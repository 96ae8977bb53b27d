"""Correlation runtime cost model and search budgeting (port of
``visionworkbench_tpu/stereo/cost_model.py``; ref ``calc_seconds_per_op``,
``src/vw/Stereo/Correlation.cc:377-429``, and the per-tile timeout,
``CorrelationView.cc:621-637``).

The reference times a fake correlation to estimate seconds per
(pixel x disparity) op and aborts tile searches that would exceed
``corr_timeout``. As in the JAX package the budget is applied up front:
measure s/op once, then shrink each level's search volume until its
predicted time fits — the same degrade-not-fail contract. The estimate and
the budget are the JAX package's arithmetic, copied; the measurement times
the port's own whole-frame search on the device asked for (on the card the
CUDA sweep, synchronised), and is kept per device type.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from visionworkbench_torch.core.device import resolve_device

# Measured seconds per op, one per device type ("cuda", "cpu").
_seconds_per_op: Dict[str, float] = {}


def calc_seconds_per_op(min_sample_seconds: float = 1.0, device=None) -> float:
    """Measure seconds per (pixel x disparity) op on ``device`` (``None`` =
    the card) by timing fake 4x4 searches with a 7x7 kernel of growing size
    until the sample takes at least ``min_sample_seconds`` (the reference's
    self-calibration loop); each search is timed once warm."""
    from visionworkbench_torch.stereo.correlation import best_of_search_convolution
    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rng = np.random.default_rng(0)
    size, search = 128, 4
    while True:
        left = torch.as_tensor(rng.random((size, size)), dtype=torch.float32, device=dev)
        right = torch.as_tensor(rng.random((size + search - 1, size + search - 1)),
                                dtype=torch.float32, device=dev)

        def run():
            return best_of_search_convolution(left, right, (search, search), (7, 7),
                                              "abs", device=dev)
        run()
        sync()
        t0 = time.perf_counter()
        run()
        sync()
        dt = time.perf_counter() - t0
        if dt >= min_sample_seconds or size >= 2048:
            _seconds_per_op[dev.type] = dt / (size * size * search * search)
            return _seconds_per_op[dev.type]
        size *= 2


def seconds_per_op(device=None) -> float:
    """The measured s/op of ``device``'s type, measured (0.1 s samples) on
    first use."""
    dev = resolve_device(device)
    if dev.type not in _seconds_per_op:
        return calc_seconds_per_op(0.1, dev)
    return _seconds_per_op[dev.type]


def estimate_search_time(pixels: int, search_volume: Tuple[int, int],
                         sec_per_op: Optional[float] = None) -> float:
    """Predicted seconds for a search (ref ``SearchParam::search_volume``
    x s/op, CorrelationView.cc:621-624); ``sec_per_op=None`` takes the
    card's measured s/op."""
    spo = seconds_per_op() if sec_per_op is None else float(sec_per_op)
    return pixels * int(search_volume[0]) * int(search_volume[1]) * spo


def budget_search_volume(pixels: int, search_volume: Tuple[int, int],
                         corr_timeout: float,
                         sec_per_op: Optional[float] = None) -> Tuple[int, int]:
    """Shrink an (sx, sy) search until its predicted time fits
    ``corr_timeout`` (<= 0 disables): the larger axis halves first, never
    below (1, 1) — the search degrades instead of failing."""
    sx, sy = int(search_volume[0]), int(search_volume[1])
    if corr_timeout <= 0:
        return sx, sy
    while (estimate_search_time(pixels, (sx, sy), sec_per_op) > corr_timeout
           and (sx > 1 or sy > 1)):
        if sx >= sy and sx > 1:
            sx = max(sx // 2, 1)
        elif sy > 1:
            sy = max(sy // 2, 1)
    return sx, sy
