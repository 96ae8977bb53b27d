"""The JAX package's first-generation fused searches (port of
``visionworkbench_tpu/ops/cost_volume.py``), as entry points onto the CUDA
sweep of ``ops/sweep.py``:

* :func:`best_of_search` replaces the TPU kernel ``pallas_best_of_search``
  (``pl.pallas_call`` at ``:165``): uniform-window abs/sq search of
  ``left`` (H, W) over ``right`` (H+sy-1, W+sx-1), returning
  ``(disp, valid, best)``;
* :func:`tiled_search` replaces ``pallas_tiled_search`` (``:332``): the
  per-tile-offset abs/sq search, returning ``(disp, valid)`` with the
  *whole* disparity, tile offset included, zeroed where invalid (unlike
  ``_tiled_search``, which keeps the offset there).

The TPU kernels' tiles follow the (8, 128) layout; here a tile is only a
block of the sweep, and the results do not depend on it. Windows start
clamped into ``match`` like ``_tiled_search``'s, so the two agree wherever
the JAX kernel's windows lie inside its (edge-padded) frame. Each entry
point has its plain version (``*_plain``), the same code on ``sweep_plain``.
"""

from __future__ import annotations

import torch

from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.ops.sweep import search_frame, sweep, sweep_plain
from visionworkbench_torch.stereo.correlation import (
    ABSOLUTE_DIFFERENCE, SQUARED_DIFFERENCE,
)


def _check_cost(cost_type: str, what: str) -> None:
    if cost_type not in (ABSOLUTE_DIFFERENCE, SQUARED_DIFFERENCE):
        raise ArgumentErr(f"{what} supports abs/sq costs")


def _frame_search(left, right, sx, sy, kw, kh, cost_type, tile, plain):
    _check_cost(cost_type, "best_of_search")
    h, w = left.shape
    if tuple(right.shape) != (h + sy - 1, w + sx - 1):
        raise ArgumentErr(f"best_of_search: right must be {(h + sy - 1, w + sx - 1)}, "
                          f"got {tuple(right.shape)}")
    return search_frame(left, right, int(sx), int(sy), int(kw), int(kh),
                        cost_type, tile=int(tile), want_best=True, plain=plain)


def best_of_search(left, right, sx: int, sy: int, kw: int, kh: int,
                   cost_type: str = ABSOLUTE_DIFFERENCE, tile: int = 128):
    """Fused disparity search. ``left`` (H, W), ``right`` (H+sy-1, W+sx-1)
    float32 tensors. Returns ``(disp (H-kh+1, W-kw+1, 2) int32, valid bool,
    best f32)``, the contract of ``pallas_best_of_search``. ``tile`` is the
    largest sweep tile tried. CPU tensors run the plain version; CUDA
    tensors launch the sweep kernel or raise."""
    return _frame_search(left, right, sx, sy, kw, kh, cost_type, tile, False)


def best_of_search_plain(left, right, sx: int, sy: int, kw: int, kh: int,
                         cost_type: str = ABSOLUTE_DIFFERENCE, tile: int = 128):
    """Plain PyTorch version of :func:`best_of_search`, on any device."""
    return _frame_search(left, right, sx, sy, kw, kh, cost_type, tile, True)


def _offset_search(fn, base, match, offsets, tile, s_x, s_y, kw, kh, cost_type):
    _check_cost(cost_type, "tiled_search")
    disp, valid, _ = fn(base, match, offsets, tile, s_x, s_y, kw, kh,
                        cost_type, False)
    return torch.where(valid[..., None], disp, torch.zeros_like(disp)), valid


def tiled_search(base, match, offsets, tile: int, s_x: int, s_y: int,
                 kw: int, kh: int, cost_type: str = ABSOLUTE_DIFFERENCE):
    """Per-tile offset search (``pallas_tiled_search``'s contract): ``base``
    carries half-kernel padding in its frame; tile (ty, tx) searches
    ``match`` from its offset ``offsets[ty, tx]`` (dx, dy). Returns
    ``(disp (nty*tile, ntx*tile, 2) int32, valid)`` with disp = offset +
    in-window argbest where valid and 0 elsewhere."""
    return _offset_search(sweep, base, match, offsets, tile, s_x, s_y, kw, kh,
                          cost_type)


def tiled_search_plain(base, match, offsets, tile: int, s_x: int, s_y: int,
                       kw: int, kh: int, cost_type: str = ABSOLUTE_DIFFERENCE):
    """Plain PyTorch version of :func:`tiled_search`, on any device."""
    return _offset_search(sweep_plain, base, match, offsets, tile, s_x, s_y,
                          kw, kh, cost_type)
