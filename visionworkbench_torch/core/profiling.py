"""Tracing / profiling (a port of ``visionworkbench_tpu/core/profiling.py``;
ref ``Stopwatch``/``Timer`` and per-tile timing under ``VW_DEBUG_LEVEL``,
``CorrelationView.cc:836-845``).

``trace()`` records with ``torch.profiler`` (CPU activity, and CUDA when a
card is present) and writes a Chrome trace into ``logdir`` (viewable in
Perfetto or ``chrome://tracing``); :class:`RateCounter` tracks megapixels/s
per pipeline stage; ``timed_stage`` combines a stopwatch with a device
barrier so device work is actually measured (CUDA launches return before
the card finishes).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import numpy as np
import torch

from visionworkbench_torch.core.stopwatch import stopwatch_set


@contextlib.contextmanager
def trace(logdir: str, host_tracer_level: int = 2):
    """Capture a ``torch.profiler`` trace of the block into ``logdir`` (one
    ``*.pt.trace.json`` Chrome trace a call). ``host_tracer_level`` is kept
    for the JAX package's signature; the CPU activity is always recorded."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()


def _leaves(tree, out):
    if isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    elif isinstance(tree, torch.Tensor):
        out.append(tree)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):   # a namedtuple
        return type(tree)(*(_to_numpy(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def materialize(tree):
    """Wait for every device that holds a tensor of ``tree`` (nested lists,
    tuples and dicts), then return the NumPy pytree: the device barrier of
    a timed region."""
    tensors = []
    _leaves(tree, tensors)
    for dev in {t.device for t in tensors if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return _to_numpy(tree)


class RateCounter:
    """Megapixels/s per named stage (the analogue of the reference's
    per-stage stopwatches + the Mp/s figures BASELINE.json asks for)."""

    def __init__(self):
        self._pixels: Dict[str, float] = {}
        self._seconds: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, pixels: int):
        sw = stopwatch_set().get(name)
        sw.start()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            sw.stop()
            self._pixels[name] = self._pixels.get(name, 0.0) + pixels
            self._seconds[name] = self._seconds.get(name, 0.0) + dt

    def rate(self, name: str) -> float:
        """Mp/s for a stage."""
        s = self._seconds.get(name, 0.0)
        return (self._pixels.get(name, 0.0) / 1e6 / s) if s > 0 else 0.0

    def report(self) -> str:
        lines = []
        for name in sorted(self._pixels):
            lines.append(f"{name}: {self.rate(name):.2f} Mp/s "
                         f"({self._pixels[name] / 1e6:.2f} Mp in "
                         f"{self._seconds[name]:.3f} s)")
        return "\n".join(lines)


@contextlib.contextmanager
def timed_stage(counter: RateCounter, name: str, pixels: int, result_holder: list):
    """Time a stage that produces device tensors: append the output to
    ``result_holder`` inside the block; it is materialized before the clock
    stops."""
    with counter.stage(name, pixels):
        yield
        if result_holder:
            result_holder[-1] = materialize(result_holder[-1])
