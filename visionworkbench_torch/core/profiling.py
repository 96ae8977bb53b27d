"""Tracing / profiling (a port of ``visionworkbench_tpu/core/profiling.py``;
ref ``Stopwatch``/``Timer`` and per-tile timing under ``VW_DEBUG_LEVEL``,
``CorrelationView.cc:836-845``).

``trace()`` records with ``torch.profiler`` (CPU activity, and CUDA when a
card is present) and writes a Chrome trace into ``logdir`` (viewable in
Perfetto or ``chrome://tracing``); ``materialize`` is the device barrier of
a timed region (CUDA launches return before the card finishes).

``span(name)`` names a step of the program. Off (no ``recording()`` open
and no profiler running) it returns one shared no-op context: a flag check,
one C call and one store, no allocation, no launch. Inside ``recording()``
each span appends ``(item_id, parent_index, name, t0_ns, t1_ns)`` on
``time.perf_counter_ns``'s clock to the recording's list: ``item_id``
counts the outermost spans of the recording, ``parent_index`` is the
enclosing span's index in the list (-1 for an outermost span). While a
profiler runs, a span also enters ``torch.profiler.record_function`` (so it
shows in a trace that records CPU activity) and is kept in the same form in
``profiled_spans()``, the spans of the latest stretch of calls made under a
profiler: a trace of CUDA activity alone holds no ``record_function``, and
these let a reader map its runtime calls and kernels onto the program's
steps. Recordings and profiled spans are per thread, as the profiler is;
a span opened without a profiler, in any thread, ends the stretch.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import List, Tuple

import numpy as np
import torch


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


Span = Tuple[int, int, str, int, int]     # (item_id, parent_index, name, t0_ns, t1_ns)


class _NoSpan:
    """The span when nothing records: enters and leaves doing nothing."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_NO_SPAN = _NoSpan()
_profiler_enabled = torch.autograd._profiler_enabled
_open_recordings = 0                      # open recording() contexts, every thread
_unprofiled = True                        # a span opened without a profiler since
                                          # the profiled stretch began


class _Local(threading.local):
    """A thread's recordings and profiled spans."""
    recordings: Tuple = ()
    profiled = None


_local = _Local()


class _Sink:
    """One list of spans: the spans, the indices of the open ones, and the
    count of outermost spans so far."""
    __slots__ = ("spans", "open", "items")

    def __init__(self):
        self.spans: List = []
        self.open: List[int] = []
        self.items = 0

    def enter(self, name: str, t0: int) -> int:
        if not self.open:
            self.items += 1
        index = len(self.spans)
        self.spans.append((self.items - 1, self.open[-1] if self.open else -1,
                           name, t0, t0))
        self.open.append(index)
        return index

    def exit(self, index: int, t1: int) -> None:
        self.open.pop()
        item, parent, name, t0, _ = self.spans[index]
        self.spans[index] = (item, parent, name, t0, t1)


def _sinks(profiling: bool) -> List[_Sink]:
    """This thread's sinks: its open recordings, and while a profiler runs
    its profiled spans (started anew when a span opens under a profiler
    after one opened without it)."""
    global _unprofiled
    sinks = list(_local.recordings)
    if profiling:
        if _unprofiled or _local.profiled is None:
            _local.profiled, _unprofiled = _Sink(), False
        sinks.append(_local.profiled)
    else:
        _unprofiled = True
    return sinks


class _Span:
    __slots__ = ("name", "rf", "marks")

    def __init__(self, name: str):
        self.name, self.rf, self.marks = name, None, ()

    def __enter__(self):
        profiling = _profiler_enabled()
        if profiling:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        sinks = _sinks(profiling)
        t0 = time.perf_counter_ns()
        self.marks = [(s, s.enter(self.name, t0)) for s in sinks]
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        for sink, index in self.marks:
            sink.exit(index, t1)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A context naming a step of the program (see the module's doc): the
    shared no-op when nothing records."""
    global _unprofiled
    if not _open_recordings and not _profiler_enabled():
        _unprofiled = True              # a later profiler starts a new stretch
        return _NO_SPAN
    return _Span(name)


@contextlib.contextmanager
def recording():
    """Record this thread's spans for the block; yields the list they go
    into (a span's entry is appended as it opens, its end set as it
    closes)."""
    global _open_recordings
    sink, before = _Sink(), _local.recordings
    _local.recordings = before + (sink,)
    _open_recordings += 1
    try:
        yield sink.spans
    finally:
        _local.recordings = before
        _open_recordings -= 1


def profiled_spans() -> List[Span]:
    """This thread's spans of the latest stretch of calls made while a
    profiler ran (empty if none): a span still open reads t1 == t0."""
    sink = _local.profiled
    return list(sink.spans) if sink is not None else []
