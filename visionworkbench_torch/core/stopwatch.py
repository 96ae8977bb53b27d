"""Timers (a copy of ``visionworkbench_tpu/core/stopwatch.py``, which imports
no JAX; ref ``src/vw/Core/Stopwatch.h:36-124``).

``Stopwatch`` accumulates wall time across start/stop pairs; ``StopwatchSet``
is a named registry; ``Timer`` is a context manager printing at exit (the RAII
``Timer`` used in ``tools/correlate.cc:264``). For device work, wrap the timed
region so it ends with ``torch.cuda.synchronize()`` — CUDA launches are
asynchronous.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional


class Stopwatch:
    def __init__(self) -> None:
        self._elapsed = 0.0
        self._start: Optional[float] = None
        self._depth = 0
        self._lock = threading.Lock()

    def start(self) -> None:
        with self._lock:
            if self._depth == 0:
                self._start = time.perf_counter()
            self._depth += 1

    def stop(self) -> None:
        with self._lock:
            self._depth -= 1
            if self._depth == 0 and self._start is not None:
                self._elapsed += time.perf_counter() - self._start
                self._start = None

    @property
    def elapsed_seconds(self) -> float:
        with self._lock:
            running = 0.0
            if self._depth > 0 and self._start is not None:
                running = time.perf_counter() - self._start
            return self._elapsed + running


class StopwatchSet:
    """Named stopwatch registry (ref ``StopwatchSet``, Stopwatch.h:90-124)."""

    def __init__(self) -> None:
        self._watches: Dict[str, Stopwatch] = {}
        self._lock = threading.Lock()

    def get(self, name: str) -> Stopwatch:
        with self._lock:
            return self._watches.setdefault(name, Stopwatch())

    def report(self) -> str:
        with self._lock:
            lines = [f"{name}: {sw.elapsed_seconds:.6f} s" for name, sw in sorted(self._watches.items())]
        return "\n".join(lines)


_global_set = StopwatchSet()


def stopwatch_set() -> StopwatchSet:
    return _global_set


class Timer:
    """Context manager that reports elapsed wall time at exit."""

    def __init__(self, desc: str = "", printer=None) -> None:
        self.desc = desc
        self.elapsed = 0.0
        self._printer = printer if printer is not None else (lambda s: print(s))

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed = time.perf_counter() - self._t0
        if self.desc:
            self._printer(f"{self.desc}: {self.elapsed:.6f} s")
