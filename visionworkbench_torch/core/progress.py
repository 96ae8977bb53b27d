"""Progress reporting / abort plumbing (a copy of
``visionworkbench_tpu/core/progress.py``, which imports no JAX; ref
``src/vw/Core/ProgressCallback.h:40-107``)."""

from __future__ import annotations

import sys
import threading
from typing import Optional

from visionworkbench_torch.core.exceptions import AbortedErr


class ProgressCallback:
    """Base progress callback: fractional progress in [0, 1] + abort flag."""

    def __init__(self) -> None:
        self._progress = 0.0
        self._abort_requested = False
        self._lock = threading.Lock()

    def report_progress(self, progress: float) -> None:
        with self._lock:
            self._progress = float(progress)

    def report_incremental_progress(self, incremental: float) -> None:
        with self._lock:
            self._progress += float(incremental)

    def report_finished(self) -> None:
        self.report_progress(1.0)

    def progress(self) -> float:
        with self._lock:
            return self._progress

    def request_abort(self) -> None:
        with self._lock:
            self._abort_requested = True

    def abort_requested(self) -> bool:
        with self._lock:
            return self._abort_requested

    def abort_if_requested(self) -> None:
        if self.abort_requested():
            raise AbortedErr("Operation aborted by ProgressCallback")


class TerminalProgressCallback(ProgressCallback):
    """Text progress bar (ref ``TerminalProgressCallback``)."""

    def __init__(self, namespace: str = "console", desc: str = "", width: int = 40,
                 stream=None) -> None:
        super().__init__()
        self.desc = desc
        self.width = width
        self._stream = stream or sys.stderr

    def report_progress(self, progress: float) -> None:
        super().report_progress(progress)
        self._draw()

    def report_finished(self) -> None:
        super().report_finished()
        self._draw()
        self._stream.write("\n")
        self._stream.flush()

    def _draw(self) -> None:
        p = max(0.0, min(1.0, self.progress()))
        filled = int(p * self.width)
        bar = "*" * filled + "." * (self.width - filled)
        self._stream.write(f"\r{self.desc}[{bar}] {100.0 * p:5.1f}%")
        self._stream.flush()


class SubProgressCallback(ProgressCallback):
    """Maps a sub-range of a parent callback (ref ``SubProgressCallback``)."""

    def __init__(self, parent: ProgressCallback, from_progress: float, to_progress: float) -> None:
        super().__init__()
        self._parent = parent
        self._from = float(from_progress)
        self._to = float(to_progress)

    def report_progress(self, progress: float) -> None:
        super().report_progress(progress)
        self._parent.report_progress(self._from + (self._to - self._from) * progress)

    def abort_requested(self) -> bool:
        return self._parent.abort_requested()


_dummy: Optional[ProgressCallback] = None


def dummy_progress() -> ProgressCallback:
    global _dummy
    if _dummy is None:
        _dummy = ProgressCallback()
    return _dummy
