"""Thread pool / work queue API parity (a copy of
``visionworkbench_tpu/core/threadpool.py``, which imports no JAX; ref
``src/vw/Core/ThreadPool.h:46-185``, ``ThreadQueue.h:37-90``).

Device parallelism comes from the card; these host-side queues back IO and
tile pipelines (the ordered writer in fileio uses the same patterns inline).
"""

from __future__ import annotations

import heapq
import queue
import threading
from typing import Any, Callable, List, Optional


class ThreadQueue:
    """Condition-variable MPMC queue (ref ``ThreadQueue``)."""

    def __init__(self, maxsize: int = 0):
        self._q: "queue.Queue" = queue.Queue(maxsize)

    def push(self, item: Any) -> None:
        self._q.put(item)

    def try_pop(self):
        try:
            return True, self._q.get_nowait()
        except queue.Empty:
            return False, None

    def wait_pop(self, timeout: Optional[float] = None):
        return self._q.get(timeout=timeout)

    def empty(self) -> bool:
        return self._q.empty()

    def size(self) -> int:
        return self._q.qsize()


class FifoWorkQueue:
    """N worker threads draining tasks in submission order
    (ref ``FifoWorkQueue``, ThreadPool.h:152)."""

    def __init__(self, num_threads: int = 4):
        self.num_threads = int(num_threads)
        self._tasks: "queue.Queue" = queue.Queue()
        self._errors: List[BaseException] = []
        self._threads: List[threading.Thread] = []

    def add_task(self, fn: Callable[[], Any]) -> None:
        self._tasks.put(fn)

    def _worker(self):
        while True:
            try:
                fn = self._tasks.get_nowait()
            except queue.Empty:
                return
            try:
                fn()
            except BaseException as e:
                self._errors.append(e)

    def join_all(self) -> None:
        """Run all queued tasks to completion (ref ``join_all``)."""
        self._threads = [threading.Thread(target=self._worker)
                         for _ in range(self.num_threads)]
        for t in self._threads:
            t.start()
        for t in self._threads:
            t.join()
        if self._errors:
            raise self._errors[0]


class OrderedWorkQueue:
    """Tasks indexed; results handed to ``consume`` strictly in index order
    (ref ``OrderedWorkQueue``, ThreadPool.h:172 — the deterministic-merge
    queue under ipfind and the block writer)."""

    def __init__(self, consume: Callable[[int, Any], None],
                 num_threads: int = 4):
        self.consume = consume
        self.num_threads = int(num_threads)
        self._tasks: List = []

    def add_task(self, index: int, fn: Callable[[], Any]) -> None:
        self._tasks.append((index, fn))

    def join_all(self) -> None:
        results: List = []
        lock = threading.Lock()
        tasks = list(self._tasks)
        cursor = [0]

        def worker():
            while True:
                with lock:
                    if cursor[0] >= len(tasks):
                        return
                    i = cursor[0]
                    cursor[0] += 1
                idx, fn = tasks[i]
                value = fn()
                with lock:
                    heapq.heappush(results, (idx, value))

        threads = [threading.Thread(target=worker)
                   for _ in range(self.num_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        while results:
            idx, value = heapq.heappop(results)
            self.consume(idx, value)


class CountingSemaphore:
    """Bounded in-flight window (ref ``CountingSemaphore``, ImageIO.h:116-143)."""

    def __init__(self, max_count: int):
        self._sem = threading.Semaphore(max_count)

    def wait(self) -> None:
        self._sem.acquire()

    def release(self) -> None:
        self._sem.release()

    def __enter__(self):
        self.wait()
        return self

    def __exit__(self, *exc):
        self.release()
