"""Thread-safe LRU cache of regenerable resources (a copy of
``visionworkbench_tpu/core/cache.py``, which imports no JAX).

Analogue of the reference's system cache (``src/vw/Core/Cache.h:105-295``,
eviction ``Cache.cc:66-97``): entries are *generated* on demand by a zero-arg
callable, sized in bytes, and evicted LRU when over budget; a handle can
re-generate after eviction. Used host-side for file tiles and pyramid levels
(device-side working sets are PyTorch's CUDA caching allocator's).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional

from visionworkbench_torch.core.log import DEBUG, vw_out


def _default_size_of(value: Any) -> int:
    nbytes = getattr(value, "nbytes", None)
    if nbytes is not None:
        return int(nbytes)
    return 1024  # opaque objects get a nominal cost


class CacheHandle:
    """Pins a generator; ``value()`` generates on miss (ref ``Cache::Handle``)."""

    def __init__(self, cache: "Cache", key: Any, generator: Callable[[], Any]) -> None:
        self._cache = cache
        self._key = key
        self._generator = generator

    def value(self) -> Any:
        return self._cache._fetch(self._key, self._generator)

    def valid(self) -> bool:
        return self._cache._is_resident(self._key)

    def release(self) -> None:
        self._cache.invalidate(self._key)


class Cache:
    def __init__(self, max_size_bytes: int) -> None:
        self.max_size = int(max_size_bytes)
        self._entries: "OrderedDict[Any, Any]" = OrderedDict()
        self._sizes: Dict[Any, int] = {}
        self._cur_size = 0
        self._lock = threading.Lock()
        # per-key generation locks so two threads don't generate the same line
        # twice (ref per-line generation locks, Cache.h:172-174)
        self._gen_locks: Dict[Any, threading.Lock] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def insert(self, generator: Callable[[], Any], key: Any) -> CacheHandle:
        return CacheHandle(self, key, generator)

    def _is_resident(self, key: Any) -> bool:
        with self._lock:
            return key in self._entries

    def _fetch(self, key: Any, generator: Callable[[], Any]) -> Any:
        with self._lock:
            if key in self._entries:
                self.hits += 1
                self._entries.move_to_end(key)
                return self._entries[key]
            gen_lock = self._gen_locks.setdefault(key, threading.Lock())
        with gen_lock:
            with self._lock:
                if key in self._entries:  # lost the race — someone generated it
                    self.hits += 1
                    self._entries.move_to_end(key)
                    return self._entries[key]
            value = generator()
            size = _default_size_of(value)
            with self._lock:
                self.misses += 1
                self._entries[key] = value
                self._sizes[key] = size
                self._cur_size += size
                self._evict_locked()
            return value

    def _evict_locked(self) -> None:
        # Walk LRU order evicting until under budget (ref Cache.cc:66-97).
        while self._cur_size > self.max_size and len(self._entries) > 1:
            old_key, _ = self._entries.popitem(last=False)
            self._cur_size -= self._sizes.pop(old_key, 0)
            self.evictions += 1
        if self._cur_size > self.max_size:
            vw_out(DEBUG, "cache").debug(
                "single cache entry (%d B) exceeds budget (%d B)",
                self._cur_size, self.max_size)

    def invalidate(self, key: Any) -> None:
        with self._lock:
            if key in self._entries:
                del self._entries[key]
                self._cur_size -= self._sizes.pop(key, 0)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._sizes.clear()
            self._cur_size = 0

    @property
    def size(self) -> int:
        with self._lock:
            return self._cur_size


_system_cache: Optional[Cache] = None
_lock = threading.Lock()


def vw_system_cache() -> Cache:
    """Global cache singleton (ref ``vw_system_cache()``, System.cc:14-50)."""
    global _system_cache
    if _system_cache is None:
        with _lock:
            if _system_cache is None:
                from visionworkbench_torch.core.settings import vw_settings
                _system_cache = Cache(vw_settings().system_cache_size)
    return _system_cache
