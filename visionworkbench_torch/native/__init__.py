"""ctypes bindings of the port's native C++ runtime (``vwtpu_runtime.cpp``
beside this file, the port's own copy of ``native/vwtpu_runtime.cpp``): the
GIL-free ordered tiled-TIFF writer and the byte-LRU cache -- the host-side
substrate the reference implements in C++ (``ThreadPool.h``,
``ImageIO.h:116-267``, ``Cache.h``). A port of
``visionworkbench_tpu/native/__init__.py``.

The library is built with g++ at first use into ``visionworkbench_torch/
_build`` (listed in ``.gitignore``), named by a hash of the source and the
flags as the CUDA kernels are (``ops/_build.py``), so an edited source is
rebuilt. The build writes a temporary name and renames it, so processes
building at once do not race. A missing compiler or a failed build raises:
there is no fallback to a Python writer.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = Path(__file__).resolve().with_name("vwtpu_runtime.cpp")
BUILD_DIR = _PKG / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_DTYPE_CODES = {np.dtype(np.uint8): 0, np.dtype(np.uint16): 1,
                np.dtype(np.int16): 2, np.dtype(np.int32): 3,
                np.dtype(np.float32): 4, np.dtype(np.float64): 5}


def library_path() -> Path:
    """Where the runtime of this source and these flags is built."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libvwtpu_runtime-{digest[:16]}.so"


def build() -> Path:
    """Build the runtime unless it is built; returns the library's path.
    Raises when g++ is not found or the build fails."""
    path = library_path()
    if path.exists():
        return path
    cxx = shutil.which(CXX)
    if cxx is None:
        raise RuntimeError(f"visionworkbench_torch: {CXX} not found; the native "
                           "runtime cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("visionworkbench_torch: native runtime build failed "
                           f"({CXX} exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """The loaded native runtime, built first if needed; raises when it
    cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.vwtpu_writer_create.restype = ctypes.c_void_p
        lib.vwtpu_writer_create.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.vwtpu_writer_submit.restype = ctypes.c_int
        lib.vwtpu_writer_submit.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                            ctypes.c_void_p]
        lib.vwtpu_writer_abort.restype = None
        lib.vwtpu_writer_abort.argtypes = [ctypes.c_void_p]
        lib.vwtpu_writer_close.restype = ctypes.c_int
        lib.vwtpu_writer_close.argtypes = [ctypes.c_void_p]
        lib.vwtpu_cache_create.restype = ctypes.c_void_p
        lib.vwtpu_cache_create.argtypes = [ctypes.c_int64]
        lib.vwtpu_cache_put.restype = None
        lib.vwtpu_cache_put.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.c_void_p, ctypes.c_int64]
        lib.vwtpu_cache_get.restype = ctypes.c_int64
        lib.vwtpu_cache_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.c_void_p, ctypes.c_int64]
        lib.vwtpu_cache_stats.restype = None
        lib.vwtpu_cache_stats.argtypes = [ctypes.c_void_p,
                                          ctypes.POINTER(ctypes.c_int64)]
        lib.vwtpu_cache_destroy.restype = None
        lib.vwtpu_cache_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    """True once the runtime is loaded (built first if needed); raises when
    it cannot be built: the port has no Python fallback to choose."""
    return load() is not None


class NativeTileWriter:
    """Ordered async tiled-TIFF writer backed by the C++ runtime."""

    def __init__(self, path: str, height: int, width: int, bands: int, dtype,
                 tile_size: int = 256, window: int = 21):
        lib = load()
        dt = np.dtype(dtype)
        if dt not in _DTYPE_CODES:
            raise ValueError(f"unsupported dtype {dt}")
        self._lib = lib
        self.dtype = dt
        self.tile = int(tile_size)
        self.bands = int(bands)
        self.h, self.w = int(height), int(width)
        self.ntx = -(-self.w // self.tile)
        self.nty = -(-self.h // self.tile)
        self._h = lib.vwtpu_writer_create(
            path.encode(), self.h, self.w, self.bands, _DTYPE_CODES[dt],
            self.tile, int(window))
        if not self._h:
            raise IOError(f"cannot open {path!r} for writing")

    def write_tile(self, tx: int, ty: int, tile: np.ndarray) -> None:
        full_shape = (self.tile, self.tile) + ((self.bands,)
                                               if self.bands > 1 else ())
        buf = np.zeros(full_shape, self.dtype)
        buf[:tile.shape[0], :tile.shape[1]] = tile
        buf = np.ascontiguousarray(buf)
        idx = ty * self.ntx + tx
        rc = self._lib.vwtpu_writer_submit(self._h, idx,
                                           buf.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            raise IOError("native tile writer failed")

    def abort(self) -> None:
        """Fail the write: blocked and later ``write_tile`` calls raise, and
        ``close`` writes no IFD."""
        if self._h:
            self._lib.vwtpu_writer_abort(self._h)

    def close(self) -> None:
        if self._h:
            rc = self._lib.vwtpu_writer_close(self._h)
            self._h = None
            if rc != 0:
                raise IOError("native tile writer: incomplete or failed write")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NativeLruCache:
    """Byte-LRU cache backed by the C++ runtime."""

    def __init__(self, budget_bytes: int):
        self._lib = load()
        self._h = self._lib.vwtpu_cache_create(int(budget_bytes))

    def put(self, key: str, data: bytes) -> None:
        self._lib.vwtpu_cache_put(self._h, key.encode(), data, len(data))

    def get(self, key: str) -> Optional[bytes]:
        n = self._lib.vwtpu_cache_get(self._h, key.encode(), None, 0)
        if n < 0:
            return None
        buf = ctypes.create_string_buffer(int(n))
        self._lib.vwtpu_cache_get(self._h, key.encode(), buf, n)
        return buf.raw

    def stats(self):
        out = (ctypes.c_int64 * 4)()
        self._lib.vwtpu_cache_stats(self._h, out)
        return {"used": out[0], "hits": out[1], "misses": out[2],
                "evictions": out[3]}

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.vwtpu_cache_destroy(h)
            self._h = None
