"""Lazy, cached, tile-granular file access (a port of
``visionworkbench_tpu/fileio/disk_image.py``; ref ``DiskImageView``,
``src/vw/FileIO/DiskImageView.h:39-105`` = BlockRasterize + system cache
over a file handle; ``DiskImageManager.h`` pool; ``DiskCacheImageView.h``
temp materialization).

The views are host objects: regions come back as NumPy arrays, and the
caller moves them to its device.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

import numpy as np

from visionworkbench_torch.core.cache import vw_system_cache
from visionworkbench_torch.core.settings import vw_settings
from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.math.bbox import BBox2i
from visionworkbench_torch.fileio.image_io import read_image
from visionworkbench_torch.fileio.tiff import TiffInfo, read_tiff_region, write_tiff


class DiskImageView:
    """Tile-cached reader: regions are assembled from fixed-grid tiles pulled
    through the global LRU cache, regenerating from disk on miss — the
    reference's canonical lazy file reader. Uncompressed TIFFs are read a
    tile at a time; compressed TIFFs and other formats are read whole once."""

    def __init__(self, path: str, tile_size: Optional[int] = None,
                 dtype=np.float32):
        self.path = path
        self.dtype = np.dtype(dtype)
        self.tile_size = tile_size or vw_settings().default_tile_size
        # the file's identity in the tile keys: a file rewritten at the same
        # path is read anew by a view made after the rewrite
        st = os.stat(path)
        self._key = ("visionworkbench_torch.DiskImageView", os.path.abspath(path),
                     st.st_mtime_ns, st.st_size, self.tile_size, self.dtype.str)
        ext = os.path.splitext(path)[1].lower()
        self._is_tiff = ext in (".tif", ".tiff")
        if self._is_tiff:
            info = TiffInfo(path)
            self.rows, self.cols = info.height, info.width
            self.bands = info.bands
            self.nodata = info.nodata
            self._whole = None if info.compression == 1 else read_image(path, dtype)
        else:
            self._whole = read_image(path, dtype)
            self.rows, self.cols = self._whole.shape[:2]
            self.bands = 1 if self._whole.ndim == 2 else self._whole.shape[2]
            self.nodata = None

    @property
    def shape(self):
        if self.bands > 1:
            return (self.rows, self.cols, self.bands)
        return (self.rows, self.cols)

    def _tile(self, tx: int, ty: int) -> np.ndarray:
        key = self._key + (tx, ty)
        ts = self.tile_size

        def generate():
            x0, y0 = tx * ts, ty * ts
            w = min(ts, self.cols - x0)
            h = min(ts, self.rows - y0)
            if self._whole is not None:
                raw = self._whole[y0:y0 + h, x0:x0 + w]
            else:
                raw = read_tiff_region(self.path, x0, y0, w, h)
            if self.dtype.kind == "f" and raw.dtype.kind in "ui":
                raw = raw.astype(self.dtype) / np.iinfo(raw.dtype).max
            return np.ascontiguousarray(raw.astype(self.dtype))

        return vw_system_cache().insert(generate, key).value()

    def read_region(self, bbox: BBox2i) -> np.ndarray:
        if (bbox.min_x < 0 or bbox.min_y < 0 or
                bbox.max_x > self.cols or bbox.max_y > self.rows):
            raise ArgumentErr(f"read_region: {bbox} outside image "
                              f"{self.cols}x{self.rows}")
        ts = self.tile_size
        shape = ((int(bbox.height), int(bbox.width), self.bands)
                 if self.bands > 1 else (int(bbox.height), int(bbox.width)))
        out = np.zeros(shape, self.dtype)
        for ty in range(bbox.min_y // ts, (bbox.max_y - 1) // ts + 1):
            for tx in range(bbox.min_x // ts, (bbox.max_x - 1) // ts + 1):
                tile = self._tile(tx, ty)
                gx, gy = tx * ts, ty * ts
                sy0 = max(bbox.min_y, gy); sy1 = min(bbox.max_y, gy + tile.shape[0])
                sx0 = max(bbox.min_x, gx); sx1 = min(bbox.max_x, gx + tile.shape[1])
                out[sy0 - bbox.min_y:sy1 - bbox.min_y,
                    sx0 - bbox.min_x:sx1 - bbox.min_x] = \
                    tile[sy0 - gy:sy1 - gy, sx0 - gx:sx1 - gx]
        return out

    def read(self) -> np.ndarray:
        return self.read_region(BBox2i(0, 0, self.cols, self.rows))


class DiskCacheImageView:
    """Materialize an expensive computation to a temp file once, then serve
    region reads from it (ref ``DiskCacheImageView.h``)."""

    def __init__(self, array: np.ndarray, tile_size: int = 256,
                 tmp_dir: Optional[str] = None):
        tmp_dir = tmp_dir or vw_settings().tmp_directory
        fd, self.path = tempfile.mkstemp(suffix=".tif", dir=tmp_dir)
        os.close(fd)
        write_tiff(self.path, np.asarray(array), tile_size=max(tile_size, 16))
        self._view = DiskImageView(self.path, tile_size=tile_size,
                                   dtype=np.asarray(array).dtype)

    def read_region(self, bbox: BBox2i) -> np.ndarray:
        return self._view.read_region(bbox)

    def __del__(self):
        try:
            os.unlink(self.path)
        except OSError:
            pass
