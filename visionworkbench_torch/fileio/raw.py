"""Headerless raw image driver (a copy of
``visionworkbench_tpu/fileio/raw.py``, which imports no JAX; ref
``DiskImageResourceRaw``, ``src/vw/FileIO/DiskImageResourceRaw.cc:1-323``).

The file carries no header: the user supplies the layout (rows, cols,
channel dtype). Reads and writes are row-seeked, so arbitrary sub-regions
touch only the bytes of the requested window — the block-read capability
the reference exposes via ``has_block_read/write``. Like the reference,
single-plane single-channel only (``check_format``,
``DiskImageResourceRaw.cc:60-67``).

Also provides the SPOT5 helpers the reference's factory hardcodes: sidecar
``.DIM`` discovery (``find_associated_spot5_dim_file``, ``.cc:197-240``) and
the ``<Raster_Dimensions>`` parser (``image_format_from_spot5_DIM``,
``.cc:272-323``) so a bare ``IMAGERY.BIL`` opens without arguments.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from visionworkbench_torch.core.exceptions import ArgumentErr, IOErr, NoImplErr
from visionworkbench_torch.math.bbox import BBox2i


@dataclass
class RawFormat:
    """User-specified layout of a headerless raw file (the reference's
    ``ImageFormat`` argument): image size + channel dtype. ``offset`` skips
    leading bytes (0 in the reference, where the format has no header)."""
    cols: int
    rows: int
    dtype: np.dtype = np.dtype(np.uint8)
    offset: int = 0

    def __post_init__(self):
        self.dtype = np.dtype(self.dtype)
        if self.cols < 1 or self.rows < 1:
            raise ArgumentErr("RawFormat: input image is size zero")

    @property
    def cstride(self) -> int:
        return self.dtype.itemsize

    @property
    def rstride(self) -> int:
        return self.cols * self.cstride


class RawImageResource:
    """Block read/write over a headerless raw file.

    ``mode``: 'r' (must exist), 'r+' (read/write, must exist), 'w+' (create
    or truncate). Row-strided seeks mirror the reference's per-line
    ``seekg``/``read`` loop (``DiskImageResourceRaw.cc:137-147``).
    """

    def __init__(self, path: str, fmt: RawFormat, mode: str = "r",
                 block_size: Optional[Tuple[int, int]] = None):
        if mode not in ("r", "r+", "w+"):
            raise ArgumentErr(f"RawImageResource: bad mode {mode!r}")
        self.path = path
        self.fmt = fmt
        self.mode = mode
        if mode == "w+":
            with open(path, "wb") as f:
                f.truncate(fmt.offset + fmt.rows * fmt.rstride)
        elif not os.path.exists(path):
            raise ArgumentErr(f"RawImageResource: failed to open {path!r}")
        self._f = open(path, "rb" if mode == "r" else "r+b")
        # Default block size: whole rows, 1024 tall past 1024 rows
        # (set_block_write_size, DiskImageResourceRaw.cc:70-83).
        if block_size is None:
            bh = fmt.rows if fmt.rows < 1024 else 1024
            block_size = (fmt.cols, bh)
        if block_size[0] > fmt.cols or block_size[1] > fmt.rows:
            raise ArgumentErr("RawImageResource: requested block size is "
                              "too big")
        self.block_size = block_size

    # -- capability flags (parity with the reference's virtuals) -----------
    has_block_read = True
    has_block_write = True
    has_nodata_read = False
    has_nodata_write = False

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.fmt.rows, self.fmt.cols)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _check_bbox(self, bbox: BBox2i):
        if (bbox.min_x < 0 or bbox.min_y < 0 or bbox.max_x > self.fmt.cols
                or bbox.max_y > self.fmt.rows):
            raise IOErr(f"RawImageResource: bbox {bbox} out of bounds for "
                        f"{self.fmt.cols}x{self.fmt.rows}")

    def read(self, bbox: Optional[BBox2i] = None) -> np.ndarray:
        """Read ``bbox`` (default: whole image) as (h, w) ndarray."""
        if bbox is None:
            bbox = BBox2i(0, 0, self.fmt.cols, self.fmt.rows)
        self._check_bbox(bbox)
        w, h = int(bbox.width), int(bbox.height)
        cs, rs = self.fmt.cstride, self.fmt.rstride
        out = np.empty((h, w), self.fmt.dtype)
        base = self.fmt.offset + bbox.min_y * rs + bbox.min_x * cs
        if w == self.fmt.cols and bbox.min_x == 0:
            self._f.seek(base)
            out[:] = np.frombuffer(self._f.read(h * rs),
                                   self.fmt.dtype).reshape(h, w)
            return out
        for i in range(h):
            self._f.seek(base + i * rs)
            out[i] = np.frombuffer(self._f.read(w * cs), self.fmt.dtype)
        return out

    def write(self, data, bbox: Optional[BBox2i] = None):
        """Write ``data`` at ``bbox`` (default: whole image)."""
        if self.mode == "r":
            raise IOErr("RawImageResource: opened read-only")
        data = np.ascontiguousarray(np.asarray(data), dtype=self.fmt.dtype)
        if data.ndim != 2:
            raise NoImplErr("RawImageResource supports single-channel "
                            "single-plane images only")
        if bbox is None:
            bbox = BBox2i(0, 0, data.shape[1], data.shape[0])
        self._check_bbox(bbox)
        w, h = int(bbox.width), int(bbox.height)
        if data.shape[0] < h or data.shape[1] < w:
            raise IOErr("RawImageResource: buffer too small for bbox")
        cs, rs = self.fmt.cstride, self.fmt.rstride
        base = self.fmt.offset + bbox.min_y * rs + bbox.min_x * cs
        for i in range(h):
            self._f.seek(base + i * rs)
            self._f.write(data[i, :w].tobytes())
        self._f.flush()


def read_raw(path: str, fmt: RawFormat,
             bbox: Optional[BBox2i] = None) -> np.ndarray:
    """One-shot raw read (region or whole)."""
    with RawImageResource(path, fmt, "r") as r:
        return r.read(bbox)


def write_raw(path: str, data, dtype=None) -> RawFormat:
    """One-shot raw write of a whole 2D array; returns the layout needed to
    read it back."""
    data = np.asarray(data)
    if dtype is not None:
        data = data.astype(dtype)
    fmt = RawFormat(cols=data.shape[1], rows=data.shape[0], dtype=data.dtype)
    with RawImageResource(path, fmt, "w+") as r:
        r.write(data)
    return fmt


# ---- SPOT5 conventions (the reference factory's hardcoded path) ----------

def find_associated_spot5_dim_file(image_file: str) -> str:
    """Locate the SPOT5 ``.DIM`` sidecar for a raw image
    (``DiskImageResourceRaw.cc:197-240``): same-stem .DIM/.dim, then the
    front/back METADATA conventions next to ``IMAGERY.BIL``."""
    stem = os.path.splitext(image_file)[0]
    for ext in (".DIM", ".dim"):
        cand = stem + ext
        if os.path.exists(cand):
            return cand
    low = image_file.lower()
    found = low.rfind("/imagery.b")
    if found == -1:
        return ""
    prefix = image_file[:found]
    for side in ("front", "back"):
        if low.rfind(side + "/") != -1:
            for name in (f"METADATA_{side.upper()}.DIM",
                         f"metadata_{side}.dim",
                         "METADATA.DIM", "metadata.dim"):
                cand = os.path.join(prefix, name)
                if os.path.exists(cand):
                    return cand
            return ""
    return ""


def raw_format_from_spot5_dim(dim_file: str) -> RawFormat:
    """Parse ``<Raster_Dimensions>`` NCOLS/NROWS from a SPOT5 DIMAP file
    (``image_format_from_spot5_DIM``, ``DiskImageResourceRaw.cc:272-323``).
    SPOT5 raw imagery is 8-bit single-band."""
    ncols = nrows = None
    with open(dim_file, "r", errors="replace") as f:
        text = f.read().lower()
    sec = text.find("<raster_dimensions")
    if sec != -1:
        m = re.search(r"<ncols>\s*(\d+)\s*</ncols>", text[sec:])
        if m:
            ncols = int(m.group(1))
        m = re.search(r"<nrows>\s*(\d+)\s*</nrows>", text[sec:])
        if m:
            nrows = int(m.group(1))
    if not ncols or not nrows:
        raise ArgumentErr(
            f"raw_format_from_spot5_dim: no Raster_Dimensions in {dim_file}")
    return RawFormat(cols=ncols, rows=nrows, dtype=np.uint8)


def open_spot5(image_file: str) -> RawImageResource:
    """Factory: open a SPOT5 raw image via its discovered .DIM sidecar
    (``construct_open``, ``DiskImageResourceRaw.cc:52-58``)."""
    dim = find_associated_spot5_dim_file(image_file)
    if not dim:
        raise ArgumentErr(f"Could not find .DIM file for: {image_file}")
    return RawImageResource(image_file, raw_format_from_spot5_dim(dim), "r")
