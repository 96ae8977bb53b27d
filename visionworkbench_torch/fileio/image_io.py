"""Whole-image read/write (a copy of ``visionworkbench_tpu/fileio/image_io.py``,
which imports no JAX; ref ``src/vw/FileIO/DiskImageResource.h:41-92``
format dispatch and ``read_image``/``write_image``, ``Image/ImageIO.h:38-114``).

Formats: TIFF/GeoTIFF through the in-tree codec
(:mod:`visionworkbench_torch.fileio.tiff`), PNG/JPEG/PGM/PPM/BMP through PIL.
Float images written to 8-bit formats are rescaled from [0, 1] like the
reference's channel-rescale casts.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from visionworkbench_torch.core.exceptions import ArgumentErr, IOErr
from visionworkbench_torch.fileio.tiff import TiffInfo, read_tiff, write_tiff

_TIFF_EXT = {".tif", ".tiff"}
_PIL_EXT = {".png", ".jpg", ".jpeg", ".pgm", ".ppm", ".pbm", ".bmp", ".gif"}


def read_image(path: str, dtype=np.float32) -> np.ndarray:
    """Read an image as (H, W[, C]); integer data rescales to [0, 1] when a
    float dtype is requested (reference channel-cast-rescale semantics)."""
    ext = os.path.splitext(path)[1].lower()
    if not os.path.exists(path):
        raise IOErr(f"read_image: no such file {path!r}")
    if ext in _TIFF_EXT:
        arr, _ = read_tiff(path)
    elif ext == ".exr":
        from visionworkbench_torch.fileio.exr import read_exr
        arr, _ = read_exr(path)
    else:
        from PIL import Image
        with Image.open(path) as im:
            arr = np.asarray(im)
    if dtype is None:
        return arr
    dt = np.dtype(dtype)
    if dt.kind == "f" and arr.dtype.kind in "ui":
        info = np.iinfo(arr.dtype)
        return arr.astype(dt) / info.max
    return arr.astype(dt)


def write_image(path: str, array, georef=None, nodata: Optional[float] = None,
                tile_size: Optional[int] = None) -> None:
    """Write (H, W[, C]) data; format by extension."""
    array = np.asarray(array)
    ext = os.path.splitext(path)[1].lower()
    if ext in _TIFF_EXT:
        write_tiff(path, array, georef=georef, nodata=nodata, tile_size=tile_size)
        return
    if ext == ".exr":
        from visionworkbench_torch.fileio.exr import write_exr
        write_exr(path, array.astype(np.float32), compression="zip")
        return
    if ext in _PIL_EXT:
        from PIL import Image
        if array.dtype.kind == "f":
            array = np.clip(array, 0.0, 1.0)
            array = (array * 255.0 + 0.5).astype(np.uint8)
        elif array.dtype == np.uint16 and ext != ".png":
            array = (array // 257).astype(np.uint8)
        if array.dtype == np.bool_:
            array = array.astype(np.uint8) * 255
        Image.fromarray(array).save(path)
        return
    raise ArgumentErr(f"write_image: unsupported extension {ext!r}")


def image_size(path: str) -> Tuple[int, int]:
    """(height, width) without decoding pixel data."""
    ext = os.path.splitext(path)[1].lower()
    if ext in _TIFF_EXT:
        info = TiffInfo(path)
        return info.height, info.width
    from PIL import Image
    with Image.open(path) as im:
        return im.height, im.width
