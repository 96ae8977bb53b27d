"""Minimal TIFF / GeoTIFF codec (pure Python + NumPy): a copy of
``visionworkbench_tpu/fileio/tiff.py``, which imports no JAX.

The role of the reference's GDAL/TIFF format resources
(``src/vw/FileIO/DiskImageResourceGDAL.cc``, ``DiskImageResourceTIFF.cc``):
this image has no GDAL/rasterio, so the framework carries its own codec for
the formats it produces — classic little-endian TIFF, stripped or tiled,
uncompressed, uint8/16/32 + float32/64, 1..N chunky samples — plus GeoTIFF
tags (ModelPixelScale/ModelTiepoint/ModelTransformation, GeoKeyDirectory,
GDAL-style nodata). Reading falls back to PIL for compressed/exotic files.

The tiled layout + the deferred offset-table patch in :class:`TiffTileWriter`
is what lets the ordered tile writer stream tiles to disk in tile order with
bounded memory (the reference's ``ThreadedBlockWriter`` contract,
``src/vw/Image/ImageIO.h:116-267``).
"""

from __future__ import annotations

import struct
from typing import Dict, Optional, Tuple

import numpy as np

from visionworkbench_torch.core.exceptions import ArgumentErr, IOErr

# TIFF tag ids
T_WIDTH, T_LENGTH, T_BPS, T_COMPRESSION, T_PHOTOMETRIC = 256, 257, 258, 259, 262
T_STRIP_OFFSETS, T_SPP, T_ROWS_PER_STRIP, T_STRIP_COUNTS = 273, 277, 278, 279
T_PLANAR, T_SAMPLE_FORMAT = 284, 339
T_TILE_W, T_TILE_L, T_TILE_OFFSETS, T_TILE_COUNTS = 322, 323, 324, 325
T_MODEL_PIXEL_SCALE, T_MODEL_TIEPOINT, T_MODEL_TRANSFORM = 33550, 33922, 34264
T_GEO_KEYS, T_GEO_DOUBLES, T_GEO_ASCII = 34735, 34736, 34737
T_GDAL_NODATA = 42113

_TYPE_FMT = {1: "B", 2: "s", 3: "H", 4: "I", 5: "II", 7: "B",
             11: "f", 12: "d", 8: "h", 9: "i"}
_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 7: 1, 8: 2, 9: 4, 11: 4, 12: 8}


def _dtype_fields(dtype: np.dtype) -> Tuple[int, int]:
    """(bits_per_sample, sample_format)"""
    dt = np.dtype(dtype)
    if dt.kind == "u":
        return dt.itemsize * 8, 1
    if dt.kind == "i":
        return dt.itemsize * 8, 2
    if dt.kind == "f":
        return dt.itemsize * 8, 3
    raise ArgumentErr(f"tiff: unsupported dtype {dt}")


def _fields_dtype(bps: int, fmt: int) -> np.dtype:
    kind = {1: "u", 2: "i", 3: "f"}.get(fmt, "u")
    return np.dtype(f"<{kind}{bps // 8}")


class _IFDWriter:
    def __init__(self):
        self.entries = []  # (tag, type, count, payload_bytes or int value)
        self.extra = b""

    def add(self, tag: int, typ: int, values) -> None:
        if typ == 2:  # ascii
            data = values.encode() + b"\x00"
            count = len(data)
        else:
            if np.isscalar(values):
                values = [values]
            fmt = "<" + _TYPE_FMT[typ] * len(values)
            data = struct.pack(fmt, *values)
            count = len(values)
        self.entries.append((tag, typ, count, data))

    def serialize(self, ifd_offset: int) -> bytes:
        self.entries.sort(key=lambda e: e[0])
        n = len(self.entries)
        # external payloads placed after the IFD
        ext_offset = ifd_offset + 2 + n * 12 + 4
        body = struct.pack("<H", n)
        ext = b""
        for tag, typ, count, data in self.entries:
            if len(data) <= 4:
                body += struct.pack("<HHI", tag, typ, count) + data.ljust(4, b"\x00")
            else:
                body += struct.pack("<HHII", tag, typ, count, ext_offset + len(ext))
                ext += data
                if len(ext) % 2:
                    ext += b"\x00"
        body += struct.pack("<I", 0)
        return body + ext


def _build_ifd(writer: "_IFDWriter", h, w, bands, dtype,
               georef=None, nodata=None) -> None:
    bps, fmt = _dtype_fields(dtype)
    writer.add(T_WIDTH, 4, w)
    writer.add(T_LENGTH, 4, h)
    writer.add(T_BPS, 3, [bps] * bands)
    writer.add(T_COMPRESSION, 3, 1)
    writer.add(T_PHOTOMETRIC, 3, 2 if bands >= 3 else 1)
    writer.add(T_SPP, 3, bands)
    writer.add(T_PLANAR, 3, 1)
    writer.add(T_SAMPLE_FORMAT, 3, [fmt] * bands)
    if nodata is not None:
        writer.add(T_GDAL_NODATA, 2, repr(float(nodata)))
    if georef is not None:
        _add_geo_tags(writer, georef)


def _add_geo_tags(writer: "_IFDWriter", georef) -> None:
    """GeoTIFF tags from a GeoReference-like object (``transform`` 3x3 affine
    pixel->projected, plus ``geo_keys()`` -> list of (key, value) shorts and
    optional doubles/ascii)."""
    t = np.asarray(georef.transform, np.float64)
    if t[0, 1] == 0 and t[1, 0] == 0:
        writer.add(T_MODEL_PIXEL_SCALE, 12, [t[0, 0], -t[1, 1], 0.0])
        writer.add(T_MODEL_TIEPOINT, 12, [0.0, 0.0, 0.0, t[0, 2], t[1, 2], 0.0])
    else:
        m = [t[0, 0], t[0, 1], 0, t[0, 2],
             t[1, 0], t[1, 1], 0, t[1, 2],
             0, 0, 0, 0, 0, 0, 0, 1]
        writer.add(T_MODEL_TRANSFORM, 12, m)
    keys, doubles, ascii_params = georef.geo_keys()
    header = [1, 1, 0, len(keys)]
    for k, typ_tag, count, value in keys:
        header += [k, typ_tag, count, value]
    writer.add(T_GEO_KEYS, 3, header)
    if doubles:
        writer.add(T_GEO_DOUBLES, 12, doubles)
    if ascii_params:
        writer.add(T_GEO_ASCII, 2, ascii_params)


def write_tiff(path: str, array: np.ndarray, georef=None,
               nodata: Optional[float] = None,
               tile_size: Optional[int] = None) -> None:
    """Write a (H, W[, C]) array as stripped (default) or tiled TIFF."""
    array = np.ascontiguousarray(array)
    if array.ndim == 2:
        h, w = array.shape
        bands = 1
    elif array.ndim == 3:
        h, w, bands = array.shape
    else:
        raise ArgumentErr("write_tiff: array must be (H, W[, C])")

    ifd = _IFDWriter()
    _build_ifd(ifd, h, w, bands, array.dtype, georef, nodata)

    with open(path, "wb") as f:
        f.write(struct.pack("<2sHI", b"II", 42, 0))  # IFD offset patched later
        if tile_size is None:
            data = array.astype(array.dtype.newbyteorder("<")).tobytes()
            offset = f.tell()
            f.write(data)
            ifd.add(T_STRIP_OFFSETS, 4, offset)
            ifd.add(T_ROWS_PER_STRIP, 4, h)
            ifd.add(T_STRIP_COUNTS, 4, len(data))
        else:
            ts = int(tile_size)
            if ts % 16:
                raise ArgumentErr("tiff tile size must be a multiple of 16")
            ntx = -(-w // ts)
            nty = -(-h // ts)
            offsets, counts = [], []
            for ty in range(nty):
                for tx in range(ntx):
                    tile = np.zeros((ts, ts) + ((bands,) if bands > 1 else ()),
                                    array.dtype)
                    ys, xs = ty * ts, tx * ts
                    sub = array[ys:ys + ts, xs:xs + ts]
                    tile[:sub.shape[0], :sub.shape[1]] = sub
                    data = tile.astype(array.dtype.newbyteorder("<")).tobytes()
                    offsets.append(f.tell())
                    counts.append(len(data))
                    f.write(data)
            ifd.add(T_TILE_W, 3, ts)
            ifd.add(T_TILE_L, 3, ts)
            ifd.add(T_TILE_OFFSETS, 4, offsets)
            ifd.add(T_TILE_COUNTS, 4, counts)
        ifd_offset = f.tell()
        if ifd_offset % 2:
            f.write(b"\x00")
            ifd_offset += 1
        f.write(ifd.serialize(ifd_offset))
        f.seek(4)
        f.write(struct.pack("<I", ifd_offset))


def _read_ifd(f, order: str) -> Dict[int, tuple]:
    e = "<" if order == "II" else ">"
    (count,) = struct.unpack(e + "H", f.read(2))
    entries = {}
    for _ in range(count):
        tag, typ, n = struct.unpack(e + "HHI", f.read(8))
        raw = f.read(4)
        size = _TYPE_SIZE.get(typ, 1) * n
        if size <= 4:
            data = raw[:size]
        else:
            (off,) = struct.unpack(e + "I", raw)
            pos = f.tell()
            f.seek(off)
            data = f.read(size)
            f.seek(pos)
        entries[tag] = (typ, n, data, e)
    return entries


def _tag_values(entry):
    typ, n, data, e = entry
    if typ == 2:
        return data.rstrip(b"\x00").decode(errors="replace")
    if typ == 5:  # rational
        vals = struct.unpack(e + "II" * n, data)
        return [vals[2 * i] / max(vals[2 * i + 1], 1) for i in range(n)]
    fmt = e + _TYPE_FMT[typ] * n
    vals = struct.unpack(fmt, data)
    return list(vals)


class TiffInfo:
    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            order, magic = struct.unpack("<2sH", f.read(4))
            order = order.decode()
            if order not in ("II", "MM") or magic not in (42, 0x2A00, 10752):
                raise IOErr(f"{path}: not a TIFF file")
            self.order = order
            e = "<" if order == "II" else ">"
            (ifd_off,) = struct.unpack(e + "I", f.read(4))
            f.seek(ifd_off)
            self.tags = _read_ifd(f, order)
        g = self._get
        self.width = int(g(T_WIDTH)[0])
        self.height = int(g(T_LENGTH)[0])
        self.bands = int(g(T_SPP, [1])[0])
        bps = int(g(T_BPS, [8])[0])
        fmt = int(g(T_SAMPLE_FORMAT, [1])[0])
        self.dtype = _fields_dtype(bps, fmt)
        self.compression = int(g(T_COMPRESSION, [1])[0])
        self.tiled = T_TILE_OFFSETS in self.tags
        self.tile_size = (int(g(T_TILE_W, [0])[0]), int(g(T_TILE_L, [0])[0]))
        self.nodata = None
        if T_GDAL_NODATA in self.tags:
            try:
                self.nodata = float(g(T_GDAL_NODATA))
            except (TypeError, ValueError):
                pass

    def _get(self, tag, default=None):
        if tag in self.tags:
            return _tag_values(self.tags[tag])
        return default

    def geo_transform(self) -> Optional[np.ndarray]:
        """3x3 affine pixel->projected, or None."""
        if T_MODEL_TRANSFORM in self.tags:
            m = self._get(T_MODEL_TRANSFORM)
            return np.array([[m[0], m[1], m[3]], [m[4], m[5], m[7]], [0, 0, 1]])
        if T_MODEL_PIXEL_SCALE in self.tags and T_MODEL_TIEPOINT in self.tags:
            s = self._get(T_MODEL_PIXEL_SCALE)
            t = self._get(T_MODEL_TIEPOINT)
            # tiepoint: (i, j, k, x, y, z): pixel (i, j) -> (x, y)
            return np.array([[s[0], 0, t[3] - t[0] * s[0]],
                             [0, -s[1], t[4] + t[1] * s[1]],
                             [0, 0, 1]])
        return None

    def geo_keys(self):
        keys = []
        if T_GEO_KEYS in self.tags:
            vals = self._get(T_GEO_KEYS)
            n = vals[3]
            for i in range(n):
                k, loc, cnt, val = vals[4 + 4 * i: 8 + 4 * i]
                keys.append((k, loc, cnt, val))
        doubles = self._get(T_GEO_DOUBLES, [])
        ascii_params = self._get(T_GEO_ASCII, "")
        return keys, doubles, ascii_params


def read_tiff(path: str) -> Tuple[np.ndarray, TiffInfo]:
    info = TiffInfo(path)
    if info.compression != 1:
        # Fall back to PIL for compressed files.
        from PIL import Image
        with Image.open(path) as im:
            arr = np.asarray(im)
        return arr, info
    e = "<" if info.order == "II" else ">"
    dt = info.dtype.newbyteorder(e)
    shape_c = (info.bands,) if info.bands > 1 else ()
    out = np.zeros((info.height, info.width) + shape_c, info.dtype)
    with open(path, "rb") as f:
        if info.tiled:
            tw, tl = info.tile_size
            offsets = info._get(T_TILE_OFFSETS)
            ntx = -(-info.width // tw)
            for i, off in enumerate(offsets):
                ty, tx = divmod(i, ntx)
                f.seek(int(off))
                tile = np.frombuffer(f.read(tw * tl * info.dtype.itemsize *
                                            info.bands), dt)
                tile = tile.reshape((tl, tw) + shape_c).astype(info.dtype)
                ys, xs = ty * tl, tx * tw
                hh = min(tl, info.height - ys)
                ww = min(tw, info.width - xs)
                out[ys:ys + hh, xs:xs + ww] = tile[:hh, :ww]
        else:
            offsets = info._get(T_STRIP_OFFSETS)
            counts = info._get(T_STRIP_COUNTS)
            rows_per = int(info._get(T_ROWS_PER_STRIP, [info.height])[0])
            row = 0
            for off, cnt in zip(offsets, counts):
                f.seek(int(off))
                strip = np.frombuffer(f.read(int(cnt)), dt)
                nrows = min(rows_per, info.height - row)
                strip = strip.reshape((nrows, info.width) + shape_c)
                out[row:row + nrows] = strip.astype(info.dtype)
                row += nrows
    return out, info


def read_tiff_region(path: str, x0: int, y0: int, w: int, h: int) -> np.ndarray:
    """Read a sub-region without loading the whole file (tile-aligned reads
    from tiled files; row reads from stripped files) — the IO primitive under
    the lazy :class:`~visionworkbench_torch.fileio.disk_image.DiskImageView`."""
    info = TiffInfo(path)
    if info.compression != 1:
        arr, _ = read_tiff(path)
        return arr[y0:y0 + h, x0:x0 + w]
    e = "<" if info.order == "II" else ">"
    dt = info.dtype.newbyteorder(e)
    shape_c = (info.bands,) if info.bands > 1 else ()
    out = np.zeros((h, w) + shape_c, info.dtype)
    with open(path, "rb") as f:
        if info.tiled:
            tw, tl = info.tile_size
            offsets = info._get(T_TILE_OFFSETS)
            ntx = -(-info.width // tw)
            ty0, ty1 = y0 // tl, (y0 + h - 1) // tl
            tx0, tx1 = x0 // tw, (x0 + w - 1) // tw
            for ty in range(ty0, ty1 + 1):
                for tx in range(tx0, tx1 + 1):
                    idx = ty * ntx + tx
                    if idx >= len(offsets):
                        continue
                    f.seek(int(offsets[idx]))
                    tile = np.frombuffer(
                        f.read(tw * tl * info.dtype.itemsize * info.bands), dt)
                    tile = tile.reshape((tl, tw) + shape_c)
                    gy, gx = ty * tl, tx * tw
                    sy0 = max(y0, gy); sy1 = min(y0 + h, gy + tl)
                    sx0 = max(x0, gx); sx1 = min(x0 + w, gx + tw)
                    if sy1 <= sy0 or sx1 <= sx0:
                        continue
                    out[sy0 - y0:sy1 - y0, sx0 - x0:sx1 - x0] = \
                        tile[sy0 - gy:sy1 - gy, sx0 - gx:sx1 - gx].astype(info.dtype)
        else:
            rows_per = int(info._get(T_ROWS_PER_STRIP, [info.height])[0])
            offsets = info._get(T_STRIP_OFFSETS)
            row_bytes = info.width * info.dtype.itemsize * info.bands
            for r in range(y0, y0 + h):
                strip_idx = r // rows_per
                within = r - strip_idx * rows_per
                f.seek(int(offsets[strip_idx]) + within * row_bytes)
                line = np.frombuffer(f.read(row_bytes), dt).reshape(
                    (info.width,) + shape_c)
                out[r - y0] = line[x0:x0 + w].astype(info.dtype)
    return out


class TiffTileWriter:
    """Incremental tiled TIFF writer: tiles stream to disk as produced (in
    any order), the offset table and IFD are written at close. This is the
    storage half of the ordered block-writer pipeline (ref
    ``ThreadedBlockWriter``, ImageIO.h:116-267)."""

    def __init__(self, path: str, height: int, width: int, bands: int, dtype,
                 tile_size: int = 256, georef=None,
                 nodata: Optional[float] = None):
        if tile_size % 16:
            raise ArgumentErr("tiff tile size must be a multiple of 16")
        self.path = path
        self.h, self.w, self.bands = int(height), int(width), int(bands)
        self.dtype = np.dtype(dtype)
        self.ts = int(tile_size)
        self.ntx = -(-self.w // self.ts)
        self.nty = -(-self.h // self.ts)
        self._offsets = [0] * (self.ntx * self.nty)
        self._counts = [0] * (self.ntx * self.nty)
        self._georef = georef
        self._nodata = nodata
        self._f = open(path, "wb")
        self._f.write(struct.pack("<2sHI", b"II", 42, 0))

    def write_tile(self, tx: int, ty: int, tile: np.ndarray) -> None:
        ts = self.ts
        full = np.zeros((ts, ts) + ((self.bands,) if self.bands > 1 else ()),
                        self.dtype)
        full[:tile.shape[0], :tile.shape[1]] = tile
        data = full.astype(self.dtype.newbyteorder("<")).tobytes()
        idx = ty * self.ntx + tx
        self._offsets[idx] = self._f.tell()
        self._counts[idx] = len(data)
        self._f.write(data)

    def close(self) -> None:
        ifd = _IFDWriter()
        _build_ifd(ifd, self.h, self.w, self.bands, self.dtype,
                   self._georef, self._nodata)
        ifd.add(T_TILE_W, 3, self.ts)
        ifd.add(T_TILE_L, 3, self.ts)
        ifd.add(T_TILE_OFFSETS, 4, self._offsets)
        ifd.add(T_TILE_COUNTS, 4, self._counts)
        off = self._f.tell()
        if off % 2:
            self._f.write(b"\x00")
            off += 1
        self._f.write(ifd.serialize(off))
        self._f.seek(4)
        self._f.write(struct.pack("<I", off))
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
