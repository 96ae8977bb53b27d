"""OpenEXR scanline codec, in-tree (a copy of
``visionworkbench_tpu/fileio/exr.py``, which imports no JAX; ref ``DiskImageResourceOpenEXR.cc`` —
the reference's EXR resource wraps libIlmImf; this is a from-scratch
implementation of the OpenEXR 2.0 scanline format, closing the §2.4 format
gap without an external library).

Scope (matching what the reference's resource exercises):
* read: single-part scanline images, NO_COMPRESSION / ZIPS / ZIP, pixel
  types HALF / FLOAT / UINT, arbitrary channel lists (returned as float32
  planes in alphabetical channel order, the file's storage order)
* write: NO_COMPRESSION (always valid EXR) or ZIP via zlib, HALF or FLOAT
  storage, 1-channel ("Y") or N-channel images

The float pipeline stores fp32 (``FLOAT``) by default — lossless round
trips for the framework's native dtype.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from visionworkbench_torch.core.exceptions import ArgumentErr, IOErr

_MAGIC = b"\x76\x2f\x31\x01"
_PT_UINT, _PT_HALF, _PT_FLOAT = 0, 1, 2
_PT_DTYPE = {_PT_UINT: np.uint32, _PT_HALF: np.float16, _PT_FLOAT: np.float32}
_NO_COMPRESSION, _RLE, _ZIPS, _ZIP = 0, 1, 2, 3
_LINES_PER_BLOCK = {_NO_COMPRESSION: 1, _ZIPS: 1, _ZIP: 16}


def _attr(name: bytes, atype: bytes, data: bytes) -> bytes:
    return name + b"\0" + atype + b"\0" + struct.pack("<i", len(data)) + data


def _chlist(channels: List[Tuple[str, int]]) -> bytes:
    out = b""
    for name, ptype in channels:
        out += name.encode() + b"\0" + struct.pack("<iBBBBii", ptype,
                                                   0, 0, 0, 0, 1, 1)
    return out + b"\0"


def _zip_compress(raw: bytes) -> bytes:
    """EXR ZIP: delta-predict then split into two interleaved halves,
    then deflate (ImfZip.cpp)."""
    a = np.frombuffer(raw, np.uint8).astype(np.int16)
    d = np.empty_like(a)
    d[0] = a[0]
    d[1:] = (a[1:] - a[:-1] + 128) & 0xFF
    n = len(d)
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[:half] = d[0::2].astype(np.uint8)
    out[half:] = d[1::2].astype(np.uint8)
    return zlib.compress(out.tobytes())


def _zip_decompress(data: bytes, expected: int) -> bytes:
    raw = zlib.decompress(data)
    if len(raw) != expected:
        raise IOErr("EXR: ZIP block size mismatch")
    t = np.frombuffer(raw, np.uint8)
    n = len(t)
    half = (n + 1) // 2
    inter = np.empty(n, np.uint8)
    inter[0::2] = t[:half]
    inter[1::2] = t[half:]
    # undo delta predictor
    d = inter.astype(np.int64)
    d[1:] -= 128
    out = np.cumsum(d) & 0xFF
    return out.astype(np.uint8).tobytes()


def write_exr(path: str, image, channel_names: Optional[List[str]] = None,
              pixel_type: str = "float", compression: str = "none") -> None:
    """Write (H, W) or (H, W, C) data as a scanline EXR.

    ``pixel_type``: "float" (fp32, lossless for the pipeline) or "half".
    ``compression``: "none" or "zip"."""
    arr = np.asarray(image)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.ndim != 3:
        raise ArgumentErr("write_exr: expected (H, W[, C]) data")
    h, w, c = arr.shape
    if channel_names is None:
        channel_names = (["Y"] if c == 1 else
                         ["R", "G", "B", "A"][:c] if c <= 4 else
                         [f"C{i}" for i in range(c)])
    if len(channel_names) != c:
        raise ArgumentErr("write_exr: channel_names/channels mismatch")
    ptype = {"float": _PT_FLOAT, "half": _PT_HALF}.get(pixel_type)
    if ptype is None:
        raise ArgumentErr(f"write_exr: unknown pixel_type {pixel_type!r}")
    comp = {"none": _NO_COMPRESSION, "zip": _ZIP,
            "zips": _ZIPS}.get(compression)
    if comp is None:
        raise ArgumentErr(f"write_exr: unknown compression {compression!r}")
    dt = np.dtype(_PT_DTYPE[ptype]).newbyteorder("<")
    # channels stored in alphabetical order (OpenEXR requirement)
    order = sorted(range(c), key=lambda i: channel_names[i])
    chans = [(channel_names[i], ptype) for i in order]
    planes = [np.ascontiguousarray(arr[:, :, i]).astype(dt) for i in order]

    header = b""
    header += _attr(b"channels", b"chlist", _chlist(chans))
    header += _attr(b"compression", b"compression", struct.pack("<B", comp))
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header += _attr(b"dataWindow", b"box2i", box)
    header += _attr(b"displayWindow", b"box2i", box)
    header += _attr(b"lineOrder", b"lineOrder", b"\0")
    header += _attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
    header += _attr(b"screenWindowCenter", b"v2f",
                    struct.pack("<ff", 0.0, 0.0))
    header += _attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
    header += b"\0"

    lpb = _LINES_PER_BLOCK[comp]
    n_blocks = -(-h // lpb)
    blocks = []
    for b in range(n_blocks):
        y0 = b * lpb
        ny = min(lpb, h - y0)
        # per EXR: within a block, scanlines in order; per scanline all
        # channels in chlist order
        raw = b"".join(p[y0 + j].tobytes()
                       for j in range(ny) for p in planes)
        if comp in (_ZIP, _ZIPS):
            cdata = _zip_compress(raw)
            if len(cdata) >= len(raw):   # spec: store raw when not smaller
                cdata = raw
        else:
            cdata = raw
        blocks.append((y0, cdata))

    with open(path, "wb") as f:
        f.write(_MAGIC + struct.pack("<I", 2))
        f.write(header)
        table_pos = f.tell()
        f.write(b"\0" * 8 * n_blocks)
        offsets = []
        for y0, cdata in blocks:
            offsets.append(f.tell())
            f.write(struct.pack("<ii", y0, len(cdata)) + cdata)
        f.seek(table_pos)
        f.write(struct.pack("<%dQ" % n_blocks, *offsets))


def _read_header(data: bytes, pos: int):
    attrs = {}
    while True:
        end = data.index(b"\0", pos)
        name = data[pos:end]
        pos = end + 1
        if name == b"":
            break
        end = data.index(b"\0", pos)
        atype = data[pos:end]
        pos = end + 1
        (size,) = struct.unpack("<i", data[pos:pos + 4])
        pos += 4
        attrs[name.decode()] = (atype.decode(), data[pos:pos + size])
        pos += size
    return attrs, pos


def read_exr(path: str):
    """Read a scanline EXR. Returns ``(array, channel_names)`` where array
    is (H, W) float32 for single-channel files, else (H, W, C) with C in
    the file's (alphabetical) channel order."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != _MAGIC:
        raise IOErr(f"read_exr: {path!r} is not an EXR file")
    version = struct.unpack("<I", data[4:8])[0]
    if version & 0x200:
        raise IOErr("read_exr: multi-part EXR not supported")
    if version & 0x800:
        raise IOErr("read_exr: deep-data EXR not supported")
    attrs, pos = _read_header(data, 8)
    if "channels" not in attrs or "dataWindow" not in attrs:
        raise IOErr("read_exr: missing required attributes")
    comp = attrs["compression"][1][0]
    if comp not in (_NO_COMPRESSION, _ZIPS, _ZIP):
        raise IOErr(f"read_exr: unsupported compression {comp}")
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1][:16])
    h, w = y1 - y0 + 1, x1 - x0 + 1

    chans = []
    cdata = attrs["channels"][1]
    cpos = 0
    while cdata[cpos] != 0:
        end = cdata.index(b"\0", cpos)
        cname = cdata[cpos:end].decode()
        ptype, _pl, _r0, _r1, _r2, xs, ys = struct.unpack(
            "<iBBBBii", cdata[end + 1:end + 17])
        if xs != 1 or ys != 1:
            raise IOErr("read_exr: subsampled channels not supported")
        chans.append((cname, ptype))
        cpos = end + 17

    lpb = _LINES_PER_BLOCK[comp]
    n_blocks = -(-h // lpb)
    table = struct.unpack("<%dQ" % n_blocks, data[pos:pos + 8 * n_blocks])
    bytes_per_px = {ch: np.dtype(_PT_DTYPE[pt]).itemsize
                    for ch, pt in chans}
    line_bytes = sum(bytes_per_px[ch] * w for ch, _ in chans)
    planes = {ch: np.empty((h, w), _PT_DTYPE[pt]) for ch, pt in chans}
    for off in table:
        y, size = struct.unpack("<ii", data[off:off + 8])
        block = data[off + 8:off + 8 + size]
        ny = min(lpb, y1 - y + 1)
        expected = line_bytes * ny
        if comp in (_ZIP, _ZIPS) and size != expected:
            block = _zip_decompress(block, expected)
        bpos = 0
        for j in range(ny):
            for ch, pt in chans:
                dt = np.dtype(_PT_DTYPE[pt]).newbyteorder("<")
                nb = dt.itemsize * w
                row = np.frombuffer(block[bpos:bpos + nb], dt)
                planes[ch][y - y0 + j] = row
                bpos += nb
    names = [ch for ch, _ in chans]
    out = np.stack([planes[ch].astype(np.float32) for ch in names], -1)
    if out.shape[-1] == 1:
        out = out[:, :, 0]
    return out, names
