"""In-tree EXIF parser (port of ``visionworkbench_tpu/camera/exif.py``, its
code copied; ref ``src/vw/Camera/ExifData.cc`` — the reference
carries its own binary TIFF/EXIF IFD walker; consumer:
``tools/print_exif.cc``). No PIL: JPEG APP1 segments and bare TIFF headers
are parsed directly (both endiannesses, all twelve TIFF value types, IFD0 +
the EXIF and GPS sub-IFDs). The accessors mirror the reference's
``ExifView`` convenience queries (``Exif.h``)."""

from __future__ import annotations

import struct
from typing import Dict, Optional

from visionworkbench_torch.core.exceptions import IOErr

# TIFF value types: (size in bytes, struct code or None) — ExifData.cc's
# type table.
_TYPES = {
    1: (1, "B"),    # BYTE
    2: (1, None),   # ASCII
    3: (2, "H"),    # SHORT
    4: (4, "I"),    # LONG
    5: (8, None),   # RATIONAL
    6: (1, "b"),    # SBYTE
    7: (1, None),   # UNDEFINED
    8: (2, "h"),    # SSHORT
    9: (4, "i"),    # SLONG
    10: (8, None),  # SRATIONAL
    11: (4, "f"),   # FLOAT
    12: (8, "d"),   # DOUBLE
}

# The tags the reference's ExifData/ExifView actually surface, plus common
# IFD0 metadata (tag id -> name).
_TAG_NAMES = {
    0x010F: "Make", 0x0110: "Model", 0x0112: "Orientation",
    0x011A: "XResolution", 0x011B: "YResolution", 0x0128: "ResolutionUnit",
    0x0131: "Software", 0x0132: "DateTime", 0x0213: "YCbCrPositioning",
    0x8769: "ExifOffset", 0x8825: "GPSInfo",
    0x829A: "ExposureTime", 0x829D: "FNumber", 0x8822: "ExposureProgram",
    0x8827: "ISOSpeedRatings", 0x9000: "ExifVersion",
    0x9003: "DateTimeOriginal", 0x9004: "DateTimeDigitized",
    0x9201: "ShutterSpeedValue", 0x9202: "ApertureValue",
    0x9203: "BrightnessValue", 0x9204: "ExposureBiasValue",
    0x9205: "MaxApertureValue", 0x9206: "SubjectDistance",
    0x9207: "MeteringMode", 0x9208: "LightSource", 0x9209: "Flash",
    0x920A: "FocalLength", 0xA002: "PixelXDimension",
    0xA003: "PixelYDimension", 0xA405: "FocalLengthIn35mmFilm",
    0xA406: "SceneCaptureType", 0xA407: "GainControl",
    0xA408: "Contrast", 0xA409: "Saturation", 0xA40A: "Sharpness",
    0x0100: "ImageWidth", 0x0101: "ImageLength",
    0x0102: "BitsPerSample", 0x0103: "Compression",
    0x011C: "PlanarConfiguration", 0x0115: "SamplesPerPixel",
}


def _read_values(data: bytes, endian: str, ttype: int, count: int,
                 off: int):
    size, code = _TYPES.get(ttype, (1, "B"))
    total = size * count
    raw = data[off:off + total]
    if len(raw) < total:
        return None
    if ttype == 2:                     # ASCII, NUL-terminated
        return raw.split(b"\0")[0].decode("ascii", "replace")
    if ttype == 7:                     # UNDEFINED: raw bytes
        return raw
    if ttype in (5, 10):               # (S)RATIONAL pairs
        code2 = ("I", "i")[ttype == 10]
        vals = [tuple(struct.unpack(endian + code2 + code2,
                                    raw[i * 8:(i + 1) * 8]))
                for i in range(count)]
    else:
        vals = list(struct.unpack(endian + code * count, raw))
    return vals[0] if count == 1 else tuple(vals)


def _parse_ifd(data: bytes, endian: str, off: int, tags: Dict[str, object],
               depth: int = 0) -> int:
    """Walk one IFD, filling ``tags``; returns the next-IFD offset
    (ref ``ExifData::process_tiff_header`` / ``parse_tiff_ifd``)."""
    if off + 2 > len(data) or depth > 4:
        return 0
    (n,) = struct.unpack(endian + "H", data[off:off + 2])
    pos = off + 2
    for _ in range(n):
        if pos + 12 > len(data):
            break
        tag, ttype, count = struct.unpack(endian + "HHI", data[pos:pos + 8])
        size, _code = _TYPES.get(ttype, (1, "B"))
        total = size * count
        if total <= 4:
            voff = pos + 8
        else:
            (voff,) = struct.unpack(endian + "I", data[pos + 8:pos + 12])
        val = _read_values(data, endian, ttype, count, voff)
        name = _TAG_NAMES.get(tag, f"Tag{tag:04X}")
        if tag in (0x8769, 0x8825):    # EXIF / GPS sub-IFD pointers
            if isinstance(val, int):
                _parse_ifd(data, endian, val, tags, depth + 1)
        elif val is not None:
            tags.setdefault(name, val)
        pos += 12
    if pos + 4 <= len(data):
        (nxt,) = struct.unpack(endian + "I", data[pos:pos + 4])
        return nxt
    return 0


def parse_tiff_exif(data: bytes) -> Dict[str, object]:
    """Parse a TIFF header blob (the contents of a JPEG ``Exif\\0\\0``
    segment, or a bare .tif file) into a name -> value dict."""
    if len(data) < 8:
        raise IOErr("EXIF TIFF blob too short")
    if data[:2] == b"II":
        endian = "<"
    elif data[:2] == b"MM":
        endian = ">"
    else:
        raise IOErr("EXIF: bad TIFF byte-order marker")
    (magic,) = struct.unpack(endian + "H", data[2:4])
    if magic != 42:
        raise IOErr("EXIF: bad TIFF magic")
    (ifd0,) = struct.unpack(endian + "I", data[4:8])
    tags: Dict[str, object] = {}
    nxt = _parse_ifd(data, endian, ifd0, tags)
    if nxt:                            # IFD1 (thumbnail) — parsed, low prio
        _parse_ifd(data, endian, nxt, tags, depth=1)
    return tags


def _jpeg_exif_segment(data: bytes) -> Optional[bytes]:
    """Find the APP1 ``Exif\\0\\0`` segment of a JPEG stream
    (ref ``ExifData::import_data``'s JPEG marker walk)."""
    if data[:2] != b"\xff\xd8":
        return None
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        if marker == 0xD9 or marker == 0xDA:   # EOI / SOS: no EXIF past here
            return None
        (seglen,) = struct.unpack(">H", data[pos + 2:pos + 4])
        seg = data[pos + 4:pos + 2 + seglen]
        if marker == 0xE1 and seg[:6] == b"Exif\x00\x00":
            return seg[6:]
        pos += 2 + seglen
    return None


def _ratio(v) -> Optional[float]:
    """EXIF rationals are (numerator, denominator) tuples here."""
    if isinstance(v, tuple) and len(v) == 2 and not isinstance(v[0], tuple):
        try:
            return float(v[0]) / float(v[1])
        except (TypeError, ValueError, ZeroDivisionError):
            return None
    try:
        return float(v)
    except (TypeError, ValueError):
        return None


class ExifView:
    """(ref ``ExifView``, Exif.h — accessors over the in-tree parser)"""

    def __init__(self, path: str):
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError as e:
            raise IOErr(f"ExifView: cannot open {path!r}: {e}")
        seg = _jpeg_exif_segment(data)
        if seg is not None:
            self.tags = parse_tiff_exif(seg)
        elif data[:2] in (b"II", b"MM"):
            self.tags = parse_tiff_exif(data)
        else:
            self.tags = {}

    def get_f_number(self) -> Optional[float]:
        return _ratio(self.tags.get("FNumber"))

    def get_exposure_time(self) -> Optional[float]:
        return _ratio(self.tags.get("ExposureTime"))

    def get_iso(self) -> Optional[float]:
        return _ratio(self.tags.get("ISOSpeedRatings"))

    def get_focal_length_35mm_equiv(self) -> Optional[float]:
        return _ratio(self.tags.get("FocalLengthIn35mmFilm")
                      or self.tags.get("FocalLength"))

    def get_average_luminance(self) -> Optional[float]:
        """Brightness estimate from aperture/exposure/ISO
        (ref ``ExifView::get_average_luminance``)."""
        f = self.get_f_number()
        t = self.get_exposure_time()
        iso = self.get_iso() or 100.0
        if not f or not t:
            return None
        return (f * f) / (t * iso) * 12.5

    def camera_make(self) -> Optional[str]:
        v = self.tags.get("Make")
        return str(v) if v is not None else None

    def camera_model(self) -> Optional[str]:
        v = self.tags.get("Model")
        return str(v) if v is not None else None

    def items(self):
        return self.tags.items()
