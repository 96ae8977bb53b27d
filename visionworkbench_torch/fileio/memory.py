"""In-memory image encode/decode (a copy of
``visionworkbench_tpu/fileio/memory.py``, which imports no JAX; ref
``MemoryImageResource``, ``src/vw/FileIO/MemoryImageResource.cc``) and
minimal PDS3 raster reading (ref ``DiskImageResourcePDS.cc``)."""

from __future__ import annotations

import io
import re
from typing import Dict, Optional, Tuple

import numpy as np

from visionworkbench_torch.core.exceptions import ArgumentErr, IOErr


def encode_image(array: np.ndarray, format: str = "png") -> bytes:
    """Encode (H, W[, C]) pixels to PNG/JPEG bytes in RAM."""
    from PIL import Image
    array = np.asarray(array)
    if array.dtype.kind == "f":
        array = (np.clip(array, 0, 1) * 255 + 0.5).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(array).save(buf, format=format.upper().replace("JPG", "JPEG"))
    return buf.getvalue()


def decode_image(data: bytes, dtype=None) -> np.ndarray:
    """Decode encoded image bytes."""
    from PIL import Image
    with Image.open(io.BytesIO(data)) as im:
        arr = np.asarray(im)
    if dtype is not None and np.dtype(dtype).kind == "f" and arr.dtype.kind in "ui":
        return arr.astype(dtype) / np.iinfo(arr.dtype).max
    return arr if dtype is None else arr.astype(dtype)


_PDS_SAMPLE_TYPES = {
    ("MSB_INTEGER", 16): ">i2", ("MSB_UNSIGNED_INTEGER", 16): ">u2",
    ("MSB_INTEGER", 32): ">i4", ("MSB_UNSIGNED_INTEGER", 8): ">u1",
    ("LSB_INTEGER", 16): "<i2", ("LSB_UNSIGNED_INTEGER", 16): "<u2",
    ("LSB_INTEGER", 32): "<i4", ("LSB_UNSIGNED_INTEGER", 8): "<u1",
    ("UNSIGNED_INTEGER", 8): ">u1",
    ("IEEE_REAL", 32): ">f4", ("PC_REAL", 32): "<f4",
    ("IEEE_REAL", 64): ">f8", ("PC_REAL", 64): "<f8",
}


def parse_pds_label(text: str) -> Dict[str, str]:
    """KEY = VALUE pairs from a PDS3 label (flat; last wins per key)."""
    out: Dict[str, str] = {}
    for line in text.splitlines():
        line = line.split("/*")[0].strip()
        m = re.match(r"^\^?([A-Z0-9_:]+)\s*=\s*(.+)$", line)
        if m:
            out[m.group(1)] = m.group(2).strip().strip('"')
    return out


def read_pds(path: str) -> Tuple[np.ndarray, Dict[str, str]]:
    """Read an attached-label PDS3 image (ref ``DiskImageResourcePDS``).

    Supports the common LINES/LINE_SAMPLES/SAMPLE_BITS/SAMPLE_TYPE layout
    with RECORD_BYTES x (^IMAGE - 1) data offset.
    """
    with open(path, "rb") as f:
        raw = f.read()
    # Label is ASCII up to the END keyword.
    end = raw.find(b"\nEND")
    header = raw[: end + 4 if end >= 0 else 4096].decode("ascii", "replace")
    label = parse_pds_label(header)
    try:
        lines = int(label["LINES"])
        samples = int(label["LINE_SAMPLES"])
        bits = int(label.get("SAMPLE_BITS", "8"))
        stype = label.get("SAMPLE_TYPE", "MSB_UNSIGNED_INTEGER")
        bands = int(label.get("BANDS", "1"))
    except (KeyError, ValueError) as e:
        raise IOErr(f"read_pds: missing/invalid label field in {path!r}: {e}")
    dt = _PDS_SAMPLE_TYPES.get((stype, bits))
    if dt is None:
        raise IOErr(f"read_pds: unsupported SAMPLE_TYPE {stype}/{bits}")
    record_bytes = int(label.get("RECORD_BYTES", "0"))
    image_ptr = label.get("IMAGE", "1")
    try:
        rec = int(re.sub(r"[^0-9]", "", image_ptr.split("<")[0]) or 1)
    except ValueError:
        rec = 1
    offset = record_bytes * (rec - 1) if record_bytes else (end + 4 if end >= 0 else 0)
    count = lines * samples * bands
    arr = np.frombuffer(raw, np.dtype(dt), count, offset)
    if bands > 1:
        arr = arr.reshape(bands, lines, samples).transpose(1, 2, 0)
    else:
        arr = arr.reshape(lines, samples)
    return arr.astype(arr.dtype.newbyteorder("=")), label


def write_pds(path: str, array: np.ndarray,
              extra_label: Optional[Dict[str, str]] = None) -> None:
    """Write a simple attached-label PDS3 image."""
    array = np.ascontiguousarray(array)
    if array.ndim != 2:
        raise ArgumentErr("write_pds: 2D images only")
    dt = array.dtype
    stype, bits = {
        np.dtype(np.uint8): ("MSB_UNSIGNED_INTEGER", 8),
        np.dtype(np.uint16): ("MSB_UNSIGNED_INTEGER", 16),
        np.dtype(np.int16): ("MSB_INTEGER", 16),
        np.dtype(np.float32): ("IEEE_REAL", 32),
    }.get(dt, (None, None))
    if stype is None:
        raise ArgumentErr(f"write_pds: unsupported dtype {dt}")
    record = 512
    fields = {
        "PDS_VERSION_ID": "PDS3",
        "RECORD_TYPE": "FIXED_LENGTH",
        "RECORD_BYTES": str(record),
        "^IMAGE": "2",
        "LINES": str(array.shape[0]),
        "LINE_SAMPLES": str(array.shape[1]),
        "SAMPLE_BITS": str(bits),
        "SAMPLE_TYPE": stype,
        "BANDS": "1",
    }
    fields.update(extra_label or {})
    label = "\r\n".join(f"{k} = {v}" for k, v in fields.items()) + "\r\nEND"
    label_bytes = label.encode().ljust(record, b" ")
    with open(path, "wb") as f:
        f.write(label_bytes)
        f.write(array.astype(dt.newbyteorder(">")).tobytes())
