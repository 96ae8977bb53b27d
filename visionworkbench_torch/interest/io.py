"""Interest point / match file IO (a copy of
``visionworkbench_tpu/interest/io.py``, which imports no JAX), binary-compatible
with the reference's ``.vwip`` / ``.match`` formats (ref
``src/vw/InterestPoint/MatcherIO.cc:248-380``).

Record layout (little-endian): x, y (f32); ix, iy (i32); orientation, scale,
interest (f32); polarity (u8); octave, scale_lvl (u32); descriptor length
(u64) then f64 descriptor values. Files begin with a u64 point count; a
``.match`` file is two concatenated lists.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Tuple

import numpy as np

from visionworkbench_torch.core.exceptions import IOErr

_HDR = struct.Struct("<ffiifffBII")


def _write_record(f, x, y, scale, orientation, interest, descriptor):
    f.write(_HDR.pack(float(x), float(y), int(x), int(y), float(orientation),
                      float(scale), float(interest), 1, 0, 0))
    d = np.asarray(descriptor, np.float64) if descriptor is not None else np.zeros(0)
    f.write(struct.pack("<Q", d.size))
    f.write(d.tobytes())


def _read_record(f) -> Dict:
    raw = f.read(_HDR.size)
    if len(raw) < _HDR.size:
        raise IOErr("Failed to read interest point from file.")
    x, y, ix, iy, orientation, scale, interest, polarity, octave, scale_lvl = \
        _HDR.unpack(raw)
    (n,) = struct.unpack("<Q", f.read(8))
    desc = np.frombuffer(f.read(8 * n), np.float64, n)
    return {"x": x, "y": y, "orientation": orientation, "scale": scale,
            "interest": interest, "descriptor": desc}


def _records_from_dict(d: Dict) -> List[Tuple]:
    n = len(d["x"])
    desc = d.get("descriptor")
    return [(d["x"][i], d["y"][i], d.get("scale", np.ones(n))[i],
             d.get("orientation", np.zeros(n))[i],
             d.get("interest", np.zeros(n))[i],
             None if desc is None else desc[i]) for i in range(n)]


def write_binary_ip_file(path: str, points: Dict) -> None:
    """(ref ``write_binary_ip_file``, MatcherIO.cc:292-303)"""
    recs = _records_from_dict(points)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(recs)))
        for r in recs:
            _write_record(f, *r)


def _dict_from_records(recs: List[Dict]) -> Dict:
    if not recs:
        return {"x": np.zeros(0, np.float32), "y": np.zeros(0, np.float32),
                "scale": np.zeros(0, np.float32),
                "orientation": np.zeros(0, np.float32),
                "interest": np.zeros(0, np.float32)}
    out = {k: np.array([r[k] for r in recs], np.float32)
           for k in ("x", "y", "scale", "orientation", "interest")}
    dlen = max(len(r["descriptor"]) for r in recs)
    if dlen:
        out["descriptor"] = np.stack([
            np.pad(r["descriptor"], (0, dlen - len(r["descriptor"])))
            for r in recs]).astype(np.float32)
    return out


def read_binary_ip_file(path: str) -> Dict:
    """(ref ``read_binary_ip_file``, MatcherIO.cc:305-321)"""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        recs = [_read_record(f) for _ in range(n)]
    return _dict_from_records(recs)


def write_binary_match_file(path: str, points1: Dict, points2: Dict) -> None:
    """(ref ``write_binary_match_file``, MatcherIO.cc:330-350)"""
    r1 = _records_from_dict(points1)
    r2 = _records_from_dict(points2)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(r1)))
        f.write(struct.pack("<Q", len(r2)))
        for r in r1:
            _write_record(f, *r)
        for r in r2:
            _write_record(f, *r)


def read_binary_match_file(path: str) -> Tuple[Dict, Dict]:
    """(ref ``read_binary_match_file``, MatcherIO.cc:352-380)"""
    with open(path, "rb") as f:
        n1, n2 = struct.unpack("<QQ", f.read(16))
        r1 = [_read_record(f) for _ in range(n1)]
        r2 = [_read_record(f) for _ in range(n2)]
    return _dict_from_records(r1), _dict_from_records(r2)


def match_filename(prefix: str, image1: str, image2: str) -> str:
    """(ref ``match_filename``, InterestPointUtils)"""
    b1 = os.path.splitext(os.path.basename(image1))[0]
    b2 = os.path.splitext(os.path.basename(image2))[0]
    return f"{prefix}{b1}__{b2}.match"


def write_text_match_file(path: str, points1: Dict, points2: Dict) -> None:
    """Plain-text match file: 'x1 y1 scale1 x2 y2 scale2' per line, 9-digit
    precision (ref ``write_text_match_file``, MatcherIO.cc:378-404)."""
    if not path.lower().endswith(".txt"):
        raise IOErr(f"Text match file must have .txt extension: {path}")
    n = len(points1["x"])
    if n != len(points2["x"]):
        raise IOErr("The vectors of matching interest points must have the "
                    "same size.")
    s1 = np.asarray(points1.get("scale", np.ones(n)))
    s2 = np.asarray(points2.get("scale", np.ones(n)))
    with open(path, "w") as f:
        for i in range(n):
            f.write(f"{points1['x'][i]:.9g} {points1['y'][i]:.9g} "
                    f"{s1[i]:.9g} {points2['x'][i]:.9g} "
                    f"{points2['y'][i]:.9g} {s2[i]:.9g}\n")


def read_text_match_file(path: str) -> Tuple[Dict, Dict]:
    """(ref ``read_text_match_file``, MatcherIO.cc:447-500)"""
    if not path.lower().endswith(".txt"):
        raise IOErr(f"Text match file must have .txt extension: {path}")
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 6:
                rows.append([float(v) for v in parts[:6]])
    a = np.asarray(rows, np.float64).reshape(-1, 6)
    zeros = np.zeros(len(a), np.float32)
    mk = lambda x, y, s: {"x": x.astype(np.float32),          # noqa: E731
                          "y": y.astype(np.float32),
                          "scale": s.astype(np.float32),
                          "orientation": zeros, "interest": zeros,
                          "descriptor": np.zeros((len(a), 0), np.float32)}
    return mk(a[:, 0], a[:, 1], a[:, 2]), mk(a[:, 3], a[:, 4], a[:, 5])
