"""Minimal ESRI shapefile polygon/polyline IO (port of
``visionworkbench_tpu/cartography/shapefile.py``, its code copied; ref
``shapeFile.cc``, ``src/vw/Cartography/shapeFile.cc`` -- OGR-backed in the
reference; self-contained codec here: .shp + .shx written, .dbf stubbed).
Host code; the files are byte for byte the JAX package's.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

from visionworkbench_torch.core.exceptions import IOErr
from visionworkbench_torch.geometry.polygon import Polygon

SHP_POLYGON = 5
SHP_POLYLINE = 3


def write_shapefile(path: str, polygons: List[Polygon],
                    shape_type: int = SHP_POLYGON) -> None:
    """Write polygons to ``path``(.shp) with its .shx (and empty .dbf)."""
    base = path[:-4] if path.lower().endswith(".shp") else path
    records = []
    gxmin = gymin = float("inf")
    gxmax = gymax = float("-inf")
    for num, poly in enumerate(polygons, start=1):
        rings = [np.asarray(r, np.float64) for r in poly.rings]
        # close rings
        rings = [np.vstack([r, r[:1]]) if not np.allclose(r[0], r[-1]) else r
                 for r in rings]
        npoints = sum(len(r) for r in rings)
        box = poly.bbox()
        gxmin = min(gxmin, box.min_x); gymin = min(gymin, box.min_y)
        gxmax = max(gxmax, box.max_x); gymax = max(gymax, box.max_y)
        content = struct.pack("<i4d", shape_type, box.min_x, box.min_y,
                              box.max_x, box.max_y)
        content += struct.pack("<ii", len(rings), npoints)
        offset = 0
        for r in rings:
            content += struct.pack("<i", offset)
            offset += len(r)
        for r in rings:
            for x, y in r:
                content += struct.pack("<2d", x, y)
        records.append((num, content))

    def header(total_bytes):
        h = struct.pack(">i5i", 9994, 0, 0, 0, 0, 0)
        h += struct.pack(">i", total_bytes // 2)
        h += struct.pack("<ii", 1000, shape_type)
        h += struct.pack("<4d", gxmin, gymin, gxmax, gymax)
        h += struct.pack("<4d", 0, 0, 0, 0)
        return h

    shp_len = 100 + sum(8 + len(c) for _, c in records)
    with open(base + ".shp", "wb") as f:
        f.write(header(shp_len))
        for num, content in records:
            f.write(struct.pack(">ii", num, len(content) // 2))
            f.write(content)
    shx_len = 100 + 8 * len(records)
    with open(base + ".shx", "wb") as f:
        f.write(header(shx_len))
        off = 100
        for num, content in records:
            f.write(struct.pack(">ii", off // 2, len(content) // 2))
            off += 8 + len(content)
    # Minimal empty dBase file so GIS tools accept the set.
    with open(base + ".dbf", "wb") as f:
        n = len(records)
        f.write(struct.pack("<B3BIHH20x", 3, 26, 1, 1, n, 33 + 32, 2))
        f.write(b"ID" + b"\x00" * 9 + b"N" + b"\x00" * 4 +
                struct.pack("<BB14x", 1, 0))
        f.write(b"\x0d")
        for _ in range(n):
            f.write(b" 0")
        f.write(b"\x1a")


def read_shapefile(path: str) -> Tuple[List[Polygon], int]:
    """Read polygons/polylines; returns (polygons, shape_type)."""
    base = path[:-4] if path.lower().endswith(".shp") else path
    try:
        data = open(base + ".shp", "rb").read()
    except OSError as e:
        raise IOErr(f"read_shapefile: {e}")
    if len(data) < 100 or struct.unpack(">i", data[:4])[0] != 9994:
        raise IOErr(f"{path}: not a shapefile")
    (shape_type,) = struct.unpack("<i", data[32:36])
    pos = 100
    polys: List[Polygon] = []
    while pos + 8 <= len(data):
        _, length_words = struct.unpack(">ii", data[pos:pos + 8])
        pos += 8
        content = data[pos:pos + 2 * length_words]
        pos += 2 * length_words
        if len(content) < 4:
            break
        (stype,) = struct.unpack("<i", content[:4])
        if stype == 0:  # null shape
            continue
        nparts, npoints = struct.unpack("<ii", content[36:44])
        parts = struct.unpack(f"<{nparts}i", content[44:44 + 4 * nparts])
        pts = np.frombuffer(content, "<f8", 2 * npoints,
                            44 + 4 * nparts).reshape(npoints, 2)
        poly = Polygon()
        for i, start in enumerate(parts):
            end = parts[i + 1] if i + 1 < nparts else npoints
            ring = pts[start:end]
            if len(ring) >= 3:
                poly.rings.append(np.array(ring[:-1] if
                                           np.allclose(ring[0], ring[-1])
                                           else ring))
        polys.append(poly)
    return polys, shape_type
