"""Polygon sets and clipping (port of ``visionworkbench_tpu/geometry/polygon.py``,
its NumPy code copied; ref ``src/vw/Geometry/dPoly.cc`` / ``cutPoly.cc`` /
``geomUtils.cc``): double-precision multi-ring polygons with area, winding,
point-in-polygon (vectorized), Sutherland-Hodgman clipping to boxes,
per-ring metadata (closed flag / color / layer), annotations, in-place
transforms, marked-ring erasure, and closest-vertex / closest-edge queries
-- the ``dPoly`` compute surface. Host NumPy: nothing of it runs on the
card."""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.math.bbox import BBox2


class Anno(NamedTuple):
    """A positioned text annotation (ref ``anno``, dPoly.h / geomUtils.h)."""
    x: float
    y: float
    label: str


class Polygon:
    """One or more rings, each an (N, 2) float64 array (ref ``dPoly``).

    Ring ``i`` carries ``closed[i]`` / ``colors[i]`` / ``layers[i]``
    metadata like the reference's parallel vectors; ``annotations`` are
    free-position labels, ``vert_index_annos`` / ``poly_index_annos`` /
    ``layer_annos`` the computed index layers (dPoly.cc:588-700)."""

    def __init__(self, rings: Optional[Sequence] = None):
        self.rings: List[np.ndarray] = []
        self.closed: List[bool] = []
        self.colors: List[str] = []
        self.layers: List[str] = []
        self.annotations: List[Anno] = []
        self.vert_index_annos: List[Anno] = []
        self.poly_index_annos: List[Anno] = []
        self.layer_annos: List[Anno] = []
        for r in (rings or []):
            self.append_ring(r)

    def append_ring(self, points, closed: bool = True,
                    color: str = "yellow", layer: str = "") -> None:
        pts = np.asarray(points, np.float64).reshape(-1, 2)
        if len(pts) < 3:
            raise ArgumentErr("Polygon ring needs >= 3 points")
        self.rings.append(pts)
        self.closed.append(bool(closed))
        self.colors.append(color)
        self.layers.append(layer)

    # Keep metadata lists consistent when rings were appended directly.
    def _sync_meta(self) -> None:
        while len(self.closed) < len(self.rings):
            self.closed.append(True)
        while len(self.colors) < len(self.rings):
            self.colors.append("yellow")
        while len(self.layers) < len(self.rings):
            self.layers.append("")
        del self.closed[len(self.rings):]
        del self.colors[len(self.rings):]
        del self.layers[len(self.rings):]

    def num_rings(self) -> int:
        return len(self.rings)

    def total_num_verts(self) -> int:
        return sum(len(r) for r in self.rings)

    def bbox(self) -> BBox2:
        box = BBox2.empty()
        for r in self.rings:
            box.grow(BBox2.from_bounds(r[:, 0].min(), r[:, 1].min(),
                                       r[:, 0].max(), r[:, 1].max()))
        return box

    def area(self) -> float:
        """Signed shoelace area summed over rings (holes = opposite winding)."""
        total = 0.0
        for r in self.rings:
            x, y = r[:, 0], r[:, 1]
            total += 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))
        return total

    def contains(self, x, y) -> np.ndarray:
        """Vectorized even-odd point-in-polygon over all rings."""
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        inside = np.zeros(np.broadcast(x, y).shape, bool)
        for r in self.rings:
            x1, y1 = r[:, 0], r[:, 1]
            x2, y2 = np.roll(x1, -1), np.roll(y1, -1)
            for i in range(len(r)):
                cond = ((y1[i] > y) != (y2[i] > y))
                xin = (x2[i] - x1[i]) * (y - y1[i]) / (y2[i] - y1[i] + 1e-300) + x1[i]
                inside ^= cond & (x < xin)
        return inside

    def clip_to_box(self, box: BBox2) -> "Polygon":
        """Sutherland-Hodgman clip of each ring (ref ``cutPoly``)."""
        out = Polygon()
        for r in self.rings:
            ring = r
            for edge in ("l", "r", "b", "t"):
                if len(ring) < 3:
                    break
                ring = _clip_edge(ring, edge, box)
            if len(ring) >= 3:
                out.rings.append(np.asarray(ring))
        return out

    def translate(self, dx: float, dy: float) -> "Polygon":
        return Polygon([r + [dx, dy] for r in self.rings])

    # --- rectangles (ref dPoly.cc:154-197) ---------------------------------
    def append_rectangle(self, xl: float, yl: float, xh: float, yh: float,
                         closed: bool = True, color: str = "yellow",
                         layer: str = "") -> None:
        """CCW rectangle ring (ref ``appendRectangle``, dPoly.cc:154)."""
        self.append_ring([(xl, yl), (xh, yl), (xh, yh), (xl, yh)],
                         closed=closed, color=color, layer=layer)

    def set_rectangle(self, xl: float, yl: float, xh: float, yh: float,
                      closed: bool = True, color: str = "yellow",
                      layer: str = "") -> None:
        """Reset to one rectangle (ref ``setRectangle``, dPoly.cc:164)."""
        self.rings, self.closed, self.colors, self.layers = [], [], [], []
        self.append_rectangle(xl, yl, xh, yh, closed, color, layer)

    def is_xy_rect(self) -> bool:
        """One 4-vertex axis-parallel (possibly degenerate) rectangle
        (ref ``isXYRect``, dPoly.cc:172-197: midpoint + direction tests)."""
        if self.num_rings() != 1 or len(self.rings[0]) != 4:
            return False
        b = self.bbox()
        tol = 1e-15 * (abs(b.min_x) + abs(b.min_y)
                       + abs(b.max_x) + abs(b.max_y))
        xv, yv = self.rings[0][:, 0], self.rings[0][:, 1]
        if abs(xv[0] + xv[2] - xv[1] - xv[3]) > tol:
            return False
        if abs(yv[0] + yv[2] - yv[1] - yv[3]) > tol:
            return False
        for i in range(4):
            i1 = (i + 1) % 4
            if abs(xv[i1] - xv[i]) > tol and abs(yv[i1] - yv[i]) > tol:
                return False
        return True

    # --- bd boxes (ref dPoly.cc:58-118) ------------------------------------
    def bdbox_center(self) -> Tuple[float, float]:
        b = self.bbox()
        return (b.min_x + b.max_x) / 2.0, (b.min_y + b.max_y) / 2.0

    def bdboxes(self) -> List[BBox2]:
        """Per-ring bounding boxes (ref ``bdBoxes``)."""
        return [BBox2.from_bounds(r[:, 0].min(), r[:, 1].min(),
                                  r[:, 0].max(), r[:, 1].max())
                for r in self.rings]

    # --- in-place transforms (ref dPoly.cc:327-502) ------------------------
    def _transform_annos(self, fn) -> None:
        for name in ("annotations", "vert_index_annos", "poly_index_annos",
                     "layer_annos"):
            setattr(self, name, [Anno(*fn(a.x, a.y), a.label)
                                 for a in getattr(self, name)])

    def shift(self, dx: float, dy: float) -> None:
        """In-place shift of vertices AND annotations (ref ``shift``)."""
        self.rings = [r + [dx, dy] for r in self.rings]
        self._transform_annos(lambda x, y: (x + dx, y + dy))

    def rotate(self, angle_deg: float) -> None:
        """In-place rotation about the origin; multiples of 90 degrees use
        exact (rounded) cos/sin like the reference (dPoly.cc:350-381)."""
        a = np.deg2rad(angle_deg)
        c, s = np.cos(a), np.sin(a)
        if angle_deg == round(angle_deg) and int(angle_deg) % 90 == 0:
            c, s = np.round(c), np.round(s)
        self.apply_transform(c, -s, s, c)

    def scale(self, factor: float) -> None:
        """In-place uniform scale about the origin (ref ``scale``)."""
        self.apply_transform(factor, 0.0, 0.0, factor)

    def apply_transform(self, a11: float, a12: float, a21: float, a22: float,
                        sx: float = 0.0, sy: float = 0.0) -> None:
        """x' = a11 x + a12 y + sx, y' = a21 x + a22 y + sy, applied to
        vertices and annotations (ref ``applyTransform``, dPoly.cc:458)."""
        m = np.array([[a11, a12], [a21, a22]], np.float64)
        t = np.array([sx, sy], np.float64)
        self.rings = [r @ m.T + t for r in self.rings]
        self._transform_annos(
            lambda x, y: (a11 * x + a12 * y + sx, a21 * x + a22 * y + sy))

    def apply_transform_around_bdbox_center(self, a11, a12, a21, a22) -> None:
        """(ref ``applyTransformAroundBdBoxCenter``, dPoly.cc:491)"""
        mx, my = self.bdbox_center()
        self.shift(-mx, -my)
        self.apply_transform(a11, a12, a21, a22)
        self.shift(mx, my)

    def append_polygons(self, other: "Polygon") -> None:
        """(ref ``appendPolygons``, dPoly.cc:504)"""
        other._sync_meta()
        for i, r in enumerate(other.rings):
            self.append_ring(r, other.closed[i], other.colors[i],
                             other.layers[i])
        self.annotations.extend(other.annotations)

    def set_color(self, color: str) -> None:
        self._sync_meta()
        self.colors = [color] * len(self.rings)

    def set_is_poly_closed(self, closed: bool) -> None:
        self._sync_meta()
        self.closed = [bool(closed)] * len(self.rings)

    # --- marking / erasure (ref dPoly.cc:123-131, 826-) --------------------
    def mark_polys_intersecting_box(self, xll, yll, xur, yur) -> Dict[int, int]:
        """Ring indices whose bounding box meets the box (ref
        ``markPolysIntersectingBox``)."""
        mark: Dict[int, int] = {}
        for i, b in enumerate(self.bdboxes()):
            if (b.min_x <= xur and xll <= b.max_x
                    and b.min_y <= yur and yll <= b.max_y):
                mark[i] = 1
        return mark

    def erase_marked_polys(self, mark: Dict[int, int]) -> None:
        """(ref ``eraseMarkedPolys``)"""
        self._sync_meta()
        keep = [i for i in range(len(self.rings)) if i not in mark]
        self.rings = [self.rings[i] for i in keep]
        self.closed = [self.closed[i] for i in keep]
        self.colors = [self.colors[i] for i in keep]
        self.layers = [self.layers[i] for i in keep]

    def erase_one_poly(self, index: int) -> None:
        """(ref ``eraseOnePoly``, dPoly.cc:826)"""
        if not 0 <= index < len(self.rings):
            raise ArgumentErr(f"erase_one_poly: index {index} out of range")
        self.erase_marked_polys({index: 1})

    def erase_polys_intersecting_box(self, xll, yll, xur, yur) -> None:
        """(ref ``erasePolysIntersectingBox``)"""
        self.erase_marked_polys(
            self.mark_polys_intersecting_box(xll, yll, xur, yur))

    # --- closest-feature queries (ref dPoly.cc:742-824) --------------------
    def find_closest_poly_vertex(self, x0: float, y0: float):
        """-> (poly_index, vert_index, x, y, dist); ties go to the LAST
        vertex scanned (the reference's ``<=`` update)."""
        best = (-1, -1, x0, y0, np.inf)
        for pi, r in enumerate(self.rings):
            d = np.hypot(r[:, 0] - x0, r[:, 1] - y0)
            for vi in range(len(r)):
                if d[vi] <= best[4]:
                    best = (pi, vi, float(r[vi, 0]), float(r[vi, 1]),
                            float(d[vi]))
        return best

    def find_closest_poly_edge(self, x0: float, y0: float):
        """-> (poly_index, edge_index, x, y, dist) over closed-ring edges
        (ref ``findClosestPolyEdge`` + ``minDistFromPtToSeg``,
        geomUtils.cc)."""
        best = (-1, -1, np.inf, np.inf, np.inf)
        for pi, r in enumerate(self.rings):
            n = len(r)
            for vi in range(n):
                x1, y1 = r[vi]
                x2, y2 = r[(vi + 1) % n]
                px, py, d = _min_dist_from_pt_to_seg(x0, y0, x1, y1, x2, y2)
                if d <= best[4]:
                    best = (pi, vi, px, py, d)
        return best

    # --- computed annotation layers (ref dPoly.cc:588-700) -----------------
    def comp_vert_index_anno(self) -> None:
        """Per-ring vertex indices as annotations (ref ``compVertIndexAnno``)."""
        self.vert_index_annos = [
            Anno(float(x), float(y), str(vi))
            for r in self.rings for vi, (x, y) in enumerate(r)]

    def comp_vert_full_index_anno(self) -> None:
        """Global vertex indices (ref ``compVertFullIndexAnno``)."""
        self.vert_index_annos = []
        count = 0
        for r in self.rings:
            for (x, y) in r:
                self.vert_index_annos.append(Anno(float(x), float(y),
                                                  str(count)))
                count += 1

    def comp_poly_index_anno(self) -> None:
        """Ring index at each ring's first vertex (ref ``compPolyIndexAnno``)."""
        self.poly_index_annos = [Anno(float(r[0, 0]), float(r[0, 1]), str(pi))
                                 for pi, r in enumerate(self.rings)]

    def comp_layer_anno(self) -> None:
        """Layer name at each ring's first vertex (ref ``compLayerAnno``)."""
        self._sync_meta()
        self.layer_annos = [Anno(float(r[0, 0]), float(r[0, 1]),
                                 self.layers[pi])
                            for pi, r in enumerate(self.rings)]

    def find_closest_annotation(self, x0: float, y0: float):
        """-> (anno_index, dist) (ref ``findClosestAnnotation``)."""
        best = (-1, np.inf)
        for i, a in enumerate(self.annotations):
            d = float(np.hypot(a.x - x0, a.y - y0))
            if d <= best[1]:
                best = (i, d)
        return best

    def erase_anno(self, index: int) -> None:
        del self.annotations[index]


def _min_dist_from_pt_to_seg(x0, y0, x1, y1, x2, y2):
    """Closest point on segment (x1,y1)-(x2,y2) to (x0,y0)
    (ref ``minDistFromPtToSeg``, geomUtils.cc)."""
    dx, dy = x2 - x1, y2 - y1
    l2 = dx * dx + dy * dy
    if l2 == 0.0:
        px, py = x1, y1
    else:
        t = ((x0 - x1) * dx + (y0 - y1) * dy) / l2
        t = min(1.0, max(0.0, t))
        px, py = x1 + t * dx, y1 + t * dy
    return float(px), float(py), float(np.hypot(x0 - px, y0 - py))


def segment_intersection(ax, ay, bx, by, cx, cy, dx, dy):
    """Proper/improper intersection of segments AB and CD -> (hit, x, y)
    (the general segment test of ``geomUtils.cc``'s cutting machinery)."""
    r = (bx - ax, by - ay)
    s = (dx - cx, dy - cy)
    denom = r[0] * s[1] - r[1] * s[0]
    qpx, qpy = cx - ax, cy - ay
    if denom == 0.0:
        # parallel: collinear overlap reports an endpoint hit
        if qpx * r[1] - qpy * r[0] != 0.0:
            return False, 0.0, 0.0
        rr = r[0] * r[0] + r[1] * r[1]
        if rr == 0.0:
            hit = (ax, ay) == (cx, cy)
            return hit, ax, ay
        t0 = (qpx * r[0] + qpy * r[1]) / rr
        t1 = t0 + (s[0] * r[0] + s[1] * r[1]) / rr
        lo, hi = min(t0, t1), max(t0, t1)
        if hi < 0.0 or lo > 1.0:
            return False, 0.0, 0.0
        t = max(lo, 0.0)
        return True, ax + t * r[0], ay + t * r[1]
    t = (qpx * s[1] - qpy * s[0]) / denom
    u = (qpx * r[1] - qpy * r[0]) / denom
    if 0.0 <= t <= 1.0 and 0.0 <= u <= 1.0:
        return True, ax + t * r[0], ay + t * r[1]
    return False, 0.0, 0.0


def poly_in_poly(inner: Polygon, outer: Polygon) -> bool:
    """Every vertex of ``inner`` inside ``outer`` and no edge crossings —
    the poly-in-poly containment test of the reference's geom utilities."""
    for r in inner.rings:
        if not outer.contains(r[:, 0], r[:, 1]).all():
            return False
    for ri in inner.rings:
        ni = len(ri)
        for vi in range(ni):
            a, b = ri[vi], ri[(vi + 1) % ni]
            for ro in outer.rings:
                no = len(ro)
                for vo in range(no):
                    c, d = ro[vo], ro[(vo + 1) % no]
                    hit, _, _ = segment_intersection(a[0], a[1], b[0], b[1],
                                                     c[0], c[1], d[0], d[1])
                    if hit:
                        return False
    return True


def _inside(p, edge, box):
    if edge == "l":
        return p[0] >= box.min_x
    if edge == "r":
        return p[0] <= box.max_x
    if edge == "b":
        return p[1] >= box.min_y
    return p[1] <= box.max_y


def _intersect(p1, p2, edge, box):
    x1, y1 = p1
    x2, y2 = p2
    if edge in ("l", "r"):
        xe = box.min_x if edge == "l" else box.max_x
        t = (xe - x1) / (x2 - x1)
        return (xe, y1 + t * (y2 - y1))
    ye = box.min_y if edge == "b" else box.max_y
    t = (ye - y1) / (y2 - y1)
    return (x1 + t * (x2 - x1), ye)


def _clip_edge(ring, edge, box):
    out = []
    n = len(ring)
    for i in range(n):
        cur = tuple(ring[i])
        prev = tuple(ring[i - 1])
        cin = _inside(cur, edge, box)
        pin = _inside(prev, edge, box)
        if cin:
            if not pin:
                out.append(_intersect(prev, cur, edge, box))
            out.append(cur)
        elif pin:
            out.append(_intersect(prev, cur, edge, box))
    return np.asarray(out, np.float64).reshape(-1, 2)


def read_poly_file(path: str) -> Polygon:
    """Simple x y per line, rings separated by NEXT (ref ``dPoly`` text IO)."""
    poly = Polygon()
    ring: List[Tuple[float, float]] = []
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line or line.upper().startswith("NEXT"):
                if len(ring) >= 3:
                    poly.append_ring(ring)
                ring = []
                continue
            parts = line.split()
            if len(parts) >= 2:
                ring.append((float(parts[0]), float(parts[1])))
    if len(ring) >= 3:
        poly.append_ring(ring)
    return poly


def write_poly_file(path: str, poly: Polygon) -> None:
    with open(path, "w") as f:
        for i, r in enumerate(poly.rings):
            for x, y in r:
                f.write(f"{x} {y}\n")
            if i + 1 < len(poly.rings):
                f.write("NEXT\n")


def read_point_list(path: str) -> np.ndarray:
    """Whitespace-separated point list file -> (N, D) array
    (ref ``PointListIO.h``)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if line:
                rows.append([float(v) for v in line.split()])
    return np.asarray(rows, np.float64)


def write_point_list(path: str, points) -> None:
    with open(path, "w") as f:
        for row in np.asarray(points, np.float64):
            f.write(" ".join(repr(float(v)) for v in row) + "\n")
