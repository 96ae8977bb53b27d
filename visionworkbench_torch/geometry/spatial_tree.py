"""Spatial index (port of ``visionworkbench_tpu/geometry/spatial_tree.py``,
its code copied; ref ``SpatialTree``, ``src/vw/Geometry/SpatialTree.h:35-98``):
2D quadtree over boxed primitives with contains / intersects / overlap-pair
queries. Host code."""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

from visionworkbench_torch.math.bbox import BBox2

_MAX_ITEMS = 8
_MAX_DEPTH = 12


class _Node:
    __slots__ = ("box", "items", "children", "depth")

    def __init__(self, box: BBox2, depth: int):
        self.box = box
        self.items: List[Tuple[BBox2, Any]] = []
        self.children: Optional[List["_Node"]] = None
        self.depth = depth

    def _split(self):
        cx, cy = self.box.center()
        b = self.box
        self.children = [
            _Node(BBox2.from_bounds(b.min_x, b.min_y, cx, cy), self.depth + 1),
            _Node(BBox2.from_bounds(cx, b.min_y, b.max_x, cy), self.depth + 1),
            _Node(BBox2.from_bounds(b.min_x, cy, cx, b.max_y), self.depth + 1),
            _Node(BBox2.from_bounds(cx, cy, b.max_x, b.max_y), self.depth + 1),
        ]
        olditems = self.items
        self.items = []
        for box, obj in olditems:
            self._place(box, obj)

    def _place(self, box: BBox2, obj):
        if self.children is not None:
            for c in self.children:
                if c.box.contains(box):
                    c._place(box, obj)
                    return
        self.items.append((box, obj))

    def insert(self, box: BBox2, obj):
        if self.children is None and len(self.items) >= _MAX_ITEMS \
                and self.depth < _MAX_DEPTH:
            self._split()
        self._place(box, obj)

    def query_point(self, x, y, out):
        if not self.box.contains((x, y)):
            return
        for box, obj in self.items:
            if box.contains((x, y)):
                out.append(obj)
        if self.children:
            for c in self.children:
                c.query_point(x, y, out)

    def query_box(self, qbox: BBox2, out):
        if not self.box.intersects(qbox):
            return
        for box, obj in self.items:
            if box.intersects(qbox):
                out.append(obj)
        if self.children:
            for c in self.children:
                c.query_box(qbox, out)

    def all_items(self, out):
        out.extend(self.items)
        if self.children:
            for c in self.children:
                c.all_items(out)


class SpatialTree:
    def __init__(self, bbox: BBox2):
        self._root = _Node(bbox.copy(), 0)
        self._count = 0

    def insert(self, bbox: BBox2, obj: Any) -> None:
        self._root.insert(bbox.copy(), obj)
        self._count += 1

    def __len__(self) -> int:
        return self._count

    def query_point(self, x: float, y: float) -> List[Any]:
        """Primitives whose boxes contain the point (ref ``contains``)."""
        out: List[Any] = []
        self._root.query_point(x, y, out)
        return out

    def query_box(self, box: BBox2) -> List[Any]:
        """Primitives whose boxes intersect the box (ref ``intersects``)."""
        out: List[Any] = []
        self._root.query_box(box, out)
        return out

    def overlap_pairs(self) -> List[Tuple[Any, Any]]:
        """All intersecting pairs (ref overlap-pair query)."""
        items: List[Tuple[BBox2, Any]] = []
        self._root.all_items(items)
        pairs = []
        for i in range(len(items)):
            bi, oi = items[i]
            for j in range(i + 1, len(items)):
                bj, oj = items[j]
                if bi.intersects(bj):
                    pairs.append((oi, oj))
        return pairs
