"""Axis-aligned bounding boxes (a copy of ``visionworkbench_tpu/math/bbox.py``,
which has no JAX in it; ref ``src/vw/Math/BBox.h:1-335``).

Host-side helper used for tiling, halo sizing, search-range bookkeeping and
the warps' output boxes. Convention: ``BBox2i(min_x, min_y, width, height)``
like the reference's ``BBox2i(x, y, w, h)``; ``max`` is exclusive. ``x`` is
the column axis.
"""

from __future__ import annotations

import math
from typing import List, Tuple


class BBox2:
    """2D box with float or int bounds; max-exclusive."""

    __slots__ = ("min_x", "min_y", "max_x", "max_y")

    def __init__(self, min_x=0, min_y=0, width=0, height=0):
        self.min_x = min_x
        self.min_y = min_y
        self.max_x = min_x + width
        self.max_y = min_y + height

    # --- constructors -----------------------------------------------------
    @classmethod
    def from_bounds(cls, min_x, min_y, max_x, max_y) -> "BBox2":
        b = cls()
        b.min_x, b.min_y, b.max_x, b.max_y = min_x, min_y, max_x, max_y
        return b

    @classmethod
    def empty(cls) -> "BBox2":
        return cls.from_bounds(math.inf, math.inf, -math.inf, -math.inf)

    # --- accessors --------------------------------------------------------
    @property
    def width(self):
        return self.max_x - self.min_x

    @property
    def height(self):
        return self.max_y - self.min_y

    def size(self) -> Tuple:
        return (self.width, self.height)

    def area(self):
        if self.is_empty():
            return 0
        return self.width * self.height

    def min(self) -> Tuple:
        return (self.min_x, self.min_y)

    def max(self) -> Tuple:
        return (self.max_x, self.max_y)

    def center(self) -> Tuple:
        return ((self.min_x + self.max_x) / 2, (self.min_y + self.max_y) / 2)

    def is_empty(self) -> bool:
        return self.max_x <= self.min_x or self.max_y <= self.min_y

    # --- mutation ---------------------------------------------------------
    def grow(self, other) -> "BBox2":
        """Expand to contain a point ``(x, y)`` or another box (ref BBox::grow)."""
        if isinstance(other, BBox2):
            if other.is_empty():
                return self
            self.min_x = min(self.min_x, other.min_x)
            self.min_y = min(self.min_y, other.min_y)
            self.max_x = max(self.max_x, other.max_x)
            self.max_y = max(self.max_y, other.max_y)
        else:
            x, y = other[0], other[1]
            self.min_x = min(self.min_x, x)
            self.min_y = min(self.min_y, y)
            self.max_x = max(self.max_x, x)
            self.max_y = max(self.max_y, y)
        return self

    def expand(self, amount) -> "BBox2":
        """Pad all sides by ``amount`` (scalar or (ax, ay)) (ref BBox::expand)."""
        ax, ay = (amount, amount) if not isinstance(amount, (tuple, list)) else amount
        self.min_x -= ax
        self.min_y -= ay
        self.max_x += ax
        self.max_y += ay
        return self

    def contract(self, amount) -> "BBox2":
        ax, ay = (amount, amount) if not isinstance(amount, (tuple, list)) else amount
        return self.expand((-ax, -ay))

    def crop(self, other: "BBox2") -> "BBox2":
        """Clip to ``other`` (ref BBox::crop)."""
        self.min_x = max(self.min_x, other.min_x)
        self.min_y = max(self.min_y, other.min_y)
        self.max_x = min(self.max_x, other.max_x)
        self.max_y = min(self.max_y, other.max_y)
        if self.is_empty():
            self.max_x, self.max_y = self.min_x, self.min_y
        return self

    def shift(self, offset) -> "BBox2":
        dx, dy = offset[0], offset[1]
        self.min_x += dx
        self.max_x += dx
        self.min_y += dy
        self.max_y += dy
        return self

    def scale(self, factor) -> "BBox2":
        self.min_x *= factor
        self.min_y *= factor
        self.max_x *= factor
        self.max_y *= factor
        return self

    # --- queries ----------------------------------------------------------
    def contains(self, other) -> bool:
        if isinstance(other, BBox2):
            return (other.min_x >= self.min_x and other.max_x <= self.max_x and
                    other.min_y >= self.min_y and other.max_y <= self.max_y)
        x, y = other[0], other[1]
        return self.min_x <= x < self.max_x and self.min_y <= y < self.max_y

    def intersects(self, other: "BBox2") -> bool:
        return not (other.min_x >= self.max_x or other.max_x <= self.min_x or
                    other.min_y >= self.max_y or other.max_y <= self.min_y)

    def intersection(self, other: "BBox2") -> "BBox2":
        out = self.copy()
        return out.crop(other)

    def union(self, other: "BBox2") -> "BBox2":
        out = self.copy()
        return out.grow(other)

    def copy(self) -> "BBox2":
        return type(self).from_bounds(self.min_x, self.min_y, self.max_x, self.max_y)

    # --- misc -------------------------------------------------------------
    def __eq__(self, other) -> bool:
        return (isinstance(other, BBox2) and self.min() == other.min()
                and self.max() == other.max())

    def __hash__(self) -> int:
        return hash((self.min_x, self.min_y, self.max_x, self.max_y))

    def __repr__(self) -> str:
        return (f"{type(self).__name__}(({self.min_x}, {self.min_y}) -> "
                f"({self.max_x}, {self.max_y}))")

    def rounded(self) -> "BBox2i":
        """Integer box containing this box (floor min, ceil max)."""
        return BBox2i.from_bounds(
            int(math.floor(self.min_x)), int(math.floor(self.min_y)),
            int(math.ceil(self.max_x)), int(math.ceil(self.max_y)))


class BBox2i(BBox2):
    """Integer box; slicing helpers for numpy-style arrays."""

    def slices(self) -> Tuple[slice, slice]:
        """(row_slice, col_slice) for ``array[rows, cols]`` indexing."""
        return (slice(int(self.min_y), int(self.max_y)),
                slice(int(self.min_x), int(self.max_x)))


def bounding_box(image) -> BBox2i:
    """Full-image box, (0, 0, W, H) — note ``shape`` is (H, W[, C])."""
    h, w = image.shape[0], image.shape[1]
    return BBox2i(0, 0, w, h)


def subdivide_bbox(box: BBox2i, tile_w: int, tile_h: int,
                   include_partials: bool = True) -> List[BBox2i]:
    """Split a box into a raster-ordered list of tiles
    (ref ``subdivide_bbox``, ``src/vw/Image/AlgorithmFunctions.h``)."""
    tiles: List[BBox2i] = []
    y = box.min_y
    while y < box.max_y:
        x = box.min_x
        th = min(tile_h, box.max_y - y)
        while x < box.max_x:
            tw = min(tile_w, box.max_x - x)
            if include_partials or (tw == tile_w and th == tile_h):
                tiles.append(BBox2i(x, y, tw, th))
            x += tile_w
        y += tile_h
    return tiles


def grow_bbox_to_int(box: BBox2) -> BBox2i:
    return box.rounded()
