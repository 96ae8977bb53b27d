"""Axis-aligned integer boxes (copied from ``visionworkbench_tpu/math/bbox.py``,
the parts the correlator uses; ref ``src/vw/Math/BBox.h``).

Convention: ``BBox2i(min_x, min_y, width, height)``; ``max`` is exclusive;
``x`` is the column axis.
"""

from __future__ import annotations


class BBox2i:
    """Integer box, max-exclusive."""

    __slots__ = ("min_x", "min_y", "max_x", "max_y")

    def __init__(self, min_x=0, min_y=0, width=0, height=0):
        self.min_x = min_x
        self.min_y = min_y
        self.max_x = min_x + width
        self.max_y = min_y + height

    @classmethod
    def from_bounds(cls, min_x, min_y, max_x, max_y) -> "BBox2i":
        b = cls()
        b.min_x, b.min_y, b.max_x, b.max_y = min_x, min_y, max_x, max_y
        return b

    @property
    def width(self):
        return self.max_x - self.min_x

    @property
    def height(self):
        return self.max_y - self.min_y
