"""2D image-to-image transform functors (port of
``visionworkbench_tpu/math/transform2d.py``; ref
``src/vw/Math/Transform.h:46-331``).

Each transform maps (x, y) point arrays forward (source -> dest) and reverse
(dest -> source); warping uses the reverse map (``TransformView``,
``Image/Transform.h:336-391``). All are affine/projective 3x3 matrices held
as host float64 NumPy; application runs in fp32 torch, one tensor operation
a step in the JAX package's order, on the device of the coordinates given
(a tensor keeps its device; arrays are planned on the CPU).
"""

from __future__ import annotations

import math

import numpy as np

from visionworkbench_torch.core.device import as_f32
from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.math.bbox import BBox2


class Transform2D:
    """Projective 2D transform with a 3x3 homogeneous matrix (row vectors
    [x, y, 1]^T convention: p' = H @ p)."""

    def __init__(self, matrix):
        m = np.asarray(matrix, np.float64)
        if m.shape != (3, 3):
            raise ArgumentErr("Transform2D expects a 3x3 matrix")
        self.matrix = m
        self._inv = np.linalg.inv(m)

    # --- application ------------------------------------------------------
    def _apply(self, m, x, y):
        x = as_f32(x)
        y = as_f32(y, like=x)
        # the fp32 matrix entries, as Python floats (exact in fp32)
        m = np.asarray(m, np.float32).astype(np.float64).tolist()
        xn = m[0][0] * x + m[0][1] * y + m[0][2]
        yn = m[1][0] * x + m[1][1] * y + m[1][2]
        wn = m[2][0] * x + m[2][1] * y + m[2][2]
        return xn / wn, yn / wn

    def forward(self, x, y):
        """Source point -> destination point (ref ``forward``)."""
        return self._apply(self.matrix, x, y)

    def reverse(self, x, y):
        """Destination point -> source point (ref ``reverse``)."""
        return self._apply(self._inv, x, y)

    # --- composition ------------------------------------------------------
    def compose(self, other: "Transform2D") -> "Transform2D":
        """self o other: applies ``other`` first (ref ``compose``)."""
        return Transform2D(self.matrix @ other.matrix)

    def inverse(self) -> "Transform2D":
        return Transform2D(self._inv)

    def forward_bbox(self, box: BBox2) -> BBox2:
        """Image of a box's corners under forward (ref ``forward_bbox``)."""
        xs = np.array([box.min_x, box.max_x, box.min_x, box.max_x], np.float64)
        ys = np.array([box.min_y, box.min_y, box.max_y, box.max_y], np.float64)
        h = self.matrix
        xn = h[0, 0] * xs + h[0, 1] * ys + h[0, 2]
        yn = h[1, 0] * xs + h[1, 1] * ys + h[1, 2]
        wn = h[2, 0] * xs + h[2, 1] * ys + h[2, 2]
        xn, yn = xn / wn, yn / wn
        return BBox2.from_bounds(xn.min(), yn.min(), xn.max(), yn.max())

    def reverse_bbox(self, box: BBox2) -> BBox2:
        return self.inverse().forward_bbox(box)

    def is_affine(self) -> bool:
        return bool(np.allclose(self.matrix[2], [0, 0, 1]))

    def __repr__(self):
        return f"{type(self).__name__}({self.matrix.tolist()})"


class HomographyTransform(Transform2D):
    """(ref ``HomographyTransform``, Transform.h:190)"""


class AffineTransform(Transform2D):
    """(ref ``AffineTransform``: 2x2 linear part + offset)"""

    def __init__(self, linear, offset):
        linear = np.asarray(linear, np.float64).reshape(2, 2)
        offset = np.asarray(offset, np.float64).reshape(2)
        m = np.eye(3)
        m[:2, :2] = linear
        m[:2, 2] = offset
        super().__init__(m)


class LinearTransform(AffineTransform):
    """2x2 linear map, no offset (ref ``LinearTransform``)."""

    def __init__(self, linear):
        super().__init__(linear, (0.0, 0.0))


class TranslateTransform(AffineTransform):
    """(ref ``TranslateTransform``, Transform.h:127)"""

    def __init__(self, dx, dy):
        super().__init__(np.eye(2), (dx, dy))


class ResampleTransform(AffineTransform):
    """Scale about the origin (ref ``ResampleTransform``, Transform.h:158)."""

    def __init__(self, sx, sy=None):
        if sy is None:
            sy = sx
        super().__init__(np.diag([sx, sy]), (0.0, 0.0))


class RotateTransform(AffineTransform):
    """Rotation by theta about a center point (ref ``RotateTransform``)."""

    def __init__(self, theta, center=(0.0, 0.0)):
        c, s = math.cos(theta), math.sin(theta)
        rot = np.array([[c, -s], [s, c]])
        cx, cy = center
        offset = np.array([cx, cy]) - rot @ np.array([cx, cy])
        super().__init__(rot, offset)


class SimilarityTransform(AffineTransform):
    """Scale + rotation + translation."""

    def __init__(self, scale, theta, dx, dy):
        c, s = math.cos(theta), math.sin(theta)
        super().__init__(scale * np.array([[c, -s], [s, c]]), (dx, dy))


def identity_transform() -> Transform2D:
    return Transform2D(np.eye(3))


def compose(*transforms: Transform2D) -> Transform2D:
    """compose(a, b, c)(p) = a(b(c(p))) (ref ``compose``, Transform.h:300)."""
    m = np.eye(3)
    for t in transforms:
        m = m @ t.matrix
    return Transform2D(m)
