"""Lens distortion models (port of ``visionworkbench_tpu/camera/distortion.py``;
ref ``src/vw/Camera/LensDistortion.h:41-362`` / ``LensDistortion.cc``).

All models operate on *normalized* focal-plane coordinates, vectorized over
(..., 2) fp32 tensors (a tensor keeps its device; arrays go to the CPU).
``distort`` applies the model; ``undistort`` inverts it with the JAX
package's fixed 20 damped Newton steps on a central-difference Jacobian (eps
1e-4 in fp32): a Python loop of the same count, no convergence test, so the
card and the CPU run the same arithmetic. Powers are the JAX package's
``integer_pow`` products (:func:`ipow`), and quotients by a number are IEEE
quotients (:func:`~visionworkbench_torch.core.device.qdiv`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from visionworkbench_torch.core.device import as_f32, norm_rn, qdiv

NEWTON_ITERS = 20
_EPS = 1e-4


def ipow(x, n: int):
    """``x ** n`` for an integer ``n >= 0`` as the JAX package's
    ``integer_pow`` computes it: square-and-multiply, one product a step."""
    if n == 0:
        return torch.ones_like(x)
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


class NullLensDistortion:
    """(ref ``NullLensDistortion``)"""
    name = "NULL"
    params: tuple = ()

    def distort(self, xy):
        return as_f32(xy)

    def undistort(self, xy):
        return as_f32(xy)


def _newton_undistort(distort_fn, xy, iters: int = NEWTON_ITERS):
    """Invert y = f(x) by damped Newton on each component pair using the
    numerical Jacobian of the 2D map (vectorized)."""
    xy = as_f32(xy)
    ex = as_f32([_EPS, 0.0], xy)
    ey = as_f32([0.0, _EPS], xy)
    x = xy
    for _ in range(iters):
        r = distort_fn(x) - xy
        jx = qdiv(distort_fn(x + ex) - distort_fn(x - ex), 2 * _EPS)  # d f / d x0
        jy = qdiv(distort_fn(x + ey) - distort_fn(x - ey), 2 * _EPS)
        a, c = jx[..., 0], jx[..., 1]
        b, d = jy[..., 0], jy[..., 1]
        det = a * d - b * c
        det = torch.where(torch.abs(det) < 1e-12, 1.0, det)
        dx = (d * r[..., 0] - b * r[..., 1]) / det
        dy = (-c * r[..., 0] + a * r[..., 1]) / det
        x = x - torch.stack([dx, dy], -1)
    return x


class TsaiLensDistortion:
    """Radial k1,k2,k3 + tangential p1,p2 (ref ``TsaiDistortionNorm``,
    LensDistortion.cc:260-276)."""
    name = "TSAI"

    def __init__(self, k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0):
        self.params = (float(k1), float(k2), float(p1), float(p2), float(k3))

    def distort(self, xy):
        xy = as_f32(xy)
        k1, k2, p1, p2, k3 = self.params
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        rdist = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
        x_out = x * rdist + (2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x))
        y_out = y * rdist + (p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y)
        return torch.stack([x_out, y_out], -1)

    def undistort(self, xy):
        return _newton_undistort(self.distort, xy)


def _sin_cos_f32(phi: float):
    """sin and cos of ``phi`` rounded to fp32 (the JAX package evaluates
    ``jnp.sin(phi)`` of a Python float in fp32)."""
    p = float(np.float32(phi))
    return math.sin(p), math.cos(p)


class BrownConradyDistortion:
    """Brown-Conrady: principal-point offset, radial k1..k3, tangential with
    angle (ref ``BrownConradyDistortion``, LensDistortion.h)."""
    name = "BrownConrady"

    def __init__(self, xp=0.0, yp=0.0, k1=0.0, k2=0.0, k3=0.0,
                 p1=0.0, p2=0.0, phi=0.0):
        self.params = tuple(float(v) for v in (xp, yp, k1, k2, k3, p1, p2, phi))

    def distort(self, xy):
        xp, yp, k1, k2, k3, p1, p2, phi = self.params
        sin_phi, cos_phi = _sin_cos_f32(phi)
        xy = as_f32(xy)
        x = xy[..., 0] - xp
        y = xy[..., 1] - yp
        r2 = x * x + y * y
        radial = k1 * r2 + k2 * ipow(r2, 2) + k3 * ipow(r2, 3)
        tangential = (p1 * r2 + p2 * ipow(r2, 2))
        dx = x * radial - tangential * sin_phi
        dy = y * radial + tangential * cos_phi
        return torch.stack([xy[..., 0] + dx, xy[..., 1] + dy], -1)

    def undistort(self, xy):
        return _newton_undistort(self.distort, xy)


class FovDistortion:
    """Field-of-view model: r_d = atan(2 r tan(w/2)) / w
    (ref ``FovDistortion``, LensDistortion.cc fisheye/FOV section)."""
    name = "FOV"

    def __init__(self, omega=0.75):
        self.params = (float(omega),)

    def distort(self, xy):
        (w,) = self.params
        xy = as_f32(xy)
        r = norm_rn(xy)
        rd = qdiv(torch.arctan(2.0 * r * np.tan(w / 2.0)), w)
        scale = torch.where(r > 1e-8, rd / torch.clamp(r, min=1e-8), 1.0)
        return xy * scale[..., None]

    def undistort(self, xy):
        (w,) = self.params
        xy = as_f32(xy)
        rd = norm_rn(xy)
        r = qdiv(torch.tan(rd * w), 2.0 * np.tan(w / 2.0))
        scale = torch.where(rd > 1e-8, r / torch.clamp(rd, min=1e-8), 1.0)
        return xy * scale[..., None]


class FisheyeDistortion:
    """Equidistant fisheye with k1..k4 theta polynomial (ref
    ``FisheyeLensDistortion``, OpenCV convention)."""
    name = "FISHEYE"

    def __init__(self, k1=0.0, k2=0.0, k3=0.0, k4=0.0):
        self.params = tuple(float(v) for v in (k1, k2, k3, k4))

    def distort(self, xy):
        k1, k2, k3, k4 = self.params
        xy = as_f32(xy)
        r = norm_rn(xy)
        theta = torch.arctan(r)
        t2 = theta * theta
        theta_d = theta * (1 + k1 * t2 + k2 * ipow(t2, 2) + k3 * ipow(t2, 3)
                           + k4 * ipow(t2, 4))
        scale = torch.where(r > 1e-8, theta_d / torch.clamp(r, min=1e-8), 1.0)
        return xy * scale[..., None]

    def undistort(self, xy):
        return _newton_undistort(self.distort, xy)


class PhotometrixDistortion:
    """Photometrix calibration-report convention (ref
    ``PhotometrixLensDistortion``): like Brown-Conrady in mm units."""
    name = "Photometrix"

    def __init__(self, xp=0.0, yp=0.0, k1=0.0, k2=0.0, k3=0.0, p1=0.0, p2=0.0):
        self.params = tuple(float(v) for v in (xp, yp, k1, k2, k3, p1, p2))

    def distort(self, xy):
        xp, yp, k1, k2, k3, p1, p2 = self.params
        xy = as_f32(xy)
        x = xy[..., 0] - xp
        y = xy[..., 1] - yp
        r2 = x * x + y * y
        dr = k1 * r2 + k2 * ipow(r2, 2) + k3 * ipow(r2, 3)
        dx = x * dr + p1 * (r2 + 2 * x * x) + 2 * p2 * x * y
        dy = y * dr + p2 * (r2 + 2 * y * y) + 2 * p1 * x * y
        return torch.stack([xy[..., 0] + dx, xy[..., 1] + dy], -1)

    def undistort(self, xy):
        return _newton_undistort(self.distort, xy)


DISTORTION_TYPES = {
    "NULL": NullLensDistortion,
    "TSAI": TsaiLensDistortion,
    "BrownConrady": BrownConradyDistortion,
    "FOV": FovDistortion,
    "FISHEYE": FisheyeDistortion,
    "Photometrix": PhotometrixDistortion,
}


class RPCLensDistortion:
    """Rational-polynomial distortion on normalized coordinates
    (ref ``RPCLensDistortion``, LensDistortion.h): each output coordinate is
    a ratio of polynomials in (x, y) up to the given degree. Coefficient
    layout per coordinate: numerator then denominator (constant term of the
    denominator fixed at 1)."""
    name = "RPC"

    def __init__(self, num_x, den_x, num_y, den_y):
        self.num_x = tuple(float(v) for v in num_x)
        self.den_x = tuple(float(v) for v in den_x)
        self.num_y = tuple(float(v) for v in num_y)
        self.den_y = tuple(float(v) for v in den_y)
        self.params = self.num_x + self.den_x + self.num_y + self.den_y

    @staticmethod
    def _poly(coeffs, x, y):
        """Coefficients over monomials 1, x, y, x^2, xy, y^2, ... by degree."""
        terms = []
        deg = 0
        idx = 0
        while idx < len(coeffs):
            for i in range(deg + 1):
                if idx >= len(coeffs):
                    break
                terms.append(coeffs[idx] * ipow(x, deg - i) * ipow(y, i))
                idx += 1
            deg += 1
        out = terms[0]
        for t in terms[1:]:
            out = out + t
        return out

    def distort(self, xy):
        xy = as_f32(xy)
        x, y = xy[..., 0], xy[..., 1]
        nx = self._poly(self.num_x, x, y)
        dx = 1.0 + self._poly((0.0,) + tuple(self.den_x), x, y)
        ny = self._poly(self.num_y, x, y)
        dy = 1.0 + self._poly((0.0,) + tuple(self.den_y), x, y)
        return torch.stack([nx / dx, ny / dy], -1)

    def undistort(self, xy):
        return _newton_undistort(self.distort, xy)


DISTORTION_TYPES["RPC"] = RPCLensDistortion
