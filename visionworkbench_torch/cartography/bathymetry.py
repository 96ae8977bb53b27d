"""Bathymetric stereo with water refraction (port of
``visionworkbench_tpu/cartography/bathymetry.py``; ref ``BathyStereoModel`` /
``SnellLaw.cc``, ``src/vw/Cartography/BathyStereoModel.h:40-77``): rays
refract at a water surface plane per Snell's law before triangulation.

:func:`snell_refraction` and :func:`_intersect_plane` compute in their
inputs' dtype (float64 if any tensor is float64), fp32 for arrays, as the
JAX package, the contract of ``triangulate_pair``.

Kept divergence: :meth:`BathyStereoModel.triangulate` takes the models'
fp32 rays and their float64 centres (per pixel where a model has them),
keeps the plane in float64, and bends, intersects and triangulates in
float64, then rounds the points and errors to fp32 once. The JAX package
rounds the plane to fp32 (one ulp of its offset is 0.5 m in ECEF) and
intersects and triangulates in fp32 from fp32 centres: at a 30 m baseline
1000 m up, its points lie metres off (``ROADMAP.md`` §3).
"""

from __future__ import annotations

import numpy as np
import torch

from visionworkbench_torch.camera.model import CameraModel
from visionworkbench_torch.core.device import common_dtype, dot, on_device, sqrt_rn
from visionworkbench_torch.stereo.stereo_model import triangulate_pair

WATER_REFRACTION_INDEX = 1.34  # ref default


def snell_refraction(incident, normal, n1: float, n2: float, device=None):
    """Refract unit direction(s) through an interface with unit normal
    (pointing into medium 1) per Snell's law (ref ``SnellLaw.cc``).
    Returns (refracted unit vectors, total_internal_reflection mask)."""
    d, n = common_dtype((incident, normal), device)
    n = n / sqrt_rn(dot(n, n))[..., None]
    cos_i = -dot(d, n)
    # Flip the normal to oppose the ray if needed.
    n = torch.where((cos_i < 0)[..., None], -n, n)
    cos_i = torch.abs(cos_i)
    eta = n1 / n2
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    tir = k < 0
    k = torch.clamp(k, min=0.0)
    t = eta * d + (eta * cos_i - sqrt_rn(k))[..., None] * n
    t = t / torch.clamp(sqrt_rn(dot(t, t)), min=1e-12)[..., None]
    return t, tir


def _intersect_plane(ctr, dir, plane, device=None):
    """Ray/plane intersection: plane = (a, b, c, d), ax+by+cz = d."""
    ctr, dir, plane = common_dtype((ctr, dir, plane), device)
    n = plane[:3]
    denom = dot(dir, n)
    tiny = torch.full_like(denom, 1e-12)
    t = (plane[3] - dot(ctr, n)) / torch.where(torch.abs(denom) < 1e-12, tiny, denom)
    return ctr + t[..., None] * dir, t


class BathyStereoModel:
    """Two-ray triangulation with refraction at a water plane
    (ref ``BathyStereoModel::operator()``)."""

    def __init__(self, camera1: CameraModel, camera2: CameraModel,
                 water_plane, refraction_index: float = WATER_REFRACTION_INDEX):
        self.camera1 = camera1
        self.camera2 = camera2
        self.plane = np.asarray(water_plane, np.float64)
        self.index = float(refraction_index)

    def _bend(self, ctr, dir):
        plane = torch.as_tensor(self.plane, dtype=torch.float64, device=dir.device)
        surf, t = _intersect_plane(ctr, dir, plane)
        bent, tir = snell_refraction(dir, plane[:3], 1.0, self.index)
        underwater = t > 0
        new_ctr = torch.where(underwater[..., None], surf, ctr)
        new_dir = torch.where((underwater & ~tir)[..., None], bent, dir)
        return new_ctr, new_dir

    def triangulate(self, pix1, pix2, device=None):
        """(..., 2) pixel pairs -> ((..., 3) fp32 points, (...,) fp32 error
        norm). The rays are the models' fp32 rays; bending, intersection
        and triangulation run in float64 from the float64 centres. A tensor
        keeps its device; an array goes to ``device`` (``None`` = the
        card)."""
        pix1 = on_device(pix1, device, torch.float32)
        pix2 = on_device(pix2, pix1.device, torch.float32).to(pix1.device)
        d1 = self.camera1.pixel_to_vector(pix1).double()
        d2 = self.camera2.pixel_to_vector(pix2).double()
        c1 = self.camera1.camera_center(pix1, torch.float64).expand(d1.shape)
        c2 = self.camera2.camera_center(pix2, torch.float64).expand(d2.shape)
        c1b, d1b = self._bend(c1, d1)
        c2b, d2b = self._bend(c2, d2)
        point, err_vec = triangulate_pair(d1b, c1b, d2b, c2b)
        err = torch.sqrt(dot(err_vec, err_vec))
        return point.float(), err.float()
