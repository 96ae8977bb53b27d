"""Ray triangulation + point-cloud generation (port of
``visionworkbench_tpu/stereo/stereo_model.py``; ref
``src/vw/Stereo/StereoModel.h:39-110`` / ``StereoModel.cc:35-254``,
``StereoView.h``).

All math is batched: whole disparity maps triangulate in one call.

Kept divergence: :meth:`StereoModel.triangulate` intersects the models'
fp32 rays in float64 from the models' float64 centres and rounds the points
and errors to fp32 once. The JAX package rounds both centres to fp32 ECEF
(one ulp there is 0.5 m, so the baseline itself is rounded) and intersects
in fp32; its points lie metres off at short baselines (``ROADMAP.md`` §3).
:func:`triangulate_pair` computes in the dtype of its tensors (float64 if
any is float64), fp32 for arrays, as the JAX package.
"""

from __future__ import annotations

import torch

from visionworkbench_torch.camera.model import CameraModel
from visionworkbench_torch.core.device import common_dtype, cross, dot, on_device, sqrt_rn
from visionworkbench_torch.image.transform import _dest_grid
from visionworkbench_torch.stereo.correlation import DisparityMap

DEFAULT_ANGLE_TOL = 1e-4  # ref StereoModel.cc:81 (~0.81 deg convergence)


def triangulate_pair(dir0, ctr0, dir1, ctr1, device=None):
    """Midpoint of the two rays' closest approach + error vector
    (ref ``triangulate_pair``, StereoModel.cc:35-48). Batched (..., 3)."""
    dir0, ctr0, dir1, ctr1 = common_dtype((dir0, ctr0, dir1, ctr1), device)
    v12 = cross(dir0, dir1)
    v1 = cross(v12, dir0)
    v2 = cross(v12, dir1)
    t0 = dot(v2, ctr1 - ctr0) / dot(v2, dir0)
    t1 = dot(v1, ctr0 - ctr1) / dot(v1, dir1)
    p1 = ctr0 + t0[..., None] * dir0
    p2 = ctr1 + t1[..., None] * dir1
    return 0.5 * (p1 + p2), p1 - p2


def are_nearly_parallel(dir0, dir1, angle_tol: float = DEFAULT_ANGLE_TOL, device=None):
    """(ref ``are_nearly_parallel``, StereoModel.cc:68-91)"""
    dir0 = on_device(dir0, device, torch.float32)
    return 1.0 - dot(dir0, on_device(dir1, dir0.device, torch.float32).to(dir0.device)) < angle_tol


class StereoModel:
    """Two-camera triangulator (ref ``StereoModel``, StereoModel.h:39-110)."""

    def __init__(self, camera1: CameraModel, camera2: CameraModel,
                 angle_tol: float = DEFAULT_ANGLE_TOL):
        self.camera1 = camera1
        self.camera2 = camera2
        self.angle_tol = angle_tol

    def triangulate(self, pix1, pix2, device=None):
        """(..., 2) pixel pairs -> ((..., 3) points, (...,) error norm,
        (...,) valid). Nearly-parallel rays are invalid
        (ref ``StereoModel::operator()``, StereoModel.cc:97-165). The rays
        are fp32, the intersection float64 from the float64 centres, the
        points and errors rounded to fp32 once. A tensor keeps its device;
        an array goes to ``device`` (``None`` = the card)."""
        pix1 = on_device(pix1, device, torch.float32)
        pix2 = on_device(pix2, pix1.device, torch.float32).to(pix1.device)
        dir1 = self.camera1.pixel_to_vector(pix1)
        dir2 = self.camera2.pixel_to_vector(pix2)
        ctr1 = self.camera1.camera_center(pix1, torch.float64).expand(dir1.shape)
        ctr2 = self.camera2.camera_center(pix2, torch.float64).expand(dir2.shape)
        point, err_vec = triangulate_pair(dir1.double(), ctr1, dir2.double(), ctr2)
        point = point.float()
        err = torch.sqrt(dot(err_vec, err_vec)).float()
        parallel = are_nearly_parallel(dir1, dir2, self.angle_tol)
        valid = ~parallel & torch.all(torch.isfinite(point), -1)
        point = torch.where(valid[..., None], point, 0.0)
        return point, torch.where(valid, err, 0.0), valid

    def point_cloud(self, disparity: DisparityMap, device=None):
        """Dense triangulation of a disparity map -> ((H, W, 3) points,
        (H, W) error, (H, W) valid) (ref ``StereoView``, StereoView.h).
        Tensors keep their device; arrays go to ``device`` (``None`` = the
        card)."""
        d = on_device(disparity.disparity, device).float()
        dvalid = on_device(disparity.valid, device).to(d.device)
        xs, ys = _dest_grid(*dvalid.shape, d.device)
        pix1 = torch.stack([xs, ys], -1)
        pix2 = torch.stack([xs + d[..., 0], ys + d[..., 1]], -1)
        point, err, valid = self.triangulate(pix1, pix2)
        valid = valid & dvalid
        return (torch.where(valid[..., None], point, 0.0),
                torch.where(valid, err, 0.0), valid)


def triangulate_point_multiview(dirs, ctrs, device=None):
    """N-ray least-squares intersection (ref ``triangulate_point``,
    StereoModel.cc:187-254; Slabaugh et al. optimal ray intersection).

    ``dirs``/``ctrs``: (N, ..., 3) fp32. Returns (point (..., 3), err (...,))
    where err = 2 x mean point-to-ray distance. The batched 3x3 solve is
    ``torch.linalg.solve_ex`` (no host sync on its error check). A tensor
    keeps its device; an array goes to ``device`` (``None`` = the card).
    """
    dirs = on_device(dirs, device, torch.float32)
    ctrs = on_device(ctrs, dirs.device, torch.float32).to(dirs.device)
    eye = torch.eye(3, dtype=torch.float32, device=dirs.device)
    outer = dirs[..., :, None] * dirs[..., None, :]       # (N, ..., 3, 3)
    m = torch.sum(eye - outer, 0)                         # (..., 3, 3)
    r = torch.sum(torch.einsum("n...ij,n...j->n...i", eye - outer, ctrs), 0)
    point = torch.linalg.solve_ex(m, r[..., None])[0][..., 0]
    v = torch.sum(dirs * (point[None] - ctrs), -1)
    d2 = torch.sum((point[None] - ctrs) ** 2, -1) - v * v
    dist = sqrt_rn(torch.clamp(d2, min=0.0))
    err = 2.0 * torch.mean(dist, 0)
    return point, err
