"""Best-fit camera from ground-point / pixel correspondences (port of
``visionworkbench_tpu/cartography/camera_fit.py``, its host NumPy solve
copied; ref ``src/vw/Cartography/CameraDatumFit.cc:30-165``): Levenberg-Marquardt
over the camera's center + axis-angle orientation, minimizing pixel
reprojection error, with an optional height-above-datum or camera-center
prior.  Works on any camera model exposing a center and a camera-to-world
rotation (``PinholeModel.C/.R``, ``OpticalBarModel.position/.rotation``);
the solve runs in float64 on the host (6 parameters, a handful of points —
the Jacobian is central-difference like the reference's
``LeastSquaresModelBase`` default). Each residual projects the points
through the camera's ``point_to_pixel`` on ``device`` (``None`` = the
card): fp32 points made once, pixels back on the host in float64.
"""

from __future__ import annotations

import copy
from typing import Sequence

import numpy as np
import torch

from visionworkbench_torch.core.device import on_device
from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.camera.linescan import (
    transform_to_vector, vector_to_transform,
)


def _get_pose(cam):
    if hasattr(cam, "R"):
        return np.asarray(cam.C, np.float64), np.asarray(cam.R, np.float64)
    if hasattr(cam, "rotation"):
        return (np.asarray(cam.position, np.float64),
                np.asarray(cam.rotation, np.float64))
    raise ArgumentErr(f"camera {type(cam).__name__} exposes no center/rotation")


def _set_pose(cam, center, rot):
    if hasattr(cam, "R"):
        cam.C = np.asarray(center, np.float64)
        cam.R = np.asarray(rot, np.float64)
    else:
        cam.position = np.asarray(center, np.float64)
        cam.rotation = np.asarray(rot, np.float64)


def camera_to_vector(cam) -> np.ndarray:
    """[center(3), axis-angle(3)] (ref ``camera_to_vector``)."""
    c, r = _get_pose(cam)
    return transform_to_vector(r, c)[:6]


def vector_to_camera(cam, vec) -> None:
    """Inverse of :func:`camera_to_vector`, in place."""
    vec = np.asarray(vec, np.float64)
    rot, _, _ = vector_to_transform(np.concatenate([vec[:3], vec[3:6], [1.0]]))
    _set_pose(cam, vec[:3], rot)


def fit_camera_to_datum(xyz: Sequence, pixels: Sequence, camera,
                        datum=None, cam_height: float = 0.0,
                        cam_weight: float = 0.0,
                        cam_ctr_weight: float = 0.0,
                        max_iterations: int = 200, device=None):
    """Refine ``camera``'s center/orientation so ``xyz`` points project to
    ``pixels`` (ref ``fitCam``, CameraDatumFit.cc:100-141).  ``cam_weight``
    adds the residual ``w * (height_above_datum - cam_height)``;
    otherwise ``cam_ctr_weight`` penalizes drift from the initial center.
    Returns a refined copy of ``camera``. The points are projected on
    ``device`` (``None`` = the card)."""
    xyz = np.asarray(xyz, np.float64).reshape(-1, 3)
    xyz_t = on_device(xyz, device, torch.float32)
    target = np.asarray(pixels, np.float64).reshape(-1, 2).ravel()
    if cam_weight > 0 and datum is None:
        raise ArgumentErr("fit_camera_to_datum: cam_weight needs a datum")
    cam = copy.deepcopy(camera)
    ctr0, _ = _get_pose(cam)

    if cam_weight > 0:
        target = np.concatenate([target, [0.0]])
    elif cam_ctr_weight > 0:
        target = np.concatenate([target, np.zeros(3)])

    def residual(p):
        vector_to_camera(cam, p)
        pix = cam.point_to_pixel(xyz_t).cpu().numpy().astype(np.float64).ravel()
        if cam_weight > 0:
            llh = np.asarray(datum.cartesian_to_geodetic(p[:3]), np.float64)
            pix = np.concatenate([pix,
                                  [cam_weight * (float(llh[2]) - cam_height)]])
        elif cam_ctr_weight > 0:
            pix = np.concatenate([pix, cam_ctr_weight * (ctr0 - p[:3])])
        return pix - target

    # Damped Gauss-Newton with central-difference Jacobian (the reference's
    # math::levenberg_marquardt with its default numeric differentiation).
    p = camera_to_vector(cam)
    lam = 0.1
    f = residual(p)
    cost = float(f @ f)
    # Steps sized so the induced pixel motion clears the fp32 noise floor of
    # the fp32 camera models (~0.03 px at 1k-pixel scale).
    steps = np.concatenate([np.full(3, 0.5), np.full(3, 1e-3)])
    for _ in range(max_iterations):
        jac = np.empty((len(f), 6))
        for c in range(6):
            d = np.zeros(6)
            d[c] = steps[c]
            jac[:, c] = (residual(p + d) - residual(p - d)) / (2 * steps[c])
        jtj = jac.T @ jac
        g = jac.T @ f
        improved = False
        for _ in range(10):
            try:
                delta = np.linalg.solve(jtj + lam * np.diag(np.diag(jtj) + 1e-12),
                                        g)
            except np.linalg.LinAlgError:
                break
            cand = p - delta
            fc = residual(cand)
            cc = float(fc @ fc)
            if cc < cost:
                p, f, cost = cand, fc, cc
                lam = max(lam / 10, 1e-12)
                improved = True
                break
            lam *= 10
        if not improved or cost < 1e-20:
            break
    vector_to_camera(cam, p)
    return cam


def fit_pinhole(xyz, pixels, camera, datum=None, cam_height: float = 0.0,
                cam_weight: float = 0.0, cam_ctr_weight: float = 0.0, device=None):
    """(ref ``fitPinhole``, CameraDatumFit.cc:155-164)"""
    return fit_camera_to_datum(xyz, pixels, camera, datum, cam_height,
                               cam_weight, cam_ctr_weight, device=device)


def fit_optical_bar(xyz, pixels, camera, datum=None, cam_height: float = 0.0,
                    cam_weight: float = 0.0, cam_ctr_weight: float = 0.0, device=None):
    """(ref ``fitOpticalBar``, CameraDatumFit.cc:144-152)"""
    return fit_camera_to_datum(xyz, pixels, camera, datum, cam_height,
                               cam_weight, cam_ctr_weight, device=device)
