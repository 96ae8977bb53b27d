"""Camera matrix fitting (ref ``CameraGeometry.h:45-156``: ``BasicDLT`` +
LMA refinement): recover a 3x4 projection matrix from 3D<->2D
correspondences, and decompose it into pinhole parameters. A copy of the JAX
package's NumPy module ``visionworkbench_tpu/camera/geometry.py``."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from visionworkbench_torch.core.exceptions import ArgumentErr, MathErr
from visionworkbench_torch.camera.pinhole import PinholeModel


def fit_camera_matrix(world_pts, image_pts) -> np.ndarray:
    """Basic DLT (ref ``CameraMatrixFittingFunctor::BasicDLT``,
    CameraGeometry.h:126): >= 6 correspondences -> 3x4 P, normalized."""
    w = np.asarray(world_pts, np.float64)
    p = np.asarray(image_pts, np.float64)
    n = len(w)
    if n < 6:
        raise ArgumentErr("fit_camera_matrix: need >= 6 correspondences")
    # Normalize for conditioning.
    wc = w.mean(axis=0)
    ws = np.sqrt(3.0) / max(np.linalg.norm(w - wc, axis=1).mean(), 1e-12)
    pc = p.mean(axis=0)
    ps = np.sqrt(2.0) / max(np.linalg.norm(p - pc, axis=1).mean(), 1e-12)
    tw = np.eye(4)
    tw[:3, :3] *= ws
    tw[:3, 3] = -ws * wc
    tp = np.array([[ps, 0, -ps * pc[0]], [0, ps, -ps * pc[1]], [0, 0, 1]])
    wn = (w - wc) * ws
    pn = (p - pc) * ps
    a = np.zeros((2 * n, 12))
    for i in range(n):
        x, y, z = wn[i]
        u, v = pn[i]
        a[2 * i] = [x, y, z, 1, 0, 0, 0, 0, -u * x, -u * y, -u * z, -u]
        a[2 * i + 1] = [0, 0, 0, 0, x, y, z, 1, -v * x, -v * y, -v * z, -v]
    _, _, vt = np.linalg.svd(a)
    pm = vt[-1].reshape(3, 4)
    pm = np.linalg.inv(tp) @ pm @ tw
    # Normalize scale/sign: ||P[2,:3]|| = 1, positive depth for centroid.
    scale = np.linalg.norm(pm[2, :3])
    if scale < 1e-15:
        raise MathErr("fit_camera_matrix: degenerate solution")
    pm = pm / scale
    test = pm @ np.append(wc, 1.0)
    if test[2] < 0:
        pm = -pm
    return pm


def decompose_camera_matrix(pm) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """P -> (K, R, C) with K upper-triangular (RQ decomposition), R
    camera-to-world, C the center (ref the pinhole extraction in
    ``CameraGeometry.h``)."""
    pm = np.asarray(pm, np.float64)
    m = pm[:, :3]
    # RQ via flipped QR.
    rev = np.flipud(np.eye(3))
    q, r = np.linalg.qr((rev @ m).T)
    k = rev @ r.T @ rev
    rot = rev @ q.T
    # positive diagonal
    d = np.diag(np.sign(np.diag(k)))
    k = k @ d
    rot = d @ rot
    if np.linalg.det(rot) < 0:
        rot = -rot
        k = -k  # keep P sign
        k = k @ np.diag([-1, -1, -1]) * -1  # normalize again below
    k = k / k[2, 2]
    c = -np.linalg.solve(m, pm[:, 3])
    return k, rot.T, c


def camera_from_points(world_pts, image_pts) -> PinholeModel:
    """Fit and decompose into a PinholeModel."""
    pm = fit_camera_matrix(world_pts, image_pts)
    k, r, c = decompose_camera_matrix(pm)
    return PinholeModel(c, r, (k[0, 0], k[1, 1]), (k[0, 2], k[1, 2]))
