"""Epipolar rectification of a pinhole stereo pair (a copy of the JAX
package's NumPy module ``visionworkbench_tpu/camera/epipolar.py``; ref
``src/vw/Camera/EpipolarUtils.h:36-65``).

Builds two new pinhole cameras sharing a rotation whose x-axis is the
baseline (the standard rectification the reference computes for
pinhole/CAHV pairs), so conjugate epipolar lines become common scanlines.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.camera.pinhole import PinholeModel
from visionworkbench_torch.camera.distortion import NullLensDistortion


def epipolar_rectify(cam1: PinholeModel, cam2: PinholeModel
                     ) -> Tuple[PinholeModel, PinholeModel]:
    """Return rectified (cam1', cam2') with identical rotation and intrinsics
    (ref ``epipolar``, EpipolarUtils.h)."""
    c1, c2 = cam1.C, cam2.C
    baseline = c2 - c1
    b_norm = np.linalg.norm(baseline)
    if b_norm < 1e-12:
        raise ArgumentErr("epipolar_rectify: cameras share a center")
    x_axis = baseline / b_norm
    # Mean forward direction, orthogonalized against the baseline.
    fwd = 0.5 * (cam1.R[:, 2] + cam2.R[:, 2])
    z_axis = fwd - np.dot(fwd, x_axis) * x_axis
    zn = np.linalg.norm(z_axis)
    if zn < 1e-12:
        raise ArgumentErr("epipolar_rectify: baseline parallel to view direction")
    z_axis /= zn
    y_axis = np.cross(z_axis, x_axis)
    r_new = np.stack([x_axis, y_axis, z_axis], axis=1)  # columns = axes

    fu = 0.5 * (cam1.fu + cam2.fu)
    fv = 0.5 * (cam1.fv + cam2.fv)
    cu = 0.5 * (cam1.cu + cam2.cu)
    cv = 0.5 * (cam1.cv + cam2.cv)
    out1 = PinholeModel(c1, r_new, (fu, fv), (cu, cv), NullLensDistortion(),
                        cam1.pixel_pitch)
    out2 = PinholeModel(c2, r_new, (fu, fv), (cu, cv), NullLensDistortion(),
                        cam2.pixel_pitch)
    return out1, out2
