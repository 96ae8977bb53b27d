"""Camera model base + adjusted wrapper (port of
``visionworkbench_tpu/camera/model.py``; ref
``src/vw/Camera/CameraModel.h:60-186``).

Every method is batched: points are (..., 3) and pixels (..., 2) ((x, y) =
(col, row)) fp32 tensors. A tensor keeps its device; an array or a list goes
to the CPU. The models keep their parameters as float64 NumPy arrays and
round them to fp32 where they meet the inputs, as the JAX package does.
``camera_center(pixel, dtype=torch.float64)`` gives the centre unrounded,
for the float64 triangulation of ``stereo/stereo_model.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from visionworkbench_torch.core.device import as_f32, matmul
from visionworkbench_torch.core.exceptions import NoImplErr
from visionworkbench_torch.math.quaternion import matrix_to_quat, quat_to_matrix


class CameraModel:
    """ABC (ref ``CameraModel``, CameraModel.h:60)."""

    def point_to_pixel(self, point):
        """(..., 3) world point -> (..., 2) pixel."""
        raise NoImplErr("point_to_pixel not implemented")

    def pixel_to_vector(self, pixel):
        """(..., 2) pixel -> (..., 3) unit ray direction."""
        raise NoImplErr("pixel_to_vector not implemented")

    def camera_center(self, pixel=None, dtype=torch.float32):
        """(..., 3) ray origin (per-pixel for scanning cameras), on
        ``pixel``'s device."""
        raise NoImplErr("camera_center not implemented")

    def camera_pose(self, pixel=None):
        """Camera-to-world rotation as a quaternion (w, x, y, z)."""
        raise NoImplErr("camera_pose not implemented")

    def type(self) -> str:
        return type(self).__name__


class AdjustedCameraModel(CameraModel):
    """Pose/position delta on top of any camera
    (ref ``AdjustedCameraModel``, CameraModel.h:120-186): world->camera pixel
    via the unadjusted model of the *rotated/translated* geometry.

    Convention follows the reference: ``rotation`` (quaternion) and
    ``translation`` adjust the camera in world frame about ``rotation_center``.
    They are kept rounded to fp32, as the JAX package keeps them.
    """

    def __init__(self, camera: CameraModel, translation=(0.0, 0.0, 0.0),
                 rotation=(1.0, 0.0, 0.0, 0.0),
                 rotation_center=(0.0, 0.0, 0.0)):
        self.unadjusted = camera
        self.translation = np.array(translation, np.float32)
        self.rotation = np.array(rotation, np.float32)
        self.rotation_center = np.array(rotation_center, np.float32)
        self._rot_m = quat_to_matrix(torch.as_tensor(self.rotation)).numpy()

    def _world_to_unadjusted(self, point):
        # Invert the adjustment: p' = R^-1 (p - t - c) + c
        p = as_f32(point)
        c = as_f32(self.rotation_center, p)
        return matmul(p - as_f32(self.translation, p) - c, self._rot_m) + c

    def point_to_pixel(self, point):
        return self.unadjusted.point_to_pixel(self._world_to_unadjusted(point))

    def pixel_to_vector(self, pixel):
        v = self.unadjusted.pixel_to_vector(pixel)
        return matmul(v, self._rot_m.T)

    def camera_center(self, pixel=None, dtype=torch.float32):
        c = self.unadjusted.camera_center(pixel, dtype)
        rc = as_f32(self.rotation_center, c, dtype)
        return matmul(c - rc, self._rot_m.T) + rc + as_f32(self.translation, c, dtype)

    def camera_pose(self, pixel=None):
        base = as_f32(self.unadjusted.camera_pose(pixel)).cpu()
        base_m = quat_to_matrix(base)
        m = (torch.as_tensor(self._rot_m) @ base_m).numpy()
        return torch.as_tensor(matrix_to_quat(m), dtype=torch.float32)
