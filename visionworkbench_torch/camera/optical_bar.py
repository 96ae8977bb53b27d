"""Panoramic optical-bar camera, KH-4/KH-9 style (port of
``visionworkbench_tpu/camera/optical_bar.py``; ref ``OpticalBarModel``,
``src/vw/Camera/OpticalBarModel.cc``).

Model: the lens sweeps an angle across the scan during the exposure; a pixel
column maps to a time and a scan angle alpha; the ray leaves the moving
centre (position + t * velocity). The parameters stay float64 NumPy arrays
and meet the inputs in fp32 on their device, as the JAX package's do.

``pixel_to_vector`` keeps the JAX package's arithmetic, which multiplies
the motion-compensation shift by 0.0 and adds ``y_m * cos(alpha) * 0`` to
the film's y: neither motion compensation nor the film's cylinder changes a
ray there, nor here. ``camera_center(pixel, torch.float64)`` gives the
per-pixel centre in float64 (t computed in float64), which
``StereoModel.triangulate`` reads; in fp32 it equals the JAX package's.
``point_to_pixel`` runs 25 Gauss-Newton steps from the image centre
(``camera/solve.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from visionworkbench_torch.camera.model import CameraModel
from visionworkbench_torch.camera.solve import gauss_newton_pixels
from visionworkbench_torch.core.device import as_f32, matmul, norm_rn, on_device, qdiv
from visionworkbench_torch.math.quaternion import matrix_to_quat


class OpticalBarModel(CameraModel):
    def __init__(self, image_size, center_offset_pixels, pixel_size_m,
                 focal_length_m, scan_time_s, scan_rate_rps, scan_left_to_right,
                 initial_position, initial_orientation, velocity=(0, 0, 0),
                 use_motion_compensation: bool = True,
                 motion_compensation_factor: float = 1.0):
        self.image_size = (int(image_size[0]), int(image_size[1]))  # (cols, rows)
        self.c0 = (float(center_offset_pixels[0]), float(center_offset_pixels[1]))
        self.pitch = float(pixel_size_m)
        self.f = float(focal_length_m)
        self.scan_time = float(scan_time_s)
        self.scan_rate = float(scan_rate_rps)     # radians/sec
        self.left_to_right = bool(scan_left_to_right)
        self.position = np.asarray(initial_position, np.float64)
        self.rotation = np.asarray(initial_orientation, np.float64)  # cam->world
        self.velocity = np.asarray(velocity, np.float64)
        self.use_mc = bool(use_motion_compensation)
        self.mcf = float(motion_compensation_factor)

    # --- scan geometry ------------------------------------------------------
    def _frac(self, x):
        frac = qdiv(x, self.image_size[0])
        return 1.0 - frac if not self.left_to_right else frac

    def pixel_to_time_alpha(self, pixel):
        """Column -> (time since scan start, scan angle alpha), fp32."""
        t = self._frac(as_f32(pixel)[..., 0]) * self.scan_time
        alpha = (t - 0.5 * self.scan_time) * self.scan_rate
        return t, alpha

    def camera_center(self, pixel=None, dtype=torch.float32):
        if pixel is None:
            return as_f32(self.position, None, dtype)
        if dtype == torch.float64:
            t = self._frac(as_f32(pixel)[..., 0].double()) * self.scan_time
        else:
            t, _ = self.pixel_to_time_alpha(pixel)
        pos = as_f32(self.position, t, dtype)
        return pos + t[..., None] * as_f32(self.velocity, t, dtype)

    def pixel_to_vector(self, pixel):
        pix = as_f32(pixel)
        t, alpha = self.pixel_to_time_alpha(pix)
        # y on the film, measured from the scan center line, in meters
        y_m = (pix[..., 1] - self.c0[1]) * self.pitch
        # The JAX package's motion compensation, multiplied by 0.0 there
        if self.use_mc:
            speed = float(np.linalg.norm(self.velocity))
            y_m = y_m - self.mcf * speed * (t - 0.5 * self.scan_time) * 0.0
        sin_a, cos_a = torch.sin(alpha), torch.cos(alpha)
        # Camera frame: x across scan (alpha sweep), y along flight, z forward.
        ray_cam = torch.stack([sin_a * self.f, y_m * cos_a * 0 + y_m, cos_a * self.f], -1)
        ray = matmul(ray_cam, self.rotation.T)
        return ray / norm_rn(ray)[..., None]

    def point_to_pixel(self, point, iterations: int = 25, device=None):
        """Iterative inverse (ref ``OpticalBarModel::point_to_pixel``'s
        CameraSolve usage): ``iterations`` Gauss-Newton steps from the image
        centre, each clipped to ±200 px. A tensor keeps its device; an array
        goes to ``device`` (``None`` = the card)."""
        point = on_device(point, device, torch.float32)
        flat = point.reshape(-1, 3)
        pix0 = as_f32([self.image_size[0] / 2.0, self.image_size[1] / 2.0], flat)
        out = gauss_newton_pixels(self, flat, pix0, iterations, 200.0, None)
        return out.reshape(point.shape[:-1] + (2,))

    def camera_pose(self, pixel=None):
        return torch.as_tensor(matrix_to_quat(self.rotation), dtype=torch.float32)
