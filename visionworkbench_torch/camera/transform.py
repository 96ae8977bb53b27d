"""Camera-to-camera pixel mapping and undistortion warps (port of
``visionworkbench_tpu/camera/transform.py``; ref
``src/vw/Camera/CameraTransform.h`` and ``tools/undistort_image.cc``).

``camera_transform_map`` maps destination pixels through
dst.pixel_to_vector -> src.point_to_pixel assuming a shared camera center
(valid for undistortion and epipolar rectification, the reference's uses);
the result feeds :func:`visionworkbench_torch.image.transform.sample` as one
warp.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from visionworkbench_torch.camera.model import CameraModel
from visionworkbench_torch.camera.pinhole import PinholeModel
from visionworkbench_torch.camera.distortion import NullLensDistortion
from visionworkbench_torch.core.device import on_device, resolve_device
from visionworkbench_torch.image.transform import _dest_grid, sample


def camera_transform_map(dst_cam: CameraModel, src_cam: CameraModel,
                         out_shape: Tuple[int, int], device=None):
    """(sx, sy) source-pixel coordinate grids for each destination pixel,
    on ``device`` (``None`` = the card)."""
    oh, ow = int(out_shape[0]), int(out_shape[1])
    xs, ys = _dest_grid(oh, ow, resolve_device(device))
    pix = torch.stack([xs, ys], -1)
    rays = dst_cam.pixel_to_vector(pix)
    center = dst_cam.camera_center(pix)
    # Project a point far along each ray (pure-rotation assumption).
    pts = center + rays * 1.0e4
    src_pix = src_cam.point_to_pixel(pts)
    return src_pix[..., 0], src_pix[..., 1]


def camera_transform(image, src_cam: CameraModel, dst_cam: CameraModel,
                     out_shape: Optional[Tuple[int, int]] = None,
                     interp: str = "bilinear", edge: str = "zero", device=None):
    """Warp ``image`` (taken by src_cam) into dst_cam's pixel space
    (ref ``camera_transform``, CameraTransform.h). A tensor keeps its
    device; an array goes to ``device`` (``None`` = the card)."""
    image = on_device(image, device)
    if out_shape is None:
        out_shape = image.shape[:2]
    sx, sy = camera_transform_map(dst_cam, src_cam, out_shape, image.device)
    return sample(image, sx, sy, interp=interp, edge=edge)


def undistorted_camera(cam: PinholeModel) -> PinholeModel:
    """The same pinhole with distortion removed (ref ``undistort_image.cc``
    strip_distortion path)."""
    return PinholeModel(cam.C, cam.R, (cam.fu, cam.fv), (cam.cu, cam.cv),
                        NullLensDistortion(), cam.pixel_pitch)


def undistort_image(image, cam: PinholeModel, interp: str = "bilinear",
                    edge: str = "zero", device=None):
    """Resample away lens distortion (ref ``tools/undistort_image.cc``)."""
    return camera_transform(image, cam, undistorted_camera(cam), None, interp,
                            edge, device)
