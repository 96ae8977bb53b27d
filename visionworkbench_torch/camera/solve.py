"""Generic iterative camera solve (port of
``visionworkbench_tpu/camera/solve.py``; ref ``src/vw/Camera/CameraSolve.h``):
invert ``pixel_to_vector`` for camera models without a closed-form
projection -- Gauss-Newton on the ray/target direction residual.

The JAX package takes each point's 3x2 Jacobian with ``jax.jacfwd`` under
``vmap``. The residual is independent per point, so here it is written
batched, (N, 2) pixels -> (N, 3), and its Jacobian is one forward-mode
``torch.func.jvp`` over the points taken twice, with the tangent (1, 0) on
the first copy and (0, 1) on the second: the same exact derivatives of the
same operations, in half the launches of two JVPs. The 2x2 normal
equations ``(JᵀJ + 1e-12 I) δ = Jᵀr`` are solved in closed form, each
product a single operation (``core/device.dot``), so the card and the CPU
round alike. The iteration count is fixed (a Python loop, no convergence
test), as ``jax.lax.fori_loop``'s.
"""

from __future__ import annotations

from typing import Optional

import torch

from visionworkbench_torch.camera.model import CameraModel
from visionworkbench_torch.core.device import as_f32, dot, norm_rn, on_device


def gauss_newton_pixels(camera: CameraModel, points: torch.Tensor, init: torch.Tensor,
                        iterations: int, step_clip: float,
                        floor: Optional[float]) -> torch.Tensor:
    """(N, 3) fp32 points -> (N, 2) pixels: ``iterations`` Gauss-Newton
    steps from ``init`` ((N, 2) or (2,)) on ``v(pix) - unit(point - c(pix))``,
    each step clipped to ``±step_clip`` px. ``floor`` bounds the distance
    the direction is divided by (``None``: no bound)."""

    n = points.shape[0]
    twice = torch.cat([points, points])

    def residual(pix):
        d = twice - camera.camera_center(pix)
        nrm = norm_rn(d)
        if floor is not None:
            nrm = torch.clamp(nrm, min=floor)
        return camera.pixel_to_vector(pix) - d / nrm[..., None]

    pix = init.expand(n, 2)
    tangent = torch.cat([as_f32(t, points).expand(n, 2) for t in ((1.0, 0.0), (0.0, 1.0))])
    for _ in range(iterations):
        r, j = torch.func.jvp(residual, (torch.cat([pix, pix]),), (tangent,))
        r, ja, jb = r[:n], j[:n].to(r.dtype), j[n:].to(r.dtype)
        a = dot(ja, ja) + 1e-12
        b = dot(ja, jb)
        c = dot(jb, jb) + 1e-12
        g0, g1 = dot(ja, r), dot(jb, r)
        det = a * c - b * b
        delta = torch.stack([(c * g0 - b * g1) / det, (a * g1 - b * g0) / det], -1)
        pix = pix - torch.clamp(delta, -step_clip, step_clip)
    return pix


def solve_point_to_pixel(camera: CameraModel, points, initial_pixel=None,
                         iterations: int = 25, step_clip: float = 200.0, device=None):
    """(..., 3) world points -> (..., 2) pixels by iteratively matching the
    camera ray direction to the point direction. A tensor keeps its device;
    an array goes to ``device`` (``None`` = the card)."""
    points = on_device(points, device, torch.float32)
    init = as_f32((0.0, 0.0) if initial_pixel is None else initial_pixel, points)
    flat = points.reshape(-1, 3)
    out = gauss_newton_pixels(camera, flat, init.to(flat.device), iterations, step_clip, 1e-12)
    return out.reshape(points.shape[:-1] + (2,))
