"""Quaternions and rotations (port of
``visionworkbench_tpu/math/quaternion.py``; ref ``src/vw/Math/Quaternion.h``
/ ``Quaternion.cc``, ``EulerAngles.h``, SLERP ``QuatInterp.cc``).

Convention matches the reference: quaternion (w, x, y, z), w scalar first.
Functions take tensors (which keep their device) or arrays and numbers
(which go to the CPU) and compute in fp32, one tensor operation a step in
the JAX package's order. ``matrix_to_quat`` is the JAX package's NumPy
function, copied.
"""

from __future__ import annotations

import numpy as np
import torch

from visionworkbench_torch.core.device import as_f32
from visionworkbench_torch.core.exceptions import ArgumentErr


def quat_mul(q1, q2):
    q1, q2 = as_f32(q1), as_f32(q2)
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], -1)


def quat_conj(q):
    q = as_f32(q)
    return q * as_f32([1.0, -1.0, -1.0, -1.0], q)


def quat_norm(q):
    q = as_f32(q)
    return torch.sqrt(torch.sum(q * q, -1))


def quat_normalize(q):
    q = as_f32(q)
    return q / quat_norm(q)[..., None]


def quat_rotate(q, v):
    """Rotate 3-vector(s) v by unit quaternion q."""
    q, v = as_f32(q), as_f32(v)
    qv = torch.cat([torch.zeros(v.shape[:-1] + (1,), dtype=v.dtype, device=v.device), v], -1)
    out = quat_mul(quat_mul(q, qv), quat_conj(q))
    return out[..., 1:]


def axis_angle_to_quat(axis, angle):
    axis = as_f32(axis)
    axis = axis / torch.clamp(torch.sqrt((axis * axis).sum(-1, keepdim=True)), min=1e-30)
    half = as_f32(angle, like=axis).to(axis.device) / 2
    return torch.cat([torch.cos(half)[..., None], torch.sin(half)[..., None] * axis], -1)


def quat_to_axis_angle(q):
    q = quat_normalize(q)
    angle = 2 * torch.arccos(torch.clamp(q[..., 0], -1.0, 1.0))
    s = torch.sqrt(torch.clamp(1 - q[..., 0] ** 2, min=1e-30))
    axis = q[..., 1:] / s[..., None]
    return axis, angle


def quat_to_matrix(q):
    """Unit quaternion -> 3x3 rotation matrix (ref ``Quaternion.h``
    rotation_matrix)."""
    q = quat_normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def matrix_to_quat(m):
    """3x3 rotation matrix -> unit quaternion (w >= 0)."""
    m = np.asarray(m, np.float64)
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        q = np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s,
                      (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s])
    else:
        i = int(np.argmax(np.diag(m)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(m[i, i] - m[j, j] - m[k, k] + 1.0, 0.0)) * 2
        q = np.zeros(4)
        q[0] = (m[k, j] - m[j, k]) / s
        q[i + 1] = 0.25 * s
        q[j + 1] = (m[j, i] + m[i, j]) / s
        q[k + 1] = (m[k, i] + m[i, k]) / s
    if q[0] < 0:
        q = -q
    return q / np.linalg.norm(q)


def slerp(alpha, q0, q1):
    """Spherical linear interpolation (ref ``QuatInterp.cc``)."""
    q0 = quat_normalize(q0)
    q1 = quat_normalize(as_f32(q1, like=q0).to(q0.device))
    alpha = as_f32(alpha, like=q0).to(q0.device)
    dot = torch.sum(q0 * q1, -1)
    q1 = torch.where(dot[..., None] < 0, -q1, q1)
    dot = torch.abs(dot)
    theta = torch.arccos(torch.clamp(dot, -1.0, 1.0))
    sin_theta = torch.sin(theta)
    big = sin_theta > 1e-6
    w0 = torch.where(big, torch.sin((1 - alpha) * theta) / sin_theta, 1 - alpha)
    w1 = torch.where(big, torch.sin(alpha * theta) / sin_theta, alpha)
    return quat_normalize(w0[..., None] * q0 + w1[..., None] * q1)


_AXES = {"x": (1.0, 0.0, 0.0), "y": (0.0, 1.0, 0.0), "z": (0.0, 0.0, 1.0)}


def euler_to_quat(x, y, z, sequence: str = "xyz"):
    """Euler angles -> quaternion (ref ``EulerAngles.h`` euler_to_quaternion)."""
    angles = {"x": x, "y": y, "z": z}
    like = next((a for a in (x, y, z) if isinstance(a, torch.Tensor)), None)
    q = as_f32([1.0, 0.0, 0.0, 0.0], like=like)
    for ax in sequence:
        if ax not in _AXES:
            raise ArgumentErr(f"bad euler sequence {sequence!r}")
        q = quat_mul(q, axis_angle_to_quat(as_f32(_AXES[ax], like=q), angles[ax]))
    return quat_normalize(q)


def euler_to_rotation_matrix(x, y, z, sequence: str = "xyz"):
    return quat_to_matrix(euler_to_quat(x, y, z, sequence))
