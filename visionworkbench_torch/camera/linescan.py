"""Linescan camera support utilities (port of
``visionworkbench_tpu/camera/linescan.py``, its NumPy code copied; ref
``src/vw/Camera/LinescanErr.cc``, ``TimeInterp.cc``,
``OrbitalCorrections.cc``, ``CameraParamsPack.cc``): ground-plane
Newton projection for pushbroom sensors, line->time interpolation,
velocity-aberration / atmospheric-refraction ray corrections, and
camera-parameter packing for bundle adjustment.

A linescan (pushbroom) camera exposes one image row at a time while the
platform moves, so ``camera_center`` and ``pixel_to_vector`` depend on the
row (= time).  Any ``CameraModel`` whose methods accept a pixel argument
works with these helpers; the concrete pose-vs-time model is supplied by
the caller (e.g. :func:`make_linescan_model` built from position/pose
samples interpolated with ``math.misc`` splines). :class:`LinescanErr`
takes the model's outputs to float64 host arrays, whether the model returns
arrays or tensors on any device (an ``OpticalBarModel`` computes on its
input's device).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from visionworkbench_torch.core.exceptions import ArgumentErr, LogicErr

SECONDS_PER_DAY = 86164.0905   # sidereal, ref OrbitalCorrections.cc:42
LIGHT_SPEED = 299792458.0


def _axis_angle_quat(axis, angle):
    """w-first unit quaternion in float64 (host-side; the helper in
    ``math.quaternion`` is fp32)."""
    axis = np.asarray(axis, np.float64)
    return np.concatenate([[math.cos(angle / 2)],
                           axis * math.sin(angle / 2)])


# --------------------------------------------------------------------------
# Line -> time interpolation (ref TimeInterp.cc)

class LinearTimeInterpolation:
    """``t = t0 + dt * line`` (ref ``TimeInterp.cc:24-29``)."""

    def __init__(self, initial_time: float, time_per_line: float):
        self.t0 = float(initial_time)
        self.dt = float(time_per_line)

    def __call__(self, line):
        return self.t0 + self.dt * np.asarray(line, np.float64)


class TLCTimeInterpolation:
    """Piecewise-linear time from a TLC (time-line-count) table
    (ref ``TimeInterp.cc:34-63``): per-segment slope/intercept chosen by
    the greatest table line <= query line, extrapolating at both ends."""

    def __init__(self, tlc: Sequence[Tuple[float, float]],
                 time_offset: float = 0.0):
        if len(tlc) < 2:
            raise ArgumentErr("TLCTimeInterpolation needs >= 2 entries")
        self.tlc = [(float(a), float(b)) for a, b in tlc]
        self.time_offset = float(time_offset)
        lines = np.asarray([a for a, _ in self.tlc])
        times = np.asarray([b for _, b in self.tlc])
        self._knots = lines[:-1]
        self._m = (times[1:] - times[:-1]) / (lines[1:] - lines[:-1])
        self._b = (time_offset + times[:-1]) - self._m * lines[:-1]

    def __call__(self, line):
        line = np.asarray(line, np.float64)
        idx = np.clip(np.searchsorted(self._knots, line, "right") - 1,
                      0, len(self._knots) - 1)
        return self._m[idx] * line + self._b[idx]


# --------------------------------------------------------------------------
# Ground-plane Newton projection (ref LinescanErr.cc)

def find_perp_vecs(vec: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Two unit vectors perpendicular to the unit vector ``vec`` and to each
    other (ref ``LinescanErr.cc:26-67``): zero the smallest coordinate and
    swap-negate the other two, then cross."""
    vec = np.asarray(vec, np.float64)
    if abs(np.linalg.norm(vec) - 1.0) > 1e-5:
        raise ArgumentErr("find_perp_vecs: input must be a unit vector")
    min_i = int(np.argmin(np.abs(vec)))
    j, k = [i for i in range(3) if i != min_i]
    perp1 = np.zeros(3)
    perp1[j] = -vec[k]
    perp1[k] = vec[j]
    perp1 /= np.linalg.norm(perp1)
    perp2 = np.cross(vec, perp1)
    perp2 /= np.linalg.norm(perp2)
    return perp1, perp2


def _f64(x) -> np.ndarray:
    """A model's output as a float64 host array (a tensor on any device is
    copied to the host)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


class LinescanErr:
    """2D residual for projecting a ground point into a time-varying camera
    (ref ``LinescanErr.cc:69-105``): the difference between the pixel's ray
    and the camera-to-point direction, projected on a ground-level plane and
    scaled by the ground distance."""

    def __init__(self, model, point, guess):
        self.model = model
        self.point = np.asarray(point, np.float64)
        ctr = _f64(model.camera_center(np.asarray(guess, np.float64))).reshape(3)
        ground_dir = self.point - ctr
        ground_dir /= np.linalg.norm(ground_dir)
        self.perp1, self.perp2 = find_perp_vecs(ground_dir)

    def __call__(self, pix) -> np.ndarray:
        pix = np.asarray(pix, np.float64)
        ctr = _f64(self.model.camera_center(pix)).reshape(3)
        to_ground = self.point - ctr
        dist = np.linalg.norm(to_ground)
        ground_dir = to_ground / dist
        pix_dir = _f64(self.model.pixel_to_vector(pix)).reshape(3)
        diff = pix_dir - ground_dir
        return np.array([np.dot(diff, self.perp1) * dist,
                         np.dot(diff, self.perp2) * dist])


def linescan_point_to_pixel(model, point, guess,
                            tol: float = 1e-8, max_iter: int = 50):
    """Project ``point`` by Newton-Raphson on :class:`LinescanErr` with a
    finite-difference Jacobian (the reference drives ``LinescanErr`` through
    ``math::newtons_method``)."""
    err = LinescanErr(model, point, guess)
    pix = np.asarray(guess, np.float64).copy()
    h = 1e-4
    for _ in range(max_iter):
        f = err(pix)
        if np.linalg.norm(f) < tol:
            break
        jac = np.empty((2, 2))
        for c in range(2):
            step = np.zeros(2)
            step[c] = h
            jac[:, c] = (err(pix + step) - err(pix - step)) / (2 * h)
        try:
            delta = np.linalg.solve(jac, f)
        except np.linalg.LinAlgError:
            break
        pix = pix - delta
        if np.linalg.norm(delta) < tol:
            break
    return pix


# --------------------------------------------------------------------------
# Orbital ray corrections (ref OrbitalCorrections.cc; Earth-specific)

def get_rotation_corrected_velocity(camera_center, camera_velocity,
                                    mean_earth_radius, uncorrected_vector):
    """Camera velocity minus the ground-point velocity due to Earth's
    rotation (ref ``OrbitalCorrections.cc:27-48``)."""
    ctr = np.asarray(camera_center, np.float64)
    vel = np.asarray(camera_velocity, np.float64)
    ray = np.asarray(uncorrected_vector, np.float64)
    r_cam = np.linalg.norm(ctr)
    len_cos = r_cam * np.dot(ray, -ctr / r_cam)
    cam_to_surface = len_cos - math.sqrt(
        mean_earth_radius ** 2 + len_cos ** 2 - r_cam ** 2)
    omega = np.array([0.0, 0.0, 2 * math.pi / SECONDS_PER_DAY])
    return vel - cam_to_surface * np.cross(omega, ray)


def apply_velocity_aberration_correction(camera_center, camera_velocity,
                                         mean_earth_radius,
                                         uncorrected_vector):
    """Rotate the ray against the transverse camera velocity / c
    (ref ``OrbitalCorrections.cc:50-83``).  Returns ``(corrected_ray,
    correction_quaternion)``."""
    ray = np.asarray(uncorrected_vector, np.float64)
    v1 = get_rotation_corrected_velocity(camera_center, camera_velocity,
                                         mean_earth_radius, ray)
    v2 = v1 - np.dot(v1, ray) * ray
    corr = -v2 / LIGHT_SPEED
    axis = np.cross(ray, corr)
    axis /= max(np.linalg.norm(axis), 1e-300)
    angle = math.atan2(np.linalg.norm(corr), np.linalg.norm(ray))
    q = _axis_angle_quat(axis, angle)
    corrected = ray + corr
    return corrected / np.linalg.norm(corrected), q


def saastamoinen_atmosphere_correction(camera_alt: float, ground_alt: float,
                                       alpha: float) -> float:
    """Refraction angle offset, Saastamoinen 1972
    (ref ``OrbitalCorrections.cc:85-99``).  Altitudes in meters, ``alpha``
    the ray's angle from nadir in radians."""
    H = camera_alt / 1000.0
    h = ground_alt / 1000.0
    h_diff = H - h
    p1 = (2335.0 / h_diff) * (1.0 - 0.02257 * h) ** 5.256
    p2 = 0.8540 ** (H - 11.0) * (82.2 - 521.0 / h_diff)
    K = (p1 - p2) * 1e-6
    return K * math.tan(alpha)


def apply_atmospheric_refraction_correction(camera_center, mean_earth_radius,
                                            mean_surface_elevation,
                                            uncorrected_vector):
    """Bend the ray toward nadir by the Saastamoinen offset
    (ref ``OrbitalCorrections.cc:101-132``).  Returns ``(corrected_ray,
    correction_quaternion)``."""
    ctr = np.asarray(camera_center, np.float64)
    nadir = -ctr / np.linalg.norm(ctr)
    cam_alt = np.linalg.norm(ctr) - mean_earth_radius
    ray = np.asarray(uncorrected_vector, np.float64)
    ray = ray / np.linalg.norm(ray)
    alpha = math.acos(np.clip(np.dot(nadir, ray), -1.0, 1.0))
    delta = saastamoinen_atmosphere_correction(cam_alt,
                                               mean_surface_elevation, alpha)
    axis = np.cross(ray, nadir)
    axis /= max(np.linalg.norm(axis), 1e-300)
    q = _axis_angle_quat(axis, delta)
    # Rodrigues in float64 (the quaternion helpers are fp32).
    corrected = (ray * math.cos(delta) + np.cross(axis, ray) * math.sin(delta)
                 + axis * np.dot(axis, ray) * (1 - math.cos(delta)))
    return corrected, q


# --------------------------------------------------------------------------
# Parameter packing (ref CameraParamsPack.cc)

def transform_to_vector(rotation, translation, scale: float = 1.0):
    """Pack rotation+translation+scale into a 7-vector
    ``[tx ty tz, axis-angle, scale]`` (ref ``CameraParamsPack.cc:43-57``).
    Conversions run in float64 (the quaternion helpers are fp32)."""
    r = np.asarray(rotation, np.float64)
    angle = math.acos(np.clip((np.trace(r) - 1) / 2, -1.0, 1.0))
    if angle < 1e-12:
        aa = np.zeros(3)
    else:
        axis = np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0],
                         r[1, 0] - r[0, 1]]) / (2 * math.sin(angle))
        aa = axis * angle
    out = np.empty(7)
    out[:3] = np.asarray(translation, np.float64)
    out[3:6] = aa
    out[6] = scale
    return out


def vector_to_transform(c):
    """Inverse of :func:`transform_to_vector`
    (ref ``CameraParamsPack.cc:24-41``)."""
    c = np.asarray(c, np.float64)
    if c.shape != (7,):
        raise LogicErr("vector_to_transform: expecting a vector of size 7")
    aa = c[3:6]
    angle = np.linalg.norm(aa)
    if angle < 1e-300:
        rot = np.eye(3)
    else:
        k = aa / angle
        kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        rot = (np.eye(3) + math.sin(angle) * kx
               + (1 - math.cos(angle)) * (kx @ kx))
    return rot, c[:3].copy(), float(c[6])
