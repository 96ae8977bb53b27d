"""Descriptor generation (port of ``visionworkbench_tpu/interest/descriptor.py``;
ref ``src/vw/InterestPoint/Descriptor.h:40-180``).

* ``patch`` — normalized raw support patch (``PatchDescriptorGenerator:86``)
* ``sgrad`` — gradient-orientation histograms over a 4x4 subgrid of the
  support region, SIFT-like (the role of ``SGradDescriptorGenerator:120``'s
  steerable-gradient histograms)
* ``pca`` — support patches projected on a learned basis
  (``PCASIFTDescriptorGenerator``)

Support regions are windows rotated by each point's orientation and scaled
by its scale, sampled bilinearly with the port's
:func:`~visionworkbench_torch.image.interpolation.interpolate` over the
whole point buffer at once (ref ``get_support``). With ``upright=True``
(every point at orientation 0 and scale 1: single-scale Harris/LoG
detections before :func:`~visionworkbench_torch.interest.detector.
assign_orientations`) a support is one (size+1)^2 window per point,
gathered at once, blended with the point's fractional weights — the same
samples for points away from the border.

The sgrad histograms sum each cell's columns, then its rows, each cell a
reduction of its own in a fixed order (the cells of a 41 px support over a
4x4 grid are 11/10/10/10 px, not a reshape); no scatter-add. The
SIFT-class oriented, scale-normalized descriptors of configuration 8
(``sift_orient_describe``) are not ported yet.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from visionworkbench_torch.core.device import on_device
from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.image.edge import edge_extend
from visionworkbench_torch.image.interpolation import interpolate
from visionworkbench_torch.interest.types import InterestPoints

SUPPORT_SIZE = 41  # ref Descriptor.h support size


def _upright_patches(img, pts: InterestPoints, size: int):
    """(K, size, size) bilinear support patches for axis-aligned unit-scale
    points: one (size+1)^2 window per point (origins clamped to the
    edge-extended image), then a four-corner blend with the point's shared
    fractional weights."""
    half = (size - 1) // 2
    pad = half + 2
    p = edge_extend(img, x_pad=pad, y_pad=pad, mode="constant")
    x0f = torch.floor(pts.x)
    y0f = torch.floor(pts.y)
    fx = (pts.x - x0f)[:, None, None]
    fy = (pts.y - y0f)[:, None, None]
    ox = torch.clamp(x0f.to(torch.int64) - half + pad, 0, p.shape[1] - size - 1)
    oy = torch.clamp(y0f.to(torch.int64) - half + pad, 0, p.shape[0] - size - 1)
    steps = torch.arange(size + 1, device=img.device)
    w = p[(oy[:, None] + steps)[:, :, None], (ox[:, None] + steps)[:, None, :]]
    return ((1 - fy) * (1 - fx) * w[:, :size, :size]
            + (1 - fy) * fx * w[:, :size, 1:]
            + fy * (1 - fx) * w[:, 1:, :size]
            + fy * fx * w[:, 1:, 1:])


def _support_coords(pts: InterestPoints, size: int):
    """Sampling grids: rotated by orientation, scaled by scale (ref
    ``get_support``). Returns (K, size, size) x/y coordinate tensors."""
    half = (size - 1) / 2.0
    us = torch.arange(size, dtype=torch.float32, device=pts.x.device) - half
    vv, uu = torch.meshgrid(us, us, indexing="ij")   # uu: x offsets, vv: y
    cos = torch.cos(pts.orientation)[:, None, None]
    sin = torch.sin(pts.orientation)[:, None, None]
    s = pts.scale[:, None, None]
    dx = (uu[None] * cos - vv[None] * sin) * s
    dy = (uu[None] * sin + vv[None] * cos) * s
    return pts.x[:, None, None] + dx, pts.y[:, None, None] + dy


def _sample_support(img, pts: InterestPoints, size: int, upright: bool):
    if upright:
        return _upright_patches(img, pts, size)
    x, y = _support_coords(pts, size)
    return interpolate(img, x, y, "bilinear")


def _l2_normalize(v):
    norm = torch.sqrt((v * v).sum(dim=1, keepdim=True))
    return v / torch.clamp_min(norm, 1e-12)


def patch_descriptor(img, pts: InterestPoints, size: int = 17,
                     upright: bool = False) -> InterestPoints:
    """Normalized patch descriptor (ref ``PatchDescriptorGenerator``)."""
    img = on_device(img, pts.x.device, torch.float32)
    patches = _sample_support(img, pts, size, upright)
    flat = patches.reshape(patches.shape[0], -1)
    out = _l2_normalize(flat - flat.mean(dim=1, keepdim=True))
    return pts._replace(descriptor=torch.where(pts.valid[:, None], out, 0.0))


def _cell_bounds(size: int, grid: int):
    """[start, stop) of each of the ``grid`` cells over ``size`` pixels:
    pixel i is in cell min(i * grid // size, grid - 1)."""
    cell = [min(i * grid // size, grid - 1) for i in range(size)]
    return [(cell.index(g), size - cell[::-1].index(g)) for g in range(grid)]


def sgrad_descriptor(img, pts: InterestPoints, grid: int = 4, bins: int = 8,
                     size: int = SUPPORT_SIZE,
                     upright: bool = False) -> InterestPoints:
    """Gradient-histogram descriptor (ref ``SGradDescriptorGenerator``)."""
    img = on_device(img, pts.x.device, torch.float32)
    k = pts.x.shape[0]
    patches = _sample_support(img, pts, size, upright)  # (K, size, size)
    gx = (torch.roll(patches, -1, dims=2) - torch.roll(patches, 1, dims=2)) * 0.5
    gy = (torch.roll(patches, -1, dims=1) - torch.roll(patches, 1, dims=1)) * 0.5
    mag = torch.sqrt(gx * gx + gy * gy)
    # Gradients are computed IN THE PATCH FRAME: a support sampled on a
    # rotated grid (upright=False) is already rotated by the point's
    # orientation; only the upright path normalizes the angles explicitly.
    ang = torch.atan2(gy, gx)
    if upright:
        ang = ang - pts.orientation[:, None, None]
    two_pi = torch.tensor(2 * math.pi, dtype=torch.float32, device=img.device)
    bin_idx = torch.remainder(
        torch.floor((ang + math.pi) / two_pi * bins).to(torch.int64), bins)
    # Gaussian weight over the window
    half = (size - 1) / 2.0
    us = torch.arange(size, dtype=torch.float32, device=img.device) - half
    g = torch.exp(-0.5 * (us / torch.tensor(0.5 * size, device=img.device)) ** 2)
    mag = mag * (g[:, None] * g[None, :])[None]
    one_hot = bin_idx[..., None] == torch.arange(bins, device=img.device)
    wb = torch.where(one_hot, mag[..., None], 0.0)          # (K, S, S, bins)
    bounds = _cell_bounds(size, grid)
    cols = torch.stack([wb[:, :, c0:c1].sum(dim=2) for c0, c1 in bounds], dim=2)
    cells = torch.stack([cols[:, r0:r1].sum(dim=1) for r0, r1 in bounds], dim=1)
    hist = cells.reshape(k, grid * grid * bins)             # [cy, cx, bin]
    hist = _l2_normalize(torch.clamp_max(_l2_normalize(hist), 0.2))  # SIFT clamp
    return pts._replace(descriptor=torch.where(pts.valid[:, None], hist, 0.0))


def sift_orient_describe(*args, **kwargs):
    raise ArgumentErr("sift_orient_describe is not ported yet (queue 1 item 3: "
                      "the SIFT-class interest points of configuration 8)")


class PCABasis:
    """Learned PCA projection for patch descriptors
    (ref ``PCASIFTDescriptorGenerator``, Descriptor.h:96-118: a basis matrix
    and mean vector loaded from disk).  The reference ships precomputed
    files; here :func:`fit_pca_basis` learns them from training patches and
    ``save``/``load`` round-trip through ``.npz`` (the JAX package's
    format)."""

    def __init__(self, basis, avg):
        self.basis = np.asarray(basis, np.float32)   # (size*size, k)
        self.avg = np.asarray(avg, np.float32)       # (size*size,)
        if self.basis.shape[0] != self.avg.shape[0]:
            raise ArgumentErr("PCA basis/avg dimension mismatch")
        self.size = int(round(self.basis.shape[0] ** 0.5))

    def save(self, path: str) -> None:
        np.savez(path, basis=self.basis, avg=self.avg)

    @classmethod
    def load(cls, path: str) -> "PCABasis":
        d = np.load(path)
        return cls(d["basis"], d["avg"])


def fit_pca_basis(patches, n_components: int = 20) -> PCABasis:
    """Learn a :class:`PCABasis` from (N, size, size) training patches:
    each patch is L2-normalized (matching ``compute_descriptor``'s
    norm_const), the mean is removed, and the top right-singular vectors
    become the basis (host NumPy, as in the JAX package)."""
    flat = np.asarray(patches, np.float32).reshape(len(patches), -1)
    flat = flat / np.maximum(
        np.linalg.norm(flat, axis=1, keepdims=True), 1e-12)
    avg = flat.mean(axis=0)
    _, _, vt = np.linalg.svd(flat - avg, full_matrices=False)
    return PCABasis(vt[:n_components].T, avg)


def pca_descriptor(img, pts: InterestPoints, basis: PCABasis,
                   upright: bool = False) -> InterestPoints:
    """Project L2-normalized support patches onto a PCA basis
    (ref ``PCASIFTDescriptorGenerator::compute_descriptor``,
    Descriptor.h:380-410): ``desc = (patch/||patch|| - avg) @ basis`` — a
    single (K, d) x (d, k) matmul over all keypoints."""
    img = on_device(img, pts.x.device, torch.float32)
    patches = _sample_support(img, pts, basis.size, upright)
    patches = patches.reshape(pts.x.shape[0], -1)
    dev = img.device
    centered = _l2_normalize(patches) - torch.as_tensor(basis.avg, device=dev)
    desc = centered @ torch.as_tensor(basis.basis, device=dev)
    return pts._replace(descriptor=torch.where(pts.valid[:, None], desc, 0.0))


def describe(img, pts: InterestPoints, kind: str = "sgrad",
             pca_basis: "PCABasis | None" = None,
             upright: bool = False) -> InterestPoints:
    """Descriptors of ``kind`` (``patch``, ``sgrad``/``sgrad2`` or ``pca``)
    on ``pts``' device. ``upright=True`` asserts every point has
    orientation 0 and scale 1 (true straight out of single-scale
    :func:`detect_points`, before :func:`assign_orientations`)."""
    if kind == "patch":
        return patch_descriptor(img, pts, upright=upright)
    if kind in ("sgrad", "sgrad2"):
        return sgrad_descriptor(img, pts, upright=upright)
    if kind == "pca":
        if pca_basis is None:
            raise ArgumentErr("describe(kind='pca') needs a pca_basis")
        return pca_descriptor(img, pts, pca_basis, upright=upright)
    raise ArgumentErr(f"unknown descriptor {kind!r}")
