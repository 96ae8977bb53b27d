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
4x4 grid are 11/10/10/10 px, not a reshape); no scatter-add.

The SIFT-class path of configuration 8 (:func:`sift_orient_describe`)
works per octave block: one upright (K, E, E) window per point, gathered
at once from the octave base, resampled to the point's scale by two
batched products with bilinear row-weight matrices, an orientation
histogram and a descriptor whose upright samples are binned into rotated
cells; every histogram is one-hot terms reduced in a fixed order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from visionworkbench_torch.core.device import as_f32, on_device
from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.image.edge import edge_extend
from visionworkbench_torch.image.interpolation import interpolate
from visionworkbench_torch.interest.types import InterestPoints

SUPPORT_SIZE = 41  # ref Descriptor.h support size


def in_f64(fn, *args):
    """``fn`` of ``args`` (the floating ones taken to float64) rounded once
    to fp32:
    the same value on the card and on the CPU, whose fp32 sqrt / atan2 /
    exp / cos / sin and whose sums' order differ by ulps (a float64 result
    within an ulp of its value rounds to the same fp32 but in ~1e-8 of
    cases). So the describers give bit-equal orientations and descriptors
    on both devices."""
    return fn(*(a.double() if a.is_floating_point() else a for a in args)).to(torch.float32)


def _one_hot_sums(one_hot, terms):
    """Sum over axis 1 of ``terms`` where ``one_hot`` holds: (K, N, B)
    one-hot masks and (K, N, 1) terms to (K, B) histograms, no scatter-add
    (atomics add in no fixed order on the card)."""
    return torch.where(one_hot, terms, 0.0).sum(dim=1)


def _f32_recip(c: float) -> float:
    """fp32 ``1 / c`` (exact as a Python float)."""
    return float(np.float32(1.0) / np.float32(c))


def angle_bins(ang, nbins: int):
    """Bin of each angle in [-pi, pi): ``floor((ang + pi) / (2 pi) * nbins)
    mod nbins``, with the quotient as the JAX package's compiled functions
    compute it: XLA folds a division by a constant into a multiply, here by
    fp32 ``(1 / 2pi) * nbins``. An angle of exactly 0 or +-pi/2 (a gradient
    with one zero component, as where samples clamp at the image border)
    lies on a bin edge for 8 and 36 bins; the IEEE quotient would put it in
    the other bin."""
    step = float(np.float32(_f32_recip(2 * math.pi)) * np.float32(nbins))
    return torch.remainder(torch.floor((ang + math.pi) * step).to(torch.int64), nbins)


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
    cos = in_f64(torch.cos, pts.orientation)[:, None, None]
    sin = in_f64(torch.sin, pts.orientation)[:, None, None]
    s = pts.scale[:, None, None]
    dx = (uu[None] * cos - vv[None] * sin) * s
    dy = (uu[None] * sin + vv[None] * cos) * s
    return pts.x[:, None, None] + dx, pts.y[:, None, None] + dy


def bilinear_once(img, x, y):
    """Bilinear samples of ``img`` at fp32 (x, y), each rounded once to
    fp32: the blend runs in float64. The JAX package samples inside jitted
    functions, where XLA fuses the blend into multiply-adds; there, as
    here, two equal neighbours (samples clamped outside the frame) give
    exactly their value, so a gradient across clamped samples is exactly
    0 and its angle lies exactly on a bin edge."""
    return interpolate(img.double(), x, y, "bilinear").to(torch.float32)


def _sample_support(img, pts: InterestPoints, size: int, upright: bool):
    if upright:
        return _upright_patches(img, pts, size)
    x, y = _support_coords(pts, size)
    return bilinear_once(img, x, y)


def _l2_normalize(v):
    def f(v):
        return v / torch.clamp_min(torch.sqrt((v * v).sum(dim=1, keepdim=True)), 1e-12)
    return in_f64(f, v)


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
    mag = in_f64(torch.sqrt, gx * gx + gy * gy)
    # Gradients are computed IN THE PATCH FRAME: a support sampled on a
    # rotated grid (upright=False) is already rotated by the point's
    # orientation; only the upright path normalizes the angles explicitly.
    ang = in_f64(torch.atan2, gy, gx)
    if upright:
        ang = ang - pts.orientation[:, None, None]
    bin_idx = angle_bins(ang, bins)
    # Gaussian weight over the window
    half = (size - 1) / 2.0
    us = torch.arange(size, dtype=torch.float32, device=img.device) - half
    g = in_f64(torch.exp, -0.5 * (us / torch.tensor(0.5 * size, device=img.device)) ** 2)
    mag = mag * (g[:, None] * g[None, :])[None]
    one_hot = bin_idx[..., None] == torch.arange(bins, device=img.device)
    wb = torch.where(one_hot, mag[..., None], 0.0)          # (K, S, S, bins)
    bounds = _cell_bounds(size, grid)

    def cell_sums(wb):
        cols = torch.stack([wb[:, :, c0:c1].sum(dim=2) for c0, c1 in bounds], dim=2)
        return torch.stack([cols[:, r0:r1].sum(dim=1) for r0, r1 in bounds], dim=1)
    cells = in_f64(cell_sums, wb)
    hist = cells.reshape(k, grid * grid * bins)             # [cy, cx, bin]
    hist = _l2_normalize(torch.clamp_max(_l2_normalize(hist), 0.2))  # SIFT clamp
    return pts._replace(descriptor=torch.where(pts.valid[:, None], hist, 0.0))


def _orientation_weights(n: int, radius: int, device):
    """(n, n) Gaussian weights of the orientation window, centred."""
    us = torch.arange(n, dtype=torch.float32, device=device) - (n - 1) / 2.0
    vv, uu = torch.meshgrid(us, us, indexing="ij")
    var = as_f32((1.5 * radius / 3.0) ** 2, us)
    return in_f64(torch.exp, -0.5 * (uu * uu + vv * vv) / var)


def _peak_orientation(weighted_mag, ang):
    """Dominant orientation of (K, n, n) weighted gradient magnitudes and
    angles: a 36-bin histogram (one-hot terms reduced in a fixed order), two
    circular [1,4,6,4,1]/16 smoothings and the parabola-interpolated peak
    (the first among equal bins)."""
    k = ang.shape[0]
    bins = angle_bins(ang, 36)
    one_hot = bins.reshape(k, -1, 1) == torch.arange(36, device=ang.device)
    hist = in_f64(_one_hot_sums, one_hot, weighted_mag.reshape(k, -1, 1))
    for _ in range(2):
        hist = (torch.roll(hist, 2, 1) + 4 * torch.roll(hist, 1, 1) + 6 * hist
                + 4 * torch.roll(hist, -1, 1) + torch.roll(hist, -2, 1)) / 16.0
    pk = torch.argmax(hist, dim=1, keepdim=True)
    c = hist.gather(1, pk)[:, 0]
    lo = hist.gather(1, torch.remainder(pk - 1, 36))[:, 0]
    hi = hist.gather(1, torch.remainder(pk + 1, 36))[:, 0]
    denom = lo - 2 * c + hi
    off = torch.where(denom.abs() > 1e-12,
                      torch.clamp(0.5 * (lo - hi) / denom, -0.5, 0.5), 0.0)
    return (pk[:, 0].to(torch.float32) + 0.5 + off) / as_f32(36.0, off) * 2 * math.pi - math.pi


def _gradients(patch):
    """Central-difference gradient magnitude and angle of the interior of
    (K, n + 2, n + 2) patches."""
    gx = (patch[:, 1:-1, 2:] - patch[:, 1:-1, :-2]) * 0.5
    gy = (patch[:, 2:, 1:-1] - patch[:, :-2, 1:-1]) * 0.5
    return in_f64(torch.sqrt, gx * gx + gy * gy), in_f64(torch.atan2, gy, gx)


def _block_patches(base, xo, yo, E: int):
    """(K, E, E) integer-origin windows around (xo, yo) from ``base``
    (edge-extended; origins clamped at the borders), gathered at once, and
    the float centre of each point inside its window."""
    pad = 4
    off = E // 2 + pad                       # padded-coords offset
    p = edge_extend(base, off, off, "constant")
    ph, pw = p.shape
    opx = torch.clamp(torch.floor(xo).to(torch.int64) - E // 2 + off, 0, pw - E)
    opy = torch.clamp(torch.floor(yo).to(torch.int64) - E // 2 + off, 0, ph - E)
    steps = torch.arange(E, device=base.device)
    w = p[(opy[:, None] + steps)[:, :, None], (opx[:, None] + steps)[:, None, :]]
    return w, xo + off - opx.to(torch.float32), yo + off - opy.to(torch.float32)


def _resample_w(cf, s, G: int, E: int):
    """(K, G, E) bilinear row-weight matrices: output g samples the patch
    at ``cf + (g - (G-1)/2) * s``."""
    g = torch.arange(G, dtype=torch.float32, device=cf.device)[None, :, None]
    e = torch.arange(E, dtype=torch.float32, device=cf.device)[None, None, :]
    tgt = cf[:, None, None] + (g - (G - 1) / 2.0) * s[:, None, None]
    return torch.clamp_min(1.0 - (e - tgt).abs(), 0.0)


def _scale_patch_grid(patches, cfx, cfy, s, G: int):
    """(K, G, G) scale-normalized upright grids: two batched products per
    point (rows, then columns)."""
    E = patches.shape[-1]
    rows = in_f64(torch.bmm, _resample_w(cfy, s, G, E), patches)
    return in_f64(torch.bmm, rows, _resample_w(cfx, s, G, E).transpose(1, 2))


def _octave_orient_describe(base, xo, yo, s_loc, valid, grid: int, bins: int,
                            size: int, radius: int):
    """Orientation + sgrad descriptor for one octave's point block, in the
    octave's pixels (ref ``SGradDescriptorGenerator`` Descriptor.h:120-180
    + orientation assignment InterestPointDetector.h:160).

    One upright patch stack from the octave base serves both: the
    orientation histogram on a (2 radius + 3)^2 grid, and the descriptor
    from gradients sampled on an UPRIGHT covering grid whose samples are
    assigned to ROTATED cells and bins (elementwise coordinate rotation;
    the Gaussian window is isotropic, so its weights are the rotated
    grid's)."""
    dev = base.device
    go = 2 * radius + 3                      # orientation grid (+grad ring)
    gcov = int(math.ceil(size * math.sqrt(2.0))) + 4  # covering grid + ring
    # Static extent: local sigma is bounded by the octave ladder
    # (sigma0 * 2^((scales+0.5)/scales) ~ 3.6); cover the larger grid.
    smax = 3.7
    E = int(math.ceil((max(go, gcov) - 1) * smax)) + 6
    patches, cfx, cfy = _block_patches(base, xo, yo, E)

    mag, ang = _gradients(_scale_patch_grid(patches, cfx, cfy, s_loc, go))
    ori = _peak_orientation(mag * _orientation_weights(go - 2, radius, dev), ang)
    ori = torch.where(valid, ori, 0.0)

    mag, ang = _gradients(_scale_patch_grid(patches, cfx, cfy, s_loc, gcov))
    ang = ang - ori[:, None, None]
    nd = gcov - 2
    ud = torch.arange(nd, dtype=torch.float32, device=dev) - (nd - 1) / 2.0
    vv, uu = torch.meshgrid(ud, ud, indexing="ij")
    cos = in_f64(torch.cos, ori)[:, None, None]
    sin = in_f64(torch.sin, ori)[:, None, None]
    # descriptor-frame coords: rotate the upright grid by -orientation
    ur = uu[None] * cos + vv[None] * sin
    vr = (-uu)[None] * sin + vv[None] * cos
    half = size / 2.0
    inside = (ur.abs() < half) & (vr.abs() < half)
    var = as_f32((0.5 * size) ** 2, ud)
    wgt = in_f64(torch.exp, -0.5 * ((uu * uu + vv * vv)[None] / var))
    per_cell = _f32_recip(size / grid)
    cx = torch.clamp(torch.floor((ur + half) * per_cell), 0, grid - 1).to(torch.int64)
    cy = torch.clamp(torch.floor((vr + half) * per_cell), 0, grid - 1).to(torch.int64)
    dbin = angle_bins(ang, bins)
    k = mag.shape[0]
    m = torch.where(inside, mag * wgt, 0.0).reshape(k, -1, 1)
    slot = ((cy * grid + cx) * bins + dbin).reshape(k, -1, 1)
    one_hot = slot == torch.arange(grid * grid * bins, device=dev)
    hist = in_f64(_one_hot_sums, one_hot, m)                # [cell, bin]
    hist = _l2_normalize(torch.clamp_max(_l2_normalize(hist), 0.2))  # SIFT clamp
    return ori, torch.where(valid[:, None], hist, 0.0)


def sift_orient_describe(pts: InterestPoints, blocks,
                         grid: int = 4, bins: int = 8, size: int = 24,
                         radius: int = 8) -> InterestPoints:
    """Assign orientations + sgrad descriptors to scale-space detections
    using their octave blocks (from ``detect_points_dog(...,
    return_blocks=True)``) — the default path of
    :func:`visionworkbench_torch.interest.detector.detect_sift_like`."""
    oris, descs = [], []
    for (base, oct_scale, s0, s1) in blocks:
        inv = 1.0 / oct_scale
        sl = slice(s0, s1)
        ori, desc = _octave_orient_describe(
            base, pts.x[sl] * inv, pts.y[sl] * inv, pts.scale[sl] * inv,
            pts.valid[sl], grid, bins, size, radius)
        oris.append(ori)
        descs.append(desc)
    return pts._replace(orientation=torch.cat(oris), descriptor=torch.cat(descs))


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
