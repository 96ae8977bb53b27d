"""Interest point detection (port of ``visionworkbench_tpu/interest/detector.py``;
ref ``src/vw/InterestPoint/InterestPointDetector.h:54-160``, ``Extrema.h``
find_peaks, ``Localize.h`` fit_peak, ``DetectorBase.h:59-310``).

Response maps are computed densely; local 3x3 maxima above threshold are
ranked into a fixed-capacity buffer (the reference's ragged
``InterestPointList`` + ``m_max_points`` culling). The ranking is the JAX
package's: a 2x2 max-pool of the peak map (exact: two cells of a 2x2 block
are always 8-neighbours, so a block holds at most one strict 3x3 maximum),
the pooled values ordered by a stable descending sort (``lax.top_k``'s
order: the lower index first among equal values, the ``-inf`` of empty
blocks included), and the first maximum of each chosen block. So for one
response map the whole point set, invalid slots included, equals the JAX
package's. The scaled detector runs octave/scale Gaussian scale-space and
takes extrema over the 3-scale neighbourhood
(``ScaledInterestPointDetector``); subpixel peak localization fits the 1D
quadratics of the reference's ``fit_peak``.

The SIFT-class path (configuration 8): the DoG detector runs the JAX
package's incremental Gaussian ladder on the same stencils, so its points
equal the JAX package's bit for bit; its 3x3x3 extremum test is a 3x3 max
pool of each neighbour plane (``+inf`` outside the frame), the same
comparisons. OBALoG runs on :mod:`~visionworkbench_torch.image.integral`'s
float64 tables. Orientation histograms are one-hot terms reduced in a fixed
order (no scatter-add).
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.nn.functional as F

from visionworkbench_torch.core.device import as_f32, on_device
from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.image.edge import edge_extend
from visionworkbench_torch.image.filters import gaussian_filter
from visionworkbench_torch.image.integral import obalog_interest
from visionworkbench_torch.image.manipulation import subsample2
from visionworkbench_torch.interest.descriptor import (
    _gradients, _one_hot_sums, _orientation_weights, _peak_orientation, angle_bins,
    bilinear_once, in_f64, sgrad_descriptor, sift_orient_describe,
)
from visionworkbench_torch.interest.operators import (
    HARRIS_DEFAULT_THRESHOLD, LOG_DEFAULT_THRESHOLD, harris_interest,
    image_gradients, log_interest,
)
from visionworkbench_torch.interest.types import InterestPoints


def _local_max_3x3(resp):
    """Strict maxima over the 8-neighbourhood (outside the frame is -inf)."""
    h, w = resp.shape
    p = F.pad(resp, (1, 1, 1, 1), value=float("-inf"))
    is_max = torch.ones_like(resp, dtype=torch.bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            is_max = is_max & (resp > p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w])
    return is_max


def _peaks_to_points(resp, threshold, max_points: int, extra_mask=None):
    """(x, y, interest, valid) of the ``max_points`` strongest strict 3x3
    maxima of ``resp`` above ``threshold`` (and inside ``extra_mask``),
    strongest first, with 1D-quadratic subpixel offsets."""
    h, w = resp.shape
    thr = torch.as_tensor(threshold, dtype=torch.float32, device=resp.device)
    is_peak = _local_max_3x3(resp) & (resp > thr)
    if extra_mask is not None:
        is_peak = is_peak & extra_mask
    masked = torch.where(is_peak, resp, float("-inf"))
    ph, pw = (-h) % 2, (-w) % 2
    p2 = F.pad(masked, (0, pw, 0, ph), value=float("-inf"))
    h2, w2 = (h + ph) // 2, (w + pw) // 2
    pooled = p2.reshape(h2, 2, w2, 2).amax(dim=(1, 3))
    if max_points > h2 * w2:
        raise ArgumentErr(f"_peaks_to_points: max_points {max_points} exceeds the "
                          f"{h2 * w2} 2x2 blocks of a {h}x{w} response")
    vals, bidx = torch.sort(pooled.reshape(-1), descending=True, stable=True)
    vals, bidx = vals[:max_points], bidx[:max_points]
    by = bidx // w2
    bx = bidx % w2
    # the in-block position: the first maximum of the block's four cells
    p2f = p2.reshape(-1)
    w2p = w2 * 2
    base = (2 * by) * w2p + 2 * bx
    cand = torch.stack([p2f[base], p2f[base + 1], p2f[base + w2p],
                        p2f[base + w2p + 1]], dim=-1)
    off = torch.argmax(cand, dim=-1)
    idx = (2 * by + off // 2) * w + (2 * bx + off % 2)
    ys = (idx // w).to(torch.float32)
    xs = (idx % w).to(torch.float32)
    valid = torch.isfinite(vals)

    # Subpixel localization: 1D quadratic in x and y (ref Localize.h fit_peak).
    p = edge_extend(resp, x_pad=1, y_pad=1, mode="constant")
    yi = idx // w + 1
    xi = idx % w + 1
    c = p[yi, xi]
    lx = p[yi, xi - 1]
    rx = p[yi, xi + 1]
    ty = p[yi - 1, xi]
    bo = p[yi + 1, xi]
    denom_x = lx - 2 * c + rx
    denom_y = ty - 2 * c + bo
    off_x = torch.where(denom_x.abs() > 1e-12, 0.5 * (lx - rx) / denom_x, 0.0)
    off_y = torch.where(denom_y.abs() > 1e-12, 0.5 * (ty - bo) / denom_y, 0.0)
    off_x = torch.clamp(off_x, -1.0, 1.0)
    off_y = torch.clamp(off_y, -1.0, 1.0)
    return xs + off_x, ys + off_y, torch.where(valid, vals, 0.0), valid


def _full(k: int, value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((k,), value, dtype=torch.float32, device=like.device)


def detect_points(img, operator: str = "harris", threshold: Optional[float] = None,
                  scale: float = 1.0, max_points: int = 1000,
                  device=None) -> InterestPoints:
    """Single-scale detection (ref ``InterestPointDetector::process_image``);
    a tensor keeps its device, an array goes to ``device`` (``None`` = the
    card)."""
    img = on_device(img, device, torch.float32)
    if operator == "harris":
        resp = harris_interest(img, scale)
        thr = HARRIS_DEFAULT_THRESHOLD if threshold is None else threshold
    elif operator == "log":
        resp = log_interest(img, scale).abs()
        thr = LOG_DEFAULT_THRESHOLD if threshold is None else threshold
    else:
        raise ArgumentErr(f"unknown operator {operator!r}")
    xs, ys, interest, valid = _peaks_to_points(resp, thr, max_points)
    k = max_points
    return InterestPoints(xs, ys, _full(k, scale, img), _full(k, 0.0, img),
                          interest, valid)


def detect_points_scaled(img, operator: str = "log",
                         threshold: Optional[float] = None,
                         scales: int = 3, octaves: int = 3,
                         max_points: int = 1000, device=None) -> InterestPoints:
    """Octave/scale-space detection (ref ``ScaledInterestPointDetector``,
    InterestPointDetector.h:100-160; defaults 3 scales x 3 octaves).

    Per octave, responses at sigma = 1.0 * 2^(s/scales) are stacked and
    extrema must dominate the adjacent-scale 3x3x3 neighborhood.
    """
    img = on_device(img, device, torch.float32)
    per_level = max(max_points // max(octaves * scales, 1), 1)
    all_pts = []
    base = img
    octave_scale = 1.0
    for _ in range(octaves):
        sigmas = [2.0 ** (s / scales) for s in range(scales + 2)]
        if operator == "log":
            # sigma^2 scale normalization makes LoG responses comparable
            # across scales (standard scale-space; the reference's ImageOctave
            # compares responses across its scale stack the same way).
            resps = [log_interest(base, s).abs() * (s * s) for s in sigmas]
            thr = LOG_DEFAULT_THRESHOLD if threshold is None else threshold
        else:
            resps = [harris_interest(base, s) for s in sigmas]
            thr = HARRIS_DEFAULT_THRESHOLD if threshold is None else threshold
        bh, bw = base.shape
        for s in range(1, scales + 1):
            resp = resps[s]
            is_scale_max = resp > torch.maximum(resps[s - 1], resps[s + 1])
            # Exclude the filter-support border (edge-extension artifacts).
            border_ok = _border_ok(bh, bw, int(2 * sigmas[s]) + 3, img.device)
            xs, ys, interest, valid = _peaks_to_points(resp, thr, per_level,
                                                       is_scale_max & border_ok)
            all_pts.append(InterestPoints(
                xs * octave_scale, ys * octave_scale,
                _full(per_level, sigmas[s] * octave_scale, img),
                _full(per_level, 0.0, img), interest, valid))
        base = gaussian_filter(base, 1.0)[::2, ::2].contiguous()
        octave_scale *= 2.0
        if min(base.shape) < 8:
            break
    return concatenate_points(all_pts)


def concatenate_points(point_sets) -> InterestPoints:
    desc = None
    if all(p.descriptor is not None for p in point_sets):
        desc = torch.cat([p.descriptor for p in point_sets])
    return InterestPoints(*(torch.cat([getattr(p, f) for p in point_sets])
                            for f in InterestPoints._fields[:-1]), desc)


def assign_orientations(img, pts: InterestPoints) -> InterestPoints:
    """Dominant gradient orientation per point (ref orientation assignment in
    ``InterestPointDetector.h`` via ``WeightedHistogram.h``): 36-bin histogram
    of gradient directions in a Gaussian-weighted 9x9 support, peak bin wins
    (the first among equal bins).

    The histogram is a one-hot (81 x 36) product reduced over the support
    (no scatter-add, whose atomics on the card add in no fixed order and
    could flip the peak from run to run)."""
    img = on_device(img, pts.x.device, torch.float32)
    ix, iy = image_gradients(img)
    mag = in_f64(torch.sqrt, ix * ix + iy * iy)
    ori = in_f64(torch.atan2, iy, ix)
    h, w = img.shape
    r = 4
    size = 2 * r + 1
    ys0 = torch.clamp(pts.y.to(torch.int64) - r, 0, h - size)
    xs0 = torch.clamp(pts.x.to(torch.int64) - r, 0, w - size)
    steps = torch.arange(size, device=img.device)
    gauss = in_f64(torch.exp, -0.5 * ((steps - r) ** 2).to(torch.float32) / (2.0 ** 2))
    weight2d = gauss[:, None] * gauss[None, :]
    rows = (ys0[:, None] + steps)[:, :, None]
    cols = (xs0[:, None] + steps)[:, None, :]
    k = pts.x.shape[0]
    m = (mag[rows, cols] * weight2d).reshape(k, -1)
    o = ori[rows, cols].reshape(k, -1)
    bins = angle_bins(o, 36)
    one_hot = bins[..., None] == torch.arange(36, device=img.device)
    hist = in_f64(_one_hot_sums, one_hot, m[..., None])            # (K, 36)
    peak = torch.argmax(hist, dim=1).to(torch.float32)
    # a tensor divisor: the IEEE quotient on the card too (a Python-number
    # divisor becomes a multiply by its reciprocal there)
    orientation = (peak + 0.5) / as_f32(36.0, peak) * 2 * math.pi - math.pi
    return pts._replace(orientation=torch.where(pts.valid, orientation, 0.0))




def _border_ok(h: int, w: int, margin: int, device) -> torch.Tensor:
    """True more than ``margin`` px inside an (h, w) frame; all false when
    the frame has no such interior."""
    ok = torch.zeros((h, w), dtype=torch.bool, device=device)
    if h > 2 * margin and w > 2 * margin:
        ok[margin:h - margin, margin:w - margin] = True
    return ok


def detect_points_obalog(img, threshold: float = 1e-4, scales: int = 3,
                         max_points: int = 1000, gain: float = 1.0,
                         device=None) -> InterestPoints:
    """Integral-image box-approximated LoG detector with per-scale auto gain
    (ref ``OBALoG`` / ``IntegralAutoGainDetector``,
    ``IntegralInterestOperator.h:43-79``, ``IntegralDetector.h:37-103``):
    center-surround box responses at doubling box sizes, thresholds relaxed
    by ``gain`` per scale, extrema per scale merged."""
    img = on_device(img, device, torch.float32)
    per_level = max(max_points // max(scales, 1), 1)
    sets = []
    thr = threshold
    for s in range(scales):
        resp = obalog_interest(img, s).abs()
        h, w = resp.shape
        xs, ys, interest, valid = _peaks_to_points(
            resp, thr, per_level, _border_ok(h, w, 5 * (1 << s), img.device))
        sets.append(InterestPoints(xs, ys, _full(per_level, float(1 << s), img),
                                   _full(per_level, 0.0, img), interest, valid))
        thr *= gain
    return concatenate_points(sets)


def _dog_edge_ok(plane, edge_ratio: float):
    """SIFT edge rejection: 2x2 spatial Hessian of the DoG plane must satisfy
    tr^2/det < (r+1)^2/r with det > 0 (Lowe 2004 sec. 4.1; fills the role of
    the reference's OpenCV SIFT bridge's edgeThreshold). The same mask for
    the plane and its negation (IEEE rounding is sign-symmetric)."""
    p = edge_extend(plane, 1, 1, "constant")
    c = plane
    dxx = p[1:-1, 2:] - 2 * c + p[1:-1, :-2]
    dyy = p[2:, 1:-1] - 2 * c + p[:-2, 1:-1]
    dxy = 0.25 * (p[2:, 2:] - p[2:, :-2] - p[:-2, 2:] + p[:-2, :-2])
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = edge_ratio
    return (det > 0) & (tr * tr * r < det * (r + 1.0) * (r + 1.0))


def _neighbour_max(plane):
    """Max over each pixel's 3x3 neighbourhood (itself included), ``+inf``
    outside the frame: a pixel beats all 9 iff it beats this."""
    p = F.pad(plane[None, None], (1, 1, 1, 1), value=float("inf"))
    return F.max_pool2d(p, 3, stride=1)[0, 0]


def detect_points_dog(img, threshold: float = 0.015, edge_ratio: float = 10.0,
                      scales: int = 3, octaves: int = 4, sigma0: float = 1.6,
                      max_points: int = 1000, return_blocks: bool = False,
                      device=None):
    """Difference-of-Gaussians scale-space detector — the SIFT-class
    pipeline standing in for the reference's OpenCV SIFT bridge
    (``ipfind.cc:61-229``, ``OpenCvDetector.cc``; ipfind's DEFAULT operator).

    Per octave: a Gaussian ladder at sigma = sigma0 * 2^(s/scales)
    (s = 0..scales+2), built incrementally (each level blurs the previous
    one by the differential sigma; octave 0 blurs the input up to sigma0,
    deeper octaves start from the decimated ``gauss[scales]``), DoG planes
    from adjacent ladder steps, strict 3x3x3 scale-space extrema (maxima of
    the DoG and of its negation), the contrast threshold, 2x2-Hessian edge
    rejection (``_dog_edge_ok``) and 1D quadratic subpixel localization in
    x, y and scale. Positions are in input pixels; ``scale`` is the
    interpolated Gaussian sigma. ``max_points // (octaves * scales)`` slots
    per (octave, scale, sign) set. ``return_blocks`` also gives each
    octave's ``(base, octave_scale, slot_start, slot_end)`` for
    :func:`~visionworkbench_torch.interest.descriptor.sift_orient_describe`.
    """
    img = on_device(img, device, torch.float32)
    per_level = max(max_points // max(octaves * scales, 1), 1)
    sets = []
    blocks = []
    base = img
    octave_scale = 1.0
    for o in range(octaves):
        bh, bw = base.shape
        if min(bh, bw) < 16:
            break
        blocks.append([base, octave_scale, len(sets) * per_level, None])
        sigmas = [sigma0 * 2.0 ** (s / scales) for s in range(scales + 3)]
        gauss = [base if o > 0 else gaussian_filter(base, sigmas[0])]
        for s in range(1, scales + 3):
            dsig = (sigmas[s] ** 2 - sigmas[s - 1] ** 2) ** 0.5
            gauss.append(gaussian_filter(gauss[-1], dsig))
        dog = [g1 - g0 for g0, g1 in zip(gauss[:-1], gauss[1:])]
        signed = {1.0: dog, -1.0: [-d for d in dog]}
        nmax = {sign: [_neighbour_max(p) for p in planes]
                for sign, planes in signed.items()}
        for s in range(1, scales + 1):
            border_ok = _border_ok(bh, bw, int(2 * sigmas[s + 1]) + 3, img.device)
            keep = border_ok & _dog_edge_ok(dog[s], edge_ratio)
            for sign in (1.0, -1.0):
                vol = signed[sign]
                resp = vol[s]
                ok_adj = resp > torch.maximum(nmax[sign][s - 1], nmax[sign][s + 1])
                xs, ys, interest, valid = _peaks_to_points(resp, threshold, per_level,
                                                           ok_adj & keep)
                # scale interpolation: 1D quadratic across the DoG ladder at
                # the integer peak
                xi = torch.clamp(xs.to(torch.int64), 0, bw - 1)
                yi = torch.clamp(ys.to(torch.int64), 0, bh - 1)
                c = vol[s][yi, xi]
                lo = vol[s - 1][yi, xi]
                hi = vol[s + 1][yi, xi]
                denom = lo - 2 * c + hi
                ds = torch.where(denom.abs() > 1e-12,
                                 torch.clamp(0.5 * (lo - hi) / denom, -0.5, 0.5), 0.0)
                # float64 power: the same scale on the card and the CPU
                sig = (sigma0 * in_f64(lambda t: torch.pow(2.0, t),
                                       (ds + s) / as_f32(float(scales), ds)) * octave_scale)
                sets.append(InterestPoints(
                    xs * octave_scale, ys * octave_scale, torch.where(valid, sig, 1.0),
                    _full(per_level, 0.0, img), interest, valid))
        blocks[-1][3] = len(sets) * per_level
        base = subsample2(gauss[scales])
        octave_scale *= 2.0
    pts = concatenate_points(sets)
    if return_blocks:
        return pts, [tuple(b) for b in blocks]
    return pts


def assign_orientations_scaled(img, pts: InterestPoints,
                               radius: int = 8) -> InterestPoints:
    """Scale-aware orientation assignment for scale-space detections (use
    after :func:`detect_points_dog`; :func:`assign_orientations` remains the
    fixed-window variant for unit-scale points): gradients of bilinear
    samples on a scale-normalized grid, a 36-bin magnitude histogram with
    Gaussian weighting, circular smoothing and the parabola-interpolated
    peak (Lowe 2004 sec. 5; ref orientation assignment in
    InterestPointDetector.h:160 via WeightedHistogram.h)."""
    img = on_device(img, pts.x.device, torch.float32)
    size = 2 * radius + 3           # +1 ring for patch-frame gradients
    us = torch.arange(size, dtype=torch.float32, device=img.device) - (size - 1) / 2.0
    vv, uu = torch.meshgrid(us, us, indexing="ij")
    s = pts.scale[:, None, None]
    patch = bilinear_once(img, pts.x[:, None, None] + uu * s,
                          pts.y[:, None, None] + vv * s)
    mag, ang = _gradients(patch)
    ori = _peak_orientation(mag * _orientation_weights(size - 2, radius, img.device), ang)
    return pts._replace(orientation=torch.where(pts.valid, ori, 0.0))


def detect_sift_like(img, threshold: float = 0.015, max_points: int = 1000,
                     descriptor_size: int = 24, device=None) -> InterestPoints:
    """The full SIFT-class pipeline: DoG detection -> scale-aware
    orientations -> oriented, scale-normalized gradient-histogram (sgrad)
    descriptors (the capability of the reference ipfind's default SIFT
    path).

    By default orientation and description run per octave block on upright
    patch stacks from the octave bases
    (:func:`~visionworkbench_torch.interest.descriptor.sift_orient_describe`);
    ``VWTPU_SIFT_GATHER=1`` (read on every call) runs
    :func:`assign_orientations_scaled` and the rotated-support
    ``sgrad_descriptor`` instead, as in the JAX package."""
    img = on_device(img, device, torch.float32)
    if os.environ.get("VWTPU_SIFT_GATHER", "0") == "1":
        pts = detect_points_dog(img, threshold=threshold, max_points=max_points)
        pts = assign_orientations_scaled(img, pts)
        return sgrad_descriptor(img, pts, size=descriptor_size, upright=False)
    pts, blocks = detect_points_dog(img, threshold=threshold, max_points=max_points,
                                    return_blocks=True)
    return sift_orient_describe(pts, blocks, size=descriptor_size)
