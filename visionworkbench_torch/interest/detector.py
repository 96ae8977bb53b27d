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

The SIFT-class detectors (DoG, OBALoG, scale-aware orientations) raise:
they are configuration 8's slice, still to port.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from visionworkbench_torch.core.device import as_f32, on_device
from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.image.edge import edge_extend
from visionworkbench_torch.image.filters import gaussian_filter
from visionworkbench_torch.interest.operators import (
    HARRIS_DEFAULT_THRESHOLD, LOG_DEFAULT_THRESHOLD, harris_interest,
    image_gradients, log_interest,
)
from visionworkbench_torch.interest.types import InterestPoints

_NOT_PORTED = ("{} is not ported yet (queue 1 item 3: the SIFT-class "
               "interest points of configuration 8)")


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
            margin = int(2 * sigmas[s]) + 3
            border_ok = torch.zeros((bh, bw), dtype=torch.bool, device=img.device)
            if bh > 2 * margin and bw > 2 * margin:
                border_ok[margin:bh - margin, margin:bw - margin] = True
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
    mag = torch.sqrt(ix * ix + iy * iy)
    ori = torch.atan2(iy, ix)
    h, w = img.shape
    r = 4
    size = 2 * r + 1
    ys0 = torch.clamp(pts.y.to(torch.int64) - r, 0, h - size)
    xs0 = torch.clamp(pts.x.to(torch.int64) - r, 0, w - size)
    steps = torch.arange(size, device=img.device)
    gauss = torch.exp(-0.5 * ((steps - r) ** 2).to(torch.float32) / (2.0 ** 2))
    weight2d = gauss[:, None] * gauss[None, :]
    rows = (ys0[:, None] + steps)[:, :, None]
    cols = (xs0[:, None] + steps)[:, None, :]
    k = pts.x.shape[0]
    m = (mag[rows, cols] * weight2d).reshape(k, -1)
    o = ori[rows, cols].reshape(k, -1)
    # tensor divisors: the IEEE quotient on the card too (a Python-number
    # divisor becomes a multiply by its reciprocal there)
    bins = torch.remainder(torch.floor(
        (o + math.pi) / as_f32(2 * math.pi, o) * 36).to(torch.int64), 36)
    one_hot = bins[..., None] == torch.arange(36, device=img.device)
    hist = torch.where(one_hot, m[..., None], 0.0).sum(dim=1)      # (K, 36)
    peak = torch.argmax(hist, dim=1).to(torch.float32)
    orientation = (peak + 0.5) / as_f32(36.0, peak) * 2 * math.pi - math.pi
    return pts._replace(orientation=torch.where(pts.valid, orientation, 0.0))


def detect_points_obalog(*args, **kwargs):
    raise ArgumentErr(_NOT_PORTED.format("detect_points_obalog"))


def detect_points_dog(*args, **kwargs):
    raise ArgumentErr(_NOT_PORTED.format("detect_points_dog"))


def assign_orientations_scaled(*args, **kwargs):
    raise ArgumentErr(_NOT_PORTED.format("assign_orientations_scaled"))


def detect_sift_like(*args, **kwargs):
    raise ArgumentErr(_NOT_PORTED.format("detect_sift_like"))
