"""Plain PyTorch reference of the pyramid correlator, frozen for the benchmark.

A copy of the path that ``visionworkbench_torch.stereo.pyramid_correlation.
pyramid_correlate`` runs at the settings of the benchmark's configurations,
written as plain tensor operations with no kernel and no import of the
program: replicate-extended crops, the 5-tap blur-and-subsample pyramids and
their 2-of-4 mask pyramids, the prefilters, the per-tile search offsets, the
block-matching sweep (abs, sq, NCC) or the census SGM/MGM search, the L<->R
consistency check, the speckle passes, the mask test and the parabola fit
(ref ``CorrelationView.cc``, ``SGM.cc``, ``DisparityMap.h``,
``ParabolaSubpixelView.cc``). It works everything out again from the two
images it is given.

``dtype`` is the working precision of every floating-point value that the
program holds in float32 (images, pyramids, costs, sums, aggregated SGM
volumes). ``torch.float32`` is the reference; a lower one (``bfloat16``) is
the benchmark's control. Integer state (disparities, codes, counts, tile
offsets) stays integer, and the SGM parabola keeps its float64 fit.

Options outside the benchmark's configurations (masks, a time budget, the
blob filter, the Bayes-EM / affine refiners, census block matching) raise.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# edges and crops
# ---------------------------------------------------------------------------


def _clamped(start: int, count: int, n: int, dev) -> torch.Tensor:
    return torch.arange(start, start + count, device=dev).clamp_(0, n - 1)


def crop_replicate(img, x0: int, y0: int, width: int, height: int):
    """Crop of ``img`` (H, W, ...) at (x0, y0), outside pixels replicated
    from the nearest edge."""
    rows = _clamped(int(y0), int(height), img.shape[0], img.device)
    cols = _clamped(int(x0), int(width), img.shape[1], img.device)
    return img.index_select(0, rows).index_select(1, cols)


def crop_zero(img, x0: int, y0: int, width: int, height: int):
    """Crop of ``img`` (H, W, ...) at (x0, y0), outside pixels zero."""
    h, w = img.shape[0], img.shape[1]
    out = img.new_zeros((height, width) + tuple(img.shape[2:]))
    ya, yb = max(y0, 0), min(y0 + height, h)
    xa, xb = max(x0, 0), min(x0 + width, w)
    if ya < yb and xa < xb:
        out[ya - y0:yb - y0, xa - x0:xb - x0] = img[ya:yb, xa:xb]
    return out


def pad_replicate(img, x_pad: Tuple[int, int], y_pad: Tuple[int, int]):
    h, w = img.shape[0], img.shape[1]
    return crop_replicate(img, -x_pad[0], -y_pad[0], w + x_pad[0] + x_pad[1],
                          h + y_pad[0] + y_pad[1])


# ---------------------------------------------------------------------------
# filters (ref Filter.tcc, Filter.h, Convolution.h)
# ---------------------------------------------------------------------------


def gaussian_taps(sigma: float) -> np.ndarray:
    """Erf-integrated Gaussian taps of VW's default size (ref
    ``Filter.cc:32-38``, ``Filter.tcc:37-80``)."""
    size = int(7 * sigma)
    if size < 3:
        size = 3
    elif size % 2 == 0:
        size -= 1
    kernel = np.zeros((size,), np.float64)
    center = size // 2
    z = 1.0 / (math.sqrt(2.0) * sigma)
    total = 0.0
    for i in range(1, center + 1):
        tap = math.erf((i + 0.5) * z) - math.erf((i - 0.5) * z)
        total += tap
        kernel[center + i] = kernel[center - i] = tap
    total *= 2.0
    tap = math.erf(0.5 * z) - math.erf(-0.5 * z)
    total += tap
    kernel[center] = tap
    return kernel / total


def _stencil_valid(img, kernel2d: np.ndarray):
    """'valid' correlation as shifted-slice products summed in row-major
    tap order, every tap (zeros too) one multiply and one add."""
    kh, kw = kernel2d.shape
    oh, ow = img.shape[0] - kh + 1, img.shape[1] - kw + 1
    out = None
    for i in range(kh):
        for j in range(kw):
            term = float(kernel2d[i, j]) * img[i:i + oh, j:j + ow]
            out = term if out is None else out + term
    return out


def _convolve(img, kernel2d: np.ndarray):
    """True convolution with VW's default origin, edges replicated."""
    k = np.asarray(kernel2d, np.float32)
    kh, kw = k.shape
    cx, cy = (kw - 1) - kw // 2, (kh - 1) - kh // 2
    padded = pad_replicate(img, (kw - 1 - cx, cx), (kh - 1 - cy, cy))
    return _stencil_valid(padded, k[::-1, ::-1])


def gaussian_filter(img, sigma: float):
    taps = gaussian_taps(sigma)
    out = _convolve(img, taps[None, :])
    return _convolve(out, taps[:, None])


def laplacian_filter(img):
    kernel = np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]], np.float64)
    k = np.asarray(kernel, np.float32)
    padded = pad_replicate(img, (1, 1), (1, 1))
    return _stencil_valid(padded, k[::-1, ::-1])


def prefilter(img, mode: str, width: float):
    """ref ``prefilter_image``, PreFilter.h:78-100."""
    if mode == "log":
        return laplacian_filter(gaussian_filter(img, width))
    if mode == "meansub":
        return img - gaussian_filter(img, width)
    if mode == "none":
        return img
    raise ValueError(f"reference: unknown prefilter {mode!r}")


# ---------------------------------------------------------------------------
# pyramids (ref CorrelationView.cc:36-216)
# ---------------------------------------------------------------------------


def max_levels(width: int, height: int, kernel, search_w: int, search_h: int,
               requested: int) -> int:
    """ref ``CorrelationView.cc:300-308`` and ``CorrelationView.h:99-105``."""
    by_size = int(math.floor(math.log2(max(min(width, height), 1))
                             - math.log2(max(max(kernel), 1))))
    by_search = int(math.floor(math.log2(max(search_w, search_h, 1)))) - 1
    return max(min(by_size, max(by_search, 0), int(requested)), 0)


def blur_downsample(img):
    """[1 4 6 4 1]/16 blur and subsample by 2: rows, then columns, each
    output summing its five taps in order over the replicated image."""
    k = [1 / 16, 4 / 16, 6 / 16, 4 / 16, 1 / 16]
    h, w = img.shape
    h2, w2 = (h + 1) // 2, (w + 1) // 2
    p = crop_replicate(img, -2, -2, w + 4, h + 4)
    rows = k[0] * p[0:2 * h2 - 1:2]
    for t in range(1, 5):
        rows = rows + k[t] * p[t:t + 2 * h2 - 1:2]
    out = k[0] * rows[:, 0:2 * w2 - 1:2]
    for t in range(1, 5):
        out = out + k[t] * rows[:, t:t + 2 * w2 - 1:2]
    return out


def mask_downsample(mask):
    """A coarse pixel is valid where 2 or more of its 2x2 are (ref
    ``SubsampleMaskByTwoFunc``); odd edges padded invalid."""
    h, w = mask.shape
    m = mask.new_zeros((h + h % 2, w + w % 2))
    m[:h, :w] = mask
    cnt = m.to(torch.int32).reshape(m.shape[0] // 2, 2, m.shape[1] // 2, 2).sum((1, 3))
    return cnt >= 2


def level_plan(h: int, w: int, levels: int, s_w: int, s_h: int,
               refine_window: int, sgm_buffer: Optional[int]):
    """Each level's ``(level, s_w_l, s_h_l, s_x, s_y)``, coarsest first: the
    level's search and the window searched (the whole search at the
    coarsest level, then the refine window, or ``2 * buffer + 1`` for
    SGM/MGM; ref ``CorrelationView.cc:391-395``)."""
    plan = []
    for level in range(levels, -1, -1):
        s = 1 << level
        s_w_l, s_h_l = max(s_w // s, 1), max(s_h // s, 1)
        if level == levels:
            win = (s_w_l, s_h_l)
        elif sgm_buffer is not None:
            win = (2 * sgm_buffer + 1,) * 2
        else:
            win = (refine_window,) * 2
        plan.append((level, s_w_l, s_h_l, min(win[0], s_w_l), min(win[1], s_h_l)))
    return plan


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pad_to(x, h: int, w: int):
    out = x.new_zeros((h, w) + tuple(x.shape[2:]))
    hh, ww = min(h, x.shape[0]), min(w, x.shape[1])
    out[:hh, :ww] = x[:hh, :ww]
    return out


def upsample2(disp, valid):
    """2x nearest upsample, disparities doubled (ref
    ``DisparityUpsampleView``)."""
    d = (disp * 2).repeat_interleave(2, 0).repeat_interleave(2, 1)
    v = valid.repeat_interleave(2, 0).repeat_interleave(2, 1)
    return d, v


def tile_offsets_min(prior_disp, prior_valid, tile: int, expand: int,
                     max_x: int, max_y: int):
    """BM tile offsets: the valid tile minimum of the previous level minus
    ``expand``, clamped; a tile with no valid pixel takes the frame's."""
    h, w = prior_valid.shape
    nty, ntx = h // tile, w // tile
    big = 1e30
    d = prior_disp.to(torch.float32)
    masked = torch.where(prior_valid[..., None], d,
                         torch.full((), big, device=d.device))
    tmin = masked.reshape(nty, tile, ntx, tile, 2).amin(dim=(1, 3))
    has = prior_valid.reshape(nty, tile, ntx, tile).any(3).any(1)
    gmin = masked.reshape(-1, 2).amin(0)
    gmin = torch.where(gmin >= big, torch.zeros_like(gmin), gmin)
    tmin = torch.where(has[..., None], tmin, gmin[None, None, :])
    off = torch.floor(tmin).to(torch.int32) - expand
    return torch.stack([off[..., 0].clamp(0, max_x),
                        off[..., 1].clamp(0, max_y)], -1).contiguous()


def _hist_median(counts):
    n = counts.sum(-1, keepdim=True)
    cum = counts.cumsum(-1)
    k1 = torch.floor((n - 1) / 2)
    k2 = torch.floor(n / 2)
    nv = counts.shape[-1]
    vals = torch.arange(nv, dtype=torch.float32, device=counts.device)
    big = torch.full_like(vals, float(nv))
    v1 = torch.where(cum > k1, vals, big).amin(-1)
    v2 = torch.where(cum > k2, vals, big).amin(-1)
    return torch.where(n[..., 0] > 0, 0.5 * (v1 + v2), torch.zeros_like(v1))


def tile_offsets_median(prior_disp, prior_valid, tile: int, buffer: int,
                        max_x: int, max_y: int, bounds: Tuple[int, int]):
    """SGM/MGM tile offsets: the tile median of the previous level (exact,
    from per-value counts) minus ``buffer``, clamped; a tile with no valid
    pixel takes the frame's median."""
    h, w = prior_valid.shape
    nty, ntx = h // tile, w // tile
    has = prior_valid.reshape(nty, tile, ntx, tile).any(3).any(1)
    r = torch.round(prior_disp.to(torch.float32)).to(torch.int32)
    di = torch.stack([r[..., 0].clamp(0, bounds[0] - 1),
                      r[..., 1].clamp(0, bounds[1] - 1)], -1)
    t4 = (di.reshape(nty, tile, ntx, tile, 2).transpose(1, 2)
          .reshape(nty, ntx, tile * tile, 2))
    v4 = (prior_valid.reshape(nty, tile, ntx, tile).transpose(1, 2)
          .reshape(nty, ntx, tile * tile).to(torch.float32))
    meds = []
    for c in (0, 1):
        counts = torch.zeros((nty, ntx, int(bounds[c])), dtype=torch.float32,
                             device=prior_disp.device)
        counts.scatter_add_(-1, t4[..., c].long(), v4)
        meds.append(torch.where(has, _hist_median(counts),
                                _hist_median(counts.sum((0, 1)))))
    off = torch.round(torch.stack(meds, -1)).to(torch.int32) - buffer
    return torch.stack([off[..., 0].clamp(0, max_x),
                        off[..., 1].clamp(0, max_y)], -1).contiguous()


# ---------------------------------------------------------------------------
# block matching (ref Correlation.cc:33-137, CostFunctions.h)
# ---------------------------------------------------------------------------


def box_sum_valid(img, kw: int, kh: int):
    """'valid' box sums over the last two axes: column sums over ``kh``
    rows in order, then row sums of those over ``kw`` columns."""
    oh, ow = img.shape[-2] - kh + 1, img.shape[-1] - kw + 1
    col = img[..., 0:oh, :]
    for i in range(1, kh):
        col = col + img[..., i:i + oh, :]
    out = col[..., :, 0:ow]
    for j in range(1, kw):
        out = out + col[..., :, j:j + ow]
    return out


def box_sum_same(img, kw: int, kh: int):
    padded = pad_replicate(img, (kw // 2, kw - 1 - kw // 2),
                           (kh // 2, kh - 1 - kh // 2))
    return box_sum_valid(padded, kw, kh)


def sqrt_rn(x):
    """Correctly rounded square root: a float64 root rounded once."""
    return torch.sqrt(x.double()).to(x.dtype)


def _search(left, right, sx: int, sy: int, kw: int, kh: int, cost: str):
    """Best candidate of the window [0, sx) x [0, sy) for every pixel of
    ``left`` (..., h, w) against ``right`` (..., h + sy - 1, w + sx - 1):
    first best wins in dy-major order; a pixel whose best equals its worst
    is invalid (ref Correlation.cc:95-133)."""
    h, w = left.shape[-2], left.shape[-1]
    oh, ow = h - kh + 1, w - kw + 1
    lead = left.shape[:-2]
    dt, dev = left.dtype, left.device
    is_max = cost == "ncc"
    if is_max:   # IEEE quotients (a tensor over a tensor)
        le = box_sum_valid(left * left, kw, kh)
        re = box_sum_valid(right * right, kw, kh)
        lprec, rprec = torch.ones_like(le) / le, torch.ones_like(re) / re
    inf = torch.full(lead + (oh, ow), float("inf"), dtype=dt, device=dev)
    best = -inf if is_max else inf
    worst = inf if is_max else -inf
    arg = torch.zeros(lead + (oh, ow), dtype=torch.int32, device=dev)
    for ey in range(sy):
        for ex in range(sx):
            r = right[..., ey:ey + h, ex:ex + w]
            if cost == "ncc":
                c = left * r
            elif cost == "abs":
                c = (left - r).abs()
            elif cost == "sq":
                c = (left - r) * (left - r)
            else:
                raise ValueError(f"reference: block matching on {cost!r}")
            s = box_sum_valid(c, kw, kh)
            if is_max:
                s = s * sqrt_rn(lprec * rprec[..., ey:ey + oh, ex:ex + ow])
                better = (s > best) | (s.isnan() & ~best.isnan())
                worst = torch.where(s.isnan() | (s < worst), s, worst)
            else:
                better = s < best
                worst = torch.maximum(worst, s)
            best = torch.where(better, s, best)
            arg = torch.where(better, torch.full_like(arg, ey * sx + ex), arg)
    valid = best != worst
    disp = torch.where(valid[..., None], torch.stack([arg % sx, arg // sx], -1),
                       torch.zeros_like(arg)[..., None])
    return disp, valid


def tiled_sweep(base, match, offsets, tile: int, sx: int, sy: int, kw: int,
                kh: int, cost: str):
    """Every tile (ty, tx) of ``base`` searched at its window of ``match``
    at ``tile * (ty, tx) + offset`` (start clamped into ``match``).
    Returns (disp (nty*tile, ntx*tile, 2) int32, valid)."""
    nty, ntx = int(offsets.shape[0]), int(offsets.shape[1])
    lh, lw = tile + kh - 1, tile + kw - 1
    rh, rw = lh + sy - 1, lw + sx - 1
    dev = base.device
    ty0 = torch.arange(nty, device=dev) * tile
    tx0 = torch.arange(ntx, device=dev) * tile
    rows = (ty0[:, None] + torch.arange(lh, device=dev))[:, None, :, None]
    cols = (tx0[:, None] + torch.arange(lw, device=dev))[None, :, None, :]
    left = base[rows, cols]
    off = offsets.long()
    y0 = (ty0[:, None] + off[..., 1]).clamp(0, match.shape[0] - rh)
    x0 = (tx0[None, :] + off[..., 0]).clamp(0, match.shape[1] - rw)
    right = match[y0[..., None, None] + torch.arange(rh, device=dev)[:, None],
                  x0[..., None, None] + torch.arange(rw, device=dev)[None, :]]
    disp, valid = _search(left, right, sx, sy, kw, kh, cost)
    disp = disp + offsets.to(torch.int32)[:, :, None, None, :]

    def untile(a):
        a = a.transpose(1, 2)
        return a.reshape((nty * tile, ntx * tile) + tuple(a.shape[4:]))

    return untile(disp), untile(valid)


# ---------------------------------------------------------------------------
# disparity-map filters (ref DisparityMap.h, Correlate.cc:1441-1502)
# ---------------------------------------------------------------------------


def _grid(h: int, w: int, dev):
    return (torch.arange(h, dtype=torch.int32, device=dev)[:, None],
            torch.arange(w, dtype=torch.int32, device=dev)[None, :])


def consistency(l_disp, l_valid, r_disp, r_valid, threshold: float):
    """A pixel survives iff the R->L disparity at its target negates its
    own within ``threshold`` in both channels."""
    h, w = l_valid.shape
    rh, rw = r_valid.shape
    ys, xs = _grid(h, w, l_valid.device)
    tx = xs + l_disp[..., 0].to(torch.int32)
    ty = ys + l_disp[..., 1].to(torch.int32)
    inside = (tx >= 0) & (tx < rw) & (ty >= 0) & (ty < rh)
    tyc, txc = ty.clamp(0, rh - 1).long(), tx.clamp(0, rw - 1).long()
    rd = r_disp[tyc, txc].to(torch.float32)
    ld = l_disp.to(torch.float32)
    diff = torch.maximum((ld[..., 0] + rd[..., 0]).abs(), (ld[..., 1] + rd[..., 1]).abs())
    valid = l_valid & inside & r_valid[tyc, txc] & (diff <= np.float32(threshold))
    return torch.where(valid[..., None], l_disp, torch.zeros_like(l_disp)), valid


def _min_match(total: int, rejection: float) -> int:
    rej = np.float32(rejection)
    for m in range(total + 1):
        if np.float32(m) / np.float32(total) >= rej:
            return m
    return total + 1


def speckle(disp, valid, half_h: int, half_v: int, pixel_threshold: float,
            rejection: float):
    """Neighbourhood agreement on integer disparities (ref
    ``rm_outliers_using_thresh``): a valid pixel survives iff enough of its
    window's neighbours (edges replicated) are valid and within the
    threshold in both channels. Invalid pixels and |d| >= 8191 never
    agree with a valid in-band one."""
    h, w = valid.shape
    dev = valid.device
    dxi = torch.round(disp[..., 0].to(torch.float32)).to(torch.int32)
    dyi = torch.round(disp[..., 1].to(torch.float32)).to(torch.int32)
    in_band = valid & (dxi.abs() < 8191) & (dyi.abs() < 8191)
    code = torch.where(in_band, ((dxi + 8192) << 14) | (dyi + 8192),
                       torch.zeros_like(dxi))
    t = int(np.floor(pixel_threshold))
    rows = torch.arange(-half_v, h + half_v, device=dev).clamp_(0, h - 1)
    cols = torch.arange(-half_h, w + half_h, device=dev).clamp_(0, w - 1)
    pc = code.index_select(0, rows).index_select(1, cols)
    cdx, cdy = code >> 14, code & 0x3FFF
    count = torch.zeros((h, w), dtype=torch.int32, device=dev)
    for i in range(2 * half_v + 1):
        for j in range(2 * half_h + 1):
            nc = pc[i:i + h, j:j + w]
            count += (((cdx - (nc >> 14)).abs() <= t)
                      & ((cdy - (nc & 0x3FFF)).abs() <= t)).to(torch.int32)
    total = (2 * half_v + 1) * (2 * half_h + 1)
    keep = valid & (count >= _min_match(total, rejection))
    return torch.where(keep[..., None], disp, torch.zeros_like(disp)), keep


def mask_test(disp, valid, left_mask, right_mask):
    """ref ``disparity_mask``: a pixel needs its left mask and an in-bounds,
    unmasked right target."""
    h, w = valid.shape
    rh, rw = right_mask.shape
    ys, xs = _grid(h, w, valid.device)
    tx = xs + disp[..., 0].to(torch.int32)
    ty = ys + disp[..., 1].to(torch.int32)
    inside = (tx >= 0) & (tx < rw) & (ty >= 0) & (ty < rh)
    ok = right_mask[ty.clamp(0, rh - 1).long(), tx.clamp(0, rw - 1).long()]
    v = valid & left_mask & ok & inside
    return torch.where(v[..., None], disp, torch.zeros_like(disp)), v


# ---------------------------------------------------------------------------
# parabola subpixel (ref ParabolaSubpixelView.cc:40-344)
# ---------------------------------------------------------------------------

_PINV = np.array([
    [1/6, -1/3, 1/6, 1/6, -1/3, 1/6, 1/6, -1/3, 1/6],    # a
    [1/6, 1/6, 1/6, -1/3, -1/3, -1/3, 1/6, 1/6, 1/6],    # b
    [1/4, 0.0, -1/4, 0.0, 0.0, 0.0, -1/4, 0.0, 1/4],     # c
    [-1/6, 0.0, 1/6, -1/6, 0.0, 1/6, -1/6, 0.0, 1/6],    # d
    [-1/6, -1/6, -1/6, 0.0, 0.0, 0.0, 1/6, 1/6, 1/6],    # e
    [-1/9, 2/9, -1/9, 2/9, 5/9, 2/9, -1/9, 2/9, -1/9],   # f
], dtype=np.float32)


def fit_parabola(planes, int_disp, valid):
    """9-point quadratic fit to the costs around each integer winner (nine
    planes, dx fastest); the stationary point's offset is kept where its
    norm is under 5 and the nine costs are not all equal."""
    coeffs = []
    for i in range(5):
        acc = None
        for j in range(9):
            wt = float(_PINV[i, j])
            if wt == 0.0:
                continue
            term = wt * planes[j]
            acc = term if acc is None else acc + term
        coeffs.append(acc)
    a, b, c, d, e = coeffs
    all_equal = planes[1] == planes[0]
    for j in range(2, 9):
        all_equal = all_equal & (planes[j] == planes[0])
    denom = 4 * a * b - c * c
    off_x = (c * e - 2 * b * d) / denom
    off_y = (c * d - 2 * a * e) / denom
    norm = torch.sqrt(off_x * off_x + off_y * off_y)
    use = (~all_equal) & (norm < 5.0)
    zero = torch.zeros((), dtype=off_x.dtype, device=off_x.device)
    fx = int_disp[..., 0].to(off_x.dtype) + torch.where(use, off_x, zero)
    fy = int_disp[..., 1].to(off_x.dtype) + torch.where(use, off_y, zero)
    return torch.where(valid[..., None], torch.stack([fx, fy], -1), zero)


def parabola_reevaluate(int_disp, valid, left_f, right_f, kw: int, kh: int):
    """The nine absolute-difference window costs around each integer
    disparity, with the disparity taken as constant over the window: the
    right image warped once by the integer field, then same-size box sums
    of |L - shift(G, delta)| (edges replicated)."""
    h, w = left_f.shape
    rh, rw = right_f.shape
    dev = left_f.device
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    yy = (ys + int_disp[..., 1].long()).clamp(0, rh - 1)
    xx = (xs + int_disp[..., 0].long()).clamp(0, rw - 1)
    g = right_f.reshape(-1)[yy * rw + xx]
    gpad = pad_replicate(g, (1, 1), (1, 1))
    planes = [box_sum_same((left_f - gpad[dy + 1:dy + 1 + h, dx + 1:dx + 1 + w]).abs(),
                           kw, kh)
              for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    return fit_parabola(planes, int_disp, valid)


# ---------------------------------------------------------------------------
# SGM / MGM (ref SGM.h, SGM.cc, SGMAssist.h)
# ---------------------------------------------------------------------------

# Default penalties by (cost, census window) (ref SGM.cc:104-160).
_P1 = {("census", 3): 3, ("census", 5): 15, ("census", 7): 30, ("census", 9): 20,
       ("ternary_census", 3): 12, ("ternary_census", 5): 30,
       ("ternary_census", 7): 40, ("ternary_census", 9): 40}
_P2 = {("census", 3): 70, ("census", 5): 750, ("census", 7): 1500, ("census", 9): 1000,
       ("ternary_census", 3): 600, ("ternary_census", 5): 1500,
       ("ternary_census", 7): 2000, ("ternary_census", 9): 2000}
N_PATHS = 8
_BIG = 3e38


def census_codes(img_int, window: int, ternary: bool, threshold: int = 2):
    """Dense census codes of an integer image (ref CensusTransform.h:
    positions r from +radius down, c from +radius down, the centre
    skipped; ternary: bits 2i (>= centre - t) and 2i+1 (> centre + t)),
    packed into 32-bit words (H, W, n_words) int32."""
    if window not in (3, 5) or (window == 3 and not ternary):
        raise ValueError("reference: dense census windows are 5 (and ternary 3)")
    radius = window // 2
    positions = [(c, r) for r in range(radius, -radius - 1, -1)
                 for c in range(radius, -radius - 1, -1) if (r, c) != (0, 0)]
    bits = len(positions) * (2 if ternary else 1)
    center = img_int.to(torch.int32)
    h, w = center.shape
    padded = pad_replicate(center, (radius, radius), (radius, radius))
    low, high = center - threshold, center + threshold
    words = [torch.zeros_like(center) for _ in range((bits + 31) // 32)]
    for i, (dc, dr) in enumerate(positions):
        val = padded[radius + dr:radius + dr + h, radius + dc:radius + dc + w]
        if ternary:
            b0, b1 = 2 * i, 2 * i + 1
            words[b0 // 32] |= (val >= low).to(torch.int32) << (b0 % 32)
            words[b1 // 32] |= (val > high).to(torch.int32) << (b1 % 32)
        else:
            words[i // 32] |= (val > center).to(torch.int32) << (i % 32)
    return torch.stack(words, -1)


def hamming(a, b):
    """Set bits of ``a ^ b`` summed over the words (int32)."""
    x = (a ^ b).to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24 & 0xFF).sum(-1).to(torch.int32)


def _shift_img(img, dy: int, dx: int):
    h, w = img.shape
    return crop_replicate(img, -dx, -dy, w, h)


def _p2_adapted(pdiff, p1: float, p2: float):
    """``P2' = max(floor(P2 / max(|dI|, 1)), P1)`` (ref SGM.cc:806-850), for
    every step of a scan at once."""
    return torch.clamp(torch.floor(torch.full_like(pdiff, p2)
                                   / torch.clamp(pdiff, min=1.0)), min=p1)


def _scan(cost_t, p2m_t, g_t, shifts, p1: float, bad: float):
    """MGM lines stepped over their first axis, every line of a batch in
    one step: ``cost_t`` (N, B, sy, sx, L), ``p2m_t`` and the guard ``g_t``
    (N, B, L). A step takes the path update ``C + min(prior, min3x3(prior) +
    P1, min_prior + P2') - min_prior`` of the carry at the two lane shifts
    (out[i] = carry[i - shift], ``bad`` beyond the ends), the floor of their
    mean, the local cost where the guard is off, and ``bad`` where the cost
    is absent (>= bad). The carry sits in a buffer padded with ``bad`` on
    the lane and grid edges, so the shifts and the 3x3 neighbourhood are
    views. Returns every step's carry (N, B, sy, sx, L)."""
    n, b, sy, sx, nl = cost_t.shape
    dt, dev = cost_t.dtype, cost_t.device
    lanes = torch.full((b, sy, sx, nl + 2), bad, dtype=dt, device=dev)
    grid = torch.full((2, b, sy + 2, sx + 2, nl), bad, dtype=dt, device=dev)
    inner = grid[:, :, 1:sy + 1, 1:sx + 1, :]
    views = [lanes[..., 1 - s:1 - s + nl] for s in shifts]
    forced = cost_t >= bad
    ys = torch.empty_like(cost_t)
    for t in range(n):
        inner[0].copy_(views[0])
        inner[1].copy_(views[1])
        min_prior = inner.amin(dim=(-3, -2))
        q = torch.minimum(torch.minimum(grid[:, :, 0:sy], grid[:, :, 1:sy + 1]),
                          grid[:, :, 2:sy + 2])
        q = torch.minimum(torch.minimum(q[:, :, :, 0:sx], q[:, :, :, 1:sx + 1]),
                          q[:, :, :, 2:sx + 2])
        best = torch.minimum(torch.minimum(inner, q + p1),
                             (min_prior + p2m_t[t])[..., None, None, :])
        upd = cost_t[t] + (best - min_prior[..., None, None, :])
        out = torch.floor((upd[0] + upd[1]) * 0.5)
        out = torch.where(g_t[t][:, None, None, :], out, cost_t[t])
        out = torch.where(forced[t], bad, out)
        ys[t] = out
        lanes[..., 1:nl + 1] = out
    return ys


def mgm_bidir_scan(cost_t, pd_f, pd_r, g_f, g_r, p1, p2, bad):
    """A diagonal task pair: ``cost_t`` (N, sy, sx, L) scanned forward and
    in reverse over N with prior shifts (+1, -1); returns the sum of the
    two directions."""
    cost2 = torch.stack([cost_t, cost_t.flip(0)], 1)
    p2m = _p2_adapted(torch.stack([pd_f, pd_r.flip(0)], 1), p1, p2)
    g2 = torch.stack([g_f, g_r.flip(0)], 1)
    ys = _scan(cost2, p2m, g2, (1, -1), p1, bad)
    return ys[:, 0] + ys[:, 1].flip(0)


def mgm_fwd_scan(cost_t, pd_t, g_t, p1, p2, bad):
    """The four edge tasks as one forward scan over sheared columns:
    ``cost_t`` (N, B, sy, sx, L), prior shifts (0, +1); every step's carry."""
    return _scan(cost_t, _p2_adapted(pd_t, p1, p2), g_t, (0, 1), p1, bad)


def _shear_rows(a, pad_value=0):
    b, h, w = a.shape[:3]
    rest = tuple(a.shape[3:])
    s = w + h + 1
    p = torch.full((b, h, s) + rest, pad_value, dtype=a.dtype, device=a.device)
    p[:, :, :w] = a
    flat = p.reshape((b, h * s) + rest)
    return flat[:, :h * (s - 1)].reshape((b, h, s - 1) + rest)


def _unshear_rows(a, w: int):
    b, h, t = a.shape[:3]
    rest = tuple(a.shape[3:])
    flat = torch.zeros((b, h * t + h) + rest, dtype=a.dtype, device=a.device)
    flat[:, :h * t] = a.reshape((b, h * t) + rest)
    return flat.reshape((b, h, t + 1) + rest)[:, :, :w]


def _step_tensors(img, dir_xy, guard, h: int, w: int):
    pd = (img - _shift_img(img, dir_xy[1], dir_xy[0])).abs()
    r = torch.arange(h, dtype=torch.int32, device=img.device)[:, None].expand(h, w)
    c = torch.arange(w, dtype=torch.int32, device=img.device)[None, :].expand(h, w)
    return pd, guard(r, c, h - 1, w - 1)


def mgm_aggregate(cost, img, p1: float, p2: float, bad: float):
    """The eight MGM direction tasks summed (ref accum_mgm_multithread,
    SGM.cc:2619-2700, SGMAssist.h:911-1237): L, T, B, R as one sheared
    forward scan under axis flips; TL and BR along rows; BL and TR along
    columns."""
    h, w, sy, sx = cost.shape
    edge = [((False, False), (-1, 0), lambda r, c, lr, lc: (r > 0) & (c > 0)),
            ((False, True), (0, -1), lambda r, c, lr, lc: (r > 0) & (c < lc)),
            ((True, False), (0, 1), lambda r, c, lr, lc: (r < lr) & (c > 0)),
            ((True, True), (1, 0), lambda r, c, lr, lc: (r < lr) & (c < lc))]

    def flip(a, fl):
        dims = [d for d, f in enumerate(fl) if f]
        return a.flip(dims) if dims else a

    cbs, pdbs, gbs = [], [], []
    for fl, d, guard in edge:
        pd, g = _step_tensors(img, d, guard, h, w)
        cbs.append(flip(cost, fl))
        pdbs.append(flip(pd, fl))
        gbs.append(flip(g, fl))
    cs = _shear_rows(torch.stack(cbs, 0), 0)
    pds = _shear_rows(torch.stack(pdbs, 0), 0)
    gs = _shear_rows(torch.stack(gbs, 0), False)
    del cbs, pdbs, gbs
    ys = mgm_fwd_scan(cs.permute(2, 0, 3, 4, 1).contiguous(),
                      pds.permute(2, 0, 1).contiguous(),
                      gs.permute(2, 0, 1).contiguous(), p1, p2, bad)
    del cs
    out = _unshear_rows(ys.permute(1, 4, 0, 2, 3), w)
    del ys
    total = torch.zeros_like(cost)
    for o, (fl, _, _) in enumerate(edge):
        total = total + flip(out[o], fl)
    del out
    pd_tl, g_tl = _step_tensors(img, (-1, -1),
                                lambda r, c, lr, lc: (r > 0) & (c > 0) & (c < lc), h, w)
    pd_br, g_br = _step_tensors(img, (1, 1),
                                lambda r, c, lr, lc: (r < lr) & (c > 0) & (c < lc), h, w)
    rows = mgm_bidir_scan(cost.permute(0, 2, 3, 1).contiguous(), pd_tl, pd_br,
                          g_tl, g_br, p1, p2, bad)
    total = total + rows.permute(0, 3, 1, 2)
    del rows
    pd_bl, g_bl = _step_tensors(img, (-1, 1),
                                lambda r, c, lr, lc: (r > 0) & (r < lr) & (c > 0), h, w)
    pd_tr, g_tr = _step_tensors(img, (1, -1),
                                lambda r, c, lr, lc: (r > 0) & (r < lr) & (c < lc), h, w)
    cols = mgm_bidir_scan(cost.permute(1, 2, 3, 0).contiguous(),
                          pd_bl.T.contiguous(), pd_tr.T.contiguous(),
                          g_bl.T.contiguous(), g_tr.T.contiguous(), p1, p2, bad)
    return total + cols.permute(3, 0, 1, 2)


def _sh3(x, d: int, axis: int):
    z = torch.zeros_like(x.narrow(axis, 0, 1))
    n = x.shape[axis]
    if d > 0:
        return torch.cat([z, x.narrow(axis, 0, n - d)], axis)
    return torch.cat([x.narrow(axis, -d, n + d), z], axis)


def _wta_stats(v, allowed):
    h, w = v.shape[:2]
    vm = torch.where(allowed, v, torch.full_like(v, _BIG)).reshape(h, w, -1)
    mn = vm.amin(-1)
    eq = vm == mn[..., None]
    cnt = eq.sum(-1, dtype=torch.int32)
    ids = torch.arange(vm.shape[-1], dtype=torch.int32, device=v.device)
    arg = torch.where(eq, ids, torch.full_like(ids, 2 ** 30)).amin(-1)
    return cnt, arg


def _tie_smooth(acc, allowed):
    """ref select_best_disparity (SGM.cc:1159-1284): while a pixel's
    minimum is not unique, 3-tap box means over its allowed rectangle (5
    horizontal, then 1 vertical; floor(x + 0.5)) replace its volume."""
    af = allowed.to(acc.dtype)
    cnt0, arg0 = _wta_stats(acc, allowed)
    inv = {ax: 1.0 / torch.clamp(af + _sh3(af, 1, ax) + _sh3(af, -1, ax), min=1.0)
           for ax in (2, 3)}
    v, sel, argsel, done = acc, acc, arg0, cnt0 <= 1
    for k in range(1, 7):
        ax = 3 if k <= 5 else 2
        va = v * af
        s = va + _sh3(va, 1, ax) + _sh3(va, -1, ax)
        v = torch.where(af > 0, torch.floor(s * inv[ax] + 0.5), v)
        cnt_k, arg_k = _wta_stats(v, allowed)
        upd = ~done
        sel = torch.where(upd[..., None, None], v, sel)
        argsel = torch.where(upd, arg_k, argsel)
        done = done | (cnt_k <= 1)
    return sel, argsel


def _parabola_2d(z):
    """ref ParabolaFit2d::find_peak (SGMAssist.h:97-135): the fit in
    float64, offsets through float32, erf squashing, norm clamp at 0.5,
    |denominator| < 0.01 keeps the integer disparity."""
    pinv = torch.as_tensor(_PINV, device=z.device).to(torch.float64)
    v = z.to(torch.float64) @ pinv.T
    a, b, c, d, e = v.unbind(-1)[:5]
    denom = 4.0 * a * b - c * c
    ok = denom.abs() >= 0.01
    safe = torch.where(ok, denom, torch.ones_like(denom))
    ox = ((c * e - 2.0 * b * d) / safe).to(torch.float32).to(torch.float64)
    oy = ((c * d - 2.0 * a * e) / safe).to(torch.float32).to(torch.float64)
    ox = torch.erf(ox / (0.34574 * math.sqrt(2.0))) / 2.0
    oy = torch.erf(oy / (0.38944 * math.sqrt(2.0))) / 2.0
    norm = torch.hypot(ox, oy)
    scale = torch.where(norm >= 0.5, norm / 0.5, torch.ones_like(norm))
    zero = torch.zeros_like(ox)
    return (torch.where(ok, ox / scale, zero).to(torch.float32),
            torch.where(ok, oy / scale, zero).to(torch.float32))


def argmin_subpixel(acc, subpixel: str, bad: float):
    """Winner of the aggregated volume (H, W, sy, sx) and, with
    ``parabola``, its fitted offset (the 3x3 neighbourhood collapsed onto
    the centre at the volume's edges and next to absent candidates)."""
    h, w, sy, sx = acc.shape
    bad_total = N_PATHS * bad
    allowed = acc < bad_total - 0.5
    acc, best = _tie_smooth(acc, allowed)
    dx, dy = best % sx, best // sx
    disp = torch.stack([dx, dy], -1).to(torch.float32)
    if subpixel == "none":
        return disp
    if subpixel != "parabola":
        raise ValueError(f"reference: SGM subpixel {subpixel!r}")
    flat = acc.reshape(h, w, sy * sx)
    idx = [(dy + jy).clamp(0, sy - 1) * sx + (dx + jx).clamp(0, sx - 1)
           for jy in (-1, 0, 1) for jx in (-1, 0, 1)]
    z = list(flat.gather(-1, torch.stack(idx, -1).long()).unbind(-1))
    absent = [t >= bad_total - 0.5 for t in z]
    lb, rb = (dx == 0) | absent[3], (dx == sx - 1) | absent[5]
    tb, bb = (dy == 0) | absent[1], (dy == sy - 1) | absent[7]
    for k in (0, 3, 6):
        z[k] = torch.where(lb, z[k + 1], z[k])
    for k in (2, 5, 8):
        z[k] = torch.where(rb, z[k - 1], z[k])
    for k in (0, 1, 2):
        z[k] = torch.where(tb, z[k + 3], z[k])
    for k in (6, 7, 8):
        z[k] = torch.where(bb, z[k - 3], z[k])
    ox, oy = _parabola_2d(torch.stack(z, -1))
    return disp + torch.stack([ox, oy], -1)


def _pixel_bounds(cost, base, seed_disp, seed_valid, buffer: int, range_x: int,
                  range_y: int, bad: float):
    """ref populate_disp_bound_image (SGM.cc:241-470): a trusted seed keeps
    only ``seed +- buffer`` (clamped into its window); seeds invalid or on
    the edge of a range of 10 or more are not trusted."""
    ry, rx = cost.shape[-2], cost.shape[-1]
    sdx = torch.round(seed_disp[..., 0]).to(torch.int32)
    sdy = torch.round(seed_disp[..., 1]).to(torch.int32)
    on_edge = torch.zeros_like(seed_valid)
    if range_x >= 10:
        on_edge = on_edge | (sdx <= 0) | (sdx >= range_x - 1)
    if range_y >= 10:
        on_edge = on_edge | (sdy <= 0) | (sdy >= range_y - 1)
    trusted = seed_valid & ~on_edge
    bx, by = base[..., 0], base[..., 1]
    lo_x = torch.minimum(torch.maximum(sdx - buffer, bx), bx + rx - 1)
    hi_x = torch.minimum(torch.maximum(sdx + buffer, bx), bx + rx - 1)
    lo_y = torch.minimum(torch.maximum(sdy - buffer, by), by + ry - 1)
    hi_y = torch.minimum(torch.maximum(sdy + buffer, by), by + ry - 1)
    ax = bx[..., None] + torch.arange(rx, dtype=torch.int32, device=cost.device)
    ay = by[..., None] + torch.arange(ry, dtype=torch.int32, device=cost.device)
    ok_x = (ax >= lo_x[..., None]) & (ax <= hi_x[..., None])
    ok_y = (ay >= lo_y[..., None]) & (ay <= hi_y[..., None])
    allowed = (ok_y[..., :, None] & ok_x[..., None, :]) | ~trusted[..., None, None]
    return torch.where(allowed, cost, torch.full_like(cost, bad))


def sgm_level(lbase, mbase, offsets, tile: int, rx: int, ry: int, window: int,
              ternary: bool, p1: float, p2: float, subpixel: str, seeds,
              buffer: int, ranges, lmask):
    """One pyramid level of MGM over the tiles' relative windows: a shared
    8-bit quantization of both crops, census codes, the hamming volume
    read at each tile's window, the seeds' per-pixel bounds, the masked
    left pixels made absent, the aggregation and the winner. Returns
    (disp (H, W, 2) float32 absolute in the level, valid)."""
    nty, ntx = int(offsets.shape[0]), int(offsets.shape[1])
    out_h, out_w = nty * tile, ntx * tile
    cw2 = window // 2
    bad = 255.0 + p2
    dev = lbase.device
    lo = torch.minimum(lbase.min(), mbase.min())
    hi = torch.maximum(lbase.max(), mbase.max())
    span = torch.clamp(hi - lo, min=1e-9)
    scale = torch.full_like(span, 255.0) / span
    lq = torch.clamp((lbase - lo) * scale, 0, 255).to(torch.int32)
    mq = torch.clamp((mbase - lo) * scale, 0, 255).to(torch.int32)
    lc = census_codes(lq, window, ternary)[cw2:cw2 + out_h, cw2:cw2 + out_w]
    rc = census_codes(mq, window, ternary)
    img = lq[cw2:cw2 + out_h, cw2:cw2 + out_w].to(lbase.dtype)
    wh, ww = tile + ry - 1, tile + rx - 1
    off = offsets.long()
    ty0 = torch.arange(nty, device=dev) * tile
    tx0 = torch.arange(ntx, device=dev) * tile
    y0 = (ty0[:, None] + cw2 + off[..., 1]).clamp(0, rc.shape[0] - wh)
    x0 = (tx0[None, :] + cw2 + off[..., 0]).clamp(0, rc.shape[1] - ww)
    win = rc[y0[..., None, None] + torch.arange(wh, device=dev)[:, None],
             x0[..., None, None] + torch.arange(ww, device=dev)[None, :]]
    lt = lc.reshape(nty, tile, ntx, tile, -1).transpose(1, 2)
    cost = torch.stack([
        torch.stack([hamming(lt, win[:, :, j:j + tile, i:i + tile]).to(lbase.dtype)
                     for i in range(rx)], -1)
        for j in range(ry)], -2)
    cost = cost.transpose(1, 2).reshape(out_h, out_w, ry, rx)
    base = offsets.to(torch.int32).repeat_interleave(tile, 0).repeat_interleave(tile, 1)
    if seeds is not None:
        cost = _pixel_bounds(cost, base, seeds[0], seeds[1], buffer, ranges[0],
                             ranges[1], bad)
    cost = torch.where(lmask[..., None, None], cost, torch.full_like(cost, bad))
    acc = mgm_aggregate(cost, img, p1, p2, bad)
    del cost
    rel = argmin_subpixel(acc, subpixel, bad)
    disp = rel + base.to(torch.float32)
    return torch.where(lmask[..., None], disp, torch.zeros_like(disp)), lmask.clone()


# ---------------------------------------------------------------------------
# the correlator
# ---------------------------------------------------------------------------


def correlate(left, right, search, settings: dict, dtype=torch.float32):
    """Disparity of ``left`` against ``right`` (float images on one device)
    over ``search`` = (x, y, w, h), max-exclusive, at the configuration's
    ``settings`` (the keyword arguments of the program's call). Returns
    (disp (H, W, 2) float32, absolute right-image offsets; valid (H, W))."""
    s = dict(settings)
    algo = s.pop("stereo_algorithm", "bm")
    cost = s.pop("cost_type", "abs")
    pf_mode = s.pop("prefilter_mode", "none")
    pf_width = float(s.pop("prefilter_width", 1.4))
    kw, kh = (int(v) for v in s.pop("kernel_size", (21, 21)))
    threshold = float(s.pop("consistency_threshold", -1.0))
    requested = int(s.pop("max_pyramid_levels", 5))
    half = int(s.pop("filter_half_kernel", 5))
    t = int(s.pop("tile_size", 64))
    refine = int(s.pop("refine_window", 11))
    cw = int(s.pop("census_window", 5))
    subpixel = s.pop("subpixel", "none")
    buffer = int(s.pop("sgm_search_buffer", 2))
    if s:
        raise ValueError(f"reference: settings it does not follow: {sorted(s)}")
    sgm = algo != "bm"
    if sgm:
        if algo != "mgm" or cost not in ("census", "ternary_census"):
            raise ValueError("reference: the semi-global path is MGM on census costs")
        kw = kh = cw
        p1 = float(_P1[(cost, cw)])
        p2 = float(_P2[(cost, cw)])
    elif cost not in ("abs", "sq", "ncc") or subpixel not in ("none", "parabola"):
        raise ValueError("reference: block matching takes abs, sq or ncc with "
                         "subpixel none or parabola")
    elif subpixel == "parabola" and cost != "ncc":
        raise ValueError("reference: the parabola's patch mode (abs, sq) is not "
                         "followed; block matching takes it with ncc")
    left = left.to(dtype)
    right = right.to(dtype)
    h, w = left.shape
    dev = left.device
    sx0, sy0, s_w, s_h = (int(v) for v in search)
    hkw, hkh = kw // 2, kh // 2
    levels = max_levels(w, h, (kw, kh), s_w, s_h, requested)
    up = 1 << levels
    off_x, off_y = hkw * up, hkh * up
    base_w = w + 2 * off_x
    base_h = h + 2 * off_y
    base_w += (-base_w) % up + up
    base_h += (-base_h) % up + up
    left_base = crop_replicate(left, -off_x, -off_y, base_w, base_h)
    rbw, rbh = base_w + s_w, base_h + s_h
    right_base = crop_replicate(right, -off_x + sx0, -off_y + sy0, rbw, rbh)
    rbw += (-rbw) % up
    rbh += (-rbh) % up
    right_base = crop_replicate(right_base, 0, 0, rbw, rbh)
    lmask = [torch.ones((h, w), dtype=torch.bool, device=dev)]
    rmask = [crop_zero(torch.ones(right.shape, dtype=torch.bool, device=dev),
                       sx0, sy0, w + s_w, h + s_h)]
    lp, rp = [left_base], [right_base]
    for _ in range(levels):
        lp.append(blur_downsample(lp[-1]))
        rp.append(blur_downsample(rp[-1]))
        lmask.append(mask_downsample(lmask[-1]))
        rmask.append(mask_downsample(rmask[-1]))
    lp = [prefilter(im, pf_mode, pf_width) for im in lp]
    rp = [prefilter(im, pf_mode, pf_width) for im in rp]

    disp = valid = None
    for level, s_w_l, s_h_l, sx, sy in level_plan(h, w, levels, s_w, s_h, refine,
                                                   buffer if sgm else None):
        scaling = 1 << level
        last = level == 0
        out_h, out_w = _cdiv(h, scaling), _cdiv(w, scaling)
        nty, ntx = _cdiv(out_h, t), _cdiv(out_w, t)
        if level == levels:
            offsets = torch.zeros((nty, ntx, 2), dtype=torch.int32, device=dev)
        else:
            pd, pv = upsample2(disp, valid)
            pr_d = _pad_to(pd[:out_h, :out_w], nty * t, ntx * t)
            pr_v = _pad_to(pv[:out_h, :out_w], nty * t, ntx * t)
            if sgm:
                offsets = tile_offsets_median(pr_d, pr_v, t, buffer, s_w_l - sx,
                                              s_h_l - sy, (s_w_l, s_h_l))
            else:
                offsets = tile_offsets_min(pr_d, pr_v, t, 2, s_w_l - sx, s_h_l - sy)
        ly0, lx0 = off_y // scaling - hkh, off_x // scaling - hkw
        lbh, lbw = nty * t + kh - 1, ntx * t + kw - 1
        lbase = crop_replicate(lp[level], lx0, ly0, lbw, lbh)
        mbase = crop_replicate(rp[level], lx0, ly0, lbw + s_w_l - 1, lbh + s_h_l - 1)
        if sgm:
            lm = _pad_to(lmask[level][:out_h, :out_w], nty * t, ntx * t)
            seeds = None if level == levels else (pr_d.to(torch.float32), pr_v)
            d, v = sgm_level(lbase, mbase, offsets, t, sx, sy, cw,
                             cost == "ternary_census", p1, p2,
                             subpixel if last else "none", seeds, buffer,
                             (s_w_l, s_h_l), lm)
        else:
            d, v = tiled_sweep(lbase, mbase, offsets, t, sx, sy, kw, kh, cost)
        disp, valid = d[:out_h, :out_w], v[:out_h, :out_w]
        if last and threshold >= 0:
            rl_h = min(out_h + s_h, rmask[level].shape[0])
            rl_w = min(out_w + s_w, rmask[level].shape[1])
            rnty, rntx = _cdiv(rl_h, t), _cdiv(rl_w, t)
            src = _pad_to(offsets, rnty, rntx)
            eff = torch.tensor([sx - 1, sy - 1], dtype=torch.int32, device=dev)
            rbh2, rbw2 = rnty * t + kh - 1, rntx * t + kw - 1
            rl_base = crop_replicate(rp[level], lx0, ly0, rbw2, rbh2)
            mx = sx - 1 + (s_w_l - sx)
            my = sy - 1 + (s_h_l - sy)
            rl_match = crop_replicate(lp[level], lx0 - mx, ly0 - my,
                                      rbw2 + sx - 1 + mx, rbh2 + sy - 1 + my)
            origin = torch.tensor([mx, my], dtype=torch.int32, device=dev)
            rl_off = (origin - (src + eff)).contiguous()
            if sgm:
                # the R->L pass: no seeds, no mask, the level's subpixel
                everywhere = torch.ones((rnty * t, rntx * t), dtype=torch.bool,
                                        device=dev)
                rd, rv = sgm_level(rl_base, rl_match, rl_off, t, sx, sy, cw,
                                   cost == "ternary_census", p1, p2, subpixel,
                                   None, buffer, (0, 0), everywhere)
            else:
                rd, rv = tiled_sweep(rl_base, rl_match, rl_off, t, sx, sy, kw, kh,
                                     cost)
            disp, valid = consistency(disp, valid, (rd - origin)[:rl_h, :rl_w],
                                      rv[:rl_h, :rl_w], threshold)
        if half > 0:
            disp, valid = speckle(disp, valid, half, half, 3.0, 0.5)
            if not last:
                disp, valid = speckle(disp, valid, 1, 1, 3.0, 0.20)
                disp, valid = mask_test(disp, valid, lmask[level][:out_h, :out_w],
                                        rmask[level])
            else:
                # level 0 with no user masks: the right mask is the rectangle
                # where the shifted right crop covers the right image
                rh_o, rw_o = right.shape
                ra, rb = max(0, -sy0), min(h + s_h, rh_o - sy0)
                ca, cb = max(0, -sx0), min(w + s_w, rw_o - sx0)
                ys, xs = _grid(out_h, out_w, dev)
                ty = ys + disp[..., 1].to(torch.int32)
                tx = xs + disp[..., 0].to(torch.int32)
                valid = valid & (ty >= ra) & (ty < rb) & (tx >= ca) & (tx < cb)
                disp = torch.where(valid[..., None], disp, torch.zeros_like(disp))
    smin = torch.tensor([sx0, sy0], dtype=disp.dtype, device=dev)
    final = torch.where(valid[..., None], disp + smin, torch.zeros_like(disp))
    if subpixel == "parabola" and not sgm:
        left_f = prefilter(left, pf_mode, pf_width)
        right_f = prefilter(right, pf_mode, pf_width)
        final = parabola_reevaluate(final, valid, left_f, right_f, kw, kh)
    return final.to(torch.float32), valid
