"""Disparity-map utilities on the correlator's path (port of
``visionworkbench_tpu/stereo/disparity.py``; ref
``src/vw/Stereo/DisparityMap.h`` and the L-R check of
``src/vw/Stereo/Correlate.cc:1441-1502``).

The speckle filter runs on integer disparities through the packed code
plane and ``ops/speckle.py``, which launches the CUDA stencil for tensors on
the card (any frame shape) and runs its plain version on the CPU. Its float
form (``integer_disparities=False``) is plain tensor work, as in the JAX
package, where only the integer form reaches the speckle kernel.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from visionworkbench_torch.core.device import sqrt_rn
from visionworkbench_torch.image.edge import edge_extend
from visionworkbench_torch.math.bbox import BBox2i
from visionworkbench_torch.ops.box_filter import box_sum_same
from visionworkbench_torch.ops.speckle import speckle_keep_mask
from visionworkbench_torch.stereo.correlation import DisparityMap


def _pixel_grid(h: int, w: int, device):
    ys = torch.arange(h, dtype=torch.int32, device=device)[:, None]
    xs = torch.arange(w, dtype=torch.int32, device=device)[None, :]
    return ys, xs


def get_disparity_range(dm: DisparityMap) -> BBox2i:
    """Min/max disparity over valid pixels (ref ``get_disparity_range``,
    DisparityMap.h:52-66; invalid pixels are skipped, as the JAX package
    does). Host-side. Returns a max-exclusive integer box containing the
    (dx, dy) range."""
    disp, valid = dm.to_numpy()
    if not valid.any():
        return BBox2i(0, 0, 0, 0)
    vals = disp[valid]
    mn = np.floor(vals.min(axis=0)).astype(int)
    mx = np.ceil(vals.max(axis=0)).astype(int)
    return BBox2i.from_bounds(int(mn[0]), int(mn[1]), int(mx[0]) + 1, int(mx[1]) + 1)


def disparity_mask(dm: DisparityMap, left_mask, right_mask,
                   disparity_bounds: Optional[BBox2i] = None) -> DisparityMap:
    """Invalidate disparities whose left pixel is masked or whose right-image
    target pixel is masked or out of bounds (ref ``disparity_mask``,
    DisparityMap.h:248). ``disparity_bounds`` is accepted for the JAX
    signature; the port always reads the right mask with one gather."""
    h, w = dm.valid.shape
    rh, rw = right_mask.shape
    ys, xs = _pixel_grid(h, w, dm.valid.device)
    tx = xs + dm.disparity[..., 0].to(torch.int32)
    ty = ys + dm.disparity[..., 1].to(torch.int32)
    in_bounds = (tx >= 0) & (tx < rw) & (ty >= 0) & (ty < rh)
    right_ok = right_mask[ty.clamp(0, rh - 1).long(), tx.clamp(0, rw - 1).long()]
    valid = dm.valid & left_mask & right_ok & in_bounds
    return DisparityMap(torch.where(valid[..., None], dm.disparity,
                                    torch.zeros_like(dm.disparity)), valid)


def _pack_code(disp, valid):
    """(dx, dy, valid) -> one int32 code plane: dx field << 14, dy low 14
    bits (both offset by 8192), invalid or out-of-band (|d| >= 8191) pixels
    code 0, whose dx-field difference vs any in-band value exceeds any
    threshold <= 26 — so they can never falsely agree."""
    dxi = torch.round(disp[..., 0]).to(torch.int32)
    dyi = torch.round(disp[..., 1]).to(torch.int32)
    in_band = valid & (dxi.abs() < 8191) & (dyi.abs() < 8191)
    code = ((dxi + 8192) << 14) | (dyi + 8192)
    return torch.where(in_band, code, torch.zeros_like(code))


def _min_match(total: int, rejection_threshold: float) -> int:
    """Smallest integer m with float32(m)/float32(total) >= rej — the exact
    integer form of the float-path keep test."""
    rej = np.float32(rejection_threshold)
    for m in range(total + 1):
        if np.float32(m) / np.float32(total) >= rej:
            return m
    return total + 1


def _rm_outliers(disp, valid, half_h: int, half_v: int,
                 pixel_threshold: float, rejection_threshold: float):
    """Float-disparity speckle filter (the JAX package's ``_rm_outliers``):
    per window offset of the replicate-extended planes, a neighbour agrees
    when it is valid and within ``pixel_threshold`` in both channels; the
    keep test ``matched / total >= rejection_threshold`` in its exact
    integer form (:func:`_min_match`)."""
    h, w = valid.shape
    dx = disp[..., 0].to(torch.float32)
    dy = disp[..., 1].to(torch.float32)
    thr = float(np.float32(pixel_threshold))
    pdx, pdy, pva = (edge_extend(p, half_h, half_v) for p in (dx, dy, valid))
    matched = torch.zeros((h, w), dtype=torch.int32, device=valid.device)
    for i in range(2 * half_v + 1):
        for j in range(2 * half_h + 1):
            ok = (pva[i:i + h, j:j + w]
                  & ((dx - pdx[i:i + h, j:j + w]).abs() <= thr)
                  & ((dy - pdy[i:i + h, j:j + w]).abs() <= thr))
            matched += ok
    total = (2 * half_v + 1) * (2 * half_h + 1)
    new_valid = valid & (matched >= _min_match(total, rejection_threshold))
    return (torch.where(new_valid[..., None], disp, torch.zeros_like(disp)),
            new_valid)


def _rm_outliers_int(disp, valid, half_h: int, half_v: int,
                     pixel_threshold: float, rejection_threshold: float):
    """Integer-disparity speckle filter (bit-identical to the JAX package's
    ``_rm_outliers_int`` on integer-valued disparities with |d| < 8191):
    the window count runs in ``ops.speckle.speckle_keep_mask``."""
    t = int(np.floor(pixel_threshold))
    total = (2 * half_v + 1) * (2 * half_h + 1)
    keep = speckle_keep_mask(_pack_code(disp, valid), half_h, half_v, t,
                             _min_match(total, rejection_threshold)) != 0
    new_valid = valid & keep
    return (torch.where(new_valid[..., None], disp, torch.zeros_like(disp)),
            new_valid)


def rm_outliers_using_thresh(dm: DisparityMap, half_h_kernel: int,
                             half_v_kernel: int, pixel_threshold: float,
                             rejection_threshold: float,
                             integer_disparities: bool = False) -> DisparityMap:
    """Neighborhood-agreement speckle filter (ref ``rm_outliers_using_thresh``,
    DisparityMap.h:405-433): a valid pixel survives iff the fraction of window
    neighbors that are valid and within ``pixel_threshold`` in both disparity
    channels is at least ``rejection_threshold``.

    ``integer_disparities``: a promise that every disparity is
    integer-valued (true for every pre-subpixel pyramid level); it selects
    the packed-code form on the speckle kernel (the same result)."""
    fn = _rm_outliers_int if integer_disparities else _rm_outliers
    disp, valid = fn(dm.disparity, dm.valid, int(half_h_kernel), int(half_v_kernel),
                     float(pixel_threshold), float(rejection_threshold))
    return DisparityMap(disp, valid)


def disparity_cleanup_using_thresh(dm: DisparityMap, half_h_kernel: int,
                                   half_v_kernel: int, pixel_threshold: float,
                                   rejection_threshold: float,
                                   integer_disparities: bool = False) -> DisparityMap:
    """Two-pass cleanup; second pass hard-coded to (1, 1, 3.0, 0.20)
    (ref ``disparity_cleanup_using_thresh``, DisparityMap.h:426-447)."""
    out = rm_outliers_using_thresh(dm, half_h_kernel, half_v_kernel,
                                   pixel_threshold, rejection_threshold,
                                   integer_disparities)
    return rm_outliers_using_thresh(out, 1, 1, 3.0, 0.20, integer_disparities)


def cross_corr_consistency_check(l2r: DisparityMap, r2l: DisparityMap,
                                 cross_corr_threshold: float = 2.0,
                                 return_diff: bool = False):
    """L-to-R vs R-to-L agreement test (ref ``cross_corr_consistency_check``,
    Correlate.cc:1441-1502): pixel survives iff the R-L disparity at its match
    target negates its own disparity to within the threshold."""
    h, w = l2r.valid.shape
    rh, rw = r2l.valid.shape
    ys, xs = _pixel_grid(h, w, l2r.valid.device)
    tx = xs + l2r.disparity[..., 0].to(torch.int32)
    ty = ys + l2r.disparity[..., 1].to(torch.int32)
    in_bounds = (tx >= 0) & (tx < rw) & (ty >= 0) & (ty < rh)
    tyc, txc = ty.clamp(0, rh - 1).long(), tx.clamp(0, rw - 1).long()
    rvalid = r2l.valid[tyc, txc]
    rd = r2l.disparity[tyc, txc].to(torch.float32)
    ld = l2r.disparity.to(torch.float32)
    diff = torch.maximum((ld[..., 0] + rd[..., 0]).abs(),
                         (ld[..., 1] + rd[..., 1]).abs())
    valid = (l2r.valid & in_bounds & rvalid
             & (diff <= np.float32(cross_corr_threshold)))
    out = DisparityMap(torch.where(valid[..., None], l2r.disparity,
                                   torch.zeros_like(l2r.disparity)), valid)
    if return_diff:
        return out, diff
    return out


def disparity_upsample(dm: DisparityMap) -> DisparityMap:
    """2x nearest upsample with disparities doubled
    (ref ``DisparityUpsampleView``, DisparityMap.h:1326-1360)."""
    disp = (dm.disparity * 2).repeat_interleave(2, 0).repeat_interleave(2, 1)
    valid = dm.valid.repeat_interleave(2, 0).repeat_interleave(2, 1)
    return DisparityMap(disp, valid)


def disparity_subsample(dm: DisparityMap) -> DisparityMap:
    """Half-resolution disparity with validity-weighted averaging and /2
    disparity rescale (ref ``DisparitySubsampleView``,
    DisparityMap.h:1253-1320): weights center 10, 4-neighbours 5, diagonals
    2, result = weighted sum / (2 * weight sum), in the JAX package's
    order."""
    h, w = dm.valid.shape
    oh, ow = 1 + (h - 1) // 2, 1 + (w - 1) // 2
    dev = dm.valid.device
    pd = edge_extend(dm.disparity.to(torch.float32), (1, 2), (1, 2))
    pv = edge_extend(dm.valid, (1, 2), (1, 2))
    ci = 2 * torch.arange(ow, device=dev)[None, :] + 1
    cj = 2 * torch.arange(oh, device=dev)[:, None] + 1
    acc = torch.zeros((oh, ow, 2), dtype=torch.float32, device=dev)
    cnt = torch.zeros((oh, ow), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for di, dj, wgt in ((0, 0, 10.0), (1, 0, 5.0), (0, 1, 5.0), (-1, 0, 5.0),
                        (0, -1, 5.0), (1, 1, 2.0), (-1, -1, 2.0), (-1, 1, 2.0),
                        (1, -1, 2.0)):
        yy, xx = cj + dj, ci + di
        v = pv[yy, xx]
        acc = acc + torch.where(v[..., None], wgt * pd[yy, xx], zero)
        cnt = cnt + torch.where(v, wgt, zero)
    out_valid = cnt > 0
    out = acc / (torch.clamp(cnt, min=1.0)[..., None] * 2.0)
    return DisparityMap(torch.where(out_valid[..., None], out, zero), out_valid)


def std_dev_image(image: torch.Tensor, kernel_w: int, kernel_h: int) -> torch.Tensor:
    """Windowed standard deviation (ref the StdDev functor of
    DisparityMap.h): sqrt(E[x^2] - E[x]^2) over the kernel window, edges
    replicated. The window sums are ``ops/box_filter.box_sum_same``'s direct
    sums (the JAX package takes prefix sums on large frames)."""
    image = image.to(torch.float32)
    n = torch.full((), float(kernel_w * kernel_h), dtype=torch.float32,
                   device=image.device)
    s1 = box_sum_same(image, kernel_w, kernel_h, edge="constant") / n
    s2 = box_sum_same(image * image, kernel_w, kernel_h, edge="constant") / n
    return sqrt_rn(torch.clamp(s2 - s1 * s1, min=0.0))


def transform_disparities(dm: DisparityMap, transform_fn) -> DisparityMap:
    """Apply a 2D point transform to the *target* coordinates of each
    disparity (ref ``transform_disparities``, DisparityMap.h:1048): new
    disparity = T(p + d) - p. ``transform_fn(x, y)`` takes and returns
    float32 tensors."""
    h, w = dm.valid.shape
    dev = dm.valid.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    nx, ny = transform_fn(xs + dm.disparity[..., 0].to(torch.float32),
                          ys + dm.disparity[..., 1].to(torch.float32))
    out = torch.stack([nx - xs, ny - ys], -1)
    return DisparityMap(torch.where(dm.valid[..., None], out, torch.zeros_like(out)),
                        dm.valid)
