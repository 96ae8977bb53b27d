"""Parabola subpixel refinement (port of
``visionworkbench_tpu/stereo/subpixel.py``; ref
``src/vw/Stereo/ParabolaSubpixelView.cc:40-344``): fit
``z = ax^2 + by^2 + cxy + dx + ey + f`` to the 3x3 cost patch of each
integer winner with the reference's 6x9 pseudoinverse
(``ParabolaSubpixelView.h:77-89``) and move to the stationary point; reject
offsets with norm >= 5 and keep the integer disparity where all nine costs
are equal.

The patches come from the sweep (``ops/sweep.py``) for abs/sq/census, or
from :func:`parabola_subpixel`, which re-evaluates the nine absolute-
difference window costs around each integer disparity as the reference
does (the pyramid's path for NCC): by default with the disparity taken as
locally constant over the window (one gather of the right image), with
``exact=True`` at every window tap. Only the ``none`` prefilter is ported.
"""

from __future__ import annotations

import torch

from visionworkbench_torch.core.device import as_tensor
from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.image.edge import edge_extend
from visionworkbench_torch.ops.box_filter import box_sum_same
from visionworkbench_torch.ops.sgm_wta import PINV_A as _PINV_A
from visionworkbench_torch.stereo.correlation import DisparityMap
from visionworkbench_torch.stereo.prefilter import PREFILTER_NONE, prefilter_image


MAX_SUBPIXEL_SHIFT = 5.0


def _fit_parabola(patch, int_disp, valid):
    """9-point 2D parabola fit. ``patch`` is either an (H, W, 9) stack or a
    list/tuple of nine (H, W) planes; the planes form drops zero taps and
    the unused f row (value-identical up to fp32 summation order). Returns
    (H, W, 2) float32 disparities, 0 where invalid."""
    if isinstance(patch, (list, tuple)):
        planes = patch
        coeffs = []
        for i in range(5):
            acc = None
            for j in range(9):
                w_ = float(_PINV_A[i, j])
                if w_ == 0.0:
                    continue
                term = w_ * planes[j]
                acc = term if acc is None else acc + term
            coeffs.append(acc)
        a, b, c, d, e = coeffs
        all_equal = planes[1] == planes[0]
        for j in range(2, 9):
            all_equal = all_equal & (planes[j] == planes[0])
    else:
        pinv = torch.as_tensor(_PINV_A, device=patch.device)
        coeffs = torch.einsum("ij,hwj->hwi", pinv, patch)
        a, b, c, d, e = (coeffs[..., k] for k in range(5))
        all_equal = (patch == patch[..., :1]).all(-1)
    denom = 4 * a * b - c * c
    off_x = (c * e - 2 * b * d) / denom
    off_y = (c * d - 2 * a * e) / denom
    norm = torch.sqrt(off_x * off_x + off_y * off_y)
    use_offset = (~all_equal) & (norm < MAX_SUBPIXEL_SHIFT)
    zero = torch.zeros((), dtype=torch.float32, device=off_x.device)
    fx = int_disp[..., 0].to(torch.float32) + torch.where(use_offset, off_x, zero)
    fy = int_disp[..., 1].to(torch.float32) + torch.where(use_offset, off_y, zero)
    out = torch.stack([fx, fy], -1)
    return torch.where(valid[..., None], out, zero)


def _warp_index(int_disp, vy: int, vx: int, rh: int, rw: int):
    """Flat index of ``right[p + v + d(p)]`` for every pixel p, clipped to
    the right image's bounds (it may be larger than left)."""
    h, w = int_disp.shape[0], int_disp.shape[1]
    dev = int_disp.device
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    yy = (ys + vy + int_disp[..., 1].long()).clamp(0, rh - 1)
    xx = (xs + vx + int_disp[..., 0].long()).clamp(0, rw - 1)
    return yy * rw + xx


def _parabola_refine_fast(int_disp, valid, left_f, right_f, kw: int, kh: int):
    """Warp the right image once by the integer disparity field
    (G(p) = R(p + d_p)), then evaluate the nine neighbour costs as
    same-size box sums of |L - shift(G, delta)| (replicated edges). Exact
    wherever the disparity is flat across the window."""
    h, w = left_f.shape
    rh, rw = right_f.shape
    g = right_f.reshape(-1)[_warp_index(int_disp, 0, 0, rh, rw)]
    gpad = edge_extend(g, 1, 1)
    planes = [box_sum_same((left_f - gpad[dy + 1:dy + 1 + h, dx + 1:dx + 1 + w]).abs(),
                           kw, kh, edge="constant")
              for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    return _fit_parabola(planes, int_disp, valid)


def _parabola_refine(int_disp, valid, left_f, right_f, kw: int, kh: int):
    """The reference's evaluation: every window tap at the window centre's
    disparity, accumulated over the (k+2)^2 super-window in the JAX
    package's order."""
    h, w = left_f.shape
    k2w, k2h = kw // 2, kh // 2
    rh, rw = right_f.shape
    rflat = right_f.reshape(-1)
    lpad = edge_extend(left_f, k2w, k2h)
    costs = [torch.zeros_like(left_f) for _ in range(9)]
    for vy in range(-k2h - 1, k2h + 2):
        for vx in range(-k2w - 1, k2w + 2):
            s_v = rflat[_warp_index(int_disp, vy, vx, rh, rw)]
            for dy in (-1, 0, 1):
                wy = vy - dy
                if abs(wy) > k2h:
                    continue
                for dx in (-1, 0, 1):
                    wx = vx - dx
                    if abs(wx) > k2w:
                        continue
                    shifted = lpad[wy + k2h:wy + k2h + h, wx + k2w:wx + k2w + w]
                    idx = (dy + 1) * 3 + (dx + 1)
                    costs[idx] = costs[idx] + (shifted - s_v).abs()
    return _fit_parabola(costs, int_disp, valid)


def parabola_subpixel(disparity: DisparityMap, left, right, kernel_size,
                      prefilter_mode: str = PREFILTER_NONE,
                      prefilter_width: float = 1.4,
                      exact: bool = False) -> DisparityMap:
    """Refine an integer disparity map to float (ref ``parabola_subpixel``,
    ParabolaSubpixelView.cc:330-344). ``disparity`` must be pixel-aligned
    with ``left`` (same H, W); dx/dy are absolute right-image offsets.
    ``left``/``right`` may be numpy arrays or tensors; the work runs on the
    disparity map's device.

    ``exact=True`` evaluates every window tap at the window-centre
    disparity like the reference (O(k^2) gathers); the default uses the
    locally-constant-disparity formulation (one gather), identical away
    from disparity discontinuities."""
    dev = disparity.disparity.device
    left = as_tensor(left, torch.float32, dev)
    right = as_tensor(right, torch.float32, dev)
    if tuple(disparity.disparity.shape[:2]) != tuple(left.shape[:2]):
        raise ArgumentErr("parabola_subpixel: disparity must match left image size")
    kw, kh = int(kernel_size[0]), int(kernel_size[1])
    left_f = prefilter_image(left, prefilter_mode, prefilter_width)
    right_f = prefilter_image(right, prefilter_mode, prefilter_width)
    refine = _parabola_refine if exact else _parabola_refine_fast
    out = refine(disparity.disparity, disparity.valid, left_f, right_f, kw, kh)
    return DisparityMap(out, disparity.valid)
