"""Parabola subpixel fit (port of ``_fit_parabola`` in
``visionworkbench_tpu/stereo/subpixel.py``; ref
``src/vw/Stereo/ParabolaSubpixelView.cc:40-344``): fit
``z = ax^2 + by^2 + cxy + dx + ey + f`` to the 3x3 cost patch of each
integer winner with the reference's 6x9 pseudoinverse
(``ParabolaSubpixelView.h:77-89``) and move to the stationary point; reject
offsets with norm >= 5 and keep the integer disparity where all nine costs
are equal. The patches come from the sweep (``ops/sweep.py``)."""

from __future__ import annotations

import numpy as np
import torch

# Pseudoinverse of A where rows of A are [x^2 y^2 xy x y 1] at the nine
# (x, y) in [-1,1]^2, x fastest (ref ParabolaSubpixelView.h:83-88).
_PINV_A = np.array([
    [1/6, -1/3, 1/6, 1/6, -1/3, 1/6, 1/6, -1/3, 1/6],    # a
    [1/6, 1/6, 1/6, -1/3, -1/3, -1/3, 1/6, 1/6, 1/6],    # b
    [1/4, 0.0, -1/4, 0.0, 0.0, 0.0, -1/4, 0.0, 1/4],     # c
    [-1/6, 0.0, 1/6, -1/6, 0.0, 1/6, -1/6, 0.0, 1/6],    # d
    [-1/6, -1/6, -1/6, 0.0, 0.0, 0.0, 1/6, 1/6, 1/6],    # e
    [-1/9, 2/9, -1/9, 2/9, 5/9, 2/9, -1/9, 2/9, -1/9],   # f
], dtype=np.float32)

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
