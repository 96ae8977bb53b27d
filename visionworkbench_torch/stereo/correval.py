"""Disparity quality evaluation (port of
``visionworkbench_tpu/stereo/correval.py``; ref
``src/vw/Stereo/CorrEval.h:37-117``): per-pixel NCC or stddev-ratio of the
left window vs the disparity-warped right window — a confidence image for a
computed disparity map.

The left window reads the edge-extended left frame, the right window a
clamped bilinear sample at ``p + tap + d(p)``; the five window sums run in
tap order, as in the JAX package."""

from __future__ import annotations

import torch

from visionworkbench_torch.core.device import as_tensor, sqrt_rn
from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.image.edge import edge_extend
from visionworkbench_torch.image.transform import _dest_grid
from visionworkbench_torch.stereo.correlation import DisparityMap
from visionworkbench_torch.stereo.subpixel_refine import _sample


def _corr_eval(disp, valid, left, right, kw: int, kh: int, metric: str):
    h, w = left.shape
    xs, ys = _dest_grid(h, w, left.device)
    k2w, k2h = kw // 2, kh // 2
    # a 0-dim tensor on the device: a true quotient on the card too (a
    # Python divisor is a multiply by its reciprocal there)
    n = torch.full((), float(kw * kh), dtype=torch.float32, device=left.device)
    sl = torch.zeros_like(left)
    sl2 = torch.zeros_like(left)
    sr = torch.zeros_like(left)
    sr2 = torch.zeros_like(left)
    slr = torch.zeros_like(left)
    dx = disp[..., 0].to(torch.float32)
    dy = disp[..., 1].to(torch.float32)
    lpad = edge_extend(left, k2w, k2h)
    for wy in range(-k2h, k2h + 1):
        for wx in range(-k2w, k2w + 1):
            lv = lpad[wy + k2h:wy + k2h + h, wx + k2w:wx + k2w + w]
            rv = _sample(right, xs + wx + dx, ys + wy + dy)
            sl = sl + lv
            sl2 = sl2 + lv * lv
            sr = sr + rv
            sr2 = sr2 + rv * rv
            slr = slr + lv * rv
    zero = torch.zeros((), dtype=torch.float32, device=left.device)
    var_l = torch.maximum(sl2 - sl * sl / n, zero)
    var_r = torch.maximum(sr2 - sr * sr / n, zero)
    if metric == "ncc":
        cov = slr - sl * sr / n
        q = cov / torch.clamp(sqrt_rn(var_l * var_r), min=1e-9)
    else:  # stddev ratio
        q = sqrt_rn(torch.minimum(var_l, var_r) /
                  torch.clamp(torch.maximum(var_l, var_r), min=1e-9))
    return torch.where(valid, q, zero)


def corr_eval(disparity: DisparityMap, left, right, kernel_size=(11, 11),
              metric: str = "ncc"):
    """Quality image in [-1, 1] (ncc) or [0, 1] (stddev)
    (ref ``corr_eval``, CorrEval.h), on the disparity map's device; invalid
    pixels give 0. ``left``/``right`` may be numpy arrays or tensors."""
    if metric not in ("ncc", "stddev"):
        raise ArgumentErr("corr_eval metric must be 'ncc' or 'stddev'")
    dev = disparity.disparity.device
    left = as_tensor(left, torch.float32, dev)
    right = as_tensor(right, torch.float32, dev)
    kw, kh = int(kernel_size[0]), int(kernel_size[1])
    return _corr_eval(disparity.disparity, disparity.valid, left, right,
                      kw, kh, metric)
