"""Plain PyTorch reference of the Bayes-EM affine subpixel refiner, frozen
for the benchmark.

A copy of what ``visionworkbench_torch.stereo.subpixel_refine.
bayes_em_subpixel`` runs at ``max_pyramid_levels=0``, the setting of the
program's ``subpixel="em"`` / ``"affine"``: one full-resolution refinement
of the correlator's integer map (ref ``subpixel_optimized_affine_2d_EM``,
``Correlate.cc:500-845``), written as plain tensor operations with no
kernel and no import of the program. Per pixel: an identity-initialised
6-parameter affine window [d0 d1 d2; d3 d4 d5]; Gaussian window weights
zeroed at invalid neighbours and renormalised (a pixel with fewer than
half its window valid ends invalid); the EM mixture of a plane model
N(0, 1e-3) and a noise model N(mean_noise, 1e-2), priors 0.8 / 0.2, each
exponent under -75 taken as 0; the 6x6 normal equations by Cholesky; the
|translation| > kernel width / 2 abort; the rising-|sum I_e| stop (EM) or
the small-update stop (``em_iters=0``, the plain weighted affine fit of
``Correlate.cc:848-1080``); the final NaN and translation invalidation.

Departures from ``Correlate.cc:500-845``, the program's own:

1. Every pixel refines at once: each window row's taps lie on a leading
   axis of length ``kw``, and the sums run over that axis in the working
   precision, not serially per pixel in double.
2. The right frame is warped once by each pixel's integer disparity; each
   tap's sample at the affine offset is a 3x3 hat-weighted stencil over the
   warped frame, offsets clipped to [-1, 1 - 1e-6], where VW resamples the
   right image bilinearly at every tap and iteration. Beyond the frame,
   samples are edge-replicated.
3. A pixel's early stop freezes it; the frame still runs every outer
   iteration (``outer_iters``, 3 on the program's path, in place of VW's
   refiner pyramid and its iteration cap).
4. A zero mixture denominator (both probabilities underflowed) computes
   with a responsibility of 0 and marks the pixel, which ends invalid
   (VW's NaN path).
5. The frames are the correlator's prefiltered ones (LoG), as the
   program's call passes its prefilter on.

``dtype`` is the working precision of every floating-point value the
program holds in float32; ``torch.float32`` is the reference, a lower one
(``bfloat16``) the benchmark's control. TF32 is off while it runs.
"""

from __future__ import annotations

import contextlib
import math
from typing import Tuple

import numpy as np
import torch

from portbench.reference.pyramid import (
    _convolve, crop_replicate, crop_zero, prefilter, sqrt_rn,
)

# The program's fixed choices on its normal path (``pyramid_correlate``'s
# ``subpixel="em"``): 3 outer iterations of 2 EM passes; ``"affine"``: 0.
OUTER_ITERS = 3
EM_ITERS = {"em": 2, "affine": 0}


@contextlib.contextmanager
def _no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def weight_template(kw: int, kh: int) -> np.ndarray:
    """Gaussian window weights, exp(-(di^2 + dj^2) / two_sigma_sqr) over
    their sum, two_sigma_sqr = 2 (kw / 5)^2 (ref
    ``compute_spatial_weight_image``, Correlate.cc:36-55, 519), in float32."""
    two_sigma_sqr = 2.0 * (float(kw) / 5.0) ** 2
    ii = np.arange(kw) - kw // 2
    jj = np.arange(kh) - kh // 2
    w = np.exp(-(ii[None, :] ** 2 + jj[:, None] ** 2) / two_sigma_sqr)
    return (w / w.sum()).astype("float32")


def _full(c: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), c, dtype=like.dtype, device=like.device)


def _solve6(A, b):
    """Unrolled 6x6 Cholesky solve over (H, W) maps: ``A`` the upper
    entries {(i, j): map}, i <= j; ``b`` six maps. A pixel whose matrix is
    not positive definite gets NaNs, which the final check invalidates."""
    L = {}
    for j in range(6):
        s = A[(j, j)]
        for k in range(j):
            s = s - L[(j, k)] * L[(j, k)]
        L[(j, j)] = sqrt_rn(s)
        inv = torch.ones_like(L[(j, j)]) / L[(j, j)]
        for i in range(j + 1, 6):
            s = A[(j, i)]
            for k in range(j):
                s = s - L[(i, k)] * L[(j, k)]
            L[(i, j)] = s * inv
    y = []
    for i in range(6):
        s = b[i]
        for k in range(i):
            s = s - L[(i, k)] * y[k]
        y.append(s / L[(i, i)])
    x = [None] * 6
    for i in range(5, -1, -1):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - L[(k, i)] * x[k]
        x[i] = s / L[(i, i)]
    return x


def _rows(padded, j0: int, h: int, w: int, n: int):
    """``[i] = padded[j0:j0+h, i:i+w]`` for i < n, on a leading axis."""
    return padded[j0:j0 + h].unfold(1, w, 1)[:, :n].permute(1, 0, 2).contiguous()


def _refine(disp, valid, left, right, kw: int, kh: int, em_iters: int, outer_iters: int):
    h, w = left.shape
    dev, dt = left.device, left.dtype
    k2w, k2h = kw // 2, kh // 2
    kern_pixels = kw * kh
    max_trans = float(kw) / 2.0
    m, mh = k2w + 2, k2h + 2         # stencil margin: tap, cell shift, bilinear

    dk = np.array([[0.5, 0.0, -0.5]], np.float64)
    x_deriv = _convolve(left, dk)
    y_deriv = _convolve(left, dk.T)
    lpad = crop_replicate(left, -k2w, -k2h, w + 2 * k2w, h + 2 * k2h)
    xpad = crop_replicate(x_deriv, -k2w, -k2h, w + 2 * k2w, h + 2 * k2h)
    ypad = crop_replicate(y_deriv, -k2w, -k2h, w + 2 * k2w, h + 2 * k2h)

    wt = weight_template(kw, kh)
    vpad = crop_zero(valid.to(dt), -k2w, -k2h, w + 2 * k2w, h + 2 * k2h)
    wsum = torch.zeros_like(left)
    good = torch.zeros_like(left)
    for jj in range(kh):
        for ii in range(kw):
            vtap = vpad[jj:jj + h, ii:ii + w]
            wsum = wsum + float(wt[jj, ii]) * vtap
            good = good + vtap
    ok_weights = good >= (kern_pixels // 2)
    wsum = torch.clamp(wsum, min=1e-20)

    zero = _full(0.0, left)
    dispf = disp.to(dt)
    dint = torch.round(dispf).to(torch.int32)
    frac0 = dispf - dint.to(dt)
    # the warped frame G(q) = right(q + dint(q) + round(frac0(q))) on the
    # margin-extended grid, the warp field edge-replicated, reads clipped
    rh, rw = right.shape
    qy = torch.arange(-mh, h + mh, dtype=torch.int32, device=dev)[:, None]
    qx = torch.arange(-m, w + m, dtype=torch.int32, device=dev)[None, :]
    fold = torch.round(frac0).to(torch.int32)
    wf = dint + fold
    wx = crop_replicate(wf[..., 0], -m, -mh, w + 2 * m, h + 2 * mh)
    wy = crop_replicate(wf[..., 1], -m, -mh, w + 2 * m, h + 2 * mh)
    ty = (qy + wy).clamp(0, rh - 1).long()
    tx = (qx + wx).clamp(0, rw - 1).long()
    G = right.reshape(-1)[ty * rw + tx]

    n_em = max(em_iters, 1)
    use_em = em_iters > 0
    var2_plane, var2_noise = 1e-3, 1e-2
    two_var_plane = _full(2 * var2_plane, left)
    two_var_noise = _full(2 * var2_noise, left)
    pnf = 1.0 / math.sqrt(2 * math.pi * var2_plane)
    nnf = 1.0 / math.sqrt(2 * math.pi * var2_noise)
    kern_px = _full(kern_pixels, left)
    wt_dev = torch.as_tensor(wt, device=dev).to(dt)
    iiv = torch.arange(-k2w, k2w + 1, dtype=dt, device=dev)[:, None, None]
    ii2 = iiv * iiv

    one, nil = torch.ones_like(left), torch.zeros_like(left)
    d = [one, nil, nil, nil, one, nil]
    prev = torch.zeros_like(left)
    frozen = torch.zeros((h, w), dtype=torch.bool, device=dev)
    poisoned = torch.zeros((h, w), dtype=torch.bool, device=dev)
    for it in range(outer_iters):
        aborted = sqrt_rn(d[2] * d[2] + d[5] * d[5]) > max_trans
        active = ~frozen & ~aborted
        ofx = d[2] + frac0[..., 0] - fold[..., 0].to(dt)
        ofy = d[5] + frac0[..., 1] - fold[..., 1].to(dt)
        d_em = list(d)
        mean_noise = torch.zeros_like(left)
        w_plane = torch.full_like(left, 0.8)
        w_noise = torch.full_like(left, 0.2)
        poison = []
        for _ in range(n_em):
            A = {(i, j): torch.zeros_like(left) for i in range(6) for j in range(i, 6)}
            b = [torch.zeros_like(left) for _ in range(6)]
            sum_ie = torch.zeros_like(left)
            mean_noise_tmp = torch.zeros_like(left)
            sg_plane = torch.zeros_like(left)
            sg_noise = torch.zeros_like(left)
            for jj in range(-k2h, k2h + 1):
                j0 = jj + k2h
                L_row = _rows(lpad, j0, h, w, kw)
                Ix = _rows(xpad, j0, h, w, kw)
                Iy = _rows(ypad, j0, h, w, kw)
                v_row = _rows(vpad, j0, h, w, kw)
                w_row = wt_dev[j0][:, None, None] * v_row / wsum[None]
                ox = (d[0] - 1.0)[None] * iiv + (d[1] * jj + ofx)[None]
                oy = d[3][None] * iiv + ((d[4] - 1.0) * jj + ofy)[None]
                ox = ox.clamp(-1.0, 1.0 - 1e-6)
                oy = oy.clamp(-1.0, 1.0 - 1e-6)
                sample = None
                for sy in (-1, 0, 1):
                    wide = _rows(G[:, 1:], jj + sy + mh, h, w, kw + 2)
                    wy_ = torch.clamp(1.0 - (oy - sy).abs(), min=0.0)
                    row_acc = None
                    for sx in (-1, 0, 1):
                        wx_ = torch.clamp(1.0 - (ox - sx).abs(), min=0.0)
                        term = wx_ * wide[sx + 1:sx + 1 + kw]
                        row_acc = term if row_acc is None else row_acc + term
                    term = wy_ * row_acc
                    sample = term if sample is None else sample + term

                I_e = sample - L_row
                if use_em:
                    delta_x = d_em[0][None] * iiv + (d_em[1] * jj + d_em[2])[None]
                    delta_y = d_em[3][None] * iiv + (d_em[4] * jj + d_em[5])[None]
                    temp_plane = I_e - delta_x * Ix - delta_y * Iy
                    temp_noise = sample - mean_noise[None]
                    ppe = -(temp_plane * temp_plane) / two_var_plane
                    plane_prob = torch.where(ppe < -75.0, zero, pnf * torch.exp(ppe))
                    npe = -(temp_noise * temp_noise) / two_var_noise
                    noise_prob = torch.where(npe < -75.0, zero, nnf * torch.exp(npe))
                    denom = plane_prob * w_plane[None] + noise_prob * w_noise[None]
                    pos = denom > 0
                    safe = torch.where(pos, denom, _full(1.0, left))
                    gamma_plane = torch.where(pos, plane_prob * w_plane[None] / safe, zero)
                    gamma_noise = torch.where(pos, noise_prob * w_noise[None] / safe, zero)
                    poison.append((~pos).any(0))
                    weight = gamma_plane * w_row
                else:
                    weight = w_row

                Ixw = weight * Ix
                Iyw = weight * Iy
                P1 = Ixw * Ix
                P2 = Iyw * Iy
                P3 = Ixw * Iy
                xe = Ixw * I_e
                ye = Iyw * I_e
                sie = I_e.sum(0)
                bx0, bx1 = xe.sum(0), (iiv * xe).sum(0)
                by0, by1 = ye.sum(0), (iiv * ye).sum(0)
                moments = [(P.sum(0), (iiv * P).sum(0), (ii2 * P).sum(0))
                           for P in (P1, P2, P3)]
                sum_ie = sum_ie + sie
                if use_em:
                    mean_noise_tmp = mean_noise_tmp + (sample * gamma_noise).sum(0)
                    sg_plane = sg_plane + gamma_plane.sum(0)
                    sg_noise = sg_noise + gamma_noise.sum(0)
                b[0] = b[0] - bx1
                b[1] = b[1] - jj * bx0
                b[2] = b[2] - bx0
                b[3] = b[3] - by1
                b[4] = b[4] - jj * by0
                b[5] = b[5] - by0
                for base, (s0, s1, s2) in ((0, moments[0]), (3, moments[1])):
                    A[(base, base)] = A[(base, base)] + s2
                    A[(base, base + 1)] = A[(base, base + 1)] + jj * s1
                    A[(base, base + 2)] = A[(base, base + 2)] + s1
                    A[(base + 1, base + 1)] = A[(base + 1, base + 1)] + jj * jj * s0
                    A[(base + 1, base + 2)] = A[(base + 1, base + 2)] + jj * s0
                    A[(base + 2, base + 2)] = A[(base + 2, base + 2)] + s0
                s0, s1, s2 = moments[2]
                A[(0, 3)] = A[(0, 3)] + s2
                A[(0, 4)] = A[(0, 4)] + jj * s1
                A[(0, 5)] = A[(0, 5)] + s1
                A[(1, 3)] = A[(1, 3)] + jj * s1
                A[(1, 4)] = A[(1, 4)] + jj * jj * s0
                A[(1, 5)] = A[(1, 5)] + jj * s0
                A[(2, 3)] = A[(2, 3)] + s1
                A[(2, 4)] = A[(2, 4)] + jj * s0
                A[(2, 5)] = A[(2, 5)] + s0

            lhs = _solve6(A, b)
            if use_em:
                mean_noise = torch.where(sg_noise > 0,
                                         mean_noise_tmp / torch.clamp(sg_noise, min=1e-20),
                                         mean_noise)
                w_plane = sg_plane / kern_px
                w_noise = sg_noise / kern_px
                d_em = [d[k] + lhs[k] for k in range(6)]

        d_new = [d[k] + lhs[k] for k in range(6)]
        curr_sum = sum_ie.abs()
        if use_em:
            stop = (prev < curr_sum) & (it > 0)
        else:
            kqw, kqh = float(k2w // 2), float(k2h // 2)
            wl = (kqw * lhs[0] * (kqw * lhs[0])
                  + kqh * lhs[1] * (kqh * lhs[1])
                  + lhs[2] * lhs[2]
                  + kqw * lhs[3] * (kqw * lhs[3])
                  + kqh * lhs[4] * (kqh * lhs[4])
                  + lhs[5] * lhs[5])
            stop = sqrt_rn(wl) < 0.05
        d = [torch.where(active, d_new[k], d[k]) for k in range(6)]
        frozen = frozen | aborted | (active & stop)
        for pr in poison:
            poisoned = poisoned | (active & pr)
        prev = torch.where(active & ~stop, curr_sum, prev)

    trans = sqrt_rn(d[2] * d[2] + d[5] * d[5])
    bad = (trans > max_trans) | ~torch.isfinite(d[2]) | ~torch.isfinite(d[5]) | poisoned
    out_valid = valid & ok_weights & ~bad
    out = dispf + torch.stack([torch.where(bad, zero, d[2]), torch.where(bad, zero, d[5])], -1)
    return torch.where(out_valid[..., None], out, zero), out_valid


def refine(disp, valid, left, right, kernel: Tuple[int, int], subpixel: str,
           prefilter_mode: str, prefilter_width: float, dtype=torch.float32):
    """The integer map (``disp`` (H, W, 2) absolute offsets, ``valid``)
    refined against the raw frames ``left`` / ``right`` over a ``kernel``
    = (width, height) window in the program's ``subpixel`` mode (``em`` or
    ``affine``). Returns (disp (H, W, 2) float32, valid)."""
    kw, kh = (int(k) for k in kernel)
    with _no_tf32():
        lf = prefilter(left.to(dtype), prefilter_mode, prefilter_width)
        rf = prefilter(right.to(dtype), prefilter_mode, prefilter_width)
        d, v = _refine(disp, valid, lf, rf, kw, kh, EM_ITERS[subpixel], OUTER_ITERS)
    return d.to(torch.float32), v
