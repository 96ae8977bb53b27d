"""Iterative subpixel refinement beyond the parabola fit (port of
``visionworkbench_tpu/stereo/subpixel_refine.py``; ref
``PyramidSubpixelView`` / ``subpixel_optimized_affine_2d`` / Lucas-Kanade
and Bayes-EM kernels, ``src/vw/Stereo/SubpixelView.h:28-146``,
``Correlate.cc``; phase correlation ``PhaseSubpixelView.cc``).

All refiners are dense and vectorized, in the JAX package's formulation:
every pixel's window system is assembled from window-tap slices (no
per-pixel loops), and the per-pixel 2x2 / 6x6 normal equations solve in
closed form / an unrolled elementwise Cholesky. The Bayes-EM refiner keeps
the window rows on a leading tap axis of length ``kw`` and samples the
right image through a 3x3 hat-weighted stencil over a warped frame.

This is plain tensor work on the disparity map's device (no TPU kernel is
involved in the JAX package either). Quotients by constants divide by 0-dim
tensors on the device, and square roots and reciprocals are the correctly
rounded ones (``stereo/correlation.py``), so the CPU path follows the JAX
package's IEEE arithmetic; ``exp`` and the order of the tap sums are the
backend's own.

Each call of the affine / Bayes-EM refiner names its steps with
``core/profiling.span`` (free when nothing records): ``em.inputs`` (the
prefiltered frames, the refiner pyramid, the derivatives and padded
stacks), ``em.weights`` (the window-weight normalisation), ``em.warp`` (the
integer warp of the right frame and the start state), one ``em.iter`` an
outer iteration, and ``em.finish`` (the final invalidation; between refiner
levels, the feed-forward). ``em_calls`` and ``em_outer_iterations`` count
the refiner's calls and outer iterations.
"""

from __future__ import annotations

import functools
import math
import os

import numpy as np
import torch

from visionworkbench_torch.core.device import as_tensor, scalar, sqrt_rn
from visionworkbench_torch.core.profiling import span
from visionworkbench_torch.image.edge import crop_extended, edge_extend
from visionworkbench_torch.image.filters import derivative_filter
from visionworkbench_torch.image.interpolation import interpolate
from visionworkbench_torch.image.manipulation import subsample2
from visionworkbench_torch.image.transform import _dest_grid
from visionworkbench_torch.stereo.correlation import DisparityMap, _reciprocal
from visionworkbench_torch.stereo.disparity import disparity_subsample
from visionworkbench_torch.stereo.prefilter import PREFILTER_NONE, prefilter_image

# Calls of the dense affine / Bayes-EM refiner (:func:`_em_affine_dense`, one
# a refiner level) and the outer iterations they ran, since the counts were
# last set to 0.
em_calls = 0
em_outer_iterations = 0


def _sample(img, x, y):
    """Bilinear gather with clamping."""
    h, w = img.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    tx = x - x0
    ty = y - y0
    x0i = x0.to(torch.int32).clamp(0, w - 1).long()
    y0i = y0.to(torch.int32).clamp(0, h - 1).long()
    x1i = (x0i + 1).clamp(0, w - 1)
    y1i = (y0i + 1).clamp(0, h - 1)
    p00 = img[y0i, x0i]
    p10 = img[y0i, x1i]
    p01 = img[y1i, x0i]
    p11 = img[y1i, x1i]
    return ((p00 * (1 - tx) + p10 * tx) * (1 - ty) +
            (p01 * (1 - tx) + p11 * tx) * ty)


def _lk_refine(disp, valid, left, right, kw: int, kh: int, iters: int):
    """Translation-only Lucas-Kanade: per pixel solve the 2x2 system
    [sum gx^2, sum gxgy; ., sum gy^2] d = -[sum gx e, sum gy e]. The
    gradients wrap around the frame (``roll``), as in the JAX package.

    Gather-based (4 bilinear gathers x kw*kh taps x iters): for small
    tiles; :func:`affine_subpixel` / :func:`bayes_em_subpixel` are the
    full-frame refiners."""
    h, w = left.shape
    xs, ys = _dest_grid(h, w, left.device)
    k2w, k2h = kw // 2, kh // 2
    gx_r = (torch.roll(right, -1, 1) - torch.roll(right, 1, 1)) * 0.5
    gy_r = (torch.roll(right, -1, 0) - torch.roll(right, 1, 0)) * 0.5
    d0 = disp.to(torch.float32)
    d = d0
    for _ in range(iters):
        a11 = torch.zeros_like(left)
        a12 = torch.zeros_like(left)
        a22 = torch.zeros_like(left)
        b1 = torch.zeros_like(left)
        b2 = torch.zeros_like(left)
        for wy in range(-k2h, k2h + 1):
            for wx in range(-k2w, k2w + 1):
                xw = xs + wx
                yw = ys + wy
                tx = xw + d[..., 0]
                ty = yw + d[..., 1]
                lv = _sample(left, xw, yw)
                rv = _sample(right, tx, ty)
                gx = _sample(gx_r, tx, ty)
                gy = _sample(gy_r, tx, ty)
                e = rv - lv
                a11 = a11 + gx * gx
                a12 = a12 + gx * gy
                a22 = a22 + gy * gy
                b1 = b1 + gx * e
                b2 = b2 + gy * e
        det = a11 * a22 - a12 * a12
        det = torch.where(det.abs() < 1e-9, scalar(1e-9, det), det)
        ddx = -(a22 * b1 - a12 * b2) / det
        ddy = -(-a12 * b1 + a11 * b2) / det
        d = d + torch.stack([ddx.clamp(-1.0, 1.0), ddy.clamp(-1.0, 1.0)], -1)
    dd = d - d0
    drift = sqrt_rn(dd[..., 0] * dd[..., 0] + dd[..., 1] * dd[..., 1])
    ok = valid & (drift < 2.0) & torch.isfinite(d).all(-1)
    return torch.where(ok[..., None], d, d0), valid


def _inputs(disparity: DisparityMap, left, right, prefilter_mode, prefilter_width):
    """``left``/``right`` as prefiltered fp32 tensors on the disparity map's
    device."""
    dev = disparity.disparity.device
    left = prefilter_image(as_tensor(left, torch.float32, dev), prefilter_mode,
                           prefilter_width)
    right = prefilter_image(as_tensor(right, torch.float32, dev), prefilter_mode,
                            prefilter_width)
    return left, right


def lk_subpixel(disparity: DisparityMap, left, right, kernel_size,
                iterations: int = 5, prefilter_mode: str = PREFILTER_NONE,
                prefilter_width: float = 1.4) -> DisparityMap:
    """Dense Lucas-Kanade subpixel (ref the LK variant of
    ``PyramidSubpixelView``), on the disparity map's device."""
    left, right = _inputs(disparity, left, right, prefilter_mode, prefilter_width)
    kw, kh = int(kernel_size[0]), int(kernel_size[1])
    d, valid = _lk_refine(disparity.disparity, disparity.valid, left, right,
                          kw, kh, int(iterations))
    return DisparityMap(d, valid)


def affine_subpixel(disparity: DisparityMap, left, right, kernel_size,
                    iterations: int = 5, prefilter_mode: str = PREFILTER_NONE,
                    prefilter_width: float = 1.4) -> DisparityMap:
    """Affine-adaptive-window subpixel (ref ``subpixel_optimized_affine_2d``,
    Correlate.cc:848-1080): the plain weighted affine Gauss-Newton core of
    the Bayes-EM family (``em_iters=0``). Failed fits (divergent affine
    parameters, degenerate weights) are invalidated (disparity zeroed,
    valid False), as in the EM refiner."""
    return bayes_em_subpixel(disparity, left, right, kernel_size,
                             em_iters=0, outer_iters=int(iterations),
                             prefilter_mode=prefilter_mode,
                             prefilter_width=prefilter_width)


def _hanning(n: int, device):
    """``jnp.hanning(n)`` in fp32: 0.5 (1 - cos(2 pi k / (n - 1))), the
    cosine taken in float64 and rounded (equal to the JAX package's)."""
    if n <= 1:
        return torch.ones(n, dtype=torch.float32, device=device)
    k = torch.arange(n, dtype=torch.float32, device=device)
    span = torch.full((), float(n - 1), dtype=torch.float32, device=device)
    return 0.5 * (1 - torch.cos((2 * math.pi * k / span).double()).float())


def _phase_windows(left, right, int_dx, int_dy, window: int, stride: int,
                   upsample: int):
    """Per window of the grid (centres ``gy`` x ``gx``), the (dx, dy) offset
    of the phase-correlation peak between the Hann-windowed left patch and
    the right patch shifted by the integer disparity (clamped into the
    frame), at ``1 / upsample`` px by zero-padding the cross spectrum."""
    h, w = left.shape
    dev = left.device
    half = window // 2
    gy = torch.arange(half, h - half, stride, device=dev)
    gx = torch.arange(half, w - half, stride, device=dev)
    win = _hanning(window, dev)
    win2 = win[:, None] * win[None, :]
    taps = torch.arange(window, device=dev)
    y0 = gy - half
    x0 = gx - half
    dy0 = (y0 + int_dy).clamp(0, h - window)
    dx0 = (x0 + int_dx).clamp(0, w - window)
    # (ny, nx, window, window) patches
    lp = left[(y0[:, None] + taps)[:, None, :, None],
              (x0[:, None] + taps)[None, :, None, :]] * win2
    rp = right[(dy0[:, None] + taps)[:, None, :, None],
               (dx0[:, None] + taps)[None, :, None, :]] * win2
    f1 = torch.fft.fft2(lp)
    f2 = torch.fft.fft2(rp)
    # Unnormalized cross spectrum: the windows are integer-aligned, so the
    # plain correlation peak is unambiguous.
    cross = f1 * torch.conj(f2)
    m_up = window * upsample
    padded = torch.zeros(cross.shape[:2] + (m_up, m_up), dtype=torch.complex64,
                         device=dev)
    padded[..., :half, :half] = cross[..., :half, :half]
    padded[..., :half, -half:] = cross[..., :half, -half:]
    padded[..., -half:, :half] = cross[..., -half:, :half]
    padded[..., -half:, -half:] = cross[..., -half:, -half:]
    corr = torch.fft.ifft2(padded).real
    peak = torch.argmax(corr.reshape(corr.shape[0], corr.shape[1], -1), -1)
    py = torch.div(peak, m_up, rounding_mode="floor")
    px = peak % m_up
    up = scalar(upsample, left)
    py = torch.where(py > m_up // 2, py - m_up, py).to(torch.float32) / up
    px = torch.where(px > m_up // 2, px - m_up, px).to(torch.float32) / up
    # disparity d satisfies left(p) = right(p + d); the peak sits at -d.
    return gx, gy, torch.stack([-px, -py], -1)


def phase_subpixel(disparity: DisparityMap, left, right, window: int = 32,
                   stride: int = 8, upsample: int = 8) -> DisparityMap:
    """Phase-correlation subpixel on a window grid with Fourier upsampling
    (ref ``PhaseSubpixelView.cc``), on the disparity map's device. The
    windows align on the mean of the valid disparities (truncated to an
    integer); each window's offset refines it, and the offsets are spread
    back to pixels bilinearly."""
    dev = disparity.disparity.device
    left = as_tensor(left, torch.float32, dev)
    right = as_tensor(right, torch.float32, dev)
    h, w = left.shape
    valid = disparity.valid
    dsum = torch.where(valid[..., None], disparity.disparity,
                       torch.zeros((), dtype=disparity.disparity.dtype, device=dev))
    cnt = torch.clamp(valid.sum(), min=1)
    dmean = (dsum.reshape(-1, 2).sum(0) / cnt).to(torch.int32)
    gx, gy, offs = _phase_windows(left, right, dmean[0], dmean[1],
                                  int(window), int(stride), int(upsample))
    xs, ys = _dest_grid(h, w, dev)
    step = scalar(max(int(stride), 1), left)
    fx = (xs - gx[0].to(torch.float32)) / step
    fy = (ys - gy[0].to(torch.float32)) / step
    off_x = interpolate(offs[..., 0], fx, fy, "bilinear")
    off_y = interpolate(offs[..., 1], fx, fy, "bilinear")
    d = torch.stack([dmean[0] + off_x, dmean[1] + off_y], -1)
    return DisparityMap(torch.where(valid[..., None], d, scalar(0.0, d)), valid)


# ---------------------------------------------------------------------------
# Bayes-EM affine subpixel (ref subpixel_optimized_affine_2d_EM,
# Correlate.cc:500-845, and bayes_em_subpixel, SubpixelView.h:128-146)
# ---------------------------------------------------------------------------

def _weight_template(kw: int, kh: int) -> np.ndarray:
    """Gaussian window weights (ref compute_spatial_weight_image,
    Correlate.cc:36-55): exp(-(di^2+dj^2)/two_sigma_sqr) normalized, with
    two_sigma_sqr = 2*(kw/5)^2 (Correlate.cc:519)."""
    two_sigma_sqr = 2.0 * (float(kw) / 5.0) ** 2
    ii = np.arange(kw) - kw // 2
    jj = np.arange(kh) - kh // 2
    w = np.exp(-(ii[None, :] ** 2 + jj[:, None] ** 2) / two_sigma_sqr)
    return (w / w.sum()).astype("float32")


@functools.lru_cache(maxsize=None)
def _weight_template_on(kw: int, kh: int, device: torch.device) -> torch.Tensor:
    """:func:`_weight_template` on ``device``, copied there once for each
    (kw, kh, device): a pageable copy to the card waits for all the work
    queued before it, so a copy a call would hold the host at every call."""
    return torch.as_tensor(_weight_template(kw, kh), device=device)


def _solve6(A, b):
    """Unrolled 6x6 Cholesky solve, elementwise over (H, W) maps.

    ``A``: dict {(i, j): map} upper-triangular entries (i <= j) of the SPD
    normal matrix; ``b``: list of 6 maps. Non-SPD pixels produce NaNs,
    which the caller's final check invalidates (the reference's posv
    failure path degrades the same way)."""
    L = {}
    for j in range(6):
        s = A[(j, j)]
        for k in range(j):
            s = s - L[(j, k)] * L[(j, k)]
        L[(j, j)] = sqrt_rn(s)
        inv = _reciprocal(L[(j, j)])
        for i in range(j + 1, 6):
            s = A[(j, i)]
            for k in range(j):
                s = s - L[(i, k)] * L[(j, k)]
            L[(i, j)] = s * inv
    # forward substitution L y = b
    y = []
    for i in range(6):
        s = b[i]
        for k in range(i):
            s = s - L[(i, k)] * y[k]
        y.append(s / L[(i, i)])
    # back substitution L^T x = y
    x = [None] * 6
    for i in range(5, -1, -1):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - L[(k, i)] * x[k]
        x[i] = s / L[(i, i)]
    return x


def _rows(padded, j0: int, h: int, w: int, n: int):
    """The ``n`` column-shifted (h, w) windows of ``padded`` starting at row
    ``j0``, stacked on a leading tap axis: ``[i] = padded[j0:j0+h, i:i+w]``."""
    return padded[j0:j0 + h].unfold(1, w, 1)[:, :n].permute(1, 0, 2).contiguous()


def _em_affine_dense(disp, valid, left, right, kw: int, kh: int,
                     em_iters: int, outer_iters: int):
    """Dense Bayes-EM affine subpixel — every pixel of the frame refines
    simultaneously (ref ``subpixel_optimized_affine_2d_EM``,
    Correlate.cc:500-845, update for update; ``em_iters=0`` disables the
    Gaussian+uniform mixture weighting, leaving the plain weighted affine
    Gauss-Newton core of ``subpixel_optimized_affine_2d``,
    Correlate.cc:848-1080).

    Per pixel, as the reference: an identity-initialized 6-parameter affine
    window model [d0 d1 d2; d3 d4 d5]; Gaussian window weights zeroed at
    invalid-neighbour taps and renormalized (pixels with fewer than
    kern_pixels // 2 valid neighbours invalidate); the EM mixture (plane
    model N(0, 1e-3) against the noise model N(mean_noise, 1e-2), priors
    0.8 / 0.2, the exponent guard at -75); the 6x6 normal-equation Cholesky
    solve; the |translation| > kern_width / 2 abort; the rising-|sum I_e|
    stop (EM) or the update-norm stop (plain affine); the final NaN and
    translation invalidation, the offset added to the original disparity.

    The JAX package's formulation: the right image is warped by the
    per-pixel integer part of the disparity once (or, with
    ``VWTPU_EM_REWARP=1``, once per outer iteration, by the current
    integer translation), and each tap's fractional sample is a 3x3
    hat-weighted stencil over the warped frame, offsets clipped to
    [-1, 1 - 1e-6]. Border pixels read replicate-extended samples. A zero
    mixture denominator computes with gamma 0 and poisons the pixel, which
    ends invalid (the reference's NaN path).
    """
    global em_calls, em_outer_iterations
    em_calls += 1
    h, w = left.shape
    dev = left.device
    k2w, k2h = kw // 2, kh // 2
    kern_pixels = kw * kh
    max_trans = float(kw) / 2.0
    m = k2w + 2  # stencil margin: tap + cell shift + bilinear
    mh = k2h + 2

    with span("em.inputs"):
        x_deriv = derivative_filter(left, 1, 0)
        y_deriv = derivative_filter(left, 0, 1)
        lpad = edge_extend(left, k2w, k2h)
        xpad = edge_extend(x_deriv, k2w, k2h)
        ypad = edge_extend(y_deriv, k2w, k2h)

    with span("em.weights"):
        # Per-pixel window weight normalization (adjust_weight_image).
        wt = _weight_template(kw, kh)
        validf = valid.to(torch.float32)
        vpad = edge_extend(validf, k2w, k2h, mode="zero")
        wsum = torch.zeros_like(left)
        good = torch.zeros_like(left)
        for jj in range(kh):
            for ii in range(kw):
                vtap = vpad[jj:jj + h, ii:ii + w]
                wsum = wsum + float(wt[jj, ii]) * vtap
                good = good + vtap
        ok_weights = good >= (kern_pixels // 2)
        wsum = torch.clamp(wsum, min=1e-20)

    with span("em.warp"):
        zero = scalar(0.0, left)
        dispf = disp.to(torch.float32)
        dint = torch.round(dispf).to(torch.int32)
        frac0 = dispf - dint.to(torch.float32)

        rh, rw = right.shape
        qy = torch.arange(-mh, h + mh, dtype=torch.int32, device=dev)[:, None]
        qx = torch.arange(-m, w + m, dtype=torch.int32, device=dev)[None, :]
        rflat = right.reshape(-1)

        def warp(fold):
            """G(q) = right(q + dint(q) + fold(q)) on the margin-extended grid
            (edge-replicated warp field; clipped reads)."""
            wf = dint + fold
            wx = crop_extended(wf[..., 0], -m, -mh, w + 2 * m, h + 2 * mh)
            wy = crop_extended(wf[..., 1], -m, -mh, w + 2 * m, h + 2 * mh)
            ty = (qy + wy).clamp(0, rh - 1).long()
            tx = (qx + wx).clamp(0, rw - 1).long()
            return rflat[ty * rw + tx]

        n_em = max(em_iters, 1)
        use_em = em_iters > 0
        # The JAX package's re-warp switch (read here on every call; there, once
        # per trace): warp-once reuses iteration 1's G, later offsets riding the
        # stencil clip; re-warp folds the integer translation into the warp
        # field every iteration (the reference-faithful mode).
        rewarp = os.environ.get("VWTPU_EM_REWARP", "0") == "1"
        fold0 = torch.round(frac0).to(torch.int32)
        G0 = None if rewarp else warp(fold0)

        var2_plane, var2_noise = 1e-3, 1e-2
        two_var_plane = scalar(2 * var2_plane, left)
        two_var_noise = scalar(2 * var2_noise, left)
        pnf = 1.0 / math.sqrt(2 * math.pi * var2_plane)
        nnf = 1.0 / math.sqrt(2 * math.pi * var2_noise)
        kern_px = scalar(kern_pixels, left)
        wt_dev = _weight_template_on(kw, kh, dev)
        iiv = torch.arange(-k2w, k2w + 1, dtype=torch.float32, device=dev)[:, None, None]
        ii2 = iiv * iiv

        # the start state: identity affine windows, nothing frozen
        one, nil = torch.ones_like(left), torch.zeros_like(left)
        d = [one, nil, nil, nil, one, nil]
        fold = fold0
        prev = torch.zeros_like(left)
        frozen = torch.zeros((h, w), dtype=torch.bool, device=dev)
        poisoned = torch.zeros((h, w), dtype=torch.bool, device=dev)

    def outer_body(it, d, fold, prev_sum, frozen, poisoned):
        # abort check at iteration top (Correlate.cc:212-217)
        aborted = sqrt_rn(d[2] * d[2] + d[5] * d[5]) > max_trans
        active = ~frozen & ~aborted

        G = warp(fold) if rewarp else G0
        tfx = d[2] + frac0[..., 0] - fold[..., 0].to(torch.float32)
        tfy = d[5] + frac0[..., 1] - fold[..., 1].to(torch.float32)

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
                L_row = _rows(lpad, j0, h, w, kw)          # (T, H, W)
                Ix = _rows(xpad, j0, h, w, kw)
                Iy = _rows(ypad, j0, h, w, kw)
                v_row = _rows(vpad, j0, h, w, kw)
                w_row = wt_dev[j0][:, None, None] * v_row / wsum[None]

                ox = (d[0] - 1.0)[None] * iiv + (d[1] * jj + tfx)[None]
                oy = d[3][None] * iiv + ((d[4] - 1.0) * jj + tfy)[None]
                ox = ox.clamp(-1.0, 1.0 - 1e-6)
                oy = oy.clamp(-1.0, 1.0 - 1e-6)
                # 3x3 hat-weighted stencil sample of G at (jj+oy, ii+ox);
                # the x-stencil reads are axis-0 slices of one wide row
                # stack, shared across taps.
                sample = None
                for sy in (-1, 0, 1):
                    # columns c + m, c = -k2w-1 .. k2w+1: (T+2, H, W)
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
                    safe = torch.where(pos, denom, scalar(1.0, left))
                    gamma_plane = torch.where(pos, plane_prob * w_plane[None] / safe, zero)
                    gamma_noise = torch.where(pos, noise_prob * w_noise[None] / safe, zero)
                    # A zero denominator (both mixture probabilities
                    # underflowed) NaN-poisons the reference's accumulators
                    # (Correlate.cc:676-678) and the pixel ends invalid; here
                    # gamma is 0 and the poisoning is recorded.
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
                # the 14 (EM: 17) moment sums of the row over the tap axis
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
                # three moments (1, ii, ii^2) per gradient product; the jj
                # factors are row constants
                for base, (s0, s1, s2) in ((0, moments[0]), (3, moments[1])):
                    A[(base, base)] = A[(base, base)] + s2
                    A[(base, base + 1)] = A[(base, base + 1)] + jj * s1
                    A[(base, base + 2)] = A[(base, base + 2)] + s1
                    A[(base + 1, base + 1)] = A[(base + 1, base + 1)] + jj * jj * s0
                    A[(base + 1, base + 2)] = A[(base + 1, base + 2)] + jj * s0
                    A[(base + 2, base + 2)] = A[(base + 2, base + 2)] + s0
                s0, s1, s2 = moments[2]   # full upper-right block (IxIy)
                A[(0, 3)] = A[(0, 3)] + s2
                A[(0, 4)] = A[(0, 4)] + jj * s1
                A[(0, 5)] = A[(0, 5)] + s1
                A[(1, 3)] = A[(1, 3)] + jj * s1
                A[(1, 4)] = A[(1, 4)] + jj * jj * s0
                A[(1, 5)] = A[(1, 5)] + jj * s0
                A[(2, 3)] = A[(2, 3)] + s1
                A[(2, 4)] = A[(2, 4)] + jj * s0
                A[(2, 5)] = A[(2, 5)] + s0

            lhs_sol = _solve6(A, b)
            if use_em:
                mean_noise = torch.where(sg_noise > 0,
                                         mean_noise_tmp / torch.clamp(sg_noise, min=1e-20),
                                         mean_noise)
                w_plane = sg_plane / kern_px
                w_noise = sg_noise / kern_px
                d_em = [d[k] + lhs_sol[k] for k in range(6)]

        d_new = [d[k] + lhs_sol[k] for k in range(6)]
        curr_sum = sum_ie.abs()
        if use_em:
            # rising-residual early stop, applied after the update like the
            # reference's d += lhs; break (Correlate.cc:824-832)
            stop = (prev_sum < curr_sum) & (it > 0)
        else:
            # the plain-affine refiner stops on a small quarter-kernel-
            # weighted update norm instead (Correlate.cc:1167-1175)
            kqw, kqh = float(k2w // 2), float(k2h // 2)
            wl = (kqw * lhs_sol[0] * (kqw * lhs_sol[0])
                  + kqh * lhs_sol[1] * (kqh * lhs_sol[1])
                  + lhs_sol[2] * lhs_sol[2]
                  + kqw * lhs_sol[3] * (kqw * lhs_sol[3])
                  + kqh * lhs_sol[4] * (kqh * lhs_sol[4])
                  + lhs_sol[5] * lhs_sol[5])
            stop = sqrt_rn(wl) < 0.05
        upd = active
        d_out = [torch.where(upd, d_new[k], d[k]) for k in range(6)]
        new_frozen = frozen | aborted | (upd & stop)
        for pr in poison:
            poisoned = poisoned | (upd & pr)
        new_prev = torch.where(upd & ~stop, curr_sum, prev_sum)
        if rewarp:
            # fold the integer translation into the warp field for the next
            # iteration
            nfx = torch.round(d_out[2] + frac0[..., 0]).to(torch.int32)
            nfy = torch.round(d_out[5] + frac0[..., 1]).to(torch.int32)
            fold = torch.where(upd[..., None], torch.stack([nfx, nfy], -1), fold)
        return d_out, fold, new_prev, new_frozen, poisoned

    for it in range(outer_iters):
        with span("em.iter"):
            d, fold, prev, frozen, poisoned = outer_body(it, d, fold, prev, frozen, poisoned)
        em_outer_iterations += 1

    with span("em.finish"):
        trans = sqrt_rn(d[2] * d[2] + d[5] * d[5])
        bad = (trans > max_trans) | ~torch.isfinite(d[2]) | ~torch.isfinite(d[5])
        bad = bad | poisoned   # mixture-denominator poisoning (see above)
        out_valid = valid & ok_weights & ~bad
        out = dispf + torch.stack([torch.where(bad, zero, d[2]),
                                   torch.where(bad, zero, d[5])], -1)
        return torch.where(out_valid[..., None], out, zero), out_valid


def _boxmean(a, wf, rad: int):
    """Valid-weighted separable box mean of an (H, W, 2) field; the box
    wraps around the frame (``roll``), as in the JAX package."""
    num, den = a * wf[..., None], wf
    for ax in (0, 1):
        n2, d2 = num, den
        for k in range(1, rad + 1):
            n2 = n2 + torch.roll(num, k, ax) + torch.roll(num, -k, ax)
            d2 = d2 + torch.roll(den, k, ax) + torch.roll(den, -k, ax)
        num, den = n2, d2
    return num / torch.clamp(den, min=1.0)[..., None]


def bayes_em_subpixel(disparity: DisparityMap, left, right, kernel_size,
                      em_iters: int = 2, outer_iters: int = 10,
                      prefilter_mode: str = PREFILTER_NONE,
                      prefilter_width: float = 1.4,
                      max_pyramid_levels: int = 2,
                      fine_outer_iters: int = 0) -> DisparityMap:
    """Bayes-EM affine subpixel refinement over its own image pyramid
    (ref ``PyramidSubpixelView`` SUBPIXEL_BAYES_EM, SubpixelView.h:36-146 +
    SubpixelView.cc:33-210 / ``subpixel_optimized_affine_2d_EM``,
    Correlate.cc:500-845), on the disparity map's device: a Gaussian
    "plane" inlier model + uniform-noise outlier model EM-weighted affine
    window fit, refined coarse-to-fine. ``em_iters=0`` degrades to the
    plain weighted affine GN (SUBPIXEL_FAST_AFFINE).

    Pyramid flow, as the JAX package: plain subsample-by-2 images,
    ``disparity_subsample`` seeds, per-level refinement with the same
    kernel size; each coarse level feeds forward a smooth correction (the
    valid-weighted 9x9 box mean of its refined-minus-seed offsets within
    1.25 px, doubled and upsampled) onto the finer level's seed; the final
    pass at native resolution. Levels stop where an image would fall below
    max(64, 8 * kernel) px. ``max_pyramid_levels=0`` is a single
    full-resolution solve. ``fine_outer_iters`` (0 = ``outer_iters``) sets
    the finest level's outer iterations when a coarser level seeds it."""
    kw, kh = int(kernel_size[0]), int(kernel_size[1])
    with span("em.inputs"):
        left, right = _inputs(disparity, left, right, prefilter_mode, prefilter_width)
        levels = max(int(max_pyramid_levels), 0)
        h0, w0 = left.shape[0], left.shape[1]
        min_dim = max(64, 8 * max(kw, kh))
        while levels > 0 and min(h0 >> levels, w0 >> levels) < min_dim:
            levels -= 1
        fine_iters = int(fine_outer_iters) if fine_outer_iters else int(outer_iters)
        if levels == 0:
            fine_iters = int(outer_iters)   # no seed to lean on

        lp, rp = [left], [right]
        dms = [disparity]
        for _ in range(levels):
            lp.append(subsample2(lp[-1]))
            rp.append(subsample2(rp[-1]))
            dms.append(disparity_subsample(dms[-1]))

    dm = dms[-1]
    for i in range(levels, 0, -1):
        d, v = _em_affine_dense(dm.disparity, dm.valid, lp[i], rp[i],
                                kw, kh, int(em_iters), int(outer_iters))
        with span("em.finish"):
            # Feed forward the smooth part of (refined - seed): the integer
            # warp of the finer level must not flip across windows on
            # per-pixel coarse noise.
            delta = d - dm.disparity
            ok = v & (delta.abs().amax(-1) <= 1.25)
            sm = _boxmean(torch.where(ok[..., None], delta, scalar(0.0, delta)),
                          ok.to(torch.float32), 4)
            up = (sm * 2.0).repeat_interleave(2, 0).repeat_interleave(2, 1)
            th, tw = lp[i - 1].shape
            corr = crop_extended(up[:th, :tw], 0, 0, tw, th)
            seed = dms[i - 1]
            dm = DisparityMap(seed.disparity + corr, seed.valid)

    d, valid = _em_affine_dense(dm.disparity, dm.valid, left, right,
                                kw, kh, int(em_iters), fine_iters)
    return DisparityMap(d, valid)
