"""SGM/MGM winner-take-all and subpixel step: the CUDA kernel
``csrc/sgm_wta.cu``, its plain PyTorch version and the wrapper that picks
between them by device.

Replaces no TPU kernel: the JAX package runs the step as tensor work
(``visionworkbench_tpu/stereo/sgm.py:_volume_argmin_subpixel``), and so did
the port until the kernel took it over on the card. The step (ref
``create_disparity_view`` + ``create_disparity_view_subpixel``,
SGM.cc:1159-1614): the winner of each pixel's accumulated (sy, sx) volume
with the reference's tie-smoothing cascade, then the subpixel offset from
the selected volume's 3x3 neighbourhood of the winner (modes none /
parabola / linear / poly4 / cosine / lc_blend).

Every cascade value is an integer-valued fp32 and every operation of the
subpixel fits is written out in one order, which the kernel follows
(``--fmad=false``): the kernel equals the plain version on the card bit for
bit. What bounds the kernel on the H100, and what its design does about it:
see the note at the top of ``csrc/sgm_wta.cu``.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.ops import _build

# Kernel launches since the count was last set to 0 (the wrapper adds one
# per launch of the CUDA kernel, and nowhere else).
launches = 0

N_PATHS = 8  # both SGM and MGM accumulate 8 directional results
_INF = 3e38

# The subpixel modes and csrc/sgm_wta.cu's numbers for them.
_MODES = {"none": 0, "parabola": 1, "linear": 2, "poly4": 3, "cosine": 4,
          "lc_blend": 5}

# Pseudoinverse of the 9-point quadratic design matrix (rows [x^2 y^2 xy x y 1]
# at (x, y) in [-1,1]^2, x fastest) — ref ParabolaFit2d, SGMAssist.h:86-94,
# and ParabolaSubpixelView.h:83-88. The one copy of the port: the block
# matcher's parabola (stereo/subpixel.py) reads it too; csrc/sgm_wta.cu
# holds rows a..e of these float32 values.
PINV_A = np.array([
    [1/6, -1/3, 1/6, 1/6, -1/3, 1/6, 1/6, -1/3, 1/6],    # a
    [1/6, 1/6, 1/6, -1/3, -1/3, -1/3, 1/6, 1/6, 1/6],    # b
    [1/4, 0.0, -1/4, 0.0, 0.0, 0.0, -1/4, 0.0, 1/4],     # c
    [-1/6, 0.0, 1/6, -1/6, 0.0, 1/6, -1/6, 0.0, 1/6],    # d
    [-1/6, -1/6, -1/6, 0.0, 0.0, 0.0, 1/6, 1/6, 1/6],    # e
    [-1/9, 2/9, -1/9, 2/9, 5/9, 2/9, -1/9, 2/9, -1/9],   # f
], dtype=np.float32)
# The erf's scalings as factors: 1 / (0.34574 sqrt 2) and 1 / (0.38944 sqrt 2).
_ERF_X = 1.0 / (0.34574 * math.sqrt(2.0))
_ERF_Y = 1.0 / (0.38944 * math.sqrt(2.0))

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("sgm_wta")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.vw_sgm_wta.argtypes = [p, ll, i, i, ctypes.c_float, i, p, p, p]
        lib.vw_sgm_wta.restype = i
        lib.vw_sgm_wta_scratch_bytes.argtypes = [ll, i, i]
        lib.vw_sgm_wta_scratch_bytes.restype = ll
        _lib = lib
    return _lib


def _subpixel_1d(sm1, s0, sp1, mode: str, left_bound, right_bound):
    """1D subpixel offset from three accumulated costs, in the reference's
    order (``compute_subpixel_offset``, SGM.cc:1445-1479): inputs already
    bound-collapsed; the all-equal zero case takes precedence over the
    two-value bound interpolation (SGM.cc:1440-1443)."""
    one = torch.ones_like(s0)
    ld = sm1 - s0
    rd = sp1 - s0
    both_zero = (ld == 0) & (rd == 0)
    use_pos = ld < rd
    x = torch.where(use_pos, ld / torch.where(rd == 0, one, rd),
                    rd / torch.where(ld == 0, one, ld))
    mult = torch.where(use_pos, one, -one)
    linear = 0.5 * x
    if mode == "linear":
        value = linear
    elif mode == "poly4":
        value = (x * x * x * x + x) * 0.25
    elif mode == "cosine":
        value = 1.0 - torch.cos(x * (math.pi / 3.0))
    elif mode == "lc_blend":
        factor = 1.195 - torch.cos(x * (math.pi / 2.3))
        cosv = 1.0 - torch.cos(x * (math.pi / 3.0))
        value = cosv * factor + linear * (1.0 - factor)
    else:
        raise ArgumentErr(f"_subpixel_1d: unknown 1D mode {mode!r}")
    ratio_off = (value - 0.5) * mult
    two_left = 0.5 * s0 / torch.where(sp1 == 0, one, sp1)
    two_right = -0.5 * s0 / torch.where(sm1 == 0, one, sm1)
    off = torch.where(left_bound, two_left,
                      torch.where(right_bound, two_right, ratio_off))
    return torch.where(both_zero, torch.zeros_like(off), off)


def _parabola_2d(z):
    """The reference SGM parabola: 9-point quadratic fit, erf squashing and
    norm clamp at 0.5; |denom| < 0.01 keeps the integer disparity
    (``ParabolaFit2d::find_peak``, SGMAssist.h:97-135). ``z`` (H, W, 9), dx
    fastest. A deliberate departure from the JAX package, which fits in
    fp32 (an einsum): the port fits in float64, as the C++ reference's
    ``ParabolaFit2d`` does (its offsets pass through float32 before the
    erf). The fit cancels large terms, so fp32 sums carry noise of ~1e-5 px
    whose sign depends on the summation order, while float64 gives the same
    offsets on the CPU and on the card; the two packages agree within the
    2e-5 px subpixel tolerance. Each coefficient sums its nine terms in
    index order (exact for integer-valued costs in any order) and the erf's
    scalings are products with :data:`_ERF_X` / :data:`_ERF_Y`, the
    operations of ``csrc/sgm_wta.cu``."""
    pinv = torch.tensor(PINV_A[:5], dtype=torch.float64, device=z.device)
    prod = z.to(torch.float64)[..., None, :] * pinv           # (H, W, 5, 9)
    v = prod[..., 0]
    for i in range(1, 9):
        v = v + prod[..., i]
    a, b, c, d, e = v.unbind(-1)
    denom = 4.0 * a * b - c * c
    ok = denom.abs() >= 0.01
    safe = torch.where(ok, denom, torch.ones_like(denom))
    ox = ((c * e - 2.0 * b * d) / safe).to(torch.float32).to(torch.float64)
    oy = ((c * d - 2.0 * a * e) / safe).to(torch.float32).to(torch.float64)
    ox = torch.erf(ox * _ERF_X) / 2.0
    oy = torch.erf(oy * _ERF_Y) / 2.0
    norm = torch.hypot(ox, oy)
    scale = torch.where(norm >= 0.5, norm / 0.5, torch.ones_like(norm))
    zero = torch.zeros_like(ox)
    return (torch.where(ok, ox / scale, zero).to(torch.float32),
            torch.where(ok, oy / scale, zero).to(torch.float32))


def _sh3(x, d: int, axis: int):
    """Shift by ``d`` (+-1) along ``axis`` with zero fill."""
    z = torch.zeros_like(x.narrow(axis, 0, 1))
    n = x.shape[axis]
    if d > 0:
        return torch.cat([z, x.narrow(axis, 0, n - d)], axis)
    return torch.cat([x.narrow(axis, -d, n + d), z], axis)


def _masked_mean3(v, allowed_f, inv_cnt, axis: int):
    """One ``select_best_disparity`` smoothing iteration (SGM.cc:1223-1268):
    3-tap box mean along ``axis`` with out-of-rectangle taps dropped,
    rounded half away from zero (``floor(x + 0.5)``, exact here), through
    the precomputed reciprocal tap count as the JAX package does."""
    va = v * allowed_f
    s = va + _sh3(va, 1, axis) + _sh3(va, -1, axis)
    out = torch.floor(s * inv_cnt + 0.5)
    return torch.where(allowed_f > 0, out, v)


def _wta_stats(v, allowed):
    """(min, multiplicity, first argmin) over the flattened (sy*sx) axis."""
    h, w = v.shape[:2]
    vm = torch.where(allowed, v, torch.full_like(v, _INF)).reshape(h, w, -1)
    mn = vm.amin(-1)
    eq = vm == mn[..., None]
    cnt = eq.sum(-1, dtype=torch.int32)
    ids = torch.arange(vm.shape[-1], dtype=torch.int32, device=v.device)
    arg = torch.where(eq, ids, torch.full_like(ids, 2 ** 30)).amin(-1)
    return mn, cnt, arg


def _tie_smooth_select(acc, allowed):
    """``select_best_disparity`` (SGM.cc:1159-1284): where a pixel's minimum
    accumulated cost is not unique, smooth its bounds rectangle with 3-tap
    box filters (5 horizontal iterations, then 1 vertical) until the minimum
    is unique or 6 iterations pass; the smoothed values replace the volume
    that the subpixel step reads. ``acc`` (H, W, sy, sx). Returns (selected
    volume, first-argmin flat index (H, W) int32).

    The cascade always runs: pixels whose minimum is unique are frozen at
    iteration 0, which gives the result of the JAX package's ``lax.cond``
    without a device-to-host sync."""
    af = allowed.to(acc.dtype)
    _, cnt0, arg0 = _wta_stats(acc, allowed)
    inv = {ax: 1.0 / torch.clamp(af + _sh3(af, 1, ax) + _sh3(af, -1, ax),
                                 min=1.0)
           for ax in (2, 3)}
    v, sel, argsel, done = acc, acc, arg0, cnt0 <= 1
    for k in range(1, 7):
        ax = 3 if k <= 5 else 2
        v = _masked_mean3(v, af, inv[ax], ax)
        _, cnt_k, arg_k = _wta_stats(v, allowed)
        upd = ~done
        sel = torch.where(upd[..., None, None], v, sel)
        argsel = torch.where(upd, arg_k, argsel)
        done = done | (cnt_k <= 1)
    return sel, argsel


def volume_argmin_subpixel_plain(acc, subpixel: str, bad: float):
    """Plain PyTorch version of the kernel: WTA argmin over the aggregated
    volume (H, W, sy, sx) + subpixel. Bound flags come from the volume edge
    or an absent (== N_PATHS * bad) neighbour; at bounds the neighbour
    collapses onto the center. Returns (H, W, 2) float32 (dx, dy)."""
    h, w, sy, sx = acc.shape
    bad_total = N_PATHS * bad
    allowed = acc < bad_total - 0.5
    acc, best = _tie_smooth_select(acc, allowed)
    flat = acc.reshape(h, w, sy * sx)
    dx = best % sx
    dy = best // sx
    disp = torch.stack([dx, dy], -1)
    if subpixel == "none":
        return disp.to(torch.float32)
    # the 3x3 neighbourhood of each winner in the edge-extended volume,
    # z[0..8] with dx fastest (z[4] = center)
    idx = [(dy + jy).clamp(0, sy - 1) * sx + (dx + jx).clamp(0, sx - 1)
           for jy in (-1, 0, 1) for jx in (-1, 0, 1)]
    z = list(flat.gather(-1, torch.stack(idx, -1).long()).unbind(-1))
    absent = [t >= bad_total - 0.5 for t in z]
    left_b = (dx == 0) | absent[3]
    right_b = (dx == sx - 1) | absent[5]
    top_b = (dy == 0) | absent[1]
    bot_b = (dy == sy - 1) | absent[7]
    for k in (0, 3, 6):
        z[k] = torch.where(left_b, z[k + 1], z[k])
    for k in (2, 5, 8):
        z[k] = torch.where(right_b, z[k - 1], z[k])
    for k in (0, 1, 2):
        z[k] = torch.where(top_b, z[k + 3], z[k])
    for k in (6, 7, 8):
        z[k] = torch.where(bot_b, z[k - 3], z[k])
    if subpixel == "parabola":
        off_x, off_y = _parabola_2d(torch.stack(z, -1))
    else:
        off_x = _subpixel_1d(z[3], z[4], z[5], subpixel, left_b, right_b)
        off_y = _subpixel_1d(z[1], z[4], z[7], subpixel, top_b, bot_b)
    return disp.to(torch.float32) + torch.stack([off_x, off_y], -1)


def volume_argmin_subpixel(acc, subpixel: str, bad: float):
    """(H, W, sy, sx) float32 accumulated volume -> (H, W, 2) float32
    disparity (dx, dy) in the volume's cells: the winner with the
    tie-smoothing cascade plus the ``subpixel`` mode's offset (ref
    ``create_disparity_view`` + ``create_disparity_view_subpixel``,
    SGM.cc:1286-1614). ``bad``: the absent candidate's per-path value.

    CPU tensors run :func:`volume_argmin_subpixel_plain`; CUDA tensors
    launch the kernel (one launch, any (sy, sx), every mode) or raise."""
    global launches
    if acc.dim() != 4 or min(acc.shape) < 1:
        raise ArgumentErr("volume_argmin_subpixel: acc must be a non-empty "
                          "(H, W, sy, sx) volume")
    if subpixel not in _MODES:
        raise ArgumentErr(f"unknown SGM subpixel mode {subpixel!r}")
    if acc.device.type == "cpu":
        return volume_argmin_subpixel_plain(acc, subpixel, bad)
    if acc.device.type != "cuda":
        raise ArgumentErr(f"volume_argmin_subpixel: unsupported device {acc.device}")
    if acc.dtype != torch.float32:
        raise ArgumentErr("volume_argmin_subpixel: acc must be float32")
    acc = acc.contiguous()
    h, w, sy, sx = acc.shape
    out = torch.empty((h, w, 2), dtype=torch.float32, device=acc.device)
    lib = _library()
    npix = h * w
    nbytes = lib.vw_sgm_wta_scratch_bytes(npix, sy, sx)
    scratch = (torch.empty(nbytes, dtype=torch.uint8, device=acc.device)
               if nbytes > 0 else None)
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream(acc.device).cuda_stream
        err = lib.vw_sgm_wta(acc.data_ptr(), npix, sy, sx, N_PATHS * bad - 0.5,
                             _MODES[subpixel],
                             None if scratch is None else scratch.data_ptr(),
                             out.data_ptr(), stream)
    _build.check(err, "sgm_wta")
    launches += 1
    return out
