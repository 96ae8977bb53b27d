"""Port's speckle stencil (``visionworkbench_torch/ops/speckle.py``) and the
integer speckle filter built on it (``stereo/disparity._rm_outliers_int``)
against the JAX package's ``_rm_outliers_int`` on the CPU.

Tolerance: exact — the filter is integer arithmetic on packed codes.
Frames include shapes that are multiples of neither 8 nor 128 (the TPU
kernel's condition, dropped by the port). The CUDA kernel is held against
the plain version on the card (skipped without one).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import _torch_threads, cuda  # noqa: F401
from visionworkbench_tpu.stereo import disparity as jdisp
from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.ops import speckle as tspeckle
from visionworkbench_torch.stereo import disparity as tdisp

# (h, w, half_h, half_v, pixel_threshold, rejection_threshold): the pyramid's
# two passes (5, 5, 3, 0.5) and (1, 1, 3, 0.2), an asymmetric window, and
# frames that are not multiples of 8 or 128
CASES = [
    (64, 64, 5, 5, 3.0, 0.5),
    (37, 53, 1, 1, 3.0, 0.2),
    (29, 70, 2, 3, 2.0, 0.6),
    (3, 130, 5, 5, 3.0, 0.5),
]


def _disparities(seed, h, w):
    """Integer disparities that mostly agree locally, with outliers and
    invalid pixels, so both keep and reject decisions occur."""
    rng = np.random.default_rng(seed)
    dx = 16 + rng.integers(-2, 3, (h, w))
    dx = np.where(rng.random((h, w)) < 0.2, rng.integers(-40, 60, (h, w)), dx)
    dy = rng.integers(-4, 5, (h, w))
    disp = np.stack([dx, dy], -1).astype(np.int32)
    valid = rng.random((h, w)) > 0.15
    return disp, valid


@pytest.mark.parametrize("case", CASES)
def test_rm_outliers_int_matches_jax(case):
    h, w, hh, hv, t, rej = case
    disp, valid = _disparities(21, h, w)
    td, tv = tdisp._rm_outliers_int(torch.as_tensor(disp), torch.as_tensor(valid),
                                    hh, hv, t, rej)
    jd, jv = jdisp._rm_outliers_int(jnp.asarray(disp), jnp.asarray(valid),
                                    hh, hv, t, rej)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert 0 < tv.numpy().sum() < valid.sum()     # some kept, some rejected


@pytest.mark.parametrize("case", CASES)
def test_keep_mask_matches_jax_window_count(case):
    """The stencil alone: keep == (valid after the JAX filter) where valid."""
    h, w, hh, hv, t, rej = case
    disp, valid = _disparities(22, h, w)
    code = tdisp._pack_code(torch.as_tensor(disp), torch.as_tensor(valid))
    total = (2 * hh + 1) * (2 * hv + 1)
    keep = tspeckle.speckle_keep_mask(code, hh, hv, int(t),
                                      tdisp._min_match(total, rej)).numpy()
    assert keep.dtype == np.int32 and keep.shape == (h, w)
    _, jv = jdisp._rm_outliers_int(jnp.asarray(disp), jnp.asarray(valid),
                                   hh, hv, t, rej)
    np.testing.assert_array_equal((keep != 0) & valid, np.asarray(jv))


def test_keep_mask_rejects_bad_input():
    with pytest.raises(ArgumentErr):
        tspeckle.speckle_keep_mask(torch.zeros((4,), dtype=torch.int32), 1, 1, 3, 2)
    with pytest.raises(ArgumentErr):
        tspeckle.speckle_keep_mask(torch.zeros((4, 4), dtype=torch.int32), -1, 1, 3, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES + [(1000, 777, 5, 5, 3.0, 0.5)])
def test_keep_mask_kernel_matches_plain(cuda, case):
    h, w, hh, hv, t, rej = case
    disp, valid = _disparities(23, h, w)
    code = tdisp._pack_code(torch.as_tensor(disp, device=cuda),
                            torch.as_tensor(valid, device=cuda))
    args = (code, hh, hv, int(t), tdisp._min_match((2 * hh + 1) * (2 * hv + 1), rej))
    before = tspeckle.launches
    got = tspeckle.speckle_keep_mask(*args)
    assert tspeckle.launches == before + 1
    ref = tspeckle.speckle_keep_mask_plain(*args)
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())


# (h, w, half_h, half_v, t, min_match): hh != hv both ways, half windows of
# 0, t = 0, min_match 1 and the whole window, a window of more rows than
# one pass of the kernel (15: passes of 11 and 4), a 5x3 frame (smaller
# than a block and than the window)
EDGE_CASES = [
    (70, 45, 5, 1, 3, 20),
    (45, 70, 1, 5, 3, 20),
    (33, 40, 0, 2, 3, 3),
    (40, 33, 3, 0, 3, 4),
    (20, 21, 0, 0, 3, 1),
    (64, 50, 2, 2, 0, 8),
    (64, 50, 5, 5, 3, 1),
    (64, 50, 5, 5, 3, 121),
    (50, 64, 2, 7, 2, 40),
    (5, 3, 5, 5, 3, 61),
]


def _strip_model(code, hh, hv, t, min_match, rows_max=11, strip=8, bx=32, by=4):
    """csrc/speckle.cu's decomposition on the CPU: blocks of bx x (by *
    strip) pixels staging their tile plus the halo (indices clamped to the
    frame) as (hi, lo) field pairs in floats, a thread's strip of ``strip``
    centres of one column, the window's rows in passes of R = min(2 hv + 1,
    rows_max) rows, each pass loading strip + R - 1 staged rows a neighbour
    column, a pair counted as sat(t + 1 - max(|dhi|, |dlo|))."""
    h, w = code.shape
    tile_h = by * strip
    r_pass = min(2 * hv + 1, rows_max)
    passes = -(-(2 * hv + 1) // r_pass)
    tp1 = np.float32(min(max(t, -1), 1 << 18) + 1)
    keep = np.zeros((h, w), np.int32)
    sw, sh = bx + 2 * hh, tile_h + passes * r_pass - 1
    for gy0 in range(0, h, tile_h):
        for gx0 in range(0, w, bx):
            rr = np.clip(gy0 - hv + np.arange(sh), 0, h - 1)
            cc = np.clip(gx0 - hh + np.arange(sw), 0, w - 1)
            staged = code[rr[:, None], cc[None, :]]
            hi = (staged >> 14).astype(np.float32)
            lo = (staged & 0x3FFF).astype(np.float32)
            tx = np.arange(bx)
            for ry in range(0, tile_h, strip):
                chi = hi[ry + hv:ry + hv + strip, tx + hh]       # (strip, bx)
                clo = lo[ry + hv:ry + hv + strip, tx + hh]
                cnt = np.zeros((strip, bx), np.float32)
                for i0 in range(0, 2 * hv + 1, r_pass):
                    rows = min(r_pass, 2 * hv + 1 - i0)
                    for j in range(2 * hh + 1):
                        nhi = hi[ry + i0:ry + i0 + strip + r_pass - 1, tx + j]
                        nlo = lo[ry + i0:ry + i0 + strip + r_pass - 1, tx + j]
                        for i in range(rows):
                            m = np.maximum(np.abs(nhi[i:i + strip] - chi),
                                           np.abs(nlo[i:i + strip] - clo))
                            cnt += np.clip(tp1 - m, 0, 1)
                out = keep[gy0 + ry:gy0 + ry + strip, gx0:gx0 + bx]   # cut at the frame
                out[...] = cnt[:out.shape[0], :out.shape[1]].astype(np.int32) >= min_match
    return keep


@pytest.mark.parametrize("case", EDGE_CASES + [(45, 70, 1, 5, -1, 1), (45, 70, 1, 5, 1 << 20, 15)])
def test_strip_model_matches_plain(case):
    """The kernel's decomposition (staging, strips, passes of rows, the
    float pair test, t clamped to [-1, 2^18]) equals the plain version on
    codes of valid and invalid pixels, any field values of a packed code."""
    h, w, hh, hv, t, min_match = case
    disp, valid = _disparities(24, h, w)
    code = tdisp._pack_code(torch.as_tensor(disp), torch.as_tensor(valid))
    ref = tspeckle.speckle_keep_mask_plain(code, hh, hv, t, min_match).numpy()
    np.testing.assert_array_equal(_strip_model(code.numpy(), hh, hv, t, min_match), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("case", EDGE_CASES)
def test_keep_mask_kernel_edge_cases(cuda, case):
    """The kernel at hh != hv, half windows of 0, t = 0, min_match 1 and the
    whole window, rows in two passes and a 5x3 frame equals the plain
    version."""
    h, w, hh, hv, t, min_match = case
    disp, valid = _disparities(25, h, w)
    code = tdisp._pack_code(torch.as_tensor(disp, device=cuda),
                            torch.as_tensor(valid, device=cuda))
    before = tspeckle.launches
    got = tspeckle.speckle_keep_mask(code, hh, hv, t, min_match)
    assert tspeckle.launches == before + 1
    ref = tspeckle.speckle_keep_mask_plain(code, hh, hv, t, min_match)
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())
