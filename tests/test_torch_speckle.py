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
