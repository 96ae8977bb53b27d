"""Port's disparity utilities and parabola fit (``visionworkbench_torch/
stereo/disparity.py``, ``stereo/subpixel.py``) against the JAX package on
the CPU, on the same numpy inputs.

Tolerances: exact for the integer and mask operations (packing, upsample,
masks, L<->R check, two-pass cleanup), the float speckle filter and
cleanup, the disparity range, subsample and transform; ``std_dev_image``
allclose at rtol 1e-5 / atol 1e-5 (see its test); ``_fit_parabola`` allclose at
rtol 1e-4 / atol 2e-4, the pin the JAX package keeps between its own planes
and stack forms (fp32 summation order differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import _torch_threads  # noqa: F401
from visionworkbench_tpu.math.bbox import BBox2i as JBBox2i
from visionworkbench_tpu.stereo import disparity as jdisp
from visionworkbench_tpu.stereo import subpixel as jsub
from visionworkbench_tpu.stereo.correlation import DisparityMap as JDM
from visionworkbench_torch.math.bbox import BBox2i
from visionworkbench_torch.stereo import disparity as tdisp
from visionworkbench_torch.stereo import subpixel as tsub
from visionworkbench_torch.stereo.correlation import DisparityMap


def _dm(seed, h, w, lo=(-3, -2), hi=(9, 3), p_valid=0.8):
    rng = np.random.default_rng(seed)
    disp = np.stack([rng.integers(lo[0], hi[0], (h, w)),
                     rng.integers(lo[1], hi[1], (h, w))], -1).astype(np.int32)
    valid = rng.random((h, w)) < p_valid
    disp = np.where(valid[..., None], disp, 0).astype(np.int32)
    return disp, valid


def _both(disp, valid):
    return (DisparityMap.from_numpy(disp, valid, device="cpu"),
            JDM(jnp.asarray(disp), jnp.asarray(valid)))


def _assert_dm_equal(t, j):
    td, tv = t.to_numpy()
    np.testing.assert_array_equal(tv, np.asarray(j.valid))
    np.testing.assert_array_equal(td, np.asarray(j.disparity))


def test_disparity_map_numpy_round_trip():
    disp, valid = _dm(30, 5, 7)
    dm = DisparityMap.from_numpy(disp, valid, device="cpu")
    assert dm.disparity.dtype == torch.int32 and dm.valid.dtype == torch.bool
    d, v = dm.to_numpy()
    np.testing.assert_array_equal(d, disp)
    np.testing.assert_array_equal(v, valid)


def test_pack_code_and_min_match_match_jax():
    disp, valid = _dm(31, 16, 20, lo=(-9000, -20), hi=(9000, 20))
    np.testing.assert_array_equal(
        tdisp._pack_code(torch.as_tensor(disp), torch.as_tensor(valid)).numpy(),
        np.asarray(jdisp._pack_code(jnp.asarray(disp), jnp.asarray(valid))))
    for total in (9, 121, 35):
        for rej in (0.2, 0.5, 0.6, 1.0):
            assert tdisp._min_match(total, rej) == jdisp._min_match(total, rej)


def test_disparity_upsample_matches_jax():
    t, j = _both(*_dm(32, 9, 11))
    _assert_dm_equal(tdisp.disparity_upsample(t), jdisp.disparity_upsample(j))


def test_cross_corr_consistency_check_matches_jax():
    h, w = 24, 30
    l2r = _dm(33, h, w, lo=(0, 0), hi=(6, 2))
    r2l = _dm(34, h + 2, w + 6, lo=(-6, -2), hi=(1, 1))
    # make most pixels consistent so both outcomes occur
    r2l[0][:h, :w] = np.where(np.random.default_rng(35).random((h, w, 1)) < 0.7,
                              -l2r[0], r2l[0][:h, :w])
    tl, jl = _both(*l2r)
    tr, jr = _both(*r2l)
    for thr in (0.0, 2.0):
        t, tdiff = tdisp.cross_corr_consistency_check(tl, tr, thr, return_diff=True)
        j, jdiff = jdisp.cross_corr_consistency_check(jl, jr, thr, return_diff=True)
        _assert_dm_equal(t, j)
        np.testing.assert_array_equal(tdiff.numpy(), np.asarray(jdiff))


@pytest.mark.parametrize("bounds", [None, (0, 0, 6, 3)])
def test_disparity_mask_matches_jax(bounds):
    h, w = 20, 26
    t, j = _both(*_dm(36, h, w, lo=(0, 0), hi=(6, 3)))
    rng = np.random.default_rng(37)
    lm = rng.random((h, w)) < 0.9
    rm = rng.random((h + 4, w + 8)) < 0.9
    tb = None if bounds is None else BBox2i(*bounds)
    jb = None if bounds is None else JBBox2i(*bounds)
    _assert_dm_equal(
        tdisp.disparity_mask(t, torch.as_tensor(lm), torch.as_tensor(rm), tb),
        jdisp.disparity_mask(j, jnp.asarray(lm), jnp.asarray(rm), jb))


def test_cleanup_using_thresh_matches_jax():
    """The coarse levels' two-pass cleanup, on a field that mostly agrees."""
    disp, valid = _dm(38, 33, 41, lo=(4, 0), hi=(7, 2), p_valid=0.85)
    t, j = _both(disp, valid)
    _assert_dm_equal(
        tdisp.disparity_cleanup_using_thresh(t, 5, 5, 3.0, 0.5, integer_disparities=True),
        jdisp.disparity_cleanup_using_thresh(j, 5, 5, 3.0, 0.5, integer_disparities=True))


def _float_dm(seed, h, w, p_valid=0.85):
    """Subpixel disparities near (5, 1) with outliers, 1/8-grid and
    off-grid values, and some threshold-exact neighbour gaps."""
    rng = np.random.default_rng(seed)
    disp = np.stack([5 + rng.normal(0, 1.2, (h, w)), 1 + rng.normal(0, 0.8, (h, w))],
                    -1).astype(np.float32)
    disp[::3, ::2] = np.round(disp[::3, ::2] * 8) / 8
    disp[5:9, 10:14] = [5 + 3.0, 1.0]                      # exactly 3 px off
    disp[rng.random((h, w)) < 0.05] = [40.0, -9.0]          # outliers
    valid = rng.random((h, w)) < p_valid
    return np.where(valid[..., None], disp, 0).astype(np.float32), valid


@pytest.mark.parametrize("half,thr,rej", [((5, 5), 3.0, 0.5), ((1, 1), 3.0, 0.2),
                                          ((2, 4), 0.5, 0.6), ((3, 1), 1.25, 1.0)])
def test_float_speckle_filter_matches_jax(half, thr, rej):
    """``integer_disparities=False``: the float form (plain tensor work),
    exact."""
    t, j = _both(*_float_dm(42, 29, 37))
    _assert_dm_equal(tdisp.rm_outliers_using_thresh(t, *half, thr, rej),
                     jdisp.rm_outliers_using_thresh(j, *half, thr, rej))


def test_float_cleanup_and_integer_forms_agree_with_jax():
    """The float two-pass cleanup, exact; on integer disparities the float
    and the packed-code forms give the same map."""
    t, j = _both(*_float_dm(43, 33, 41))
    _assert_dm_equal(tdisp.disparity_cleanup_using_thresh(t, 5, 5, 3.0, 0.5),
                     jdisp.disparity_cleanup_using_thresh(j, 5, 5, 3.0, 0.5))
    ti, _ = _both(*_dm(44, 33, 41, lo=(3, 0), hi=(8, 2)))
    a = tdisp.disparity_cleanup_using_thresh(ti, 5, 5, 3.0, 0.5, integer_disparities=True)
    b = tdisp.disparity_cleanup_using_thresh(ti, 5, 5, 3.0, 0.5)
    np.testing.assert_array_equal(a.valid.numpy(), b.valid.numpy())
    np.testing.assert_array_equal(a.disparity.numpy(), b.disparity.numpy())


@pytest.mark.parametrize("float_disp", [False, True])
def test_get_disparity_range_matches_jax(float_disp):
    t, j = _both(*(_float_dm(45, 11, 13) if float_disp else _dm(45, 11, 13)))
    got, ref = tdisp.get_disparity_range(t), jdisp.get_disparity_range(j)
    assert (got.min_x, got.min_y, got.max_x, got.max_y) == \
        (ref.min_x, ref.min_y, ref.max_x, ref.max_y)
    empty = tdisp.get_disparity_range(DisparityMap(t.disparity, t.valid & False))
    assert (empty.width, empty.height) == (0, 0)


@pytest.mark.parametrize("shape", [(17, 23), (16, 16), (1, 5)])
def test_disparity_subsample_matches_jax(shape):
    for disp, valid in (_dm(46, *shape), _float_dm(47, *shape, p_valid=0.4)):
        t, j = _both(disp, valid)
        _assert_dm_equal(tdisp.disparity_subsample(t), jdisp.disparity_subsample(j))


def test_std_dev_image_allclose_to_jax():
    """Allclose at rtol 1e-5 / atol 1e-5: the JAX package takes the
    window sums as prefix-sum differences on frames of 64^2 or more, the
    port as direct sums; exact on a small quantized frame (both direct)."""
    rng = np.random.default_rng(48)
    img = (rng.random((70, 66)) * 4).astype(np.float32)
    for kw, kh in [(5, 5), (7, 3)]:
        np.testing.assert_allclose(tdisp.std_dev_image(torch.as_tensor(img), kw, kh).numpy(),
                                   np.asarray(jdisp.std_dev_image(jnp.asarray(img), kw, kh)),
                                   rtol=1e-5, atol=1e-5)
    q = (rng.integers(0, 256, (20, 24)) / 256).astype(np.float32)
    np.testing.assert_array_equal(tdisp.std_dev_image(torch.as_tensor(q), 5, 3).numpy(),
                                  np.asarray(jdisp.std_dev_image(jnp.asarray(q), 5, 3)))


def test_transform_disparities_matches_jax():
    t, j = _both(*_float_dm(49, 12, 15))

    def affine(x, y):
        return 1.25 * x - 0.5 * y + 3.0, 0.75 * y + 0.125 * x - 1.0
    _assert_dm_equal(tdisp.transform_disparities(t, affine),
                     jdisp.transform_disparities(j, affine))


@pytest.mark.parametrize("form", ["planes", "stack"])
def test_fit_parabola_matches_jax(form):
    h, w = 17, 23
    rng = np.random.default_rng(40)
    disp, valid = _dm(41, h, w)
    # bowls around the winner (a true minimum inside the 3x3) plus noise,
    # some flat patches (all nine equal) and some far-off stationary points
    yy, xx = np.meshgrid([-1.0, 0.0, 1.0], [-1.0, 0.0, 1.0], indexing="ij")
    cx, cy = rng.uniform(-0.6, 0.6, (2, h, w, 1))
    a, b = rng.uniform(0.5, 3.0, (2, h, w, 1))
    patch = (a * (xx.ravel() - cx) ** 2 + b * (yy.ravel() - cy) ** 2
             + 0.05 * rng.random((h, w, 9))).astype(np.float32)
    patch[::5, ::3] = 1.25
    patch[1::7, 2::5] = rng.random((9,)).astype(np.float32) * 0.01
    tin = tuple(torch.as_tensor(patch[..., k]) for k in range(9)) \
        if form == "planes" else torch.as_tensor(patch)
    jin = tuple(jnp.asarray(patch[..., k]) for k in range(9)) \
        if form == "planes" else jnp.asarray(patch)
    got = tsub._fit_parabola(tin, torch.as_tensor(disp), torch.as_tensor(valid)).numpy()
    ref = np.asarray(jsub._fit_parabola(jin, jnp.asarray(disp), jnp.asarray(valid)))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=2e-4)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got[~valid], 0.0)
