"""Port's pyramid block-matching correlator (``visionworkbench_torch/stereo/
pyramid_correlation.py``) and its image helpers against the JAX package on
the CPU, on the same quantized numpy inputs.

Tolerances, each with its reason:

* ``crop_extended``/``edge_extend``, ``_mask_downsample``, ``_tile_offsets``,
  ``max_pyramid_levels_for``: exact (integer or copy operations).
* ``_blur_downsample``: allclose at rtol 1e-6 — the port sums the five taps
  in order, the JAX package through banded matmuls, so fp32 rounding may
  differ; one level of a 1/256-grid image is exact in any order.
* ``pyramid_correlate`` with ``max_pyramid_levels=0``: integer disparities
  and validity exact (plain, L<->R-checked and masked runs); the parabola
  output allclose at rtol 1e-4 / atol 2e-4 (the JAX package's own pin).
* ``pyramid_correlate`` in SGM/MGM mode at one level: exact (integer-valued
  census costs and aggregation).
* multi-level ``pyramid_correlate``: >= 99.5 % equal integer disparities
  among pixels valid in both and <= 0.5 % validity mismatch — blur rounding
  at coarse levels may flip near-tied winners there.
* the options (LoG and mean-subtract prefilters, the blob filter,
  ``keep_levels``, ``corr_timeout``, MGM with LoG): the floor is the same
  99.5 %, but each measured exact, so equality is asserted (each test
  states its measurement); the parabola output as above.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import _torch_threads, cuda, quantized  # noqa: F401
from visionworkbench_tpu.image import edge as jedge
from visionworkbench_tpu.image.filters import (
    generate_pyramid_smoothing_kernel as jkernel,
)
from visionworkbench_tpu.math.bbox import BBox2i as JBBox2i
from visionworkbench_tpu.stereo import pyramid_correlation as jpyr
from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.image import edge as tedge
from visionworkbench_torch.image.filters import (
    generate_pyramid_smoothing_kernel as tkernel,
)
from visionworkbench_torch.math.bbox import BBox2i
from visionworkbench_torch.stereo import pyramid_correlation as tpyr


def _pair(seed, h, w, shift=(5, 1)):
    """Quantized texture with left(p) == right(p + shift): the true
    disparity is ``shift`` (dx, dy)."""
    rng = np.random.default_rng(seed)
    tex = quantized(rng, (h + 16, w + 32))
    left = tex[8:8 + h, 16:16 + w].copy()
    right = tex[8 - shift[1]:8 - shift[1] + h, 16 - shift[0]:16 - shift[0] + w].copy()
    return left, right


def _run_both(left, right, search, **kw):
    t = tpyr.pyramid_correlate(left, right, BBox2i(*search), device="cpu", **kw)
    j = jpyr.pyramid_correlate(jnp.asarray(left), jnp.asarray(right),
                               JBBox2i(*search), **kw)
    td, tv = t.to_numpy()
    return td, tv, np.asarray(j.disparity), np.asarray(j.valid)


# ---- image helpers -----------------------------------------------------------

@pytest.mark.parametrize("mode", ["constant", "zero"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32, bool])
def test_crop_and_edge_extend_match_jax(mode, dtype):
    rng = np.random.default_rng(50)
    img = (rng.random((7, 9, 2)) * 100).astype(dtype)
    for x0, y0, w, h in [(-3, -2, 15, 12), (4, 5, 8, 6), (-1, 3, 5, 2), (2, 1, 3, 4)]:
        np.testing.assert_array_equal(
            tedge.crop_extended(torch.as_tensor(img), x0, y0, w, h, mode).numpy(),
            np.asarray(jedge.crop_extended(jnp.asarray(img), x0, y0, w, h, mode)))
    np.testing.assert_array_equal(
        tedge.edge_extend(torch.as_tensor(img), (2, 3), 1, mode).numpy(),
        np.asarray(jedge.edge_extend(jnp.asarray(img), (2, 3), 1, mode)))
    with pytest.raises(ArgumentErr):
        tedge.crop_extended(torch.as_tensor(img), 0, 0, 2, 2, "mirror")


def test_pyramid_kernel_and_level_count_match_jax():
    np.testing.assert_array_equal(tkernel(), jkernel())
    for (w, h, k, s, req) in [(1024, 1024, (15, 15), (0, -4, 64, 8), 4),
                              (128, 96, (7, 5), (-8, -2, 16, 4), 5),
                              (30, 500, (21, 21), (0, 0, 3, 1), 3)]:
        assert (tpyr.max_pyramid_levels_for(w, h, k, BBox2i(*s), req)
                == jpyr.max_pyramid_levels_for(w, h, k, JBBox2i(*s), req))


@pytest.mark.parametrize("shape", [(33, 47), (64, 64), (5, 2)])
def test_blur_downsample_matches_jax(shape):
    rng = np.random.default_rng(51)
    img = rng.random(shape, np.float32)
    got = tpyr._blur_downsample(torch.as_tensor(img)).numpy()
    ref = np.asarray(jpyr._blur_downsample(jnp.asarray(img)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    q = quantized(rng, shape)
    np.testing.assert_array_equal(tpyr._blur_downsample(torch.as_tensor(q)).numpy(),
                                  np.asarray(jpyr._blur_downsample(jnp.asarray(q))))


@pytest.mark.parametrize("shape", [(33, 47), (8, 8), (1, 3)])
def test_mask_downsample_matches_jax(shape):
    m = np.random.default_rng(52).random(shape) < 0.6
    np.testing.assert_array_equal(
        tpyr._mask_downsample(torch.as_tensor(m)).numpy(),
        np.asarray(jpyr._mask_downsample(jnp.asarray(m))))


@pytest.mark.parametrize("p_valid", [0.7, 0.02, 0.0])
def test_tile_offsets_match_jax(p_valid):
    rng = np.random.default_rng(53)
    tile, h, w = 8, 24, 40
    disp = np.stack([rng.integers(-3, 30, (h, w)), rng.integers(-2, 6, (h, w))],
                    -1).astype(np.int32)
    valid = rng.random((h, w)) < p_valid
    got = tpyr._tile_offsets(torch.as_tensor(disp), torch.as_tensor(valid),
                             tile, 2, 17, 3)
    ref = jpyr._tile_offsets(jnp.asarray(disp), jnp.asarray(valid), tile, 2, 17, 3)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---- the correlator ----------------------------------------------------------

LEVEL0 = dict(kernel_size=(7, 5), tile_size=16, max_pyramid_levels=0)


@pytest.mark.parametrize("name,kw", [
    ("plain", dict(cost_type="abs")),
    ("consistency", dict(cost_type="sq", consistency_threshold=1.0)),
    ("masked", dict(cost_type="abs", masks=True)),
])
def test_single_level_exact(name, kw):
    left, right = _pair(60, 48, 56)
    kw = dict(kw)
    if kw.pop("masks", False):
        rng = np.random.default_rng(61)
        lm = np.ones(left.shape, bool)
        lm[10:20, 5:30] = False
        rm = rng.random(right.shape) < 0.97
        kw.update(left_mask=lm, right_mask=rm)
    td, tv, jd, jv = _run_both(left, right, (-8, -2, 16, 4), **LEVEL0, **kw)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(td, jd)
    assert td.dtype == np.int32
    assert tv.mean() > 0.5
    assert (td[tv] == [5, 1]).all(axis=-1).mean() > 0.95


def test_single_level_parabola_allclose():
    left, right = _pair(62, 48, 56)
    td, tv, jd, jv = _run_both(left, right, (-8, -2, 16, 4), subpixel="parabola",
                               **LEVEL0)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(td, jd, rtol=1e-4, atol=2e-4)
    assert td.dtype == np.float32


@pytest.mark.parametrize("kw", [dict(subpixel="parabola"),
                                dict(consistency_threshold=2.0)])
def test_multi_level_agreement(kw):
    left, right = _pair(63, 128, 128, shift=(11, 1))
    td, tv, jd, jv = _run_both(left, right, (0, -2, 32, 4), kernel_size=(7, 7),
                               tile_size=16, max_pyramid_levels=2, **kw)
    both = tv & jv
    agree = (np.round(td[both]) == np.round(jd[both])).all(-1).mean()
    mismatch = (tv != jv).mean()
    assert agree >= 0.995, agree
    assert mismatch <= 0.005, mismatch
    assert tv.mean() > 0.5


@pytest.mark.parametrize("kw", [
    # census and NCC run (tests/test_torch_pyramid_census.py); a census
    # window with no variant and an unknown cost are still rejected
    dict(cost_type="census", census_window=4), dict(cost_type="xx"),
    # SGM/MGM run (test_sgm_mgm_small_frame_matches_jax), the prefilters,
    # corr_timeout, the blob filter and keep_levels too (the option tests
    # below), and subpixel affine / em in BM mode
    # (tests/test_torch_subpixel_pyramid.py); these are still rejected
    dict(stereo_algorithm="sgm", subpixel="affine"),
    dict(stereo_algorithm="xx"), dict(subpixel="bayes"), dict(subpixel="xx"),
    dict(prefilter_mode="xx"), dict(engine="xla"), dict(kernel_size=(4, 5)),
])
def test_options_not_in_this_slice_raise(kw):
    left, right = _pair(64, 16, 16)
    with pytest.raises(ArgumentErr):
        tpyr.pyramid_correlate(left, right, BBox2i(0, 0, 4, 2), device="cpu", **kw)


@pytest.mark.parametrize("algo", ["sgm", "mgm"])
def test_sgm_mgm_small_frame_matches_jax(algo):
    """The SGM/MGM branch on a 64^2 frame at one level: integer disparities
    and validity equal the JAX package's."""
    left, right = _pair(67, 64, 64, shift=(6, 1))
    td, tv, jd, jv = _run_both(left, right, (0, -1, 12, 3), stereo_algorithm=algo,
                               max_pyramid_levels=0, tile_size=32)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(td, jd)
    assert (td[tv] == [6, 1]).all(-1).mean() > 0.95


# ---- the options (prefilters, corr_timeout, blob filter, keep_levels) --------
#
# One JAX run per configuration, shared through module-scoped fixtures
# (the JAX package's compiles are most of these tests' time).

OPTS = dict(kernel_size=(7, 7), tile_size=16, max_pyramid_levels=3,
            prefilter_mode="log")
OPTS_SEARCH = (0, -2, 32, 4)
# corr_timeout: at 1e-6 s/op a 0.5 s budget leaves levels 3-1 whole and
# degrades level 0's 11x4 window to 4x4 (the R->L pass charged too).
TIMEOUT = dict(corr_timeout=0.5, seconds_per_op=1e-6, consistency_threshold=2.0,
               keep_levels=True)


def _noisy_pair(seed):
    """A 128^2 pair (true shift (11, 1)) whose right frame holds a block
    of fresh noise: the block's matches fail in scattered small blobs."""
    left, right = _pair(seed, 128, 128, shift=(11, 1))
    right[70:110, 20:70] = quantized(np.random.default_rng(seed + 1), (40, 50))
    return left, right


def _run_pair(left, right, search, **kw):
    t = tpyr.pyramid_correlate(left, right, BBox2i(*search), device="cpu", **kw)
    j = jpyr.pyramid_correlate(jnp.asarray(left), jnp.asarray(right),
                               JBBox2i(*search), **kw)
    return t, j


def _assert_same(t, j):
    td, tv = t.to_numpy()
    np.testing.assert_array_equal(tv, np.asarray(j.valid))
    np.testing.assert_array_equal(td, np.asarray(j.disparity))


@pytest.fixture(scope="module")
def log_runs():
    """The LoG BM pyramid at 3 levels: plain, and with the blob filter."""
    left, right = _noisy_pair(68)
    return {"plain": _run_pair(left, right, OPTS_SEARCH, **OPTS),
            "blob": _run_pair(left, right, OPTS_SEARCH, blob_filter_area=200, **OPTS),
            "pair": (left, right)}


@pytest.fixture(scope="module")
def timeout_run():
    left, right = _pair(69, 128, 128, shift=(11, 1))
    return _run_pair(left, right, OPTS_SEARCH, **OPTS, **TIMEOUT)


def test_log_three_level_pyramid_matches_jax(log_runs):
    """``prefilter_mode="log"`` on a 3-level BM pyramid (128^2, 7x7, tile
    16). The LoG images leave the 1/256 grid, so window sums may differ in
    the last ulp and flip a near-tied winner; the floor is 99.5 %
    agreement. Measured: integer disparities and validity equal at every
    pixel (100 %), so equality is asserted."""
    t, j = log_runs["plain"]
    _assert_same(t, j)
    td, tv = t.to_numpy()
    top = np.s_[8:60, 8:-16]              # away from the noise block
    assert tv[top].mean() > 0.95
    assert (td[top][tv[top]] == [11, 1]).all(-1).mean() > 0.95   # 0.981


def test_blob_filter_matches_jax(log_runs):
    """``blob_filter_area=200`` (25 at level 3, 200 at level 0): equal to
    the JAX package's, and it removed valid pixels the plain run keeps."""
    t, j = log_runs["blob"]
    _assert_same(t, j)
    plain_valid = log_runs["plain"][0].valid.numpy()
    assert (plain_valid & ~t.valid.numpy()).sum() > 0


def test_keep_levels_matches_jax(timeout_run):
    """``keep_levels=True``: a ``PyramidCorrResult`` with one map per level,
    coarsest first, of the JAX package's shapes and values."""
    t, j = timeout_run
    assert isinstance(t, tpyr.PyramidCorrResult)
    assert len(t.level_disparities) == len(j.level_disparities) == 4
    for level, (tl, jl) in zip(range(3, -1, -1), zip(t.level_disparities,
                                                     j.level_disparities)):
        side = -(-128 // (1 << level))
        assert tuple(tl.disparity.shape) == (side, side, 2)
        _assert_same(tl, jl)


def test_corr_timeout_matches_jax(timeout_run):
    """``corr_timeout`` with the same ``seconds_per_op`` in both packages:
    the same capped searches (level 0 degraded to 4x4) and the same
    result; the degraded window still holds the true shift."""
    plan = tpyr.level_searches(128, 128, 3, (32, 4), 11, None, 0.5, 1e-6, True)
    assert [p[3:] for p in plan] == [(4, 1), (8, 1), (11, 2), (4, 4)]
    t, j = timeout_run
    _assert_same(t.disparity, j.disparity)
    td, tv = t.disparity.to_numpy()
    core = np.s_[8:-8, 8:-16]
    assert (td[core][tv[core]] == [11, 1]).all(-1).mean() > 0.9    # 0.961


def test_cost_model_matches_jax():
    """The budget arithmetic is the JAX package's; the measured s/op is the
    port's own, kept per device type."""
    from visionworkbench_tpu.stereo import cost_model as jcm
    from visionworkbench_torch.stereo import cost_model as tcm
    for pixels, vol, budget, spo in [(1000, (8, 4), 0.0, 1.0), (10, (8, 4), 1e9, 1e-9),
                                     (1000, (8, 4), 1.0, 1.0), (10, (8, 4), 161, 1.0),
                                     (4096, (32, 2), 0.05, 1e-6), (7, (1, 9), 20, 1.0)]:
        assert (tcm.budget_search_volume(pixels, vol, budget, spo)
                == jcm.budget_search_volume(pixels, vol, budget, spo))
        assert (tcm.estimate_search_time(pixels, vol, spo)
                == jcm.estimate_search_time(pixels, vol, spo))
    spo = tcm.calc_seconds_per_op(0.0, device="cpu")
    assert 0 < spo < 1e-3
    assert tcm.seconds_per_op("cpu") == spo


def test_corr_timeout_without_seconds_per_op_measures_the_device():
    """With no ``seconds_per_op`` the budget uses the s/op measured on the
    run's device (the CPU here, kept per device type); a budget no search
    fits degrades every level to a 1x1 search, which still runs: one
    candidate is best and worst at once, so every pixel is invalid, with
    disparity 0 (the JAX package's degraded run too)."""
    from visionworkbench_torch.stereo import cost_model as tcm
    left, right = _pair(70, 64, 64, shift=(5, 1))
    dm = tpyr.pyramid_correlate(left, right, BBox2i(0, 0, 16, 4), kernel_size=(7, 7),
                                tile_size=16, max_pyramid_levels=1, corr_timeout=1e-12,
                                device="cpu")
    assert "cpu" in tcm._seconds_per_op
    d, v = dm.to_numpy()
    assert d.shape == (64, 64, 2)
    assert not v.any() and not d.any()


def test_meansub_ncc_parabola_matches_jax():
    """``prefilter_mode="meansub"`` with NCC and the parabola at one level:
    the re-evaluation prefilters the full-resolution images again.
    Measured: integer disparities and validity equal everywhere; the
    parabola output allclose at rtol 1e-4 / atol 2e-4 (the JAX package's
    own pin; 8.1e-6 measured)."""
    left, right = _pair(62, 48, 56)
    kw = dict(kernel_size=(7, 5), tile_size=16, max_pyramid_levels=0, cost_type="ncc",
              prefilter_mode="meansub")
    t, j = _run_pair(left, right, (-8, -2, 16, 4), subpixel="parabola", **kw)
    td, tv = t.to_numpy()
    np.testing.assert_array_equal(tv, np.asarray(j.valid))
    np.testing.assert_allclose(td, np.asarray(j.disparity), rtol=1e-4, atol=2e-4)
    assert (np.abs(td[tv] - [5, 1]) < 0.5).all(-1).mean() > 0.9    # 0.975


def test_mgm_log_small_frame_matches_jax():
    """MGM with the LoG prefilter at 64^2 and one level: equal to the JAX
    package's (the census codes of equal LoG images are equal)."""
    left, right = _pair(67, 64, 64, shift=(6, 1))
    t, j = _run_pair(left, right, (0, -1, 12, 3), stereo_algorithm="mgm",
                     max_pyramid_levels=0, tile_size=32, prefilter_mode="log")
    _assert_same(t, j)
    assert t.valid.numpy().mean() > 0.5


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    left, right = _pair(65, 16, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpyr.pyramid_correlate(left, right, BBox2i(0, 0, 4, 2))


def _card_masks(seed, shape):
    """A left mask with one masked block, a right mask with 3 % of its
    pixels masked."""
    rng = np.random.default_rng(seed)
    lm = np.ones(shape, bool)
    lm[20:44, 10:70] = False
    return lm, rng.random(shape) < 0.97


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(consistency_threshold=2.0),
                                dict(subpixel="parabola"),
                                dict(consistency_threshold=2.0, masks=True),
                                dict(subpixel="parabola", masks=True)])
def test_card_matches_cpu(cuda, kw):
    """Whole slice on the card (CUDA kernels) against the CPU (plain
    versions): integer disparities and validity exact, parabola atol 1e-4,
    also with left and right masks. The masked pixels' fill value is
    allclose at rtol 1e-6 between the devices: ``_mean_fill``'s sum runs
    in another order on each."""
    left, right = _pair(66, 128, 128, shift=(11, 1))
    args = (left, right, BBox2i(0, -2, 32, 4))
    kw = dict(kw)
    if kw.pop("masks", False):
        lm, rm = _card_masks(67, left.shape)
        kw.update(left_mask=lm, right_mask=rm)
        fill = [float(tpyr._mean_fill(torch.as_tensor(left, device=d),
                                      torch.as_tensor(lm, device=d), 128, 128)[20, 10])
                for d in (cuda, "cpu")]
        np.testing.assert_allclose(fill[0], fill[1], rtol=1e-6, atol=0)
    opts = dict(kernel_size=(7, 7), tile_size=16, max_pyramid_levels=2, **kw)
    gd, gv = tpyr.pyramid_correlate(*args, device=cuda, **opts).to_numpy()
    cd, cv = tpyr.pyramid_correlate(*args, device="cpu", **opts).to_numpy()
    np.testing.assert_array_equal(gv, cv)
    np.testing.assert_allclose(gd, cd, rtol=0, atol=1e-4 if "subpixel" in kw else 0)


@pytest.mark.cuda
def test_card_options_match_cpu(cuda):
    """The LoG pyramid with the blob filter and ``keep_levels`` on the card
    against the CPU: every level's integer disparities and validity
    equal."""
    left, right = _noisy_pair(68)
    opts = dict(OPTS, blob_filter_area=200, keep_levels=True)
    g = tpyr.pyramid_correlate(left, right, BBox2i(*OPTS_SEARCH), device=cuda, **opts)
    c = tpyr.pyramid_correlate(left, right, BBox2i(*OPTS_SEARCH), device="cpu", **opts)
    for gl, cl in zip(g.level_disparities + [g.disparity],
                      c.level_disparities + [c.disparity]):
        gd, gv = gl.to_numpy()
        cd, cv = cl.to_numpy()
        np.testing.assert_array_equal(gv, cv)
        np.testing.assert_array_equal(gd, cd)
