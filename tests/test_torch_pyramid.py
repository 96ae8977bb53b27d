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
        tedge.crop_extended(torch.as_tensor(img), 0, 0, 2, 2, "periodic")


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
    # SGM/MGM run (test_sgm_mgm_small_frame_matches_jax); these options
    # are still rejected in SGM mode
    dict(stereo_algorithm="sgm", subpixel="affine"),
    dict(stereo_algorithm="mgm", prefilter_mode="log"),
    dict(stereo_algorithm="xx"), dict(prefilter_mode="log"),
    dict(prefilter_mode="meansub"), dict(subpixel="affine"),
    dict(subpixel="xx"), dict(corr_timeout=1.0), dict(blob_filter_area=10),
    dict(keep_levels=True), dict(engine="xla"), dict(kernel_size=(4, 5)),
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
