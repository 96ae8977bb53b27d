"""Port's pyramid correlator with the census, ternary-census and NCC costs,
and ``parabola_subpixel`` (``visionworkbench_torch/stereo/``), against the
JAX package on the CPU, on the same quantized numpy inputs.

Tolerances, each with its reason:

* one level: integer disparities and validity exact (exact window sums,
  as in ``tests/test_torch_sweep.py``); the parabola output allclose at
  rtol 1e-4 / atol 2e-4 (the JAX package's own pin: the port fits on nine
  planes, the JAX package with an einsum, so fp32 rounding differs).
* two levels: >= 99.5 % equal integer disparities among pixels valid in
  both and <= 0.5 % validity mismatch (blur rounding at the coarse level
  may flip near-tied winners).
* ``parabola_subpixel`` (fast and exact) on a smooth disparity field:
  rtol 1e-4 / atol 2e-4, as above; its nine cost planes are exact sums.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import _torch_threads, cuda, quantized  # noqa: F401
from visionworkbench_tpu.math.bbox import BBox2i as JBBox2i
from visionworkbench_tpu.stereo import pyramid_correlation as jpyr
from visionworkbench_tpu.stereo import subpixel as jsub
from visionworkbench_tpu.stereo.correlation import DisparityMap as JDisparityMap
from visionworkbench_torch.math.bbox import BBox2i
from visionworkbench_torch.stereo import pyramid_correlation as tpyr
from visionworkbench_torch.stereo import subpixel as tsub
from visionworkbench_torch.stereo.correlation import DisparityMap


def _pair(seed, h, w, shift):
    """Quantized texture with left(p) == right(p + shift)."""
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


@pytest.mark.parametrize("kw", [
    dict(cost_type="census", subpixel="parabola", consistency_threshold=1.0),
    dict(cost_type="ternary_census", census_window=7, subpixel="parabola"),
    dict(cost_type="ncc", subpixel="parabola", consistency_threshold=1.0),
    dict(cost_type="ternary_census", census_window=3),
])
def test_single_level_census_ncc_matches_jax(kw):
    left, right = _pair(80, 32, 40, (5, 1))
    td, tv, jd, jv = _run_both(left, right, (-4, -1, 10, 3), kernel_size=(5, 5),
                               tile_size=16, max_pyramid_levels=0, **kw)
    np.testing.assert_array_equal(tv, jv)
    if "subpixel" in kw:
        np.testing.assert_allclose(td, jd, rtol=1e-4, atol=2e-4)
        td = np.round(td)
    else:
        np.testing.assert_array_equal(td, jd)
    assert tv.mean() > 0.5
    assert (td[tv] == [5, 1]).all(-1).mean() > 0.9


@pytest.mark.parametrize("kw", [
    dict(cost_type="census", census_window=3, subpixel="parabola"),
    dict(cost_type="ternary_census", census_window=7, subpixel="parabola"),
    dict(cost_type="ncc", consistency_threshold=2.0),
])
def test_two_level_census_ncc_agreement(kw):
    left, right = _pair(81, 64, 64, (6, 1))
    td, tv, jd, jv = _run_both(left, right, (0, -1, 12, 3), kernel_size=(5, 5),
                               tile_size=16, max_pyramid_levels=2, **kw)
    both = tv & jv
    agree = (np.round(td[both]) == np.round(jd[both])).all(-1).mean()
    mismatch = (tv != jv).mean()
    assert agree >= 0.995, agree
    assert mismatch <= 0.005, mismatch
    assert tv.mean() > 0.5


@pytest.mark.parametrize("exact", [False, True])
def test_parabola_subpixel_matches_jax(exact):
    left, right = _pair(82, 40, 48, (3, 1))
    rng = np.random.default_rng(83)
    disp = np.zeros((40, 48, 2), np.int32)
    disp[..., 0], disp[..., 1] = 3, 1        # the true shift (smooth: fits well posed)
    valid = rng.random((40, 48)) < 0.9
    t = tsub.parabola_subpixel(DisparityMap(torch.as_tensor(disp), torch.as_tensor(valid)),
                               left, right, (7, 5), exact=exact)
    j = jsub.parabola_subpixel(JDisparityMap(jnp.asarray(disp), jnp.asarray(valid)),
                               jnp.asarray(left), jnp.asarray(right), (7, 5), exact=exact)
    td = t.disparity.numpy()
    np.testing.assert_allclose(td, np.asarray(j.disparity), rtol=1e-4, atol=2e-4)
    np.testing.assert_array_equal(t.valid.numpy(), valid)
    assert td.dtype == np.float32 and (td[~valid] == 0).all()
    # away from the borders the fit stays within half a pixel of the true shift
    assert np.abs(td[5:35, 5:40][valid[5:35, 5:40]] - [3, 1]).max() < 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(cost_type="census", subpixel="parabola"),
    dict(cost_type="ternary_census", census_window=7, consistency_threshold=2.0),
    dict(cost_type="ncc", subpixel="parabola", consistency_threshold=2.0),
])
def test_card_matches_cpu_census_ncc(cuda, kw):
    """The slice on the card (CUDA sweep) against the CPU (plain versions):
    integer disparities and validity exact, parabola atol 1e-4."""
    left, right = _pair(84, 128, 128, (11, 1))
    args = (left, right, BBox2i(0, -2, 32, 4))
    opts = dict(kernel_size=(7, 7), tile_size=16, max_pyramid_levels=2, **kw)
    gd, gv = tpyr.pyramid_correlate(*args, device=cuda, **opts).to_numpy()
    cd, cv = tpyr.pyramid_correlate(*args, device="cpu", **opts).to_numpy()
    np.testing.assert_array_equal(gv, cv)
    np.testing.assert_allclose(gd, cd, rtol=0, atol=1e-4 if "subpixel" in kw else 0)
