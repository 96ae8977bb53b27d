"""Port's iterative subpixel refiners (``visionworkbench_torch/stereo/
subpixel_refine.py``) against the loop-faithful NumPy oracle
(``tests/oracle/vw_oracle_em.py``) and the JAX package, on the CPU.

Tolerances, each with its reason:

* ``_weight_template``: bit for bit with the JAX package (the same NumPy
  code); against the oracle at the JAX package's own rtol 2e-6.
* One outer iteration of the Bayes-EM and plain-affine refiners (re-warp
  mode) against the oracle: all pixels valid in both, median |dd| < 1e-5,
  max < 5e-4 — the JAX package's own pins (``tests/test_em_oracle_parity.py``;
  measured here: EM median 3.3e-7, max 7.1e-5; affine 2.1e-7 / 1.4e-6).
  Not bit for bit: the oracle sums serially in float64 where the dense
  refiner sums fp32 tap stacks.
* The sparse-neighbourhood invalidation: exact (a validity decision).
* ``lk_subpixel`` and ``phase_subpixel`` against the JAX package:
  validity equal; LK within 2e-5 px (measured 5.5e-6: XLA contracts the
  window sums into FMAs, the port rounds each product), phase within 1e-6
  (measured exact: the peaks are unambiguous, the offsets multiples of
  1/8, the Hann window equal bit for bit). ``affine_subpixel`` is held in
  ``tests/test_torch_subpixel_pyramid.py``.
* ``bayes_em_subpixel`` over two levels against the JAX package: validity
  equal on >= 99.5 % of pixels, on pixels valid in both the median |dd|
  below 1e-5 and >= 98 % within 1e-3 px (an iterative solver whose
  early-stop branches flip on last-ulp differences; XLA's ``exp`` is not
  PyTorch's).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torch_parity import (  # noqa: F401
    _torch_threads, agreement, oracle_scene, run_vs_oracle, sine_scene,
)
from visionworkbench_tpu.stereo import subpixel_refine as jr
from visionworkbench_tpu.stereo.correlation import DisparityMap as JDM
from visionworkbench_torch.stereo import subpixel_refine as tr
from visionworkbench_torch.stereo.correlation import DisparityMap as TDM


@pytest.mark.parametrize("kw,kh", [(9, 9), (7, 7), (21, 21), (7, 5)])
def test_weight_template_matches_jax_and_oracle(kw, kh):
    from oracle import vw_oracle_em as ora
    got = tr._weight_template(kw, kh)
    np.testing.assert_array_equal(got, np.asarray(jr._weight_template(kw, kh)))
    ref = ora.compute_spatial_weight_image(kw, kh, 2.0 * (kw / 5.0) ** 2)
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=1e-9)


@pytest.mark.parametrize("em_iters", [2, 0], ids=["bayes_em", "plain_affine"])
def test_single_iteration_update_matches_oracle(monkeypatch, em_iters):
    """One outer iteration: sampling, mixture weights, moment sums and the
    6x6 solve update for update; no stop rule can hide drift."""
    od, ov, td, tv = run_vs_oracle(monkeypatch, em_iters, outer_iters=1)
    assert ov.all() and tv.all()
    delta = np.abs(td - od).max(axis=-1)
    assert np.median(delta) < 1e-5, np.median(delta)
    assert delta.max() < 5e-4, delta.max()


def test_sparse_neighbourhood_invalidates(monkeypatch):
    """good_pixels < kern_pixels / 2 invalidates, in the oracle and the
    port: a lone valid pixel in an invalid block."""
    from oracle import vw_oracle_em as ora
    h = w = 32
    left, right = oracle_scene(h, w)
    disp0 = np.zeros((h, w, 2), np.float32)
    valid0 = np.ones((h, w), bool)
    valid0[10:30, 10:30] = False
    valid0[16, 16] = True
    _, ov = ora.subpixel_optimized_affine_2d_em(
        disp0.copy(), valid0.copy(), left, right, 9, 9)
    assert not ov[16, 16]
    monkeypatch.setenv("VWTPU_EM_REWARP", "1")
    out = tr.bayes_em_subpixel(
        TDM(torch.as_tensor(disp0), torch.as_tensor(valid0)), left, right, (9, 9),
        em_iters=2, outer_iters=10, max_pyramid_levels=0)
    tv = out.valid.numpy()
    assert not tv[16, 16]
    assert not tv[valid0 == 0].any()


def _both(j, t):
    jd, jv = np.asarray(j.disparity), np.asarray(j.valid)
    td, tv = t.to_numpy()
    return jd, jv, td, tv


def _seed(h, w, value, dtype):
    d = np.zeros((h, w, 2), dtype)
    d[..., 0], d[..., 1] = value
    return d, np.ones((h, w), bool)


def test_lk_subpixel_matches_jax():
    h = w = 44
    left, right = sine_scene(h, w, (0.3, -0.2))
    d0, v0 = _seed(h, w, (0, 0), np.int32)
    j = jr.lk_subpixel(JDM(jnp.asarray(d0), jnp.asarray(v0)), jnp.asarray(left),
                       jnp.asarray(right), (5, 5), iterations=3)
    t = tr.lk_subpixel(TDM(torch.as_tensor(d0), torch.as_tensor(v0)), left, right,
                       (5, 5), iterations=3)
    jd, jv, td, tv = _both(j, t)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(td, jd, rtol=0, atol=2e-5)
    core = td[12:-12, 12:-12]
    assert abs(core[..., 0].mean() - 0.3) < 0.07 and abs(core[..., 1].mean() + 0.2) < 0.07


def test_phase_subpixel_matches_jax():
    h = w = 72
    left, right = sine_scene(h, w, (0.5, 0.25))
    d0, v0 = _seed(h, w, (0, 0), np.int32)
    v0[:3] = False     # the window alignment averages the valid pixels only
    j = jr.phase_subpixel(JDM(jnp.asarray(d0), jnp.asarray(v0)), jnp.asarray(left),
                          jnp.asarray(right), window=32, stride=8, upsample=8)
    t = tr.phase_subpixel(TDM(torch.as_tensor(d0), torch.as_tensor(v0)), left, right,
                          window=32, stride=8, upsample=8)
    jd, jv, td, tv = _both(j, t)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(td, jd, rtol=0, atol=1e-6)
    core = td[20:-20, 20:-20]
    assert abs(core[..., 0].mean() - 0.5) < 0.15 and abs(core[..., 1].mean() - 0.25) < 0.15


def test_hanning_matches_jax():
    for n in (1, 2, 16, 31, 32):
        np.testing.assert_array_equal(tr._hanning(n, "cpu").numpy(),
                                      np.asarray(jnp.hanning(n)))


def test_bayes_em_pyramid_matches_jax():
    """Two levels (192^2 and its 96^2 decimation): decimation,
    ``disparity_subsample`` seeds, the wrap-around box mean of the coarse
    correction and the upsample. Measured: validity 99.992 % equal, |dd|
    median 2.4e-7, 0.9917 within 1e-3 (held above 0.98)."""
    n = 192
    true = (2.3, 1.25)
    left, right = sine_scene(n, n, true)
    d0 = np.zeros((n, n, 2), np.float32)
    d0[..., 0], d0[..., 1] = 2, 1
    v0 = np.ones((n, n), bool)
    v0[40:60, 100:130] = False
    kw = dict(em_iters=2, outer_iters=1, max_pyramid_levels=1)
    j = jr.bayes_em_subpixel(JDM(jnp.asarray(d0), jnp.asarray(v0)), jnp.asarray(left),
                             jnp.asarray(right), (7, 7), **kw)
    t = tr.bayes_em_subpixel(TDM(torch.as_tensor(d0), torch.as_tensor(v0)), left,
                             right, (7, 7), **kw)
    jd, jv = np.asarray(j.disparity), np.asarray(j.valid)
    td, tv = t.to_numpy()
    agree, dd = agreement(jd, jv, td, tv)
    print(f"levels 1: valid {tv.mean():.4f}, validity agrees {agree:.5f}, |dd| "
          f"median {np.median(dd):.3g}, max {dd.max():.3g}, "
          f"within 1e-3 {(dd < 1e-3).mean():.5f}")
    assert agree >= 0.995, agree
    assert np.median(dd) < 1e-5
    assert (dd < 1e-3).mean() > 0.98
    core = np.s_[8:-8, 8:-8]
    assert np.median(np.abs(td[core][..., 0] - true[0])[tv[core]]) < 0.2
