"""The quality-subpixel path of the port's pyramid correlator
(``pyramid_correlate(subpixel="em"|"affine")``: the Bayes-EM / affine
refiner at full resolution after census block matching, config 7's
settings on a 96^2 frame) and ``affine_subpixel`` against the JAX package
on the CPU. The JAX
package runs the refiner in its default warp-once mode here (no re-warp
test traces these shapes).

Tolerances, each with its reason: the integer correlator's disparities and
validity are the JAX package's (census costs are integers); the refiner is
an iterative fp32 solver whose early-stop branches flip on last-ulp
differences (XLA contracts its sums into FMAs, and its ``exp`` is not
PyTorch's), so for EM validity must agree on >= 99.5 % of pixels (measured
99.989 %), and on pixels valid in both the median |dd| is held below 1e-5
px (measured 0) and the share within 1e-3 px above 0.99 (measured 0.998).
The plain-affine refiner measured validity equal and 4.3e-6 px at most:
held within 1e-4.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torch_parity import _torch_threads, agreement, sine_scene  # noqa: F401
from visionworkbench_tpu.math.bbox import BBox2i as JBBox2i
from visionworkbench_tpu.stereo import pyramid_correlation as jpyr
from visionworkbench_tpu.stereo import subpixel_refine as jr
from visionworkbench_tpu.stereo.correlation import DisparityMap as JDM
from visionworkbench_torch.math.bbox import BBox2i
from visionworkbench_torch.stereo import pyramid_correlation as tpyr
from visionworkbench_torch.stereo import subpixel_refine as tr
from visionworkbench_torch.stereo.correlation import DisparityMap as TDM

N = 96
SEARCH = (0, -4, 64, 8)
CONFIG7 = dict(kernel_size=(7, 7), cost_type="census", census_window=5,
               max_pyramid_levels=4, tile_size=32)


def config7_pair(n, seed=11):
    """``tools_bench_configs.py`` config 7's texture in ``bench.py``'s
    orientation: left(p) = right(p + (16, 0))."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:n, 0:n + 80].astype(np.float32)
    tex = (np.sin(xs * 0.21) * np.cos(ys * 0.17)
           + 0.5 * np.sin(xs * 0.047 + ys * 0.031)
           + 0.3 * rng.random(xs.shape)).astype(np.float32)
    return tex[:, 16:16 + n].copy(), tex[:, :n].copy()


@pytest.mark.parametrize("subpixel", ["em", "affine"])
def test_pyramid_quality_subpixel_matches_jax(subpixel):
    left, right = config7_pair(N)
    j = jpyr.pyramid_correlate(jnp.asarray(left), jnp.asarray(right),
                               JBBox2i(*SEARCH), subpixel=subpixel, **CONFIG7)
    t = tpyr.pyramid_correlate(left, right, BBox2i(*SEARCH), subpixel=subpixel,
                               device="cpu", **CONFIG7)
    jd, jv = np.asarray(j.disparity), np.asarray(j.valid)
    td, tv = t.to_numpy()
    agree, dd = agreement(jd, jv, td, tv)
    print(f"{subpixel}: valid {tv.mean():.4f}, validity agrees {agree:.5f}, |dd| "
          f"median {np.median(dd):.3g}, max {dd.max():.3g}, "
          f"within 1e-3 {(dd < 1e-3).mean():.5f}")
    core = np.s_[16:-16, 16:-16]
    correct = (np.abs(td[core][..., 0] - 16.0) < 0.5)[tv[core]].mean()
    assert correct > 0.9, correct
    if subpixel == "affine":
        # measured: validity equal, max |dd| 4.3e-6
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_allclose(td, jd, rtol=0, atol=1e-4)
    else:
        assert agree >= 0.995, agree
        assert np.median(dd) < 1e-5
        assert (dd < 1e-3).mean() > 0.99


def test_affine_subpixel_matches_jax():
    """``affine_subpixel`` (5 outer iterations, a block of invalid seeds):
    validity equal, within 1e-4 px (the 6x6 solve on sums XLA fuses)."""
    h = w = 52
    true = (2.3, 1.25)
    left, right = sine_scene(h, w, true)
    d0 = np.zeros((h, w, 2), np.float32)
    d0[..., 0], d0[..., 1] = 2, 1
    v0 = np.ones((h, w), bool)
    v0[20:24, 30:33] = False
    j = jr.affine_subpixel(JDM(jnp.asarray(d0), jnp.asarray(v0)), jnp.asarray(left),
                           jnp.asarray(right), (7, 7), iterations=5)
    t = tr.affine_subpixel(TDM(torch.as_tensor(d0), torch.as_tensor(v0)), left, right,
                           (7, 7), iterations=5)
    jd, jv = np.asarray(j.disparity), np.asarray(j.valid)
    td, tv = t.to_numpy()
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(td, jd, rtol=0, atol=1e-4)
    core = np.s_[8:-8, 8:-8]
    assert np.median(np.abs(td[core][..., 0] - true[0])) < 0.1
