"""Port's ``interpolate`` (``visionworkbench_torch/image/interpolation.py``)
and ``corr_eval`` (``visionworkbench_torch/stereo/correval.py``) against the
JAX package on the CPU.

Tolerances, each with its reason:

* ``interpolate``, every mode, with and without a channel axis, with
  coordinates past every border: bit for bit (elementwise, one operation a
  step in the JAX package's order, no reduction; the JAX package runs it
  eagerly, op by op, so no multiply-add fuses).
* ``corr_eval``: atol 2e-5 on windows with real texture (measured 1.1e-6
  for ncc, 6.0e-7 for stddev): the JAX package's jitted window sums contract into FMAs, the
  port rounds each product. Invalid pixels give exactly 0 in both.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torch_parity import _torch_threads  # noqa: F401
from visionworkbench_tpu.image import interpolation as ji
from visionworkbench_tpu.stereo import correval as jc
from visionworkbench_tpu.stereo.correlation import DisparityMap as JDM
from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.image import interpolation as ti
from visionworkbench_torch.stereo import correval as tc
from visionworkbench_torch.stereo.correlation import DisparityMap as TDM


@pytest.mark.parametrize("method", ti.METHODS)
@pytest.mark.parametrize("channels", [0, 3])
def test_interpolate_matches_jax(method, channels):
    rng = np.random.default_rng(30 + channels)
    shape = (20, 23) + ((channels,) if channels else ())
    img = rng.random(shape).astype(np.float32)
    # coordinates past every border, plus exact integers and half-pixels
    x = (rng.random((15, 17)) * 31 - 4).astype(np.float32)
    y = (rng.random((15, 17)) * 28 - 4).astype(np.float32)
    x[0, :6] = [-0.5, 0.5, 1.0, 21.5, 22.0, 22.5]
    y[1, :4] = [-1.0, 0.5, 19.0, 19.5]
    want = np.asarray(ji.interpolate(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y),
                                     method))
    got = ti.interpolate(torch.as_tensor(img), torch.as_tensor(x), torch.as_tensor(y),
                         method)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    sampler = ti.interpolate_image(torch.as_tensor(img), method)
    np.testing.assert_array_equal(sampler(x, y).numpy(), want)
    np.testing.assert_array_equal(ti.interpolate(img, x, y, method, device="cpu").numpy(),
                                  want)
    assert ti.pixel_buffer(method) == ji.pixel_buffer(method)


def test_interpolate_integer_image_and_bad_method():
    img = np.arange(30, dtype=np.int32).reshape(5, 6)
    x = np.array([[0.25, 4.75, -2.0]], np.float32)
    y = np.array([[1.5, 3.25, 9.0]], np.float32)
    for m in ti.METHODS:
        np.testing.assert_array_equal(
            ti.interpolate(torch.as_tensor(img), x, y, m).numpy(),
            np.asarray(ji.interpolate(jnp.asarray(img), x, y, m)))
    with pytest.raises(ArgumentErr):
        ti.interpolate(torch.as_tensor(img), x, y, "lanczos")


def _corr_scene(h=40, w=44, seed=31):
    """Textured pair with right(p + (2, 1)) ~= left(p), integer disparities
    scattered around the truth, some invalid."""
    rng = np.random.default_rng(seed)
    tex = rng.random((h + 8, w + 8)).astype(np.float32)
    left = tex[2:2 + h, 2:2 + w].copy()
    right = (tex[1:1 + h, 0:w] + 0.05 * rng.random((h, w))).astype(np.float32)
    d = np.stack([np.full((h, w), 2), np.full((h, w), 1)], -1).astype(np.int32)
    d += rng.integers(-1, 2, d.shape).astype(np.int32)
    valid = rng.random((h, w)) < 0.9
    return left, right, d, valid


@pytest.mark.parametrize("metric", ["ncc", "stddev"])
def test_corr_eval_matches_jax(metric):
    left, right, d, valid = _corr_scene()
    want = np.asarray(jc.corr_eval(JDM(jnp.asarray(d), jnp.asarray(valid)),
                                   jnp.asarray(left), jnp.asarray(right), (7, 5), metric))
    got = tc.corr_eval(TDM(torch.as_tensor(d), torch.as_tensor(valid)), left, right,
                       (7, 5), metric).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[~valid], 0.0)
    np.testing.assert_array_equal(want[~valid], 0.0)
    # windows whose right samples stay inside the frame (real texture)
    core = np.s_[4:-6, 4:-8]
    np.testing.assert_allclose(got[core], want[core], rtol=0, atol=2e-5)
    lo = -1.0 if metric == "ncc" else 0.0
    assert got[core].min() >= lo - 1e-5 and got[core].max() <= 1.0 + 1e-5
    with pytest.raises(ArgumentErr):
        tc.corr_eval(TDM(torch.as_tensor(d), torch.as_tensor(valid)), left, right,
                     (7, 5), "sad")
