"""Port's single-level entry points ``best_of_search_convolution`` and
``calc_disparity`` (``visionworkbench_torch/stereo/correlation.py``) and the
first-generation searches of ``visionworkbench_torch/ops/cost_volume.py``
against the JAX package on the CPU, and against ``tests/oracle/vw_oracle.py``.

Tolerances, each with its reason:

* vs the JAX package, every cost: disparity, validity and best metric
  exact (inputs on the 1/256 grid make every window sum exact; census costs
  are small integers), NaN metrics of zero-energy NCC windows included.
* vs the oracle: abs/sq/census exact; NCC >= 99.8 % per-pixel agreement as
  ``docs/parity.md`` states (the oracle sums its windows in float64, so
  near-ties may flip).
* kernels 6 and 7 vs ``pallas_best_of_search`` / ``pallas_tiled_search``
  run with ``interpret=True``: exact, a flat window included so that kernel
  7's zeroed invalid disparities (offset included) are pinned.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import _torch_threads, cuda, quantized  # noqa: F401
from visionworkbench_tpu.math.bbox import BBox2i as JBBox2i
from visionworkbench_tpu.ops.cost_volume import (
    pallas_best_of_search, pallas_tiled_search,
)
from visionworkbench_tpu.stereo import correlation as jcorr
from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.math.bbox import BBox2i
from visionworkbench_torch.ops import cost_volume as tcv
from visionworkbench_torch.ops import sweep as tsweep
from visionworkbench_torch.stereo import correlation as tcorr

COSTS = ["abs", "sq", "ncc", "census", "ternary_census"]
WINDOW = {"census": 7, "ternary_census": 5}     # two-word codes


def _pair(seed, h, w, sx, sy, black=True):
    """left embedded in right at (2, 1); black blocks in both frames give
    zero-energy NCC windows (left) and NaN candidates (right)."""
    rng = np.random.default_rng(seed)
    left = quantized(rng, (h, w))
    right = quantized(rng, (h + sy - 1, w + sx - 1))
    right[1:1 + h, 2:2 + w] = left
    if black:
        left[4:12, 3:11] = 0.0
        right[8:16, 10:18] = 0.0
    return left, right


@pytest.mark.parametrize("cost", COSTS)
def test_best_of_search_convolution_matches_jax(cost):
    left, right = _pair(30, 20, 24, 4, 2)
    cw = WINDOW.get(cost, 5)
    dm, best = tcorr.best_of_search_convolution(left, right, (4, 2), (5, 5), cost, cw,
                                                return_cost=True, device="cpu")
    jdm, jbest = jcorr.best_of_search_convolution(jnp.asarray(left), jnp.asarray(right),
                                                  (4, 2), (5, 5), cost, cw,
                                                  return_cost=True)
    d, v = dm.to_numpy()
    np.testing.assert_array_equal(v, np.asarray(jdm.valid))
    np.testing.assert_array_equal(d, np.asarray(jdm.disparity))
    np.testing.assert_array_equal(best.numpy(), np.asarray(jbest))   # NaN == NaN
    assert d.shape == (16, 20, 2) and d.dtype == np.int32
    if cost == "ncc":
        nan = np.isnan(best.numpy())
        assert nan.sum() > 20 and v[nan].all()


@pytest.mark.parametrize("cost", COSTS)
def test_calc_disparity_matches_jax(cost):
    rng = np.random.default_rng(31)
    left_in = quantized(rng, (36, 40))
    right_in = quantized(rng, (38, 46))
    right_in[1:37, 3:43] = left_in
    left_in[10:20, 8:20] = 0.0
    right_in[11:21, 11:23] = 0.0
    cw = WINDOW.get(cost, 5)
    t = tcorr.calc_disparity(cost, left_in, right_in, BBox2i(2, 3, 30, 28), (5, 2),
                             (5, 3), census_window=cw, device="cpu")
    j = jcorr.calc_disparity(cost, jnp.asarray(left_in), jnp.asarray(right_in),
                             JBBox2i(2, 3, 30, 28), (5, 2), (5, 3), census_window=cw)
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    np.testing.assert_array_equal(t.disparity.numpy(), np.asarray(j.disparity))
    assert t.disparity.shape == (26, 26, 2)
    assert (t.disparity.numpy()[t.valid.numpy()] == [3, 1]).all(-1).mean() > 0.5


@pytest.mark.parametrize("cost", COSTS)
def test_best_of_search_convolution_matches_oracle(cost):
    from tests.oracle import vw_oracle as vw      # resolves only in this repo
    h, w, sx, sy = 30, 34, 6, 5
    left, right = _pair(32, h, w, sx, sy, black=False)
    cw = WINDOW.get(cost, 5)
    d, v = tcorr.best_of_search_convolution(left, right, (sx, sy), (7, 5), cost, cw,
                                            device="cpu").to_numpy()
    od, ov = vw.best_of_search_convolution(left, right, (sx, sy), (7, 5), cost, cw)
    if cost == "ncc":
        agree = (v == ov) & (~v | (d == od).all(-1))
        assert agree.mean() >= 0.998, agree.mean()
    else:
        np.testing.assert_array_equal(v, ov)
        np.testing.assert_array_equal(d[v], od[v])


def test_frame_tile_does_not_change_the_result():
    """The whole-frame search's tile (and its edge padding) is free: tiles
    of 8, 16 and 64 give the same output, best metric included."""
    left, right = _pair(33, 37, 29, 5, 3)
    lt, rt = torch.as_tensor(left), torch.as_tensor(right)
    outs = [tsweep.search_frame(lt, rt, 5, 3, 7, 5, "ncc", tile=t, want_best=True)
            for t in (8, 16, 64)]
    assert [tsweep.frame_tile(31, 25, 5, 3, 7, 5, "ncc", tile=t) for t in (8, 16, 64)] \
        == [8, 16, 32]
    for o in outs[1:]:
        for a, b in zip(o, outs[0]):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("kw", [dict(right_cols=-1), dict(kernel=(4, 5)),
                                dict(search=(0, 2)), dict(cost="xx"),
                                dict(cost="census", cw=6)])
def test_best_of_search_convolution_rejects_bad_arguments(kw):
    left, right = _pair(34, 12, 14, 3, 2, black=False)
    right = right[:, :right.shape[1] + kw.get("right_cols", 0)]
    with pytest.raises(ArgumentErr):
        tcorr.best_of_search_convolution(left, right, kw.get("search", (3, 2)),
                                         kw.get("kernel", (5, 5)), kw.get("cost", "abs"),
                                         kw.get("cw", 5), device="cpu")


@pytest.mark.parametrize("cost", ["abs", "sq"])
def test_best_of_search_matches_pallas_interpret(cost):
    """Kernel 6's contract: (disp, valid, best), a flat window making
    invalid pixels."""
    rng = np.random.default_rng(35)
    h, w, sx, sy, k = 34, 38, 5, 3, 7
    left = quantized(rng, (h, w))
    right = quantized(rng, (h + sy - 1, w + sx - 1))
    left[5:20, 5:20] = 0.5
    right[5:22, 5:25] = 0.5
    d1, v1, b1 = pallas_best_of_search(jnp.asarray(left), jnp.asarray(right), sx, sy,
                                       k, k, cost, tile=16, interpret=True)
    d2, v2, b2 = tcv.best_of_search(torch.as_tensor(left), torch.as_tensor(right),
                                    sx, sy, k, k, cost)
    np.testing.assert_array_equal(v2.numpy(), np.asarray(v1))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(d1))
    np.testing.assert_array_equal(b2.numpy(), np.asarray(b1))
    assert (~v2).sum() > 20


@pytest.mark.parametrize("cost", ["abs", "sq"])
def test_tiled_search_matches_pallas_interpret(cost):
    """Kernel 7's contract: the whole disparity, tile offset included, is
    zeroed where invalid (``_tiled_search`` keeps the offset there)."""
    rng = np.random.default_rng(36)
    tile, s_x, s_y, kw, kh = 16, 5, 3, 7, 7
    nty, ntx = 2, 3
    base = quantized(rng, (nty * tile + kh - 1 + 8, ntx * tile + kw - 1 + 8))
    match = quantized(rng, (nty * tile + kh + s_y + 16, ntx * tile + kw + s_x + 130))
    base[2:20, 2:20] = 0.25
    match[0:40, 0:40] = 0.25
    offsets = np.array([[[1, 2], [0, 1], [2, 2]], [[2, 0], [1, 1], [0, 2]]], np.int32)
    d1, v1 = pallas_tiled_search(jnp.asarray(base), jnp.asarray(match),
                                 jnp.asarray(offsets), tile, s_x, s_y, kw, kh, cost,
                                 interpret=True)
    d2, v2 = tcv.tiled_search(torch.as_tensor(base), torch.as_tensor(match),
                              torch.as_tensor(offsets), tile, s_x, s_y, kw, kh, cost)
    np.testing.assert_array_equal(v2.numpy(), np.asarray(v1))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(d1))
    invalid = ~v2.numpy()
    assert invalid[:tile, :tile].any() and (d2.numpy()[invalid] == 0).all()
    with pytest.raises(ArgumentErr):
        tcv.tiled_search(torch.as_tensor(base), torch.as_tensor(match),
                         torch.as_tensor(offsets), tile, s_x, s_y, kw, kh, "census")


@pytest.mark.cuda
@pytest.mark.parametrize("cost", COSTS)
def test_search_frame_kernel_matches_plain(cuda, cost):
    """The whole-frame search on the card (NCC with black blocks, census
    from full-frame code planes) equals its plain version exactly."""
    left, right = _pair(37, 90, 150, 32, 3)
    args = (torch.as_tensor(left, device=cuda), torch.as_tensor(right, device=cuda),
            32, 3, 15, 15, cost, WINDOW.get(cost, 5))
    before = tsweep.launches
    got = tsweep.search_frame(*args, want_best=True)
    assert tsweep.launches == before + 1
    ref = tsweep.search_frame(*args, want_best=True, plain=True)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


@pytest.mark.cuda
def test_cost_volume_kernels_match_plain(cuda):
    left, right = _pair(38, 70, 90, 5, 3)
    args = (torch.as_tensor(left, device=cuda), torch.as_tensor(right, device=cuda),
            5, 3, 7, 7, "sq")
    for a, b in zip(tcv.best_of_search(*args), tcv.best_of_search_plain(*args)):
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
    offsets = torch.zeros((4, 5, 2), dtype=torch.int32, device=cuda)
    args = (args[0], args[1][:70, :90].contiguous(), offsets, 16, 5, 3, 7, 7, "abs")
    for a, b in zip(tcv.tiled_search(*args), tcv.tiled_search_plain(*args)):
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
