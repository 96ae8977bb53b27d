"""Port's SGM/MGM (``visionworkbench_torch/stereo/sgm.py`` and the SGM branch
of ``stereo/pyramid_correlation.py``) against the JAX package and the
reference transliteration ``tests/oracle/vw_oracle_sgm.py`` on the CPU, on
the same seeded numpy inputs.

Tolerances, each with its reason:

* census costs, aggregation, WTA with the tie-smoothing cascade, seeds,
  masks, banding, tile offsets and the shear: exact — every value is an
  integer-valued fp32 below 2^24, so integer winners and validity must be
  equal bit for bit;
* subpixel offsets: allclose at atol 2e-5 / rtol 1e-5, the oracle parity's
  own pin (``tests/test_sgm_oracle_parity.py``) — the parabola fit is a
  matrix product plus ``erf``, the 1D fits ``cos``, whose last ulps differ;
* ``pyramid_correlate`` with 2 levels: >= 99.5 % equal integer disparities
  among pixels valid in both and <= 0.5 % validity mismatch — the port's
  blur sums its taps in another order than the JAX package's matmuls, so
  the coarse level's quantized image may differ by one step. Measured on
  this input: 100 % agreement, 0 % mismatch, for SGM and MGM.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import _torch_threads, cuda, quantized  # noqa: F401
from visionworkbench_tpu.math.bbox import BBox2i as JBBox2i
from visionworkbench_tpu.stereo import pyramid_correlation as jpyr
from visionworkbench_tpu.stereo import sgm as jsgm
from visionworkbench_tpu.stereo.correlation import DisparityMap as JDisparityMap
from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.math.bbox import BBox2i
from visionworkbench_torch.stereo import pyramid_correlation as tpyr
from visionworkbench_torch.stereo import sgm as tsgm
from visionworkbench_torch.stereo.correlation import DisparityMap

SUB_TOL = dict(atol=2e-5, rtol=1e-5)


def _region_u8(seed, h=30, w=34, sx=6, sy=2, shift=3):
    """u8 pair with an embedded known shift and sparse defects (the oracle
    parity's inputs); ``right`` carries the full search margin."""
    rng = np.random.default_rng(seed)
    right = rng.random((h + sy - 1, w + sx - 1)).astype(np.float32)
    left = right[:h, shift:shift + w].copy()
    left = np.clip(left + (rng.random((h, w)) < 0.02) * 0.3, 0.0, 1.0)
    q = lambda a: np.clip(np.rint(a * 255.0), 0, 255).astype(np.int32)  # noqa: E731
    return q(left), q(right)


def _port_region(lq, rq, sv, use_mgm, subpixel, **kw):
    dm, off = tsgm.sgm_reference_region(lq, rq, sv, use_mgm=use_mgm,
                                        subpixel=subpixel, device="cpu", **kw)
    return dm.to_numpy(), off


def _jax_region(lq, rq, sv, use_mgm, subpixel, **kw):
    dm, off = jsgm.sgm_reference_region(jnp.asarray(lq), jnp.asarray(rq), sv,
                                        use_mgm=use_mgm, subpixel=subpixel, **kw)
    return (np.asarray(dm.disparity), np.asarray(dm.valid)), off


# ---- reference region: every subpixel mode, SGM and MGM ----------------------

@pytest.mark.parametrize("use_mgm", [False, True])
def test_reference_region_matches_jax(use_mgm):
    lq, rq = _region_u8(90 + use_mgm)
    (td, tv), toff = _port_region(lq, rq, (6, 2), use_mgm, "none")
    (jd, jv), joff = _jax_region(lq, rq, (6, 2), use_mgm, "none")
    assert toff == joff and tv.all()
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(td, jd)
    for mode in tsgm.SUBPIXEL_MODES[1:]:
        (td, _), _ = _port_region(lq, rq, (6, 2), use_mgm, mode)
        (jd, _), _ = _jax_region(lq, rq, (6, 2), use_mgm, mode)
        np.testing.assert_allclose(td, jd, **SUB_TOL, err_msg=mode)


def test_reference_region_ternary_and_allowed_match_jax():
    """Ternary census 7x7 with a per-pixel candidate mask: absent candidates
    and bound-collapsed subpixel neighbours."""
    lq, rq = _region_u8(92, sx=5)
    rows, cols = lq.shape[0] - 6, lq.shape[1] - 6
    rng = np.random.default_rng(93)
    allowed = rng.random((rows, cols, 2, 5)) < 0.8
    allowed[3:6, 4:9] = False
    kw = dict(kernel_size=7, cost_type="ternary_census",
              ternary_census_threshold=2, allowed=allowed)
    for mode in ("none", "lc_blend", "linear"):
        (td, tv), _ = _port_region(lq, rq, (5, 2), False, mode, **kw)
        (jd, jv), _ = _jax_region(lq, rq, (5, 2), False, mode, **kw)
        np.testing.assert_array_equal(tv, jv)
        if mode == "none":
            np.testing.assert_array_equal(td, jd)
        else:
            np.testing.assert_allclose(td, jd, **SUB_TOL, err_msg=mode)


def test_reference_region_matches_oracle():
    """Flat regions exercise the multiple-minimum smoothing cascade; the
    integer winners must equal the reference transliteration's."""
    from tests.oracle import vw_oracle_sgm as O
    h, w, sx, sy = 26, 30, 5, 2
    left = np.zeros((h, w), np.int32)
    right = np.zeros((h + sy - 1, w + sx - 1), np.int32)
    for (y, x) in [(8, 9), (15, 20), (20, 6)]:
        left[y, x] = 255
        right[y, x + 2] = 255
    o = O.SGMOracle("census", True, 0, 0, sx - 1, sy - 1, 5, "linear")
    d0, v0 = o.semi_global_matching_func(left, right)
    sd0, _ = o.create_disparity_view_subpixel(d0, v0)
    (td, tv), _ = _port_region(left, right, (sx, sy), True, "none")
    np.testing.assert_array_equal(tv, v0)
    np.testing.assert_array_equal(td.astype(np.int32), d0)
    (td, _), _ = _port_region(left, right, (sx, sy), True, "linear")
    np.testing.assert_allclose(td, sd0, **SUB_TOL)


# ---- pieces of the pyramid branch ------------------------------------------

def test_shear_round_trip_matches_jax():
    a = np.random.default_rng(94).random((3, 5, 7, 2)).astype(np.float32)
    got = tsgm._shear_rows(torch.as_tensor(a), 0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsgm._shear_rows(jnp.asarray(a), 0)))
    np.testing.assert_array_equal(tsgm._unshear_rows(got, 7).numpy(), a)


@pytest.mark.parametrize("p_valid", [0.7, 0.03, 0.0])
def test_tile_offsets_centered_match_jax(p_valid):
    rng = np.random.default_rng(95)
    tile, h, w, bounds = 8, 24, 32, (20, 3)
    disp = np.stack([rng.integers(-2, 24, (h, w)), rng.integers(-1, 4, (h, w))],
                    -1).astype(np.float32)
    disp[:8, :8, 0] = 6.0                 # a tile whose median is a tie of 2
    disp[:4, :8, 0] = 7.0
    valid = rng.random((h, w)) < p_valid
    valid[:8, :8] = True
    got = tpyr._tile_offsets_centered(torch.as_tensor(disp), torch.as_tensor(valid),
                                      tile, 2, 15, 1, bounds)
    ref = jpyr._tile_offsets_centered(jnp.asarray(disp), jnp.asarray(valid),
                                      tile, 2, 15, 1, value_bounds=bounds)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_calc_disparity_sgm_seeds_mask_and_banding_match_jax():
    """Half-resolution seeds, a left mask and a 1 MB budget that forces
    bands (the working-set estimate is 2.2 MB for SGM, 2 bands, and 4.4 MB
    for MGM, 4 bands): integer disparities and validity exact."""
    rng = np.random.default_rng(96)
    h, w, sx, sy = 96, 80, 6, 3
    right = quantized(rng, (h + sy - 1, w + sx - 1))
    left = right[1:1 + h, 3:3 + w].copy()
    lmask = np.ones((h, w), bool)
    lmask[10:16, 5:20] = False
    hh, hw = (h + 1) // 2, (w + 1) // 2
    seed = np.stack([rng.integers(0, 3, (hh, hw)), rng.integers(0, 2, (hh, hw))],
                    -1).astype(np.float32)
    seed_valid = rng.random((hh, hw)) < 0.8
    for use_mgm in (False, True):
        kw = dict(kernel_size=5, use_mgm=use_mgm, subpixel="none", left_mask=lmask,
                  memory_limit_mb=1, band_overlap=6, search_buffer=1)
        t = tsgm.calc_disparity_sgm(
            left, right, (sx, sy), device="cpu",
            prev_disparity=DisparityMap.from_numpy(seed, seed_valid, "cpu"), **kw)
        j = jsgm.calc_disparity_sgm(
            jnp.asarray(left), jnp.asarray(right), (sx, sy),
            prev_disparity=JDisparityMap(jnp.asarray(seed), jnp.asarray(seed_valid)),
            **kw)
        td, tv = t.to_numpy()
        np.testing.assert_array_equal(tv, np.asarray(j.valid))
        np.testing.assert_array_equal(td, np.asarray(j.disparity))
        assert not tv[10:16, 5:20].any() and tv.mean() > 0.8


def test_calc_disparity_sgm_bad_args():
    left = np.zeros((10, 10), np.float32)
    with pytest.raises(ArgumentErr):
        tsgm.calc_disparity_sgm(left, np.zeros((10, 12)), (3, 1), cost_type="abs",
                                device="cpu")
    with pytest.raises(ArgumentErr):
        tsgm.calc_disparity_sgm(left, np.zeros((10, 10)), (3, 1), device="cpu")
    with pytest.raises(ArgumentErr):
        tsgm.calc_disparity_sgm(left, np.zeros((10, 12)), (3, 1), subpixel="em",
                                device="cpu")


# ---- the pyramid correlator in SGM/MGM mode ---------------------------------

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


@pytest.mark.parametrize("algo,kw", [
    ("sgm", dict(subpixel="none", consistency_threshold=1.0)),
    ("mgm", dict(subpixel="none", masks=True)),
    ("sgm", dict(subpixel="parabola")),
])
def test_pyramid_single_level_matches_jax(algo, kw):
    left, right = _pair(97, 40, 48, (5, 1))
    kw = dict(kw)
    if kw.pop("masks", False):
        rng = np.random.default_rng(98)
        lm = np.ones(left.shape, bool)
        lm[10:18, 5:25] = False
        kw.update(left_mask=lm, right_mask=rng.random(right.shape) < 0.97)
    td, tv, jd, jv = _run_both(left, right, (-2, -1, 10, 3), stereo_algorithm=algo,
                               max_pyramid_levels=0, tile_size=16, **kw)
    np.testing.assert_array_equal(tv, jv)
    if kw["subpixel"] == "none":
        np.testing.assert_array_equal(td, jd)
        assert (td[tv] == [5, 1]).all(-1).mean() > 0.95
    else:
        np.testing.assert_allclose(td, jd, **SUB_TOL)
    assert td.dtype == np.float32 and tv.mean() > 0.5


@pytest.mark.parametrize("algo", ["sgm", "mgm"])
def test_pyramid_two_levels_agree_with_jax(algo):
    left, right = _pair(99, 64, 64, (11, 1))
    td, tv, jd, jv = _run_both(left, right, (0, -1, 24, 3), stereo_algorithm=algo,
                               max_pyramid_levels=2, tile_size=16,
                               consistency_threshold=2.0, subpixel="linear")
    both = tv & jv
    agree = (np.round(td[both]) == np.round(jd[both])).all(-1).mean()
    assert agree >= 0.995, agree
    assert (tv != jv).mean() <= 0.005
    assert tv.mean() > 0.5


def test_pyramid_three_levels_agree_with_jax():
    """SGM at the depth of 3 pyramid levels (4 levels run, 96^2 down to
    12^2), at the tolerances of the 2-level case."""
    left, right = _pair(104, 96, 96, (13, 1))
    td, tv, jd, jv = _run_both(left, right, (0, -1, 32, 3), stereo_algorithm="sgm",
                               max_pyramid_levels=3, tile_size=16,
                               consistency_threshold=2.0, subpixel="linear")
    both = tv & jv
    agree = (np.round(td[both]) == np.round(jd[both])).all(-1).mean()
    assert agree >= 0.995, agree
    assert (tv != jv).mean() <= 0.005
    assert tv.mean() > 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("algo,masks", [("sgm", False), ("mgm", False),
                                        ("sgm", True), ("mgm", True)])
def test_card_matches_cpu(cuda, algo, masks):
    """The SGM/MGM slice on the card (CUDA scans and speckle) against the
    CPU (plain versions): integer disparities and validity exact, also with
    left and right masks (the census costs compare pixels, so the masked
    pixels' fill value, whose sum runs in another order on each device,
    moves no cost unless it lands on a pixel's value)."""
    left, right = _pair(100, 128, 128, (11, 1))
    args = (left, right, BBox2i(0, -1, 24, 3))
    opts = dict(stereo_algorithm=algo, max_pyramid_levels=2, tile_size=32,
                subpixel="none", consistency_threshold=2.0)
    if masks:
        rng = np.random.default_rng(103)
        lm = np.ones(left.shape, bool)
        lm[30:60, 20:90] = False
        opts.update(left_mask=lm, right_mask=rng.random(right.shape) < 0.97)
    gd, gv = tpyr.pyramid_correlate(*args, device=cuda, **opts).to_numpy()
    cd, cv = tpyr.pyramid_correlate(*args, device="cpu", **opts).to_numpy()
    np.testing.assert_array_equal(gv, cv)
    np.testing.assert_array_equal(gd, cd)


@pytest.mark.cuda
def test_calc_disparity_sgm_wide_search_card_matches_cpu(cuda):
    """The documented call, ``calc_disparity_sgm(left, right, (64, 8), ...)``,
    on a 256^2 frame: 512 disparity cells, so both scans (x and y) run the
    path-line kernel (``csrc/sgm_path_scan.cu``), as the counts show. Card
    against CPU: validity exact, parabola subpixel allclose at the subpixel
    tolerance."""
    from visionworkbench_torch.ops import sgm_scan
    rng = np.random.default_rng(101)
    h = w = 256
    right = quantized(rng, (h + 7, w + 63))
    left = right[3:3 + h, 20:20 + w].copy()
    args = (left, right, (64, 8))
    opts = dict(kernel_size=5, cost_type="census", subpixel="parabola")
    before = sgm_scan.launches["scan_bidir"]
    path = sgm_scan.path_scan_launches["scan_bidir"]
    gd, gv = tsgm.calc_disparity_sgm(*args, device=cuda, **opts).to_numpy()
    assert sgm_scan.launches["scan_bidir"] == before + 2
    assert sgm_scan.path_scan_launches["scan_bidir"] == path + 2
    cd, cv = tsgm.calc_disparity_sgm(*args, device="cpu", **opts).to_numpy()
    np.testing.assert_array_equal(gv, cv)
    np.testing.assert_allclose(gd, cd, **SUB_TOL)
    core = np.s_[8:-8, 8:-8]
    assert (np.abs(gd[core] - [20, 3]) < 0.5).all(-1).mean() > 0.95


@pytest.mark.cuda
def test_calc_disparity_sgm_mgm_wide_search_card_matches_cpu(cuda):
    """``calc_disparity_sgm(..., use_mgm=True)`` at the documented 64x8
    search on a 128^2 frame: 512 disparity cells, so the three MGM scans (2
    ``mgm_bidir``, 1 ``mgm_fwd``) run the cluster kernel
    (``csrc/mgm_cluster_scan.cu``), as the counts show. Card against CPU:
    validity exact, parabola subpixel allclose at the subpixel tolerance."""
    from visionworkbench_torch.ops import sgm_scan
    rng = np.random.default_rng(103)
    h = w = 128
    right = quantized(rng, (h + 7, w + 63))
    left = right[3:3 + h, 20:20 + w].copy()
    args = (left, right, (64, 8))
    opts = dict(kernel_size=5, cost_type="census", subpixel="parabola", use_mgm=True)
    counts = (sgm_scan.launches, sgm_scan.cluster_scan_launches)
    before = [dict(c) for c in counts]
    gd, gv = tsgm.calc_disparity_sgm(*args, device=cuda, **opts).to_numpy()
    ran = [{k: c[k] - b[k] for k in c} for c, b in zip(counts, before)]
    assert ran == [{"scan_bidir": 0, "mgm_bidir": 2, "mgm_fwd": 1},
                   {"mgm_bidir": 2, "mgm_fwd": 1}]
    cd, cv = tsgm.calc_disparity_sgm(*args, device="cpu", **opts).to_numpy()
    np.testing.assert_array_equal(gv, cv)
    np.testing.assert_allclose(gd, cd, **SUB_TOL)
    core = np.s_[8:-8, 8:-8]
    assert (np.abs(gd[core] - [20, 3]) < 0.5).all(-1).mean() > 0.95


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["sgm", "mgm"])
def test_single_level_wide_search_card_matches_cpu(cuda, algo):
    """``pyramid_correlate`` at one level with config 6's 64x2 search on a
    64x512 frame: more than 16 cells a lane, so SGM's two scans run the
    path-line kernel and MGM's three scans the cluster kernel, as the counts
    show. Card against CPU: integer disparities and validity exact."""
    from visionworkbench_torch.ops import sgm_scan
    left, right = _pair(102, 64, 512, (16, 0))
    args = (left, right, BBox2i(0, -1, 64, 2))
    opts = dict(stereo_algorithm=algo, max_pyramid_levels=0, tile_size=64,
                subpixel="none")
    counts = (sgm_scan.launches, sgm_scan.mgm_scan_launches, sgm_scan.path_scan_launches,
              sgm_scan.cluster_scan_launches)
    before = [dict(c) for c in counts]
    gd, gv = tpyr.pyramid_correlate(*args, device=cuda, **opts).to_numpy()
    ran = [{k: c[k] - b[k] for k in c} for c, b in zip(counts, before)]
    if algo == "sgm":
        assert ran == [{"scan_bidir": 2, "mgm_bidir": 0, "mgm_fwd": 0},
                       {"scan_bidir": 0, "mgm_bidir": 0, "mgm_fwd": 0}, {"scan_bidir": 2},
                       {"mgm_bidir": 0, "mgm_fwd": 0}]
    else:
        assert ran == [{"scan_bidir": 0, "mgm_bidir": 2, "mgm_fwd": 1},
                       {"scan_bidir": 0, "mgm_bidir": 0, "mgm_fwd": 0}, {"scan_bidir": 0},
                       {"mgm_bidir": 2, "mgm_fwd": 1}]
    cd, cv = tpyr.pyramid_correlate(*args, device="cpu", **opts).to_numpy()
    np.testing.assert_array_equal(gv, cv)
    np.testing.assert_array_equal(gd, cd)
