"""The port's ``parallel/`` (``visionworkbench_torch/parallel/``) on
``torch.distributed``: gloo worlds of 2 and 4 CPU ranks, each started once
(``tests/torch_parallel_worker.py``, run as child processes with a
``file://`` rendezvous), their results held against NumPy, the port's
unsharded path and, for two entry points, the JAX package on its 4-device
CPU mesh.

Claims, each with its reason:

* ``halo_exchange_rows`` (shallow, deep and one-sided halos; float32, int32
  and bool bands; a 1-D mesh and both axes of a 2 x 2 tile x disp mesh):
  equal to the NumPy edge-padded frame's slices.
* ``map_overlap`` of a Gaussian: equal to the filter on the whole frame
  (its reach is within the halo).
* ``disparity_sharded_search`` (abs and NCC on quantized inputs): integer
  disparities and validity equal to the JAX package's on its 4-device disp
  mesh and to the port's ``best_of_search_convolution``; all-flat inputs
  invalid everywhere.
* ``hierarchical_sharded_correlate`` BM with a left mask, the L<->R check
  and the parabola (``__graft_entry__.dryrun_multichip``'s 1b recipe cut to
  128 x 48, 2 levels, quantized): validity equal to the JAX package's 4
  bands, disparities within the parabola tolerance of the port's monolithic
  tests (rtol 1e-4, atol 2e-4), so the integer winners are equal (another
  winner moves the output by about a pixel). The one call of the JAX
  package's hierarchical correlator in this file.
* hierarchical BM against the port's monolithic ``pyramid_correlate``
  (``tests/test_parallel.py``'s recipes: plain, parabola with a positive
  search minimum, masks, L<->R, blob filter, depth clamped to the band;
  plus NCC with the LoG prefilter and the parabola's re-evaluation, and
  census): >= 0.99 of the interior valid in both equal (within 1e-3 px
  for subpixel output), the JAX tests' claims; >= 0.97 of the validity
  equal where they claim it.
* hierarchical SGM and MGM: >= 0.995 of the pixels at least ``tile_size``
  rows from a seam agree with the monolithic engine (the claim of
  ``tests/test_parallel.py:352-398``; band seams truncate the paths).
* ``sharded_pyramid_correlate``: >= 0.99 of the interior equal to
  ``pyramid_correlate``, >= 0.9 at the true shift.
* ``reproject_mosaic(mesh=...)``: equal bit for bit to ``mesh=None``
  (config 5 at 96^2, and an odd 75 x 89 canvas with a rotated source).
* every rank returns the same whole map; the workers never import ``jax``
  or ``visionworkbench_tpu``.

The card's check (a world of one rank, card against CPU) is in
``tests/test_torch_parallel_card.py``, which imports no JAX.
"""

import os
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as tpw
from torch_parity import _torch_threads  # noqa: F401
from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.image.filters import gaussian_filter
from visionworkbench_torch.mosaic.geomosaic import reproject_mosaic
from visionworkbench_torch.parallel import make_disp_mesh, make_tile_disp_mesh, make_tile_mesh
from visionworkbench_torch.stereo.correlation import best_of_search_convolution
from visionworkbench_torch.stereo.pyramid_correlation import pyramid_correlate

WORLD_SECONDS = 120     # wall limit of one world, all its cases included
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORE = np.s_[16:-16, 16:-16]


def _start_world(world: int, out_dir) -> None:
    """Run ``world`` worker ranks to their end; kill them all and fail on
    the wall limit or on a rank's error."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    init = os.path.join(str(out_dir), "rendezvous")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "torch_parallel_worker.py"),
         str(rank), str(world), str(out_dir), init],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)]
    deadline = time.monotonic() + WORLD_SECONDS
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            for q in procs:
                q.communicate()
            pytest.fail(f"the gloo world of {world} ranks passed its "
                        f"{WORLD_SECONDS} s limit")
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "WORKER_PASS" in out, \
            f"rank {rank} of {world} failed:\n{out[-4000:]}"


class World:
    def __init__(self, size, out_dir):
        self.size, self.dir = size, out_dir

    def result(self, case, rank=0):
        return dict(np.load(os.path.join(str(self.dir), f"{case}_w{self.size}_r{rank}.npz")))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The gloo worlds of 2 and 4 ranks, each run once."""
    out = {}
    for size in (2, 4):
        d = tmp_path_factory.mktemp(f"world{size}")
        _start_world(size, d)
        out[size] = World(size, d)
    return out


def _agree(ref_d, ref_v, d, v, tol=0.0, core=CORE):
    """(share of the interior valid in both with equal disparities, share
    of the interior with equal validity)."""
    both = ref_v[core] & v[core]
    same = (np.abs(ref_d[core] - d[core]) <= tol).all(-1)[both]
    return same.mean(), (ref_v[core] == v[core]).mean()


@pytest.mark.parametrize("world", [2, 4])
def test_workers_ran_without_jax(worlds, world):
    """Each rank printed WORKER_PASS after asserting that neither ``jax``
    nor ``visionworkbench_tpu`` is in its ``sys.modules``; every case of
    its world size wrote a result for every rank."""
    w = worlds[world]
    for case, (sizes, _) in tpw.CASES.items():
        if world in sizes:
            for rank in range(world):
                assert w.result(case, rank)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("depth", sorted(tpw.HALOS))
@pytest.mark.parametrize("dtype", ["float32", "int32", "bool"])
def test_halo_exchange_rows_matches_edge_pad(worlds, world, dtype, depth):
    frame = tpw.halo_frames(world)[dtype]
    top, bot = tpw.HALOS[depth]
    hb = tpw.HALO_BAND
    padded = np.pad(frame, [(top, bot)] + [(0, 0)] * (frame.ndim - 1), mode="edge")
    for rank in range(world):
        got = worlds[world].result("halo", rank)[f"{dtype}_{depth}"]
        assert got.dtype == frame.dtype
        np.testing.assert_array_equal(got, padded[rank * hb:rank * hb + hb + top + bot])


@pytest.mark.parametrize("depth", sorted(tpw.HALOS))
@pytest.mark.parametrize("axis", ["tile", "disp"])
def test_halo_exchange_rows_2x2_mesh(worlds, axis, depth):
    """Along either axis of the 2 x 2 mesh a rank's peers are the global
    ranks of its group: the frame exchanged depends on the rank's index on
    the other axis, so rows sent to another group would show."""
    frame = tpw.halo_frames(2)["float32"]
    top, bot = tpw.HALOS[depth]
    hb = tpw.HALO_BAND
    for rank in range(4):
        r = worlds[4].result("halo_2x2", rank)
        t_idx, d_idx = r["coords"]
        assert (t_idx, d_idx) == (rank // 2, rank % 2)
        idx, other = (t_idx, d_idx) if axis == "tile" else (d_idx, t_idx)
        img = np.pad(frame + np.float32(1000.0 * other), [(top, bot), (0, 0)], mode="edge")
        np.testing.assert_array_equal(r[f"{axis}_{depth}"], img[idx * hb:idx * hb + hb + top + bot])


@pytest.mark.parametrize("world", [2, 4])
def test_map_overlap_gaussian_equals_whole(worlds, world):
    whole = gaussian_filter(torch.as_tensor(tpw.gaussian_image()), 1.0).numpy()
    np.testing.assert_array_equal(worlds[world].result("map_overlap")["out"], whole)


@pytest.fixture(scope="module")
def jax_disp_search():
    """The JAX package's ``disparity_sharded_search`` on its 4-device disp
    mesh, abs and NCC."""
    from visionworkbench_tpu.parallel import disparity_sharded_search as jsearch
    from visionworkbench_tpu.parallel import make_disp_mesh as jmesh
    out = {}
    for cost in ("abs", "ncc"):
        left, right, sv, ks = tpw.disp_search_inputs(cost)
        dm = jsearch(jnp.asarray(left), jnp.asarray(right), sv, ks, jmesh(4), cost)
        out[cost] = (np.asarray(dm.disparity), np.asarray(dm.valid))
    return out


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("cost", ["abs", "ncc"])
def test_disparity_sharded_search_matches_jax(worlds, jax_disp_search, world, cost):
    r = worlds[world].result(f"disp_{cost}")
    jd, jv = jax_disp_search[cost]
    np.testing.assert_array_equal(r["valid"], jv)
    np.testing.assert_array_equal(r["disparity"], jd)
    left, right, sv, ks = tpw.disp_search_inputs(cost)
    td, tv = best_of_search_convolution(left, right, sv, ks, cost, device="cpu").to_numpy()
    np.testing.assert_array_equal(r["valid"], tv)
    np.testing.assert_array_equal(r["disparity"], td)


@pytest.mark.parametrize("world", [2, 4])
def test_disparity_sharded_flat_invalidation(worlds, world):
    r = worlds[world].result("disp_flat")
    assert r["disparity"].shape == (12, 12, 2)
    assert not r["valid"].any() and not r["disparity"].any()


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_pyramid_correlate_matches_whole(worlds, world):
    left, right, sr, kw = tpw.sharded_pyramid_case()
    wd, wv = pyramid_correlate(left, right, sr, device="cpu", **kw).to_numpy()
    r = worlds[world].result("sharded_pyramid")
    agree, _ = _agree(wd, wv, r["disparity"], r["valid"], core=np.s_[8:-8, 8:-8])
    assert agree > 0.99, agree
    sd, sv = r["disparity"][8:-8, 8:-8], r["valid"][8:-8, 8:-8]
    assert ((sd[..., 0] == -3) & (sd[..., 1] == -1))[sv].mean() > 0.9


def test_hierarchical_bm_matches_jax(worlds):
    """The one call of the JAX package's hierarchical correlator here."""
    from visionworkbench_tpu.math.bbox import BBox2i as JBBox2i
    from visionworkbench_tpu.parallel import hierarchical_sharded_correlate as jhier
    from visionworkbench_tpu.parallel import make_tile_mesh as jmesh
    left, right, sr, kw, _ = tpw.hier_case("bm_jax")
    jkw = dict(kw, left_mask=jnp.asarray(kw["left_mask"]))
    jdm = jhier(jnp.asarray(left), jnp.asarray(right),
                JBBox2i(sr.min_x, sr.min_y, sr.width, sr.height), jmesh(4), **jkw)
    jd, jv = np.asarray(jdm.disparity), np.asarray(jdm.valid)
    r = worlds[4].result("hier_bm_jax")
    assert jv.sum() > 0.5 * jv.size
    np.testing.assert_array_equal(r["valid"], jv)
    np.testing.assert_allclose(r["disparity"], jd, rtol=1e-4, atol=2e-4)


MONOLITHIC = {   # case: (subpixel tolerance, validity claim, true-shift claim)
    "bm": (0.0, None, 0.9), "subpixel": (1e-3, None, None), "masks": (0.0, 0.97, None),
    "consistency": (0.0, 0.97, None), "blob": (0.0, 0.99, None),
    "ncc_log": (1e-3, None, 0.9), "census": (1e-3, None, 0.9), "clamp_levels": (0.0, None, 0.9),
}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", sorted(MONOLITHIC))
def test_hierarchical_matches_monolithic(worlds, case, world):
    sizes = tpw.CASES[f"hier_{case}"][0]
    if world not in sizes:
        world = max(sizes)
    left, right, sr, kw, true = tpw.hier_case(case)
    md, mv = pyramid_correlate(left, right, sr, device="cpu", **kw).to_numpy()
    r = worlds[world].result(f"hier_{case}")
    sd, sv = r["disparity"], r["valid"]
    tol, valid_claim, true_claim = MONOLITHIC[case]
    agree, valid_agree = _agree(md, mv, sd, sv, tol)
    assert agree > 0.99, agree
    if valid_claim:
        assert valid_agree > valid_claim, valid_agree
    if true_claim:
        correct = ((np.round(sd[CORE][..., 0]) == true[0])
                   & (np.round(sd[CORE][..., 1]) == true[1]))[sv[CORE]]
        assert correct.mean() > true_claim, correct.mean()
    if case == "masks":
        assert not sv[110:130, 35:55].any()      # masked left pixels


@pytest.mark.parametrize("world", [2, 4])
def test_hierarchical_consistency_and_blob_filter_reject(worlds, world):
    """The banded L<->R check and blob filter take pixels away."""
    w = worlds[world]
    assert w.result("hier_consistency")["valid"].sum() < \
        w.result("hier_consistency_off")["valid"].sum()
    assert w.result("hier_blob")["valid"].sum() < w.result("hier_blob_off")["valid"].sum()


@pytest.mark.parametrize("algo", ["sgm", "mgm"])
def test_hierarchical_sgm_mgm_far_from_seams(worlds, algo):
    left, right, sr, kw, true = tpw.hier_case(algo)
    d0, v0 = pyramid_correlate(left, right, sr, device="cpu", **kw).to_numpy()
    r = worlds[4].result(f"hier_{algo}")
    d1, v1 = r["disparity"], r["valid"]
    h = left.shape[0]
    seams = np.arange(0, h + 1, h // 4)
    far = np.min(np.abs(np.arange(h)[:, None] - seams[None]), 1) >= kw["tile_size"]
    agree = (v1[far] == v0[far]) & ((d1[far] == d0[far]).all(-1) | ~(v1[far] & v0[far]))
    assert agree.mean() >= 0.995, agree.mean()
    core = np.s_[8:-8, 8:-8]
    assert (d1[core][..., 0] == true[0])[v1[core]].mean() > 0.9


@pytest.mark.parametrize("world", [2, 4])
def test_every_rank_returns_the_same_map(worlds, world):
    w = worlds[world]
    for case, (sizes, _) in tpw.CASES.items():
        if world not in sizes or case.startswith("halo"):
            continue
        ref = w.result(case)
        for rank in range(1, world):
            got = w.result(case, rank)
            for k in ref:
                np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{case} {k} r{rank}")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["config5", "odd"])
def test_reproject_mosaic_mesh_equals_none(worlds, name, world):
    srcs, georefs, dst, shape, levels = tpw.mosaic_case(name)
    out, valid = reproject_mosaic(srcs, georefs, dst, shape, levels=levels, device="cpu")
    r = worlds[world].result(f"mosaic_{name}")
    np.testing.assert_array_equal(r["valid"], valid.numpy())
    np.testing.assert_array_equal(r["out"], out.numpy())


def test_meshes_raise_without_a_process_group():
    import torch.distributed as dist
    assert not dist.is_initialized()
    for make in (make_tile_mesh, make_disp_mesh, lambda device: make_tile_disp_mesh(2, 2, device)):
        with pytest.raises(ArgumentErr, match="no process group"):
            make(device="cpu")


@pytest.mark.parametrize("kw", [dict(stereo_algorithm="bp"),
                                dict(stereo_algorithm="sgm", consistency_threshold=1.0),
                                dict(subpixel="em"), dict(cost_type="l1"),
                                dict(prefilter_mode="sobel")])
def test_hierarchical_rejects_unknown_options(kw):
    """Options the banded engine does not have raise before any
    collective (the JAX package's checks, plus the monolithic engine's
    cost, subpixel and prefilter checks)."""
    from visionworkbench_torch.parallel import hierarchical_sharded_correlate
    left, right, sr, _, _ = tpw.hier_case("bm_jax")
    with pytest.raises(ArgumentErr):
        hierarchical_sharded_correlate(left, right, sr, None, **kw)
