"""Port's mosaic (``visionworkbench_torch/mosaic/``: the pyramids and
blends of ``composite.py``, ``ImageComposite``, the reprojection mosaic of
``geomosaic.py`` — the repo's config 5 — and ``quadtree.py``) against the
JAX package on the CPU, on the same seeded numpy inputs. The JAX package
runs jitted, once per configuration (module fixtures).

Tolerances: the reprojection plans (fp32 grids on the host, one operation
a step as the JAX package's eager planning), the masks, the grassfire
alphas and the mosaics' ``valid`` are exact. Blended values within 2e-5
(images of magnitude ~2): the JAX package smooths and upsamples with
banded matmuls (the border taps merged into one weight, FMAs), the port
with stencils of the same taps, so sums round differently (measured
<= 5.2e-6 at 256^2 on config 5, <= 1.4e-6 here).
"""

import os

import jax
import numpy as np
import pytest

from torch_parity import _torch_threads, cuda  # noqa: F401
import visionworkbench_tpu.cartography.georeference as jgeo
import visionworkbench_tpu.fileio.tiff as jtiff
import visionworkbench_tpu.image.morphology as jmorph
import visionworkbench_tpu.image.transform as jt
import visionworkbench_tpu.math.bbox as jbbox
import visionworkbench_tpu.mosaic.composite as jcomp
import visionworkbench_tpu.mosaic.geomosaic as jgm
import visionworkbench_tpu.mosaic.quadtree as jqt
import visionworkbench_torch.cartography.georeference as tgeo
import visionworkbench_torch.fileio.tiff as ttiff
import visionworkbench_torch.math.bbox as tbbox
import visionworkbench_torch.mosaic.composite as tcomp
import visionworkbench_torch.mosaic.geomosaic as tgm
import visionworkbench_torch.mosaic.quadtree as tqt
from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.image.transform import warp_route

ATOL = 2e-5


def _texture(n, seed=11):
    """Config 5's texture (``tools_bench_configs.py:96-101``)."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:n, 0:n + 80].astype(np.float32)
    return (np.sin(xs * 0.21) * np.cos(ys * 0.17)
            + 0.5 * np.sin(xs * 0.047 + ys * 0.031)
            + 0.3 * rng.random(xs.shape)).astype(np.float32)


def _georef(geo, t):
    return geo.GeoReference(transform=np.asarray(t, np.float64))


def _diag(scale, x0, y0):
    return [[scale, 0.0, x0], [0.0, -scale, y0], [0.0, 0.0, 1.0]]


def _config(name):
    """``(srcs, src transforms, dst transform, out_shape, levels)``.
    ``config5``: ``tools_bench_configs.py:184-230`` at n = 96 (sources
    57^2, the config's levels 4). ``odd``: a 75x89 canvas, levels 3,
    sources of odd shapes covering part of it, one source's georef
    rotated (its map is not separable: the 2-D route)."""
    if name == "config5":
        n = 96
        tex = _texture(n)
        specs = [(0.0102, -0.05 * n * 0.01, n * 0.0105),
                 (0.0098, 0.45 * n * 0.01, n * 0.0104),
                 (0.0101, -0.04 * n * 0.01, n * 0.0056),
                 (0.0099, 0.46 * n * 0.01, n * 0.0055)]
        sh = int(n * 0.6)
        srcs = [tex[:sh, i * 7:i * 7 + sh] + np.float32(i * 1e-4) for i in range(4)]
        return srcs, [_diag(*s) for s in specs], _diag(0.01, 0.0, n * 0.01), (n, n), 4
    tex = _texture(75, seed=12)
    c, s = np.cos(0.12), np.sin(0.12)
    rot = [[0.0104 * c, 0.0104 * s, 0.05], [0.0104 * s, -0.0104 * c, 0.70], [0, 0, 1]]
    ts = [_diag(0.0118, -0.02, 0.76), rot, _diag(0.0085, 0.02, 0.41),
          _diag(0.0112, 0.43, 0.40)]
    shapes = [(41, 47), (43, 39), (37, 45), (45, 49)]
    srcs = [tex[i:i + h, 3 * i:3 * i + w] + np.float32(i * 0.1)
            for i, (h, w) in enumerate(shapes)]
    return srcs, ts, _diag(0.01, 0.0, 0.75), (75, 89), 3


@pytest.fixture(scope="module", params=["config5", "odd"])
def mosaic_case(request):
    """The JAX package's plans, routes and jitted mosaic, and the port's,
    for one configuration."""
    srcs, ts, dt, out_shape, levels = _config(request.param)
    jg = [_georef(jgeo, t) for t in ts]
    jdst = _georef(jgeo, dt)
    jplans = jgm.plan_reproject_grids(jg, jdst, out_shape)
    calls, routes = [], []
    with pytest.MonkeyPatch.context() as mp:
        # which coordinates each source's warp took: 1-D or 2-D
        for name, route in (("_grid_axis_1d", "separable"), ("interp_map_grid", "grid")):
            orig = getattr(jt, name)
            mp.setattr(jt, name, lambda *a, _o=orig, _r=route, **k:
                       (calls.append(_r), _o(*a, **k))[1])
        warp = jgm.warp_from_grid
        mp.setattr(jgm, "warp_from_grid", lambda *a, **k:
                   (calls.clear(), warp(*a, **k), routes.append(calls[0]))[1])
        jout, jvalid = jax.jit(lambda *im: jgm.reproject_mosaic(
            list(im), jg, jdst, out_shape, levels=levels, plans=jplans))(*srcs)
    tg = [_georef(tgeo, t) for t in ts]
    tdst = _georef(tgeo, dt)
    tplans = tgm.plan_reproject_grids(tg, tdst, out_shape)
    tout, tvalid = tgm.reproject_mosaic(srcs, tg, tdst, out_shape, levels=levels,
                                        plans=tplans, device="cpu")
    return dict(name=request.param, srcs=srcs, out_shape=out_shape, levels=levels, tg=tg, tdst=tdst,
                jplans=jplans, tplans=tplans, routes=routes,
                jout=np.asarray(jout), jvalid=np.asarray(jvalid),
                tout=tout.numpy(), tvalid=tvalid.numpy())


def test_plans_masks_alphas_match_jax(mosaic_case):
    """The grids, the coordinate route JAX's predicate took, and each
    source's mask and grassfire alpha."""
    c = mosaic_case
    assert [warp_route(*p) for p in c["tplans"]] == c["routes"]
    # config 5's scales differ from the canvas's by <= 2 %: at 96^2 the
    # displacement band is narrow (2-D coordinates), at 1024^2 wide
    # (1-D); the odd configuration has both
    assert set(c["routes"]) == {"config5": {"grid"}, "odd": {"separable", "grid"}}[c["name"]]
    for src, jp, tp in zip(c["srcs"], c["jplans"], c["tplans"]):
        sx_g, sy_g, step = tp
        np.testing.assert_array_equal(sx_g, jp[0])
        np.testing.assert_array_equal(sy_g, jp[1])
        assert step == jp[2]
        _, mask, alpha = tp.prepare(src.shape, c["out_shape"], "bilinear", "cpu")
        sx, sy = jgm._host_interp_grid(*jp, c["out_shape"])
        h, w = src.shape
        jmask = (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)
        np.testing.assert_array_equal(mask.numpy(), jmask)
        np.testing.assert_array_equal(alpha.numpy(), jmorph.grassfire_np(jmask))


def test_reproject_mosaic_matches_jax(mosaic_case):
    """``valid`` exactly (and the union of the plans' masks), the mosaic
    within 2e-5."""
    c = mosaic_case
    assert c["tout"].shape == c["jout"].shape == c["out_shape"]
    np.testing.assert_array_equal(c["tvalid"], c["jvalid"])
    union = np.zeros(c["out_shape"], bool)
    for src, p in zip(c["srcs"], c["tplans"]):
        union |= p.prepare(src.shape, c["out_shape"], "bilinear", "cpu")[1].numpy()
    np.testing.assert_array_equal(c["tvalid"], union)
    np.testing.assert_allclose(c["tout"], c["jout"], rtol=0, atol=ATOL)


def test_reproject_mosaic_plans_made_inside(mosaic_case):
    """Without ``plans`` (made inside), and with the JAX package's plain
    ``(sx_g, sy_g, step)`` tuples: the same mosaic bit for bit; a second
    frame through the same plans reuses their prepared state."""
    c = mosaic_case
    kw = dict(levels=c["levels"], device="cpu")
    for plans in (None, [tuple(p) for p in c["jplans"]]):
        out, valid = tgm.reproject_mosaic(c["srcs"], c["tg"], c["tdst"], c["out_shape"],
                                          plans=plans, **kw)
        np.testing.assert_array_equal(out.numpy(), c["tout"])
        np.testing.assert_array_equal(valid.numpy(), c["tvalid"])
    prepared = [dict(p._prepared) for p in c["tplans"]]
    tgm.reproject_mosaic(c["srcs"], c["tg"], c["tdst"], c["out_shape"],
                         plans=c["tplans"], **kw)
    assert all(p._prepared.keys() == q.keys() and
               all(p._prepared[k] is q[k] for k in q)
               for p, q in zip(c["tplans"], prepared))


def test_reproject_mosaic_mesh_raises(tmp_path):
    """``mesh=`` works: in a gloo world of one rank, a tile mesh gives the
    mosaic of ``mesh=None`` bit for bit (the 2- and 4-rank worlds are in
    ``tests/test_torch_parallel.py``); a mesh without a tile axis and an
    empty source list raise."""
    import torch.distributed as dist
    from datetime import timedelta
    from visionworkbench_torch.parallel import make_disp_mesh, make_tile_mesh
    srcs, ts, dt, out_shape, levels = _config("odd")
    args = (srcs, [_georef(tgeo, t) for t in ts], _georef(tgeo, dt), out_shape)
    ref = tgm.reproject_mosaic(*args, levels=levels, device="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", rank=0,
                            world_size=1, timeout=timedelta(seconds=60))
    try:
        out = tgm.reproject_mosaic(*args, levels=levels, mesh=make_tile_mesh(device="cpu"))
        for got, want in zip(out, ref):
            np.testing.assert_array_equal(got.numpy(), want.numpy())
        with pytest.raises(ArgumentErr, match="no 'tile' axis"):
            tgm.reproject_mosaic(*args, mesh=make_disp_mesh(device="cpu"))
    finally:
        dist.destroy_process_group()
    with pytest.raises(ArgumentErr):
        tgm.reproject_mosaic([], [], _georef(tgeo, dt), out_shape, device="cpu")


def _canvases(channels=()):
    """Three overlapping sources on a 41x53 canvas (odd), their masks
    (one with a hole) and grassfire alphas."""
    rng = np.random.default_rng(21)
    h, w = 41, 53
    imgs = [(rng.random((h, w) + channels) + i).astype(np.float32) for i in range(3)]
    masks = [np.zeros((h, w), bool) for _ in range(3)]
    masks[0][:, :30] = True
    masks[1][:, 20:] = True
    masks[2][10:35, 5:48] = True
    masks[2][18:24, 20:30] = False
    return imgs, masks, [jmorph.grassfire_np(m).astype(np.float32) for m in masks]


@pytest.mark.parametrize("variant", ["alphas", "no_alphas", "rgb"])
def test_multiband_blend_matches_jax(variant):
    imgs, masks, alphas = _canvases((3,) if variant == "rgb" else ())
    use = alphas if variant == "alphas" else None
    jo, jv = jax.jit(lambda *a: jcomp.multiband_blend(list(a[:3]), list(a[3:]), 3, use))(
        *imgs, *masks)
    to, tv = tcomp.multiband_blend(imgs, masks, 3, use, device="cpu")
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=ATOL)


def test_pyramids_and_feather_blend_match_jax():
    img = np.random.default_rng(22).random((37, 45)).astype(np.float32)
    for levels in (1, 3):
        for jf, tf in ((jcomp.gaussian_pyramid, tcomp.gaussian_pyramid),
                       (jcomp.laplacian_pyramid, tcomp.laplacian_pyramid)):
            for a, b in zip(jax.jit(jf, static_argnums=1)(img, levels),
                            tf(img, levels, device="cpu")):
                assert b.shape == a.shape
                np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=ATOL)
        lp = tcomp.laplacian_pyramid(img, levels, device="cpu")
        np.testing.assert_allclose(tcomp.collapse_pyramid(lp).numpy(),
                                   np.asarray(jax.jit(jcomp.collapse_pyramid)(
                                       [x.numpy() for x in lp])),
                                   rtol=0, atol=ATOL)
        np.testing.assert_allclose(tcomp.collapse_pyramid(lp).numpy(), img, atol=ATOL)
    for h, w in ((4, 4), (37, 45), (1024, 1024), (614, 2000), (3, 900)):
        assert tcomp.blend_levels_for(h, w) == jcomp.blend_levels_for(h, w)
    for ch in ((), (2,)):
        imgs, masks, _ = _canvases(ch)
        jo, jv = jax.jit(jcomp.feather_blend)(imgs, masks)
        to, tv = tcomp.feather_blend(imgs, masks, device="cpu")
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["multiband", "draft", "simple"])
def test_image_composite_matches_jax(monkeypatch, mode):
    # the JAX package's composite blends through its jitted blend functions
    for name in ("multiband_blend", "feather_blend"):
        monkeypatch.setattr(jcomp, name, jax.jit(getattr(jcomp, name)))
    rng = np.random.default_rng(23)
    comps = (jcomp.ImageComposite(mode), tcomp.ImageComposite(mode, device="cpu"))
    for i, (x, y) in enumerate(((0, 0), (17, 5), (-6, 21))):
        img = (rng.random((29, 33)) + i).astype(np.float32)
        mask = None if i != 1 else rng.random((29, 33)) < 0.9
        for comp in comps:
            comp.insert(img, x, y, mask)
    (jo, jv), (to, tv) = (c.generate() for c in comps)
    assert (comps[1].bbox().min(), comps[1].bbox().max()) == \
        (comps[0].bbox().min(), comps[0].bbox().max())
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(to, jo, rtol=0, atol=ATOL)


def test_quadtree_matches_jax(tmp_path):
    """The same tiles (names, levels, values through float TIFFs) and the
    same KML."""
    img = np.random.default_rng(24).random((100, 130)).astype(np.float32)
    tiles = {}
    for key, qt, tiff in (("jax", jqt, jtiff), ("torch", tqt, ttiff)):
        kw = {} if key == "jax" else {"device": "cpu"}
        name = str(tmp_path / key / "qtree")
        gen = qt.QuadTreeGenerator(img, name, tile_size=64, file_type=".tif", **kw)
        written = gen.generate()
        tiles[key] = ([(lv, x, y, os.path.relpath(p, tmp_path / key))
                       for lv, x, y, p in written],
                      [tiff.read_tiff(p)[0] for *_, p in written], gen.tree_levels)
        box = (jbbox if key == "jax" else tbbox).BBox2.from_bounds(-120, 39, -119, 40)
        with open(qt.write_kml_superoverlay(name, box, written, 64)) as f:
            tiles[key] += (f.read(),)
    (jl, jd, jn, jk), (tl, td, tn, tk) = tiles["jax"], tiles["torch"]
    assert tl == jl and tn == jn == 3 and tk == jk
    for a, b in zip(jd, td):
        np.testing.assert_allclose(b, a, rtol=0, atol=ATOL)


@pytest.mark.cuda
def test_mosaic_card_matches_cpu(cuda):
    """Config 5 at 96^2 and the odd configuration: card = CPU (``valid``
    equal, values within 1e-5); multiband and feather blends."""
    for name in ("config5", "odd"):
        srcs, ts, dt, out_shape, levels = _config(name)
        tg = [_georef(tgeo, t) for t in ts]
        tdst = _georef(tgeo, dt)
        plans = tgm.plan_reproject_grids(tg, tdst, out_shape)
        go, gv = tgm.reproject_mosaic(srcs, tg, tdst, out_shape, levels=levels,
                                      plans=plans, device=cuda)
        co, cv = tgm.reproject_mosaic(srcs, tg, tdst, out_shape, levels=levels,
                                      plans=plans, device="cpu")
        np.testing.assert_array_equal(gv.cpu().numpy(), cv.numpy())
        np.testing.assert_allclose(go.cpu().numpy(), co.numpy(), rtol=0, atol=1e-5)
    imgs, masks, _ = _canvases((3,))
    for f in (lambda d: tcomp.multiband_blend(imgs, masks, 3, device=d),
              lambda d: tcomp.feather_blend(imgs, masks, device=d)):
        (go, gv), (co, cv) = f(cuda), f("cpu")
        np.testing.assert_array_equal(gv.cpu().numpy(), cv.numpy())
        np.testing.assert_allclose(go.cpu().numpy(), co.numpy(), rtol=0, atol=1e-5)
