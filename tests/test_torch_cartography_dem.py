"""Port's camera cartography, point images, DEMs, hillshade and colormap
(``visionworkbench_torch/cartography/{camera_bbox, map2cam, point_image,
hillshade, colormap}``) and the ``undistort_image``, ``hillshade`` and
``colormap`` tools against the JAX package on the CPU, on the geometry of
the stereo-dem scene (``stereo_dem_scene.py``, ``chip_smoke.py``'s phase 8)
at 64² (f and the principal point scaled by 1/16, a 32² DEM, a 128²
texture; seeded). The entry points that take arrays send them to
``device`` (``None`` = the card; without one they raise, they do not fall
back to the CPU), and keep a tensor's device.

Tolerances (fp32 ECEF: an ulp is 0.5 m at these coordinates, and the
packages' ``sin``/``cos``/``atan2`` differ by ulps; measured max in
brackets):

* ECEF points (datum hits, point images) within 2 m (1.0 m: two ulps);
  DEM hits within 4 m (2.6 m: 20 march steps on fp32 geodetic heights);
  lon/lat within 2e-5 degrees (3.8e-6, one ulp of 37); geodetic heights
  within 4 m (the fp32 Bowring heights', as
  ``tests/test_torch_cartography.py``; 0.5 m); validity equal.
* camera pixels of map points (``Datum2CamTrans`` / ``Map2CamTrans``)
  within 2 px (0.075 px: the fp32 ECEF point minus the fp32 centre, as in
  the JAX package, where one ulp is 0.5 m); orthoimages of [0, 1) noise
  within 0.5 on >= 0.95 of the pixels.
* ``point_image_to_dem`` on one point cloud: cells equal on >= 0.99
  (measured 1.0; a point within a longitude ulp of a cell edge may land in
  the neighbour), heights of shared cells within 4 m (0.79 m: the port's
  float64 geodetic heights and sums against the JAX package's fp32 ones,
  ``ROADMAP.md`` §3); ``camera_bbox`` within 2e-5 degrees.
* ``hillshade`` and ``colormap`` (every style, a LUT file, bounds, nodata,
  shade) on the same input: within 1e-6 (0: the same stencils, IEEE
  quotients, correctly rounded roots, the same integer index).
* the tools on the same files: hillshade within 1e-6, colormap PNGs equal,
  undistorted images within 1e-3 on >= 0.99 of the pixels.
* the slice (the phase's chain at 64² from one true disparity map):
  warps within 2e-3 (5.2e-4); each step fed the JAX step's input within
  the bounds above (DEM cells 0.998 equal, heights 1.52 m); end to end,
  points within the JAX package's own error against the float64 oracle +
  0.6 m (0.5 m), DEM heights within 4.6 m on shared cells (1.52 m).
"""

import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import _torch_threads, jax_georef, port_camera  # noqa: F401
import stereo_dem_scene as sds
import visionworkbench_tpu.camera as jcam
import visionworkbench_tpu.cartography as jcart
import visionworkbench_tpu.fileio as jfileio
import visionworkbench_tpu.stereo.stereo_model as jsm
import visionworkbench_torch.cartography as tcart
import visionworkbench_torch.stereo.stereo_model as tsm
from visionworkbench_tpu.stereo.correlation import DisparityMap as JDM
from visionworkbench_torch.stereo.correlation import DisparityMap as TDM

# the packages export the function ``colormap`` under the module's name
jcmap = importlib.import_module("visionworkbench_tpu.cartography.colormap")
tcmap = importlib.import_module("visionworkbench_torch.cartography.colormap")

N = 64
ECEF_M = 2.0
DEG = 2e-5
HEIGHT_M = 4.0
CAM_PX = 2.0
SAME = 1e-6


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _err(a, b, where=None):
    d = np.abs(_np(a).astype(np.float64) - _np(b).astype(np.float64))
    if where is not None:
        d = d[where]
    return float(d.max()) if d.size else 0.0


@pytest.fixture(scope="module")
def scene():
    sc = sds.scene(N)
    sc["jleft"] = jcam.PinholeModel(sc["left"].C, sc["left"].R, (sc["left"].fu, sc["left"].fv),
                                    (sc["left"].cu, sc["left"].cv),
                                    jcam.TsaiLensDistortion(*sds.DEM_TSAI))
    sc["jdem_georef"] = jax_georef(sc["dem_georef"])
    rng = np.random.default_rng(12)
    sc["pix"] = rng.uniform(-2, N + 2, (256, 2)).astype(np.float32)
    return sc


# ---- camera footprints and ray/DEM intersection --------------------------------

def test_intersect_datum_and_lonlat_match_jax(scene):
    tcam_, jcam_ = port_camera(scene["jleft"]), scene["jleft"]
    pix = scene["pix"]
    dirs = jcam_.pixel_to_vector(jnp.asarray(pix))
    ctr = jnp.broadcast_to(jcam_.camera_center(), dirs.shape)
    datum = scene["dem_georef"].datum
    for h in (0.0, 50.0):
        txyz, tv = tcart.intersect_datum(np.array(ctr), np.array(dirs), datum, h, device="cpu")
        jxyz, jv = jcart.intersect_datum(ctr, dirs, scene["jdem_georef"].datum, h)
        assert np.array_equal(tv.numpy(), np.asarray(jv)) and tv.all()
        assert _err(txyz, jxyz) <= ECEF_M
    tlon, tlat, tv = tcart.camera_pixel_to_datum_lonlat(pix, tcam_, datum, device="cpu")
    jlon, jlat, jv = jcart.camera_pixel_to_datum_lonlat(jnp.asarray(pix), jcam_,
                                                        scene["jdem_georef"].datum)
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert max(_err(tlon, jlon), _err(tlat, jlat)) <= DEG


@pytest.mark.parametrize("nodata", [None, -9999.0])
def test_camera_pixel_to_dem_xyz_matches_jax(scene, nodata):
    """Validity equal; each DEM hit within 4 m (the march moves a point by
    its fp32 geodetic height's error each step; measured 2.6 m). With
    nodata, a ray whose march reaches a cell next to the nodata block reads
    a height mixed with the nodata value and jumps hundreds of metres, in a
    cycle, in both packages (``ROADMAP.md`` §3): such points are held by
    validity only, the rest (those whose last step moved them < 4 m in both
    packages) to 4 m."""
    dem = scene["dem"].copy()
    if nodata is not None:
        dem[10:14, 8:20] = nodata
    args = (scene["pix"], dem, nodata)

    def port(it):
        return tcart.camera_pixel_to_dem_xyz(args[0], port_camera(scene["jleft"]), args[1],
                                             scene["dem_georef"], args[2], it, device="cpu")

    def jax_(it):
        return jcart.camera_pixel_to_dem_xyz(jnp.asarray(args[0]), scene["jleft"],
                                             jnp.asarray(args[1]), scene["jdem_georef"],
                                             args[2], it)

    (txyz, tv), (jxyz, jv) = port(20), jax_(20)
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    held = tv.numpy().copy()
    if nodata is not None:
        assert not held.all()
        for last, before in ((txyz, port(19)[0]), (jxyz, jax_(19)[0])):
            held &= np.linalg.norm(_np(last) - _np(before), axis=-1) < HEIGHT_M
        assert held.mean() >= 0.5
    e = np.linalg.norm(txyz.double().numpy() - np.asarray(jxyz), axis=-1)
    assert e[held].max() <= HEIGHT_M


def test_camera_bbox_matches_jax(scene):
    datum = scene["dem_georef"].datum
    tb, th = tcart.camera_bbox(port_camera(scene["jleft"]), datum, N, N, 256, device="cpu")
    jb, jh = jcart.camera_bbox(scene["jleft"], scene["jdem_georef"].datum, N, N, 256)
    assert th == jh is True
    for k in ("min_x", "min_y", "max_x", "max_y"):
        assert abs(getattr(tb, k) - getattr(jb, k)) <= DEG
    miss = jcam.PinholeModel(scene["left"].C, -scene["left"].R, (90.0, 90.0), (32.0, 32.0))
    assert tcart.camera_bbox(port_camera(miss), datum, N, N, device="cpu")[1] is False


# ---- point images and DEMs ---------------------------------------------------------

def test_point_image_conversions_match_jax(scene):
    g, jg = scene["dem_georef"], scene["jdem_georef"]
    dem = scene["dem"]
    tllh = tcart.dem_to_geodetic(dem, g, device="cpu")
    jllh = jcart.dem_to_geodetic(jnp.asarray(dem), jg)
    assert _err(tllh, jllh) <= DEG
    txyz = tcart.dem_to_point_image(dem, g, device="cpu")
    assert _err(txyz, jcart.dem_to_point_image(jnp.asarray(dem), jg)) <= ECEF_M
    assert _err(tcart.geodetic_to_cartesian(np.array(jllh), g.datum, device="cpu"),
                jcart.geodetic_to_cartesian(jllh, jg.datum)) <= ECEF_M
    back = tcart.cartesian_to_geodetic(txyz, g.datum)
    jback = jcart.cartesian_to_geodetic(jnp.asarray(txyz.numpy()), jg.datum)
    assert _err(back[..., :2], jback[..., :2]) <= DEG
    assert _err(back[..., 2], jback[..., 2]) <= HEIGHT_M


def _cloud(scene, seed=14, up=2):
    """A point cloud on the true DEM: ECEF points of a finer grid over it,
    with some invalid points."""
    g = scene["dem_georef"]
    n = scene["dem"].shape[0] * up
    rng = np.random.default_rng(seed)
    fy, fx = np.mgrid[0:n, 0:n] / up - (up - 1) / (2 * up)
    h = np.asarray(tcart.dem_to_geodetic(scene["dem"], g, device="cpu"))[..., 2]
    hf = np.repeat(np.repeat(h, up, 0), up, 1) + rng.normal(0, 0.5, (n, n))
    lon, lat = g.pixel_to_lonlat(torch.as_tensor(fx, dtype=torch.float32),
                                 torch.as_tensor(fy, dtype=torch.float32))
    xyz = g.datum.geodetic_to_cartesian(torch.stack(
        [lon, lat, torch.as_tensor(hf, dtype=torch.float32)], -1)).numpy()
    return xyz, rng.random((n, n)) > 0.1


def test_point_image_to_dem_matches_jax(scene):
    xyz, valid = _cloud(scene)
    g = scene["dem"].shape[0]
    tdem, tv = tcart.point_image_to_dem(xyz, valid, scene["dem_georef"], g, g + 3, device="cpu")
    jdem, jv = jcart.point_image_to_dem(jnp.asarray(xyz), jnp.asarray(valid),
                                        scene["jdem_georef"], g, g + 3)
    tv, jv = tv.numpy(), np.asarray(jv)
    assert tdem.shape == (g, g + 3) and tdem.dtype == torch.float32
    assert (tv == jv).mean() >= 0.99
    assert _err(tdem, jdem, tv & jv) <= HEIGHT_M
    assert np.all(tdem.numpy()[~tv] == 0)


def _array_cases(scene):
    """(name, call(device), tensor-input call) of every entry point of the
    slice that takes arrays, on arrays of the scene."""
    cam, g = port_camera(scene["jleft"]), scene["dem_georef"]
    pix = scene["pix"]
    dirs = cam.pixel_to_vector(torch.as_tensor(pix))
    dirs2 = cam.pixel_to_vector(torch.as_tensor(pix + [5.0, 0.0]))
    ctr = cam.camera_center(dirs).expand(dirs.shape)
    xyz, valid = _cloud(scene)
    llh = tcart.dem_to_geodetic(scene["dem"], g, device="cpu")
    m = tsm.StereoModel(cam, cam)
    n = scene["dem"].shape[0]
    t = torch.as_tensor
    return {
        "point_image_to_dem": (
            lambda d: tcart.point_image_to_dem(xyz, valid, g, n, n, device=d),
            lambda: tcart.point_image_to_dem(t(xyz), t(valid), g, n, n)),
        "camera_pixel_to_dem_xyz": (
            lambda d: tcart.camera_pixel_to_dem_xyz(pix, cam, scene["dem"], g, device=d),
            lambda: tcart.camera_pixel_to_dem_xyz(t(pix), cam, t(scene["dem"]), g)),
        "camera_pixel_to_datum_lonlat": (
            lambda d: tcart.camera_pixel_to_datum_lonlat(pix, cam, g.datum, device=d),
            lambda: tcart.camera_pixel_to_datum_lonlat(t(pix), cam, g.datum)),
        "intersect_datum": (
            lambda d: tcart.intersect_datum(ctr.numpy(), dirs.numpy(), g.datum, device=d),
            lambda: tcart.intersect_datum(ctr, dirs, g.datum)),
        "geodetic_to_cartesian": (
            lambda d: tcart.geodetic_to_cartesian(llh.numpy(), g.datum, device=d),
            lambda: tcart.geodetic_to_cartesian(llh, g.datum)),
        "cartesian_to_geodetic": (
            lambda d: tcart.cartesian_to_geodetic(xyz, g.datum, device=d),
            lambda: tcart.cartesian_to_geodetic(t(xyz), g.datum)),
        "triangulate": (
            lambda d: m.triangulate(pix, pix + [1.0, 0.0], device=d),
            lambda: m.triangulate(t(pix), t(pix + [1.0, 0.0]))),
        "triangulate_pair": (
            lambda d: tsm.triangulate_pair(dirs.numpy(), ctr.numpy(), dirs2.numpy(),
                                           ctr.numpy() + 1, device=d),
            lambda: tsm.triangulate_pair(dirs, ctr, dirs2, ctr + 1)),
        "are_nearly_parallel": (
            lambda d: tsm.are_nearly_parallel(dirs.numpy(), dirs2.numpy(), device=d),
            lambda: tsm.are_nearly_parallel(dirs, dirs2)),
        "triangulate_point_multiview": (
            lambda d: tsm.triangulate_point_multiview(
                np.stack([dirs.numpy(), dirs2.numpy()]), np.stack([ctr.numpy(), ctr.numpy() + 1]),
                device=d),
            lambda: tsm.triangulate_point_multiview(torch.stack([dirs, dirs2]),
                                                    torch.stack([ctr, ctr + 1]))),
    }


ARRAY_CASES = ["point_image_to_dem", "camera_pixel_to_dem_xyz", "camera_pixel_to_datum_lonlat",
               "intersect_datum", "geodetic_to_cartesian", "cartesian_to_geodetic",
               "triangulate", "triangulate_pair", "are_nearly_parallel",
               "triangulate_point_multiview"]


@pytest.mark.parametrize("device", ["cpu", None])
@pytest.mark.parametrize("case", ARRAY_CASES)
def test_array_inputs_go_to_device(scene, case, device):
    """Arrays go to ``device``: ``"cpu"`` gives what CPU tensors give;
    ``None`` means the card, and raises where there is none (no entry point
    moves to the CPU on its own)."""
    call, tensor_call = _array_cases(scene)[case]
    if device is None and not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(device)
        return
    got, want = call(device), tensor_call()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        assert a.device.type == ("cpu" if device == "cpu" else "cuda")
        if device == "cpu":
            assert torch.equal(a, b)


def test_map2cam_and_orthoproject_match_jax(scene):
    g, jg = scene["dem_georef"], scene["jdem_georef"]
    tcam_, jcam_ = port_camera(scene["jleft"]), scene["jleft"]
    ys, xs = np.mgrid[0:32, 0:32].astype(np.float32)
    dem = scene["dem"].copy()
    dem[3:6, 3:6] = sds.DEM_NODATA
    for tt, jt in ((tcart.Datum2CamTrans(tcam_, g, 30.0), jcart.Datum2CamTrans(jcam_, jg, 30.0)),
                   (tcart.Map2CamTrans(tcam_, g, dem, g, sds.DEM_NODATA),
                    jcart.Map2CamTrans(jcam_, jg, jnp.asarray(dem), jg, sds.DEM_NODATA))):
        tx, ty = tt.reverse(torch.as_tensor(xs), torch.as_tensor(ys))
        jx, jy = jt.reverse(jnp.asarray(xs), jnp.asarray(ys))
        assert max(_err(tx, jx), _err(ty, jy)) <= CAM_PX
    img = np.random.default_rng(15).random((N, N)).astype(np.float32)
    got = tcart.orthoproject(img, tcam_, g, (32, 32), dem=dem, dem_nodata=sds.DEM_NODATA,
                             device="cpu").numpy()
    want = np.asarray(jcart.orthoproject(jnp.asarray(img), jcam_, jg, (32, 32),
                                         dem=jnp.asarray(dem), dem_nodata=sds.DEM_NODATA))
    assert got.shape == want.shape == (32, 32)
    assert (np.abs(got - want) <= 0.5).mean() >= 0.95


# ---- hillshade and colormap ---------------------------------------------------------

@pytest.mark.parametrize("nodata", [None, 7.5])
def test_hillshade_matches_jax(scene, nodata):
    dem = np.round(scene["dem"] * 4) / 4
    got = tcart.hillshade(dem, 315.0, 35.0, 12.5, nodata, device="cpu")
    want = jcart.hillshade(jnp.asarray(dem), 315.0, 35.0, 12.5, nodata)
    if nodata is None:
        assert _err(got, want) <= SAME
    else:
        assert np.array_equal(got.valid.numpy(), np.asarray(want.valid))
        assert not got.valid.all() and _err(got.data, want.data) <= SAME


COLORMAPS = sorted(jcmap._LUTS)


@pytest.mark.parametrize("style", COLORMAPS + ["file", "array"])
def test_colormap_matches_jax(scene, style, tmp_path):
    rng = np.random.default_rng(16)
    vals = (scene["dem"] + rng.normal(0, 3, scene["dem"].shape)).astype(np.float32)
    vals[0, :5] = np.nan
    vals[1, :5] = -5.0
    shade = rng.random(vals.shape).astype(np.float32)
    if style == "file":
        path = str(tmp_path / "lut.txt")
        with open(path, "w") as f:
            f.write("# intensity r g b\n0% 0 0 255\n40% 0,255,0\n1.0 255 0 0\n")
        style = path
    elif style == "array":
        style = np.linspace(0, 1, 17 * 3).reshape(17, 3)
    assert np.array_equal(tcmap._build_lut(jcmap._JET_NODES), jcmap._build_lut(jcmap._JET_NODES))
    for kw in ({}, {"lo": 10.0, "hi": 80.0, "nodata": -5.0, "shade": shade}):
        got = tcart.colormap(vals, style=style, device="cpu",
                             **{k: v for k, v in kw.items()})
        jkw = {k: (jnp.asarray(v) if k == "shade" else v) for k, v in kw.items()}
        want = jcart.colormap(jnp.asarray(vals), style=style, **jkw)
        assert got.shape == (*vals.shape, 3) and _err(got, want) <= SAME


def test_colormap_tables_are_the_jax_tables():
    assert sorted(tcmap._LUTS) == COLORMAPS
    for k in COLORMAPS:
        assert np.array_equal(tcmap._LUTS[k], jcmap._LUTS[k])


# ---- the tools ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def tool_files(scene, tmp_path_factory):
    d = tmp_path_factory.mktemp("dem_tools")
    img = stereo_images(scene)[0].numpy()
    dem = scene["dem"].copy()
    dem[2:5, 2:9] = sds.DEM_NODATA
    paths = {"img": str(d / "left.tif"), "tsai": str(d / "left.tsai"),
             "dem": str(d / "dem.tif"), "dir": str(d)}
    jfileio.write_tiff(paths["img"], img)
    jcam.write_pinhole_model(paths["tsai"], scene["jleft"])
    jfileio.write_tiff(paths["dem"], dem, georef=scene["jdem_georef"], nodata=sds.DEM_NODATA)
    return paths


TOOLS = {
    "undistort_image": (lambda p, o: [p["img"], p["tsai"], "-o", o], ".tif"),
    "hillshade": (lambda p, o: [p["dem"], "-o", o, "-a", "250", "--blur", "1.2"], ".tif"),
    "colormap": (lambda p, o: [p["dem"], "-o", o, "--hillshade", "--colormap-style", "jet"],
                 ".png"),
}


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tool_matches_jax(tool_files, tool, capsys):
    argv, ext = TOOLS[tool]
    outs = {side: os.path.join(tool_files["dir"], f"{tool}_{side}{ext}") for side in "jt"}
    jmain = importlib.import_module(f"visionworkbench_tpu.tools.{tool}").main
    tmain = importlib.import_module(f"visionworkbench_torch.tools.{tool}").main
    assert jmain(argv(tool_files, outs["j"])) == 0
    jtext = capsys.readouterr().out
    assert tmain(argv(tool_files, outs["t"]), device="cpu") == 0
    assert capsys.readouterr().out == jtext.replace(outs["j"], outs["t"])
    want = jfileio.read_image(outs["j"], None).astype(np.float64)
    got = jfileio.read_image(outs["t"], None).astype(np.float64)
    assert got.shape == want.shape
    if tool == "undistort_image":
        assert (np.abs(got - want) <= 1e-3).mean() >= 0.99
    elif tool == "hillshade":
        assert _err(got, want) <= SAME
        assert jfileio.read_tiff(outs["t"])[1].geo_keys() == jfileio.read_tiff(outs["j"])[1].geo_keys()
    else:
        assert np.array_equal(got, want)


# ---- the slice: the stereo-dem chain at 64² ------------------------------------------

def stereo_images(scene):
    if "images" not in scene:
        scene["images"] = [sds.render(scene[k], scene, N, "cpu")
                           for k in ("left", "right")]
    return scene["images"]


def _jax_rect(cam):
    return jcam.PinholeModel(cam.C, cam.R, (cam.fu, cam.fv), (cam.cu, cam.cv))


def test_stereo_dem_slice_matches_jax(scene):
    """The phase's chain after the correlator, from one true disparity map,
    in both packages: rectification, the warps, triangulation, the DEM,
    hillshade and colormap, each step also fed the JAX step's input."""
    left, right = stereo_images(scene)
    rect_l, rect_r = sds.rectify(scene)
    jr_r, jr_l = jcam.epipolar_rectify(_jax_rect(scene["right"]), _jax_rect(scene["left"]))
    for t, j in ((rect_l, jr_l), (rect_r, jr_r)):
        assert np.array_equal(t.C, j.C) and np.array_equal(t.R, j.R)
    # the warps into the rectified cameras
    jl_src = scene["jleft"]
    tw = sds.warp(left, scene["left"], rect_l, N)[0]
    jw = jcam.camera_transform(jnp.asarray(left.numpy()), jl_src, jr_l, (N, N))
    assert _err(tw, jw) <= 2e-3
    # the true disparity -> points -> DEM -> hillshade -> colormap
    depth, valid = sds.depth(rect_l, scene, N, "cpu")
    d32 = sds.disparity(rect_l, rect_r, depth).astype(np.float32)
    txyz, _, tv = tsm.StereoModel(rect_l, rect_r).point_cloud(
        TDM(torch.as_tensor(d32), torch.as_tensor(valid)))
    jxyz, _, jv = jsm.StereoModel(jr_l, jr_r).point_cloud(JDM(jnp.asarray(d32),
                                                              jnp.asarray(valid)))
    assert np.array_equal(tv.numpy(), np.asarray(jv)) and tv.numpy().mean() > 0.9
    pix1 = np.stack(np.meshgrid(np.arange(N), np.arange(N)), -1).astype(np.float32)
    truth = sds.triangulate64(rect_l, rect_r, pix1, pix1 + d32)
    e_jax = np.linalg.norm(np.asarray(jxyz) - truth, axis=-1)[valid].max()
    assert np.linalg.norm(txyz.numpy() - truth, axis=-1)[valid].max() <= sds.DEM_POINT_M
    assert _err(txyz, jxyz, valid) <= e_jax + sds.DEM_POINT_M
    g = scene["dem"].shape[0]
    tg, jg = scene["dem_georef"], scene["jdem_georef"]
    tdem, tdv = tcart.point_image_to_dem(txyz, tv, tg, g, g)
    jdem, jdv = jcart.point_image_to_dem(jxyz, jv, jg, g, g)
    both = tdv.numpy() & np.asarray(jdv)
    assert (tdv.numpy() == np.asarray(jdv)).mean() >= 0.95
    assert _err(tdem, jdem, both) <= HEIGHT_M + sds.DEM_POINT_M
    # each step on the JAX step's input
    sdem, sdv = tcart.point_image_to_dem(np.array(jxyz), np.array(jv), tg, g, g, device="cpu")
    assert (sdv.numpy() == np.asarray(jdv)).mean() >= 0.99
    assert _err(sdem, jdem, sdv.numpy() & np.asarray(jdv)) <= HEIGHT_M
    jnd = jnp.where(jdv, jdem, sds.DEM_NODATA)
    jshade = jcart.hillshade(jnd, scale=scene["cell_m"], nodata=sds.DEM_NODATA).data
    tshade = tcart.hillshade(np.array(jnd), scale=scene["cell_m"], nodata=sds.DEM_NODATA,
                             device="cpu").data
    assert _err(tshade, jshade) <= SAME
    trgb = tcart.colormap(np.array(jnd), nodata=sds.DEM_NODATA, shade=tshade, device="cpu")
    jrgb = jcart.colormap(jnd, nodata=sds.DEM_NODATA, shade=jshade)
    assert _err(trgb, jrgb) <= SAME
    # the port's own chain runs through (its DEM against the true DEM)
    tnd = torch.where(tdv, tdem, sds.DEM_NODATA)
    trgb = tcart.colormap(tnd, nodata=sds.DEM_NODATA, shade=tcart.hillshade(
        tnd, scale=scene["cell_m"], nodata=sds.DEM_NODATA).data)
    assert trgb.shape == (g, g, 3) and torch.isfinite(trgb).all()
    assert np.median(np.abs(tdem.numpy() - scene["dem"])[tdv.numpy()]) <= 5.0
