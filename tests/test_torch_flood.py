"""The port's flood suite (``visionworkbench_torch/tools/flood/``, the
``detect_water``, ``clean_sentinel1_borders``, ``sentinel1_flood_detect``,
``extract_modis`` and ``georef_query`` tools) against the JAX package on the
CPU, on the same numpy-seeded inputs.

* Sentinel-1 (Martinis), stage by stage, each port stage fed the JAX
  package's output of the stage before (so ``log10`` ulps do not cascade):
  ``proc`` at rtol 1e-5 (``valid`` equal); tile means at rtol 1e-5
  (``tvalid`` equal); the tile deviations, which cancel, at rtol 1e-6 of a
  float64 oracle (the port sums and keeps the statistics in float64; the
  JAX package's fp32 sums put its deviations up to ~1.5e-3 relative off it)
  and within the JAX package's own distance to the oracle; kept tiles equal;
  the threshold within 1e-4; the fuzzy members and the classes equal. End
  to end on ``tests/test_flood.py``'s three SAR scenes: the threshold within
  1e-3 and the classes equal on >= 0.999 of the pixels.
* Landsat, WorldView, SPOT and MODIS: score and index planes at rtol 1e-5
  and atol 1e-6 (the TOA planes at rtol 1e-5 -- ``log`` in the thermal
  band), class maps equal, on ``flood_scene.py``'s scenes at 256² (MODIS
  bands 3-7 at 128²).
* The tools on the same files and on SAR scenes of 216² (turned, warped to
  256²) and 256² (``tests/test_flood.py:311-330``'s generator; its 64² in
  the JAX package's test): outputs equal (the SAR tools' class maps on >= 0.999 of the
  pixels), printed lines equal but for the Martinis threshold's digits.
* ``detect_water --mode sentinel1`` runs Martinis at 10 m a pixel in both
  packages whatever the georeference says (``ROADMAP.md`` section 3).
"""

import re

import numpy as np
import pytest
import torch

from torch_parity import _torch_threads  # noqa: F401
import flood_scene as fs
import visionworkbench_tpu.tools.flood as jfl
import visionworkbench_torch.tools.flood as tfl
from visionworkbench_tpu.fileio import read_tiff as jread, write_tiff as jwrite
from visionworkbench_torch.fileio import read_tiff as tread

SAR_N = 256
SAR_TILE = 64
# Every JAX-package run of one block compiles one shape: the SAR tools' scene
# of 216² turned by 11.8 degrees warps onto 256² north up, and the optical
# scenes are 256² (MODIS bands 3-7 128²).
TOOL_N, TOOL_DEG = 216, 11.8
OPT_N = MODIS_N = SAR_N
RTOL = 1e-5
ATOL = 1e-6


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------- common

def test_common_helpers_match_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform(-1, 1, 200).astype(np.float32)
    b = rng.uniform(-1, 1, 200).astype(np.float32)
    b[:20] = -a[:20]                       # zero denominators
    assert np.array_equal(_np(tfl.compute_index(a, b, device="cpu")),
                          np.asarray(jfl.compute_index(a, b)))
    assert np.array_equal(_np(tfl.rescale_to_01(a, 0.3, 0.8, device="cpu")),
                          np.asarray(jfl.rescale_to_01(a, 0.3, 0.8)))
    assert np.array_equal(_np(tfl.clamp01(3 * a, device="cpu")), np.asarray(jfl.clamp01(3 * a)))
    for when in [(2016, 1, 3, 17, 46, 54.8), (2023, 10, 23, 0, 0, 0.0)]:
        assert tfl.compute_earth_sun_distance(*when) == jfl.compute_earth_sun_distance(*when)


# ---------------------------------------------------------------- radar

def _sar_scene(seed=42, h=SAR_N, w=SAR_N, dem=False):
    """``tests/test_flood.py``'s synthetic SAR scenes."""
    rng = np.random.default_rng(seed)
    dn = rng.normal(1000.0, 150.0, (h, w)).clip(200.0)
    dn[96:160, :] = rng.normal(30.0, 5.0, (64, w)).clip(5.0)
    out = {"dn": dn.astype(np.float32), "dem": None}
    if dem:
        d = np.zeros((h, w), np.float32)
        d[:64, :] = np.linspace(200.0, 0.0, 64)[:, None]
        out["dem"] = d
    return out


@pytest.fixture(scope="module")
def sar():
    """The JAX package's stages on the 256² scene (with its DEM)."""
    sc = _sar_scene(3, dem=True)
    dn, valid = sc["dn"], sc["dn"] > 0
    proc, pvalid = jfl.radar.preprocess_sentinel1(dn, valid)
    means, stds, tvalid = jfl.radar.generate_tile_means(proc, pvalid, SAR_TILE)
    kept = jfl.radar.select_best_tiles(means, stds, tvalid)
    out = {}
    for with_dem in (False, True):
        out[with_dem] = jfl.radar.sar_martinis(dn, valid, dem=sc["dem"] if with_dem else None,
                                               tile_size=SAR_TILE)
    return dict(sc, valid=valid, proc=np.asarray(proc), pvalid=np.asarray(pvalid),
                means=np.asarray(means), stds=np.asarray(stds), tvalid=np.asarray(tvalid),
                kept=kept, threshold=jfl.radar.compute_global_threshold(proc, pvalid, kept,
                                                                        SAR_TILE),
                result=out)


def test_preprocess_matches_jax(sar):
    proc, pvalid = tfl.radar.preprocess_sentinel1(sar["dn"], sar["valid"], device="cpu")
    np.testing.assert_allclose(_np(proc), sar["proc"], rtol=RTOL)
    assert np.array_equal(_np(pvalid), sar["pvalid"])


def _tile_stats64(proc, pvalid, ts):
    """Float64 oracle of ``generate_tile_means``."""
    h, w = proc.shape
    th, tw, hs = h // ts, w // ts, ts // 2
    six = (th, 2, hs, tw, 2, hs)
    keep = pvalid[:th * ts, :tw * ts]
    sub = np.where(keep, proc[:th * ts, :tw * ts], 0.0).astype(np.float64).reshape(six)
    count = keep.reshape(six).sum((2, 5)).astype(np.float64)
    mean = sub.sum((2, 5)) / np.maximum(count, 1.0)
    used = count / (hs * hs) >= 0.95
    n = used.sum((1, 3))
    mom = (mean * used).sum((1, 3)) / np.maximum(n, 1)
    d = (mean - mom[:, None, :, None]) * used
    std = np.where(n > 1, np.sqrt((d * d).sum((1, 3)) / np.maximum(n - 1, 1)), 0.0)
    return mom, std


def test_tile_statistics_and_threshold_match_jax(sar):
    """Means at rtol 1e-5 of the JAX package's; the deviations, which
    cancel (four sub-tile means of ~100 a few tenths apart), at rtol 1e-6
    of a float64 oracle, and as close to the JAX package's as its own fp32
    sums are to the oracle."""
    means, stds, tvalid = tfl.radar.generate_tile_means(sar["proc"], sar["pvalid"], SAR_TILE,
                                                        device="cpu")
    mom64, std64 = _tile_stats64(sar["proc"], sar["pvalid"], SAR_TILE)
    np.testing.assert_allclose(_np(means), sar["means"], rtol=RTOL)
    np.testing.assert_allclose(_np(means), mom64, rtol=1e-6)
    np.testing.assert_allclose(_np(stds), std64, rtol=1e-6, atol=1e-9)
    jax_err = np.abs(sar["stds"] - std64)
    assert (np.abs(_np(stds) - sar["stds"]) <= jax_err + 1e-6 * std64 + 1e-9).all()
    assert np.array_equal(_np(tvalid), sar["tvalid"])
    kept = tfl.radar.select_best_tiles(sar["means"], sar["stds"], sar["tvalid"])
    assert kept == sar["kept"] and kept
    assert tfl.radar.select_best_tiles(_np(means), _np(stds), _np(tvalid)) == kept
    thr = tfl.radar.compute_global_threshold(torch.as_tensor(sar["proc"]),
                                             torch.as_tensor(sar["pvalid"]), kept, SAR_TILE)
    assert abs(thr - sar["threshold"]) <= 1e-4


def test_kittler_illingworth_and_fuzzy_members_match_jax():
    rng = np.random.default_rng(0)
    vals = np.concatenate([rng.normal(60, 8, 4000), rng.normal(250, 15, 6000)])
    hist, _ = np.histogram(vals, bins=255, range=(0.0, 400.0))
    assert (tfl.radar.split_histogram_kittler_illingworth(hist, 0.0, 400.0)
            == jfl.radar.split_histogram_kittler_illingworth(hist, 0.0, 400.0))
    v = rng.uniform(-5, 20, 4096).astype(np.float32)
    for fn in ("fuzzy_membership_z", "fuzzy_membership_s"):
        got = _np(getattr(tfl.radar, fn)(v, 3.3, 11.7, device="cpu"))
        assert np.array_equal(got, np.asarray(getattr(jfl.radar, fn)(v, 3.3, 11.7))), fn


@pytest.mark.parametrize("with_dem", [False, True], ids=["no_dem", "dem"])
def test_refinement_matches_jax(sar, with_dem):
    """Stages 5-6 from the JAX package's proc, validity and threshold."""
    want = sar["result"][with_dem]
    classes, raw, defuzzed = tfl.radar._refine(
        torch.as_tensor(sar["proc"]), torch.as_tensor(sar["pvalid"]), want.threshold, 10.0,
        sar["dem"] if with_dem else None, 1.0)
    assert np.array_equal(_np(raw), want.raw_water)
    np.testing.assert_allclose(_np(defuzzed), want.defuzzed, rtol=RTOL, atol=ATOL)
    assert np.array_equal(_np(classes), want.classes)


@pytest.mark.parametrize("scene", ["synthetic", "dem", "flat"])
def test_sar_martinis_end_to_end_matches_jax(scene):
    if scene == "flat":
        # at 256² and tile 64 (tests/test_flood.py: 128², tile 32), so that
        # every Martinis run of this block compiles one shape in the JAX
        # package
        rng = np.random.default_rng(1)
        sc = {"dn": rng.normal(1000.0, 5.0, (SAR_N, SAR_N)).clip(1.0).astype(np.float32),
              "dem": None}
    else:
        sc = _sar_scene(42 if scene == "synthetic" else 3, dem=scene == "dem")
    tile = SAR_TILE
    try:
        want = jfl.radar.sar_martinis(sc["dn"], dem=sc["dem"], tile_size=tile)
    except ValueError:
        with pytest.raises(ValueError):
            tfl.radar.sar_martinis(sc["dn"], dem=sc["dem"], tile_size=tile, device="cpu")
        return
    got = tfl.radar.sar_martinis(sc["dn"], dem=sc["dem"], tile_size=tile, device="cpu")
    assert abs(got.threshold - want.threshold) <= 1e-3
    assert (_np(got.classes) == want.classes).mean() >= 0.999
    assert got.classes.dtype == torch.uint8 and got.classes.device.type == "cpu"


# ------------------------------------------------------------ optical

@pytest.fixture(scope="module")
def optical(tmp_path_factory):
    """flood_scene's Landsat 8, WorldView-3, SPOT-6 and MODIS scenes,
    written once."""
    folder = str(tmp_path_factory.mktemp("optical"))
    return {"folder": folder,
            "landsat": fs.landsat8(OPT_N, 31, "cpu", folder),
            "worldview": fs.worldview3(OPT_N, 32, "cpu", folder),
            "spot": fs.spot6(OPT_N, 33, "cpu", folder),
            "modis": fs.modis(MODIS_N, 34, "cpu", folder)}


def test_landsat_matches_jax(optical):
    paths = optical["landsat"]["paths"]
    jstack, jvalid, _ = jfl.landsat.load_landsat_image(paths)
    stack, valid, _ = tfl.landsat.load_landsat_image(paths)
    assert np.array_equal(stack, jstack) and np.array_equal(valid, jvalid)
    jmd = jfl.landsat.load_landsat_metadata(paths)
    md = tfl.landsat.load_landsat_metadata(paths)
    for f in ("rad_mult", "rad_add", "toa_mult", "toa_add", "k_constants"):
        assert np.array_equal(getattr(md, f), getattr(jmd, f)), f
    assert md.sun_elevation_degrees == jmd.sun_elevation_degrees
    jtoa = np.asarray(jfl.landsat.convert_to_toa(stack, jmd))
    toa = tfl.landsat.convert_to_toa(stack, md, device="cpu")
    np.testing.assert_allclose(_np(toa), jtoa, rtol=RTOL)
    t = torch.as_tensor(jtoa)
    assert np.array_equal(_np(tfl.landsat.detect_clouds(t)),
                          np.asarray(jfl.landsat.detect_clouds(jtoa)))
    np.testing.assert_allclose(_np(tfl.landsat.detect_water_score(t)),
                               np.asarray(jfl.landsat.detect_water_score(jtoa)),
                               rtol=RTOL, atol=ATOL)
    for sens in (1.0, 1.3):
        got = tfl.landsat.detect_water(stack, md, valid, sens, device="cpu")
        assert np.array_equal(_np(got), np.asarray(jfl.landsat.detect_water(stack, jmd, valid,
                                                                             sens))), sens


def test_worldview_and_spot_match_jax(optical):
    paths = optical["worldview"]["paths"]
    img = tread(paths[0])[0]
    jmd = jfl.multispectral.load_worldview23_metadata(paths)
    md = tfl.multispectral.load_worldview23_metadata(paths)
    assert md.earth_sun_distance == jmd.earth_sun_distance
    assert np.array_equal(md.abs_cal_factor, jmd.abs_cal_factor)
    jtoa = np.asarray(jfl.multispectral.convert_to_toa(img, jmd))
    np.testing.assert_allclose(_np(tfl.multispectral.convert_to_toa(img, md, device="cpu")),
                               jtoa, rtol=RTOL, atol=ATOL)
    t = torch.as_tensor(jtoa)
    for fn in ("compute_ndvi", "compute_ndwi", "compute_ndwi2", "compute_sdi"):
        np.testing.assert_allclose(_np(getattr(tfl.multispectral, fn)(t)),
                                   np.asarray(getattr(jfl.multispectral, fn)(jtoa)),
                                   rtol=RTOL, atol=ATOL, err_msg=fn)
    valid = (img != 0).any(-1)
    valid[:3, :3] = False
    for sens in (1.0, 0.7):
        got = tfl.multispectral.detect_water_worldview23(img, md, valid, sens, device="cpu")
        want = jfl.multispectral.detect_water_worldview23(img, jmd, valid, sens)
        assert np.array_equal(_np(got), np.asarray(want)), sens
    spot = tread(optical["spot"]["paths"][0])[0]
    for sens in (1.0, 0.7):
        got = tfl.multispectral.detect_water_spot67(spot, valid, sens, device="cpu")
        assert np.array_equal(_np(got), np.asarray(
            jfl.multispectral.detect_water_spot67(spot, valid, sens))), sens


def _modis_stack(optical):
    """The 7-band stack: bands 3-7 repeated onto band 1's grid."""
    bands = [tread(p)[0].astype(np.float32) for p in optical["modis"]["paths"]]
    return np.stack([b if b.shape[0] == MODIS_N else np.repeat(np.repeat(b, 2, 0), 2, 1)
                     for b in bands], -1)


@pytest.mark.parametrize("method, threshold", [
    ("evi", None), ("xiao", None), ("diff", 0.0), ("dartmouth", 0.5), ("mod_ndwi", 0.1),
    ("fai", 100.0)])
def test_modis_methods_match_jax(optical, method, threshold):
    stack = _modis_stack(optical)
    if method == "evi":
        np.testing.assert_allclose(_np(tfl.modis.form_modis_products(stack, device="cpu")),
                                   np.asarray(jfl.modis.form_modis_products(stack)),
                                   rtol=RTOL, atol=ATOL)
    got = tfl.modis.detect_water(stack, method, threshold, device="cpu")
    assert np.array_equal(_np(got), np.asarray(jfl.modis.detect_water(stack, method,
                                                                       threshold)))


# ------------------------------------------------------------ tools

def _run(capsys, main, argv, **kw):
    assert main(argv, **kw) == 0
    return capsys.readouterr().out


def _tool_runs(capsys, tmp_path, name, argv_of, compare_share=1.0, out_name="out.tif"):
    """The JAX package's and the port's ``main`` of tool ``name`` on the same
    arguments (``argv_of(prefix)``); returns the two printed outputs after
    checking the written files."""
    import importlib
    jmain = importlib.import_module(f"visionworkbench_tpu.tools.{name}").main
    tmain = importlib.import_module(f"visionworkbench_torch.tools.{name}").main
    outs = {}
    for tag, main, kw in (("jax", jmain, {}), ("port", tmain, {"device": "cpu"})):
        d = tmp_path / tag
        d.mkdir()
        outs[tag] = (_run(capsys, main, argv_of(str(d)), **kw).replace(str(d), "<d>"),
                     tread(str(d / out_name)))
    (jtext, (jarr, jinfo)), (ttext, (tarr, tinfo)) = outs["jax"], outs["port"]
    assert tarr.dtype == jarr.dtype and tarr.shape == jarr.shape
    assert (tarr == jarr).mean() >= compare_share
    assert tinfo.nodata == jinfo.nodata
    assert np.array_equal(tinfo.geo_transform(), jinfo.geo_transform())
    return jtext, ttext


def _digits(text):
    """Printed text with the numbers after 'threshold:' blanked."""
    return re.sub(r"threshold: [0-9.]+", "threshold: <t>", text)


@pytest.fixture(scope="module")
def sar_files(tmp_path_factory):
    """A rotated, georeferenced GRD scene (flood_scene's generator, a river
    6-20 px wide) with its 30 m DEM, and ``tests/test_flood.py:311-330``'s
    north-up scene at the rotated one's warped size."""
    folder = tmp_path_factory.mktemp("sar")
    sc = fs.sentinel1(TOOL_N, 35, "cpu", str(folder), river_px=(6.0, 20.0),
                      rotation_deg=TOOL_DEG)
    shape = fs.north_up(sc["georef"], TOOL_N)[1]
    rng = np.random.default_rng(7)
    plain = rng.normal(1000.0, 150.0, shape).clip(200.0).astype(np.float32)
    plain[96:160, :] = (30.0 + 5.0 * rng.random((64, shape[1]))).astype(np.float32)
    jwrite(str(folder / "plain.tif"), plain)
    return {"rotated": sc["path"], "dem": fs.s1_dem(sc, TOOL_N, "cpu", str(folder)),
            "plain": str(folder / "plain.tif")}


@pytest.mark.parametrize("case", ["rotated", "rotated_dem", "plain"])
def test_sentinel1_flood_detect_matches_jax(capsys, tmp_path, sar_files, case):
    tile = ["--tile-size", str(SAR_TILE)]
    extra = {"rotated": tile, "rotated_dem": tile + ["--dem-path", sar_files["dem"]],
             "plain": tile + ["--skip-warp", "--border-threshold", "1.0"]}[case]
    src = sar_files["plain" if case == "plain" else "rotated"]
    jtext, ttext = _tool_runs(capsys, tmp_path, "sentinel1_flood_detect",
                              lambda d: [src, d + "/out.tif"] + extra, 0.999)
    assert _digits(ttext) == _digits(jtext)
    jt, tt = (float(re.search(r"threshold: ([0-9.]+)", t).group(1)) for t in (jtext, ttext))
    assert abs(tt - jt) <= 1e-3
    if case != "plain":
        for inter in ("out.tif_clean.tif", "out.tif_WARP.tif"):
            jarr, _ = tread(str(tmp_path / "jax" / inter))
            tarr, _ = tread(str(tmp_path / "port" / inter))
            assert tarr.dtype == jarr.dtype
            if inter.endswith("clean.tif"):
                assert np.array_equal(tarr, jarr)
            else:
                # the bicubic warp through fp32 lon/lat (one ulp of longitude
                # is ~0.07 px here, so a few samples land apart; ROADMAP.md
                # section 3)
                assert (np.abs(tarr - jarr) <= 1.0).mean() >= 0.99


def test_clean_sentinel1_borders_matches_jax(capsys, tmp_path, sar_files):
    jtext, ttext = _tool_runs(capsys, tmp_path, "clean_sentinel1_borders",
                              lambda d: [sar_files["rotated"], "-o", d + "/out.tif",
                                         "--nodata-value", "0"])
    assert ttext == jtext


@pytest.mark.parametrize("mode", ["landsat", "worldview", "spot", "modis", "ndwi", "sar_fixed"])
def test_detect_water_matches_jax(capsys, tmp_path, optical, sar_files, mode):
    inputs = {"landsat": optical["landsat"]["paths"],
              "worldview": optical["worldview"]["paths"],
              "spot": optical["spot"]["paths"],
              "ndwi": optical["worldview"]["paths"][:1],
              "sar_fixed": [sar_files["plain"]]}
    args = {"ndwi": ["--mode", "worldview", "--nodata-value", "500", "--min-blob-area", "3"],
            "sar_fixed": ["--mode", "sentinel1", "--threshold", "500", "--nodata-value", "0"]}
    if mode == "modis":
        # extract_modis first: band 1's grid, bands 3-7 upsampled
        jtext, ttext = _tool_runs(capsys, tmp_path, "extract_modis",
                                  lambda d: optical["modis"]["paths"] + ["--prefix", d + "/"],
                                  out_name="modis_stack.tif")
        assert ttext == jtext
        for tag in ("jax", "port"):
            (tmp_path / tag).rename(tmp_path / f"{tag}_stack")
        inputs["modis"] = [str(tmp_path / "port_stack" / "modis_stack.tif")]
    argv = inputs[mode] + args.get(mode, ["--mode", mode])
    jtext, ttext = _tool_runs(capsys, tmp_path, "detect_water",
                              lambda d: argv + ["-o", d + "/out.tif"])
    assert ttext == jtext


def test_detect_water_martinis_runs_at_10m(capsys, tmp_path, monkeypatch, sar_files):
    """Both packages run Martinis at 10 m a pixel on a 20 m georeferenced
    input: neither GeoReference has ``meters_per_pixel``."""
    import visionworkbench_tpu.cartography.georeference as jgeo
    import visionworkbench_torch.cartography.georeference as tgeo
    import visionworkbench_tpu.tools.flood.radar as jradar
    import visionworkbench_torch.tools.flood.radar as tradar
    assert not hasattr(jgeo.GeoReference, "meters_per_pixel")
    assert not hasattr(tgeo.GeoReference, "meters_per_pixel")
    arr, info = jread(sar_files["plain"])
    g = jgeo.GeoReference.from_epsg(32615, transform=np.array(
        [[20.0, 0, 6e5], [0, -20.0, 3.4e6], [0, 0, 1]]))
    src = str(tmp_path / "grd20.tif")
    jwrite(src, arr, georef=g)
    seen = {}
    for tag, mod in (("jax", jradar), ("port", tradar)):
        orig = mod.sar_martinis

        def spy(*a, _orig=orig, _tag=tag, **kw):
            seen[_tag] = kw["meters_per_pixel"]
            return _orig(*a, **kw)
        monkeypatch.setattr(mod, "sar_martinis", spy)
    _tool_runs(capsys, tmp_path, "detect_water",
               lambda d: [src, "--mode", "sentinel1", "--tile-size", str(SAR_TILE),
                          "-o", d + "/out.tif"],
               0.999)
    assert seen == {"jax": 10.0, "port": 10.0}


def test_georef_query_matches_jax(capsys, sar_files):
    from visionworkbench_tpu.tools.georef_query import main as jmain
    from visionworkbench_torch.tools.georef_query import main as tmain
    src = sar_files["rotated"]
    for argv in ([src], [src, "--print-bounds", "--row", "3", "--col", "5", "--lat", "30.73",
                         "--lon", "-91.95", "--output-format", "1"]):
        want = _run(capsys, jmain, argv)
        assert _run(capsys, tmain, argv, device="cpu") == want, argv


def test_extract_modis_missing_band(capsys, tmp_path, optical):
    from visionworkbench_torch.tools.extract_modis import main
    assert main(optical["modis"]["paths"][:3], device="cpu") == 1
    assert "missing MODIS channels" in capsys.readouterr().err
