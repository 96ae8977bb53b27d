"""Port's on-disk pyramid (``visionworkbench_torch/mosaic/pyramid.py``) and
``tools/image2qtree.py`` against the JAX package's on the CPU, on the same
seeded inputs.

Tolerances: pyramid levels within 1e-6 on [0, 1) data (the 5-tap kernel's
products and sums may round differently: the JAX package's XLA code may
contract them into fused multiply-adds; measured max printed). image2qtree's
tile list and KML text are equal; its PNG tiles are uint8, so a value
within ~1e-5 of a quantization step can flip by one step: decoded tiles
within 1/255 everywhere and equal on >= 0.999 of the pixels.
"""

import glob
import os

import numpy as np
import pytest

from torch_parity import _torch_threads  # noqa: F401
import visionworkbench_tpu.fileio.tiff as jtiff
import visionworkbench_tpu.math.bbox as jbbox
import visionworkbench_tpu.mosaic as jmosaic
import visionworkbench_tpu.mosaic.pyramid as jpyr
from visionworkbench_tpu.tools.image2qtree import main as jmain
import visionworkbench_torch.fileio as tfileio
import visionworkbench_torch.math.bbox as tbbox
import visionworkbench_torch.mosaic as tmosaic
import visionworkbench_torch.mosaic.pyramid as tpyr
from visionworkbench_torch.tools.image2qtree import main as tmain

LEVEL_ATOL = 1e-6
SCALES = (1.0, 0.7, 0.5, 0.25, 0.1, 1 / 64, 1e-4)


@pytest.fixture(scope="module")
def pyramids(tmp_path_factory):
    d = tmp_path_factory.mktemp("pyr")
    img = np.random.default_rng(21).random((300, 260)).astype(np.float32)
    path = str(d / "base.tif")
    jtiff.write_tiff(path, img, tile_size=64)
    jp = jpyr.DiskImagePyramid(path, min_dimension=32, cache_dir=str(d / "jax"),
                               tile_size=64)
    tp = tpyr.DiskImagePyramid(path, min_dimension=32, cache_dir=str(d / "torch"),
                               tile_size=64, device="cpu")
    return img, jp, tp


def test_pyramid_export():
    assert tmosaic.DiskImagePyramid is tpyr.DiskImagePyramid
    assert hasattr(jmosaic, "DiskImagePyramid")


def test_pyramid_levels(pyramids):
    """The same number of levels and shapes; every level within 1e-6."""
    img, jp, tp = pyramids
    assert tp.num_levels == jp.num_levels == 4       # 300x260 -> 150, 75, 37
    errs = []
    for jl, tl in zip(jp.levels, tp.levels):
        got, want = tl.read(), jl.read()
        assert got.shape == want.shape and got.dtype == np.float32
        errs.append(float(np.abs(got - want).max()))
    print(f"pyramid levels: max |port - JAX| per level {errs}")
    assert max(errs) <= LEVEL_ATOL
    np.testing.assert_array_equal(tp.levels[0].read(), img)
    assert os.path.dirname(tp.levels[1].path) == tp.cache_dir


@pytest.mark.parametrize("scale", SCALES)
def test_pyramid_clip(pyramids, scale):
    """``get_image_clip``: the same level and shape, values within 1e-6."""
    _, jp, tp = pyramids
    for box in ((0, 0, 260, 300), (37, 51, 129, 77), (250, 290, 10, 10)):
        got, gl = tp.get_image_clip(scale, tbbox.BBox2i(*box))
        want, wl = jp.get_image_clip(scale, jbbox.BBox2i(*box))
        assert gl == wl == tp.level_for_scale(scale) == jp.level_for_scale(scale)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=LEVEL_ATOL)


def _inputs(folder):
    """The two inputs of ``tests/test_tools.py``'s projection corner case:
    a geographic frame and an overlapping UTM zone 11N frame."""
    from visionworkbench_tpu.cartography import GeoReference, make_geographic_georef
    from visionworkbench_tpu.cartography.datum import well_known_datum
    from visionworkbench_tpu.cartography.projection import UTMProjection
    rng = np.random.default_rng(42)
    g_geo = make_geographic_georef(-120.0, 40.0, 0.001)
    yy, xx = np.mgrid[0:80, 0:96].astype(np.float32)
    img1 = (0.4 + 0.3 * np.sin(xx * 0.2) * np.cos(yy * 0.15)
            + 0.1 * rng.random((80, 96))).astype(np.float32)
    p1 = str(folder / "geo.tif")
    jtiff.write_tiff(p1, img1, georef=g_geo)
    datum = well_known_datum("WGS84")
    utm = UTMProjection(datum, 11, True)
    ex, ny = (float(v) for v in utm.forward(-119.96, 39.995))
    t = np.array([[90.0, 0.0, ex], [0.0, -90.0, ny], [0.0, 0.0, 1.0]])
    img2 = (0.6 + 0.2 * np.cos(xx * 0.12) + 0.1 * rng.random((80, 96))).astype(np.float32)
    p2 = str(folder / "utm.tif")
    jtiff.write_tiff(p2, img2, georef=GeoReference(datum, utm, t))
    return [p1, p2]


def _tile_list(name):
    out = []
    for p in glob.glob(os.path.join(name, "*", "*", "*.png")):
        level, x, y = p.split(os.sep)[-3:]
        out.append((int(level), int(x), int(os.path.splitext(y)[0])))
    return sorted(out)


@pytest.mark.parametrize("blend", ["multiband", "draft"])
def test_image2qtree_matches(tmp_path, capsys, blend):
    """The same tiles, KML text and printed lines; tiles within one uint8
    step everywhere and equal on >= 0.999 of the pixels."""
    inputs = _inputs(tmp_path)
    args = ["--tile-size", "32", "--blend", blend, "-m", "kml"]
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    jname, tname = str(tmp_path / "jax" / "qt"), str(tmp_path / "torch" / "qt")
    assert jmain(inputs + ["-o", jname] + args) == 0
    jout = capsys.readouterr().out
    assert tmain(inputs + ["-o", tname] + args, device="cpu") == 0
    tout = capsys.readouterr().out
    assert tout.replace(tname, "NAME") == jout.replace(jname, "NAME")
    tiles = _tile_list(tname)
    assert tiles == _tile_list(jname) and len(tiles) >= 5
    assert len({t[0] for t in tiles}) >= 2
    with open(jname + ".kml") as f, open(tname + ".kml") as g:
        assert g.read() == f.read()
    flips = total = 0
    for level, x, y in tiles:
        rel = os.path.join(str(level), str(x), f"{y}.png")
        got = tfileio.read_image(os.path.join(tname, rel)).astype(np.int16)
        want = tfileio.read_image(os.path.join(jname, rel)).astype(np.int16)
        assert got.shape == want.shape
        d = np.abs(got - want)
        assert d.max() <= 1, (rel, d.max())
        flips += int((d > 0).sum())
        total += d.size
    print(f"image2qtree {blend}: {flips} of {total} tile pixels one step apart")
    assert flips <= 1e-3 * total
