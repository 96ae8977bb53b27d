"""The port's file IO (``visionworkbench_torch/fileio/``: copies of the JAX
package's NumPy TIFF, EXR and ``image_io`` modules) and its correlate CLI
(``visionworkbench_torch/tools/correlate.py``) against the JAX package's, on
the CPU.

Files written by either package are read by the other, bit for bit (stripped
and tiled TIFF, 1 and 3 bands, uint8 / uint16 / float32, nodata; EXR, float
and half; PNG through ``read_image``). The two CLIs run on one small pair
with a nodata block (census 7x7, parabola): the output TIFFs' validity bands
are equal, dx/dy within 2e-4 px (measured 8.8e-5: the parabola fit, which
XLA fuses into FMAs; the pin of ``tests/test_torch_pyramid.py``).
"""

import os

import numpy as np
import pytest

from torch_parity import _torch_threads  # noqa: F401
from visionworkbench_tpu import fileio as jfio
from visionworkbench_tpu.fileio import exr as jexr
from visionworkbench_tpu.tools.correlate import main as jmain
from visionworkbench_torch import fileio as tfio
from visionworkbench_torch.fileio import exr as texr
from visionworkbench_torch.math.bbox import BBox2i
from visionworkbench_torch.stereo.pyramid_correlation import pyramid_correlate
from visionworkbench_torch.tools.correlate import main as tmain

PACKAGES = {"torch": tfio, "jax": jfio}
EXR = {"torch": texr, "jax": jexr}


def _image(rng, dtype, bands, h=37, w=53):
    shape = (h, w) + ((bands,) if bands > 1 else ())
    if np.dtype(dtype).kind == "f":
        return (rng.random(shape) * 100 - 50).astype(dtype)
    return rng.integers(0, np.iinfo(dtype).max, shape).astype(dtype)


@pytest.mark.parametrize("writer,reader", [("torch", "jax"), ("jax", "torch")])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
@pytest.mark.parametrize("bands", [1, 3])
@pytest.mark.parametrize("tile", [None, 16])
def test_tiff_cross_package(tmp_path, writer, reader, dtype, bands, tile):
    rng = np.random.default_rng(40 + bands)
    img = _image(rng, dtype, bands)
    path = str(tmp_path / "x.tif")
    PACKAGES[writer].write_tiff(path, img, nodata=7.0, tile_size=tile)
    got, info = PACKAGES[reader].read_tiff(path)
    assert got.dtype == img.dtype
    np.testing.assert_array_equal(got, img)
    assert info.nodata == 7.0 and info.tiled == (tile is not None)
    np.testing.assert_array_equal(PACKAGES[reader].read_tiff_region(path, 5, 3, 20, 11),
                                  img[3:14, 5:25])
    np.testing.assert_array_equal(PACKAGES[reader].read_image(path, None), img)
    assert PACKAGES[reader].image_size(path) == img.shape[:2]


@pytest.mark.parametrize("writer,reader", [("torch", "jax"), ("jax", "torch")])
@pytest.mark.parametrize("pixel_type,compression", [("float", "zip"), ("half", "none")])
def test_exr_cross_package(tmp_path, writer, reader, pixel_type, compression):
    rng = np.random.default_rng(44)
    img = (rng.random((19, 23, 3)) * 4 - 2).astype(np.float32)
    path = str(tmp_path / "x.exr")
    EXR[writer].write_exr(path, img, pixel_type=pixel_type, compression=compression)
    got, names = EXR[reader].read_exr(path)
    want, want_names = EXR[writer].read_exr(path)
    assert names == want_names == ["B", "G", "R"]
    np.testing.assert_array_equal(got, want)
    if pixel_type == "float":
        np.testing.assert_array_equal(got, img[..., ::-1])
    # write_image / read_image dispatch on the extension
    path1 = str(tmp_path / "y.exr")
    PACKAGES[writer].write_image(path1, img[..., 0])
    np.testing.assert_array_equal(PACKAGES[reader].read_image(path1), img[..., 0])


def test_png_read_image_both_packages(tmp_path):
    rng = np.random.default_rng(45)
    img = rng.integers(0, 256, (21, 17, 3)).astype(np.uint8)
    path = str(tmp_path / "x.png")
    tfio.write_image(path, img)
    for dtype in (None, np.float32):
        np.testing.assert_array_equal(tfio.read_image(path, dtype),
                                      jfio.read_image(path, dtype))
    np.testing.assert_array_equal(tfio.read_image(path, None), img)


def _cli_pair(tmp_path, n=96):
    """Config 7's texture in bench.py's orientation (left(p) = right(p +
    (16, 0))), the left TIFF with a nodata block."""
    rng = np.random.default_rng(11)
    ys, xs = np.mgrid[0:n, 0:n + 80].astype(np.float32)
    tex = (np.sin(xs * 0.21) * np.cos(ys * 0.17)
           + 0.5 * np.sin(xs * 0.047 + ys * 0.031)
           + 0.3 * rng.random(xs.shape)).astype(np.float32)
    left, right = tex[:, 16:16 + n].copy(), tex[:, :n].copy()
    left[30:40, 50:62] = -9999.0
    lp, rp = str(tmp_path / "left.tif"), str(tmp_path / "right.tif")
    tfio.write_tiff(lp, left, nodata=-9999.0)
    tfio.write_tiff(rp, right)
    return lp, rp, left, right


def test_correlate_cli_matches_jax(tmp_path, capsys):
    lp, rp, _, _ = _cli_pair(tmp_path)
    args = [lp, rp, "--kernel", "7", "7", "--cost-mode", "census",
            "--max-pyramid-levels", "2", "--tile-size", "32", "--xrange", "32",
            "--yrange", "4", "--yoffset", "-2", "--prefilter", "none",
            "--subpixel", "parabola"]
    assert jmain(args + ["-o", str(tmp_path / "jax")]) == 0
    assert tmain(args + ["-o", str(tmp_path / "torch")], device="cpu") == 0
    assert "Wrote" in capsys.readouterr().out
    want, _ = jfio.read_tiff(str(tmp_path / "jax.tif"))
    got, info = jfio.read_tiff(str(tmp_path / "torch.tif"))
    assert got.shape == want.shape == (96, 96, 3) and info.tiled
    np.testing.assert_array_equal(got[..., 2], want[..., 2])
    np.testing.assert_allclose(got[..., :2], want[..., :2], rtol=0, atol=2e-4)
    valid = got[..., 2] > 0.5
    assert not valid[30:40, 50:62].any()          # the nodata block
    core = np.s_[16:-16, 16:-16]
    assert (np.abs(got[..., 0] - 16)[core][valid[core]] < 0.5).mean() > 0.9


def test_correlate_cli_em_and_match_file(tmp_path):
    """``--subpixel em`` writes what ``pyramid_correlate`` returns for the
    same options (masks from the nodata tag); ``--match-file`` reads its
    file before any correlation (a missing one raises; the pre-alignment
    itself: ``tests/test_torch_ipfind_ipmatch.py``)."""
    lp, rp, left, right = _cli_pair(tmp_path)
    args = [lp, rp, "--kernel", "7", "7", "--cost-mode", "census",
            "--max-pyramid-levels", "4", "--subpixel", "em", "--prefilter", "none",
            "-o", str(tmp_path / "em")]
    assert tmain(args, device="cpu") == 0
    got, _ = tfio.read_tiff(str(tmp_path / "em.tif"))
    dm = pyramid_correlate(left, right, BBox2i(0, 0, 64, 8), kernel_size=(7, 7),
                           cost_type="census", left_mask=left != -9999.0,
                           max_pyramid_levels=4, subpixel="em", device="cpu")
    d, v = dm.to_numpy()
    np.testing.assert_array_equal(got[..., 2], v.astype(np.float32))
    np.testing.assert_array_equal(got[..., :2], d)
    with pytest.raises(FileNotFoundError):
        tmain([lp, rp, "--match-file", str(tmp_path / "x.match")], device="cpu")
    assert not os.path.exists("disparity.tif")
