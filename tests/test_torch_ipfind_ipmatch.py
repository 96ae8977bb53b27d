"""The port's interest-point tools (``visionworkbench_torch/tools/ipfind.py``,
``ipmatch.py``) and the correlate CLI's ``--match-file`` against the JAX
package's CLIs on the CPU, on a seeded textured pair written as float32
TIFFs.

* ``ipfind``: the same points (>= 99 % of the JAX package's within 1e-3
  px; measured 100 %), orientations and descriptors within the tolerances
  of ``tests/test_torch_interest.py``.
* ``ipmatch`` on the same ``.vwip`` files (the JAX package's) writes the
  same bytes, binary and text, in every RANSAC mode; a match whose ratio
  test lies within 1e-5 of its bound would be the one exception
  (measured: none). The file modes write the same bytes.
* ``correlate --match-file``: the pre-aligned right image within 2e-5 of
  the JAX package's (measured 1.7e-6: the JAX package samples through
  banded matmuls, the port through gathers of the same taps), the integer disparities and
  validity equal on >= 99.9 % of pixels (measured 100 %).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.ndimage import gaussian_filter as ndi_gauss

from torch_parity import _torch_threads  # noqa: F401
import visionworkbench_tpu.image.transform as jtransform
import visionworkbench_tpu.interest.io as jio
import visionworkbench_tpu.math.transform2d as jt2d
from visionworkbench_tpu.math.ransac import ransac as jransac
from visionworkbench_tpu.tools import correlate as jcorr
from visionworkbench_tpu.tools import ipfind as jfind
from visionworkbench_tpu.tools import ipmatch as jmatch
import visionworkbench_torch.interest.io as tio
from visionworkbench_torch.fileio import read_tiff, write_tiff
from visionworkbench_torch.tools import correlate as tcorr
from visionworkbench_torch.tools import ipfind as tfind
from visionworkbench_torch.tools import ipmatch as tmatch

# the pre-alignment scene: right = the texture under H (left -> right)
H_TRUE = np.array([[np.cos(0.005), -np.sin(0.005), 3.3],
                   [np.sin(0.005), np.cos(0.005), 0.7], [0.0, 0.0, 1.0]])


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A smooth random texture and a view shifted by (6, 4): a.tif, b.tif;
    ``ipfind`` (harris, single scale) of the JAX package on both."""
    folder = tmp_path_factory.mktemp("ip")
    rng = np.random.default_rng(31)
    base = ndi_gauss(rng.random((110, 130)), 1.5).astype(np.float32)
    paths = [str(folder / "a.tif"), str(folder / "b.tif")]
    write_tiff(paths[0], base[:96, :112].copy())
    write_tiff(paths[1], base[4:100, 6:118].copy())
    jdir = folder / "jax"
    jdir.mkdir()
    for p in paths:
        os.symlink(p, str(jdir / os.path.basename(p)))
    jpaths = [str(jdir / os.path.basename(p)) for p in paths]
    assert jfind.main([*jpaths, "--interest-operator", "harris", "--single-scale",
                       "--threshold", "1e-8", "--max-points", "64"]) == 0
    return folder, paths, jpaths


def _points(path):
    return tio.read_binary_ip_file(path)


@pytest.mark.parametrize("opts", [
    ("--interest-operator", "harris", "--single-scale", "--threshold", "1e-8"),
    ("--interest-operator", "log", "--single-scale", "--threshold", "1e-4",
     "--no-orientation", "--descriptor-generator", "patch", "-g", "2"),
])
def test_ipfind_matches_jax(pair, tmp_path, opts, capsys):
    folder, paths, _ = pair
    outs = {}
    for tag, main, kw in (("jax", jfind.main, {}), ("torch", tfind.main, {"device": "cpu"})):
        out = tmp_path / tag
        out.mkdir()
        assert main([paths[0], *opts, "--max-points", "64", "--output-dir", str(out),
                     "--print-ip", "3", "-d", "1"], **kw) == 0
        outs[tag] = _points(str(out / "a.vwip"))
        assert os.path.exists(str(out / "a_debug.png"))
    assert "ip 2:" in capsys.readouterr().out
    ref, got = outs["jax"], outs["torch"]
    a = np.stack([ref["x"], ref["y"]], -1)
    b = np.stack([got["x"], got["y"]], -1)
    dist = np.sqrt(((a[:, None] - b[None]) ** 2).sum(-1))
    paired = dist.min(1) <= 1e-3
    assert len(a) >= 20 and paired.mean() >= 0.99
    # orientations and descriptors on the points paired by nearest neighbour
    i = np.flatnonzero(paired)
    j = dist.argmin(1)[i]
    d = np.abs(got["orientation"][j] - ref["orientation"][i])
    assert (np.minimum(d, 2 * np.pi - d) <= 1e-5).mean() >= 0.97
    diff = got["descriptor"][j] - ref["descriptor"][i]
    assert (np.abs(diff).max(1) <= 1e-5).mean() >= 0.85
    assert np.linalg.norm(diff, axis=1).max() <= 0.1


@pytest.fixture(scope="module")
def jax_sift_files(pair, tmp_path_factory):
    """The JAX CLI's ``.vwip`` of a.tif with its default operator (``sift``;
    ``dog`` is the same path) and with ``obalog``."""
    _, paths, _ = pair
    out = {}
    for op in ("sift", "obalog"):
        folder = tmp_path_factory.mktemp(f"jax_{op}")
        assert jfind.main([paths[0], "--interest-operator", op, "--output-dir",
                           str(folder)]) == 0
        out[op] = _points(str(folder / "a.vwip"))
    return out


@pytest.mark.parametrize("op", ["sift", "dog", "obalog", None])
def test_ipfind_sift_class_matches_jax(pair, jax_sift_files, tmp_path, op):
    """The SIFT-class operators and the default one (``sift``) against the
    JAX CLI: points paired by nearest neighbour, then orientations and
    descriptors on the pairs, as ``tests/test_torch_sift.py`` states the
    tolerances (measured: every DoG point at 0 px, 0.95 of the
    orientations within 1e-4 rad, 0.947 of their descriptors within 1e-5,
    L2 <= 0.010). OBALoG's points move with the JAX package's fp32 integral
    images (measured: 446 of 448 within 0.01 px, one 0.25 px off on a flat
    peak), and its rotated-support descriptors with them (L2 median 2.8e-5,
    p95 0.029, max 0.109)."""
    args = [pair[1][0], "--output-dir", str(tmp_path)]
    args += [] if op is None else ["--interest-operator", op]
    assert tfind.main(args, device="cpu") == 0
    got = _points(str(tmp_path / "a.vwip"))
    ref = jax_sift_files["obalog" if op == "obalog" else "sift"]
    a = np.stack([ref["x"], ref["y"]], -1)
    b = np.stack([got["x"], got["y"]], -1)
    dist = np.sqrt(((a[:, None] - b[None]) ** 2).sum(-1))
    paired = dist.min(1) <= (1e-2 if op == "obalog" else 1e-3)
    assert len(a) >= 20 and abs(len(a) - len(b)) <= 0.01 * len(a)
    assert paired.mean() >= 0.99
    i = np.flatnonzero(paired)
    j = dist.argmin(1)[i]
    d = np.abs(got["orientation"][j] - ref["orientation"][i])
    agree = np.minimum(d, 2 * np.pi - d) <= 1e-4
    assert agree.mean() >= 0.9
    diff = (got["descriptor"][j] - ref["descriptor"][i])[agree]
    l2 = np.linalg.norm(diff, axis=1)
    if op == "obalog":
        assert np.median(l2) <= 1e-3 and (l2 <= 0.1).mean() >= 0.95
    else:
        assert (np.abs(diff).max(1) <= 1e-5).mean() >= 0.85 and l2.max() <= 0.1


@pytest.mark.parametrize("opts", [
    (),
    ("--ransac-constraint", "homography", "--inlier-threshold", "3", "--matches-as-txt"),
    ("--ransac-constraint", "none", "--matcher-threshold", "0.8"),
    ("--ransac-constraint", "fundamental", "--matcher-threshold", "0.8",
     "--ransac-iterations", "40"),
])
def test_ipmatch_writes_same_bytes(pair, tmp_path, opts, capsys):
    """On the JAX package's ``.vwip`` files (the images' folder): the same
    match file bytes."""
    _, _, jpaths = pair
    files = {}
    for tag, main, kw in (("jax", jmatch.main, {}), ("torch", tmatch.main, {"device": "cpu"})):
        prefix = str(tmp_path / f"{tag}_")
        assert main([*jpaths, "--output-prefix", prefix, *opts], **kw) == 0
        ext = ".txt" if "--matches-as-txt" in opts else ".match"
        with open(prefix + "a__b" + ext, "rb") as f:
            files[tag] = f.read()
    out = capsys.readouterr().out
    assert files["torch"] == files["jax"]
    a, b = (tio.read_text_match_file if "--matches-as-txt" in opts
            else tio.read_binary_match_file)(str(tmp_path / ("torch_a__b" + ext)))
    assert len(a["x"]) >= 10
    if "none" not in opts:
        assert out.count("RANSAC kept") == 2
        np.testing.assert_allclose(a["x"] - b["x"], 6.0, atol=0.5)
        np.testing.assert_allclose(a["y"] - b["y"], 4.0, atol=0.5)


def test_ipmatch_debug_image_and_file_modes(pair, tmp_path):
    _, _, jpaths = pair
    prefix = str(tmp_path / "d_")
    assert tmatch.main([*jpaths, "--output-prefix", prefix, "--debug-image"],
                       device="cpu") == 0
    assert os.path.exists(prefix + "a__b_debug.png")
    m = prefix + "a__b.match"
    extra = str(tmp_path / "extra.match")
    a, b = tio.read_binary_match_file(m)
    tio.write_binary_match_file(extra, {"x": np.r_[a["x"][:3], 1.5], "y": np.r_[a["y"][:3], 2.5]},
                                {"x": np.r_[b["x"][:3], 3.5], "y": np.r_[b["y"][:3], 4.5]})
    outs = {}
    for tag, main in (("jax", jmatch.main), ("torch", tmatch.main)):
        t = str(tmp_path / f"{tag}.txt")
        back = str(tmp_path / f"{tag}_back.match")
        merged = str(tmp_path / f"{tag}_merged.match")
        assert main(["--binary-to-txt", m, t]) == 0
        assert main(["--txt-to-binary", t, back]) == 0
        assert main(["--merge-match-files", m, extra, merged]) == 0
        outs[tag] = [open(f, "rb").read() for f in (t, back, merged)]
    assert outs["torch"] == outs["jax"]
    assert len(tio.read_binary_match_file(str(tmp_path / "torch_merged.match"))[0]["x"]) \
        == len(a["x"]) + 1


def _texture(x, y):
    return (np.sin(0.31 * x) * np.cos(0.23 * y) + 0.5 * np.sin(0.07 * x + 0.11 * y)
            + 0.3 * np.cos(0.53 * x - 0.41 * y)).astype(np.float32)


@pytest.fixture(scope="module")
def match_scene(tmp_path_factory):
    """left = the texture, right = the texture under ``H_TRUE``, and a match
    file (written by the port's ``interest/io``) of 40 exact
    correspondences and 10 outliers 30-60 px off."""
    folder = tmp_path_factory.mktemp("mf")
    h, w = 64, 96
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    inv = np.linalg.inv(H_TRUE)
    sx = inv[0, 0] * xx + inv[0, 1] * yy + inv[0, 2]
    sy = inv[1, 0] * xx + inv[1, 1] * yy + inv[1, 2]
    left, right = _texture(xx, yy), _texture(sx, sy)
    rng = np.random.default_rng(41)
    p1 = rng.random((50, 2)) * [w - 1, h - 1]
    p2 = (np.hstack([p1, np.ones((50, 1))]) @ H_TRUE.T)[:, :2]
    p2[:10] += (rng.random((10, 2)) * 30 + 30) * rng.choice([-1, 1], (10, 2))
    paths = [str(folder / n) for n in ("left.tif", "right.tif", "lr.match")]
    write_tiff(paths[0], left)
    write_tiff(paths[1], right)
    tio.write_binary_match_file(paths[2], {"x": p1[:, 0], "y": p1[:, 1]},
                                {"x": p2[:, 0], "y": p2[:, 1]})
    return folder, paths, left, right


def test_match_file_prealignment_matches_jax(match_scene, capsys):
    _, paths, left, right = match_scene
    got = tcorr._prealign(paths[2], right, left.shape, "cpu").numpy()
    assert "from 40 inliers" in capsys.readouterr().out
    d1, d2 = jio.read_binary_match_file(paths[2])
    t, inliers = jransac(np.stack([d2["x"], d2["y"]], -1), np.stack([d1["x"], d1["y"]], -1),
                         "homography", 10.0, 100)
    assert len(inliers) == 40
    ref = np.asarray(jtransform.transform(
        jnp.asarray(right), jt2d.HomographyTransform(t.matrix).inverse(), left.shape))
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)


def test_correlate_match_file_matches_jax(match_scene, capsys):
    """Both CLIs end to end with the match file: the right image
    pre-aligned (the residual disparity is H_TRUE applied twice: ~(6.6,
    1.4) plus 0.6 degrees), then the pyramid correlation."""
    folder, paths, _, _ = match_scene
    args = [paths[0], paths[1], "--match-file", paths[2], "--kernel", "7", "7",
            "--max-pyramid-levels", "1", "--tile-size", "32", "--xrange", "16",
            "--yrange", "8", "--yoffset", "-2", "--prefilter", "none"]
    assert jcorr.main(args + ["-o", str(folder / "jax")]) == 0
    assert tcorr.main(args + ["-o", str(folder / "torch")], device="cpu") == 0
    assert capsys.readouterr().out.count("from 40 inliers") == 2
    want, _ = read_tiff(str(folder / "jax.tif"))
    got, _ = read_tiff(str(folder / "torch.tif"))
    assert got.shape == want.shape == (64, 96, 3)
    same = (got == want).all(-1)
    assert same.mean() >= 0.999
    valid = got[..., 2] > 0.5
    core = np.s_[8:-8, 8:-8]
    assert valid[core].mean() > 0.8
    # the residual disparity: H_TRUE applied twice, less the position
    yy, xx = np.mgrid[0:64, 0:96].astype(np.float64)
    h2 = H_TRUE @ H_TRUE
    ex = h2[0, 0] * xx + h2[0, 1] * yy + h2[0, 2] - xx
    ey = h2[1, 0] * xx + h2[1, 1] * yy + h2[1, 2] - yy
    ok = (np.abs(got[..., 0] - ex) <= 1.0) & (np.abs(got[..., 1] - ey) <= 1.0)
    assert ok[core][valid[core]].mean() > 0.9
