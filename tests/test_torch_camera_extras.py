"""Port's ``camera/{linescan, exif, bayer, solve, optical_bar}`` and the
``print_exif`` / ``convert_pinhole_model`` tools against the JAX package on
the CPU, on the same seeded inputs.

Tolerances (fp32; measured max in brackets):

* ``linescan`` and ``exif`` are the JAX package's NumPy code, copied: equal,
  on ``tests/test_linescan.py``'s cases and ``tests/test_camera.py``'s EXIF
  byte fixture (both byte orders). ``linescan_point_to_pixel`` of an
  optical-bar model (fp32 rays) within 1e-3 px of the JAX package's.
* ``bayer_demosaic``: within 1e-6 of the JAX package's (XLA contracts the
  stencil's multiply-adds; 2.4e-7), each of the four patterns.
* ``OpticalBarModel``: rays within 5e-7 (1.2e-7); fp32 centres within one
  ECEF ulp (XLA's multiply-add of position + t * velocity); the float64
  centre the float64 formula's; ``point_to_pixel`` and
  ``solve_point_to_pixel`` (25 Gauss-Newton steps) within 2e-3 px of the
  JAX package's (2.4e-4) and their round trips within 0.05 px.
* the tools: ``print_exif`` prints the same lines; ``convert_pinhole_model``
  writes k1, p1, p2 within 1e-4 of the JAX package's (k2, k3 act on r^4,
  r^6 and stay loose in fp32, ``tests/test_torch_math_extras.py``), the
  NullLensDistortion route the same file byte for byte.
"""

import math
import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import _torch_threads, port_camera  # noqa: F401
import visionworkbench_tpu.camera as jcam
import visionworkbench_tpu.camera.linescan as jls
import visionworkbench_torch.camera as tcam
import visionworkbench_torch.camera.linescan as tls

RAY = 5e-7
PIX = 2e-3
BAYER = 1e-6


class ToyLinescan:
    """``tests/test_linescan.py``'s pushbroom: the centre slides along +y
    with the row; each row views a rigid fan of rays in the x-z plane."""

    C0 = np.array([0.0, 0.0, 0.0])
    VEL = np.array([0.0, 2.0, 0.0])
    F, CX = 500.0, 320.0

    def camera_center(self, pix):
        return self.C0 + self.VEL * float(np.asarray(pix).reshape(-1)[-1])

    def pixel_to_vector(self, pix):
        x = float(np.asarray(pix).reshape(-1)[0])
        d = np.array([(x - self.CX) / self.F, 0.0, 1.0])
        return d / np.linalg.norm(d)


def _toy_point():
    cam = ToyLinescan()
    true_pix = np.array([350.0, 17.0])
    return cam.camera_center(true_pix) + cam.pixel_to_vector(true_pix) * 80.0


LINESCAN = {
    "linear_time": lambda m: m.LinearTimeInterpolation(10.0, 0.5)(np.arange(5)),
    "tlc_time": lambda m: m.TLCTimeInterpolation(
        [(0.0, 0.0), (10.0, 1.0), (30.0, 5.0)], time_offset=2.0)(
        np.array([-5.0, 0, 10, 20, 30, 40])),
    "perp_vecs": lambda m: m.find_perp_vecs(np.array([0.3, -0.5, 0.81240384])),
    "point_to_pixel": lambda m: m.linescan_point_to_pixel(ToyLinescan(), _toy_point(),
                                                          guess=(320.0, 0.0)),
    "velocity_aberration": lambda m: m.apply_velocity_aberration_correction(
        np.array([6371e3 + 600e3, 0.0, 0.0]), np.array([0.0, 7500.0, 0.0]), 6371e3,
        np.array([-1.0, 0.0, 0.0])),
    "atmospheric_refraction": lambda m: m.apply_atmospheric_refraction_correction(
        np.array([0.0, 0.0, 6371e3 + 700e3]), 6371e3, 0.0,
        np.array([math.sin(0.4), 0.0, -math.cos(0.4)])),
    "saastamoinen": lambda m: m.saastamoinen_atmosphere_correction(700e3, 120.0, 0.3),
    "transform_vector": lambda m: m.vector_to_transform(m.transform_to_vector(
        np.asarray(jcam.geometry.decompose_camera_matrix(np.hstack(
            [np.diag([800.0, 820.0, 1.0]), np.ones((3, 1))]))[1]), [1.0, -2.0, 3.0], 1.7)),
}


def _flat(x):
    if isinstance(x, (tuple, list)):
        return np.concatenate([np.ravel(np.asarray(v, np.float64)) for v in x])
    return np.ravel(np.asarray(x, np.float64))


@pytest.mark.parametrize("case", sorted(LINESCAN))
def test_linescan_equals_jax(case):
    assert np.array_equal(_flat(LINESCAN[case](tls)), _flat(LINESCAN[case](jls)))


# ---- the optical-bar model ------------------------------------------------------

def _optical_bar(velocity=(30.0, -20.0, 7000.0), mc=True, l2r=True):
    """``tests/test_carto_extras.py``'s optical bar (200 km up, 2000 x 1000)
    with a moving centre; the JAX package's and the port's."""
    pos = np.array([6378137.0 + 200000.0, 0.0, 0.0])
    r = np.stack([np.array([0, 1.0, 0]), np.array([0, 0, 1.0]), np.array([-1.0, 0, 0])], axis=1)
    args = ((2000, 1000), (1000, 500), 1e-5, 0.6, 1.0, 0.2, l2r, pos, r)
    kw = dict(velocity=velocity, use_motion_compensation=mc, motion_compensation_factor=0.9)
    return jcam.OpticalBarModel(*args, **kw), tcam.OpticalBarModel(*args, **kw)


def _pixels(seed=0, count=300):
    return (np.random.default_rng(seed).random((count, 2)) * [2000, 1000]).astype(np.float32)


@pytest.mark.parametrize("mc, l2r", [(True, True), (False, False)])
def test_optical_bar_matches_jax(mc, l2r):
    jm, tm = _optical_bar(mc=mc, l2r=l2r)
    pix = _pixels()
    jr = np.asarray(jm.pixel_to_vector(jnp.asarray(pix)))
    tr = tm.pixel_to_vector(torch.as_tensor(pix))
    assert tr.dtype == torch.float32 and np.abs(tr.numpy() - jr).max() <= RAY
    jt, ja = (np.asarray(v) for v in jm.pixel_to_time_alpha(jnp.asarray(pix)))
    tt, ta = (v.numpy() for v in tm.pixel_to_time_alpha(torch.as_tensor(pix)))
    assert np.abs(tt - jt).max() <= 1e-7 and np.abs(ta - ja).max() <= 1e-7
    jc = np.asarray(jm.camera_center(jnp.asarray(pix)), np.float64)
    tc = tm.camera_center(torch.as_tensor(pix)).numpy().astype(np.float64)
    assert np.abs(tc - jc).max() <= np.spacing(np.float32(np.abs(jc).max()))
    c64 = tm.camera_center(torch.as_tensor(pix), torch.float64).numpy()
    frac = pix[:, 0].astype(np.float64) / 2000
    t64 = (frac if l2r else 1.0 - frac) * 1.0
    assert np.array_equal(c64, tm.position + t64[:, None] * tm.velocity)
    assert np.array_equal(tm.camera_center().numpy(), np.asarray(jm.camera_center()))
    assert np.array_equal(tm.camera_pose().numpy(), np.asarray(jm.camera_pose()))


def test_optical_bar_projections_match_jax():
    """``point_to_pixel`` and ``solve_point_to_pixel`` of points 100 km
    along the rays (from the fp32 centres): against the JAX package's and
    the pixels; the float64 centre feeds ``StereoModel``."""
    from visionworkbench_tpu.camera.solve import solve_point_to_pixel as jsolve
    jm, tm = _optical_bar()
    pix = _pixels(1, 200)
    ctr = tm.camera_center(torch.as_tensor(pix)).double()
    pts = (ctr + tm.pixel_to_vector(torch.as_tensor(pix)).double() * 1e5).float().numpy()
    want = np.asarray(jm.point_to_pixel(jnp.asarray(pts)))
    got = tm.point_to_pixel(pts, device="cpu")
    assert got.dtype == torch.float32 and np.abs(got.numpy() - want).max() <= PIX
    assert np.abs(got.numpy() - pix).max() <= 0.05
    init = (1000.0, 500.0)
    want = np.asarray(jsolve(jm, jnp.asarray(pts), initial_pixel=init))
    got = tcam.solve_point_to_pixel(tm, torch.as_tensor(pts), initial_pixel=init)
    assert np.abs(got.numpy() - want).max() <= PIX
    assert np.abs(got.numpy() - pix).max() <= 0.05


def test_linescan_point_to_pixel_on_optical_bar_matches_jax():
    jm, tm = _optical_bar()
    true_pix = np.array([1234.0, 321.0])
    ctr = tm.camera_center(torch.as_tensor(true_pix, dtype=torch.float32), torch.float64)
    pt = (ctr + tm.pixel_to_vector(torch.as_tensor(true_pix, dtype=torch.float32)).double()
          * 1e5).numpy()
    want = jls.linescan_point_to_pixel(jm, pt, guess=(1000.0, 500.0))
    got = tls.linescan_point_to_pixel(tm, pt, guess=(1000.0, 500.0))
    assert np.abs(got - want).max() <= 1e-3 and np.abs(got - true_pix).max() <= 0.05


def test_solve_point_to_pixel_matches_jax():
    """``tests/test_core_extras.py``'s case: a pinhole solved iteratively."""
    from visionworkbench_tpu.camera.solve import solve_point_to_pixel as jsolve
    jcamera = jcam.PinholeModel((0, 0, 0), np.eye(3), (400, 400), (100, 80))
    cam = port_camera(jcamera)
    pts = np.array([[0.2, -0.1, 5.0], [0.5, 0.3, 8.0], [-0.4, 0.2, 3.0]], np.float32)
    want = np.asarray(jsolve(jcamera, jnp.asarray(pts), initial_pixel=(100.0, 80.0)))
    got = tcam.solve_point_to_pixel(cam, pts, initial_pixel=(100.0, 80.0), device="cpu")
    assert got.shape == (3, 2) and np.abs(got.numpy() - want).max() <= PIX
    np.testing.assert_allclose(got.numpy(), cam.point_to_pixel(torch.as_tensor(pts)).numpy(),
                               atol=0.05)
    if not torch.cuda.is_available():   # arrays go to the card by default
        with pytest.raises(RuntimeError):
            tcam.solve_point_to_pixel(cam, pts)


# ---- Bayer -----------------------------------------------------------------------

@pytest.mark.parametrize("pattern", ["rggb", "bggr", "grbg", "gbrg"])
def test_bayer_matches_jax(pattern):
    mosaic = np.random.default_rng(5).random((37, 50)).astype(np.float32)
    want = np.asarray(jcam.bayer_demosaic(jnp.asarray(mosaic), pattern))
    got = tcam.bayer_demosaic(mosaic, pattern, device="cpu")
    assert got.shape == (37, 50, 3) and np.abs(got.numpy() - want).max() <= BAYER
    flat = tcam.bayer_demosaic(torch.full((8, 8), 0.5), pattern)
    assert torch.allclose(flat, torch.full((8, 8, 3), 0.5))


# ---- EXIF --------------------------------------------------------------------------

def exif_fixture(e="<"):
    """``tests/test_camera.py``'s hand-built EXIF TIFF blob (IFD0: Make,
    Model, the EXIF pointer; the EXIF IFD: FNumber, ExposureTime, ISO,
    FocalLength) in byte order ``e``."""
    def entry(tag, ttype, count, value_bytes, data_area, base):
        if len(value_bytes) <= 4:
            val = value_bytes + b"\0" * (4 - len(value_bytes))
            return struct.pack(e + "HHI", tag, ttype, count) + val, data_area
        off = base + len(data_area)
        return struct.pack(e + "HHII", tag, ttype, count, off), data_area + value_bytes

    make, model = b"VWTPU\0", b"UnitCam 9000\0"
    ifd0_off = 8
    data0_base = ifd0_off + 2 + 3 * 12 + 4
    entries0, data0 = [], b""
    for tag, text in ((0x010F, make), (0x0110, model)):
        ent, data0 = entry(tag, 2, len(text), text, data0, data0_base)
        entries0.append(ent)
    exif_off = data0_base + len(data0)
    entries0.append(struct.pack(e + "HHII", 0x8769, 4, 1, exif_off))
    n_exif = 4
    data1_base = exif_off + 2 + n_exif * 12 + 4
    entries1, data1 = [], b""
    for tag, num, den in ((0x829D, 28, 10), (0x829A, 1, 250)):
        ent, data1 = entry(tag, 5, 1, struct.pack(e + "II", num, den), data1, data1_base)
        entries1.append(ent)
    entries1.append(struct.pack(e + "HHI", 0x8827, 3, 1) + struct.pack(e + "HH", 200, 0))
    ent, data1 = entry(0x920A, 5, 1, struct.pack(e + "II", 50, 1), data1, data1_base)
    entries1.append(ent)
    order = b"II" if e == "<" else b"MM"
    return (order + struct.pack(e + "H", 42) + struct.pack(e + "I", ifd0_off)
            + struct.pack(e + "H", 3) + b"".join(entries0) + struct.pack(e + "I", 0) + data0
            + struct.pack(e + "H", n_exif) + b"".join(entries1) + struct.pack(e + "I", 0)
            + data1)


def _jpeg(tiff):
    seg = b"Exif\x00\x00" + tiff
    return b"\xff\xd8" + b"\xff\xe1" + struct.pack(">H", len(seg) + 2) + seg + b"\xff\xd9"


ACCESSORS = ("get_f_number", "get_exposure_time", "get_iso", "get_focal_length_35mm_equiv",
             "get_average_luminance", "camera_make", "camera_model")


@pytest.mark.parametrize("endian", ["<", ">"])
def test_exif_equals_jax(tmp_path, endian):
    from visionworkbench_tpu.camera.exif import parse_tiff_exif as jparse
    from visionworkbench_torch.camera.exif import parse_tiff_exif as tparse
    tiff = exif_fixture(endian)
    assert tparse(tiff) == jparse(tiff) and tparse(tiff)["Make"] == "VWTPU"
    for name, data in (("fixture.jpg", _jpeg(tiff)), ("fixture.tif", tiff),
                       ("plain.bin", b"\x00" * 16)):
        path = str(tmp_path / name)
        with open(path, "wb") as f:
            f.write(data)
        jv, tv = jcam.ExifView(path), tcam.ExifView(path)
        assert tv.tags == jv.tags
        assert [getattr(tv, a)() for a in ACCESSORS] == [getattr(jv, a)() for a in ACCESSORS]
    assert "PIL" not in tcam.ExifView.__init__.__code__.co_names


# ---- the tools ---------------------------------------------------------------------

@pytest.fixture
def exif_files(tmp_path):
    from PIL import Image
    pil = str(tmp_path / "pil.jpg")
    im = Image.new("L", (8, 8), 100)
    exif = Image.Exif()
    exif[271] = "MakeX"
    im.save(pil, exif=exif)
    fixture = str(tmp_path / "fixture.jpg")
    with open(fixture, "wb") as f:
        f.write(_jpeg(exif_fixture()))
    return [pil, fixture, str(tmp_path / "missing.jpg")]


def test_print_exif_tool_matches_jax(exif_files, capsys):
    from visionworkbench_tpu.tools.print_exif import main as jmain
    from visionworkbench_torch.tools.print_exif import main as tmain
    assert jmain(exif_files) == 0
    want = capsys.readouterr().out
    assert tmain(exif_files, device="cpu") == 0
    got = capsys.readouterr().out
    assert got == want and "MakeX" in got and "average luminance" in got


@pytest.mark.parametrize("output_type", ["TsaiLensDistortion", "NullLensDistortion"])
def test_convert_pinhole_model_tool_matches_jax(tmp_path, capsys, output_type):
    from visionworkbench_tpu.fileio import write_tiff
    from visionworkbench_tpu.tools.convert_pinhole_model import main as jmain
    from visionworkbench_torch.camera import read_pinhole_model
    from visionworkbench_torch.tools.convert_pinhole_model import main as tmain
    cam = jcam.PinholeModel((0, 0, 0), np.eye(3), (300, 300), (40, 32),
                            jcam.TsaiLensDistortion(k1=-0.15, k2=0.02, p1=1e-3))
    cam_path, img_path = str(tmp_path / "cam.tsai"), str(tmp_path / "img.tif")
    jcam.write_pinhole_model(cam_path, cam)
    write_tiff(img_path, np.zeros((64, 80), np.float32))
    outs = {s: str(tmp_path / f"out_{s}.tsai") for s in "jt"}
    argv = [img_path, cam_path, "--sample-spacing", "10", "--output-type", output_type, "-o"]
    assert jmain(argv + [outs["j"]]) == 0
    jtext = capsys.readouterr().out
    assert tmain(argv + [outs["t"]], device="cpu") == 0
    ttext = capsys.readouterr().out
    assert ttext.split(" (")[0] == jtext.split(" (")[0].replace(outs["j"], outs["t"])
    if output_type == "NullLensDistortion":
        assert open(outs["t"]).read() == open(outs["j"]).read()
        return
    got, want = (read_pinhole_model(outs[s]).distortion.params for s in "tj")
    assert np.abs(np.subtract(got, want)[[0, 2, 3]]).max() <= 1e-4
    assert abs(got[0] + 0.15) <= 1e-4 and os.path.getsize(outs["t"]) > 0
