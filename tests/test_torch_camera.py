"""Port's camera models (``visionworkbench_torch/camera/``, ``math/quaternion``)
against the JAX package on the CPU, on the same seeded numpy inputs; both
sides are built from one seeded JAX model (``torch_parity.port_camera``).

Tolerances (fp32; XLA contracts the jitted Newton loops' multiply-adds into
FMAs and its transcendentals differ from PyTorch's by ulps, measured max in
brackets):

* quaternions within 2e-6 (4.8e-7); ``matrix_to_quat``, ``epipolar_rectify``,
  the camera-matrix fit, the CAHV vectors of ``pinhole_to_cahv`` and
  ``linearize_camera``'s host arithmetic are NumPy copies: equal (the
  linearized CAHV's vectors within 1e-6 of their scale: they are made from
  the model's fp32 rays).
* lens distortion: ``distort`` within 5e-7 of the normalized coordinates
  (6.0e-8); ``undistort`` (20 Newton steps on a central-difference Jacobian)
  within 5e-7 (6.0e-8).
* pinhole, CAHV, CAHVOR, CAHVORE (linearity 1, 0.5, 0) and the adjusted
  model: pixels within 5e-4 px (1.2e-4, CAHVORE's 30 Newton steps), rays
  within 5e-7 (1.2e-7); centres and poses equal.
* files: TSAI and CAHV files the port writes equal the JAX package's byte
  for byte, and each package reads the other's.
* ``camera_transform`` / ``undistort_image`` at 48²: source coordinates and
  bilinear samples of [0, 1) noise within 5e-5 (7.6e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import _torch_threads, port_camera  # noqa: F401
import visionworkbench_tpu.camera as jcam
import visionworkbench_tpu.math.quaternion as jq
import visionworkbench_torch.camera as tcam
import visionworkbench_torch.math.quaternion as tq

QUAT = 2e-6
NORM = 5e-7
PIX = 5e-4
RAY = 5e-7
WARP = 5e-5
LINEAR = 1e-6


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _err(a, b):
    return float(np.abs(_np(a).astype(np.float64) - _np(b).astype(np.float64)).max())


def _rot(seed):
    rng = np.random.default_rng(seed)
    return np.asarray(jq.euler_to_rotation_matrix(*rng.uniform(-0.3, 0.3, 3)), np.float64)


def _pinhole(dist=None, seed=1):
    """``tests/test_camera.py``'s ``_test_camera`` with a seeded rotation."""
    return jcam.PinholeModel((10.0, -5.0, 2.0), _rot(seed), (500.0, 510.0), (320.0, 240.0),
                             dist)


def _cahv_family():
    base = jcam.pinhole_to_cahv(_pinhole())
    radial = (0.0, -0.001, 0.0002)
    models = {"cahv": base,
              "cahvor": jcam.CAHVORModel(base.C, base.A, base.H, base.V, base.A, radial)}
    for p in (1.0, 0.5, 0.0):
        models[f"cahvore_{p:g}"] = jcam.CAHVOREModel(
            base.C, base.A, base.H, base.V, base.A, radial, (0.0005, -0.0002, 0.0001), p)
    return models


def _pixels(seed=3, n=64):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0, 640, n), rng.uniform(0, 480, n)], -1).astype(np.float32)


def _points(cam, seed=4, n=64):
    """Points 20-60 m in front of ``cam`` along its seeded pixels' rays."""
    rng = np.random.default_rng(seed)
    rays = np.asarray(cam.pixel_to_vector(jnp.asarray(_pixels(seed, n))))
    return (np.asarray(cam.camera_center(), np.float32)
            + rays * rng.uniform(20, 60, (n, 1)).astype(np.float32))


# ---- quaternions --------------------------------------------------------------

def _quats(seed, n=64):
    q = np.random.default_rng(seed).normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


QUAT_CASES = {
    "mul": lambda m: m.quat_mul(_quats(0), _quats(1)),
    "conj": lambda m: m.quat_conj(_quats(0)),
    "normalize": lambda m: m.quat_normalize(3 * _quats(0)),
    "rotate": lambda m: m.quat_rotate(_quats(0), _quats(1)[:, 1:]),
    "axis_angle": lambda m: m.axis_angle_to_quat(_quats(1)[:, 1:], _quats(2)[:, 0] * 3),
    "to_axis_angle": lambda m: np.concatenate(
        [_np(a).reshape(64, -1) for a in m.quat_to_axis_angle(_quats(0))], -1),
    "to_matrix": lambda m: m.quat_to_matrix(_quats(0)),
    "slerp": lambda m: m.slerp(np.float32(0.3), _quats(0), _quats(1)),
    "euler": lambda m: m.euler_to_quat(0.1, -0.7, 2.1, "zyx"),
    "euler_matrix": lambda m: m.euler_to_rotation_matrix(0.3, 0.2, -0.4),
}


@pytest.mark.parametrize("case", sorted(QUAT_CASES))
def test_quaternion_matches_jax(case):
    got, want = QUAT_CASES[case](tq), QUAT_CASES[case](jq)
    assert _np(got).shape == _np(want).shape
    assert _err(got, want) <= QUAT


def test_matrix_to_quat_is_the_jax_function():
    for seed in range(5):
        m = _rot(seed)
        assert np.array_equal(tq.matrix_to_quat(m), jq.matrix_to_quat(m))


# ---- lens distortion ----------------------------------------------------------

DISTORTIONS = {
    "NULL": jcam.NullLensDistortion(),
    "TSAI": jcam.TsaiLensDistortion(-0.1, 0.02, 1e-3, -5e-4, 0.003),
    "BrownConrady": jcam.BrownConradyDistortion(0.01, -0.02, -0.08, 0.01, 0.001, 2e-4,
                                                -1e-4, 0.3),
    "FOV": jcam.FovDistortion(0.8),
    "FISHEYE": jcam.FisheyeDistortion(-0.02, 0.003, 1e-4, -2e-5),
    "Photometrix": jcam.PhotometrixDistortion(0.01, 0.02, -0.05, 0.004, 1e-4, 3e-4, -2e-4),
}


def _rpc():
    from visionworkbench_tpu.camera.distortion import RPCLensDistortion
    return RPCLensDistortion((0.0, 1.0, 0.0, 0.01, -0.02, 0.005),
                             (0.002, -0.001, 0.01, 0.0, 0.003),
                             (0.0, 0.0, 1.0, -0.01, 0.015, 0.02),
                             (-0.001, 0.002, 0.0, 0.004, -0.002))


def _normalized(seed=5, n=64):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.45, 0.45, (n, 2)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(DISTORTIONS) + ["RPC"])
@pytest.mark.parametrize("direction", ["distort", "undistort"])
def test_distortion_matches_jax(name, direction):
    jd = _rpc() if name == "RPC" else DISTORTIONS[name]
    td = port_camera(jcam.PinholeModel(distortion=jd)).distortion
    assert type(td).__name__ == type(jd).__name__ and td.params == jd.params
    xy = _normalized()
    got = getattr(td, direction)(xy)
    want = getattr(jd, direction)(jnp.asarray(xy))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _err(got, want) <= NORM
    if direction == "undistort" and name != "NULL":
        assert _err(td.distort(got), xy) <= 1e-5      # the Newton steps converged


def test_distortion_types_exported():
    assert sorted(tcam.DISTORTION_TYPES) == sorted(jcam.DISTORTION_TYPES)


# ---- pinhole, CAHV family, adjusted -------------------------------------------

def _models():
    models = {"pinhole": _pinhole(),
              "pinhole_tsai": _pinhole(jcam.TsaiLensDistortion(-0.1, 0.02, 1e-3, -5e-4)),
              **_cahv_family()}
    models["adjusted"] = jcam.AdjustedCameraModel(
        _pinhole(jcam.TsaiLensDistortion(-0.05, 0.01)), (1.0, -2.0, 0.5),
        np.asarray(jq.euler_to_quat(0.02, -0.01, 0.03)), (9.0, -4.0, 3.0))
    return models


MODELS = _models()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_camera_matches_jax(name):
    jm = MODELS[name]
    tm = port_camera(jm)
    pix = _pixels()
    pts = _points(jm)
    assert _err(tm.pixel_to_vector(pix), jm.pixel_to_vector(jnp.asarray(pix))) <= RAY
    assert _err(tm.point_to_pixel(pts), jm.point_to_pixel(jnp.asarray(pts))) <= PIX
    assert _err(tm.camera_center(), jm.camera_center()) == 0.0
    assert _err(tm.camera_pose(), jm.camera_pose()) == 0.0
    c64 = tm.camera_center(torch.zeros(2), torch.float64)
    assert c64.dtype == torch.float64
    if name != "adjusted":
        assert np.array_equal(c64.numpy(), jm.C)


def test_adjusted_camera_matches_translated_pinhole():
    """``tests/test_camera.py::test_adjusted_camera_translation`` on the port."""
    cam = port_camera(_pinhole())
    adj = tcam.AdjustedCameraModel(cam, translation=(1.0, 2.0, 3.0))
    np.testing.assert_allclose(adj.camera_center().numpy(), cam.C + [1, 2, 3], atol=1e-5)
    shifted = tcam.PinholeModel(cam.C + [1, 2, 3], cam.R, (cam.fu, cam.fv), (cam.cu, cam.cv))
    p = torch.tensor([[15.0, 0.0, 40.0]])
    np.testing.assert_allclose(adj.point_to_pixel(p).numpy(), shifted.point_to_pixel(p).numpy(),
                               atol=1e-3)


def test_pinhole_to_cahv_and_linearize_match_jax():
    jp = _pinhole()
    jc, tc = jcam.pinhole_to_cahv(jp), tcam.pinhole_to_cahv(port_camera(jp))
    for k in "CAHV":
        assert np.array_equal(getattr(tc, k), getattr(jc, k))
    jore = _cahv_family()["cahvore_0.5"]
    jl = jcam.linearize_camera(jore, (640, 480), (512, 384))
    tl = tcam.linearize_camera(port_camera(jore), (640, 480), (512, 384))
    for k in "CAHV":
        want = getattr(jl, k)
        assert _err(getattr(tl, k), want) <= LINEAR * np.abs(want).max()


def test_tsai_files_equal_byte_for_byte(tmp_path):
    for i, name in enumerate(sorted(DISTORTIONS)):
        jm = _pinhole(DISTORTIONS[name], seed=i)
        jm.pixel_pitch = 0.5 if i % 2 else 1.0
        jp, tp = str(tmp_path / f"j{i}.tsai"), str(tmp_path / f"t{i}.tsai")
        jcam.write_pinhole_model(jp, jm)
        tcam.write_pinhole_model(tp, port_camera(jm))
        assert open(jp, "rb").read() == open(tp, "rb").read()
        tb, jb = tcam.read_pinhole_model(jp), jcam.read_pinhole_model(tp)
        assert np.array_equal(tb.C, jb.C) and np.array_equal(tb.R, jb.R)
        assert (tb.fu, tb.fv, tb.cu, tb.cv, tb.pixel_pitch) == (
            jb.fu, jb.fv, jb.cu, jb.cv, jb.pixel_pitch)
        assert type(tb.distortion).__name__ == type(jb.distortion).__name__
        assert tb.distortion.params == jb.distortion.params


def test_cahv_files_equal_byte_for_byte(tmp_path):
    for name, jm in _cahv_family().items():
        jp, tp = str(tmp_path / f"j_{name}.cahv"), str(tmp_path / f"t_{name}.cahv")
        jcam.write_cahv_model(jp, jm)
        tcam.write_cahv_model(tp, port_camera(jm))
        assert open(jp, "rb").read() == open(tp, "rb").read()
        tb, jb = tcam.read_cahv_model(jp), jcam.read_cahv_model(tp)
        assert type(tb).__name__ == type(jb).__name__ == type(jm).__name__
        for k in ("C", "A", "H", "V", "O", "Rd", "E", "linearity"):
            if hasattr(jb, k):
                assert np.array_equal(getattr(tb, k), getattr(jb, k))


# ---- epipolar rectification, camera fitting, warps -----------------------------

def test_epipolar_rectify_matches_jax():
    j1 = jcam.PinholeModel((0, 0, 0), _rot(7), (500, 500), (320, 240),
                           jcam.TsaiLensDistortion(-0.05))
    j2 = jcam.PinholeModel((1.0, 0.1, 0), _rot(8), (505, 498), (322, 238))
    for jr, tr in zip(jcam.epipolar_rectify(j1, j2),
                      tcam.epipolar_rectify(port_camera(j1), port_camera(j2))):
        assert np.array_equal(tr.C, jr.C) and np.array_equal(tr.R, jr.R)
        assert (tr.fu, tr.fv, tr.cu, tr.cv) == (jr.fu, jr.fv, jr.cu, jr.cv)
        assert tr.distortion.name == jr.distortion.name == "NULL"


def test_camera_fit_matches_jax():
    jm = _pinhole()
    pts = _points(jm, n=24).astype(np.float64)
    pix = np.asarray(jm.point_to_pixel(jnp.asarray(pts)), np.float64)
    assert np.array_equal(tcam.fit_camera_matrix(pts, pix), jcam.fit_camera_matrix(pts, pix))
    pm = jcam.fit_camera_matrix(pts, pix)
    for a, b in zip(tcam.decompose_camera_matrix(pm), jcam.decompose_camera_matrix(pm)):
        assert np.array_equal(a, b)
    tc, jc = tcam.camera_from_points(pts, pix), jcam.camera_from_points(pts, pix)
    assert np.array_equal(tc.C, jc.C) and np.array_equal(tc.R, jc.R)


def test_camera_transform_and_undistort_image_match_jax():
    img = np.random.default_rng(9).random((48, 48)).astype(np.float32)
    src = _pinhole(jcam.TsaiLensDistortion(-0.1, 0.02, 1e-3, -5e-4))
    src.fu, src.fv, src.cu, src.cv = 60.0, 61.0, 23.5, 24.0
    dst = jcam.PinholeModel(src.C, _rot(1) @ np.asarray(jq.euler_to_rotation_matrix(
        0.01, -0.02, 0.005), np.float64), (58.0, 58.0), (24.0, 23.0))
    jx, jy = jcam.camera_transform_map(dst, src, (48, 48))
    tx, ty = tcam.camera_transform_map(port_camera(dst), port_camera(src), (48, 48),
                                       device="cpu")
    assert max(_err(tx, jx), _err(ty, jy)) <= WARP
    got = tcam.camera_transform(img, port_camera(src), port_camera(dst), device="cpu")
    assert _err(got, jcam.camera_transform(jnp.asarray(img), src, dst)) <= WARP
    got = tcam.undistort_image(img, port_camera(src), device="cpu")
    assert got.shape == (48, 48)
    assert _err(got, jcam.undistort_image(jnp.asarray(img), src)) <= WARP
