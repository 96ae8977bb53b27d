"""Port's triangulation (``visionworkbench_torch/stereo/stereo_model.py``)
against a float64 NumPy oracle and the JAX package on the CPU.

The port intersects the fp32 rays in float64 from the models' float64
centres and rounds once (``ROADMAP.md`` §3, kept divergence); the JAX
package rounds the centres to fp32 ECEF (0.5 m an ulp here) and intersects
in fp32. At the geometry of the stereo-dem scene (``stereo_dem_scene.py``,
``chip_smoke.py``'s phase 8: nadir
pinholes 1000 m above WGS84 at (-122, 37), a 30 m baseline; here at 64²,
f and the principal point scaled by 1/16) the port lies within 0.6 m of
the oracle on every pixel (measured median 0.156 m, max 0.300 m: the fp32
rounding of the points), on the phase's pair (centres on the fp32 grid)
and on the same pair at its float64 centres. The JAX package is held to its
own measured error: |port - JAX| <= its max error against the oracle + 0.6
m (JAX measured 0.156 / 0.300 m on the phase's pair, 5.24 / 9.82 m at the
float64 centres).

``triangulate_pair`` on fp32 inputs, ``are_nearly_parallel`` and
``triangulate_point_multiview`` compute in fp32 as the JAX package: points
within 1e-4 (measured 0 for the pair, 1.8e-5 for the 3x3 solves), equal
flags; the multiview error within 1e-2 (measured 3.7e-3: ``|p - c|² - v²``
cancels in fp32 at squares of ~1e2 in both packages).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import _torch_threads  # noqa: F401
import stereo_dem_scene as sds
import visionworkbench_tpu.camera as jcam
import visionworkbench_tpu.stereo.stereo_model as jsm
import visionworkbench_torch.camera as tcam
import visionworkbench_torch.stereo.stereo_model as tsm
from visionworkbench_tpu.stereo.correlation import DisparityMap as JDM
from visionworkbench_torch.stereo.correlation import DisparityMap as TDM

N = 64
POINT_M = sds.DEM_POINT_M
FP32 = 1e-4


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jax_pinhole(cam):
    return jcam.PinholeModel(cam.C, cam.R, (cam.fu, cam.fv), (cam.cu, cam.cv))


@pytest.fixture(scope="module")
def scene():
    """The stereo-dem phase at 64²: the rectified pairs (fp32-grid and
    float64 centres), each pixel's true depth and the true disparities."""
    sc = sds.scene(N)
    rect = sds.rectify(sc)
    depth, valid = sds.depth(rect[0], sc, N, "cpu")
    pairs = {"chain": rect,
             "float64_centres": sds.rectify(sds.scene(N, fp32_centres=False))}
    return {k: (p, sds.disparity(*p, depth), valid) for k, p in pairs.items()}


@pytest.mark.parametrize("pair", ["chain", "float64_centres"])
def test_point_cloud_matches_float64_oracle_and_jax(scene, pair):
    (cl, cr), d_true, valid = scene[pair]
    d32 = d_true.astype(np.float32)
    valid = valid.copy()
    valid[::7, ::5] = False                     # the map's own validity masks points
    xyz, err, v = tsm.StereoModel(cl, cr).point_cloud(TDM(torch.as_tensor(d32),
                                                          torch.as_tensor(valid)), device="cpu")
    assert xyz.dtype == torch.float32 and err.dtype == torch.float32
    assert np.array_equal(v.numpy(), valid)
    pix1 = np.stack(np.meshgrid(np.arange(N), np.arange(N)), -1).astype(np.float32)
    truth = sds.triangulate64(cl, cr, pix1, pix1 + d32)
    e_port = np.linalg.norm(xyz.numpy() - truth, axis=-1)[valid]
    assert e_port.max() <= POINT_M
    assert np.all(xyz.numpy()[~valid] == 0) and np.all(err.numpy()[~valid] == 0)
    jxyz, jerr, jv = jsm.StereoModel(_jax_pinhole(cl), _jax_pinhole(cr)).point_cloud(
        JDM(jnp.asarray(d32), jnp.asarray(valid)))
    assert np.array_equal(np.asarray(jv), valid)
    jxyz = np.asarray(jxyz)
    e_jax = np.linalg.norm(jxyz - truth, axis=-1)[valid]
    assert np.linalg.norm(xyz.numpy() - jxyz, axis=-1)[valid].max() <= e_jax.max() + POINT_M
    # the error norms: the rays' closest approach, well under a metre here
    assert np.abs(err.numpy() - np.asarray(jerr))[valid].max() <= e_jax.max() + POINT_M


def test_cahv_route_matches_pinhole_route(scene):
    """``StereoModel`` on ``pinhole_to_cahv`` of the rectified pair (the
    phase's CAHV route) equals the pinhole route within 1 m (measured 0.5
    m here, 0.559 m at 1024² on an NVIDIA H100 80GB HBM3 at 700 W, in
    ``chip_smoke.py``'s phase 8: a point's fp32 rounding lands on
    the neighbouring ulp), validity equal; and the JAX package's CAHV route
    on the same pair (centres on the fp32 grid) within 1 m (0.5 m)."""
    (cl, cr), d_true, valid = scene["chain"]
    dm = TDM(torch.as_tensor(d_true.astype(np.float32)), torch.as_tensor(valid))
    pxyz, _, pv = tsm.StereoModel(cl, cr).point_cloud(dm)
    cxyz, _, cv = tsm.StereoModel(tcam.pinhole_to_cahv(cl), tcam.pinhole_to_cahv(cr)).point_cloud(dm)
    assert torch.equal(pv, cv)
    assert np.linalg.norm((cxyz - pxyz).double().numpy(), axis=-1)[valid].max() <= sds.DEM_CAHV_M
    jxyz, _, jv = jsm.StereoModel(jcam.pinhole_to_cahv(_jax_pinhole(cl)),
                                  jcam.pinhole_to_cahv(_jax_pinhole(cr))).point_cloud(
        JDM(jnp.asarray(dm.disparity.numpy()), jnp.asarray(valid)))
    assert np.array_equal(np.asarray(jv), valid)
    assert np.linalg.norm(cxyz.numpy() - np.asarray(jxyz), axis=-1)[valid].max() <= 1.0


def test_triangulate_float64_centres_from_model():
    """The centres come from the models' float64 ``C``: a baseline of 3 mm
    at 6.4e6 m (below an fp32 ulp of ECEF) still triangulates."""
    c = np.array([-2.7e6, -4.3e6, 3.8e6])
    r = np.eye(3)
    cam1 = tcam.PinholeModel(c, r, (1000.0, 1000.0), (50.0, 50.0))
    cam2 = tcam.PinholeModel(c + [3e-3, 0, 0], r, (1000.0, 1000.0), (50.0, 50.0))
    pt = c + [0.01, 0.02, 1.0]
    pix = [sds.project64(cam, pt[None])[0] for cam in (cam1, cam2)]
    point, _, valid = tsm.StereoModel(cam1, cam2, angle_tol=1e-9).triangulate(
        np.float32(pix[0]), np.float32(pix[1]), device="cpu")
    assert bool(valid)
    assert np.linalg.norm(point.double().numpy() - pt) <= 0.5   # one ECEF ulp


def _rays(seed, n=64):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)) + [0, 0, 4]
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def test_triangulate_pair_matches_jax():
    rng = np.random.default_rng(5)
    c0 = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    c1 = (c0 + [1.0, 0.0, 0.0]).astype(np.float32)
    d0, d1 = _rays(1), _rays(2)
    got = tsm.triangulate_pair(d0, c0, d1, c1, device="cpu")
    want = jsm.triangulate_pair(d0, c0, d1, c1)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert np.abs(_np(g) - np.asarray(w)).max() <= FP32
    g64 = tsm.triangulate_pair(torch.as_tensor(d0).double(), c0, d1, c1, device="cpu")[0]
    assert g64.dtype == torch.float64


def test_are_nearly_parallel_matches_jax():
    d0 = _rays(3)
    d1 = d0.copy()
    d1[::2] = _rays(4)[::2]
    got = tsm.are_nearly_parallel(d0, d1, device="cpu")
    assert np.array_equal(got.numpy(), np.asarray(jsm.are_nearly_parallel(d0, d1)))
    assert got[1::2].all() and not got[::2].any()


def test_parallel_rays_invalid():
    """``tests/test_camera.py::test_triangulation_parallel_rays_invalid``."""
    cam = tcam.PinholeModel((0, 0, 0), np.eye(3), (500, 500), (320, 240))
    point, err, valid = tsm.StereoModel(cam, cam).triangulate([[320.0, 240.0]],
                                                               [[320.0, 240.0]], device="cpu")
    assert not bool(valid[0]) and float(err[0]) == 0 and not point.any()


def test_triangulate_point_multiview_matches_jax():
    rng = np.random.default_rng(6)
    pts = rng.uniform(-1, 1, (32, 3)) + [0, 0, 10]
    ctrs = np.stack([rng.uniform(-1, 1, (32, 3)) for _ in range(3)]).astype(np.float32)
    dirs = pts[None] - ctrs + rng.normal(0, 1e-3, (3, 32, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)
    p, e = tsm.triangulate_point_multiview(dirs, ctrs, device="cpu")
    jp, je = jsm.triangulate_point_multiview(dirs, ctrs)
    assert np.abs(p.numpy() - np.asarray(jp)).max() <= FP32
    assert np.abs(e.numpy() - np.asarray(je)).max() <= 1e-2
    assert np.abs(p.numpy() - pts).max() <= 0.1
