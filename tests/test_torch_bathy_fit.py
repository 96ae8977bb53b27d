"""Port's ``cartography/{bathymetry, camera_fit}`` against the JAX package
and float64 oracles on the CPU, and the slice: the opticalbar-dem and
bathy-dem chains at 64^2 (the cameras scaled by 1/16) from one true
disparity map through both packages' triangulation and DEM.

Tolerances:

* ``snell_refraction`` on fp32 arrays within 1e-6 of the JAX package's
  (XLA's multiply-adds), total internal reflection equal; on float64
  tensors within 1e-14 of ``stereo_dem_scene.snell64``. ``_intersect_plane``
  on fp32 arrays within 1e-5 of the coordinates' scale.
* ``BathyStereoModel`` (the kept divergence: float64 bending, intersection
  and triangulation from the float64 centres and plane): at the stereo-dem
  geometry over a water plane at the datum, 2000 seeded points 2-20 m down
  seen through their exact (float64) refracted pixels, within 0.6 m of the
  points (the fp32 rounding of the output: 0.165 m median, 0.292 m max);
  the JAX package's fp32 route is 3.90 m off at the median (22.07 m max) at
  a 30 m baseline (pinned here above 1 m), and the port lies within the JAX
  package's own error + 0.6 m of it. The JAX package's "deeper than naive" case within
  1e-4 m of the JAX package's point.
* ``fit_pinhole`` with each prior (none, height above a datum, the centre):
  the same host NumPy solve on fp32 projections that differ by XLA's
  multiply-adds, so within 0.05 m / 1e-4 of the JAX package's fit, the
  reprojection errors within 0.01 px of each other and within 0.5 px (1 px
  with the centre prior, which holds the camera near its seed: 0.79 px in
  both). ``fit_camera_to_datum`` on an optical bar, one LM iteration in each
  package (10 Gauss-Newton steps a projection; the JAX package's method
  compiled once with the pose as arguments), within 1e-3 m / 1e-6
  (1.4e-4 m, 3.0e-8).
* the slice at 64^2: the port's points within 0.6 m of the float64 oracle on
  every valid pixel (the JAX package's opticalbar points within 0.6 m too;
  its bathy points under the water metres off), validity equal; the DEMs'
  cells agreeing on >= 0.95 and heights within the JAX package's point
  error + 4 m of each other.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import _torch_threads, jax_georef, port_camera  # noqa: F401
import stereo_dem_scene as sds
import visionworkbench_tpu.camera as jcam
import visionworkbench_tpu.cartography as jcart
import visionworkbench_tpu.cartography.bathymetry as jbathy
import visionworkbench_tpu.stereo.stereo_model as jsm
from visionworkbench_tpu.math.quaternion import euler_to_rotation_matrix
from visionworkbench_tpu.stereo.correlation import DisparityMap as JDM
import visionworkbench_torch.camera as tcam
import visionworkbench_torch.cartography as tcart
import visionworkbench_torch.cartography.bathymetry as tbathy
import visionworkbench_torch.stereo.stereo_model as tsm
from visionworkbench_torch.stereo.correlation import DisparityMap as TDM

SNELL = 1e-6
POINT_M = 0.6
HEIGHT_M = 4.0
N = 64


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _dist(a, b):
    return np.linalg.norm(_np(a).astype(np.float64) - _np(b).astype(np.float64), axis=-1)


# ---- Snell's law and the plane ----------------------------------------------------

def _rays(seed, count=200):
    d = np.random.default_rng(seed).normal(size=(count, 3))
    d[:, 2] = -np.abs(d[:, 2]) - 0.2            # downward, through a +z normal
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("normal", [(0.0, 0.0, 1.0), (0.1, -0.2, 0.95)])
def test_snell_refraction_matches_jax_and_float64(normal):
    d = _rays(1)
    jt, jtir = jbathy.snell_refraction(jnp.asarray(d), jnp.asarray(normal), 1.0, 1.34)
    tt, ttir = tbathy.snell_refraction(d, normal, 1.0, 1.34, device="cpu")
    assert tt.dtype == torch.float32 and np.abs(tt.numpy() - np.asarray(jt)).max() <= SNELL
    assert np.array_equal(ttir.numpy(), np.asarray(jtir)) and not ttir.any()
    n = np.asarray(normal) / np.linalg.norm(normal)
    down = np.where((d @ n > 0)[:, None], -d, d)    # the oracle's rays go against n
    t64, _ = tbathy.snell_refraction(torch.as_tensor(down), normal, 1.0, 1.34)
    assert t64.dtype == torch.float64
    assert np.abs(t64.numpy() - sds.snell64(down, n, 1.34)).max() <= 1e-14
    # from water to air past the critical angle
    up = -d
    up[:, 2] = 0.05
    _, jtir = jbathy.snell_refraction(jnp.asarray(up), jnp.asarray(normal), 1.34, 1.0)
    _, ttir = tbathy.snell_refraction(up, normal, 1.34, 1.0, device="cpu")
    assert np.array_equal(ttir.numpy(), np.asarray(jtir)) and ttir.any()


def test_intersect_plane_matches_jax():
    rng = np.random.default_rng(2)
    ctr = rng.uniform(-50, 50, (100, 3)) + [0, 0, 120]
    d = _rays(3, 100)
    plane = (0.05, -0.1, 0.99, 12.0)
    jp, jt = jbathy._intersect_plane(jnp.asarray(ctr, jnp.float32), jnp.asarray(d, jnp.float32),
                                     jnp.asarray(plane, jnp.float32))
    tp, tt = tbathy._intersect_plane(ctr, d, plane, device="cpu")
    assert tp.dtype == torch.float32
    assert np.abs(tp.numpy() - np.asarray(jp)).max() <= 1e-5 * np.abs(np.asarray(jp)).max()
    assert np.abs(tt.numpy() - np.asarray(jt)).max() <= 1e-5 * np.abs(np.asarray(jt)).max()


# ---- BathyStereoModel ---------------------------------------------------------------

def _water_pair(baseline, seed=21, count=2000):
    """Two nadir pinholes (f 1500 px) 1000 m above WGS84 at (-122, 37),
    ``baseline`` apart east-west with centres on the fp32 grid, a water
    plane at the datum, ``count`` seeded points 2-20 m under it and their
    exact refracted pixels (float64)."""
    lon, lat = sds.DEM_LONLAT
    east, north, up = sds._enu64(lon, lat)
    nadir = np.stack([east, -north, -up], axis=1)
    c0 = sds._ecef64(lon, lat, sds.DEM_ALT_M)
    cams = [tcam.PinholeModel(np.float32(c0 + s * baseline / 2 * east).astype(np.float64),
                              nadir, (sds.DEM_F, sds.DEM_F), (sds.DEM_PP, sds.DEM_PP))
            for s in (1, -1)]
    plane = sds.water_plane(0.0)
    rng = np.random.default_rng(seed)
    e, n = rng.uniform(-150, 150, (2, count))
    depth = rng.uniform(2.0, 20.0, count)
    pts = (sds._ecef64(lon, lat, 0.0) + e[:, None] * east + n[:, None] * north
           - depth[:, None] * up)
    return cams, plane, pts, [sds.refracted_pixel64(c, pts, plane) for c in cams]


@pytest.mark.parametrize("baseline", [30.0, 300.0])
def test_bathy_stereo_matches_float64_and_jax(baseline):
    cams, plane, pts, pix = _water_pair(baseline)
    # the oracle's pixels are exact: its own triangulation returns the points
    assert _dist(sds.bathy_triangulate64(*cams, *pix, plane), pts).max() <= 1e-6
    p32 = [p.astype(np.float32) for p in pix]
    tp, terr = tbathy.BathyStereoModel(*cams, plane).triangulate(*p32, device="cpu")
    assert tp.dtype == torch.float32 and terr.dtype == torch.float32
    e_port = _dist(tp, pts)
    assert e_port.max() <= POINT_M and np.median(e_port) <= 0.2
    jcams = [jcam.PinholeModel(c.C, c.R, (c.fu, c.fv), (c.cu, c.cv)) for c in cams]
    jp, _ = jbathy.BathyStereoModel(*jcams, plane).triangulate(*(jnp.asarray(p) for p in p32))
    e_jax = _dist(jp, pts)
    assert (_dist(tp, jp) <= e_jax + POINT_M).all()
    if baseline == 30.0:
        assert np.median(e_jax) > 1.0      # the JAX package's fp32 route


def test_bathy_stereo_deeper_than_naive():
    """``tests/test_carto_extras.py``'s case in both packages."""
    jc = [jcam.PinholeModel((x, 0, 10.0), np.eye(3), (500, 500), (100, 100)) for x in (0.0, 2.0)]
    tc = [port_camera(c) for c in jc]
    pix1, pix2 = np.array([[120.0, 100.0]]), np.array([[80.0, 100.0]])
    plane = (0, 0, 1.0, 12.0)
    jpt, _ = jbathy.BathyStereoModel(*jc, plane).triangulate(jnp.asarray(pix1), jnp.asarray(pix2))
    tpt, _ = tbathy.BathyStereoModel(*tc, plane).triangulate(pix1, pix2, device="cpu")
    naive, _, _ = tsm.StereoModel(*tc).triangulate(pix1, pix2, device="cpu")
    assert float(tpt[0, 2]) > float(naive[0, 2])
    assert _dist(tpt, jpt).max() <= 1e-4


# ---- camera fits --------------------------------------------------------------------

def _fit_problem():
    """``tests/test_cartography.py``'s fit: a pinhole 1000 m over 12 seeded
    points, a seed 30 m and 0.06 rad off."""
    r = np.asarray(euler_to_rotation_matrix(0.05, -0.1, 0.02))
    truth = jcam.PinholeModel((100.0, -50.0, 1000.0), r, (800.0, 800.0), (512.0, 384.0))
    rng = np.random.default_rng(1)
    xyz = np.stack([rng.uniform(-300, 300, 12), rng.uniform(-300, 300, 12),
                    rng.uniform(-50, 50, 12)], axis=1)
    pixels = np.asarray(truth.point_to_pixel(jnp.asarray(xyz)))
    seed = jcam.PinholeModel((130.0, -20.0, 960.0),
                             np.asarray(euler_to_rotation_matrix(0.1, -0.05, 0.0)),
                             (800.0, 800.0), (512.0, 384.0))
    return truth, xyz, pixels, seed


SPHERE = (900.0, 900.0)   # a datum the camera flies ~106 m above


def _prior(kind, pkg):
    if kind == "height":
        datum = pkg.Datum("sphere", "sphere", "Greenwich", *SPHERE)
        h = float(np.linalg.norm([100.0, -50.0, 1000.0]) - SPHERE[0])
        return dict(datum=datum, cam_height=h, cam_weight=1.0)
    return dict(cam_ctr_weight=0.1) if kind == "centre" else {}


@pytest.mark.parametrize("kind", ["none", "height", "centre"])
def test_fit_pinhole_matches_jax(kind):
    truth, xyz, pixels, seed = _fit_problem()
    jfit = jcart.fit_pinhole(xyz, pixels, seed, **_prior(kind, jcart))
    tfit = tcart.fit_pinhole(xyz, pixels, port_camera(seed), device="cpu",
                             **_prior(kind, tcart))
    assert isinstance(tfit, tcam.PinholeModel) and tfit is not seed
    assert np.abs(tfit.C - jfit.C).max() <= 0.05 and np.abs(tfit.R - jfit.R).max() <= 1e-4
    pts = torch.as_tensor(xyz, dtype=torch.float32)
    reproj = [np.abs(f.point_to_pixel(pts).numpy() - pixels).max()
              for f in (tfit, port_camera(jfit))]
    assert abs(reproj[0] - reproj[1]) <= 0.01
    # the centre prior holds the camera near its seed, 30 m off
    assert reproj[0] <= (0.5 if kind != "centre" else 1.0)
    assert np.linalg.norm(tfit.C - truth.C) < 25.0


class _ShortSolve(tcam.OpticalBarModel):
    """The port's optical bar with 10 Gauss-Newton steps in
    ``point_to_pixel`` (these points converge in 4)."""

    def point_to_pixel(self, point, iterations=10, **kw):
        return super().point_to_pixel(point, iterations, **kw)


def _jax_optical_bar(args):
    """The JAX package's optical bar whose ``point_to_pixel`` (10 steps) is
    compiled once, with the pose as its arguments: the fit projects 14
    times an LM iteration at other poses, and each eager call of the JAX
    package's method compiles anew (~0.3 s)."""
    static = jcam.OpticalBarModel(*args)

    @jax.jit
    def project(position, rotation, point):
        m = copy.copy(static)
        m.position, m.rotation = position, rotation
        return jcam.OpticalBarModel.point_to_pixel(m, point, 10)

    class Once(jcam.OpticalBarModel):
        def point_to_pixel(self, point, iterations=10):
            return project(*(jnp.asarray(a, jnp.float32)
                             for a in (self.position, self.rotation, point)))

    return Once(*args)


def test_fit_camera_to_datum_optical_bar_matches_jax(monkeypatch):
    """One LM iteration on an optical bar over 10 seeded points 800-1300 m
    along its rays, from a seed 3 m off, in each package;
    ``fit_optical_bar`` is that function. (The rotation is not a half
    turn: ``transform_to_vector``'s axis is undefined there.)"""
    r = np.asarray(euler_to_rotation_matrix(0.3, -0.2, 0.5), np.float64)
    args = ((400, 300), (200, 150), 3e-3, 1.0, 0.5, 1.6, True, (0.0, 0.0, 1000.0), r, (0, 60, 0))
    jm, tm = _jax_optical_bar(args), _ShortSolve(*args)
    rng = np.random.default_rng(4)
    pix = np.stack([rng.uniform(20, 380, 10), rng.uniform(20, 280, 10)], -1).astype(np.float32)
    tp = torch.as_tensor(pix)
    xyz = (tm.camera_center(tp, torch.float64)
           + tm.pixel_to_vector(tp).double() * rng.uniform(800, 1300, (10, 1))).numpy()
    seeds = []
    for m in (jm, tm):
        s = copy.deepcopy(m)
        s.position = s.position + np.array([2.0, -2.0, 1.0])
        seeds.append(s)
    jfit = jcart.fit_camera_to_datum(xyz, pix, seeds[0], max_iterations=1)
    tfit = tcart.fit_camera_to_datum(xyz, pix, seeds[1], max_iterations=1, device="cpu")
    assert np.abs(tfit.position - jfit.position).max() <= 1e-3
    assert np.abs(tfit.rotation - jfit.rotation).max() <= 1e-6
    assert np.linalg.norm(tfit.position - tm.position) < np.linalg.norm([2.0, -2.0, 1.0])
    from visionworkbench_torch.cartography import camera_fit
    seen = {}
    monkeypatch.setattr(camera_fit, "fit_camera_to_datum",
                        lambda *a, **k: seen.update(args=a, kwargs=k) or "fit")
    assert camera_fit.fit_optical_bar(xyz, pix, tm, device="cpu") == "fit"
    assert seen["args"][2] is tm and seen["kwargs"] == {"device": "cpu"}


# ---- the slice at 64^2 ----------------------------------------------------------------

def _dems(sc, txyz, tv, jxyz, jv, e_jax):
    """Both packages' DEMs of their points: cells agreeing on >= 0.95,
    heights within the JAX package's point error + HEIGHT_M."""
    g = sc["dem"].shape[0]
    tdem, tdv = tcart.point_image_to_dem(txyz, tv, sc["dem_georef"], g, g, device="cpu")
    jdem, jdv = jcart.point_image_to_dem(jxyz, jv, jax_georef(sc["dem_georef"]), g, g)
    both = tdv.numpy() & np.asarray(jdv)
    assert (tdv.numpy() == np.asarray(jdv)).mean() >= 0.95 and both.mean() > 0.2
    assert np.abs(tdem.numpy() - np.asarray(jdem))[both].max() <= e_jax + HEIGHT_M
    return tdem.numpy(), tdv.numpy()


def test_opticalbar_dem_slice_matches_jax():
    """opticalbar-dem at 64^2: the true disparity through both packages'
    ``StereoModel`` (the port's with its float64 per-pixel centres), against
    the float64 oracle, then both DEMs."""
    sc = sds.scene(N)
    cams = sds.optical_bar_pair(N)
    jcams = [jcam.OpticalBarModel(c.image_size, c.c0, c.pitch, c.f, c.scan_time, c.scan_rate,
                                  c.left_to_right, c.position, c.rotation, c.velocity)
             for c in cams]
    assert all(np.array_equal(port_camera(j).position, c.position) for j, c in zip(jcams, cams))
    d, v = sds.ob_truth(*cams, sc, N, "cpu")
    d32 = d.astype(np.float32)
    txyz, _, tv = tsm.StereoModel(*cams).point_cloud(TDM(torch.as_tensor(d32), torch.as_tensor(v)))
    jxyz, _, jv = jsm.StereoModel(*jcams).point_cloud(JDM(jnp.asarray(d32), jnp.asarray(v)))
    assert np.array_equal(tv.numpy(), np.asarray(jv)) and v.mean() > 0.8
    pix1 = np.stack(np.meshgrid(np.arange(N), np.arange(N)), -1).astype(np.float32)
    truth = sds.ob_triangulate64(*cams, pix1, pix1 + d32)
    assert _dist(txyz, truth)[v].max() <= POINT_M
    e_jax = _dist(jxyz, truth)[v].max()
    tdem, tdv = _dems(sc, txyz, tv, jxyz, jv, e_jax)
    assert np.median(np.abs(tdem - sc["dem"])[tdv]) <= 5.0


def test_bathy_dem_slice_matches_jax():
    """bathy-dem at 64^2: the true disparity of the rectified pair over the
    water through ``StereoModel`` and, below the plane, ``BathyStereoModel``
    in both packages, against the float64 oracles, then both DEMs; the
    refraction-free depths are shallower."""
    sc = sds.scene(N)
    plane = sds.water_plane()
    rect = sds.rectify(sc)
    jrect = [jcam.PinholeModel(c.C, c.R, (c.fu, c.fv), (c.cu, c.cv)) for c in rect]
    d, v, under = sds.bathy_truth(*rect, sc, N, "cpu", plane)
    assert under.mean() > 0.05 and (~under & v).mean() > 0.3
    d32 = d.astype(np.float32)
    pix1 = np.stack(np.meshgrid(np.arange(N), np.arange(N)), -1).astype(np.float32)
    pix2 = pix1 + d32
    wet = under & v
    txyz, _, tv = tsm.StereoModel(*rect).point_cloud(TDM(torch.as_tensor(d32), torch.as_tensor(v)))
    tb = tbathy.BathyStereoModel(*rect, plane).triangulate(pix1, pix2, device="cpu")[0]
    jxyz, _, jv = jsm.StereoModel(*jrect).point_cloud(JDM(jnp.asarray(d32), jnp.asarray(v)))
    jb = jbathy.BathyStereoModel(*jrect, plane).triangulate(jnp.asarray(pix1), jnp.asarray(pix2))[0]
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    truth = np.where(wet[..., None], sds.bathy_triangulate64(*rect, pix1, pix2, plane),
                     sds.triangulate64(*rect, pix1, pix2))
    tm = np.where(wet[..., None], tb.numpy(), txyz.numpy())
    jm = np.where(wet[..., None], np.asarray(jb), np.asarray(jxyz))
    assert _dist(tm, truth)[v].max() <= POINT_M
    e_jax = _dist(jm, truth)[v].max()
    assert _dist(jm, truth)[wet].max() > 1.0          # the JAX package's fp32 route
    tdem, tdv = _dems(sc, tm, tv.numpy(), jm, np.asarray(jv), e_jax)
    # the refraction-free DEM's depths under the water are shallower
    g = sc["dem"].shape[0]
    naive, nv = tcart.point_image_to_dem(txyz, tv, sc["dem_georef"], g, g)
    cells = tdv & nv.numpy() & (sc["dem"] < sds.DEM_WATER_M)
    ratio = np.median((sds.DEM_WATER_M - naive.numpy()[cells])
                      / (sds.DEM_WATER_M - tdem[cells]))
    assert cells.sum() > 20 and ratio < 0.9
