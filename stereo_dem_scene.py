"""The stereo-dem scene and its float64 oracle, shared by ``chip_smoke.py``'s
phase 8 and the CPU tests of the port's cameras, triangulation and DEMs.

stereo-dem-1024 is the Ames Stereo Pipeline flow of a nadir frame-camera
pair (camera models -> rectified pair -> correlator -> triangulation ->
point cloud -> DEM -> hillshade / colormap) on WGS84 at (-122, 37). The
cameras are this configuration's weights; every array is made from a seed.
:func:`scene` builds it at any side ``n`` (f, the principal point, the DEM
grid and the texture scaled by n / DEM_N); :func:`render` takes its images
through the port; :func:`disparity` and :func:`triangulate64` are the
float64 truth the port is held to.

    import stereo_dem_scene as sds
    sc = sds.scene(64)
    left = sds.render(sc["left"], sc, 64, "cpu")
"""

from __future__ import annotations

import numpy as np

DEM_N = 1024                 # image side, px
DEM_LONLAT = (-122.0, 37.0)  # the scene's centre, degrees
DEM_ALT_M = 1000.0           # the cameras' height above the datum
DEM_F = 1500.0               # focal length, px (scaled by n / DEM_N)
DEM_PP = 511.5               # principal point, px (scaled by n / DEM_N)
DEM_TSAI = (-0.1, 0.02, 1e-3, -5e-4)   # k1, k2, p1, p2 (tests/test_camera.py:37)
DEM_BASELINE_M = 30.0        # east-west; the left camera to the east
# small attitude errors (x, y, z rotations, rad) of the left and the right
# camera, which the rectification takes out
DEM_ATTITUDE = ((0.004, -0.003, 0.002), (-0.003, 0.002, -0.001))
DEM_HALF_M = 400.0           # half-side of the DEM's and the texture's area
DEM_GRID = 512               # DEM cells a side (true DEM and output DEM)
DEM_TEX = 2048               # ortho texture texels a side
DEM_HILL_M = 100.0           # relief of the true DEM
DEM_SEED = 23                # the hills
DEM_TEX_SEED = 11            # the texture (bench.py's)
DEM_NODATA = -9999.0
DEM_COVER = 1 - 1e-3         # a warp's coverage that counts as a valid pixel
DEM_POINT_M = 0.6            # points from the true disparity against float64
DEM_CAHV_M = 1.0             # the CAHV route against the pinhole route


def texture(h, w, seed):
    """``tools_bench_configs.py:96-101``'s texture, (h, w + 80)."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w + 80].astype(np.float32)
    return (np.sin(xs * 0.21) * np.cos(ys * 0.17)
            + 0.5 * np.sin(xs * 0.047 + ys * 0.031)
            + 0.3 * rng.random(xs.shape)).astype(np.float32)


def _enu64(lon, lat):
    """East, north and up unit vectors at (lon, lat), ECEF, float64."""
    lo, la = np.radians(lon), np.radians(lat)
    return (np.array([-np.sin(lo), np.cos(lo), 0.0]),
            np.array([-np.sin(la) * np.cos(lo), -np.sin(la) * np.sin(lo), np.cos(la)]),
            np.array([np.cos(la) * np.cos(lo), np.cos(la) * np.sin(lo), np.sin(la)]))


def _ecef64(lon, lat, h, a=6378137.0, b=6356752.314245):
    """WGS84 geodetic -> ECEF in float64."""
    lo, la = np.radians(lon), np.radians(lat)
    e2 = 1 - (b * b) / (a * a)
    n = a / np.sqrt(1 - e2 * np.sin(la) ** 2)
    return np.array([(n + h) * np.cos(la) * np.cos(lo), (n + h) * np.cos(la) * np.sin(lo),
                     (n * (1 - e2) + h) * np.sin(la)])


def _rot64(x, y, z):
    """Rotation about x, then y, then z (rad), float64."""
    cx, sx, cy, sy, cz, sz = np.cos(x), np.sin(x), np.cos(y), np.sin(y), np.cos(z), np.sin(z)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rz @ ry @ rx


def _hills(g, seed):
    """A true DEM of smooth hills (six Gaussian bumps, 150-300 m wide) on a
    g x g grid over the area, scaled to 0 .. DEM_HILL_M metres."""
    rng = np.random.default_rng(seed)
    m = (np.arange(g) + 0.5) / g * 2 * DEM_HALF_M - DEM_HALF_M
    x, y = np.meshgrid(m, -m)                      # east, north; row 0 north
    z = np.zeros((g, g))
    for _ in range(6):
        cx, cy = rng.uniform(-DEM_HALF_M, DEM_HALF_M, 2)
        sig = rng.uniform(150.0, 300.0)
        z += rng.uniform(0.5, 1.0) * np.exp(-((x - cx) ** 2 + (y - cy) ** 2) / (2 * sig * sig))
    return ((z - z.min()) / (z.max() - z.min()) * DEM_HILL_M).astype(np.float32)


def scene(n=DEM_N, fp32_centres=True):
    """stereo-dem at side ``n``: the left and right TSAI pinholes (nadir,
    DEM_ALT_M above the datum, DEM_BASELINE_M apart east-west, the left one
    east, so the disparity is positive after rectification), the true DEM
    and its geographic georef, the texture and its georef. The centres lie
    on the fp32 grid (an ECEF ulp is 0.5 m here), so the port's fp32
    rendering (``camera_center``, then ``camera_pixel_to_dem_xyz``) sees the
    pair from the models' own centres; ``fp32_centres=False`` gives the
    float64 centres instead."""
    from visionworkbench_torch.camera import PinholeModel, TsaiLensDistortion
    from visionworkbench_torch.cartography import GeoReference, Projection, well_known_datum
    s = n / DEM_N
    lon0, lat0 = DEM_LONLAT
    east, north, up = _enu64(lon0, lat0)
    nadir = np.stack([east, -north, -up], axis=1)   # image x east, y south, z down
    c0 = _ecef64(lon0, lat0, DEM_ALT_M)
    centres = [c0 + side * DEM_BASELINE_M / 2 * east for side in (1, -1)]
    if fp32_centres:
        centres = [np.float32(c).astype(np.float64) for c in centres]
    cams = [PinholeModel(c, nadir @ _rot64(*att),
                         (DEM_F * s, DEM_F * s), (DEM_PP * s, DEM_PP * s),
                         TsaiLensDistortion(*DEM_TSAI))
            for c, att in zip(centres, DEM_ATTITUDE)]
    datum = well_known_datum("WGS84")
    dlat = np.degrees(2 * DEM_HALF_M / 6371000.0)
    dlon = dlat / np.cos(np.radians(lat0))

    def georef(cells):
        t = np.array([[dlon / cells, 0, lon0 - dlon / 2], [0, -dlat / cells, lat0 + dlat / 2],
                      [0, 0, 1]])
        return GeoReference(datum, Projection(datum), t)

    g = int(round(DEM_GRID * s))
    t = int(round(DEM_TEX * s))
    return {"left": cams[0], "right": cams[1], "dem": _hills(g, DEM_SEED),
            "dem_georef": georef(g), "cell_m": 2 * DEM_HALF_M / g,
            "tex": texture(t, t - 80, DEM_TEX_SEED), "tex_georef": georef(t)}


def pixel_grid(n, dev):
    """(n, n, 2) fp32 (x, y) pixels of an n^2 frame on ``dev``."""
    import torch
    from visionworkbench_torch.image.transform import _dest_grid
    return torch.stack(_dest_grid(n, n, dev), -1)


def _dem_hits(cam, sc, n, dev):
    """``camera_pixel_to_dem_xyz`` of every pixel of ``cam`` (n^2) on the
    true DEM: fp32 ECEF points and where the rays hit."""
    from visionworkbench_torch.cartography import camera_pixel_to_dem_xyz
    return camera_pixel_to_dem_xyz(pixel_grid(n, dev), cam, sc["dem"], sc["dem_georef"])


def render(cam, sc, n, dev):
    """The image ``cam`` takes of the textured true DEM, through the port:
    ``pixel_to_vector`` (the TSAI Newton), ``camera_pixel_to_dem_xyz`` on the
    true DEM, lon/lat, a bilinear sample of the texture (0 where the ray
    misses the DEM)."""
    import torch
    from visionworkbench_torch.image.interpolation import interpolate
    xyz, valid = _dem_hits(cam, sc, n, dev)
    llh = sc["dem_georef"].datum.cartesian_to_geodetic(xyz)
    tx, ty = sc["tex_georef"].lonlat_to_pixel(llh[..., 0], llh[..., 1])
    img = interpolate(torch.as_tensor(sc["tex"], device=dev), tx, ty, "bilinear")
    return torch.where(valid, img, 0.0)


def rectify(sc):
    """The rectified (left, right) pinholes: ``epipolar_rectify`` given the
    right camera first, so the rectified x axis runs from the right camera
    to the left one and the left-to-right disparity is positive."""
    from visionworkbench_torch.camera import epipolar_rectify
    rect_r, rect_l = epipolar_rectify(sc["right"], sc["left"])
    return rect_l, rect_r


def warp(img, cam, rect, n):
    """``camera_transform`` of an image into its rectified camera, with the
    warp's coverage (a plane of ones warped beside it) as the valid mask."""
    import torch
    from visionworkbench_torch.camera import camera_transform
    out = camera_transform(torch.stack([img, torch.ones_like(img)], -1), cam, rect, (n, n))
    return out[..., 0].contiguous(), out[..., 1] >= DEM_COVER


def depth(rect_l, sc, n, dev):
    """How far the rectified left camera sees along each pixel's ray: its
    hits on the true DEM (``camera_pixel_to_dem_xyz``), float64 (n, n), and
    where it hits."""
    xyz, valid = _dem_hits(rect_l, sc, n, dev)
    return np.linalg.norm(xyz.double().cpu().numpy() - rect_l.C, axis=-1), valid.cpu().numpy()


def ray64(cam, pix):
    """Float64 unit rays of a pinhole without distortion."""
    x = (pix[..., 0] * cam.pixel_pitch - cam.cu) / cam.fu
    y = (pix[..., 1] * cam.pixel_pitch - cam.cv) / cam.fv
    ray = np.stack([x, y, np.ones_like(x)], -1) @ cam.R.T
    return ray / np.linalg.norm(ray, axis=-1, keepdims=True)


def project64(cam, pts):
    """Float64 pixels of ECEF points through a pinhole without distortion."""
    c = (pts - cam.C) @ cam.R
    return np.stack([c[..., 0] / c[..., 2] * cam.fu + cam.cu,
                     c[..., 1] / c[..., 2] * cam.fv + cam.cv], -1) / cam.pixel_pitch


def disparity(rect_l, rect_r, dist):
    """The true disparity of a rectified pair, float64 (n, n, 2): each
    pixel's float64 ray from the left camera's centre, ``dist`` along it
    (:func:`depth`), projected into the right camera."""
    n = dist.shape[0]
    pix = np.stack(np.meshgrid(np.arange(n), np.arange(n)), -1).astype(np.float64)
    return project64(rect_r, rect_l.C + ray64(rect_l, pix) * dist[..., None]) - pix


def triangulate64(cam1, cam2, pix1, pix2):
    """The float64 oracle of ``StereoModel.triangulate`` for pinholes without
    distortion: float64 rays and centres, ``triangulate_pair``'s midpoint."""
    d0, d1 = ray64(cam1, np.asarray(pix1, np.float64)), ray64(cam2, np.asarray(pix2, np.float64))
    c0, c1 = cam1.C, cam2.C
    v12 = np.cross(d0, d1)
    v1, v2 = np.cross(v12, d0), np.cross(v12, d1)
    t0 = np.sum(v2 * (c1 - c0), -1) / np.sum(v2 * d0, -1)
    t1 = np.sum(v1 * (c0 - c1), -1) / np.sum(v1 * d1, -1)
    return 0.5 * ((c0 + t0[..., None] * d0) + (c1 + t1[..., None] * d1))
