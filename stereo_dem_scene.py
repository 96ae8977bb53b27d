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

Two more flows run over the same place, DEM and texture (``chip_smoke.py``
phase 9): opticalbar-dem, a panoramic (KH-4/KH-9 style) pair whose centres
move during the scan (:func:`optical_bar_pair`, :func:`ob_truth`), and
bathy-dem, stereo-dem's pinhole pair over a water body whose rays refract at
a water plane (:func:`water_plane`, :func:`render_refracted`,
:func:`bathy_truth`, :func:`bathy_triangulate64`).

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

# opticalbar-dem: a panoramic pair 1000 m up, flying north, scanning west to
# east (0.8 rad in 0.5 s: 0.78 m a pixel at 1000 m); the pitch is scaled by
# DEM_N / n, so the pair sees the same area at any side n
OB_PITCH_M = 7.8e-4
OB_F_M = 1.0
OB_SCAN_S = 0.5
OB_SCAN_RATE = 1.6           # rad/s
OB_SPEED = 60.0              # m/s, north
# the search: the true disparity spans x 32.8..42.3 px, y -4.5..5.7 px at
# 1024^2; the texture repeats under a shift of (7.5, 9.2) px, and a search
# starting lower in y lets the coarse levels lock onto that alias
OB_SEARCH = (0, -6, 64, 16)
# bathy-dem: a water plane DEM_WATER_M above the datum at the scene's
# centre, its normal the local up
DEM_WATER_M = 30.0
WATER_INDEX = 1.34


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
    return texture_at(sc, *_dem_hits(cam, sc, n, dev))


def texture_at(sc, xyz, valid):
    """The texture at ECEF ground points (lon/lat, a bilinear sample), 0
    where ``valid`` is false."""
    import torch
    from visionworkbench_torch.image.interpolation import interpolate
    llh = sc["dem_georef"].datum.cartesian_to_geodetic(xyz)
    tx, ty = sc["tex_georef"].lonlat_to_pixel(llh[..., 0], llh[..., 1])
    img = interpolate(torch.as_tensor(sc["tex"], device=xyz.device), tx, ty, "bilinear")
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
    return _midpoint64(ray64(cam1, np.asarray(pix1, np.float64)), cam1.C,
                       ray64(cam2, np.asarray(pix2, np.float64)), cam2.C)


def _midpoint64(d0, c0, d1, c1):
    """The midpoint of the closest approach of the rays (c0, d0), (c1, d1)
    (``triangulate_pair``), float64."""
    v12 = np.cross(d0, d1)
    v1, v2 = np.cross(v12, d0), np.cross(v12, d1)
    t0 = np.sum(v2 * (c1 - c0), -1) / np.sum(v2 * d0, -1)
    t1 = np.sum(v1 * (c0 - c1), -1) / np.sum(v1 * d1, -1)
    return 0.5 * ((c0 + t0[..., None] * d0) + (c1 + t1[..., None] * d1))


# ---- opticalbar-dem ------------------------------------------------------------

def optical_bar_pair(n=DEM_N):
    """The (left, right) ``OpticalBarModel``s of opticalbar-dem at side n:
    1000 m above the datum at the scene's centre, DEM_BASELINE_M apart
    east-west (the left one east, so the disparity is positive), flying
    north at OB_SPEED, the film's x east (the scan west to east), its y
    south; centres on the fp32 grid."""
    from visionworkbench_torch.camera import OpticalBarModel
    lon0, lat0 = DEM_LONLAT
    east, north, up = _enu64(lon0, lat0)
    rot = np.stack([east, -north, -up], axis=1)
    c0 = _ecef64(lon0, lat0, DEM_ALT_M)
    pitch = OB_PITCH_M * DEM_N / n
    return [OpticalBarModel((n, n), (n / 2, n / 2), pitch, OB_F_M, OB_SCAN_S, OB_SCAN_RATE,
                            True, np.float32(c0 + side * DEM_BASELINE_M / 2 * east)
                            .astype(np.float64), rot, OB_SPEED * north)
            for side in (1, -1)]


def _ob_time64(cam, x):
    frac = x / cam.image_size[0]
    return (frac if cam.left_to_right else 1.0 - frac) * cam.scan_time


def ob_center64(cam, pix):
    """Float64 per-pixel centres of an optical-bar camera."""
    return cam.position + _ob_time64(cam, pix[..., 0])[..., None] * cam.velocity


def ob_ray64(cam, pix):
    """Float64 unit rays of an optical-bar camera (the JAX package's model:
    no motion-compensation or cylinder term)."""
    alpha = (_ob_time64(cam, pix[..., 0]) - 0.5 * cam.scan_time) * cam.scan_rate
    y_m = (pix[..., 1] - cam.c0[1]) * cam.pitch
    ray = np.stack([np.sin(alpha) * cam.f, y_m, np.cos(alpha) * cam.f], -1) @ cam.rotation.T
    return ray / np.linalg.norm(ray, axis=-1, keepdims=True)


def ob_project64(cam, pts, iters=8):
    """Float64 pixels of ECEF points through an optical-bar camera: the
    column fixes the scan time, hence the centre; a fixed-point iteration
    on the column (the centre moves ~0.03 m a column against ~1000 m of
    range, so each step gains ~4 digits)."""
    x = np.full(pts.shape[:-1], cam.image_size[0] / 2.0)
    for _ in range(iters):
        d = (pts - ob_center64(cam, np.stack([x, x], -1))) @ cam.rotation
        alpha = np.arctan2(d[..., 0], d[..., 2])
        frac = (alpha / cam.scan_rate + 0.5 * cam.scan_time) / cam.scan_time
        x = (frac if cam.left_to_right else 1.0 - frac) * cam.image_size[0]
    y = d[..., 1] / np.hypot(d[..., 0], d[..., 2]) * cam.f / cam.pitch + cam.c0[1]
    return np.stack([x, y], -1)


def ob_ground64(cam, xyz):
    """Float64 ground points of an optical-bar camera's n x n frame on its
    pixels' float64 rays: each rendered hit's (``xyz``, fp32 (n, n, 3))
    range from its pixel's fp32 centre, taken along the pixel's float64 ray
    from its float64 centre. (The fp32 march of ``camera_pixel_to_dem_xyz``
    leaves its hits up to ~2 m off their rays, 0.5 m an ECEF ulp.)"""
    n = xyz.shape[0]
    grid = pixel_grid(n, xyz.device)
    dist = np.linalg.norm(xyz.double().cpu().numpy()
                          - cam.camera_center(grid).double().cpu().numpy(), axis=-1)
    pix = grid.double().cpu().numpy()
    return ob_center64(cam, pix) + ob_ray64(cam, pix) * dist[..., None]


def ob_truth(left, right, sc, n, dev):
    """The true disparity of the optical-bar pair, float64 (n, n, 2), and
    where the left rays hit the DEM: each left pixel's ground point
    (:func:`ob_ground64`) projected into the right camera in float64."""
    xyz, valid = _dem_hits(left, sc, n, dev)
    pix = np.stack(np.meshgrid(np.arange(n), np.arange(n)), -1).astype(np.float64)
    return ob_project64(right, ob_ground64(left, xyz)) - pix, valid.cpu().numpy()


def ob_triangulate64(cam1, cam2, pix1, pix2):
    """The float64 oracle of ``StereoModel.triangulate`` for optical-bar
    cameras: float64 rays and per-pixel centres, the midpoint."""
    pix1, pix2 = np.asarray(pix1, np.float64), np.asarray(pix2, np.float64)
    return _midpoint64(ob_ray64(cam1, pix1), ob_center64(cam1, pix1),
                       ob_ray64(cam2, pix2), ob_center64(cam2, pix2))



# ---- bathy-dem -----------------------------------------------------------------

def water_plane(height=DEM_WATER_M):
    """(a, b, c, d), ax + by + cz = d: the plane through the point ``height``
    above the datum at the scene's centre, its normal the local up."""
    _, _, up = _enu64(*DEM_LONLAT)
    return np.concatenate([up, [up @ _ecef64(*DEM_LONLAT, height)]])


def snell64(d, n, index):
    """Float64 refraction of unit rays ``d`` entering water (index) through
    the unit normal ``n`` (the port's ``snell_refraction`` from air)."""
    cos_i = np.abs(d @ n)
    eta = 1.0 / index
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    t = eta * d + (eta * cos_i - np.sqrt(k))[..., None] * n
    return t / np.linalg.norm(t, axis=-1, keepdims=True)


def bend64(c, d, plane, index=WATER_INDEX):
    """Float64 surface points and refracted rays of rays (c, d) from above
    the plane."""
    n = plane[:3]
    t = (plane[3] - c @ n) / (d @ n)
    return c + t[..., None] * d, snell64(d, n, index)


def refracted_pixel64(cam, pts, plane, index=WATER_INDEX, iters=30):
    """Float64 pixels through a pinhole without distortion of points under
    the water: the surface point where the ray from the camera's centre
    obeys Snell's law (a Newton solve of the horizontal offset on the
    vertical plane through the centre and the point), projected."""
    n = plane[:3]
    hc = cam.C @ n - plane[3]                     # the camera's height above the plane
    dp = np.maximum(plane[3] - pts @ n, 0.0)      # the points' depths
    foot_c = cam.C - hc * n
    u = (pts + dp[..., None] * n) - foot_c
    r_full = np.linalg.norm(u, axis=-1)
    unit = u / np.maximum(r_full, 1e-300)[..., None]
    r = r_full * hc / (hc + dp)                   # the straight line's crossing
    wet = dp > 0                                  # a point on the surface is its own
    with np.errstate(divide="ignore", invalid="ignore"):
        r = _snell_offset(r, r_full, hc, dp, wet, index, iters)
    return project64(cam, foot_c + r[..., None] * unit)


def _snell_offset(r, r_full, hc, dp, wet, index, iters):
    for _ in range(iters):
        a, b = np.hypot(r, hc), np.maximum(np.hypot(r_full - r, dp), 1e-300)
        f = r / a - index * (r_full - r) / b
        df = hc * hc / a ** 3 + index * dp * dp / b ** 3
        r = np.where(wet, np.clip(r - f / np.maximum(df, 1e-300), 0.0, r_full), r_full)
    return r


def bathy_triangulate64(cam1, cam2, pix1, pix2, plane, index=WATER_INDEX):
    """The float64 oracle of ``BathyStereoModel.triangulate`` for pinholes
    without distortion: float64 rays bent at the plane, the midpoint."""
    c1, d1 = bend64(cam1.C, ray64(cam1, np.asarray(pix1, np.float64)), plane, index)
    c2, d2 = bend64(cam2.C, ray64(cam2, np.asarray(pix2, np.float64)), plane, index)
    return _midpoint64(d1, c1, d2, c2)


def ray_camera(centres, rays):
    """A ``CameraModel`` of per-pixel ray origins and directions of a whole
    n x n frame ((n, n, 3) fp32 tensors): ``camera_center`` and
    ``pixel_to_vector`` of that frame's pixel grid return them
    (``camera_pixel_to_dem_xyz`` marches from them)."""
    from visionworkbench_torch.camera import CameraModel

    class RayCamera(CameraModel):
        def camera_center(self, pixel=None, dtype=None):
            return centres

        def pixel_to_vector(self, pixel):
            return rays

    return RayCamera()


def refracted_hits(cam, sc, n, dev, plane, rays64=None):
    """Where the rays of ``cam`` (a pinhole) meet the true DEM through the
    water: the plain rays' hits (``camera_pixel_to_dem_xyz``) say which
    pixels see terrain under the plane; those march from their float64
    surface point (rounded to fp32) along their float64 refracted ray
    (rounded), the rest along the plain ray. ``rays64`` (float64 (n, n, 3))
    replaces the port's fp32 rays in the refraction. Returns the fp32 hits,
    where they hit, where the terrain is under water (n, n) and the float64
    surface points and refracted rays."""
    import torch
    from visionworkbench_torch.cartography import camera_pixel_to_dem_xyz
    grid = pixel_grid(n, dev)
    rays = cam.pixel_to_vector(grid)
    plain, hit = camera_pixel_to_dem_xyz(grid, cam, sc["dem"], sc["dem_georef"])
    under = hit.cpu().numpy() & (plain.double().cpu().numpy() @ plane[:3] < plane[3])
    d64 = rays.double().cpu().numpy() if rays64 is None else rays64
    surf, bent = bend64(cam.C, d64, plane)
    sel = torch.as_tensor(under, device=dev)[..., None]
    wet = ray_camera(
        torch.where(sel, torch.as_tensor(surf, dtype=torch.float32, device=dev),
                    cam.camera_center(grid).expand(rays.shape)),
        torch.where(sel, torch.as_tensor(bent, dtype=torch.float32, device=dev),
                    rays if rays64 is None else torch.as_tensor(
                        rays64, dtype=torch.float32, device=dev)))
    xyz, valid = camera_pixel_to_dem_xyz(grid, wet, sc["dem"], sc["dem_georef"])
    return xyz, valid, under, surf, bent


def render_refracted(cam, sc, n, dev, plane):
    """The image ``cam`` takes of the textured true DEM through the water
    (:func:`refracted_hits`), and where its rays hit."""
    xyz, valid = refracted_hits(cam, sc, n, dev, plane)[:2]
    return texture_at(sc, xyz, valid), valid


def bathy_truth(rect_l, rect_r, sc, n, dev, plane):
    """The true disparity of the rectified pair over the water, float64 (n,
    n, 2), where the left rays hit the DEM, and where they see terrain under
    the water: each rectified left pixel's hit's range from its ray origin
    (centre, or surface point under the water) taken along its float64 ray
    (bent under the water), projected into the right camera (through the
    water by :func:`refracted_pixel64`)."""
    pix = np.stack(np.meshgrid(np.arange(n), np.arange(n)), -1).astype(np.float64)
    d64 = ray64(rect_l, pix)
    xyz, valid, under, surf, bent = refracted_hits(rect_l, sc, n, dev, plane, d64)
    xyz = xyz.double().cpu().numpy()
    origin = np.where(under[..., None], surf.astype(np.float32).astype(np.float64), rect_l.C)
    dist = np.linalg.norm(xyz - origin, axis=-1)[..., None]
    right = project64(rect_r, rect_l.C + d64 * dist)
    right[under] = refracted_pixel64(rect_r, (surf + bent * dist)[under], plane)
    return right - pix, valid.cpu().numpy(), under
