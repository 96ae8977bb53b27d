"""Camera-to-ground intersection and footprints (port of
``visionworkbench_tpu/cartography/camera_bbox.py``; ref
``src/vw/Cartography/CameraBBox.h:36-103``).

``intersect_datum``: closed-form ray/ellipsoid intersection (the reference's
``datum_intersection``); ``camera_pixel_to_dem_xyz``: 20 march steps of the
ray onto a DEM (a Python loop of the JAX package's count, no convergence
test); ``camera_bbox``: ground footprint of the full image. fp32 tensors: a
tensor keeps its device, an array goes to ``device`` (``None`` = the card).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from visionworkbench_torch.camera.model import CameraModel
from visionworkbench_torch.cartography.datum import Datum
from visionworkbench_torch.cartography.georeference import GeoReference
from visionworkbench_torch.core.device import as_f32, dot, on_device, resolve_device, sqrt_rn
from visionworkbench_torch.image.interpolation import interpolate
from visionworkbench_torch.math.bbox import BBox2


def intersect_datum(ctr, dir, datum: Datum, height: float = 0.0, device=None):
    """Ray/ellipsoid intersection (ref ``datum_intersection``, CameraBBox.h).

    Returns ((..., 3) ECEF points, (...,) valid). ``height`` inflates the
    ellipsoid (intersection with a constant-height surface).
    """
    dir = on_device(dir, device, torch.float32)
    ctr = on_device(ctr, dir.device, torch.float32).to(dir.device)
    a = datum.a + height
    b = datum.b + height
    scale = as_f32([1.0 / a, 1.0 / a, 1.0 / b], dir)
    o = ctr * scale
    d = dir * scale
    # Solve |o + t d|^2 = 1
    aa = dot(d, d)
    bb = 2 * dot(o, d)
    cc = dot(o, o) - 1.0
    disc = bb * bb - 4 * aa * cc
    valid = disc >= 0
    sq = sqrt_rn(torch.clamp(disc, min=0.0))
    t = (-bb - sq) / (2 * aa)   # nearer root
    valid = valid & (t > 0)
    pts = ctr + t[..., None] * dir
    return torch.where(valid[..., None], pts, 0.0), valid


def camera_pixel_to_datum_lonlat(pixels, camera: CameraModel, datum: Datum,
                                 height: float = 0.0, device=None):
    """(..., 2) pixels -> (lon, lat, valid) on the datum surface."""
    pixels = on_device(pixels, device, torch.float32)
    dirs = camera.pixel_to_vector(pixels)
    ctr = camera.camera_center(pixels).expand(dirs.shape)
    xyz, valid = intersect_datum(ctr, dirs, datum, height)
    llh = datum.cartesian_to_geodetic(xyz)
    return llh[..., 0], llh[..., 1], valid


def camera_pixel_to_dem_xyz(pixel, camera: CameraModel, dem,
                            dem_georef: GeoReference,
                            dem_nodata: Optional[float] = None,
                            iterations: int = 20, device=None):
    """Iterative ray/DEM intersection (ref ``camera_pixel_to_dem_xyz``,
    CameraBBox.h:59): start at the datum-surface hit, then alternate
    project-to-DEM / march-along-ray ``iterations`` times."""
    pixel = on_device(pixel, device, torch.float32)
    dem = on_device(dem, pixel.device, torch.float32).to(pixel.device)
    dirs = camera.pixel_to_vector(pixel)
    ctr = camera.camera_center(pixel).expand(dirs.shape)
    datum = dem_georef.datum

    def dem_height_at(xyz):
        llh = datum.cartesian_to_geodetic(xyz)
        px, py = dem_georef.lonlat_to_pixel(llh[..., 0], llh[..., 1])
        h = interpolate(dem, px, py, "bilinear")
        inside = ((px >= 0) & (px <= dem.shape[1] - 1) &
                  (py >= 0) & (py <= dem.shape[0] - 1))
        if dem_nodata is not None:
            inside = inside & (h != dem_nodata)
        return h, llh[..., 2], inside

    xyz, valid = intersect_datum(ctr, dirs, datum, 0.0)
    for _ in range(iterations):
        h_dem, h_ray, inside = dem_height_at(xyz)
        # March along the ray by the height error (projected onto the ray's
        # vertical component, approximated with unit factor).
        err = h_ray - h_dem
        xyz_new = xyz + err[..., None] * dirs
        xyz = torch.where(valid[..., None], xyz_new, xyz)
        valid = valid & inside
    return torch.where(valid[..., None], xyz, 0.0), valid


def camera_bbox(camera: CameraModel, datum: Datum, cols: int, rows: int,
                samples: int = 100, device=None) -> Tuple[BBox2, bool]:
    """Lon/lat footprint of the image on the datum (ref ``camera_bbox``,
    CameraBBox.h:72-103), its rays on ``device`` (``None`` = the card).
    Returns (bbox, all_rays_hit)."""
    n = int(np.sqrt(samples))
    xs = np.linspace(0, cols - 1, n)
    ys = np.linspace(0, rows - 1, n)
    gx, gy = np.meshgrid(xs, ys)
    pix = torch.as_tensor(np.stack([gx.ravel(), gy.ravel()], -1), dtype=torch.float32,
                          device=resolve_device(device))
    lon, lat, valid = camera_pixel_to_datum_lonlat(pix, camera, datum)
    lon, lat, valid = lon.cpu().numpy(), lat.cpu().numpy(), valid.cpu().numpy()
    if not valid.any():
        return BBox2.empty(), False
    box = BBox2.from_bounds(lon[valid].min(), lat[valid].min(),
                            lon[valid].max(), lat[valid].max())
    return box, bool(valid.all())
