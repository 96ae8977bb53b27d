"""Cartesian <-> geodetic image operations (port of
``visionworkbench_tpu/cartography/point_image.py``; ref
``src/vw/Cartography/PointImageManipulation.h``): whole-image conversions
between DEMs, lon/lat/height images, and ECEF point images.

Kept divergence: :func:`point_image_to_dem` converts the fp32 points to
geodetic in float64 and rounds lon/lat to fp32 once for the georef (the
JAX package converts in fp32: its heights carry ~1 m of rounding, and a
longitude ulp at -122 degrees is 0.68 m, so the packages' different
``atan2`` put points near a cell edge in different cells); it accumulates
each cell's count and heights in float64 and rounds the mean to fp32 once
(the JAX package adds in fp32). The card's ``index_add_`` adds in atomic
order; float64 sums of these heights are exact to far below an fp32 ulp,
so the card and the CPU agree."""

from __future__ import annotations

import torch

from visionworkbench_torch.cartography.datum import Datum
from visionworkbench_torch.cartography.georeference import GeoReference
from visionworkbench_torch.core.device import on_device
from visionworkbench_torch.image.transform import _dest_grid


def dem_to_geodetic(dem, georef: GeoReference, device=None):
    """(H, W) DEM -> (H, W, 3) lon/lat/height (ref ``dem_to_geodetic``). A
    tensor keeps its device; an array goes to ``device`` (``None`` = the
    card)."""
    dem = on_device(dem, device, torch.float32)
    xs, ys = _dest_grid(*dem.shape, dem.device)
    lon, lat = georef.pixel_to_lonlat(xs, ys)
    return torch.stack([lon, lat, dem], -1)


def dem_to_point_image(dem, georef: GeoReference, device=None):
    """(H, W) DEM -> (H, W, 3) ECEF points (ref ``dem_to_point_image``)."""
    return geodetic_to_cartesian(dem_to_geodetic(dem, georef, device), georef.datum)


def geodetic_to_cartesian(llh_image, datum: Datum, device=None):
    return datum.geodetic_to_cartesian(on_device(llh_image, device, torch.float32))


def cartesian_to_geodetic(xyz_image, datum: Datum, device=None):
    return datum.cartesian_to_geodetic(on_device(xyz_image, device, torch.float32))


def point_image_to_dem(xyz_image, valid, georef: GeoReference, rows: int,
                       cols: int, device=None):
    """Splat an ECEF point cloud into a gridded DEM in ``georef``'s frame:
    mean height per output cell (a simple rasterizer standing in for the
    reference pipeline's point2dem, which lives in Ames Stereo Pipeline).
    A tensor keeps its device; an array goes to ``device`` (``None`` = the
    card)."""
    xyz = on_device(xyz_image, device, torch.float32).reshape(-1, 3)
    valid = on_device(valid, xyz.device).to(xyz.device).reshape(-1)
    llh = georef.datum.cartesian_to_geodetic(xyz.double())
    px, py = georef.lonlat_to_pixel(llh[..., 0].float(), llh[..., 1].float())
    xi = torch.round(px).to(torch.int64)
    yi = torch.round(py).to(torch.int64)
    inside = (xi >= 0) & (xi < cols) & (yi >= 0) & (yi < rows) & valid
    cell = torch.clamp(yi, 0, rows - 1) * cols + torch.clamp(xi, 0, cols - 1)
    zeros = torch.zeros(rows * cols, dtype=torch.float64, device=xyz.device)
    wsum = zeros.index_add(0, cell, inside.double())
    hsum = zeros.index_add(0, cell, torch.where(inside, llh[..., 2], 0.0))
    out_valid = (wsum > 0).reshape(rows, cols)
    dem = (hsum / torch.clamp(wsum, min=1.0)).float().reshape(rows, cols)
    return torch.where(out_valid, dem, 0.0), out_valid
