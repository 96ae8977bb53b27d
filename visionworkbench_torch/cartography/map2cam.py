"""Map-projected pixel <-> camera pixel transforms and orthoprojection
(port of ``visionworkbench_tpu/cartography/map2cam.py``; ref
``Map2CamTrans`` / ``Datum2CamTrans``,
``src/vw/Cartography/Map2CamTrans.h:48-120``, and ``OrthoImageView``,
``OrthoImageView.h:45-253``).

``reverse`` builds fp32 ECEF points and projects them with the camera's
``point_to_pixel`` (fp32 points minus the fp32 centre), as the JAX package
does; it runs on the device of the map coordinates given."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from visionworkbench_torch.camera.model import CameraModel
from visionworkbench_torch.cartography.georeference import GeoReference
from visionworkbench_torch.core.device import as_f32, on_device
from visionworkbench_torch.image.interpolation import interpolate
from visionworkbench_torch.image.transform import _dest_grid, sample


class Datum2CamTrans:
    """Map-projected pixel -> camera pixel assuming ground on the datum at a
    fixed height (ref ``Datum2CamTrans``, Map2CamTrans.h)."""

    def __init__(self, camera: CameraModel, image_georef: GeoReference,
                 height: float = 0.0):
        self.camera = camera
        self.georef = image_georef
        self.height = float(height)

    def ground_llh(self, x, y):
        """map pixel -> (..., 3) lon/lat/height of its ground point, on the
        datum at ``height``."""
        lon, lat = self.georef.pixel_to_lonlat(x, y)
        h = torch.full(lon.shape, self.height, dtype=torch.float32, device=lon.device)
        return torch.stack([lon, lat, h], -1)

    def ground_point(self, x, y):
        """map pixel -> fp32 ECEF ground point."""
        return self.georef.datum.geodetic_to_cartesian(self.ground_llh(x, y))

    def reverse(self, x, y):
        """map pixel -> camera pixel (the warping direction)."""
        pix = self.camera.point_to_pixel(self.ground_point(x, y))
        return pix[..., 0], pix[..., 1]


class Map2CamTrans(Datum2CamTrans):
    """Map-projected pixel -> camera pixel through a DEM
    (ref ``Map2CamTrans``, Map2CamTrans.h:48-120). The DEM (an array or a
    tensor) meets the map coordinates on their device."""

    def __init__(self, camera: CameraModel, image_georef: GeoReference,
                 dem, dem_georef: GeoReference,
                 dem_nodata: Optional[float] = None):
        super().__init__(camera, image_georef, 0.0)
        self.dem = as_f32(dem)
        self.dem_georef = dem_georef
        self.dem_nodata = dem_nodata

    def ground_llh(self, x, y):
        """map pixel -> lon/lat and the DEM's bilinear height (0 where it
        reads nodata)."""
        lon, lat = self.georef.pixel_to_lonlat(x, y)
        dpx, dpy = self.dem_georef.lonlat_to_pixel(lon, lat)
        h = interpolate(self.dem.to(lon.device), dpx, dpy, "bilinear")
        if self.dem_nodata is not None:
            h = torch.where(h == self.dem_nodata, 0.0, h)
        return torch.stack([lon, lat, h], -1)


def orthoproject(camera_image, camera: CameraModel, output_georef: GeoReference,
                 out_shape: Tuple[int, int], dem=None,
                 dem_georef: Optional[GeoReference] = None,
                 dem_nodata: Optional[float] = None, height: float = 0.0,
                 interp: str = "bilinear", device=None):
    """Render a camera image onto a map grid (ref ``OrthoImageView``): each
    output map pixel looks up its ground point (datum surface or DEM) and
    samples the camera image at that point's projection — one warp. A
    tensor image keeps its device; an array goes to ``device`` (``None`` =
    the card)."""
    image = on_device(camera_image, device)
    if dem is not None:
        tx = Map2CamTrans(camera, output_georef, dem,
                          dem_georef or output_georef, dem_nodata)
    else:
        tx = Datum2CamTrans(camera, output_georef, height)
    oh, ow = int(out_shape[0]), int(out_shape[1])
    xs, ys = _dest_grid(oh, ow, image.device)
    sx, sy = tx.reverse(xs, ys)
    return sample(image, sx, sy, interp=interp, edge="zero")
