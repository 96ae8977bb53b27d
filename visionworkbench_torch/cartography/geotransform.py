"""Image-to-image cartographic reprojection (port of
``visionworkbench_tpu/cartography/geotransform.py``; ref ``GeoTransform``,
``src/vw/Cartography/GeoTransform.h:43-132``, used with ``transform()``
for warping — call stack SURVEY.md section 3.5).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from visionworkbench_torch.cartography.georeference import GeoReference
from visionworkbench_torch.core.device import on_device
from visionworkbench_torch.image.transform import _dest_grid, sample
from visionworkbench_torch.math.bbox import BBox2, BBox2i


class GeoTransform:
    """Maps pixels between two georeferences: dst pixel -> (dst proj ->
    lonlat -> src proj) -> src pixel. ``reverse`` is the warping direction;
    it runs on the device of the points given (the reference goes through
    PROJ on the host per pixel)."""

    def __init__(self, src_georef: GeoReference, dst_georef: GeoReference):
        self.src = src_georef
        self.dst = dst_georef
        self.same_datum = src_georef.datum == dst_georef.datum

    def reverse(self, x, y):
        """dst pixel -> src pixel."""
        lon, lat = self.dst.pixel_to_lonlat(x, y)
        return self.src.lonlat_to_pixel(lon, lat)

    def forward(self, x, y):
        """src pixel -> dst pixel."""
        lon, lat = self.src.pixel_to_lonlat(x, y)
        return self.dst.lonlat_to_pixel(lon, lat)

    def forward_bbox(self, bbox: BBox2i, samples: int = 32) -> BBox2:
        xs = np.linspace(bbox.min_x, bbox.max_x, samples)
        ys = np.linspace(bbox.min_y, bbox.max_y, samples)
        bx = np.concatenate([xs, xs, np.full(samples, bbox.min_x),
                             np.full(samples, bbox.max_x)])
        by = np.concatenate([np.full(samples, bbox.min_y),
                             np.full(samples, bbox.max_y), ys, ys])
        fx, fy = self.forward(bx, by)
        fx, fy = np.asarray(fx), np.asarray(fy)
        ok = np.isfinite(fx) & np.isfinite(fy)
        return BBox2.from_bounds(fx[ok].min(), fy[ok].min(),
                                 fx[ok].max(), fy[ok].max())

    def reverse_bbox(self, bbox: BBox2i, samples: int = 32) -> BBox2:
        return GeoTransform(self.dst, self.src).forward_bbox(bbox, samples)


def reproject_image(src, src_georef: GeoReference, dst_georef: GeoReference,
                    out_shape: Tuple[int, int], interp: str = "bilinear",
                    edge: str = "zero", edge_value: float = 0.0, device=None):
    """Warp ``src`` into ``dst_georef``'s pixel grid (ref ``transform(src,
    GeoTransform(...))``, SURVEY.md section 3.5): the reverse map of every
    output pixel on the device, then :func:`sample`. Runs on ``src``'s
    device when it is a tensor, else on ``device`` (``None`` = the card)."""
    src = on_device(src, device)
    tx = GeoTransform(src_georef, dst_georef)
    xs, ys = _dest_grid(int(out_shape[0]), int(out_shape[1]), src.device)
    sx, sy = tx.reverse(xs, ys)
    return sample(src, sx, sy, interp=interp, edge=edge, edge_value=edge_value)
