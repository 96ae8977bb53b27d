"""DEM hillshading (port of ``visionworkbench_tpu/cartography/hillshade.py``;
ref ``src/vw/Cartography/Hillshade.cc:30`` and ``tools/hillshade.cc``):
Lambertian shading of the DEM normal field against a sun direction given by
azimuth/elevation, on the port's derivative stencils."""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from visionworkbench_torch.core.device import on_device, qdiv, sqrt_rn
from visionworkbench_torch.image.filters import derivative_filter
from visionworkbench_torch.image.types import MaskedImage


def hillshade(dem, azimuth: float = 300.0, elevation: float = 20.0,
              scale: float = 1.0, nodata: Optional[float] = None, device=None):
    """Shaded relief in [0, 1]; ``scale`` is ground units per pixel (ref
    ``do_hillshade``: light vector from az/el, normals from Sobel-style
    derivatives divided by the pixel scale). A tensor keeps its device; an
    array goes to ``device`` (``None`` = the card)."""
    dem = on_device(dem, device, torch.float32)
    az = math.radians(azimuth)
    el = math.radians(elevation)
    lx, ly, lz = (float(v) for v in np.float32([math.sin(az) * math.cos(el),
                                                 -math.cos(az) * math.cos(el),
                                                 math.sin(el)]))
    dx = qdiv(derivative_filter(dem, 1, 0), scale)
    dy = qdiv(derivative_filter(dem, 0, 1), scale)
    # Surface normal (un-normalized): (-dz/dx, -dz/dy, 1)
    norm = sqrt_rn(dx * dx + dy * dy + 1.0)
    shaded = (-dx * lx - dy * ly + lz) / norm
    shaded = torch.clamp(shaded, 0.0, 1.0)
    if nodata is not None:
        valid = dem != nodata
        return MaskedImage(torch.where(valid, shaded, 0.0), valid)
    return shaded
