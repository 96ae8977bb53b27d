"""Flood / water detection suite of the port (``visionworkbench_tpu/tools/
flood/``; ref ``src/vw/tools/flood_common.h``, ``landsat.h``, ``radar.h``,
``multispectral.h``, ``modis_utilities.h``, ``modis_water_detection.h``).

Layout mirrors the reference headers:

* :mod:`.common` -- shared constants + helpers (flood_common.h)
* :mod:`.landsat` -- Landsat 5/7/8 TOA + cloud/water scoring (landsat.h)
* :mod:`.radar` -- Sentinel-1 SAR Martinis algorithm (radar.h)
* :mod:`.multispectral` -- WorldView-2/3 + SPOT 6/7 detection (multispectral.h)
* :mod:`.modis` -- MODIS products + detection functors (modis_*.h)

All per-pixel functor chains from the reference are whole-image fp32
tensor expressions on the input's device (an array goes to ``device``,
``None`` = the card); per-tile statistics are reshape-reductions; the
metadata parsers, tile selection and histogram splits are host code.
"""

from .common import (FLOOD_DETECT_WATER, FLOOD_DETECT_LAND,
                     FLOOD_DETECT_NODATA, compute_index, rescale_to_01,
                     clamp01, compute_earth_sun_distance)
from . import landsat, radar, multispectral, modis

__all__ = [
    "FLOOD_DETECT_WATER", "FLOOD_DETECT_LAND", "FLOOD_DETECT_NODATA",
    "compute_index", "rescale_to_01", "clamp01",
    "compute_earth_sun_distance", "landsat", "radar", "multispectral",
    "modis",
]
