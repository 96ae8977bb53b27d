"""WorldView-2/3 and SPOT 6/7 water detection (port of
``visionworkbench_tpu/tools/flood/multispectral.py``; ref
``src/vw/tools/multispectral.h``).

WorldView: IMD metadata -> radiance -> TOA reflectance (ESUN table +
earth-sun distance), then an NDVI/NDWI2 decision rule. SPOT: no TOA
available; ad-hoc NDVI/NDWI rule on raw DNs. The IMD parser is the JAX
package's host code, copied; the per-pixel work is fp32 tensor work on the
stack's device. The JAX package's two jitted classifiers are plain
functions here, a launch an operation.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .common import (as_image, as_valid, compute_index, compute_earth_sun_distance,
                     find_string_in_list, parse_metadata_line, safe_ratio,
                     water_classes)

NUM_SPOT67_BANDS = 5
NUM_WORLDVIEW_BANDS = 8

# Band-averaged solar spectral irradiance, "Radiometric Use of WorldView-2
# Imagery" (multispectral.h:48-58).
WORLDVIEW_ESUN = np.array([1758.2229, 1974.2416, 1856.4104, 1738.4791,
                           1559.4555, 1342.0695, 1069.7302, 861.2866],
                          np.float32)

# WorldView channel indices (multispectral.h:76-83).
COASTAL, BLUE, GREEN, YELLOW, RED, RED_EDGE, NIR1, NIR2 = range(8)

# SPOT 6/7 channel indices as found in HDDS files (multispectral.h:70-73).
SPOT_BLUE, SPOT_GREEN, SPOT_RED, SPOT_NIR = range(4)

_IMD_BAND_GROUPS = {"BAND_C": 0, "BAND_B": 1, "BAND_G": 2, "BAND_Y": 3,
                    "BAND_R": 4, "BAND_RE": 5, "BAND_N": 6, "BAND_N2": 7}


@dataclasses.dataclass
class WorldViewMetadataContainer:
    """TOA constants from the .IMD file (multispectral.h:148-171)."""
    abs_cal_factor: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(NUM_WORLDVIEW_BANDS, np.float32))
    effective_bandwidth: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(NUM_WORLDVIEW_BANDS, np.float32))
    mean_sun_elevation: float = 0.0
    datetime: str = ""
    earth_sun_distance: float = 0.0

    def populate_derived_values(self):
        """Parse '2016-10-23T17:46:54.796950Z;' → earth-sun distance in AU
        (multispectral.h:159-170)."""
        dt = self.datetime.strip()
        year, month, day = int(dt[0:4]), int(dt[5:7]), int(dt[8:10])
        hour, minute = int(dt[11:13]), int(dt[14:16])
        second = float(dt[17:25].rstrip("Z;"))
        self.earth_sun_distance = compute_earth_sun_distance(
            year, month, day, hour, minute, second)


def parse_worldview23_metadata(text: str) -> WorldViewMetadataContainer:
    """Parse WorldView .IMD metadata contents (multispectral.h:174-238)."""
    md = WorldViewMetadataContainer()
    channel_index = -1
    found = 0
    for line in text.splitlines():
        if "BEGIN_GROUP" in line:
            name = line.split("=", 1)[1].strip()
            channel_index = _IMD_BAND_GROUPS.get(name, -1)
            continue
        if "absCalFactor" in line:
            if channel_index < 0:
                raise ValueError("absCalFactor outside a band group")
            md.abs_cal_factor[channel_index] = parse_metadata_line(line)
            found += 1
            continue
        if "effectiveBandwidth" in line:
            if channel_index < 0:
                raise ValueError("effectiveBandwidth outside a band group")
            md.effective_bandwidth[channel_index] = parse_metadata_line(line)
            found += 1
            continue
        if "meanSunEl" in line:
            md.mean_sun_elevation = parse_metadata_line(line)
            found += 1
            continue
        if "firstLineTime" in line:
            md.datetime = line.split("=", 1)[1]
            found += 1
            continue
    if found != 2 * NUM_WORLDVIEW_BANDS + 2:
        raise ValueError("Failed to find all required WorldView metadata")
    md.populate_derived_values()
    return md


def load_worldview23_metadata(input_paths) -> WorldViewMetadataContainer:
    path = find_string_in_list(list(input_paths), ".IMD")
    if not path:
        raise ValueError("WorldView metadata (.IMD) file not found")
    with open(path) as f:
        return parse_worldview23_metadata(f.read())


def convert_to_toa(stack, metadata: WorldViewMetadataContainer, device=None):
    """DN stack (H, W, 8) -> TOA reflectance (multispectral.h:243-260). An
    array goes to ``device`` (``None`` = the card). The per-band factors are
    the JAX package's fp32 constants (the scale rounded to fp32, then
    divided by the ESUN table), made on the host."""
    x = as_image(stack, device)
    gain = torch.from_numpy((metadata.abs_cal_factor
                             / metadata.effective_bandwidth).astype(np.float32))
    scale = (metadata.earth_sun_distance ** 2 * np.pi
             / np.cos(np.deg2rad(90.0 - metadata.mean_sun_elevation)))
    factor = torch.from_numpy(np.float32(scale) / WORLDVIEW_ESUN)
    rad = x * gain.to(x.device)
    return rad * factor.to(x.device)


def compute_ndvi(toa):
    """NDVI (multispectral.h:275-277; note the reference's RED/NIR2 order)."""
    return compute_index(toa[..., RED], toa[..., NIR2])


def compute_ndwi(toa):
    return compute_index(toa[..., BLUE], toa[..., NIR1])


def compute_ndwi2(toa):
    return compute_index(toa[..., COASTAL], toa[..., NIR2])


def compute_sdi(toa):
    """Shadow detection index (multispectral.h:291-296)."""
    ratio = safe_ratio(toa[..., NIR2] - toa[..., BLUE], toa[..., NIR2] + toa[..., BLUE], 10.0)
    return ratio - toa[..., NIR1]


def _times(c: float, sensitivity: float) -> float:
    """``c * sensitivity`` as the JAX package's jitted classifiers compute
    it: an fp32 product of fp32 operands."""
    return float(np.float32(c) * np.float32(sensitivity))


def _classify_wv(toa, valid, sensitivity):
    ndvi = compute_ndvi(toa)
    ndwi2 = compute_ndwi2(toa)
    land = (ndvi < _times(0.1, sensitivity)) | (ndwi2 < _times(0.3, sensitivity))
    water = (ndvi > _times(0.5, sensitivity)) | (ndwi2 > _times(0.5, sensitivity))
    return water_classes(~land & water, valid)


def detect_water_worldview23(stack, metadata: WorldViewMetadataContainer,
                             valid=None, sensitivity: float = 1.0, device=None):
    """WorldView-2/3 water classification (multispectral.h:375-396: land
    rules are checked before water rules, so a pixel matching both is
    land). uint8 codes on the stack's device (an array goes to ``device``,
    ``None`` = the card)."""
    toa = convert_to_toa(stack, metadata, device)
    return _classify_wv(toa, as_valid(valid, toa), sensitivity)


def compute_ndvi_spot(stack, device=None):
    """NDVI, SPOT band order (multispectral.h:300-302)."""
    x = as_image(stack, device)
    return compute_index(x[..., SPOT_RED], x[..., SPOT_NIR])


def compute_ndwi_spot(stack, device=None):
    """NDWI, SPOT band order (multispectral.h:305-307)."""
    x = as_image(stack, device)
    return compute_index(x[..., SPOT_BLUE], x[..., SPOT_NIR])


def _classify_spot(stack, valid, sensitivity):
    ndvi = compute_ndvi_spot(stack)
    ndwi = compute_ndwi_spot(stack)
    water = ((ndwi > _times(0.3, sensitivity))
             | ((ndvi + ndwi) > _times(0.6, sensitivity)))
    return water_classes(water, valid)


def detect_water_spot67(stack, valid=None, sensitivity: float = 1.0, device=None):
    """SPOT 6/7 ad-hoc water rule on raw DNs (multispectral.h:399-416).
    uint8 codes on the stack's device (an array goes to ``device``,
    ``None`` = the card)."""
    stack = as_image(stack, device)
    return _classify_spot(stack, as_valid(valid, stack), sensitivity)
