"""Landsat water detection (port of ``visionworkbench_tpu/tools/flood/landsat.py``;
ref ``src/vw/tools/landsat.h``).

Pipeline: per-band GeoTIFFs + USGS MTL metadata text file -> top-of-atmosphere
reflectance (and brightness temperature for the thermal band) -> per-pixel
cloud score -> per-pixel water score -> threshold scaled by sun elevation.

The reference's per-pixel functor chain (``LandsatToaFunctor`` ->
``DetectWaterLandsatFunctor``) becomes whole-image fp32 tensor expressions
over an (H, W, 7) band stack on the stack's device; the MTL parser and the
band-file search are the JAX package's host code, copied. The JAX
package's jitted ``_classify`` is a plain function here, a launch an
operation. Quotients are IEEE's (``core/device.qdiv`` / ``rdiv``) and the
five-band mean and sample deviation sum in channel order, so the card and
the CPU round alike.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

from visionworkbench_torch.core.device import qdiv, rdiv, sqrt_rn
from .common import (as_image, as_valid, clamp01, compute_index, find_string_in_list,
                     parse_metadata_line, rescale_to_01, safe_ratio, water_classes)

# Channel layout of the 7-band working stack (landsat.h:61-68).
BLUE, GREEN, RED, NIR, SWIR1, TEMP, SWIR2 = range(7)
NUM_BANDS_OF_INTEREST = 7

# Source band indices (0-based) per sensor (landsat.h:71-74).
LS5_BAND_LOCATIONS = (0, 1, 2, 3, 4, 5, 6)
LS7_BAND_LOCATIONS = (0, 1, 2, 3, 4, 5, 7)
LS8_BAND_LOCATIONS = (1, 2, 3, 4, 5, 9, 6)


def band_locations(landsat_type: int):
    if landsat_type == 8:
        return LS8_BAND_LOCATIONS
    if landsat_type == 7:
        return LS7_BAND_LOCATIONS
    return LS5_BAND_LOCATIONS


def get_output_channel(input_channel: int, landsat_type: int) -> int:
    """Map a source band index to the working-stack channel, or -1
    (landsat.h:78-95)."""
    locs = band_locations(landsat_type)
    for i, loc in enumerate(locs):
        if loc == input_channel:
            return i
    return -1


@dataclasses.dataclass
class LandsatMetadataContainer:
    """TOA conversion constants from the MTL file (landsat.h:257-268)."""
    rad_mult: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(NUM_BANDS_OF_INTEREST, np.float32))
    rad_add: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(NUM_BANDS_OF_INTEREST, np.float32))
    toa_mult: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(NUM_BANDS_OF_INTEREST, np.float32))
    toa_add: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(NUM_BANDS_OF_INTEREST, np.float32))
    k_constants: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(4, np.float32))
    sun_elevation_degrees: float = 0.0


_BAND_RE = re.compile(r"_(\d+)\s*=")


def _band_number_from_line(line: str) -> int:
    """0-based band number from e.g. 'RADIANCE_MULT_BAND_3 = ...'
    (landsat.h:230-236)."""
    m = _BAND_RE.search(line)
    return int(m.group(1)) - 1 if m else -1


def parse_landsat_metadata(text: str,
                           landsat_type: int = 8) -> LandsatMetadataContainer:
    """Parse a USGS MTL metadata file's contents (landsat.h:272-326)."""
    md = LandsatMetadataContainer()

    def update_vector(line, prefix, vec):
        if prefix not in line:
            return False
        out = get_output_channel(_band_number_from_line(line), landsat_type)
        if out >= 0:
            vec[out] = parse_metadata_line(line)
        return True

    for line in text.splitlines():
        if "SUN_ELEVATION" in line:
            md.sun_elevation_degrees = parse_metadata_line(line)
            continue
        if update_vector(line, "RADIANCE_MULT_BAND_", md.rad_mult):
            continue
        if update_vector(line, "RADIANCE_ADD_BAND_", md.rad_add):
            continue
        if update_vector(line, "REFLECTANCE_MULT_BAND_", md.toa_mult):
            continue
        if update_vector(line, "REFLECTANCE_ADD_BAND_", md.toa_add):
            continue
        if "K1_CONSTANT_BAND_10" in line:
            md.k_constants[0] = parse_metadata_line(line)
        if "K1_CONSTANT_BAND_11" in line:
            md.k_constants[1] = parse_metadata_line(line)
        if "K2_CONSTANT_BAND_10" in line:
            md.k_constants[2] = parse_metadata_line(line)
        if "K2_CONSTANT_BAND_11" in line:
            md.k_constants[3] = parse_metadata_line(line)

    if md.sun_elevation_degrees == 0 or md.toa_mult[0] == 0:
        raise ValueError("Failed to read required Landsat metadata")

    # Fold the sun-elevation correction into the reflectance coefficients
    # (landsat.h:321-324).
    sin_el = np.sin(np.deg2rad(md.sun_elevation_degrees))
    md.toa_mult = (md.toa_mult / sin_el).astype(np.float32)
    md.toa_add = (md.toa_add / sin_el).astype(np.float32)
    return md


def load_landsat_metadata(image_files,
                          landsat_type: int = 8) -> LandsatMetadataContainer:
    """Locate and parse the MTL .txt file among ``image_files``
    (landsat.h:272-279)."""
    path = find_string_in_list(list(image_files), ".txt")
    if not path:
        raise ValueError("Landsat metadata file not found")
    with open(path) as f:
        return parse_landsat_metadata(f.read(), landsat_type)


def find_band_files(image_files, landsat_type: int = 8):
    """Locate the per-band GeoTIFF for each working channel by the USGS
    ``_B<n>.TIF`` suffix, zero-padded variant included (landsat.h:170-219).
    Returns 7 paths in working-channel order."""
    locs = band_locations(landsat_type)
    out = []
    for chan in range(NUM_BANDS_OF_INTEREST):
        num = locs[chan] + 1
        patterns = [f"_B{num}.TIF", f"_B{num}.tif"]
        if num < 10:
            patterns += [f"_B0{num}.TIF", f"_B0{num}.tif"]
        path = next((f for f in image_files
                     if any(p in f for p in patterns)), None)
        if path is None:
            raise ValueError(f"No input file contained landsat channel "
                             f"{chan + 1}")
        out.append(path)
    return out


def load_landsat_image(image_files, landsat_type: int = 8):
    """Stack the 7 per-band files into (H, W, 7) + validity mask
    (landsat.h:170-227; a pixel is invalid when all bands are zero). Host
    arrays, as the JAX package's (the DNs keep their dtype)."""
    from visionworkbench_torch.fileio import read_tiff
    paths = find_band_files(image_files, landsat_type)
    bands = []
    info0 = None
    for p in paths:
        arr, info = read_tiff(p)
        if info0 is None:
            info0 = info
        bands.append(np.asarray(arr)[..., 0] if np.asarray(arr).ndim == 3
                     else np.asarray(arr))
    stack = np.stack(bands, axis=-1)
    valid = (stack != 0).any(axis=-1)
    return stack, valid, info0


def convert_to_toa(stack, metadata: LandsatMetadataContainer, device=None):
    """DN stack (H, W, 7) -> TOA reflectance + brightness temperature
    (landsat.h:346-363). Thermal band uses the LS8 band-10 K constants. An
    array goes to ``device`` (``None`` = the card)."""
    x = as_image(stack, device)
    mult = torch.from_numpy(np.asarray(metadata.toa_mult, np.float32)).to(x.device)
    add = torch.from_numpy(np.asarray(metadata.toa_add, np.float32)).to(x.device)
    toa = x * mult + add
    temp_rad = (x[..., TEMP] * float(metadata.rad_mult[TEMP])
                + float(metadata.rad_add[TEMP]))
    k1 = float(metadata.k_constants[0])
    k2 = float(metadata.k_constants[2])
    toa[..., TEMP] = rdiv(k2, torch.log(rdiv(k1, temp_rad) + 1.0))
    return toa


def detect_clouds(toa):
    """Per-pixel cloud likelihood test (landsat.h:403-427): min of five
    brightness/temperature/snow scores > 0.35."""
    score = torch.clamp(rescale_to_01(toa[..., BLUE], 0.1, 0.3), max=1.0)
    vis = toa[..., RED] + toa[..., GREEN] + toa[..., BLUE]
    score = torch.minimum(score, rescale_to_01(vis, 0.2, 0.8))
    ir = toa[..., NIR] + toa[..., SWIR1] + toa[..., SWIR2]
    score = torch.minimum(score, rescale_to_01(ir, 0.3, 0.8))
    score = torch.minimum(score, rescale_to_01(toa[..., TEMP], 300.0, 290.0))
    ndsi = compute_index(toa[..., GREEN], toa[..., SWIR1])
    score = torch.minimum(score, rescale_to_01(ndsi, 0.8, 0.6))
    return score > 0.35


def compute_water_threshold(sun_angle_degrees: float) -> float:
    """Sun-elevation-scaled water score threshold (landsat.h:430-439)."""
    thresh = (0.6 / 54.0) * (62.0 - sun_angle_degrees)
    return max(thresh, 0.05)


def _mean_std5(bands):
    """Mean and sample (ddof=1) standard deviation over five planes, as
    ``jnp.mean`` / ``jnp.std(ddof=1)`` of a trailing axis: sums in channel
    order, IEEE quotients, a correctly rounded root."""
    total = bands[0]
    for b in bands[1:]:
        total = total + b
    mean = qdiv(total, 5.0)
    ss = None
    for b in bands:
        d = b - mean
        ss = d * d if ss is None else ss + d * d
    return mean, sqrt_rn(qdiv(ss, 4.0))


def detect_water_score(toa):
    """Per-pixel water score in [0, 1]; 0 under detected clouds
    (landsat.h:443-488). The score is the min of shadow-darkness, blue
    z-score, above-freezing temperature, and MNDWI terms."""
    shadow_sum = toa[..., NIR] + toa[..., SWIR1] + toa[..., SWIR2]
    score = clamp01(rescale_to_01(shadow_sum, 0.35, 0.2))

    # The reference uses the sample (ddof=1) standard deviation
    # (math::standard_deviation over 5 values).
    mean, std = _mean_std5([toa[..., GREEN], toa[..., RED], toa[..., NIR],
                            toa[..., SWIR2], toa[..., SWIR1]])
    z = clamp01(rescale_to_01((toa[..., BLUE] - std)
                              / torch.where(mean == 0, 1.0, mean), 0.0, 1.0))
    z = torch.where(mean == 0, 1.0, z)
    score = torch.minimum(score, z)

    score = torch.minimum(score, rescale_to_01(toa[..., TEMP], 273.0, 275.0))

    gs = toa[..., GREEN] + toa[..., SWIR1]
    mndwi = safe_ratio(toa[..., GREEN] - toa[..., SWIR1], gs, 0.0)
    score = clamp01(torch.minimum(score, rescale_to_01(mndwi, 0.3, 0.8)))

    return torch.where(detect_clouds(toa), 0.0, score)


def _classify(toa, valid, thresh):
    return water_classes(detect_water_score(toa) > thresh, valid)


def detect_water(stack, metadata: LandsatMetadataContainer, valid=None,
                 sensitivity: float = 1.0, device=None):
    """Classify a Landsat DN stack (H, W, 7) into water/land/nodata codes
    (landsat.h ``DetectWaterLandsatFunctor`` + ``detect_water`` driver,
    landsat.h:492-591): uint8 on the stack's device (an array goes to
    ``device``, ``None`` = the card)."""
    toa = convert_to_toa(stack, metadata, device)
    thresh = compute_water_threshold(metadata.sun_elevation_degrees)
    return _classify(toa, as_valid(valid, toa), float(np.float32(thresh * sensitivity)))
