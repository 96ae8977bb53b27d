"""MODIS water detection (port of ``visionworkbench_tpu/tools/flood/modis.py``;
ref ``src/vw/tools/modis_utilities.h``, ``modis_water_detection.h``).

Products (NDVI/NDWI/EVI/LSWI) are computed once over the whole (H, W, 7)
surface-reflectance stack; each detection functor is a boolean tensor
expression, fp32 on the stack's device.
"""

from __future__ import annotations

import torch

from .common import as_image, safe_ratio

# Channel indices in the 7-band stack (modis_utilities.h:51-58).
B1, B2, B3, B4, B5, B6, B7 = range(7)
NUM_MODIS_BANDS = 7

# Product indices (modis_utilities.h:64).
NDVI, NDWI, EVI, LSWI = range(4)
NUM_MODIS_PRODUCTS = 4

# MODIS GeoTIFF channel names the reference loads (modis_utilities.h:91-97).
MODIS_CHANNEL_NAMES = ("sur_refl_b01_1", "sur_refl_b02_1", "sur_refl_b03_1",
                       "sur_refl_b04_1", "sur_refl_b05_1", "sur_refl_b06_1",
                       "sur_refl_b07_1")


def form_modis_products(stack, device=None):
    """(H, W, 7) reflectance stack -> (H, W, 4) NDVI/NDWI/EVI/LSWI products
    (modis_utilities.h:220-243). An array goes to ``device`` (``None`` = the
    card)."""
    x = as_image(stack, device)
    b1, b2, b3, b4, b6 = (x[..., B1], x[..., B2], x[..., B3], x[..., B4],
                          x[..., B6])
    ndvi = safe_ratio(b2 - b1, b2 + b1, 0.0)
    ndwi = safe_ratio(b1 - b6, b1 + b6, 0.0)
    evi = safe_ratio(2.5 * (b2 - b1), 6.0 * b1 + b2 - 7.5 * b3 + 1.0, 0.0)
    lswi = safe_ratio(b2 - b6, b2 + b6, 0.0)
    return torch.stack([ndvi, ndwi, evi, lswi], dim=-1)


def detect_water_evi(stack, products):
    """Simple EVI classifier (modis_water_detection.h:60-66)."""
    evi, lswi = products[..., EVI], products[..., LSWI]
    criteria1 = (evi <= 0.3) & (lswi - evi >= 0.05)
    criteria2 = (evi <= 0.05) & (lswi <= 0.0)
    return criteria1 | criteria2


def detect_water_xiao(stack, products):
    """Xiao et al. 2006 paddy-rice decision tree
    (modis_water_detection.h:74-78)."""
    ndvi, evi, lswi = (products[..., NDVI], products[..., EVI],
                       products[..., LSWI])
    return (lswi - ndvi >= 0.05) | (lswi - evi >= 0.05)


def detect_water_diff(stack, products, threshold):
    """b2 - b1 <= threshold (modis_water_detection.h:84-91)."""
    x = as_image(stack, products.device)
    return x[..., B2] - x[..., B1] <= threshold


def detect_water_dartmouth(stack, products, threshold):
    """Dartmouth Flood Observatory ratio (modis_water_detection.h:96-105)."""
    x = as_image(stack, products.device)
    return (x[..., B2] + 500.0) / (x[..., B1] + 2500.0) <= threshold


def detect_water_mod_ndwi(stack, products, threshold):
    """(b6-b4)/(b4+b6) <= threshold (modis_water_detection.h:108-116)."""
    x = as_image(stack, products.device)
    den = x[..., B4] + x[..., B6]
    val = safe_ratio(x[..., B6] - x[..., B4], den, 0.0)
    return (den != 0) & (val <= threshold)


def detect_water_fai(stack, products, threshold):
    """Floating Algae Index, Feng et al. 2012
    (modis_water_detection.h:121-129)."""
    x = as_image(stack, products.device)
    constant = (859.0 - 645.0) / (1240.0 - 645.0)
    fai = x[..., B2] - (x[..., B1] + constant * (x[..., B5] - x[..., B1]))
    return fai <= threshold


METHODS = {
    "evi": detect_water_evi,
    "xiao": detect_water_xiao,
    "diff": detect_water_diff,
    "dartmouth": detect_water_dartmouth,
    "mod_ndwi": detect_water_mod_ndwi,
    "fai": detect_water_fai,
}

# Methods requiring a hand-tuned threshold argument.
THRESHOLD_METHODS = ("diff", "dartmouth", "mod_ndwi", "fai")


def detect_water(stack, method: str = "evi", threshold: float = None, device=None):
    """Run a MODIS detection method over an (H, W, 7) stack; returns a bool
    water mask (modis_water_detection.h ``for_each_pixel`` driver), on the
    stack's device (an array goes to ``device``, ``None`` = the card)."""
    stack = as_image(stack, device)
    products = form_modis_products(stack)
    fn = METHODS[method]
    if method in THRESHOLD_METHODS:
        if threshold is None:
            raise ValueError(f"method {method!r} needs a threshold")
        return fn(stack, products, threshold)
    return fn(stack, products)
