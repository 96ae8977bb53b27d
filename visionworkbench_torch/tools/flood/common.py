"""Shared flood-detection helpers (port of
``visionworkbench_tpu/tools/flood/common.py``; ref
``src/vw/tools/flood_common.h``).

Output class codes, band-index math, and the WorldView earth-sun distance
formula. The scalar helpers of the reference are broadcastable tensor
functions (fp32, on the input's device), so whole band stacks run through
them at once; the metadata helpers are host code, copied. Every quotient
is IEEE's (``core/device.qdiv``), so the card and the CPU round alike.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from visionworkbench_torch.core.device import on_device, qdiv, resolve_device

# Output classification codes (flood_common.h:40-42).
FLOOD_DETECT_WATER = 255
FLOOD_DETECT_LAND = 1
FLOOD_DETECT_NODATA = 0


def as_plane(x, device=None) -> torch.Tensor:
    """``x`` as a float tensor that holds every value exactly: fp32, or
    float64 where fp32 cannot hold every value of the array's dtype (as the
    JAX package's NumPy compares and selects them). A tensor keeps its
    device and dtype; an array (uint16 DNs included) is sent to ``device``
    (``None`` = the card) as it is and converted there."""
    if isinstance(x, torch.Tensor):
        return x
    x = np.ascontiguousarray(x)
    dtype = torch.float32 if np.can_cast(x.dtype, np.float32) else torch.float64
    return torch.from_numpy(x).to(resolve_device(device)).to(dtype)


def as_image(x, device=None) -> torch.Tensor:
    """``x`` as an fp32 tensor (:func:`as_plane`, rounded to fp32)."""
    return as_plane(x, device).float()


def as_valid(valid, like: torch.Tensor) -> torch.Tensor:
    """``valid`` as a bool tensor on ``like``'s device; all True when None."""
    if valid is None:
        return torch.ones(like.shape[:2], dtype=torch.bool, device=like.device)
    return on_device(valid, like.device).to(like.device, torch.bool)


def water_classes(water: torch.Tensor, valid=None) -> torch.Tensor:
    """uint8 FLOOD_DETECT_* codes of a water mask, NODATA outside ``valid``."""
    out = torch.where(water, FLOOD_DETECT_WATER, FLOOD_DETECT_LAND).to(torch.uint8)
    if valid is not None:
        out = torch.where(valid, out, FLOOD_DETECT_NODATA).to(torch.uint8)
    return out


def safe_ratio(num: torch.Tensor, den: torch.Tensor, fill: float) -> torch.Tensor:
    """``num / den``, ``fill`` where ``den`` is 0 (the reference's
    divide-by-zero guards)."""
    zero = den == 0
    return torch.where(zero, fill, num / torch.where(zero, 1.0, den))


def compute_index(a, b, device=None):
    """Normalized difference index (a-b)/(a+b); 100 where the denominator is
    zero (flood_common.h ``compute_index`` divide-by-zero guard)."""
    a = on_device(a, device, torch.float32)
    b = on_device(b, a.device, torch.float32).to(a.device)
    return safe_ratio(a - b, a + b, 100.0)


def clamp01(value, device=None):
    return torch.clamp(on_device(value, device, torch.float32), 0.0, 1.0)


def rescale_to_01(value, lo, hi, device=None):
    """Linear rescale of [lo, hi] onto [0, 1]; NOT clamped (the reference's
    ``rescale_to_01`` leaves out-of-range values outside [0,1], and callers
    rely on that inside min() chains)."""
    return qdiv(on_device(value, device, torch.float32) - lo, hi - lo)


def find_string_in_list(strings, substring):
    """First string containing ``substring`` or '' (flood_common.h)."""
    for s in strings:
        if substring in s:
            return s
    return ""


def parse_metadata_line(line: str) -> float:
    """Extract the numeric value after '=' (flood_common.h)."""
    return float(line.split("=", 1)[1].strip().rstrip(";"))


def compute_earth_sun_distance(year: int, month: int, day: int, hour: int,
                               minute: int, second: float) -> float:
    """Earth-sun distance in AU at a given UTC time (flood_common.h:103-121,
    from "Radiometric Use of WorldView-2 Imagery"). Note the reference
    evaluates cos() on *degrees* values g and 2g -- replicated verbatim for
    parity (the constants were calibrated with that convention)."""
    ut = hour + minute / 60.0 + second / 3600.0
    if month in (1, 2):
        year -= 1
        month += 12
    a = int(year / 100.0)
    b = 2 - a + a // 4
    julian_day = (math.floor(365.25 * (year + 4716))
                  + math.floor(30.6001 * (month + 1))
                  + day + ut / 24.0 + b - 1524.5)
    d = julian_day - 2451545.0
    g = 357.529 + 0.98560028 * d
    return 1.00014 - 0.01671 * math.cos(g) - 0.00014 * math.cos(2 * g)
