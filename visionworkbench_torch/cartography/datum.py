"""Datums / reference ellipsoids (port of
``visionworkbench_tpu/cartography/datum.py``; ref
``src/vw/Cartography/Datum.cc``).

Geodetic <-> geocentric (ECEF) conversions run in fp32 torch on the device
of the points given (a tensor keeps its device; arrays go to the CPU).
Well-known datums match the reference's set.
"""

from __future__ import annotations

import math

import torch

from visionworkbench_torch.core.device import as_f32, rdiv
from visionworkbench_torch.core.exceptions import ArgumentErr

_D2R = math.pi / 180.0
_R2D = 180.0 / math.pi


class Datum:
    def __init__(self, name: str = "WGS_1984",
                 spheroid_name: str = "WGS 84",
                 meridian_name: str = "Greenwich",
                 semi_major_axis: float = 6378137.0,
                 semi_minor_axis: float = 6356752.314245,
                 meridian_offset: float = 0.0):
        self.name = name
        self.spheroid_name = spheroid_name
        self.meridian_name = meridian_name
        self.a = float(semi_major_axis)
        self.b = float(semi_minor_axis)
        self.meridian_offset = float(meridian_offset)

    # --- derived quantities -------------------------------------------------
    @property
    def flattening(self) -> float:
        return (self.a - self.b) / self.a

    @property
    def e2(self) -> float:
        """First eccentricity squared."""
        return 1.0 - (self.b * self.b) / (self.a * self.a)

    def inverse_flattening(self) -> float:
        f = self.flattening
        return math.inf if f == 0 else 1.0 / f

    def radius(self, lon, lat):
        """Ellipsoid radius at geodetic latitude (ref ``Datum::radius``)."""
        lat = as_f32(lat) * _D2R
        cl, sl = torch.cos(lat), torch.sin(lat)
        a2, b2 = self.a ** 2, self.b ** 2
        return torch.sqrt((a2 * a2 * cl * cl + b2 * b2 * sl * sl) /
                          (a2 * cl * cl + b2 * sl * sl))

    # --- conversions --------------------------------------------------------
    def geodetic_to_cartesian(self, llh):
        """(..., 3) (lon deg, lat deg, height m) -> ECEF (..., 3)
        (ref ``Datum::geodetic_to_cartesian``)."""
        llh = as_f32(llh)
        lon = (llh[..., 0] + self.meridian_offset) * _D2R
        lat = llh[..., 1] * _D2R
        h = llh[..., 2]
        sl, cl = torch.sin(lat), torch.cos(lat)
        n = rdiv(self.a, torch.sqrt(1 - self.e2 * sl * sl))
        x = (n + h) * cl * torch.cos(lon)
        y = (n + h) * cl * torch.sin(lon)
        z = (n * (1 - self.e2) + h) * sl
        return torch.stack([x, y, z], -1)

    def cartesian_to_geodetic(self, xyz, iterations: int = 10):
        """ECEF -> (lon deg, lat deg, height m) via Bowring iteration
        (ref ``Datum::cartesian_to_geodetic``); in fp32, or in float64 for a
        float64 tensor."""
        if not (isinstance(xyz, torch.Tensor) and xyz.dtype == torch.float64):
            xyz = as_f32(xyz)
        x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
        lon = torch.atan2(y, x) * _R2D - self.meridian_offset
        p = torch.sqrt(x * x + y * y)
        lat = torch.atan2(z, p * (1 - self.e2))
        for _ in range(iterations):
            sl = torch.sin(lat)
            n = rdiv(self.a, torch.sqrt(1 - self.e2 * sl * sl))
            h = p / torch.cos(lat) - n
            lat = torch.atan2(z, p * (1 - self.e2 * n / (n + h)))
        sl = torch.sin(lat)
        n = rdiv(self.a, torch.sqrt(1 - self.e2 * sl * sl))
        h = p / torch.cos(lat) - n
        return torch.stack([lon, lat * _R2D, h], -1)

    def __eq__(self, other):
        return (isinstance(other, Datum) and abs(self.a - other.a) < 1e-6 and
                abs(self.b - other.b) < 1e-6 and
                abs(self.meridian_offset - other.meridian_offset) < 1e-12)

    def __repr__(self):
        return f"Datum({self.name!r}, a={self.a}, b={self.b})"


_WELL_KNOWN = {
    "WGS84": ("WGS_1984", "WGS 84", 6378137.0, 6356752.314245),
    "WGS72": ("WGS_1972", "WGS 72", 6378135.0, 6356750.52),
    "NAD83": ("North_American_Datum_1983", "GRS 1980", 6378137.0, 6356752.314140),
    "NAD27": ("North_American_Datum_1927", "Clarke 1866", 6378206.4, 6356583.8),
    "D_MOON": ("D_MOON", "MOON", 1737400.0, 1737400.0),
    "D_MARS": ("D_MARS", "MARS", 3396190.0, 3376200.0),
    "MOLA": ("D_MARS_MOLA", "MOLA", 3396000.0, 3396000.0),
}


def well_known_datum(name: str) -> Datum:
    """(ref ``Datum::set_well_known_datum``)"""
    key = name.upper().replace(" ", "")
    if key not in _WELL_KNOWN:
        raise ArgumentErr(f"unknown datum {name!r}; one of {sorted(_WELL_KNOWN)}")
    dname, sph, a, b = _WELL_KNOWN[key]
    return Datum(dname, sph, "Greenwich", a, b)
