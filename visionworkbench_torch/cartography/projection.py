"""Map projections (port of ``visionworkbench_tpu/cartography/projection.py``;
the role of PROJ in the reference's ``GeoReference``,
``src/vw/Cartography/GeoReference.cc``; Snyder, "Map Projections: A
Working Manual").

All projections map (lon deg, lat deg) <-> (x m, y m) in fp32 torch,
vectorized, in the JAX package's order of operations, on the device of the
coordinates given (a tensor keeps its device; arrays go to the CPU, where
reprojection grids are planned). Ellipsoidal series are used where
Snyder's standard treatment requires them (UTM, Lambert Conformal);
spherical forms elsewhere match the reference's PROJ setup for those modes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from visionworkbench_torch.core.device import as_f32, rdiv, scalar
from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.cartography.datum import Datum

_D2R = math.pi / 180.0
_R2D = 180.0 / math.pi


def _pair(a, b):
    """Two coordinate arrays as fp32 tensors on the first one's device."""
    a = as_f32(a)
    return a, as_f32(b, like=a).to(a.device)


class Projection:
    """Base: identity 'geographic' projection in degrees
    (ref ``GeoReference::set_geographic``)."""
    name = "geographic"
    proj4_name = "longlat"

    def __init__(self, datum: Datum):
        self.datum = datum

    def forward(self, lon, lat):
        return _pair(lon, lat)

    def reverse(self, x, y):
        return _pair(x, y)

    def params(self) -> dict:
        return {}


class SinusoidalProjection(Projection):
    """(ref ``set_sinusoidal``)"""
    name = "sinusoidal"
    proj4_name = "sinu"

    def __init__(self, datum: Datum, center_longitude=0.0,
                 false_easting=0.0, false_northing=0.0):
        super().__init__(datum)
        self.lon0 = float(center_longitude)
        self.x0 = float(false_easting)
        self.y0 = float(false_northing)

    def forward(self, lon, lat):
        r = self.datum.a
        lon, lat = _pair(lon, lat)
        x = r * _D2R * (lon - self.lon0) * torch.cos(lat * _D2R) + self.x0
        y = r * _D2R * lat + self.y0
        return x, y

    def reverse(self, x, y):
        r = self.datum.a
        x, y = _pair(x, y)
        lat = (y - self.y0) / (r * _D2R)
        cos_lat = torch.cos(lat * _D2R)
        lon = (x - self.x0) / (r * _D2R * torch.clamp(cos_lat, min=1e-12)) + self.lon0
        return lon, lat

    def params(self):
        return {"center_longitude": self.lon0, "false_easting": self.x0,
                "false_northing": self.y0}


class MercatorProjection(Projection):
    """Spherical Mercator (ref ``set_mercator``)."""
    name = "mercator"
    proj4_name = "merc"

    def __init__(self, datum: Datum, center_longitude=0.0, center_latitude=0.0,
                 scale=1.0, false_easting=0.0, false_northing=0.0):
        super().__init__(datum)
        self.lon0 = float(center_longitude)
        self.k0 = float(scale)
        self.x0 = float(false_easting)
        self.y0 = float(false_northing)

    def forward(self, lon, lat):
        r = self.datum.a * self.k0
        lon, lat = _pair(lon, lat)
        lat = torch.clamp(lat, -89.9, 89.9)
        x = r * _D2R * (lon - self.lon0) + self.x0
        y = r * torch.log(torch.tan(math.pi / 4 + lat * _D2R / 2)) + self.y0
        return x, y

    def reverse(self, x, y):
        r = self.datum.a * self.k0
        x, y = _pair(x, y)
        lon = (x - self.x0) / (r * _D2R) + self.lon0
        lat = (2 * torch.atan(torch.exp((y - self.y0) / r)) - math.pi / 2) * _R2D
        return lon, lat

    def params(self):
        return {"center_longitude": self.lon0, "scale": self.k0,
                "false_easting": self.x0, "false_northing": self.y0}


class TransverseMercatorProjection(Projection):
    """Ellipsoidal transverse Mercator, Snyder eq. 8-9..8-17 — the basis of
    UTM (ref ``set_UTM`` / ``set_transverse_mercator``)."""
    name = "transverse mercator"
    proj4_name = "tmerc"

    def __init__(self, datum: Datum, center_longitude=0.0, center_latitude=0.0,
                 scale=0.9996, false_easting=500000.0, false_northing=0.0):
        super().__init__(datum)
        self.lon0 = float(center_longitude)
        self.lat0 = float(center_latitude)
        self.k0 = float(scale)
        self.x0 = float(false_easting)
        self.y0 = float(false_northing)

    def _m(self, lat_rad):
        e2 = self.datum.e2
        e4, e6 = e2 * e2, e2 * e2 * e2
        return self.datum.a * (
            (1 - e2 / 4 - 3 * e4 / 64 - 5 * e6 / 256) * lat_rad
            - (3 * e2 / 8 + 3 * e4 / 32 + 45 * e6 / 1024) * torch.sin(2 * lat_rad)
            + (15 * e4 / 256 + 45 * e6 / 1024) * torch.sin(4 * lat_rad)
            - (35 * e6 / 3072) * torch.sin(6 * lat_rad))

    def forward(self, lon, lat):
        a, e2, k0 = self.datum.a, self.datum.e2, self.k0
        ep2 = e2 / (1 - e2)
        lon, lat = _pair(lon, lat)
        phi = lat * _D2R
        lam = (lon - self.lon0) * _D2R
        sp, cp = torch.sin(phi), torch.cos(phi)
        n = rdiv(a, torch.sqrt(1 - e2 * sp * sp))
        t = torch.tan(phi) ** 2
        c = ep2 * cp * cp
        aa = lam * cp
        m = self._m(phi)
        m0 = self._m(scalar(self.lat0, phi) * _D2R)
        x = k0 * n * (aa + (1 - t + c) * aa ** 3 / 6 +
                      (5 - 18 * t + t * t + 72 * c - 58 * ep2) * aa ** 5 / 120) \
            + self.x0
        y = k0 * (m - m0 + n * torch.tan(phi) * (
            aa ** 2 / 2 + (5 - t + 9 * c + 4 * c * c) * aa ** 4 / 24 +
            (61 - 58 * t + t * t + 600 * c - 330 * ep2) * aa ** 6 / 720)) \
            + self.y0
        return x, y

    def reverse(self, x, y):
        a, e2, k0 = self.datum.a, self.datum.e2, self.k0
        ep2 = e2 / (1 - e2)
        e1 = (1 - math.sqrt(1 - e2)) / (1 + math.sqrt(1 - e2))
        x, y = _pair(x, y)
        m0 = self._m(scalar(self.lat0, x) * _D2R)
        m = m0 + (y - self.y0) / k0
        mu = m / (a * (1 - e2 / 4 - 3 * e2 * e2 / 64 - 5 * e2 ** 3 / 256))
        phi1 = (mu + (3 * e1 / 2 - 27 * e1 ** 3 / 32) * torch.sin(2 * mu)
                + (21 * e1 ** 2 / 16 - 55 * e1 ** 4 / 32) * torch.sin(4 * mu)
                + (151 * e1 ** 3 / 96) * torch.sin(6 * mu)
                + (1097 * e1 ** 4 / 512) * torch.sin(8 * mu))
        sp, cp = torch.sin(phi1), torch.cos(phi1)
        c1 = ep2 * cp * cp
        t1 = torch.tan(phi1) ** 2
        n1 = rdiv(a, torch.sqrt(1 - e2 * sp * sp))
        r1 = rdiv(a * (1 - e2), (1 - e2 * sp * sp) ** 1.5)
        d = (x - self.x0) / (n1 * k0)
        lat = (phi1 - (n1 * torch.tan(phi1) / r1) * (
            d * d / 2 - (5 + 3 * t1 + 10 * c1 - 4 * c1 * c1 - 9 * ep2) * d ** 4 / 24
            + (61 + 90 * t1 + 298 * c1 + 45 * t1 * t1 - 252 * ep2
               - 3 * c1 * c1) * d ** 6 / 720)) * _R2D
        lon = self.lon0 + (
            (d - (1 + 2 * t1 + c1) * d ** 3 / 6 +
             (5 - 2 * c1 + 28 * t1 - 3 * c1 * c1 + 8 * ep2 + 24 * t1 * t1)
             * d ** 5 / 120) / cp) * _R2D
        return lon, lat

    def params(self):
        return {"center_longitude": self.lon0, "center_latitude": self.lat0,
                "scale": self.k0, "false_easting": self.x0,
                "false_northing": self.y0}


class UTMProjection(TransverseMercatorProjection):
    """(ref ``GeoReference::set_UTM``: zone/hemisphere -> tmerc params)"""
    name = "utm"
    proj4_name = "utm"

    def __init__(self, datum: Datum, zone: int, north: bool = True):
        if not 1 <= zone <= 60:
            raise ArgumentErr(f"UTM zone must be 1..60, got {zone}")
        lon0 = -183.0 + 6.0 * zone
        super().__init__(datum, lon0, 0.0, 0.9996, 500000.0,
                         0.0 if north else 10000000.0)
        self.zone = zone
        self.north = north

    def params(self):
        return {"zone": self.zone, "north": self.north}


def _azimuthal_reverse(xx, yy, rho, c, phi0: float, lat0: float, lon0: float,
                       eps: float):
    """(lon, lat) of the spherical azimuthal families' inverse, given the
    plane point (xx, yy), its radius rho and the angular distance c."""
    sc, cc = torch.sin(c), torch.cos(c)
    safe_rho = torch.clamp(rho, min=1e-12)
    lat = torch.asin(torch.clamp(
        cc * math.sin(phi0) + yy * sc * math.cos(phi0) / safe_rho, -1, 1)) * _R2D
    lon = lon0 + torch.atan2(
        xx * sc, safe_rho * math.cos(phi0) * cc - yy * math.sin(phi0) * sc) * _R2D
    lat = torch.where(rho < eps, lat0, lat)
    lon = torch.where(rho < eps, lon0, lon)
    return lon, lat


class StereographicProjection(Projection):
    """Spherical (oblique/polar) stereographic (ref ``set_stereographic``)."""
    name = "stereographic"
    proj4_name = "stere"

    def __init__(self, datum: Datum, center_latitude=90.0, center_longitude=0.0,
                 scale=1.0, false_easting=0.0, false_northing=0.0):
        super().__init__(datum)
        self.lat0 = float(center_latitude)
        self.lon0 = float(center_longitude)
        self.k0 = float(scale)
        self.x0 = float(false_easting)
        self.y0 = float(false_northing)

    def forward(self, lon, lat):
        r = self.datum.a * self.k0
        lon, lat = _pair(lon, lat)
        phi = lat * _D2R
        lam = (lon - self.lon0) * _D2R
        phi0 = math.radians(self.lat0)
        den = 1 + math.sin(phi0) * torch.sin(phi) + \
            math.cos(phi0) * torch.cos(phi) * torch.cos(lam)
        k = rdiv(2 * r, torch.clamp(den, min=1e-12))
        x = k * torch.cos(phi) * torch.sin(lam) + self.x0
        y = k * (math.cos(phi0) * torch.sin(phi) -
                 math.sin(phi0) * torch.cos(phi) * torch.cos(lam)) + self.y0
        return x, y

    def reverse(self, x, y):
        r = self.datum.a * self.k0
        x, y = _pair(x, y)
        xx = x - self.x0
        yy = y - self.y0
        rho = torch.sqrt(xx * xx + yy * yy)
        c = 2 * torch.atan2(rho, torch.full_like(rho, 2 * r))
        return _azimuthal_reverse(xx, yy, rho, c, math.radians(self.lat0),
                                  self.lat0, self.lon0, 1e-9)

    def params(self):
        return {"center_latitude": self.lat0, "center_longitude": self.lon0,
                "scale": self.k0, "false_easting": self.x0,
                "false_northing": self.y0}


class OrthographicProjection(Projection):
    """Spherical orthographic (ref ``set_orthographic``)."""
    name = "orthographic"
    proj4_name = "ortho"

    def __init__(self, datum: Datum, center_latitude=0.0, center_longitude=0.0,
                 false_easting=0.0, false_northing=0.0):
        super().__init__(datum)
        self.lat0 = float(center_latitude)
        self.lon0 = float(center_longitude)
        self.x0 = float(false_easting)
        self.y0 = float(false_northing)

    def forward(self, lon, lat):
        r = self.datum.a
        lon, lat = _pair(lon, lat)
        phi = lat * _D2R
        lam = (lon - self.lon0) * _D2R
        phi0 = math.radians(self.lat0)
        x = r * torch.cos(phi) * torch.sin(lam) + self.x0
        y = r * (math.cos(phi0) * torch.sin(phi) -
                 math.sin(phi0) * torch.cos(phi) * torch.cos(lam)) + self.y0
        return x, y

    def reverse(self, x, y):
        r = self.datum.a
        x, y = _pair(x, y)
        xx = (x - self.x0) / r
        yy = (y - self.y0) / r
        rho = torch.sqrt(xx * xx + yy * yy)
        c = torch.asin(torch.clamp(rho, 0, 1))
        return _azimuthal_reverse(xx, yy, rho, c, math.radians(self.lat0),
                                  self.lat0, self.lon0, 1e-9)

    def params(self):
        return {"center_latitude": self.lat0, "center_longitude": self.lon0,
                "false_easting": self.x0, "false_northing": self.y0}


class LambertAzimuthalProjection(Projection):
    """Spherical Lambert azimuthal equal-area (ref ``set_lambert_azimuthal``)."""
    name = "lambert azimuthal"
    proj4_name = "laea"

    def __init__(self, datum: Datum, center_latitude=0.0, center_longitude=0.0,
                 false_easting=0.0, false_northing=0.0):
        super().__init__(datum)
        self.lat0 = float(center_latitude)
        self.lon0 = float(center_longitude)
        self.x0 = float(false_easting)
        self.y0 = float(false_northing)

    def forward(self, lon, lat):
        r = self.datum.a
        lon, lat = _pair(lon, lat)
        phi = lat * _D2R
        lam = (lon - self.lon0) * _D2R
        phi0 = math.radians(self.lat0)
        den = 1 + math.sin(phi0) * torch.sin(phi) + \
            math.cos(phi0) * torch.cos(phi) * torch.cos(lam)
        kp = torch.sqrt(rdiv(2.0, torch.clamp(den, min=1e-12)))
        x = r * kp * torch.cos(phi) * torch.sin(lam) + self.x0
        y = r * kp * (math.cos(phi0) * torch.sin(phi) -
                      math.sin(phi0) * torch.cos(phi) * torch.cos(lam)) + self.y0
        return x, y

    def reverse(self, x, y):
        r = self.datum.a
        x, y = _pair(x, y)
        xx = (x - self.x0) / r
        yy = (y - self.y0) / r
        rho = torch.sqrt(xx * xx + yy * yy)
        c = 2 * torch.asin(torch.clamp(rho / 2, -1, 1))
        return _azimuthal_reverse(xx, yy, rho, c, math.radians(self.lat0),
                                  self.lat0, self.lon0, 1e-9)

    def params(self):
        return {"center_latitude": self.lat0, "center_longitude": self.lon0,
                "false_easting": self.x0, "false_northing": self.y0}


class LambertConformalProjection(Projection):
    """Spherical Lambert conformal conic, 2 standard parallels
    (ref ``set_lambert_conformal``)."""
    name = "lambert conformal conic"
    proj4_name = "lcc"

    def __init__(self, datum: Datum, std_parallel_1=33.0, std_parallel_2=45.0,
                 center_latitude=0.0, center_longitude=0.0,
                 false_easting=0.0, false_northing=0.0):
        super().__init__(datum)
        self.sp1, self.sp2 = float(std_parallel_1), float(std_parallel_2)
        self.lat0, self.lon0 = float(center_latitude), float(center_longitude)
        self.x0, self.y0 = float(false_easting), float(false_northing)
        p1, p2 = math.radians(self.sp1), math.radians(self.sp2)
        if abs(p1 - p2) < 1e-12:
            self.n = math.sin(p1)
        else:
            self.n = (math.log(math.cos(p1) / math.cos(p2)) /
                      math.log(math.tan(math.pi / 4 + p2 / 2) /
                               math.tan(math.pi / 4 + p1 / 2)))
        self.f = (math.cos(p1) * math.tan(math.pi / 4 + p1 / 2) ** self.n) / self.n
        self.rho0 = (self.datum.a * self.f /
                     math.tan(math.pi / 4 + math.radians(self.lat0) / 2) ** self.n)

    def forward(self, lon, lat):
        a = self.datum.a
        lon, lat = _pair(lon, lat)
        phi = torch.clamp(lat, -89.9, 89.9) * _D2R
        lam = (lon - self.lon0) * _D2R
        rho = rdiv(a * self.f, torch.tan(math.pi / 4 + phi / 2) ** self.n)
        theta = self.n * lam
        x = rho * torch.sin(theta) + self.x0
        y = self.rho0 - rho * torch.cos(theta) + self.y0
        return x, y

    def reverse(self, x, y):
        a = self.datum.a
        x, y = _pair(x, y)
        xx = x - self.x0
        yy = self.rho0 - (y - self.y0)
        sign = 1.0 if self.n >= 0 else -1.0
        rho = sign * torch.sqrt(xx * xx + yy * yy)
        theta = torch.atan2(sign * xx, sign * yy)
        lat = (2 * torch.atan(rdiv(a * self.f, rho) ** (1.0 / self.n))
               - math.pi / 2) * _R2D
        lon = self.lon0 + (theta / self.n) * _R2D
        return lon, lat

    def params(self):
        return {"std_parallel_1": self.sp1, "std_parallel_2": self.sp2,
                "center_latitude": self.lat0, "center_longitude": self.lon0,
                "false_easting": self.x0, "false_northing": self.y0}


class EquirectangularProjection(Projection):
    """Spherical equirectangular / plate carree with a latitude of true
    scale (ref ``set_equirectangular``, Snyder eq. 12-1..12-6)."""
    name = "equirectangular"
    proj4_name = "eqc"

    def __init__(self, datum: Datum, center_latitude=0.0, center_longitude=0.0,
                 latitude_of_true_scale=0.0, false_easting=0.0,
                 false_northing=0.0):
        super().__init__(datum)
        self.lat0 = float(center_latitude)
        self.lon0 = float(center_longitude)
        self.lat_ts = float(latitude_of_true_scale)
        self.x0 = float(false_easting)
        self.y0 = float(false_northing)

    def forward(self, lon, lat):
        r = self.datum.a
        cos_ts = math.cos(math.radians(self.lat_ts))
        lon, lat = _pair(lon, lat)
        x = r * _D2R * (lon - self.lon0) * cos_ts + self.x0
        y = r * _D2R * (lat - self.lat0) + self.y0
        return x, y

    def reverse(self, x, y):
        r = self.datum.a
        cos_ts = math.cos(math.radians(self.lat_ts))
        x, y = _pair(x, y)
        lon = (x - self.x0) / (r * _D2R * cos_ts) + self.lon0
        lat = (y - self.y0) / (r * _D2R) + self.lat0
        return lon, lat

    def params(self):
        return {"center_latitude": self.lat0, "center_longitude": self.lon0,
                "latitude_of_true_scale": self.lat_ts,
                "false_easting": self.x0, "false_northing": self.y0}


class GnomonicProjection(Projection):
    """Spherical gnomonic: project from the sphere's center onto a tangent
    plane (ref ``set_gnomonic``, Snyder eq. 22-3..22-15); great circles map
    to straight lines."""
    name = "gnomonic"
    proj4_name = "gnom"

    def __init__(self, datum: Datum, center_latitude=0.0, center_longitude=0.0,
                 scale=1.0, false_easting=0.0, false_northing=0.0):
        super().__init__(datum)
        self.lat0 = float(center_latitude)
        self.lon0 = float(center_longitude)
        self.k0 = float(scale)
        self.x0 = float(false_easting)
        self.y0 = float(false_northing)

    def _phi0(self, like):
        """(sin, cos) of the fp32 center latitude, in fp32."""
        phi0 = scalar(np.float32(np.deg2rad(self.lat0)), like)
        return torch.sin(phi0), torch.cos(phi0)

    def forward(self, lon, lat):
        r = self.datum.a * self.k0
        lon, lat = _pair(lon, lat)
        lam = (lon - self.lon0) * _D2R
        phi = lat * _D2R
        s0, c0 = self._phi0(phi)
        cos_c = s0 * torch.sin(phi) + c0 * torch.cos(phi) * torch.cos(lam)
        k = 1.0 / torch.clamp(cos_c, min=1e-6)
        x = r * k * torch.cos(phi) * torch.sin(lam) + self.x0
        y = r * k * (c0 * torch.sin(phi) - s0 * torch.cos(phi) * torch.cos(lam)) + self.y0
        return x, y

    def reverse(self, x, y):
        r = self.datum.a * self.k0
        x, y = _pair(x, y)
        xr = (x - self.x0) / r
        yr = (y - self.y0) / r
        rho = torch.sqrt(xr * xr + yr * yr)
        c = torch.atan(rho)
        s0, c0 = self._phi0(rho)
        sin_c, cos_c = torch.sin(c), torch.cos(c)
        safe_rho = torch.clamp(rho, min=1e-12)
        phi = torch.asin(cos_c * s0 + yr * sin_c * c0 / safe_rho)
        lam = torch.atan2(xr * sin_c, safe_rho * c0 * cos_c - yr * s0 * sin_c)
        lon = lam * _R2D + self.lon0
        lat = phi * _R2D
        lat = torch.where(rho < 1e-12, self.lat0, lat)
        lon = torch.where(rho < 1e-12, self.lon0, lon)
        return lon, lat

    def params(self):
        return {"center_latitude": self.lat0, "center_longitude": self.lon0,
                "scale": self.k0, "false_easting": self.x0,
                "false_northing": self.y0}


PROJECTIONS = {
    "geographic": Projection,
    "longlat": Projection,
    "sinusoidal": SinusoidalProjection,
    "mercator": MercatorProjection,
    "transverse mercator": TransverseMercatorProjection,
    "tmerc": TransverseMercatorProjection,
    "utm": UTMProjection,
    "stereographic": StereographicProjection,
    "orthographic": OrthographicProjection,
    "lambert azimuthal": LambertAzimuthalProjection,
    "lambert conformal conic": LambertConformalProjection,
    "equirectangular": EquirectangularProjection,
    "gnomonic": GnomonicProjection,
}
