"""GeoReference: datum + projection + pixel<->projected affine (port of
``visionworkbench_tpu/cartography/georeference.py``; ref
``src/vw/Cartography/GeoReference.h:46-158`` / ``GeoReference.cc``), with
GeoTIFF key IO (ref ``GeoReferenceResourceGDAL.cc``).

The pixel <-> projected affine runs in fp32 torch, the float64 transform's
entries rounded to fp32, one operation a step in the JAX package's order
(so host planning on the CPU gives the JAX package's values bit for bit);
a tensor keeps its device, arrays go to the CPU.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from visionworkbench_torch.core.device import as_f32
from visionworkbench_torch.core.exceptions import UnsupportedCRSErr
from visionworkbench_torch.math.bbox import BBox2, BBox2i
from visionworkbench_torch.cartography.datum import Datum, well_known_datum
from visionworkbench_torch.cartography.projection import (
    EquirectangularProjection, GnomonicProjection, LambertAzimuthalProjection,
    LambertConformalProjection, MercatorProjection, OrthographicProjection,
    Projection, SinusoidalProjection, StereographicProjection,
    TransverseMercatorProjection, UTMProjection,
)
from visionworkbench_torch.cartography import crs as _crs

PIXEL_AS_AREA = "PixelAsArea"    # pixel (0,0) covers [0,1)x[0,1); center at (0.5, 0.5)
PIXEL_AS_POINT = "PixelAsPoint"  # pixel (0,0) is the point at the transform origin


class GeoReference:
    def __init__(self, datum: Optional[Datum] = None,
                 projection: Optional[Projection] = None,
                 transform=np.eye(3),
                 pixel_interpretation: str = PIXEL_AS_AREA):
        self.datum = datum or well_known_datum("WGS84")
        self.projection = projection or Projection(self.datum)
        self.transform = np.asarray(transform, np.float64)
        self._inv_transform = np.linalg.inv(self.transform)
        self.pixel_interpretation = pixel_interpretation

    # --- constructors -------------------------------------------------------
    def set_transform(self, transform) -> None:
        self.transform = np.asarray(transform, np.float64)
        self._inv_transform = np.linalg.inv(self.transform)

    def set_well_known_geogcs(self, name: str) -> None:
        self.datum = well_known_datum(name)
        self.projection.datum = self.datum

    def set_proj4_projection_str(self, s: str) -> None:
        """Ingest a proj4 string (ref ``set_proj4_projection_str``,
        GeoReference.h:251); raises ``UnsupportedCRSErr`` beyond the
        in-tree projection families."""
        self.datum, self.projection = _crs.parse_proj4(s)

    def set_wkt(self, wkt: str) -> None:
        """Ingest a WKT CRS (ref ``set_wkt``, GeoReference.h:254)."""
        self.datum, self.projection = _crs.parse_wkt(wkt)

    def set_epsg(self, code: int) -> None:
        """Ingest an EPSG code (the reference goes through
        ``set_proj4_projection_str("+init=epsg:...")``)."""
        self.datum, self.projection = _crs.from_epsg(code)

    @classmethod
    def from_proj4(cls, s: str, transform=np.eye(3),
                   pixel_interpretation: str = PIXEL_AS_AREA) -> "GeoReference":
        datum, proj = _crs.parse_proj4(s)
        return cls(datum, proj, transform, pixel_interpretation)

    @classmethod
    def from_wkt(cls, wkt: str, transform=np.eye(3),
                 pixel_interpretation: str = PIXEL_AS_AREA) -> "GeoReference":
        datum, proj = _crs.parse_wkt(wkt)
        return cls(datum, proj, transform, pixel_interpretation)

    @classmethod
    def from_epsg(cls, code: int, transform=np.eye(3),
                  pixel_interpretation: str = PIXEL_AS_AREA) -> "GeoReference":
        datum, proj = _crs.from_epsg(code)
        return cls(datum, proj, transform, pixel_interpretation)

    # --- pixel <-> projected ------------------------------------------------
    def _pixel_offset(self) -> float:
        return 0.5 if self.pixel_interpretation == PIXEL_AS_AREA else 0.0

    def pixel_to_point(self, px, py):
        """Pixel -> projected coordinates (ref ``pixel_to_point``)."""
        t = self.transform.tolist()
        off = self._pixel_offset()
        px = as_f32(px) + off
        py = as_f32(py, like=px) + off
        x = t[0][0] * px + t[0][1] * py + t[0][2]
        y = t[1][0] * px + t[1][1] * py + t[1][2]
        return x, y

    def point_to_pixel(self, x, y):
        it = self._inv_transform.tolist()
        x = as_f32(x)
        y = as_f32(y, like=x)
        off = self._pixel_offset()
        px = it[0][0] * x + it[0][1] * y + it[0][2] - off
        py = it[1][0] * x + it[1][1] * y + it[1][2] - off
        return px, py

    # --- pixel <-> lonlat ---------------------------------------------------
    def pixel_to_lonlat(self, px, py):
        x, y = self.pixel_to_point(px, py)
        return self.projection.reverse(x, y)

    def lonlat_to_pixel(self, lon, lat):
        x, y = self.projection.forward(lon, lat)
        return self.point_to_pixel(x, y)

    def point_to_lonlat(self, x, y):
        return self.projection.reverse(x, y)

    def lonlat_to_point(self, lon, lat):
        return self.projection.forward(lon, lat)

    # --- bounding boxes -----------------------------------------------------
    def pixel_to_lonlat_bbox(self, bbox: BBox2i, samples: int = 32) -> BBox2:
        """Lon/lat box of a pixel box, sampled along the boundary
        (ref ``pixel_to_lonlat_bbox``, GeoReference.cc)."""
        xs = np.linspace(bbox.min_x, bbox.max_x, samples)
        ys = np.linspace(bbox.min_y, bbox.max_y, samples)
        border_x = np.concatenate([xs, xs, np.full(samples, bbox.min_x),
                                   np.full(samples, bbox.max_x)])
        border_y = np.concatenate([np.full(samples, bbox.min_y),
                                   np.full(samples, bbox.max_y), ys, ys])
        lon, lat = self.pixel_to_lonlat(border_x, border_y)
        lon, lat = np.asarray(lon), np.asarray(lat)
        ok = np.isfinite(lon) & np.isfinite(lat)
        return BBox2.from_bounds(lon[ok].min(), lat[ok].min(),
                                 lon[ok].max(), lat[ok].max())

    def lonlat_to_pixel_bbox(self, box: BBox2, samples: int = 32) -> BBox2:
        lons = np.linspace(box.min_x, box.max_x, samples)
        lats = np.linspace(box.min_y, box.max_y, samples)
        border_lon = np.concatenate([lons, lons, np.full(samples, box.min_x),
                                     np.full(samples, box.max_x)])
        border_lat = np.concatenate([np.full(samples, box.min_y),
                                     np.full(samples, box.max_y), lats, lats])
        px, py = self.lonlat_to_pixel(border_lon, border_lat)
        px, py = np.asarray(px), np.asarray(py)
        ok = np.isfinite(px) & np.isfinite(py)
        return BBox2.from_bounds(px[ok].min(), py[ok].min(),
                                 px[ok].max(), py[ok].max())

    # --- GeoTIFF keys -------------------------------------------------------
    def geo_keys(self):
        """(keys, doubles, ascii) for the GeoTIFF writer (GeoKeyDirectory
        layout, every in-tree projection family both directions — ref
        ``GeoReferenceResourceGDAL.cc`` writes the same vocabulary through
        GDAL). Double-valued params are (key, 34736, 1, index-into-doubles)
        entries."""
        keys = []
        doubles = []

        def dkey(key_id, value):
            keys.append((key_id, 34736, 1, len(doubles)))
            doubles.append(float(value))

        p = self.projection
        is_geographic = type(p) is Projection
        # GTModelTypeGeoKey: 1=projected, 2=geographic
        keys.append((1024, 0, 1, 2 if is_geographic else 1))
        # GTRasterTypeGeoKey: 1=PixelIsArea, 2=PixelIsPoint
        keys.append((1025, 0, 1,
                     1 if self.pixel_interpretation == PIXEL_AS_AREA else 2))

        # Geographic CS keys (always written: a projected CS needs its datum).
        geog_epsg = _crs.epsg_for(self.datum, Projection(self.datum))
        keys.append((2048, 0, 1, geog_epsg or 32767))
        keys.append((2054, 0, 1, 9102))     # GeogAngularUnits: degree
        if not geog_epsg:
            dkey(2057, self.datum.a)        # GeogSemiMajorAxis
            dkey(2058, self.datum.b)        # GeogSemiMinorAxis
            if self.datum.meridian_offset:
                dkey(2061, self.datum.meridian_offset)  # PrimeMeridianLong
        if not is_geographic:
            epsg = self._epsg_code()
            keys.append((3072, 0, 1, epsg or 32767))  # ProjectedCSType
            keys.append((3076, 0, 1, 9001))           # ProjLinearUnits: metre
            if not epsg:
                keys.append((3074, 0, 1, 32767))      # user-defined Projection
                ct, params = _PROJ_TO_GEOTIFF_CT(p)
                keys.append((3075, 0, 1, ct))         # ProjCoordTrans
                for key_id, value in params:
                    dkey(key_id, value)
        # GeoKeyDirectory entries must be sorted by key id (GeoTIFF 7.1).
        keys.sort(key=lambda e: e[0])
        ascii_params = f"{self.datum.spheroid_name}|{self.datum.name}|"
        return keys, doubles, ascii_params

    def _epsg_code(self) -> Optional[int]:
        return _crs.epsg_for(self.datum, self.projection)

    def proj4_str(self) -> str:
        """Canonical proj4 description of datum + projection
        (ref ``proj4_str``, GeoReference.h:248 / GeoReference.cc:481-585)."""
        return _crs.to_proj4(self.datum, self.projection)

    def wkt_str(self, projcs_name: Optional[str] = None) -> str:
        """WKT1 description (ref ``get_wkt``, GeoReference.h:257)."""
        return _crs.to_wkt(self.datum, self.projection, projcs_name)

    def __repr__(self):
        return (f"GeoReference({self.projection.name}, {self.datum.name}, "
                f"transform={self.transform.tolist()})")


def _PROJ_TO_GEOTIFF_CT(p: Projection):
    """Projection -> (ProjCoordTransGeoKey code, [(param geokey, value)])
    (GeoTIFF 6.3.3.3 coordinate-transformation vocabulary, the same codes
    GDAL writes for the reference)."""
    t = type(p)
    if t in (TransverseMercatorProjection, UTMProjection):
        return 1, [(3080, p.lon0), (3081, p.lat0), (3092, p.k0),
                   (3082, p.x0), (3083, p.y0)]
    if t is MercatorProjection:
        return 7, [(3080, p.lon0), (3081, 0.0), (3092, p.k0),
                   (3082, p.x0), (3083, p.y0)]
    if t is LambertConformalProjection:
        return 8, [(3078, p.sp1), (3079, p.sp2), (3080, p.lon0),
                   (3081, p.lat0), (3082, p.x0), (3083, p.y0)]
    if t is LambertAzimuthalProjection:
        return 10, [(3088, p.lon0), (3089, p.lat0), (3082, p.x0),
                    (3083, p.y0)]
    if t is StereographicProjection:
        return 14, [(3080, p.lon0), (3081, p.lat0), (3092, p.k0),
                    (3082, p.x0), (3083, p.y0)]
    if t is EquirectangularProjection:
        return 17, [(3088, p.lon0), (3089, p.lat0), (3078, p.lat_ts),
                    (3082, p.x0), (3083, p.y0)]
    if t is GnomonicProjection:
        return 19, [(3088, p.lon0), (3089, p.lat0), (3092, p.k0),
                    (3082, p.x0), (3083, p.y0)]
    if t is OrthographicProjection:
        return 21, [(3088, p.lon0), (3089, p.lat0), (3082, p.x0),
                    (3083, p.y0)]
    if t is SinusoidalProjection:
        return 24, [(3088, p.lon0), (3082, p.x0), (3083, p.y0)]
    raise UnsupportedCRSErr(
        f"no GeoTIFF coordinate-transformation code for {t.__name__}")


# GeoTIFF CT code -> decoder(datum, params dict) for the read side. Accepts
# the GDAL spellings: natural-origin (3080/3081), false-origin (3084/3085)
# and center (3088/3089) lon/lat key variants all map to the same notion.
def _decode_ct(ct: int, d, g):
    lon0 = g(3080, g(3084, g(3088, 0.0)))
    lat0 = g(3081, g(3085, g(3089, 0.0)))
    k0 = g(3092, g(3094, 1.0))
    x0, y0 = g(3082, 0.0), g(3083, 0.0)
    if ct == 1:
        # Recognize the UTM parameterization (exact EPSG round-trip).
        if (abs(k0 - 0.9996) < 1e-9 and x0 == 500000.0 and lat0 == 0.0
                and y0 in (0.0, 10000000.0)):
            zf = (lon0 + 183.0) / 6.0
            if abs(zf - round(zf)) < 1e-9 and 1 <= round(zf) <= 60:
                return UTMProjection(d, int(round(zf)), y0 == 0.0)
        return TransverseMercatorProjection(d, lon0, lat0, k0, x0, y0)
    if ct == 7:
        return MercatorProjection(d, lon0, 0.0, k0, x0, y0)
    if ct in (8, 9):
        sp1 = g(3078, lat0)
        sp2 = g(3079, sp1)
        return LambertConformalProjection(d, sp1, sp2, lat0, lon0, x0, y0)
    if ct == 10:
        return LambertAzimuthalProjection(d, lat0, lon0, x0, y0)
    if ct in (14, 16):
        return StereographicProjection(d, lat0, lon0, k0, x0, y0)
    if ct == 15:
        # Polar stereographic: 3095 straight-vertical-pole longitude,
        # lat0 is the latitude of true scale (pole implied by sign). GDAL
        # writes BOTH ScaleAtNatOrigin=1 and the true-scale latitude, so a
        # non-polar lat_ts wins over a unit scale key.
        lon_p = g(3095, lon0)
        lat_ts = lat0
        pole = 90.0 if lat_ts >= 0 else -90.0
        if abs(k0 - 1.0) > 1e-12 or abs(abs(lat_ts) - 90.0) < 1e-9:
            scale = k0
        else:
            scale = (1.0 + math.sin(math.radians(abs(lat_ts)))) / 2.0
        return StereographicProjection(d, pole, lon_p, scale, x0, y0)
    if ct == 17:
        return EquirectangularProjection(d, lat0, lon0, g(3078, 0.0), x0, y0)
    if ct == 19:
        return GnomonicProjection(d, lat0, lon0, k0, x0, y0)
    if ct == 21:
        return OrthographicProjection(d, lat0, lon0, x0, y0)
    if ct == 24:
        return SinusoidalProjection(d, lon0, x0, y0)
    raise UnsupportedCRSErr(f"unsupported GeoTIFF coordinate "
                            f"transformation code {ct}")


def georeference_from_tiff_info(info, strict: bool = False) -> Optional[GeoReference]:
    """Decode a GeoReference from TIFF geo tags — the full in-tree geo-key
    vocabulary: known ProjectedCSType EPSG codes, user-defined projections
    via ProjCoordTransGeoKey + parameter doubles, and user-defined datums
    via semi-axis doubles (ref ``read_georeference``,
    ``GeoReferenceResourceGDAL.cc``).

    ``strict``: raise :class:`UnsupportedCRSErr` on an unrecognized CRS
    instead of falling back to an identity (geographic) projection."""
    t = info.geo_transform()
    if t is None:
        return None
    keys, doubles, ascii_params = info.geo_keys()
    kd = {}
    for (k, loc, cnt, v) in keys:
        if loc == 0:
            kd[k] = v
        elif loc == 34736 and cnt >= 1 and v < len(doubles):
            kd[k] = float(doubles[v])
    raster_type = kd.get(1025, 1)
    interp = PIXEL_AS_AREA if raster_type == 1 else PIXEL_AS_POINT

    # Datum: known geographic EPSG, else semi-axis doubles, else WGS84.
    geog_code = kd.get(2048, 0)
    from visionworkbench_torch.cartography.crs import (
        _GEOGRAPHIC_EPSG, from_epsg)
    if geog_code in _GEOGRAPHIC_EPSG:
        datum = well_known_datum(_GEOGRAPHIC_EPSG[geog_code])
    elif 2057 in kd:
        a = kd[2057]
        b = kd.get(2058)
        if b is None:
            invf = kd.get(2059, 0.0)
            b = a if invf == 0 else a * (1.0 - 1.0 / invf)
        datum = Datum("user-defined", "user-defined", "Greenwich", a, b,
                      kd.get(2061, 0.0))
    elif strict and geog_code == 32767:
        raise UnsupportedCRSErr("user-defined geographic CS without "
                                "semi-axis geokeys (2057/2058)")
    else:
        datum = well_known_datum("WGS84")

    model_type = kd.get(1024, 2)
    proj: Projection
    if model_type == 2:
        proj = Projection(datum)
    else:
        code = kd.get(3072, 0)
        proj = None
        if code and code != 32767:
            try:
                datum, proj = from_epsg(code)
            except UnsupportedCRSErr:
                if strict and 3075 not in kd:
                    raise
                proj = None
        if proj is None and 3075 in kd:
            def g(key_id, default):
                return kd.get(key_id, default)
            proj = _decode_ct(kd[3075], datum, g)
        if proj is None:
            if strict:
                raise UnsupportedCRSErr(
                    f"unrecognized projected CS (ProjectedCSType={code}, "
                    "no ProjCoordTransGeoKey)")
            proj = Projection(datum)  # unknown: leave as identity
    # The codec's transform maps pixel corners; GeoReference applies the
    # half-pixel shift itself for area pixels, so strip it from the offset.
    g = GeoReference(datum, proj, t, interp)
    return g


def georeference_from_pds_label(label) -> Optional[GeoReference]:
    """Decode a GeoReference from a PDS3 label dict (as returned by
    ``fileio.read_pds``), ref ``GeoReferenceResourcePDS.cc:32-77``: only
    SIMPLE CYLINDRICAL is supported — westernmost longitude / maximum
    latitude as the offset, 1/MAP_RESOLUTION degrees per pixel, radii in km.
    Returns None when required keys are missing or the projection is
    unsupported."""
    def q(key):
        v = label.get(key)
        if v is None:
            return None
        return v.strip().strip('"').strip("'")

    try:
        a_km, b_km = q("A_AXIS_RADIUS"), q("B_AXIS_RADIUS")
        res = q("MAP_RESOLUTION")
        west, north = q("WESTERNMOST_LONGITUDE"), q("MAXIMUM_LATITUDE")
        if None in (a_km, b_km, res, west, north):
            return None
        proj_type = q("MAP_PROJECTION_TYPE")
        if proj_type is not None and proj_type.upper() != "SIMPLE CYLINDRICAL":
            return None
        datum = Datum("PDS Datum", "PDS Spheroid",
                      semi_major_axis=float(a_km) * 1000.0,
                      semi_minor_axis=float(b_km) * 1000.0)
        deg_per_pixel = 1.0 / float(res)
        t = np.array([[deg_per_pixel, 0, float(west)],
                      [0, -deg_per_pixel, float(north)],
                      [0, 0, 1]], np.float64)
        return GeoReference(datum, Projection(datum), t)
    except (ValueError, TypeError):
        return None


def make_geographic_georef(west: float, north: float, deg_per_pixel: float,
                           datum_name: str = "WGS84") -> GeoReference:
    """Convenience: north-up geographic georef with square degrees-per-pixel."""
    datum = well_known_datum(datum_name)
    t = np.array([[deg_per_pixel, 0, west],
                  [0, -deg_per_pixel, north],
                  [0, 0, 1]], np.float64)
    return GeoReference(datum, Projection(datum), t)
