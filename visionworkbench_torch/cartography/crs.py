"""CRS ingestion / emission: proj4 strings, EPSG codes, and WKT (a copy of
``visionworkbench_tpu/cartography/crs.py``, which has no JAX in it, on the
port's own datums and projections).

The reference builds a GeoReference from any proj4 string, WKT string, or
EPSG code by delegating to PROJ/OGR (ref
``src/vw/Cartography/GeoReference.h:251-254`` ``set_proj4_projection_str`` /
``set_wkt``, ``GeoReference.cc:594-830``, GDAL-side
``GeoReferenceResourceGDAL.cc``). Without PROJ, the framework
parses those three formats directly onto its in-tree projection families
(``cartography/projection.py``) and raises a typed
:class:`~visionworkbench_torch.core.exceptions.UnsupportedCRSErr` for anything
beyond them — a clear contract instead of a silent identity fallback.

Everything here is host-side planning code (strings -> (Datum, Projection));
the resulting projection objects are the torch ones the compute path
uses for whole-image warps.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Tuple

from visionworkbench_torch.core.exceptions import UnsupportedCRSErr
from visionworkbench_torch.cartography.datum import Datum, well_known_datum
from visionworkbench_torch.cartography.projection import (
    EquirectangularProjection, GnomonicProjection, LambertAzimuthalProjection,
    LambertConformalProjection, MercatorProjection, OrthographicProjection,
    Projection, SinusoidalProjection, StereographicProjection,
    TransverseMercatorProjection, UTMProjection,
)

__all__ = [
    "parse_proj4", "parse_wkt", "from_epsg", "to_proj4", "to_wkt",
    "epsg_for",
]


# ---------------------------------------------------------------------------
# Datums / ellipsoids
# ---------------------------------------------------------------------------

# +ellps= vocabulary (subset of PROJ's table covering the reference's tools).
_ELLPS = {
    "WGS84":  ("WGS 84", 6378137.0, 298.257223563),
    "GRS80":  ("GRS 1980", 6378137.0, 298.257222101),
    "WGS72":  ("WGS 72", 6378135.0, 298.26),
    "clrk66": ("Clarke 1866", 6378206.4, 294.9786982),
    "clrk80": ("Clarke 1880 mod.", 6378249.145, 293.465),
    "intl":   ("International 1909 (Hayford)", 6378388.0, 297.0),
    "sphere": ("Normal Sphere", 6370997.0, 0.0),
}

_DATUMS = {
    "WGS84": "WGS84",
    "NAD83": "NAD83",
    "NAD27": "NAD27",
    "WGS72": "WGS72",
}

# Geographic-CS EPSG codes -> well-known datum name.
_GEOGRAPHIC_EPSG = {
    4326: "WGS84",
    4322: "WGS72",
    4269: "NAD83",
    4267: "NAD27",
    4258: "NAD83",   # ETRS89 shares the GRS80 ellipsoid; treated as GRS80
}
_EPSG_FOR_DATUM = {"WGS84": 4326, "WGS72": 4322, "NAD83": 4269, "NAD27": 4267}


def _datum_from_ellps(name: str) -> Datum:
    if name not in _ELLPS:
        raise UnsupportedCRSErr(
            f"unsupported +ellps={name!r}; one of {sorted(_ELLPS)}")
    sph, a, rf = _ELLPS[name]
    b = a if rf == 0 else a * (1.0 - 1.0 / rf)
    return Datum(f"unknown ({sph})", sph, "Greenwich", a, b)


def _datum_abr(a: float, b: Optional[float] = None,
               rf: Optional[float] = None, name: str = "unnamed") -> Datum:
    if b is None:
        b = a if (rf is None or rf == 0) else a * (1.0 - 1.0 / rf)
    return Datum(name, name, "Greenwich", a, b)


# ---------------------------------------------------------------------------
# proj4
# ---------------------------------------------------------------------------

def _parse_proj4_tokens(s: str) -> Dict[str, str]:
    params: Dict[str, str] = {}
    for tok in s.split():
        if not tok.startswith("+"):
            continue
        if "=" in tok:
            k, v = tok[1:].split("=", 1)
            params[k] = v
        else:
            params[tok[1:]] = ""
    return params


def parse_proj4(s: str) -> Tuple[Datum, Projection]:
    """proj4 string -> (Datum, Projection)
    (ref ``GeoReference::set_proj4_projection_str``, GeoReference.cc:594-660;
    the reference hands the string to PROJ — here it is parsed onto the
    in-tree families, with :class:`UnsupportedCRSErr` beyond them)."""
    p = _parse_proj4_tokens(s)
    if "init" in p:
        m = re.match(r"(?i)epsg:(\d+)$", p["init"])
        if not m:
            raise UnsupportedCRSErr(f"unsupported +init={p['init']!r} "
                                    "(only epsg:<code>)")
        return from_epsg(int(m.group(1)))
    proj = p.get("proj")
    if proj is None:
        raise UnsupportedCRSErr(f"no +proj= in {s!r}")

    # --- datum ---
    if "datum" in p:
        key = p["datum"].upper()
        if key not in _DATUMS:
            raise UnsupportedCRSErr(
                f"unsupported +datum={p['datum']!r}; one of {sorted(_DATUMS)}")
        datum = well_known_datum(_DATUMS[key])
    elif "a" in p or "R" in p:
        a = float(p.get("a", p.get("R")))
        b = float(p["b"]) if "b" in p else None
        rf = float(p["rf"]) if "rf" in p else (0.0 if "R" in p else None)
        datum = _datum_abr(a, b, rf, name="user-defined")
    elif "ellps" in p:
        datum = _datum_from_ellps(p["ellps"])
    else:
        datum = well_known_datum("WGS84")   # PROJ's historic default
    if "pm" in p:
        try:
            datum.meridian_offset = float(p["pm"])
        except ValueError:
            if p["pm"].lower() != "greenwich":
                raise UnsupportedCRSErr(f"unsupported +pm={p['pm']!r}")

    units = p.get("units", "m")
    if proj not in ("longlat", "latlong", "latlon", "lonlat") and \
            units not in ("m", "meter", "metre"):
        raise UnsupportedCRSErr(f"unsupported +units={units!r} (only metres)")

    def f(key: str, default: float = 0.0) -> float:
        return float(p.get(key, default))

    k_scale = float(p["k"]) if "k" in p else (
        float(p["k_0"]) if "k_0" in p else None)

    # --- projection families ---
    if proj in ("longlat", "latlong", "latlon", "lonlat"):
        return datum, Projection(datum)
    if proj == "eqc":
        return datum, EquirectangularProjection(
            datum, f("lat_0"), f("lon_0"), f("lat_ts"), f("x_0"), f("y_0"))
    if proj == "sinu":
        return datum, SinusoidalProjection(datum, f("lon_0"), f("x_0"), f("y_0"))
    if proj == "merc":
        # +k (scale at equator) or +lat_ts: spherical merc k = cos(lat_ts).
        scale = k_scale if k_scale is not None else \
            math.cos(math.radians(f("lat_ts")))
        return datum, MercatorProjection(datum, f("lon_0"), f("lat_0"),
                                         scale, f("x_0"), f("y_0"))
    if proj == "webmerc":
        sph = Datum("WGS_1984 (web sphere)", "WGS 84", "Greenwich",
                    datum.a, datum.a)
        return sph, MercatorProjection(sph, f("lon_0"), 0.0, 1.0,
                                       f("x_0"), f("y_0"))
    if proj == "tmerc":
        return datum, TransverseMercatorProjection(
            datum, f("lon_0"), f("lat_0"),
            k_scale if k_scale is not None else 1.0, f("x_0"), f("y_0"))
    if proj == "utm":
        if "zone" not in p:
            raise UnsupportedCRSErr("+proj=utm needs +zone=")
        return datum, UTMProjection(datum, int(p["zone"]), "south" not in p)
    if proj == "ortho":
        return datum, OrthographicProjection(datum, f("lat_0"), f("lon_0"),
                                             f("x_0"), f("y_0"))
    if proj in ("stere", "sterea"):
        if k_scale is not None:
            scale = k_scale
        elif "lat_ts" in p:
            # Spherical polar stereographic with a latitude of true scale:
            # k0 = (1 + sin(|lat_ts|)) / 2 (Snyder eq. 21-7 specialization).
            scale = (1.0 + math.sin(math.radians(abs(f("lat_ts"))))) / 2.0
        else:
            scale = 1.0
        return datum, StereographicProjection(datum, f("lat_0"), f("lon_0"),
                                              scale, f("x_0"), f("y_0"))
    if proj == "gnom":
        return datum, GnomonicProjection(datum, f("lat_0"), f("lon_0"),
                                         k_scale if k_scale is not None else 1.0,
                                         f("x_0"), f("y_0"))
    if proj == "laea":
        return datum, LambertAzimuthalProjection(datum, f("lat_0"), f("lon_0"),
                                                 f("x_0"), f("y_0"))
    if proj == "lcc":
        lat1 = f("lat_1")
        lat2 = float(p["lat_2"]) if "lat_2" in p else lat1
        return datum, LambertConformalProjection(
            datum, lat1, lat2, f("lat_0"), f("lon_0"), f("x_0"), f("y_0"))
    raise UnsupportedCRSErr(
        f"unsupported +proj={proj!r}; in-tree families: longlat eqc sinu merc "
        "webmerc tmerc utm ortho stere sterea gnom laea lcc")


def to_proj4(datum: Datum, projection: Projection) -> str:
    """Canonical proj4 emission for the in-tree families (spelled like the
    reference's setters, GeoReference.cc:481-585)."""
    def num(v: float) -> str:
        return f"{v:.10g}"

    # datum part
    dp: List[str] = []
    for wk, code in (("WGS84", "WGS84"), ("NAD83", "NAD83"),
                     ("NAD27", "NAD27"), ("WGS72", "WGS72")):
        if datum == well_known_datum(wk):
            dp.append(f"+datum={code}")
            break
    else:
        dp.append(f"+a={num(datum.a)} +b={num(datum.b)}")
    if datum.meridian_offset:
        dp.append(f"+pm={num(datum.meridian_offset)}")
    datum_str = " ".join(dp)

    t = type(projection)
    pr = projection
    if t is Projection:
        return f"+proj=longlat {datum_str} +no_defs"
    if t is UTMProjection:
        south = "" if pr.north else " +south"
        return (f"+proj=utm +zone={pr.zone}{south} {datum_str} "
                "+units=m +no_defs")
    if t is SinusoidalProjection:
        core = f"+proj=sinu +lon_0={num(pr.lon0)} +x_0={num(pr.x0)} +y_0={num(pr.y0)}"
    elif t is EquirectangularProjection:
        core = (f"+proj=eqc +lon_0={num(pr.lon0)} +lat_0={num(pr.lat0)} "
                f"+lat_ts={num(pr.lat_ts)} +x_0={num(pr.x0)} +y_0={num(pr.y0)}")
    elif t is MercatorProjection:
        core = (f"+proj=merc +lon_0={num(pr.lon0)} +k={num(pr.k0)} "
                f"+x_0={num(pr.x0)} +y_0={num(pr.y0)}")
    elif t is TransverseMercatorProjection:
        core = (f"+proj=tmerc +lon_0={num(pr.lon0)} +lat_0={num(pr.lat0)} "
                f"+k={num(pr.k0)} +x_0={num(pr.x0)} +y_0={num(pr.y0)}")
    elif t is StereographicProjection:
        core = (f"+proj=stere +lat_0={num(pr.lat0)} +lon_0={num(pr.lon0)} "
                f"+k={num(pr.k0)} +x_0={num(pr.x0)} +y_0={num(pr.y0)}")
    elif t is OrthographicProjection:
        core = (f"+proj=ortho +lat_0={num(pr.lat0)} +lon_0={num(pr.lon0)} "
                f"+x_0={num(pr.x0)} +y_0={num(pr.y0)}")
    elif t is GnomonicProjection:
        core = (f"+proj=gnom +lat_0={num(pr.lat0)} +lon_0={num(pr.lon0)} "
                f"+k={num(pr.k0)} +x_0={num(pr.x0)} +y_0={num(pr.y0)}")
    elif t is LambertAzimuthalProjection:
        core = (f"+proj=laea +lat_0={num(pr.lat0)} +lon_0={num(pr.lon0)} "
                f"+x_0={num(pr.x0)} +y_0={num(pr.y0)}")
    elif t is LambertConformalProjection:
        core = (f"+proj=lcc +lat_1={num(pr.sp1)} +lat_2={num(pr.sp2)} "
                f"+lat_0={num(pr.lat0)} +lon_0={num(pr.lon0)} "
                f"+x_0={num(pr.x0)} +y_0={num(pr.y0)}")
    else:
        raise UnsupportedCRSErr(f"no proj4 emission for {t.__name__}")
    return f"{core} {datum_str} +units=m +no_defs"


# ---------------------------------------------------------------------------
# EPSG
# ---------------------------------------------------------------------------

def from_epsg(code: int) -> Tuple[Datum, Projection]:
    """EPSG code -> (Datum, Projection) for the in-tree set: the geographic
    CSs 4326/4322/4269/4267/4258, WGS84/WGS72/NAD83/NAD27 UTM ranges,
    world Mercator 3395, and web Mercator 3857."""
    code = int(code)
    if code in _GEOGRAPHIC_EPSG:
        d = well_known_datum(_GEOGRAPHIC_EPSG[code])
        return d, Projection(d)
    for (lo, n, datum_name, north) in (
            (32601, 60, "WGS84", True), (32701, 60, "WGS84", False),
            (32201, 60, "WGS72", True), (32301, 60, "WGS72", False),
            (26903, 21, "NAD83", True),   # 26903..26923: NAD83 UTM 3N..23N
            (26703, 20, "NAD27", True)):  # 26703..26722: NAD27 UTM 3N..22N
        if lo <= code < lo + n:
            d = well_known_datum(datum_name)
            zone = code - lo + (1 if lo in (32601, 32701, 32201, 32301) else 3)
            return d, UTMProjection(d, zone, north)
    if code == 3395:
        d = well_known_datum("WGS84")
        return d, MercatorProjection(d, 0.0, 0.0, 1.0, 0.0, 0.0)
    if code == 3857:
        a = 6378137.0
        d = Datum("WGS_1984 (web sphere)", "WGS 84", "Greenwich", a, a)
        return d, MercatorProjection(d, 0.0, 0.0, 1.0, 0.0, 0.0)
    raise UnsupportedCRSErr(
        f"EPSG:{code} outside the in-tree set (geographic 4326/4322/4269/"
        "4267/4258, UTM 32601-32660/32701-32760/32201-32260/32301-32360/"
        "26903-26923/26703-26722, Mercator 3395/3857)")


def epsg_for(datum: Datum, projection: Projection) -> Optional[int]:
    """Best-effort EPSG code for an in-tree (datum, projection), or None."""
    name = None
    for wk in ("WGS84", "WGS72", "NAD83", "NAD27"):
        if datum == well_known_datum(wk):
            name = wk
            break
    if isinstance(projection, UTMProjection):
        z = projection.zone
        if name == "WGS84":
            return (32600 if projection.north else 32700) + z
        if name == "WGS72":
            return (32200 if projection.north else 32300) + z
        if name == "NAD83" and projection.north and 3 <= z <= 23:
            return 26900 + z
        if name == "NAD27" and projection.north and 3 <= z <= 22:
            return 26700 + z
        return None
    if type(projection) is Projection and name:
        return _EPSG_FOR_DATUM[name]
    if (type(projection) is MercatorProjection and name == "WGS84"
            and projection.k0 == 1.0 and projection.lon0 == 0.0
            and projection.x0 == 0.0 and projection.y0 == 0.0):
        return 3395
    if (type(projection) is MercatorProjection and datum.a == datum.b
            and datum.a == 6378137.0 and projection.k0 == 1.0
            and projection.lon0 == 0.0):
        return 3857
    return None


# ---------------------------------------------------------------------------
# WKT (OGC WKT1 as written by GDAL)
# ---------------------------------------------------------------------------

class _WktNode:
    __slots__ = ("name", "values", "children")

    def __init__(self, name: str):
        self.name = name
        self.values: List = []       # strings / numbers
        self.children: List["_WktNode"] = []

    def child(self, name: str) -> Optional["_WktNode"]:
        for c in self.children:
            if c.name.upper() == name.upper():
                return c
        return None

    def all(self, name: str) -> List["_WktNode"]:
        return [c for c in self.children if c.name.upper() == name.upper()]


_WKT_TOKEN = re.compile(r'\s*(?:("(?:[^"]|"")*")|([A-Za-z_][A-Za-z0-9_]*)'
                        r'|([-+]?[0-9][-+0-9.eE]*)|([\[\],\(\)]))')


def _parse_wkt_tree(s: str) -> _WktNode:
    pos = 0
    n = len(s)

    def tokens():
        nonlocal pos
        while pos < n:
            m = _WKT_TOKEN.match(s, pos)
            if not m:
                if s[pos:].strip():
                    raise UnsupportedCRSErr(
                        f"WKT parse error at {s[pos:pos+30]!r}")
                return
            pos = m.end()
            if m.group(1) is not None:
                yield ("str", m.group(1)[1:-1].replace('""', '"'))
            elif m.group(2) is not None:
                yield ("word", m.group(2))
            elif m.group(3) is not None:
                yield ("num", float(m.group(3)))
            else:
                yield ("punct", m.group(4))

    it = tokens()

    def parse_node(name: str) -> _WktNode:
        node = _WktNode(name)
        tok = next(it, None)
        if tok is None or tok[1] not in ("[", "("):
            raise UnsupportedCRSErr(f"WKT: expected '[' after {name}")
        pending_word = None
        for kind, val in it:
            if kind == "punct" and val in ("]", ")"):
                if pending_word is not None:
                    node.values.append(pending_word)
                return node
            if kind == "punct" and val == ",":
                if pending_word is not None:
                    node.values.append(pending_word)
                    pending_word = None
                continue
            if kind == "punct" and val in ("[", "("):
                raise UnsupportedCRSErr("WKT: unexpected '['")
            if kind == "word":
                # Either a keyword opening a child node, or a bare enum value
                # (e.g. AXIS[...,NORTH]); decided by the next token.
                if pending_word is not None:
                    node.values.append(pending_word)
                save = pos
                nxt = next(it, None)
                if nxt is not None and nxt[0] == "punct" and nxt[1] in ("[", "("):
                    nonlocal_pos_restore(save)
                    node.children.append(parse_node(val))
                    pending_word = None
                else:
                    pending_word = val
                    if nxt is not None and nxt[0] == "punct" and nxt[1] in ("]", ")"):
                        node.values.append(pending_word)
                        return node
                    elif nxt is not None and nxt[0] != "punct":
                        node.values.append(pending_word)
                        pending_word = None
                        node.values.append(nxt[1])
                continue
            node.values.append(val)
        raise UnsupportedCRSErr(f"WKT: unterminated {name}")

    def nonlocal_pos_restore(p):
        nonlocal pos
        pos = p

    first = next(it, None)
    if first is None or first[0] != "word":
        raise UnsupportedCRSErr("empty WKT")
    return parse_node(first[1])


def _datum_from_wkt_geogcs(geogcs: _WktNode) -> Datum:
    datum_node = geogcs.child("DATUM")
    if datum_node is None:
        raise UnsupportedCRSErr("WKT GEOGCS without DATUM")
    dname = str(datum_node.values[0]) if datum_node.values else "unknown"
    sph = datum_node.child("SPHEROID") or datum_node.child("ELLIPSOID")
    if sph is None or len(sph.values) < 3:
        raise UnsupportedCRSErr("WKT DATUM without SPHEROID[name, a, 1/f]")
    sname = str(sph.values[0])
    a = float(sph.values[1])
    rf = float(sph.values[2])
    b = a if rf == 0 else a * (1.0 - 1.0 / rf)
    pm = geogcs.child("PRIMEM")
    off = float(pm.values[1]) if pm is not None and len(pm.values) > 1 else 0.0
    return Datum(dname, sname, "Greenwich", a, b, off)


def parse_wkt(s: str) -> Tuple[Datum, Projection]:
    """WKT1 (GDAL spelling) -> (Datum, Projection)
    (ref ``GeoReference::set_wkt``, GeoReference.h:254 / GeoReference.cc)."""
    root = _parse_wkt_tree(s)
    kind = root.name.upper()
    if kind in ("GEOGCS", "GEOGCRS"):
        d = _datum_from_wkt_geogcs(root)
        return d, Projection(d)
    if kind not in ("PROJCS", "PROJCRS"):
        raise UnsupportedCRSErr(f"unsupported WKT root {root.name!r} "
                                "(GEOGCS or PROJCS)")
    geogcs = root.child("GEOGCS") or root.child("GEOGCRS")
    if geogcs is None:
        raise UnsupportedCRSErr("WKT PROJCS without GEOGCS")
    datum = _datum_from_wkt_geogcs(geogcs)
    proj_node = root.child("PROJECTION")
    if proj_node is None or not proj_node.values:
        raise UnsupportedCRSErr("WKT PROJCS without PROJECTION")
    method = str(proj_node.values[0]).lower()
    params: Dict[str, float] = {}
    for pn in root.all("PARAMETER"):
        if len(pn.values) >= 2:
            params[str(pn.values[0]).lower()] = float(pn.values[1])
    unit = root.child("UNIT")
    if unit is not None and len(unit.values) >= 2 and \
            abs(float(unit.values[1]) - 1.0) > 1e-9:
        raise UnsupportedCRSErr(
            f"unsupported projected WKT UNIT {unit.values!r} (metres only)")

    def g(name: str, default: float = 0.0) -> float:
        return params.get(name, default)

    lon0 = g("central_meridian", g("longitude_of_center"))
    lat0 = g("latitude_of_origin", g("latitude_of_center"))
    x0, y0 = g("false_easting"), g("false_northing")
    k = g("scale_factor", 1.0)

    if method == "transverse_mercator":
        # Recognize the UTM parameterization for EPSG round-tripping.
        if (abs(k - 0.9996) < 1e-9 and x0 == 500000.0 and lat0 == 0.0
                and y0 in (0.0, 10000000.0)):
            zf = (lon0 + 183.0) / 6.0
            if abs(zf - round(zf)) < 1e-9 and 1 <= round(zf) <= 60:
                return datum, UTMProjection(datum, int(round(zf)), y0 == 0.0)
        return datum, TransverseMercatorProjection(datum, lon0, lat0, k, x0, y0)
    if method in ("mercator_1sp", "mercator"):
        return datum, MercatorProjection(datum, lon0, lat0, k, x0, y0)
    if method == "mercator_2sp":
        k2 = math.cos(math.radians(g("standard_parallel_1")))
        return datum, MercatorProjection(datum, lon0, lat0, k2, x0, y0)
    if method == "sinusoidal":
        return datum, SinusoidalProjection(datum, lon0, x0, y0)
    if method in ("equirectangular", "equidistant_cylindrical"):
        return datum, EquirectangularProjection(
            datum, lat0, lon0, g("standard_parallel_1"), x0, y0)
    if method == "orthographic":
        return datum, OrthographicProjection(datum, lat0, lon0, x0, y0)
    if method in ("stereographic", "oblique_stereographic"):
        return datum, StereographicProjection(datum, lat0, lon0, k, x0, y0)
    if method == "polar_stereographic":
        # GDAL: latitude_of_origin is the latitude of true scale; the pole
        # is implied by its sign (spherical k0 = (1+sin|lat_ts|)/2).
        lat_ts = lat0
        pole = 90.0 if lat_ts >= 0 else -90.0
        if "scale_factor" in params and abs(k - 1.0) > 1e-12:
            scale = k
        else:
            scale = (1.0 + math.sin(math.radians(abs(lat_ts)))) / 2.0
        return datum, StereographicProjection(datum, pole, lon0, scale, x0, y0)
    if method == "gnomonic":
        return datum, GnomonicProjection(datum, lat0, lon0, k, x0, y0)
    if method == "lambert_azimuthal_equal_area":
        return datum, LambertAzimuthalProjection(datum, lat0, lon0, x0, y0)
    if method == "lambert_conformal_conic_2sp":
        return datum, LambertConformalProjection(
            datum, g("standard_parallel_1"), g("standard_parallel_2"),
            lat0, lon0, x0, y0)
    if method == "lambert_conformal_conic_1sp":
        if abs(k - 1.0) > 1e-12:
            raise UnsupportedCRSErr(
                "Lambert_Conformal_Conic_1SP with scale_factor != 1 has no "
                "in-tree equivalent")
        return datum, LambertConformalProjection(datum, lat0, lat0,
                                                 lat0, lon0, x0, y0)
    raise UnsupportedCRSErr(f"unsupported WKT PROJECTION {method!r}")


def _wkt_geogcs(datum: Datum, indent: str = "") -> str:
    rf = datum.inverse_flattening()
    rf_s = "0" if rf == math.inf else f"{rf:.9f}".rstrip("0").rstrip(".")
    epsg = None
    for wk, code in _EPSG_FOR_DATUM.items():
        if datum == well_known_datum(wk):
            epsg = code
            break
    auth = f',AUTHORITY["EPSG","{epsg}"]' if epsg else ""
    gname = {4326: "WGS 84", 4322: "WGS 72", 4269: "NAD83",
             4267: "NAD27"}.get(epsg, datum.name)
    return (f'GEOGCS["{gname}",DATUM["{datum.name}",'
            f'SPHEROID["{datum.spheroid_name}",{datum.a:.10g},{rf_s}]],'
            f'PRIMEM["Greenwich",{datum.meridian_offset:.10g}],'
            f'UNIT["degree",0.0174532925199433]{auth}]')


_WKT_METHOD = {
    TransverseMercatorProjection: "Transverse_Mercator",
    MercatorProjection: "Mercator_1SP",
    SinusoidalProjection: "Sinusoidal",
    EquirectangularProjection: "Equirectangular",
    OrthographicProjection: "Orthographic",
    StereographicProjection: "Stereographic",
    GnomonicProjection: "Gnomonic",
    LambertAzimuthalProjection: "Lambert_Azimuthal_Equal_Area",
    LambertConformalProjection: "Lambert_Conformal_Conic_2SP",
}


def to_wkt(datum: Datum, projection: Projection,
           projcs_name: Optional[str] = None) -> str:
    """WKT1 emission for the in-tree families (the GDAL spelling the
    reference writes through OGR, ``GeoReferenceResourceGDAL.cc``)."""
    if type(projection) is Projection:
        return _wkt_geogcs(datum)
    geog = _wkt_geogcs(datum)
    pr = projection
    t = type(pr)
    params: List[Tuple[str, float]] = []
    if t is UTMProjection:
        method = "Transverse_Mercator"
        hemi = "N" if pr.north else "S"
        projcs_name = projcs_name or f"UTM Zone {pr.zone}, " \
            f"{'Northern' if pr.north else 'Southern'} Hemisphere"
        params = [("latitude_of_origin", 0.0), ("central_meridian", pr.lon0),
                  ("scale_factor", 0.9996), ("false_easting", 500000.0),
                  ("false_northing", 0.0 if pr.north else 10000000.0)]
    elif t is TransverseMercatorProjection:
        method = "Transverse_Mercator"
        params = [("latitude_of_origin", pr.lat0), ("central_meridian", pr.lon0),
                  ("scale_factor", pr.k0), ("false_easting", pr.x0),
                  ("false_northing", pr.y0)]
    elif t is MercatorProjection:
        method = "Mercator_1SP"
        params = [("central_meridian", pr.lon0), ("scale_factor", pr.k0),
                  ("false_easting", pr.x0), ("false_northing", pr.y0)]
    elif t is SinusoidalProjection:
        method = "Sinusoidal"
        params = [("longitude_of_center", pr.lon0),
                  ("false_easting", pr.x0), ("false_northing", pr.y0)]
    elif t is EquirectangularProjection:
        method = "Equirectangular"
        params = [("latitude_of_origin", pr.lat0), ("central_meridian", pr.lon0),
                  ("standard_parallel_1", pr.lat_ts),
                  ("false_easting", pr.x0), ("false_northing", pr.y0)]
    elif t is OrthographicProjection:
        method = "Orthographic"
        params = [("latitude_of_origin", pr.lat0), ("central_meridian", pr.lon0),
                  ("false_easting", pr.x0), ("false_northing", pr.y0)]
    elif t is StereographicProjection:
        method = "Stereographic"
        params = [("latitude_of_origin", pr.lat0), ("central_meridian", pr.lon0),
                  ("scale_factor", pr.k0),
                  ("false_easting", pr.x0), ("false_northing", pr.y0)]
    elif t is GnomonicProjection:
        method = "Gnomonic"
        params = [("latitude_of_origin", pr.lat0), ("central_meridian", pr.lon0),
                  ("scale_factor", pr.k0),
                  ("false_easting", pr.x0), ("false_northing", pr.y0)]
    elif t is LambertAzimuthalProjection:
        method = "Lambert_Azimuthal_Equal_Area"
        params = [("latitude_of_center", pr.lat0),
                  ("longitude_of_center", pr.lon0),
                  ("false_easting", pr.x0), ("false_northing", pr.y0)]
    elif t is LambertConformalProjection:
        method = "Lambert_Conformal_Conic_2SP"
        params = [("standard_parallel_1", pr.sp1), ("standard_parallel_2", pr.sp2),
                  ("latitude_of_origin", pr.lat0), ("central_meridian", pr.lon0),
                  ("false_easting", pr.x0), ("false_northing", pr.y0)]
    else:
        raise UnsupportedCRSErr(f"no WKT emission for {t.__name__}")
    projcs_name = projcs_name or f"{pr.name} projection"
    ps = ",".join(f'PARAMETER["{k}",{v:.10g}]' for k, v in params)
    epsg = epsg_for(datum, projection)
    auth = f',AUTHORITY["EPSG","{epsg}"]' if epsg else ""
    return (f'PROJCS["{projcs_name}",{geog},PROJECTION["{method}"],{ps},'
            f'UNIT["metre",1]{auth}]')
