"""Port's cartography (``visionworkbench_torch/cartography/``: datums, the
ten projection families, CRS parsing, GeoReference with its GeoTIFF keys,
GeoTransform and ``reproject_image``) against the JAX package on the CPU,
on the same seeded numpy inputs.

Tolerances (fp32 everywhere): the host-side parts (datums, CRS strings,
geo keys, the GeoTIFF round trip, the pixel <-> projected affine) are
exact. The projections run ``sin``/``cos``/``atan``/``log``/``pow`` on
both sides, and XLA's and PyTorch's differ by ulps (and the jitted JAX
package fuses multiply-adds): forward within 4e-6 of the output's scale
(measured <= 3.9e-7, Lambert conformal), reverse and round trips within
2e-4 degrees (measured <= 1.2e-4, the polar stereographic's longitudes
near the pole); ECEF within 4e-6 of the semi-major axis (measured
7.8e-8), geodetic heights within 4 m (the fp32 Bowring iteration's;
measured 1 m). Reprojected images: the
reverse maps within 0.01 px (fp32 UTM metres; measured 4.9e-4) and the
samples within twice that plus 2e-5 (bilinear on [0, 1] noise).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import _torch_threads, cuda  # noqa: F401
import visionworkbench_tpu.cartography.crs as jcrs
import visionworkbench_tpu.cartography.datum as jdatum
import visionworkbench_tpu.cartography.georeference as jgeo
import visionworkbench_tpu.cartography.geotransform as jgt
import visionworkbench_tpu.cartography.projection as jproj
import visionworkbench_tpu.fileio.tiff as jtiff
import visionworkbench_tpu.math.bbox as jbbox
import visionworkbench_torch.cartography.crs as tcrs
import visionworkbench_torch.cartography.datum as tdatum
import visionworkbench_torch.cartography.georeference as tgeo
import visionworkbench_torch.cartography.geotransform as tgt
import visionworkbench_torch.cartography.projection as tproj
import visionworkbench_torch.fileio.tiff as ttiff
import visionworkbench_torch.math.bbox as tbbox

FWD_REL = 4e-6
DEG = 2e-4


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _families(proj, datum):
    """The ten projection families (and the geographic identity), each
    with a lon/lat box it is used over."""
    d = datum.well_known_datum("WGS84")
    return {
        "geographic": (proj.Projection(d), (-30, 30, -30, 30)),
        "sinusoidal": (proj.SinusoidalProjection(d, 10, 100, 200), (-20, 40, -60, 60)),
        "mercator": (proj.MercatorProjection(d, 5, 0, 1.0, 10, 20), (-30, 40, -70, 70)),
        "tmerc": (proj.TransverseMercatorProjection(d, -3, 10, 0.9996, 500000, 0),
                  (-6, 0, 0, 60)),
        "utm": (proj.UTMProjection(d, 33, False), (12, 18, -60, -1)),
        "stereographic": (proj.StereographicProjection(d, 90, 0, 0.994, 2e6, 2e6),
                          (-180, 180, 50, 89)),
        "orthographic": (proj.OrthographicProjection(d, 40, -100), (-140, -60, 10, 70)),
        "laea": (proj.LambertAzimuthalProjection(d, 52, 10, 4321000, 3210000),
                 (-10, 30, 35, 70)),
        "lcc": (proj.LambertConformalProjection(d, 33, 45, 39, -96, 0, 0),
                (-120, -70, 25, 50)),
        "equirectangular": (proj.EquirectangularProjection(d, 0, 0, 30, 0, 0),
                            (-170, 170, -80, 80)),
        "gnomonic": (proj.GnomonicProjection(d, 40, 10), (-20, 40, 20, 60)),
    }


def _lonlat(box, seed, n=2000):
    rng = np.random.default_rng(seed)
    return (rng.uniform(box[0], box[1], n).astype(np.float32),
            rng.uniform(box[2], box[3], n).astype(np.float32))


@pytest.mark.parametrize("family", sorted(_families(tproj, tdatum)))
def test_projection_matches_jax(family):
    """Forward, reverse and the round trip of each family; the
    parameters, names and the family table."""
    jp, box = _families(jproj, jdatum)[family]
    tp, _ = _families(tproj, tdatum)[family]
    assert (tp.name, tp.proj4_name, tp.params()) == (jp.name, jp.proj4_name, jp.params())
    lon, lat = _lonlat(box, 3)
    jx, jy = (np.asarray(v) for v in jp.forward(lon, lat))
    tx, ty = (_np(v) for v in tp.forward(lon, lat))
    scale = max(np.abs(jx).max(), np.abs(jy).max(), 1.0)
    np.testing.assert_allclose(tx, jx, rtol=0, atol=FWD_REL * scale)
    np.testing.assert_allclose(ty, jy, rtol=0, atol=FWD_REL * scale)
    jl, jt = (np.asarray(v) for v in jp.reverse(jx, jy))
    tl, tt = (_np(v) for v in tp.reverse(jx, jy))
    np.testing.assert_allclose(tl, jl, rtol=0, atol=DEG)
    np.testing.assert_allclose(tt, jt, rtol=0, atol=DEG)
    np.testing.assert_allclose(tl, lon, rtol=0, atol=DEG)
    np.testing.assert_allclose(tt, lat, rtol=0, atol=DEG)
    assert sorted(tproj.PROJECTIONS) == sorted(jproj.PROJECTIONS)


def test_datum_matches_jax():
    for name in jdatum._WELL_KNOWN:
        jd, td = jdatum.well_known_datum(name), tdatum.well_known_datum(name)
        assert (td.name, td.spheroid_name, td.a, td.b, td.e2, td.flattening,
                td.inverse_flattening(), repr(td)) == \
            (jd.name, jd.spheroid_name, jd.a, jd.b, jd.e2, jd.flattening,
             jd.inverse_flattening(), repr(jd))
    jd = jdatum.Datum("mars", "s", "m", 3396190.0, 3376200.0, 12.5)
    td = tdatum.Datum("mars", "s", "m", 3396190.0, 3376200.0, 12.5)
    assert td == tdatum.Datum("x", "y", "z", 3396190.0, 3376200.0, 12.5)
    lon, lat = _lonlat((-180, 180, -85, 85), 4, 500)
    h = np.random.default_rng(5).uniform(-5000, 9000, 500).astype(np.float32)
    llh = np.stack([lon, lat, h], -1)
    np.testing.assert_allclose(_np(td.radius(lon, lat)), np.asarray(jd.radius(lon, lat)),
                               rtol=0, atol=FWD_REL * jd.a)
    jxyz = np.asarray(jd.geodetic_to_cartesian(llh))
    np.testing.assert_allclose(_np(td.geodetic_to_cartesian(llh)), jxyz,
                               rtol=0, atol=FWD_REL * jd.a)
    jllh = np.asarray(jd.cartesian_to_geodetic(jxyz))
    tllh = _np(td.cartesian_to_geodetic(jxyz))
    np.testing.assert_allclose(tllh[:, :2], jllh[:, :2], rtol=0, atol=DEG)
    np.testing.assert_allclose(tllh[:, 2], jllh[:, 2], rtol=0, atol=4.0)
    with pytest.raises(ValueError):
        tdatum.well_known_datum("nope")


PROJ4 = [
    "+proj=longlat +datum=WGS84 +no_defs",
    "+proj=utm +zone=12 +datum=WGS84 +units=m +no_defs",
    "+proj=utm +zone=33 +south +datum=WGS84 +units=m",
    "+proj=tmerc +lon_0=9 +lat_0=0 +k=1 +x_0=3500000 +y_0=0 +ellps=GRS80",
    "+proj=merc +lon_0=10 +k=0.9 +x_0=1000 +y_0=2000 +a=3396190 +b=3376200",
    "+proj=merc +lat_ts=30 +lon_0=0 +datum=WGS84",
    "+proj=stere +lat_0=90 +lon_0=-45 +k=0.994 +x_0=2e6 +y_0=2e6 +datum=WGS84",
    "+proj=stere +lat_0=-90 +lat_ts=-71 +lon_0=0 +datum=WGS84",
    "+proj=sinu +lon_0=0 +x_0=0 +y_0=0 +a=3396190 +b=3376200",
    "+proj=lcc +lat_1=33 +lat_2=45 +lat_0=40 +lon_0=-97 +datum=NAD83",
    "+proj=eqc +lat_ts=30 +lat_0=0 +lon_0=0 +datum=WGS84",
    "+proj=ortho +lat_0=52 +lon_0=10 +datum=WGS84",
    "+proj=laea +lat_0=52 +lon_0=10 +x_0=4321000 +y_0=3210000 +ellps=GRS80",
    "+proj=gnom +lat_0=40 +lon_0=-100 +datum=WGS84",
    "+proj=longlat +a=1737400 +b=1737400 +no_defs",
]


def _same(d1, p1, d2, p2):
    """Datum and projection of the two packages agree."""
    assert type(p1).__name__ == type(p2).__name__
    assert p1.params() == p2.params()
    assert (d1.name, d1.spheroid_name, d1.a, d1.b, d1.meridian_offset) == \
        (d2.name, d2.spheroid_name, d2.a, d2.b, d2.meridian_offset)


@pytest.mark.parametrize("s", PROJ4, ids=[f"{s.split()[0][6:]}{i}" for i, s in enumerate(PROJ4)])
def test_crs_parsing_matches_jax(s):
    """``parse_proj4``, ``parse_wkt`` (of the emitted WKT) and the emitters
    give the JAX package's datum, projection and strings."""
    td, tp = tcrs.parse_proj4(s)
    jd, jp = jcrs.parse_proj4(s)
    _same(td, tp, jd, jp)
    assert tcrs.to_proj4(td, tp) == jcrs.to_proj4(jd, jp)
    assert tcrs.to_wkt(td, tp) == jcrs.to_wkt(jd, jp)
    assert tcrs.epsg_for(td, tp) == jcrs.epsg_for(jd, jp)
    _same(*tcrs.parse_wkt(tcrs.to_wkt(td, tp)), *jcrs.parse_wkt(jcrs.to_wkt(jd, jp)))


def test_from_epsg_matches_jax():
    for code in (4326, 4269, 4267, 3857, 32612, 32733, 32601, 32760, 3031, 3413,
                 26915, 104903):
        try:
            jd, jp = jcrs.from_epsg(code)
        except jcrs.UnsupportedCRSErr:
            with pytest.raises(tcrs.UnsupportedCRSErr):
                tcrs.from_epsg(code)
            continue
        _same(*tcrs.from_epsg(code), jd, jp)
        assert tgeo.GeoReference.from_epsg(code).proj4_str() == \
            jgeo.GeoReference.from_epsg(code).proj4_str()


def _georefs(geo, proj, datum):
    t = np.array([[30.0, 0.0, 400000.0], [0.0, -30.0, 5000000.0], [0.0, 0.0, 1.0]])
    d = datum.well_known_datum("WGS84")
    mars = datum.Datum("D_MARS", "MARS", "Greenwich", 3396190.0, 3376200.0)
    return [
        geo.GeoReference(d, proj.UTMProjection(d, 31, True), t),
        geo.GeoReference(d, proj.UTMProjection(d, 31, True), t, geo.PIXEL_AS_POINT),
        geo.GeoReference(mars, proj.StereographicProjection(mars, -90, 0, 0.97, 1e5, 2e5), t),
        geo.GeoReference(mars, proj.EquirectangularProjection(mars, 0, 180, 15, 0, 0),
                         np.array([[200.0, 0.0, -1e6], [0.0, -200.0, 5e5], [0, 0, 1]])),
        geo.make_geographic_georef(-105.5, 40.25, 0.001),
        geo.GeoReference(d, proj.LambertConformalProjection(d, 33, 45, 39, -96, 2e5, 1e5),
                         np.array([[25.0, 0.5, -2e5], [0.3, -25.0, 3e5], [0, 0, 1]])),
    ]


def test_georeference_matches_jax():
    """The pixel <-> projected affine exactly (fp32, one operation a step);
    lon/lat, boxes, geo keys and the CRS strings; the PDS label reader."""
    rng = np.random.default_rng(6)
    px = rng.uniform(-5, 300, 400)
    py = rng.uniform(-5, 300, 400)
    for jg, tg in zip(_georefs(jgeo, jproj, jdatum), _georefs(tgeo, tproj, tdatum)):
        for a, b in zip(jg.pixel_to_point(px, py), tg.pixel_to_point(px, py)):
            np.testing.assert_array_equal(_np(b), np.asarray(a))
        x, y = (np.asarray(v) for v in jg.pixel_to_point(px, py))
        for a, b in zip(jg.point_to_pixel(x, y), tg.point_to_pixel(x, y)):
            np.testing.assert_array_equal(_np(b), np.asarray(a))
        jl = [np.asarray(v) for v in jg.pixel_to_lonlat(px, py)]
        tl = [_np(v) for v in tg.pixel_to_lonlat(px, py)]
        np.testing.assert_allclose(tl[0], jl[0], rtol=0, atol=DEG)
        np.testing.assert_allclose(tl[1], jl[1], rtol=0, atol=DEG)
        jp = np.asarray(jg.lonlat_to_pixel(*jl))
        np.testing.assert_allclose(_np(torch.stack(tg.lonlat_to_pixel(*jl))), jp, atol=0.05)
        jb = jg.pixel_to_lonlat_bbox(jbbox.BBox2i(0, 0, 256, 200))
        tb = tg.pixel_to_lonlat_bbox(tbbox.BBox2i(0, 0, 256, 200))
        np.testing.assert_allclose([tb.min_x, tb.min_y, tb.max_x, tb.max_y],
                                   [jb.min_x, jb.min_y, jb.max_x, jb.max_y], atol=DEG)
        jb2 = jg.lonlat_to_pixel_bbox(jb)
        tb2 = tg.lonlat_to_pixel_bbox(tb)
        np.testing.assert_allclose([tb2.min_x, tb2.min_y, tb2.max_x, tb2.max_y],
                                   [jb2.min_x, jb2.min_y, jb2.max_x, jb2.max_y], atol=0.1)
        assert tg.geo_keys() == jg.geo_keys()
        assert (tg.proj4_str(), tg.wkt_str(), repr(tg)) == \
            (jg.proj4_str(), jg.wkt_str(), repr(jg))
    label = {"A_AXIS_RADIUS": "3396.19", "B_AXIS_RADIUS": "3376.2",
             "MAP_RESOLUTION": "128", "WESTERNMOST_LONGITUDE": "-10.5",
             "MAXIMUM_LATITUDE": "'20.25'", "MAP_PROJECTION_TYPE": '"SIMPLE CYLINDRICAL"'}
    jg, tg = jgeo.georeference_from_pds_label(label), tgeo.georeference_from_pds_label(label)
    np.testing.assert_array_equal(tg.transform, jg.transform)
    _same(tg.datum, tg.projection, jg.datum, jg.projection)
    assert tgeo.georeference_from_pds_label({**label, "MAP_PROJECTION_TYPE": "POLAR"}) is None


@pytest.mark.parametrize("case", range(6))
def test_geotiff_round_trip_with_jax(tmp_path, case):
    """A GeoTIFF written with the port's GeoReference through the port's
    ``write_tiff`` reads back through the JAX package's
    ``georeference_from_tiff_info``, and the reverse: transform, pixel
    interpretation, datum (axes and prime meridian; a user-defined datum's
    name is not in the keys) and projection equal both ways. The two
    writers' files are byte for byte the same."""
    tg = _georefs(tgeo, tproj, tdatum)[case]
    jg = _georefs(jgeo, jproj, jdatum)[case]
    img = np.random.default_rng(7).random((9, 13)).astype(np.float32)
    files = []
    for write, read, decode, g in (
            (ttiff.write_tiff, jtiff.read_tiff, jgeo.georeference_from_tiff_info, tg),
            (jtiff.write_tiff, ttiff.read_tiff, tgeo.georeference_from_tiff_info, jg)):
        path = str(tmp_path / f"t{len(files)}.tif")
        write(path, img, georef=g)
        with open(path, "rb") as f:
            files.append(f.read())
        data, info = read(path)
        np.testing.assert_array_equal(data, img)
        back = decode(info, strict=True)
        np.testing.assert_array_equal(back.transform, g.transform)
        assert back.pixel_interpretation == g.pixel_interpretation
        assert (back.datum.a, back.datum.b, back.datum.meridian_offset) == \
            (g.datum.a, g.datum.b, g.datum.meridian_offset)
        assert type(back.projection).__name__ == type(g.projection).__name__
        assert back.projection.params() == g.projection.params()
    assert files[0] == files[1]


def test_geotransform_and_reproject_image_match_jax():
    """Geographic -> UTM and back on a 48x56 patch near 12 E 47 N: the
    transform's points and boxes, and the reprojected images (the port
    evaluates the reverse map on the device, as the JAX package does)."""
    jgeo_g = jgeo.make_geographic_georef(11.9, 47.05, 0.002)
    tgeo_g = tgeo.make_geographic_georef(11.9, 47.05, 0.002)
    t = np.array([[150.0, 0, 716000.0], [0, -150.0, 5215000.0], [0, 0, 1]])
    dj, dt = jdatum.well_known_datum("WGS84"), tdatum.well_known_datum("WGS84")
    jutm = jgeo.GeoReference(dj, jproj.UTMProjection(dj, 32), t)
    tutm = tgeo.GeoReference(dt, tproj.UTMProjection(dt, 32), t)
    rng = np.random.default_rng(8)
    src = rng.random((48, 56)).astype(np.float32)
    px, py = rng.uniform(0, 50, 200), rng.uniform(0, 50, 200)
    for (js, jd), (ts, td) in (((jgeo_g, jutm), (tgeo_g, tutm)),
                               ((jutm, jgeo_g), (tutm, tgeo_g))):
        jx, tx = jgt.GeoTransform(js, jd), tgt.GeoTransform(ts, td)
        assert tx.same_datum == jx.same_datum
        for f, g in ((jx.forward, tx.forward), (jx.reverse, tx.reverse)):
            for a, b in zip(f(px, py), g(px, py)):
                np.testing.assert_allclose(_np(b), np.asarray(a), rtol=0, atol=0.02)
        for f, g in ((jx.forward_bbox, tx.forward_bbox), (jx.reverse_bbox, tx.reverse_bbox)):
            a, b = f(jbbox.BBox2i(0, 0, 56, 48)), g(tbbox.BBox2i(0, 0, 56, 48))
            np.testing.assert_allclose([b.min_x, b.min_y, b.max_x, b.max_y],
                                       [a.min_x, a.min_y, a.max_x, a.max_y], atol=0.02)
        # the reverse map of every output pixel: UTM metres in fp32 are
        # 0.5 m apart near 5e6 m, so an ulp of a projection moves a
        # coordinate by ~0.003 px of 150 m; a sample of [0, 1] noise moves
        # by at most twice that
        gy, gx = np.mgrid[0:44, 0:52].astype(np.float32)
        dc = max(np.abs(_np(b) - np.asarray(a)).max()
                 for a, b in zip(jx.reverse(gx, gy), tx.reverse(gx, gy)))
        assert dc <= 0.01
        for interp, edge in (("bilinear", "zero"), ("bicubic", "constant")):
            ref = np.asarray(jgt.reproject_image(jnp.asarray(src), js, jd, (44, 52), interp, edge))
            got = tgt.reproject_image(src, ts, td, (44, 52), interp, edge, device="cpu")
            np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2 * dc + 2e-5)


@pytest.mark.cuda
def test_projections_and_reprojection_card_match_cpu(cuda):
    """Card = CPU for every family (the card's transcendental functions
    round differently: the same tolerances as against the JAX package) and
    for ``reproject_image`` (the reverse maps within 0.01 px, the samples
    within twice that plus 2e-5, as against the JAX package)."""
    for family, (p, box) in _families(tproj, tdatum).items():
        lon, lat = _lonlat(box, 9, 500)
        cx, cy = p.forward(lon, lat)
        gx, gy = p.forward(torch.as_tensor(lon, device=cuda), torch.as_tensor(lat, device=cuda))
        scale = max(cx.abs().max().item(), cy.abs().max().item(), 1.0)
        for g, c in ((gx, cx), (gy, cy)):
            np.testing.assert_allclose(g.cpu().numpy(), c.numpy(), rtol=0, atol=FWD_REL * scale)
        for g, c in zip(p.reverse(gx, gy), p.reverse(gx.cpu(), gy.cpu())):
            np.testing.assert_allclose(g.cpu().numpy(), c.numpy(), rtol=0, atol=DEG)
    src = np.random.default_rng(10).random((48, 56)).astype(np.float32)
    g = tgeo.make_geographic_georef(11.9, 47.05, 0.002)
    d = tdatum.well_known_datum("WGS84")
    utm = tgeo.GeoReference(d, tproj.UTMProjection(d, 32),
                            np.array([[150.0, 0, 716000.0], [0, -150.0, 5215000.0], [0, 0, 1]]))
    gy, gx = np.mgrid[0:44, 0:52].astype(np.float32)
    tx = tgt.GeoTransform(g, utm)
    dc = max((a.cpu() - b).abs().max().item() for a, b in zip(
        tx.reverse(torch.as_tensor(gx, device=cuda), torch.as_tensor(gy, device=cuda)),
        tx.reverse(gx, gy)))
    assert dc <= 0.01
    np.testing.assert_allclose(
        tgt.reproject_image(src, g, utm, (44, 52), device=cuda).cpu().numpy(),
        tgt.reproject_image(src, g, utm, (44, 52), device="cpu").numpy(), rtol=0,
        atol=2 * dc + 2e-5)
