"""The port's geometry (``visionworkbench_torch/geometry/``), control networks
(``ba/control_network.py``), ``cartography/{chipper, shapefile}`` and
``version`` against the JAX package on the CPU: the same results, and
written files (poly files, point lists, shapefiles, binary control
networks) byte for byte the JAX package's.

``build_control_network``: the network's structure (points, their
measures, image ids, order) equal to the JAX package's; the positions
within 0.6 m of the float64 oracle of ``stereo_dem_scene.triangulate64``
(the port's float64 intersection of fp32 rays; ``ROADMAP.md`` section 3),
and within that plus the JAX package's own distance to the oracle of its
positions; points of nearly parallel rays dropped in both.
"""

import numpy as np
import pytest

from torch_parity import _torch_threads  # noqa: F401
import stereo_dem_scene as sds
import visionworkbench_tpu.ba.control_network as jcn
import visionworkbench_tpu.cartography.chipper as jchip
import visionworkbench_tpu.cartography.shapefile as jshp
import visionworkbench_tpu.geometry.frame_tree as jft
import visionworkbench_tpu.geometry.polygon as jpoly
import visionworkbench_tpu.geometry.spatial_tree as jst
import visionworkbench_torch.ba.control_network as tcn
import visionworkbench_torch.cartography.chipper as tchip
import visionworkbench_torch.cartography.shapefile as tshp
import visionworkbench_torch.geometry.frame_tree as tft
import visionworkbench_torch.geometry.polygon as tpoly
import visionworkbench_torch.geometry.spatial_tree as tst
from visionworkbench_tpu.math.bbox import BBox2 as JBox
from visionworkbench_torch.math.bbox import BBox2 as TBox

POINT_M = sds.DEM_POINT_M


def _rings(seed, count=3):
    """Star-shaped rings around random centres (one reversed: a hole's
    winding)."""
    rng = np.random.default_rng(seed)
    rings = []
    for k in range(count):
        c = rng.uniform(-20, 20, 2)
        t = np.sort(rng.uniform(0, 2 * np.pi, rng.integers(5, 12)))
        r = rng.uniform(3, 9, t.size)
        ring = np.stack([c[0] + r * np.cos(t), c[1] + r * np.sin(t)], -1)
        rings.append(ring[::-1] if k == 1 else ring)
    return rings


def _poly(mod, seed):
    p = mod.Polygon()
    for i, r in enumerate(_rings(seed)):
        p.append_ring(r, closed=i != 2, color=("red", "green", "blue")[i], layer=f"L{i}")
    p.annotations.append(mod.Anno(1.5, -2.5, "a"))
    return p


def _same(a, b):
    """Deep equality of polygon query results (tuples, arrays, floats)."""
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b or (a != a and b != b)


def _state(p):
    return (p.rings, p.closed, p.colors, p.layers, [tuple(a) for a in p.annotations],
            [tuple(a) for a in p.vert_index_annos], [tuple(a) for a in p.poly_index_annos],
            [tuple(a) for a in p.layer_annos])


@pytest.mark.parametrize("seed", [0, 1])
def test_polygon_matches_jax(seed):
    jp, tp = _poly(jpoly, seed), _poly(tpoly, seed)
    assert tp.area() == jp.area() and tp.total_num_verts() == jp.total_num_verts()
    jb, tb = jp.bbox(), tp.bbox()
    assert (tb.min_x, tb.min_y, tb.max_x, tb.max_y) == (jb.min_x, jb.min_y, jb.max_x, jb.max_y)
    ys, xs = np.mgrid[-30:30:0.7, -30:30:0.7]
    assert np.array_equal(tp.contains(xs, ys), jp.contains(xs, ys))
    box = (-5.0, -8.0, 15.0, 20.0)
    assert _same(tp.clip_to_box(TBox(*box)).rings, jp.clip_to_box(JBox(*box)).rings)
    for x, y in ((0.3, -0.2), (12.0, 7.5), (-25.0, 30.0)):
        assert _same(tp.find_closest_poly_vertex(x, y), jp.find_closest_poly_vertex(x, y))
        assert _same(tp.find_closest_poly_edge(x, y), jp.find_closest_poly_edge(x, y))
        assert _same(tp.find_closest_annotation(x, y), jp.find_closest_annotation(x, y))
    assert tp.mark_polys_intersecting_box(-5, -5, 5, 5) == jp.mark_polys_intersecting_box(-5, -5,
                                                                                          5, 5)
    assert tp.is_xy_rect() == jp.is_xy_rect()
    for p in (jp, tp):
        p.comp_vert_index_anno()
        p.comp_poly_index_anno()
        p.comp_layer_anno()
        p.rotate(90)
        p.rotate(33.0)
        p.scale(1.7)
        p.apply_transform_around_bdbox_center(1.0, 0.2, -0.1, 0.9)
        p.shift(3.0, -4.0)
        p.append_polygons(p.translate(1.0, 1.0))
        p.set_color("white")
        p.erase_polys_intersecting_box(0, 0, 2, 2)
        if p.num_rings() > 1:
            p.erase_one_poly(1)
    assert _same(_state(tp), _state(jp))
    jr, tr = jpoly.Polygon(), tpoly.Polygon()
    for p in (jr, tr):
        p.set_rectangle(1, 2, 5, 7)
    assert tr.is_xy_rect() and jr.is_xy_rect()
    assert tpoly.poly_in_poly(tr, tp) == jpoly.poly_in_poly(jr, jp)
    for args in ((0, 0, 4, 4, 0, 4, 4, 0), (0, 0, 2, 0, 1, 0, 3, 0), (0, 0, 1, 1, 2, 2, 3, 3)):
        assert tpoly.segment_intersection(*args) == jpoly.segment_intersection(*args)


def test_poly_and_point_files_byte_equal(tmp_path):
    jp, tp = _poly(jpoly, 3), _poly(tpoly, 3)
    jpoly.write_poly_file(str(tmp_path / "j.poly"), jp)
    tpoly.write_poly_file(str(tmp_path / "t.poly"), tp)
    assert (tmp_path / "t.poly").read_bytes() == (tmp_path / "j.poly").read_bytes()
    assert _same(tpoly.read_poly_file(str(tmp_path / "j.poly")).rings,
                 jpoly.read_poly_file(str(tmp_path / "j.poly")).rings)
    pts = np.random.default_rng(4).normal(size=(20, 3))
    jpoly.write_point_list(str(tmp_path / "j.txt"), pts)
    tpoly.write_point_list(str(tmp_path / "t.txt"), pts)
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    assert np.array_equal(tpoly.read_point_list(str(tmp_path / "j.txt")), pts)


def test_spatial_tree_matches_jax():
    rng = np.random.default_rng(5)
    world = (0.0, 0.0, 100.0, 100.0)
    trees = {"j": jst.SpatialTree(JBox(*world)), "t": tst.SpatialTree(TBox(*world))}
    boxes = [(float(x), float(y), float(w), float(h)) for x, y, w, h in
             zip(*rng.uniform(0, 90, (2, 200)), *rng.uniform(0.5, 10, (2, 200)))]
    for i, b in enumerate(boxes):
        trees["j"].insert(JBox(*b), i)
        trees["t"].insert(TBox(*b), i)
    assert len(trees["t"]) == len(trees["j"]) == 200
    for x, y in rng.uniform(0, 100, (20, 2)):
        assert trees["t"].query_point(x, y) == trees["j"].query_point(x, y)
    for q in ((10, 10, 20, 5), (50, 0, 1, 100), (0, 0, 100, 100)):
        assert trees["t"].query_box(TBox(*q)) == trees["j"].query_box(JBox(*q))
    assert trees["t"].overlap_pairs() == trees["j"].overlap_pairs()


def test_frame_store_matches_jax():
    k = np.array([0.3, -0.2, 0.9])
    a = np.linalg.norm(k)
    kx = np.cross(np.eye(3), k / a)            # the axis's cross-product matrix
    rot = np.eye(3) + np.sin(a) * kx + (1 - np.cos(a)) * kx @ kx
    out = {}
    for tag, mod in (("j", jft), ("t", tft)):
        fs = mod.FrameStore()
        fs.add("world")
        fs.add("body", "world", mod.ATrans(rot, (1.0, 2.0, 3.0)))
        fs.add("camera", "body", mod.ATrans(rot.T, (0.0, -0.5, 0.25)))
        fs.add("arm", "world", mod.ATrans(np.eye(3), (5.0, 0.0, 0.0)))
        fs.set_transform("arm", mod.ATrans(rot @ rot, (5.0, 1.0, 0.0)))
        t = fs.transform_between("camera", "arm")
        out[tag] = (fs.frame_names(), t.rotation, t.translation,
                    t.apply(np.arange(12.0).reshape(4, 3)), fs.to_world("camera").inverse().rotation)
    assert _same(out["t"], out["j"])


def test_chipper_matches_jax():
    pts = np.random.default_rng(6).random((3000, 3)) * [100.0, 40.0, 1.0]
    jchips, tchips = jchip.chip_points(pts, 128), tchip.chip_points(pts, 128)
    assert _same(tchips, jchips)
    assert tchip.chip_bounds(pts, tchips) == jchip.chip_bounds(pts, jchips)


def test_shapefile_byte_equal(tmp_path):
    for stype in (jshp.SHP_POLYGON, jshp.SHP_POLYLINE):
        files = {}
        for tag, mod, poly in (("j", jshp, jpoly), ("t", tshp, tpoly)):
            base = tmp_path / f"{tag}{stype}"
            mod.write_shapefile(str(base) + ".shp", [_poly(poly, 7), _poly(poly, 8)], stype)
            files[tag] = [(tmp_path / f"{tag}{stype}{ext}").read_bytes()
                          for ext in (".shp", ".shx", ".dbf")]
        assert files["t"] == files["j"]
        jb, js = jshp.read_shapefile(str(tmp_path / f"j{stype}.shp"))
        tb, ts = tshp.read_shapefile(str(tmp_path / f"j{stype}.shp"))
        assert ts == js == stype and _same([p.rings for p in tb], [p.rings for p in jb])


def _network(mod, seed=9):
    rng = np.random.default_rng(seed)
    cn = mod.ControlNetwork("net")
    cn.image_names = ["a.tif", "b.tif", "c.tif"]
    for k in range(6):
        p = mod.ControlPoint(mod.ControlPoint.GroundControlPoint if k % 3 == 0
                             else mod.ControlPoint.TiePoint)
        p.position = rng.normal(size=3) * 1e3
        p.sigma = rng.uniform(0.1, 2, 3)
        for img in range(1 + k % 3):
            p.add_measure(mod.ControlMeasure(*rng.uniform(0, 500, 2), *rng.uniform(0.5, 1, 2),
                                             image_id=img))
        cn.add_point(p)
    return cn


def test_control_network_io_byte_equal(tmp_path):
    _network(jcn).write_binary(str(tmp_path / "j.cnet"))
    _network(tcn).write_binary(str(tmp_path / "t.cnet"))
    assert (tmp_path / "t.cnet").read_bytes() == (tmp_path / "j.cnet").read_bytes()
    jb = jcn.ControlNetwork.read_binary(str(tmp_path / "j.cnet"))
    tb = tcn.ControlNetwork.read_binary(str(tmp_path / "j.cnet"))
    assert tb.image_names == jb.image_names and len(tb) == len(jb)
    assert tb.num_measures() == jb.num_measures()
    for tp, jp in zip(tb.points, jb.points):
        assert tp.type == jp.type and np.array_equal(tp.position, jp.position)
        assert [repr(m) for m in tp.measures] == [repr(m) for m in jp.measures]
    with pytest.raises(tcn.IOErr):
        (tmp_path / "bad.cnet").write_bytes(b"not a network")
        tcn.ControlNetwork.read_binary(str(tmp_path / "bad.cnet"))
    jg = jcn.CameraRelationNetwork.from_control_network(jb)
    tg = tcn.CameraRelationNetwork.from_control_network(tb)
    assert tg.pairs() == jg.pairs()
    assert [tg.neighbors(i) for i in range(3)] == [jg.neighbors(i) for i in range(3)]


def _cameras():
    """Three distortion-free pinholes 1000 m up at stereo-dem's place (the
    JAX package's and the port's), 30 m apart; and ground points."""
    import visionworkbench_tpu.camera as jcam
    import visionworkbench_torch.camera as tcam
    sc = sds.scene(64)
    left, right = sds.rectify(sc)
    third_c = np.float32(left.C + 2 * (right.C - left.C))
    ports = [left, right, tcam.PinholeModel(third_c.astype(np.float64), right.R,
                                            (right.fu, right.fv), (right.cu, right.cv))]
    jaxs = [jcam.PinholeModel(c.C, c.R, (c.fu, c.fv), (c.cu, c.cv)) for c in ports]
    centre = 0.5 * (left.C + right.C)
    down = -centre / np.linalg.norm(centre)
    rng = np.random.default_rng(12)
    ground = centre + down * rng.uniform(900, 1100, (44, 1)) + rng.normal(0, 60, (44, 3))
    return ports, jaxs, ground


def test_build_control_network_matches_jax_and_float64():
    ports, jaxs, ground = _cameras()
    pix = [sds.project64(c, ground[:40]) for c in ports]
    far = ground[40:] + 1e9 * (ground[40:] - ports[0].C)   # seen along parallel rays
    matches = {(0, 1): (pix[0][:30], pix[1][:30]),        # two-image points
               (1, 2): (pix[1][20:], pix[2][20:]),        # chains 20-29 across three
               (0, 2): (sds.project64(ports[0], far), sds.project64(ports[2], far))}
    want = jcn.build_control_network(["a", "b", "c"], jaxs, matches)
    got = tcn.build_control_network(["a", "b", "c"], ports, matches, device="cpu")
    assert got.image_names == want.image_names and len(got) == len(want)
    assert [[(m.image_id, m.col, m.row) for m in p.measures] for p in got.points] == \
        [[(m.image_id, m.col, m.row) for m in p.measures] for p in want.points]
    assert len(got) == 40          # the four far points are dropped (parallel rays)
    assert {len(p.measures) for p in got.points} == {2, 3}
    pos = np.stack([p.position for p in got.points])
    jpos = np.stack([p.position for p in want.points])
    oracle = np.stack([sds.triangulate64(ports[p.measures[0].image_id],
                                         ports[p.measures[1].image_id],
                                         np.array(p.measures[0].position()),
                                         np.array(p.measures[1].position()))
                       for p in got.points])
    err = np.linalg.norm(pos - oracle, axis=-1)
    jerr = np.linalg.norm(jpos - oracle, axis=-1)
    assert err.max() <= POINT_M
    assert (np.linalg.norm(pos - jpos, axis=-1) <= jerr + POINT_M).all()


def test_version_and_exports():
    import visionworkbench_torch
    from visionworkbench_torch.version import __version__
    assert visionworkbench_torch.__version__ is __version__
    from visionworkbench_torch.ba import build_control_network
    from visionworkbench_torch.cartography import read_shapefile, write_shapefile
    from visionworkbench_torch.geometry import FrameStore, Polygon, SpatialTree
    assert build_control_network is tcn.build_control_network
    assert (read_shapefile, write_shapefile) == (tshp.read_shapefile, tshp.write_shapefile)
    assert (FrameStore, Polygon, SpatialTree) == (tft.FrameStore, tpoly.Polygon,
                                                 tst.SpatialTree)
