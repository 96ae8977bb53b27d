"""Port's host IO (``visionworkbench_torch/fileio/{raw, memory, disk_image,
manager, tiled_writer}`` and the native runtime ``visionworkbench_torch/
native``) against the JAX package's modules on the CPU, on the same seeded
inputs. Nothing here computes pixels: files, regions, tiles, tags and
counts are compared exactly (bit for bit, and byte for byte where both
packages wrote a file by the same route).
"""

import os
import random
import threading
import time

import numpy as np
import pytest

from torch_parity import _torch_threads  # noqa: F401
import visionworkbench_tpu.cartography.georeference as jgeo
import visionworkbench_tpu.fileio.disk_image as jdisk
import visionworkbench_tpu.fileio.manager as jman
import visionworkbench_tpu.fileio.memory as jmem
import visionworkbench_tpu.fileio.raw as jraw
import visionworkbench_tpu.fileio.tiff as jtiff
import visionworkbench_tpu.fileio.tiled_writer as jtw
import visionworkbench_tpu.math.bbox as jbbox
import visionworkbench_tpu.native as jnative
import visionworkbench_torch.cartography.georeference as tgeo
import visionworkbench_torch.fileio as tfileio
import visionworkbench_torch.fileio.disk_image as tdisk
import visionworkbench_torch.fileio.manager as tman
import visionworkbench_torch.fileio.memory as tmem
import visionworkbench_torch.fileio.raw as traw
import visionworkbench_torch.fileio.tiff as ttiff
import visionworkbench_torch.fileio.tiled_writer as ttw
import visionworkbench_torch.math.bbox as tbbox
import visionworkbench_torch.native as tnative

import visionworkbench_tpu.fileio as jfileio


def test_fileio_names():
    names = {n for n in dir(jfileio) if not n.startswith("_")
             and not isinstance(getattr(jfileio, n), type(os))}
    assert names <= set(dir(tfileio)), names - set(dir(tfileio))


def _boxes(mod):
    return [mod.BBox2i(0, 0, 37, 23), mod.BBox2i(5, 3, 20, 11), mod.BBox2i(36, 22, 1, 1),
            mod.BBox2i(0, 9, 37, 4)]


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float32])
def test_raw_files(tmp_path, dtype):
    """write_raw bytes, region reads and sub-region writes equal."""
    rng = np.random.default_rng(5)
    data = (rng.random((23, 37)) * 100).astype(dtype)
    jp, tp = str(tmp_path / "j.raw"), str(tmp_path / "t.raw")
    jf, tf = jraw.write_raw(jp, data), traw.write_raw(tp, data)
    assert open(jp, "rb").read() == open(tp, "rb").read()
    assert (tf.cols, tf.rows, tf.dtype, tf.offset, tf.cstride, tf.rstride) == \
        (jf.cols, jf.rows, jf.dtype, jf.offset, jf.cstride, jf.rstride)
    for jb, tb in zip(_boxes(jbbox), _boxes(tbbox)):
        got = traw.read_raw(tp, tf, tb)
        np.testing.assert_array_equal(got, jraw.read_raw(jp, jf, jb))
        np.testing.assert_array_equal(got, data[tb.slices()])
    patch = (rng.random((4, 6)) * 50).astype(dtype)
    with jraw.RawImageResource(jp, jf, "r+") as r:
        r.write(patch, jbbox.BBox2i(7, 2, 6, 4))
    with traw.RawImageResource(tp, tf, "r+") as r:
        r.write(patch, tbbox.BBox2i(7, 2, 6, 4))
        assert r.block_size == (37, 23) and r.shape == (23, 37)
    assert open(jp, "rb").read() == open(tp, "rb").read()
    from visionworkbench_torch.core.exceptions import IOErr
    with pytest.raises(IOErr):
        traw.read_raw(tp, tf, tbbox.BBox2i(30, 0, 8, 1))


DIM = """<?xml version="1.0"?>
<Dimap_Document><Raster_Dimensions>
  <NCOLS> 37 </NCOLS>
  <NROWS>23</NROWS>
  <NBANDS>1</NBANDS>
</Raster_Dimensions></Dimap_Document>
"""


@pytest.mark.parametrize("layout", ["same_stem", "front"])
def test_spot5_dim(tmp_path, layout):
    """SPOT5 sidecar discovery and the Raster_Dimensions parser equal."""
    data = np.random.default_rng(6).integers(0, 255, (23, 37)).astype(np.uint8)
    if layout == "same_stem":
        img = tmp_path / "scene.bil"
        (tmp_path / "scene.DIM").write_text(DIM)
    else:
        (tmp_path / "front").mkdir()
        img = tmp_path / "front" / "IMAGERY.BIL"
        (tmp_path / "front" / "METADATA_FRONT.DIM").write_text(DIM)
    data.tofile(img)
    jd, td = (jraw.find_associated_spot5_dim_file(str(img)),
              traw.find_associated_spot5_dim_file(str(img)))
    assert td == jd and td
    jf, tf = jraw.raw_format_from_spot5_dim(jd), traw.raw_format_from_spot5_dim(td)
    assert (tf.cols, tf.rows, tf.dtype) == (jf.cols, jf.rows, jf.dtype) == (37, 23, np.uint8)
    with traw.open_spot5(str(img)) as r:
        np.testing.assert_array_equal(r.read(), data)
    assert traw.find_associated_spot5_dim_file(str(tmp_path / "none.bil")) == ""


@pytest.mark.parametrize("kind", ["gray_f32", "gray_u8", "rgb_u8", "rgb_f32"])
def test_memory_codecs(kind):
    """PNG bytes equal; decoding equal, with and without a float dtype."""
    rng = np.random.default_rng(7)
    shape = (19, 23) if kind.startswith("gray") else (19, 23, 3)
    arr = rng.random(shape).astype(np.float32)
    if kind.endswith("u8"):
        arr = (arr * 255).astype(np.uint8)
    jb, tb = jmem.encode_image(arr), tmem.encode_image(arr)
    assert tb == jb
    for dtype in (None, np.float32):
        got = tmem.decode_image(tb, dtype)
        want = jmem.decode_image(jb, dtype)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int16, np.float32])
def test_pds_roundtrip(tmp_path, dtype):
    """write_pds bytes equal; read_pds arrays and labels equal."""
    arr = (np.random.default_rng(8).random((13, 17)) * 200).astype(dtype)
    jp, tp = str(tmp_path / "j.img"), str(tmp_path / "t.img")
    jmem.write_pds(jp, arr, {"TARGET_NAME": "MARS"})
    tmem.write_pds(tp, arr, {"TARGET_NAME": "MARS"})
    assert open(jp, "rb").read() == open(tp, "rb").read()
    (ga, gl), (wa, wl) = tmem.read_pds(tp), jmem.read_pds(jp)
    assert gl == wl and ga.dtype == wa.dtype
    np.testing.assert_array_equal(ga, wa)
    np.testing.assert_array_equal(ga, arr)
    assert tmem.parse_pds_label("A = 1 /* c */\n^IMAGE = 3\nB = \"x\"") == \
        jmem.parse_pds_label("A = 1 /* c */\n^IMAGE = 3\nB = \"x\"")


def _image_file(tmp_path, kind):
    """A file of ``kind`` written by the port's codec (the same bytes as
    the JAX package's copy)."""
    rng = np.random.default_rng(9)
    if kind == "png":
        path = str(tmp_path / "img.png")
        tmem_bytes = tmem.encode_image((rng.random((45, 70)) * 255).astype(np.uint8))
        with open(path, "wb") as f:
            f.write(tmem_bytes)
        return path
    path = str(tmp_path / f"{kind}.tif")
    if kind == "uint16":
        ttiff.write_tiff(path, (rng.random((45, 70)) * 65535).astype(np.uint16), tile_size=32)
    elif kind == "stripped":
        ttiff.write_tiff(path, rng.random((45, 70)).astype(np.float32))
    elif kind == "multiband":
        ttiff.write_tiff(path, rng.random((45, 70, 3)).astype(np.float32), tile_size=16)
    else:
        ttiff.write_tiff(path, rng.random((45, 70)).astype(np.float32), tile_size=32)
    return path


@pytest.mark.parametrize("kind", ["tiled", "stripped", "uint16", "multiband", "png"])
@pytest.mark.parametrize("tile", [16, 48])
def test_disk_image_view_regions(tmp_path, kind, tile):
    """Regions of every file kind equal to the JAX package's view (integer
    files read as float32 normalized by the dtype's max)."""
    path = _image_file(tmp_path, kind)
    jv, tv = jdisk.DiskImageView(path, tile_size=tile), tdisk.DiskImageView(path, tile_size=tile)
    assert (tv.rows, tv.cols, tv.bands, tv.nodata, tv.shape) == \
        (jv.rows, jv.cols, jv.bands, jv.nodata, jv.shape)
    boxes = [(0, 0, 70, 45), (3, 5, 30, 17), (47, 31, 23, 14), (69, 44, 1, 1)]
    for b in boxes:
        got = tv.read_region(tbbox.BBox2i(*b))
        want = jv.read_region(jbbox.BBox2i(*b))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tv.read(), jv.read())
    from visionworkbench_torch.core.exceptions import ArgumentErr
    with pytest.raises(ArgumentErr):
        tv.read_region(tbbox.BBox2i(60, 0, 11, 1))


def test_disk_image_view_reads_a_rewritten_file(tmp_path):
    """Tiles are cached under the file's identity: a view made after the
    file is rewritten at the same path reads the new pixels."""
    path = str(tmp_path / "x.tif")
    ttiff.write_tiff(path, np.zeros((40, 40), np.float32), tile_size=16)
    assert tdisk.DiskImageView(path, tile_size=16).read().max() == 0
    time.sleep(0.01)
    ttiff.write_tiff(path, np.ones((40, 41), np.float32), tile_size=16)
    assert tdisk.DiskImageView(path, tile_size=16).read().min() == 1


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_disk_cache_image_view(tmp_path, dtype):
    arr = (np.random.default_rng(10).random((40, 52)) * 200).astype(dtype)
    jv = jdisk.DiskCacheImageView(arr, tile_size=16, tmp_dir=str(tmp_path))
    tv = tdisk.DiskCacheImageView(arr, tile_size=16, tmp_dir=str(tmp_path))
    for b in [(5, 5, 20, 20), (0, 0, 52, 40), (40, 30, 12, 10)]:
        got = tv.read_region(tbbox.BBox2i(*b))
        np.testing.assert_array_equal(got, jv.read_region(jbbox.BBox2i(*b)))
        np.testing.assert_array_equal(got, arr[b[1]:b[1] + b[3], b[0]:b[0] + b[2]])
    path = tv.path
    del tv
    assert not os.path.exists(path)


def test_disk_image_manager(tmp_path):
    """The same open views and evictions over one access sequence."""
    paths = []
    for i in range(4):
        p = str(tmp_path / f"m{i}.tif")
        ttiff.write_tiff(p, np.full((20, 20), i, np.float32), tile_size=16)
        paths.append(p)
    jm, tm = jman.DiskImageManager(max_open=2, tile_size=16), \
        tman.DiskImageManager(max_open=2, tile_size=16)
    seq = [0, 1, 0, 2, 1, 3, 3, 0]
    for i in seq:
        jv, tv = jm.get(paths[i]), tm.get(paths[i])
        assert (len(tm), tm.evictions) == (len(jm), jm.evictions)
        assert list(tm._views) == list(jm._views)
        np.testing.assert_array_equal(tv.read(), jv.read())
    assert tm.evictions == 4


def _tiles(h, w, bands, seed=11):
    rng = np.random.default_rng(seed)
    shape = (h, w) if bands == 1 else (h, w, bands)
    return rng.random(shape).astype(np.float32)


def _tile_fn(full, seed=12, fail_at=None):
    """Tiles of ``full`` that finish out of raster order (seeded delays)."""
    rng = random.Random(seed)
    delays = {}

    def tile_fn(bbox):
        key = (bbox.min_x, bbox.min_y)
        if fail_at is not None and key == fail_at:
            raise RuntimeError(f"tile {key} failed")
        time.sleep(delays.setdefault(key, rng.random() * 0.004))
        return full[bbox.min_y:bbox.max_y, bbox.min_x:bbox.max_x]
    return tile_fn


def _tags(path):
    info = ttiff.TiffInfo(path)
    return (info.width, info.height, info.bands, info.tiled, info.tile_size,
            info.compression, info.nodata)


# 70 x 100 at tile 32: 12 tiles, under the JAX package's native window of
# 21 waiting tiles (its native writer can deadlock past that; the port's
# cannot, test_native_writer_many_tiles_and_errors).
@pytest.mark.parametrize("route", ["native", "python"])
@pytest.mark.parametrize("bands", [1, 3])
def test_block_write_image_matches(tmp_path, route, bands):
    """Both packages write the same pixels and tags; where both took the
    same route (the JAX package falls back to its Python route when its own
    native build fails), the same bytes."""
    h, w = 70, 100
    full = _tiles(h, w, bands)
    geo = dict(georef=None, nodata=None)
    jgeo_kw, tgeo_kw = dict(geo), dict(geo)
    if route == "python":
        jgeo_kw = dict(georef=jgeo.make_geographic_georef(-120.0, 40.0, 0.001), nodata=-1.0)
        tgeo_kw = dict(georef=tgeo.make_geographic_georef(-120.0, 40.0, 0.001), nodata=-1.0)
    jp, tp = str(tmp_path / "j.tif"), str(tmp_path / "t.tif")
    jax_native = route == "native" and jnative.available()
    jtw.block_write_image(jp, h, w, bands, np.float32, _tile_fn(full), tile_size=32,
                          num_threads=4, **jgeo_kw)
    ttw.block_write_image(tp, h, w, bands, np.float32, _tile_fn(full), tile_size=32,
                          num_threads=4, **tgeo_kw)
    got, ginfo = ttiff.read_tiff(tp)
    want, winfo = jtiff.read_tiff(jp)
    np.testing.assert_array_equal(got, full)
    np.testing.assert_array_equal(got, want)
    assert _tags(tp) == _tags(jp)
    if route == "python":
        back = tgeo.georeference_from_tiff_info(ginfo)
        np.testing.assert_array_equal(back.transform, tgeo_kw["georef"].transform)
    if route == "python" or jax_native:
        assert open(tp, "rb").read() == open(jp, "rb").read()


@pytest.mark.parametrize("route", ["native", "python"])
def test_block_write_image_error(tmp_path, route):
    """An error in ``tile_fn`` reaches the caller on both routes, in both
    packages."""
    h, w = 70, 100
    full = _tiles(h, w, 1)
    kw = {} if route == "native" else {"nodata": -1.0}
    for mod, name in ((jtw, "j.tif"), (ttw, "t.tif")):
        with pytest.raises(RuntimeError, match=r"tile \(32, 32\) failed"):
            mod.block_write_image(str(tmp_path / name), h, w, 1, np.float32,
                                  _tile_fn(full, fail_at=(32, 32)), tile_size=32, **kw)


def test_resume_completed_tiles(tmp_path):
    """A partial file (Python route, ``tile_fn`` raising part-way): the
    resume set names exactly the tiles on disk, and the JAX package's
    function gives the same sets on the same files."""
    h, w, ts = 96, 160, 16
    full = _tiles(h, w, 1)
    path = str(tmp_path / "partial.tif")
    with pytest.raises(RuntimeError):
        ttw.block_write_image(path, h, w, 1, np.float32, _tile_fn(full, fail_at=(48, 32)),
                              tile_size=ts, num_threads=4, nodata=-1.0)
    done = ttw.resume_completed_tiles(path, ts)
    assert done == jtw.resume_completed_tiles(path, ts)
    ntx = w // ts
    first_missing = 2 * ntx + 3
    # a raster prefix, stopped at the failed tile
    assert done == {(i % ntx, i // ntx) for i in range(len(done))}
    assert len(done) <= first_missing
    for tx, ty in done:
        np.testing.assert_array_equal(
            ttiff.read_tiff_region(path, tx * ts, ty * ts, ts, ts),
            full[ty * ts:(ty + 1) * ts, tx * ts:(tx + 1) * ts])
    complete = str(tmp_path / "complete.tif")
    ttw.block_write_image(complete, h, w, 1, np.float32, _tile_fn(full), tile_size=ts)
    assert ttw.resume_completed_tiles(complete, ts) == \
        {(x, y) for x in range(ntx) for y in range(h // ts)}
    failed_native = str(tmp_path / "failed_native.tif")    # no IFD is written
    with pytest.raises(RuntimeError):
        ttw.block_write_image(failed_native, h, w, 1, np.float32,
                              _tile_fn(full, fail_at=(48, 32)), tile_size=ts)
    assert ttw.resume_completed_tiles(failed_native, ts) == set()
    for p, t in ((complete, 32), (str(tmp_path / "absent.tif"), ts)):
        assert ttw.resume_completed_tiles(p, t) == jtw.resume_completed_tiles(p, t) == set()


def _in_thread(fn, timeout=60):
    """Run ``fn`` in a thread; fail if it has not ended after ``timeout``."""
    out = {}

    def run():
        try:
            fn()
        except BaseException as e:  # handed to the test below
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), "the writer did not finish (deadlock)"
    return out.get("error")


@pytest.mark.parametrize("fail_at", [None, (16, 0), (240, 224)], ids=["ok", "early", "late"])
def test_native_writer_many_tiles_and_errors(tmp_path, fail_at):
    """Many more tiles than the window, 8 threads, tiles finishing out of
    order under a short switch interval: the native route ends (no
    deadlock), writes every pixel, and an error part-way reaches the
    caller."""
    import sys
    h, w, ts = 256, 320, 16
    full = _tiles(h, w, 1)
    path = str(tmp_path / "many.tif")
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        err = _in_thread(lambda: ttw.block_write_image(
            path, h, w, 1, np.float32, _tile_fn(full, seed=13, fail_at=fail_at),
            tile_size=ts, num_threads=8))
    finally:
        sys.setswitchinterval(prev)
    if fail_at is None:
        assert err is None
        np.testing.assert_array_equal(ttiff.read_tiff(path)[0], full)
    else:
        assert isinstance(err, RuntimeError) and "failed" in str(err)


def test_native_writer_and_cache_match(tmp_path):
    """The port's NativeTileWriter (tiles submitted out of order) writes the
    bytes of the JAX package's; NativeLruCache counts the same."""
    h, w, ts = 100, 130, 32
    full = np.arange(h * w, dtype=np.float32).reshape(h, w)
    tp = str(tmp_path / "t.tif")
    wr = tnative.NativeTileWriter(tp, h, w, 1, np.float32, ts)
    order = [(tx, ty) for ty in range(wr.nty) for tx in range(wr.ntx)]
    random.Random(0).shuffle(order)
    for tx, ty in order:
        wr.write_tile(tx, ty, full[ty * ts:(ty + 1) * ts, tx * ts:(tx + 1) * ts])
    wr.close()
    np.testing.assert_array_equal(ttiff.read_tiff(tp)[0], full)
    ops = [("put", "a", 400), ("put", "b", 400), ("get", "a"), ("put", "c", 400),
           ("get", "b"), ("get", "c"), ("put", "a", 900), ("get", "zzz")]

    def run(mod):
        c, log = mod.NativeLruCache(1000), []
        for op in ops:
            if op[0] == "put":
                c.put(op[1], op[1].encode() * op[2])
            else:
                v = c.get(op[1])
                log.append(None if v is None else len(v))
            log.append(tuple(sorted(c.stats().items())))
        return log

    if jnative.available():
        jp = str(tmp_path / "j.tif")
        with jnative.NativeTileWriter(jp, h, w, 1, np.float32, ts) as jw:
            for tx, ty in order:
                jw.write_tile(tx, ty, full[ty * ts:(ty + 1) * ts, tx * ts:(tx + 1) * ts])
        assert open(tp, "rb").read() == open(jp, "rb").read()
        assert run(tnative) == run(jnative)
    else:
        assert run(tnative)[-1] == (("evictions", 3), ("hits", 4), ("misses", 2),
                                    ("used", 900))


def _listing(folder):
    return {f: os.stat(os.path.join(folder, f)).st_mtime_ns for f in os.listdir(folder)}


def test_native_build_goes_to_build_dir(tmp_path, monkeypatch):
    """The runtime is built from the port's own source into
    ``visionworkbench_torch/_build`` (by default; here a fresh directory in
    its place), named by a hash of source and flags, through a temporary
    name; nothing is written beside either package's native source."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(tnative.__file__)))
    assert str(tnative.BUILD_DIR) == os.path.join(pkg, "_build")
    assert str(tnative.SOURCE) == os.path.join(pkg, "native", "vwtpu_runtime.cpp")
    assert tnative.library_path().parent == tnative.BUILD_DIR
    jdir = os.path.dirname(os.path.abspath(jnative.__file__))
    before = (_listing(jdir), _listing(os.path.dirname(str(tnative.SOURCE))))
    fresh = tmp_path / "_build"
    monkeypatch.setattr(tnative, "BUILD_DIR", fresh)
    monkeypatch.setattr(tnative, "_lib", None)
    lib = tnative.load()
    built = tnative.library_path()
    assert lib._name == str(built) and built.parent == fresh
    assert os.listdir(fresh) == [built.name]
    assert built.name.startswith("libvwtpu_runtime-") and built.suffix == ".so"
    assert tnative.available() is True
    after = (_listing(jdir), _listing(os.path.dirname(str(tnative.SOURCE))))
    assert after == before


@pytest.mark.parametrize("how", ["no_compiler", "failing_compiler"])
def test_native_build_failure_raises(tmp_path, monkeypatch, how):
    """With g++ unreachable, or failing, on a fresh build directory, the
    runtime does not load: ``load``, ``available`` and the writer's native
    route raise; nothing falls back to the Python writer."""
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(tnative, "_lib", None)
    if how == "no_compiler":
        empty = tmp_path / "empty_path"
        empty.mkdir()
        monkeypatch.setenv("PATH", str(empty))
        match = "not found"
    else:
        monkeypatch.setattr(tnative, "CXX", "false")
        match = "build failed"
    with pytest.raises(RuntimeError, match=match):
        tnative.load()
    with pytest.raises(RuntimeError, match=match):
        tnative.available()
    out = str(tmp_path / "never.tif")
    with pytest.raises(RuntimeError, match=match):
        ttw.block_write_image(out, 40, 40, 1, np.float32,
                              lambda b: np.zeros((b.height, b.width), np.float32),
                              tile_size=16)
    assert not os.path.exists(out)
    assert not list((tmp_path / "_build").glob("*.so"))
