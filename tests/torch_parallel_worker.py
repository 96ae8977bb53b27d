"""One rank of a ``torch.distributed`` gloo world for
``tests/test_torch_parallel.py`` (not collected by pytest: its name does not
start with ``test_``). It imports only ``torch``, numpy and the port.

    python tests/torch_parallel_worker.py <rank> <world> <out_dir> <init_file>

The rank joins the world through a ``file://`` rendezvous on
``init_file``, runs every case of :data:`CASES` meant for its world size
through the port's ``parallel/`` on the CPU, and writes one
``<case>_w<world>_r<rank>.npz`` a case into ``out_dir``. At its end it
asserts that neither ``jax`` nor ``visionworkbench_tpu`` was imported, and
prints ``WORKER_PASS``.

The cases' inputs come from the functions below (seeded numpy), which the
test imports to run the references on the same inputs.
"""

import os
import sys
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from visionworkbench_torch.cartography.georeference import GeoReference
from visionworkbench_torch.image.filters import gaussian_filter
from visionworkbench_torch.math.bbox import BBox2i
from visionworkbench_torch.mosaic.geomosaic import reproject_mosaic
from visionworkbench_torch.parallel import (
    DISP_AXIS, TILE_AXIS, disparity_sharded_search, halo_exchange_rows,
    hierarchical_sharded_correlate, make_disp_mesh, make_tile_disp_mesh,
    make_tile_mesh, map_overlap, row_sharding, sharded_pyramid_correlate,
)

# halo depths (top, bottom): shallow (single hop) and deep (all-gather)
HALO_BAND = 8
HALOS = {"shallow": (3, 5), "deep": (10, 13), "one_side": (0, 7)}


def quantized(rng, shape):
    """fp32 image on the 1/256 grid (``tests/torch_parity.py``)."""
    return (rng.integers(0, 256, shape) / 256.0).astype(np.float32)


def halo_frames(world, seed=3):
    """The full frames the halo cases shard: float, int32 and bool."""
    rng = np.random.default_rng(seed)
    h = HALO_BAND * world
    return {"float32": rng.random((h, 5)).astype(np.float32),
            "int32": rng.integers(-99, 99, (h, 5, 2)).astype(np.int32),
            "bool": rng.random((h, 5)) < 0.5}


def gaussian_image(seed=42):
    return np.random.default_rng(seed).standard_normal((64, 32)).astype(np.float32)


def disp_search_inputs(cost, seed=5):
    """``tests/test_parallel.py:38-51``'s shape on quantized inputs:
    ``(left, right, search_volume, kernel_size)``; ``flat``: all zeros."""
    h, w, sx, sy = 30, 28, 5, 8
    if cost == "flat":
        return (np.zeros((16, 16), np.float32), np.zeros((23, 20), np.float32),
                (5, 8), (5, 5))
    rng = np.random.default_rng(seed)
    return quantized(rng, (h, w)), quantized(rng, (h + sy - 1, w + sx - 1)), (sx, sy), (5, 5)


def _texture_pair(h, w, shift, seed, freq=(0.33, 0.27), extra=8):
    """``tests/test_parallel.py``'s textured pair: left(p) == right(p - shift)."""
    rng = np.random.default_rng(seed)
    sx, sy = 8, 3
    ys, xs = np.mgrid[0:h + sy + extra, 0:w + sx + extra].astype(np.float32)
    tex = (np.sin(xs * freq[0]) * np.cos(ys * freq[1])
           + 0.4 * rng.random(xs.shape)).astype(np.float32)
    return tex[:h, :w].copy(), tex[shift[1]:shift[1] + h, shift[0]:shift[0] + w].copy()


def hier_case(name):
    """``(left, right, search_region, kwargs, true_shift)`` of a
    hierarchical case; kwargs go to both ``hierarchical_sharded_correlate``
    and ``pyramid_correlate`` (``left_mask``/``right_mask`` included)."""
    if name == "bm_jax":
        # __graft_entry__.dryrun_multichip's 1b recipe cut to 128 x 48 and 2
        # levels, on a quantized texture: d = (4, -1)
        h, w = 128, 48
        tex = quantized(np.random.default_rng(0), (h + 8, w + 16))
        left, right = tex[:h, 4:4 + w].copy(), tex[1:1 + h, :w].copy()
        mask = np.ones((h, w), bool)
        mask[:, :3] = False
        return left, right, BBox2i(0, -1, 8, 2), dict(
            left_mask=mask, kernel_size=(7, 7), max_pyramid_levels=2,
            tile_size=16, refine_window=4, filter_half_kernel=2,
            consistency_threshold=2.0, subpixel="parabola"), (4, -1)
    if name == "bm":            # tests/test_parallel.py:153-185
        left, right = _texture_pair(512, 96, (4, 1), 42)
        return left, right, BBox2i(-8, -3, 16, 6), dict(
            kernel_size=(7, 7), max_pyramid_levels=3, tile_size=16,
            filter_half_kernel=3), (-4, -1)
    if name == "subpixel":      # :188-216
        rng = np.random.default_rng(42)
        h, w = 256, 96
        ys, xs = np.mgrid[0:h + 4, 0:w + 12].astype(np.float32)
        tex = (np.sin(xs * 0.31) * np.cos(ys * 0.23)
               + 0.4 * rng.random(xs.shape)).astype(np.float32)
        left = tex[:h, 8:8 + w].copy()
        right = tex[1:1 + h, 3:3 + w].copy()
        return left, right, BBox2i(2, -3, 8, 6), dict(
            kernel_size=(7, 7), max_pyramid_levels=2, tile_size=16,
            filter_half_kernel=3, subpixel="parabola"), (5, -1)
    if name in ("masks", "consistency", "consistency_off"):   # :241-313
        left, right = _texture_pair(256, 96, (3, 1), 42, (0.37, 0.29), extra=0)
        kw = dict(kernel_size=(7, 7), max_pyramid_levels=2, tile_size=16,
                  filter_half_kernel=3)
        if name == "masks":
            lmask = np.ones((256, 96), bool)
            lmask[100:140, 30:60] = False            # a hole across a band edge
            rmask = np.ones((256, 96), bool)
            rmask[:, :10] = False
            kw.update(left_mask=lmask, right_mask=rmask)
        else:
            left[60:90, 40:70] = np.random.default_rng(9).random((30, 30))
            kw.update(consistency_threshold=1.0 if name == "consistency" else -1.0)
        return left, right, BBox2i(-6, -3, 12, 6), kw, (-3, -1)
    if name in ("blob", "blob_off"):                        # :316-345
        rng = np.random.default_rng(42)
        ys, xs = np.mgrid[0:256, 0:102].astype(np.float32)
        tex = (np.sin(xs * 0.37) * np.cos(ys * 0.29)
               + 0.4 * rng.random(xs.shape)).astype(np.float32)
        left, right = tex[:, :96].copy(), tex[:, 3:99].copy()
        left[40:80] = 0.5
        left[120:200] = 0.5
        return left, right, BBox2i(-6, 0, 12, 1), dict(
            kernel_size=(7, 7), max_pyramid_levels=1, tile_size=16,
            filter_half_kernel=3, blob_filter_area=40 if name == "blob" else 0), (-3, 0)
    if name in ("ncc_log", "census"):
        left, right = _texture_pair(256, 96, (4, 1), 7)
        kw = dict(kernel_size=(7, 7), max_pyramid_levels=2, tile_size=16,
                  filter_half_kernel=3, subpixel="parabola")
        kw.update(dict(cost_type="ncc", prefilter_mode="log", prefilter_width=1.4)
                  if name == "ncc_log" else dict(cost_type="census", census_window=5))
        return left, right, BBox2i(-8, -3, 16, 6), kw, (-4, -1)
    if name in ("sgm", "mgm"):  # :352-398
        rng = np.random.default_rng(42)
        h, w = 256, 64
        r = rng.random((h + 4, w + 8)).astype(np.float32)
        return r[:h, 3:3 + w].copy(), r[:h, :w].copy(), BBox2i(0, -1, 8, 2), dict(
            max_pyramid_levels=2, tile_size=16, census_window=5,
            filter_half_kernel=2, subpixel="none", stereo_algorithm=name), (3, 0)
    if name == "clamp_levels":  # :219-238: 100-row bands at 4 ranks
        tex = np.random.default_rng(42).random((400, 70)).astype(np.float32)
        return tex[:, :64].copy(), tex[:, 3:67].copy(), BBox2i(-4, 0, 8, 1), dict(
            kernel_size=(7, 7), max_pyramid_levels=5, tile_size=16,
            filter_half_kernel=2), (-3, 0)
    raise KeyError(name)


def sharded_pyramid_case():
    """``tests/test_parallel.py:54-84``: one level, tile 16."""
    left, right = _texture_pair(256, 64, (3, 1), 42, (0.37, 0.29), extra=0)
    return left, right, BBox2i(-6, -3, 12, 6), dict(
        kernel_size=(7, 7), max_pyramid_levels=1, tile_size=16, filter_half_kernel=5)


def _georef(scale, x0, y0):
    return GeoReference(transform=np.array([[scale, 0.0, x0], [0.0, -scale, y0],
                                            [0.0, 0.0, 1.0]]))


def mosaic_case(name):
    """``(srcs, src georefs, dst georef, out_shape, levels)``: ``config5``,
    config 5's four sources at n = 96 (``tests/test_torch_mosaic.py``);
    ``odd``, a 75 x 89 canvas (bands of unequal rows) with one rotated
    source (the 2-D coordinate route)."""
    rng = np.random.default_rng(11)
    if name == "config5":
        n = 96
        specs = [(0.0102, -0.05, 1.05), (0.0098, 0.45, 1.04), (0.0101, -0.04, 0.56),
                 (0.0099, 0.46, 0.55)]
        srcs = [rng.random((57, 57)).astype(np.float32) + i for i in range(4)]
        return (srcs, [_georef(s, x * n * 0.01, y * n * 0.01) for s, x, y in specs],
                _georef(0.01, 0.0, n * 0.01), (n, n), 4)
    c, s = np.cos(0.12), np.sin(0.12)
    rot = GeoReference(transform=np.array([[0.0104 * c, 0.0104 * s, 0.05],
                                           [0.0104 * s, -0.0104 * c, 0.70], [0, 0, 1]]))
    georefs = [_georef(0.0118, -0.02, 0.76), rot, _georef(0.0085, 0.02, 0.41),
               _georef(0.0112, 0.43, 0.40)]
    shapes = [(41, 47), (43, 39), (37, 45), (45, 49)]
    srcs = [rng.random(sh).astype(np.float32) + i for i, sh in enumerate(shapes)]
    return srcs, georefs, _georef(0.01, 0.0, 0.75), (75, 89), 3


def _dm(dm):
    d, v = dm.to_numpy()
    return {"disparity": d, "valid": v}


def run_halo(world):
    mesh = make_tile_mesh(device="cpu")
    band = row_sharding(mesh)
    out = {}
    for dtype, frame in halo_frames(world).items():
        for depth, (top, bot) in HALOS.items():
            ext = halo_exchange_rows(band(torch.as_tensor(frame)), top, bot, mesh)
            out[f"{dtype}_{depth}"] = ext.numpy()
    return out


def run_halo_2x2(world):
    """A 2 x 2 tile x disp mesh: every rank exchanges along each axis a
    frame that depends on its index on the other axis."""
    mesh = make_tile_disp_mesh(2, 2, device="cpu")
    t_idx, d_idx = mesh.get_local_rank(TILE_AXIS), mesh.get_local_rank(DISP_AXIS)
    frame = halo_frames(2)["float32"]
    out = {}
    for axis, other in ((TILE_AXIS, d_idx), (DISP_AXIS, t_idx)):
        img = torch.as_tensor(frame + 1000.0 * other)
        band = row_sharding(mesh, axis)
        for depth, (top, bot) in HALOS.items():
            out[f"{axis}_{depth}"] = halo_exchange_rows(band(img), top, bot, mesh,
                                                        axis).numpy()
    out["coords"] = np.array([t_idx, d_idx])
    return out


def run_map_overlap(world):
    mesh = make_tile_mesh(device="cpu")
    out = map_overlap(lambda b: gaussian_filter(b, 1.0), gaussian_image(), mesh, halo=4)
    return {"out": out.numpy()}


def run_disp_search(cost):
    def run(world):
        left, right, sv, ks = disp_search_inputs(cost)
        mesh = make_disp_mesh(device="cpu")
        return _dm(disparity_sharded_search(left, right, sv, ks, mesh,
                                            "ncc" if cost == "ncc" else "abs"))
    return run


def run_sharded_pyramid(world):
    left, right, sr, kw = sharded_pyramid_case()
    return _dm(sharded_pyramid_correlate(left, right, sr, make_tile_mesh(device="cpu"),
                                         **kw))


def run_hier(name):
    def run(world):
        left, right, sr, kw, _ = hier_case(name)
        return _dm(hierarchical_sharded_correlate(left, right, sr,
                                                  make_tile_mesh(device="cpu"), **kw))
    return run


def run_mosaic(name):
    def run(world):
        srcs, georefs, dst, shape, levels = mosaic_case(name)
        out, valid = reproject_mosaic(srcs, georefs, dst, shape, levels=levels,
                                      mesh=make_tile_mesh(device="cpu"))
        return {"out": out.numpy(), "valid": valid.numpy()}
    return run


HIER_CASES = ("bm_jax", "bm", "subpixel", "masks", "consistency", "consistency_off",
              "blob", "blob_off", "ncc_log", "census", "sgm", "mgm", "clamp_levels")
# case -> (world sizes it runs in, runner)
CASES = {
    "halo": ((2, 4), run_halo),
    "halo_2x2": ((4,), run_halo_2x2),
    "map_overlap": ((2, 4), run_map_overlap),
    **{f"disp_{c}": ((2, 4), run_disp_search(c)) for c in ("abs", "ncc", "flat")},
    "sharded_pyramid": ((2, 4), run_sharded_pyramid),
    **{f"hier_{c}": ((4,) if c in ("bm_jax", "sgm", "mgm", "clamp_levels") else (2, 4),
                     run_hier(c)) for c in HIER_CASES},
    **{f"mosaic_{c}": ((2, 4), run_mosaic(c)) for c in ("config5", "odd")},
}


def main() -> int:
    rank, world, out_dir, init_file = (int(sys.argv[1]), int(sys.argv[2]),
                                       sys.argv[3], sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=60))
    for name, (worlds, run) in CASES.items():
        if world in worlds:
            np.savez(os.path.join(out_dir, f"{name}_w{world}_r{rank}.npz"), **run(world))
    dist.barrier()
    dist.destroy_process_group()
    leaked = [m for m in ("jax", "visionworkbench_tpu") if m in sys.modules]
    assert not leaked, f"the port imported {leaked}"
    print("WORKER_PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
