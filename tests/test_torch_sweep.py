"""Port's block-matching sweep (``visionworkbench_torch/ops/sweep.py`` and the
plain search of ``stereo/correlation.py``) against the JAX package's XLA
engines on the CPU: ``_tiled_search``, ``_tiled_search_patches``,
``_best_of_search`` and ``_search_with_patches``.

Tolerance: exact for disp, valid and the 3x3 patches — inputs are on the
1/256 grid, so every window sum is exact in fp32 in any order.
The CUDA kernel is held against the plain version on the card (skipped
without one).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import _torch_threads, cuda, quantized  # noqa: F401
from visionworkbench_tpu.stereo import correlation as jcorr
from visionworkbench_tpu.stereo.pyramid_correlation import (
    _tiled_search, _tiled_search_patches,
)
from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.ops import _build
from visionworkbench_torch.ops import sweep as tsweep
from visionworkbench_torch.stereo import correlation as tcorr

# (cost, tile, kw, kh, s_x, s_y, nty, ntx): non-square windows and kernels,
# tile grids of at least 2x2
CASES = [
    ("abs", 8, 5, 3, 6, 4, 2, 3),
    ("sq", 8, 3, 5, 4, 6, 3, 2),
    ("abs", 16, 7, 7, 11, 2, 2, 2),
]


def _inputs(seed, case, ring, max_off=4, overrun=0):
    """base/match frames sized like the pyramid's, with the base embedded
    in the match frame so the search has true winners."""
    _, tile, kw, kh, sx, sy, nty, ntx = case
    rng = np.random.default_rng(seed)
    lh, lw = nty * tile + kh - 1, ntx * tile + kw - 1
    mh = lh + sy - 1 + 2 * ring + max_off
    mw = lw + sx - 1 + 2 * ring + max_off
    base = quantized(rng, (lh, lw))
    match = quantized(rng, (mh, mw))
    match[2:2 + lh, 3:3 + lw] = base[:mh - 2, :mw - 3]
    offsets = rng.integers(0, max_off + 1 + overrun, (nty, ntx, 2)).astype(np.int32)
    return base, match, offsets


def _port(fn, base, match, offsets, case, want_patches, device="cpu"):
    cost, tile, kw, kh, sx, sy, _, _ = case
    t = [torch.as_tensor(a, device=device) for a in (base, match, offsets)]
    d, v, p = fn(*t, tile, sx, sy, kw, kh, cost, want_patches)
    return d.cpu().numpy(), v.cpu().numpy(), None if p is None else p.cpu().numpy()


@pytest.mark.parametrize("want_patches", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_sweep_matches_jax_tiled_search(case, want_patches):
    cost, tile, kw, kh, sx, sy, _, _ = case
    ring = int(want_patches)
    base, match, offsets = _inputs(11, case, ring)
    d, v, p = _port(tsweep.sweep, base, match, offsets, case, want_patches)
    jb, jm, jo = jnp.asarray(base), jnp.asarray(match), jnp.asarray(offsets)
    if want_patches:
        jd, jv, jp = _tiled_search_patches(jb, jm, jo, tile, sx, sy, kw, kh, cost)
        # JAX stacks the patch as (H, W, 9); the port returns (9, H, W) planes
        np.testing.assert_array_equal(p, np.moveaxis(np.asarray(jp), -1, 0))
    else:
        jd, jv = _tiled_search(jb, jm, jo, tile, sx, sy, kw, kh, cost, 5)
        assert p is None
    np.testing.assert_array_equal(v, np.asarray(jv))
    np.testing.assert_array_equal(d, np.asarray(jd))
    assert d.dtype == np.int32 and v.dtype == bool
    assert 0.5 < v.mean() <= 1.0


def test_sweep_clamps_window_start_like_dynamic_slice():
    """Offsets that would run a window past the frame clamp its start into
    the frame, as lax.dynamic_slice does, while disp carries the offset."""
    case = CASES[0]
    cost, tile, kw, kh, sx, sy, _, _ = case
    base, match, offsets = _inputs(12, case, 0, max_off=2, overrun=6)
    d, v, _ = _port(tsweep.sweep, base, match, offsets, case, False)
    jd, jv = _tiled_search(jnp.asarray(base), jnp.asarray(match),
                           jnp.asarray(offsets), tile, sx, sy, kw, kh, cost, 5)
    np.testing.assert_array_equal(v, np.asarray(jv))
    np.testing.assert_array_equal(d, np.asarray(jd))


@pytest.mark.parametrize("cost", ["abs", "sq"])
def test_search_matches_jax_correlation(cost):
    rng = np.random.default_rng(13)
    h, w, sx, sy, kw, kh = 20, 24, 5, 3, 5, 3
    left = quantized(rng, (h, w))
    right = quantized(rng, (h + sy + 1, w + sx + 1))
    right[2:2 + h, 1:1 + w] = left
    inner = right[1:1 + h + sy - 1, 1:1 + w + sx - 1]
    td, tv, tb = tcorr._best_of_search(torch.as_tensor(left),
                                       torch.as_tensor(inner), sx, sy, kw, kh, cost)
    jd, jv, jb = jcorr._best_of_search(jnp.asarray(left), jnp.asarray(inner),
                                       sx, sy, kw, kh, cost)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    pd, pv, pb, pp = tcorr._search_with_patches(
        torch.as_tensor(left), torch.as_tensor(right), sx, sy, kw, kh, cost)
    qd, qv, qb, qp = jcorr._search_with_patches(
        jnp.asarray(left), jnp.asarray(right), sx, sy, kw, kh, cost,
        chunk=(sx + 2) * (sy + 2))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(qv))
    np.testing.assert_array_equal(pd.numpy(), np.asarray(qd))
    np.testing.assert_array_equal(pp.numpy(), np.asarray(qp))
    # the patched sweep keeps the plain sweep's winners
    np.testing.assert_array_equal(pd.numpy(), td.numpy())


@pytest.mark.parametrize("cost", ["census", "ternary_census", "ncc", "nope"])
def test_sweep_rejects_costs_not_ported(cost):
    """Every cost is ported now; what the sweep still rejects is a census
    window with no variant, NCC in patch mode and an unknown cost."""
    base, match, offsets = _inputs(14, CASES[0], 1)
    _, tile, kw, kh, sx, sy, _, _ = CASES[0]
    t = [torch.as_tensor(a) for a in (base, match, offsets)]
    window = {"census": 4, "ternary_census": 11}.get(cost, 5)
    with pytest.raises(ArgumentErr):
        tsweep.sweep(*t, tile, sx, sy, kw, kh, cost, cost == "ncc", window)


def test_sweep_rejects_match_frame_smaller_than_a_window():
    _, tile, kw, kh, sx, sy, _, _ = CASES[0]
    base, match, offsets = _inputs(15, CASES[0], 0)
    with pytest.raises(ArgumentErr):
        _port(tsweep.sweep, base, match[:tile + kh + sy - 3], offsets, CASES[0], False)


@pytest.mark.cuda
@pytest.mark.parametrize("want_patches", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_sweep_kernel_matches_plain(cuda, case, want_patches):
    """The CUDA kernel adds in the plain version's order: exact on any
    input, here on unquantized noise too."""
    base, match, offsets = _inputs(16, case, int(want_patches))
    base = base + np.float32(1e-3) * np.random.default_rng(1).random(base.shape, np.float32)
    before = tsweep.launches
    got = _port(tsweep.sweep, base, match, offsets, case, want_patches, cuda)
    assert tsweep.launches == before + 1
    ref = _port(tsweep.sweep_plain, base, match, offsets, case, want_patches, cuda)
    for a, b in zip(got, ref):
        if b is not None:
            np.testing.assert_array_equal(a, b)


def _fake_nvcc(tmp_path, fail):
    """A stand-in nvcc under CUDA_HOME that logs each call and either
    writes its -o file or fails like a compile error."""
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f'echo call >> "{tmp_path}/calls.log"\n'
        'while [ $# -gt 0 ]; do [ "$1" = "-o" ] && out="$2"; shift; done\n'
        + ('echo "error: bad source"; exit 2\n' if fail else ': > "$out"\n'))
    nvcc.chmod(0o755)
    return tmp_path / "calls.log"


@pytest.mark.parametrize("fail", [False, True])
def test_kernel_build_runs_once_or_raises(monkeypatch, tmp_path, fail):
    """The loader runs nvcc once per source and reuses the library; a failed
    build raises and leaves no library behind (no fallback)."""
    from visionworkbench_torch.ops import _build
    calls = _fake_nvcc(tmp_path, fail)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    if fail:
        with pytest.raises(RuntimeError, match="bad source"):
            _build.build()
        assert not list((tmp_path / "build").glob("*.so"))
        return
    libs = _build.build()
    assert set(libs) == set(_build.SOURCES) == {"sweep", "speckle", "sgm_scan",
                                                  "mgm_scan", "sgm_path_scan",
                                                  "mgm_cluster_scan", "sgm_wta"}
    assert all(p.exists() for p in libs.values())
    assert _build.build() == libs
    assert len(calls.read_text().splitlines()) == 7     # one nvcc per source


def test_launch_error_code_raises():
    from visionworkbench_torch.ops import _build
    _build.check(0, "sweep")
    with pytest.raises(RuntimeError, match="cudaError_t 1"):
        _build.check(1, "sweep")


# ---- band_sweep_kernel (the abs/sq instances on the card) -------------------

# (tile, s_x, s_y, ring) of every abs sweep of the bench frame (bench.py:
# 1024^2, 64x8 search, 15x15 kernel, 4 levels, tile 64): levels 4 to 1, level
# 0 with the patch ring, the level-0 R->L pass; config 3's calc_disparity
# (1010^2 output, 32x1 search; kernel 6's route) and kernel 7 (11x1 window)
MAIN_PATH_SHAPES = {
    "level4": (64, 4, 1, 0), "level3": (64, 8, 1, 0), "level2": (64, 11, 2, 0),
    "level1": (64, 11, 4, 0), "level0_patches": (64, 11, 8, 1),
    "level0_rl": (64, 11, 8, 0),
    "config3": (tsweep.frame_tile(1010, 1010, 32, 1, 15, 15, "abs"), 32, 1, 0),
    "kernel7": (64, 11, 1, 0),
}


@pytest.mark.parametrize("cost", ["abs", "sq"])
@pytest.mark.parametrize("shape", sorted(MAIN_PATH_SHAPES))
def test_band_kernel_runs_every_main_path_shape(shape, cost):
    tile, sx, sy, ring = MAIN_PATH_SHAPES[shape]
    assert tsweep._sweep_variant(cost, tile, sx, sy, 15, 15, ring) == 16
    # pyramid_correlate's default 21x21 kernel takes the larger instance
    assert tsweep._sweep_variant(cost, tile, sx, sy, 21, 21, ring) == 24


# (cost, census window, tile, s_x, s_y, ring, codes_in) of every census
# sweep of config 4 (bench frame, census 5x5: levels 4 to 1, level 0 with
# the ring, the R->L pass), its ternary 7x7 variant (level 0 with the ring)
# and config 3's census 7x7 calc_disparity (code planes, 32x1 search)
CENSUS_MAIN_PATH_SHAPES = {
    **{f"config4_{name}": ("census", 5, tile, sx, sy, ring, False)
       for name, (tile, sx, sy, ring) in MAIN_PATH_SHAPES.items()
       if name.startswith("level")},
    "config4_ternary7_level0_patches": ("ternary_census", 7, 64, 11, 8, 1, False),
    "config3_census7": ("census", 7, tsweep.frame_tile(1010, 1010, 32, 1, 15, 15, "census", 2),
                        32, 1, 0, True),
}


@pytest.mark.parametrize("shape", sorted(CENSUS_MAIN_PATH_SHAPES))
def test_band_census_kernel_runs_every_census_main_path_shape(shape):
    cost, window, tile, sx, sy, ring, codes_in = CENSUS_MAIN_PATH_SHAPES[shape]
    assert tsweep._sweep_variant(cost, tile, sx, sy, 15, 15, ring, window, codes_in) == 16
    assert tsweep._sweep_variant(cost, tile, sx, sy, 21, 21, ring, window, codes_in) == 24


# (tile, s_x, s_y) of every NCC sweep (no patch mode, so no ring): config 3's
# calc_disparity (1010^2 output, 32x1 search), pyramid_correlate(cost_type=
# "ncc") on the bench frame (levels 4 to 0, tile 64, and the level-0 R->L
# pass) and its level 1 at a tile of 128
NCC_MAIN_PATH_SHAPES = {
    "config3": (tsweep.frame_tile(1010, 1010, 32, 1, 15, 15, "ncc"), 32, 1),
    **{name: (tile, sx, sy) for name, (tile, sx, sy, _) in MAIN_PATH_SHAPES.items()
       if name.startswith("level")},
    "level1_tile128": (128, 11, 4),
}


@pytest.mark.parametrize("shape", sorted(NCC_MAIN_PATH_SHAPES))
def test_band_kernel_runs_every_ncc_main_path_shape(shape):
    """NCC runs band_sweep_kernel<ncc, K> at every shape of its main paths
    (sweep_kernel ran them all before), the larger instance past 16."""
    tile, sx, sy = NCC_MAIN_PATH_SHAPES[shape]
    assert tsweep._sweep_variant("ncc", tile, sx, sy, 15, 15, 0) == 16
    assert tsweep._sweep_variant("ncc", tile, sx, sy, 21, 21, 0) == 24
    assert tsweep._sweep_variant("ncc", tile, sx, sy, 24, 24, 0) == 24
    assert tsweep._sweep_variant("ncc", tile, sx, sy, 25, 15, 0) is None


@pytest.mark.parametrize("tile, sx, sy, kw, k", [
    (64, 32, 1, 15, 16),       # config 3: the column-sum buffers hold the energies' sums
    (64, 11, 8, 15, 16),       # level 0: the energies' column sums need more rows
    (128, 11, 4, 21, 24),
    (8, 40, 3, 3, 16),         # a wide window: right rows wider than the buffers
])
def test_band_geometry_sizes_ncc_planes(tile, sx, sy, kw, k):
    """NCC's band block has, beyond the abs block, room in the column-sum
    buffers for the right energies' column sums ((16 + sy - 1) x rw floats)
    and a plane of right precisions ((16 + sy - 1) x an odd stride >= tile
    + sx - 1), as csrc/sweep.cu lays them out."""
    rows = _build.SWEEP_BAND_ROWS
    bands, threads, plain = tsweep._band_geometry(tile, sx, sy, kw, 0, k)
    assert (bands, threads) == tsweep._band_geometry(tile, sx, sy, kw, 0, k, True)[:2]
    ncc = tsweep._band_geometry(tile, sx, sy, kw, 0, k, True)[2]
    rw = tile + kw - 1 + sx - 1
    sums = 2 * rows * ((tile + k - 1) | 1)
    stride = (tile + sx - 1) | 1
    assert stride % 2 == 1 and stride >= tile + sx - 1
    assert ncc - plain == 4 * (max(0, (rows + sy - 1) * rw - sums) + (rows + sy - 1) * stride)


def _ncc_band_model(base, match, offsets, tile, sx, sy, kw, kh, k):
    """csrc/sweep.cu's band_sweep_kernel<ncc, k> on the CPU, band by band in
    the kernel's index arithmetic and fp32 summation order (numpy float32
    adds and products are IEEE, as the kernel's with --fmad=false; the root
    of a float64 is rounded to the correctly rounded fp32 root). Returns
    (disp, valid, best) planes."""
    rows = _build.SWEEP_BAND_ROWS
    nty, ntx = offsets.shape[:2]
    lh, lw = tile + kh - 1, tile + kw - 1
    rh, rw = lh + sy - 1, lw + sx - 1
    nr, prows, pw = rows + k - 1, rows + sy - 1, tile + sx - 1
    f32 = np.float32
    disp = np.zeros((nty * tile, ntx * tile, 2), np.int32)
    valid = np.zeros((nty * tile, ntx * tile), bool)
    best_out = np.zeros((nty * tile, ntx * tile), f32)

    def sums(terms, n):        # n sums of consecutive terms, top to bottom
        acc = np.zeros((terms.shape[0] - n + 1,) + terms.shape[1:], f32)
        for i in range(n):
            acc = acc + terms[i:i + acc.shape[0]]
        return acc

    for ty in range(nty):
        for tx in range(ntx):
            off_x, off_y = (int(v) for v in offsets[ty, tx])
            by0, bx0 = ty * tile, tx * tile
            ry0 = min(max(by0 + off_y, 0), match.shape[0] - rh)
            rx0 = min(max(bx0 + off_x, 0), match.shape[1] - rw)
            for y0 in range(0, tile, rows):
                R = np.zeros((nr + sy - 1, rw), f32)
                n = min(nr + sy - 1, rh - y0)
                R[:n] = match[ry0 + y0:ry0 + y0 + n, rx0:rx0 + rw]
                lv = np.zeros((nr, lw), f32)
                n = min(nr, lh - y0)
                lv[:n] = base[by0 + y0:by0 + y0 + n, bx0:bx0 + lw]
                E = sums(R * R, kh)[:prows]                       # (prows, rw)
                rp = f32(1) / sums(E.T, kw).T[:, :pw]             # (prows, pw)
                lp = f32(1) / sums(sums(lv * lv, kh)[:rows].T, kw).T[:, :tile]
                best = np.full((rows, tile), -np.inf, f32)
                worst = np.full((rows, tile), np.inf, f32)
                arg = np.zeros((rows, tile), np.int32)
                for ey in range(sy):
                    for ex in range(sx):
                        prod = lv * R[ey:ey + nr, ex:ex + lw]
                        s = sums(sums(prod, kh)[:rows].T, kw).T[:, :tile]
                        prec = lp * rp[ey:ey + rows, ex:ex + tile]
                        m = s * np.sqrt(prec.astype(np.float64)).astype(f32)
                        better = (m > best) | (np.isnan(m) & ~np.isnan(best))
                        best = np.where(better, m, best)
                        arg = np.where(better, ey * sx + ex, arg)
                        worst = np.where(np.isnan(m) | (m < worst), m, worst)
                v = best != worst
                out = slice(by0 + y0, by0 + min(y0 + rows, tile))
                n = out.stop - out.start
                cols = slice(bx0, bx0 + tile)
                valid[out, cols] = v[:n]
                best_out[out, cols] = best[:n]
                disp[out, cols, 0] = np.where(v, arg % sx, 0)[:n] + off_x
                disp[out, cols, 1] = np.where(v, arg // sx, 0)[:n] + off_y
    return disp, valid, best_out


# (tile, kw, kh, s_x, s_y, nty, ntx, K): one band (16), two with the last
# cut at the tile's edge (24), kw != kh, a 1-row window, the larger instance
NCC_MODEL_CASES = [
    (16, 5, 3, 4, 3, 2, 2, 16),
    (24, 3, 7, 5, 2, 2, 1, 16),
    (8, 9, 5, 6, 1, 1, 3, 16),
    (16, 17, 19, 3, 2, 1, 2, 24),
]


@pytest.mark.parametrize("case", NCC_MODEL_CASES)
def test_ncc_band_model_matches_plain(case):
    """The NCC band decomposition (staged right rows, the energies' column
    and window sums, the precisions' plane read at (o + ey, x + ex), the
    left energies from the column threads' values) equals the plain version
    bit for bit on off-grid noise with zero-energy blocks (NaN metrics)."""
    tile, kw, kh, sx, sy, nty, ntx, k = case
    assert tsweep._sweep_variant("ncc", tile, sx, sy, kw, kh, 0) == k
    base, match, offsets = _band_inputs(19, ("ncc", tile, kw, kh, sx, sy, nty, ntx), 0,
                                        False)
    base[1:kh + 3, 2:kw + 5] = 0.0            # zero-energy left windows
    match[3:kh + 9, 1:kw + 12] = 0.0
    with np.errstate(divide="ignore", invalid="ignore"):   # the NaN metrics
        model = _ncc_band_model(base, match, offsets, tile, sx, sy, kw, kh, k)
    t = [torch.as_tensor(a) for a in (base, match, offsets)]
    best = torch.empty(nty * tile, ntx * tile)
    d, v, _ = tsweep.sweep_plain(*t, tile, sx, sy, kw, kh, "ncc", False, best_out=best)
    assert np.isnan(model[2]).any() and model[1][np.isnan(model[2])].all()
    np.testing.assert_array_equal(model[0], d.numpy())
    np.testing.assert_array_equal(model[1], v.numpy())
    np.testing.assert_array_equal(model[2], best.numpy())


@pytest.mark.parametrize("cost, tile, sx, sy, kw, kh, ring", [
    ("abs", 64, 11, 8, 25, 15, 1),            # kernel past the largest bound
    ("sq", 64, 11, 8, 15, 31, 0),
    ("census", 64, 11, 8, 15, 25, 1),
    ("ncc", 64, 32, 1, 25, 25, 0),
    ("abs", 12, 4, 2, 5, 5, 0),               # tile not a multiple of 8
    ("ternary_census", 20, 4, 2, 5, 5, 0),
    ("ncc", 12, 4, 2, 5, 5, 0),
    ("abs", 256, 4, 2, 5, 5, 0),              # 512 threads a block
    ("census", 256, 4, 2, 5, 5, 0),
    ("sq", 64, 2000, 4, 15, 15, 0),           # right rows past shared memory
    ("ternary_census", 64, 1000, 4, 15, 15, 0),
])
def test_sweep_kernel_runs_shapes_past_the_band_kernel(cost, tile, sx, sy, kw, kh, ring):
    assert tsweep._sweep_variant(cost, tile, sx, sy, kw, kh, ring, 7) is None


def _row_thread(tid, tile):
    """csrc/sweep.cu's row-thread map: band row and first pixel of thread
    ``tid`` (a warp spans 8 rows x 4 segments)."""
    nseg = tile // _build.SWEEP_SEG
    return ((tid & 7) + 8 * ((tid >> 3) // nseg),
            ((tid >> 3) % nseg) * _build.SWEEP_SEG)


@pytest.mark.parametrize("kw", [3, 15, 24])
@pytest.mark.parametrize("tile", [8, 16, 24, 32, 64, 128])
def test_band_grid_covers_every_output_row_once(tile, kw):
    """Bands of SWEEP_BAND_ROWS rows (the last cut at the tile's edge, here
    also where the band height does not divide the tile) and the row
    threads of each band cover every output pixel of a tile exactly once;
    there are threads for every column of the column pass."""
    rows, seg = _build.SWEEP_BAND_ROWS, _build.SWEEP_SEG
    bands, threads, _ = tsweep._band_geometry(tile, 11, 8, kw, 1, 24)
    assert threads % 32 == 0 and tile + kw - 1 <= threads <= _build.SWEEP_BAND_MAX_THREADS
    covered = np.zeros((tile, tile), int)
    for band in range(bands):
        for tid in range(rows * (tile // seg)):
            o, x0 = _row_thread(tid, tile)
            assert 0 <= o < rows
            if band * rows + o < tile:
                covered[band * rows + o, x0:x0 + seg] += 1
    np.testing.assert_array_equal(covered, 1)


def _band_inputs(seed, case, ring, grid):
    """_inputs, or with ``grid`` False the same frames off the 1/256 grid
    (uniform noise), where a change of summation order shows."""
    base, match, offsets = _inputs(seed, case, ring)
    if not grid:
        rng = np.random.default_rng(seed + 1)
        base = base + rng.random(base.shape, np.float32) / 7
        match = match + rng.random(match.shape, np.float32) / 7
        match[2:2 + base.shape[0], 3:3 + base.shape[1]] = base[:match.shape[0] - 2,
                                                               :match.shape[1] - 3]
    return base, match, offsets


# (cost, tile, kw, kh, s_x, s_y, nty, ntx): odd kernels, tiles 8 to 128
# (24: the band height does not divide it; 128: 256 threads), the larger
# instance (21x17); NCC at config 3's shape (32x1 search), a pyramid level
# 0's (11x8), K 24 (kernel 24x23) and a tile of 128
BAND_CASES = [
    ("abs", 8, 5, 3, 6, 4, 2, 3),
    ("sq", 16, 7, 7, 11, 2, 2, 2),
    ("abs", 24, 9, 5, 4, 3, 2, 1),
    ("abs", 32, 11, 9, 7, 3, 2, 2),
    ("abs", 64, 15, 15, 11, 8, 2, 2),
    ("sq", 64, 21, 17, 5, 3, 1, 2),
    ("sq", 128, 15, 13, 4, 2, 1, 2),
    ("ncc", 64, 15, 15, 32, 1, 2, 2),
    ("ncc", 64, 15, 15, 11, 8, 2, 2),
    ("ncc", 32, 24, 23, 5, 3, 2, 1),
    ("ncc", 128, 15, 15, 11, 4, 1, 2),
]
# NCC has no patch mode
BAND_RUNS = [(case, want_patches) for case in BAND_CASES for want_patches in (False, True)
             if not (case[0] == "ncc" and want_patches)]


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [True, False], ids=["quantized", "off_grid"])
@pytest.mark.parametrize("case, want_patches", BAND_RUNS)
def test_band_kernel_matches_plain_and_sweep_kernel(cuda, case, want_patches, grid):
    """band_sweep_kernel equals the plain version and sweep_kernel bit for
    bit (disp, valid, patches, best), quantized or not; at a tile of 128
    sweep_kernel runs the tile's pixels in rounds. NCC's frames carry black
    blocks: zero-energy windows give NaN metrics, which win and stay
    valid."""
    cost, tile, kw, kh, sx, sy, nty, ntx = case
    k = tsweep._sweep_variant(cost, tile, sx, sy, kw, kh, int(want_patches))
    assert k is not None
    frames = _band_inputs(17, case, int(want_patches), grid)
    if cost == "ncc":
        frames[0][3:kh + 9, 5:kw + 20] = 0.0
        frames[1][20:kh + 40, 2:kw + 30] = 0.0
    t = [torch.as_tensor(a, device=cuda) for a in frames]
    args = (*t, tile, sx, sy, kw, kh, cost, want_patches, 5)
    best = [torch.empty(nty * tile, ntx * tile, device=cuda) for _ in range(3)]
    before = (tsweep.launches, tsweep.band_launches)
    got = (*tsweep.sweep(*args, best_out=best[0]), best[0])
    assert (tsweep.launches, tsweep.band_launches) == (before[0] + 1, before[1] + 1)
    refs = [(*tsweep.sweep_plain(*args, best_out=best[1]), best[1]),
            (*tsweep._sweep_cuda(*args, best[2], None), best[2])]
    assert tsweep.band_launches == before[1] + 1     # it ran sweep_kernel
    for ref in refs:
        for a, b in zip(got, ref):
            if b is not None:
                np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
    if cost == "ncc":
        assert bool(best[0].isnan().any()) and bool(got[1][best[0].isnan()].all())


def test_band_limits_reach_nvcc(monkeypatch):
    """The band kernel's layout and bounds are set once, in ops/_build.py:
    nvcc gets them as macros, and another value builds another library."""
    flags = _build.flags("sweep")
    for macro, value in (("ROWS", _build.SWEEP_BAND_ROWS), ("K0", _build.SWEEP_BAND_K[0]),
                         ("K1", _build.SWEEP_BAND_K[1]), ("SEG", _build.SWEEP_SEG),
                         ("MAX_THREADS", _build.SWEEP_BAND_MAX_THREADS)):
        name = "SEG" if macro == "SEG" else f"BAND_{macro}"
        assert f"-DVW_SWEEP_{name}={value}" in flags
    path = _build.library_path("sweep")
    monkeypatch.setitem(_build.DEFINES, "sweep", flags[len(_build.NVCC_FLAGS):-1])
    assert _build.library_path("sweep") != path


# ---- tile 128 (ROADMAP.md section 3: sweep_kernel failed to launch there) ----

# (cost, tile, kw, kh, s_x, s_y, nty, ntx): one and two tiles of 128, small
# kernels and windows
TILE128_CASES = [
    ("ncc", 128, 3, 3, 2, 2, 1, 1),
    ("census", 128, 5, 3, 3, 2, 1, 2),
]


@pytest.mark.parametrize("case", TILE128_CASES, ids=[c[0] for c in TILE128_CASES])
def test_tile128_matches_jax_tiled_search(case):
    """The plain version at a tile of 128 (the card's reference) against the
    JAX package: NCC with black blocks (zero-energy windows), census 5x5."""
    cost, tile, kw, kh, sx, sy, _, _ = case
    base, match, offsets = _inputs(18, case, 0)
    if cost == "ncc":
        base[20:40, 30:60] = 0.0
        match[25:50, 10:50] = 0.0
    d, v, p = _port(tsweep.sweep, base, match, offsets, case, False)
    jd, jv = _tiled_search(jnp.asarray(base), jnp.asarray(match),
                           jnp.asarray(offsets), tile, sx, sy, kw, kh, cost, 5)
    assert p is None
    np.testing.assert_array_equal(v, np.asarray(jv))
    np.testing.assert_array_equal(d, np.asarray(jd))
    assert v.mean() > 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("case", TILE128_CASES, ids=[c[0] for c in TILE128_CASES])
def test_tile128_card_matches_plain(cuda, case):
    """sweep() at a tile of 128 runs on the card and equals the plain
    version: NCC on band_sweep_kernel, census on band_census_kernel, each
    also forced on sweep_kernel (its threads capped by its launch bound and
    shared memory, the pixels in rounds)."""
    cost, tile, kw, kh, sx, sy, nty, ntx = case
    base, match, offsets = _inputs(18, case, 0)
    if cost == "ncc":
        base[20:40, 30:60] = 0.0
        match[25:50, 10:50] = 0.0
    t = [torch.as_tensor(a, device=cuda) for a in (base, match, offsets)]
    args = (*t, tile, sx, sy, kw, kh, cost, False, 5)
    best = [torch.empty(nty * tile, ntx * tile, device=cuda) for _ in range(3)]
    before = (tsweep.band_launches, tsweep.census_band_launches)
    got = (*tsweep.sweep(*args, best_out=best[0]), best[0])
    assert (tsweep.band_launches, tsweep.census_band_launches) == (
        before[0] + int(cost == "ncc"), before[1] + int(cost == "census"))
    refs = [(*tsweep.sweep_plain(*args, best_out=best[1]), best[1]),
            (*tsweep._sweep_cuda(*args, best[2], None), best[2])]
    for ref in refs:
        for a, b in zip(got, ref):
            if b is not None:
                np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


def test_sweep_kernel_rounds_fit_shared_memory(monkeypatch):
    """Where a tile's column sums and NCC precisions do not fit a block, the
    wrapper lowers sweep_kernel's threads until a round's rows fit; one
    round covers the whole tile at the main path's tile of 64."""
    class Lib:                     # the card's answers, as the wrapper reads them
        def vw_sweep_max_threads(self, cost, n_words):
            return 256             # kSweepMaxThreads

        def vw_sweep_pixels_per_thread(self):
            return 16

    monkeypatch.setattr(tsweep, "_max_threads",
                        {(c, n, "card"): 256 for c in range(4) for n in (1, 2)})
    shape = (128, 32, 8, 21, 21, 0, "ncc")
    threads, smem = tsweep._sweep_block(Lib(), *shape, 1, False, "card")
    assert tsweep.smem_bytes(*shape) > tsweep._MAX_SMEM
    assert threads % 32 == 0 and 32 <= threads < 256 and smem <= tsweep._MAX_SMEM
    rows = tsweep._round_rows(128, threads, 16)
    assert rows < 128 and smem == tsweep.smem_bytes(*shape, rows=rows)
    assert tsweep.smem_bytes(*shape, rows=tsweep._round_rows(128, threads + 32, 16)) > (
        tsweep._MAX_SMEM)
    assert tsweep._sweep_block(Lib(), 64, 32, 1, 15, 15, 0, "ncc", 1, False, "card") == (
        256, tsweep.smem_bytes(64, 32, 1, 15, 15, 0, "ncc"))
    assert tsweep._round_rows(64, 256, 16) == 64
