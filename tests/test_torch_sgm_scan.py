"""Port's SGM/MGM aggregation scans (``visionworkbench_torch/ops/sgm_scan.py``)
against the JAX package on the CPU: each plain version against the JAX
``lax.scan`` engine of ``stereo/sgm.py`` and against the Pallas kernel in
interpret mode, as ``tests/test_sgm.py`` runs them (N <= 24, L = 128; for
``scan_bidir`` also the wide grids of ``calc_disparity_sgm``'s search,
8x64 and an odd 3x11, at N < L and N > L so that diagonal lines enter and
leave the frame), on the same seeded integer-valued inputs.

Tolerance: exact. Every value is an integer-valued fp32 below 2^24, so the
recurrences are exact in any order. The CUDA kernels are held against the
plain versions on the card (skipped without one), also exactly, with the
carry in shared memory and, for wide search windows, in global scratch; the
register-carry kernel (``csrc/mgm_scan.cu``) and the path-line kernel
(``csrc/sgm_path_scan.cu``) also against ``line_scan_kernel<0>``
(``scan_bidir``) and ``line_scan_kernel<1>`` (MGM) on the same inputs, with
the launch counts showing which kernel ran. On the CPU, the choice between
the kernels (``_scan_bidir_pick``, ``_scan_variant``, ``_mgm_variant``) is
held against the shapes config 6's SGM and MGM pyramids give and against
the limits nvcc builds the instances with, and plain models of the
path-line kernel's decomposition (blocks of adjacent lines, the steps each
runs, the padded grid) and of the MGM cluster kernel's (a line's lanes in
block tiles, the source terms posted to double-buffered rows, the tiles'
edge lanes reading the neighbour tile's rows) against the plain versions.
The MGM plain versions are also held against the JAX package at wide grids
(3x11, 8x8), the cluster kernel's.
Pixel differences are drawn from [0, 256), the range of |dI| on 8-bit
images, so the P2' = max(floor(P2 / |dI|), P1) clamp and every IEEE
quotient of the penalty are reached.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import _torch_threads, cuda  # noqa: F401
from visionworkbench_tpu.ops import sgm_scan as jscan
from visionworkbench_tpu.stereo import sgm as jsgm
from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.ops import sgm_scan as tscan

P1, P2 = 15.0, 750.0
BAD = 255.0 + P2


PD_HI = 256       # |dI| of 8-bit images


def _ints(rng, shape, hi, bad_frac=0.0):
    """Integer-valued float32 in [0, hi), with a share of absent (bad)
    candidates."""
    a = np.floor(rng.random(shape) * hi).astype(np.float32)
    if bad_frac:
        a[rng.random(shape) < bad_frac] = BAD
    return a


def _scan_inputs(seed, n, sy, sx, nl, b, bad_frac=0.05):
    rng = np.random.default_rng(seed)
    return (_ints(rng, (n, sy, sx, nl), 30, bad_frac), _ints(rng, (n, b, nl), PD_HI),
            _ints(rng, (n, b, nl), PD_HI))


def _mgm_inputs(seed, n, sy, sx, nl, bad_frac=0.05, guard_off=0.2):
    """Costs with a share ``bad_frac`` of absent candidates, and guards
    false with probability ``guard_off`` (1: all false, 0: all true)."""
    rng = np.random.default_rng(seed)
    return (_ints(rng, (n, sy, sx, nl), 30, bad_frac), _ints(rng, (n, nl), PD_HI),
            _ints(rng, (n, nl), PD_HI), rng.random((n, nl)) >= guard_off,
            rng.random((n, nl)) >= guard_off)


def _fwd_inputs(seed, n, b, sy, sx, nl, bad_frac=0.05, guard_off=0.2):
    rng = np.random.default_rng(seed)
    return (_ints(rng, (n, b, sy, sx, nl), 30, bad_frac), _ints(rng, (n, b, nl), PD_HI),
            rng.random((n, b, nl)) >= guard_off)


def _t(arrays, device="cpu"):
    return [torch.as_tensor(a, device=device) for a in arrays]


@pytest.mark.parametrize("shifts", [(0,), (0, 1, -1), (1, -1)])
@pytest.mark.parametrize("grid", [(2, 5), (1, 4),
                                  # (sy, sx, N, L): wide grids, N < L and N > L
                                  (8, 64, 6, 40), (8, 64, 12, 5),
                                  (3, 11, 6, 40), (3, 11, 12, 5)])
def test_scan_bidir_matches_jax(shifts, grid):
    sy, sx, n, nl = (*grid, 24, 128)[:4]
    cost, pf, pr = _scan_inputs(20, n, sy, sx, nl, len(shifts))
    got = tscan.scan_bidir(*_t((cost, pf, pr)), shifts, P1, P2, BAD).numpy()
    j = [jnp.asarray(a) for a in (cost, pf, pr)]
    np.testing.assert_array_equal(got, np.asarray(jsgm._scan_bidir(*j, shifts, P1, P2, BAD)))
    np.testing.assert_array_equal(
        got, np.asarray(jscan.pallas_scan_bidir(*j, shifts, P1, P2, BAD, interpret=True)))


@pytest.mark.parametrize("grid", [(2, 5), (3, 3),
                                  # wide grids (the cluster kernel's)
                                  (3, 11), (8, 8)])
def test_mgm_bidir_matches_jax(grid):
    sy, sx = grid
    arrays = _mgm_inputs(21, 16, sy, sx, 128)
    got = tscan.mgm_bidir(*_t(arrays), (1, -1), P1, P2, BAD).numpy()
    j = [jnp.asarray(a) for a in arrays]
    old = jsgm._SGM_PALLAS
    try:
        jsgm._SGM_PALLAS = False          # the JAX package's lax.scan engine
        ref = jsgm._mgm_plain_scan(*j, P1, P2, BAD)
    finally:
        jsgm._SGM_PALLAS = old
    np.testing.assert_array_equal(got, np.asarray(ref))
    np.testing.assert_array_equal(
        got, np.asarray(jscan.pallas_mgm_bidir(*j, (1, -1), P1, P2, BAD, interpret=True)))


def test_mgm_fwd_matches_jax():
    cost, pd, g = _fwd_inputs(22, 16, 4, 2, 5, 128)
    got = tscan.mgm_fwd(*_t((cost, pd, g)), (0, 1), P1, P2, BAD).numpy()
    j = [jnp.asarray(a) for a in (cost, pd, g)]

    def step(carry, inp):                 # the scan body of _mgm_sheared_scan
        cx, px, gx = inp
        a = jsgm._path_update(carry, cx, px, P1, P2, BAD)
        bb = jsgm._path_update(jsgm._shift_lane(carry, 1, BAD), cx, px, P1, P2, BAD)
        o = jnp.floor((a + bb) * 0.5)
        o = jnp.where(gx[:, None, None, :], o, cx)
        o = jsgm._force_bad(o, cx, BAD)
        return o, o

    _, ref = jax.lax.scan(step, jnp.full(cost.shape[1:], BAD, jnp.float32), tuple(j))
    np.testing.assert_array_equal(got, np.asarray(ref))
    np.testing.assert_array_equal(
        got, np.asarray(jscan.pallas_mgm_fwd(*j, (0, 1), P1, P2, BAD, interpret=True)))


@pytest.mark.parametrize("grid", [(3, 11), (8, 8)])
def test_mgm_fwd_wide_grid_matches_jax(grid):
    """The sheared forward scan at wide grids (the cluster kernel's), B = 2
    orientations on a short line, against the JAX package's scan body of
    ``_mgm_sheared_scan`` and the Pallas kernel in interpret mode."""
    sy, sx = grid
    cost, pd, g = _fwd_inputs(39, 8, 2, sy, sx, 128)
    got = tscan.mgm_fwd(*_t((cost, pd, g)), (0, 1), P1, P2, BAD).numpy()
    j = [jnp.asarray(a) for a in (cost, pd, g)]

    def step(carry, inp):                 # the scan body of _mgm_sheared_scan
        cx, px, gx = inp
        a = jsgm._path_update(carry, cx, px, P1, P2, BAD)
        bb = jsgm._path_update(jsgm._shift_lane(carry, 1, BAD), cx, px, P1, P2, BAD)
        o = jnp.floor((a + bb) * 0.5)
        o = jnp.where(gx[:, None, None, :], o, cx)
        o = jsgm._force_bad(o, cx, BAD)
        return o, o

    _, ref = jax.lax.scan(step, jnp.full(cost.shape[1:], BAD, jnp.float32), tuple(j))
    np.testing.assert_array_equal(got, np.asarray(ref))
    np.testing.assert_array_equal(
        got, np.asarray(jscan.pallas_mgm_fwd(*j, (0, 1), P1, P2, BAD, interpret=True)))


def test_path_update_quotient_is_ieee():
    """floor(P2 / |dI|) must be the floor of the IEEE quotient: PyTorch's
    ``scalar / tensor`` (reciprocal times scalar) misses exact quotients."""
    pd = torch.arange(1, 2000, dtype=torch.float32)[:, None]
    prior = torch.zeros((pd.shape[0], 1, 1, 1))
    got = tscan._path_update(prior, torch.zeros_like(prior), pd, 0.0, 750.0, BAD)
    ref = jsgm._path_update(jnp.asarray(prior.numpy()), jnp.zeros(prior.shape),
                            jnp.asarray(pd.numpy()), 0.0, 750.0, BAD)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# config 6's MGM pyramid (512^2, search 64x2, sgm_search_buffer 2): level 4
# (1, 4) over 64 lanes, levels 3-1 (1, 5) over 64-256, level 0 (2, 5) over 512
_CONFIG6_MGM = {
    ("mgm_fwd", (128, 4, 1, 4, 64)): 1, ("mgm_bidir", (64, 1, 4, 64)): 2,
    ("mgm_fwd", (128, 4, 1, 5, 64)): 1, ("mgm_bidir", (64, 1, 5, 64)): 2,
    ("mgm_fwd", (256, 4, 1, 5, 128)): 1, ("mgm_bidir", (128, 1, 5, 128)): 2,
    ("mgm_fwd", (512, 4, 1, 5, 256)): 1, ("mgm_bidir", (256, 1, 5, 256)): 2,
    ("mgm_fwd", (1024, 4, 2, 5, 512)): 1, ("mgm_bidir", (512, 2, 5, 512)): 2}


@pytest.mark.parametrize("shape,want", [
    ((1, 4, 64), 64), ((1, 5, 128), 128), ((1, 5, 256), 256), ((2, 5, 512), 512),
    ((1, 1, 33), 64), ((3, 3, 65), 96), ((4, 4, 512), 512), ((1, 16, 500), 512),
    # past the cell or lane limits, and scratch-sized windows:
    # line_scan_kernel<1>
    ((2, 3, 1024), None), ((1, 6, 513), None),
    ((1, 17, 64), None), ((5, 5, 64), None), ((3, 3, 513), None),
    ((2, 5, 1024), None), ((1, 7, 513), None), ((1, 1, 1030), None),
    ((8, 16, 256), None),
    ((8, 64, 256), None),
    ((1, 5, 64), 64), ((16, 1, 480), 480), ((1, 1, 513), None)])
def test_mgm_variant_picks_by_grid_and_line(shape, want):
    """Threads of the register-carry instance, or None for
    ``line_scan_kernel<1>``: up to 16 cells over up to 512 lanes."""
    assert tscan._mgm_variant(*shape) == want


def test_mgm_variant_covers_config6_mgm_pyramid(monkeypatch):
    """Every MGM scan of config 6's pyramid (tools_bench_configs.py config 6,
    as chip_smoke.py runs it) has a register-carry instance. The scans are
    replaced by a recorder (no scan runs; the shapes do not depend on the
    data)."""
    from visionworkbench_torch.math.bbox import BBox2i
    from visionworkbench_torch.stereo import sgm as tsgm
    from visionworkbench_torch.stereo.pyramid_correlation import pyramid_correlate
    seen = {}

    def recorder(kind):
        def scan(cost_t, *args):
            key = (kind, tuple(cost_t.shape))
            seen[key] = seen.get(key, 0) + 1
            return torch.zeros_like(cost_t)
        return scan

    monkeypatch.setattr(tsgm, "mgm_fwd", recorder("mgm_fwd"))
    monkeypatch.setattr(tsgm, "mgm_bidir", recorder("mgm_bidir"))
    img = np.random.default_rng(27).random((512, 512)).astype(np.float32)
    pyramid_correlate(img, img, BBox2i(0, -1, 64, 2), kernel_size=(5, 5),
                      max_pyramid_levels=4, tile_size=64, stereo_algorithm="mgm",
                      subpixel="none", device="cpu")
    assert seen == _CONFIG6_MGM
    for (_, shape) in seen:
        assert tscan._mgm_variant(*shape[-3:]) == shape[-1]
        # and so none of them takes the cluster kernel
        assert tscan._mgm_pick(*shape[-3:]) == (shape[-1], None)


def test_mgm_instance_limits_are_built_from_the_variant_limits(monkeypatch):
    """``_mgm_variant``'s limits are the macros ``csrc/mgm_scan.cu`` is built
    with, and they are part of the library's name (a change rebuilds)."""
    from visionworkbench_torch.ops import _build
    flags = _build.flags("mgm_scan")
    assert f"-DVW_MGM_MAX_CELLS={_build.MGM_MAX_CELLS}" in flags
    assert f"-DVW_MGM_MAX_LANES={_build.MGM_MAX_LANES}" in flags
    assert _build.flags("sgm_scan") == _build.NVCC_FLAGS
    cells, lanes = _build.MGM_MAX_CELLS, _build.MGM_MAX_LANES
    assert tscan._mgm_variant(1, cells, lanes) == lanes
    assert tscan._mgm_variant(1, cells + 1, lanes) is None
    assert tscan._mgm_variant(1, cells, lanes + 1) is None
    name = _build.library_path("mgm_scan")
    monkeypatch.setitem(_build.DEFINES, "mgm_scan", (
        f"-DVW_MGM_MAX_CELLS={cells}", f"-DVW_MGM_MAX_LANES={lanes // 2}"))
    assert _build.library_path("mgm_scan") != name


# config 6's SGM pyramid: (scan shape, lane shifts) -> launches per frame;
# level 0 (2, 5) over 512 lanes, levels 1-3 (1, 5) over 256-64, level 4
# (1, 4) over 64; an x-scan (3 directions) and a y-scan per level
_CONFIG6_SGM = {
    ((512, 2, 5, 512), (0, 1, -1)): 1, ((512, 2, 5, 512), (0,)): 1,
    ((256, 1, 5, 256), (0, 1, -1)): 1, ((256, 1, 5, 256), (0,)): 1,
    ((128, 1, 5, 128), (0, 1, -1)): 1, ((128, 1, 5, 128), (0,)): 1,
    ((64, 1, 5, 64), (0, 1, -1)): 1, ((64, 1, 5, 64), (0,)): 1,
    ((64, 1, 4, 64), (0, 1, -1)): 1, ((64, 1, 4, 64), (0,)): 1}


@pytest.mark.parametrize("shape,b,want", [
    ((2, 5, 512), 3, 512), ((2, 5, 512), 1, 512), ((1, 5, 65), 2, 96),
    ((1, 4, 64), 3, 64), ((4, 4, 512), 3, 512), ((1, 1, 1), 1, 32),
    # not the register-carry kernel: more than 16 cells (calc_disparity_sgm's
    # 64x8 search), more than 512 lanes (both on the path-line kernel),
    # more than 3 directions (line_scan_kernel<0>)
    ((8, 64, 256), 3, None), ((1, 17, 64), 1, None), ((2, 5, 513), 3, None),
    ((1, 4, 1100), 1, None), ((2, 5, 512), 4, None)])
def test_scan_variant_picks_by_grid_line_and_directions(shape, b, want):
    """Threads of the register-carry instance for scan_bidir, or None: up to
    16 cells over up to 512 lanes, up to 3 path directions. The shapes it
    leaves with up to 512 cells and 3 directions have a path-line
    instance."""
    assert tscan._scan_variant(*shape, b) == want
    if want is None:
        sy, sx, _ = shape
        assert ((tscan._path_scan_variant(sy, sx, b) is not None)
                == (sy * sx <= 512 and b <= 3))


def test_scan_variant_covers_config6_sgm_pyramid(monkeypatch):
    """Every scan_bidir launch of config 6's SGM pyramid (10 a frame) has a
    register-carry instance. The scans are replaced by a recorder (no scan
    runs; the shapes do not depend on the data)."""
    from visionworkbench_torch.math.bbox import BBox2i
    from visionworkbench_torch.stereo import sgm as tsgm
    from visionworkbench_torch.stereo.pyramid_correlation import pyramid_correlate
    seen = {}

    def recorder(cost_t, pd_f, pd_r, shifts, *args):
        key = (tuple(cost_t.shape), tuple(shifts))
        seen[key] = seen.get(key, 0) + 1
        return torch.zeros_like(cost_t)

    monkeypatch.setattr(tsgm, "scan_bidir", recorder)
    img = np.random.default_rng(32).random((512, 512)).astype(np.float32)
    pyramid_correlate(img, img, BBox2i(0, -1, 64, 2), kernel_size=(5, 5),
                      max_pyramid_levels=4, tile_size=64, stereo_algorithm="sgm",
                      subpixel="none", device="cpu")
    assert seen == _CONFIG6_SGM
    for shape, shifts in seen:
        assert tscan._scan_variant(*shape[-3:], len(shifts)) == shape[-1]


def test_scan_variant_limits_are_the_kernel_source_limits():
    """``_scan_variant`` reads the limits nvcc builds the instances with, and
    the wrapper's modes and direction limit are those of
    ``csrc/mgm_scan.cu``."""
    import re

    from visionworkbench_torch.ops import _build
    flags = _build.flags("mgm_scan")
    cells, lanes = _build.MGM_MAX_CELLS, _build.MGM_MAX_LANES
    assert f"-DVW_MGM_MAX_CELLS={cells}" in flags
    assert f"-DVW_MGM_MAX_LANES={lanes}" in flags
    assert tscan._scan_variant(1, cells, lanes, 3) == lanes
    assert tscan._scan_variant(1, cells + 1, lanes, 3) is None
    assert tscan._scan_variant(1, cells, lanes + 1, 3) is None
    src = (_build.CSRC / "mgm_scan.cu").read_text()
    enum = re.search(r"enum Mode \{ kFwd = (\d), kBidir = (\d), kSgm = (\d) \}", src)
    assert tuple(int(x) for x in enum.groups()) == (
        tscan._MODES["mgm_fwd"], tscan._MODES["mgm_bidir"], tscan._MODES["scan_bidir"])
    assert f"if (B > {tscan._MAX_DIRECTIONS}) return cudaErrorInvalidValue;" in src


# (N, sy, sx, L, shifts) -> the kernel on a card of 132 SMs: ("mgm_scan",
# threads), ("path_scan", cells a thread, lines a block) or ("line_scan",)
@pytest.mark.parametrize("case,want", [
    # config 6's level-0 x- and y-scans: the register-carry kernel
    ((512, 2, 5, 512, (0, 1, -1)), ("mgm_scan", 512)),
    ((512, 2, 5, 512, (0,)), ("mgm_scan", 512)),
    # calc_disparity_sgm's 64x8 search at 256^2: x-scan 2 x 1278 lines in
    # blocks of 8; y-scan 2 x 256 lines, in blocks of 4 (128 blocks: at
    # least half of 132 SMs)
    ((256, 8, 64, 256, (0, 1, -1)), ("path_scan", 16, 8)),
    ((256, 8, 64, 256, (0,)), ("path_scan", 16, 4)),
    # 17, 33, 64 cells; lines past the register-carry kernel's 512 lanes
    ((20, 1, 17, 33, (0, 1, -1)), ("path_scan", 1, 4)),
    ((300, 3, 11, 200, (0, 1, -1)), ("path_scan", 2, 8)),
    ((12, 8, 8, 1, (0, 1, -1)), ("path_scan", 2, 1)),
    ((40, 1, 4, 1100, (0,)), ("path_scan", 1, 8)),
    # the longest padded grid of 512 cells, 1x512: 8 lines in 132 KB
    ((64, 1, 512, 2048, (0,)), ("path_scan", 16, 8)),
    # past 512 cells or 3 directions: line_scan_kernel<0>
    ((24, 8, 65, 256, (0, 1, -1)), ("line_scan",)),
    ((24, 32, 32, 64, (0,)), ("line_scan",)),
    ((24, 8, 64, 256, (0, 1, -1, 0)), ("line_scan",))])
def test_scan_bidir_pick(case, want):
    """Which kernel ``scan_bidir`` launches for a shape on the card:
    register-carry where it has an instance, else the path-line kernel up
    to 512 cells (any line length), else ``line_scan_kernel<0>``; and the
    path-line kernel's instance and lines a block."""
    n, sy, sx, nl, shifts = case
    threads, path = tscan._scan_bidir_pick(n, sy, sx, nl, shifts, 132)
    got = (("mgm_scan", threads) if threads is not None
           else ("path_scan", *path) if path is not None else ("line_scan",))
    assert got == want


def test_path_scan_limits_are_the_kernel_source_limits(monkeypatch):
    """``_path_scan_variant`` and ``_path_scan_lines`` read the limits nvcc
    builds ``csrc/sgm_path_scan.cu`` with (part of the library's name: a
    change rebuilds), and its direction limit is the wrapper's."""
    from visionworkbench_torch.ops import _build
    flags = _build.flags("sgm_path_scan")
    cells, lines = _build.PATH_SCAN_MAX_CELLS, _build.PATH_SCAN_MAX_LINES
    assert f"-DVW_PATH_MAX_CELLS={cells}" in flags
    assert f"-DVW_PATH_MAX_LINES={lines}" in flags
    assert "sgm_path_scan" in _build.SOURCES
    assert tscan._path_scan_variant(1, cells, 3) == cells // 32
    assert tscan._path_scan_variant(1, cells + 1, 3) is None
    assert tscan._path_scan_variant(1, cells, 4) is None
    assert tscan._path_scan_lines(1, 17, 10 ** 4, 10 ** 4, (0, 1, -1), 1) == lines
    src = (_build.CSRC / "sgm_path_scan.cu").read_text()
    assert f"constexpr int kMaxDirections = {tscan._MAX_DIRECTIONS};" in src
    name = _build.library_path("sgm_path_scan")
    monkeypatch.setitem(_build.DEFINES, "sgm_path_scan", (
        f"-DVW_PATH_MAX_CELLS={2 * cells}", f"-DVW_PATH_MAX_LINES={lines}"))
    assert _build.library_path("sgm_path_scan") != name


@pytest.mark.parametrize("grid", [(1, 17), (17, 1), (3, 11), (8, 8), (8, 64), (16, 32),
                                  (1, 512), (512, 1), (2, 256)])
@pytest.mark.parametrize("shifts", [(0,), (0, 1, -1)])
def test_path_scan_lines_fill_the_card_and_fit_shared_memory(grid, shifts):
    """Lines a block: a power of two up to the limit, whose block fits
    shared memory, and as many as leave the launch at least half as many
    blocks as the 132 SMs (or 1 where even single lines do not)."""
    from visionworkbench_torch.ops import _build
    sy, sx = grid
    for n, nl in ((256, 256), (12, 5), (1, 1100), (1024, 40)):
        g = tscan._path_scan_lines(sy, sx, n, nl, shifts, 132)
        assert g & (g - 1) == 0 and 1 <= g <= _build.PATH_SCAN_MAX_LINES
        assert tscan._path_scan_smem(sy, sx, g) <= tscan._MAX_SMEM
        blocks = 2 * sum(-(-(nl if s == 0 else nl + n - 1) // g) for s in shifts)
        wider = 2 * g
        if wider <= _build.PATH_SCAN_MAX_LINES and (
                tscan._path_scan_smem(sy, sx, wider) <= tscan._MAX_SMEM):
            assert 2 * 2 * sum(-(-(nl if s == 0 else nl + n - 1) // wider)
                               for s in shifts) < 132
        assert 2 * blocks >= 132 or g == 1


def _path_line_model(cost, pf, pr, shifts, p1, p2, bad, lines):
    """A plain model of ``csrc/sgm_path_scan.cu``'s decomposition: the
    chains (group, direction, line k at lane k + s t), in blocks of
    ``lines`` adjacent lines, each block running the steps at which one of
    its lines is in the frame (the kernel's bounds), a line's carry bad
    until it enters, its 3x3 grid min read from a grid padded with bad.
    Returns the output volume."""
    n, sy, sx, nl = cost.shape
    cells = sy * sx
    out = torch.zeros_like(cost)
    c = torch.arange(cells)
    pidx = (c // sx + 1) * (sx + 2) + c % sx + 1
    for grp, pd in enumerate((pf, pr)):
        for b, s in enumerate(shifts):
            n_lines = nl if s == 0 else nl + n - 1
            for k0 in range(1 - n if s > 0 else 0, (1 - n if s > 0 else 0) + n_lines,
                            lines):
                t_lo, t_hi = 0, n
                if s > 0:
                    t_lo, t_hi = max(0, 1 - k0 - lines), min(n, nl - k0)
                elif s < 0:
                    t_lo, t_hi = max(0, k0 - nl + 1), min(n, k0 + lines)
                carry = torch.full((lines, cells), bad)
                for t in range(t_lo, t_hi):
                    row = n - 1 - t if grp else t
                    for w in range(lines):
                        lane = k0 + w + s * t
                        if not 0 <= lane < nl:
                            continue
                        p, cx = carry[w], cost[row, :, :, lane].reshape(cells)
                        p2m = torch.clamp(torch.floor(torch.tensor(p2) / torch.clamp(
                            pd[row, b, lane], min=1.0)), min=p1)
                        mp = p.min()
                        g = torch.full(((sy + 2) * (sx + 2),), bad)
                        g[pidx] = p
                        q = p
                        if sy > 1:
                            q = torch.minimum(torch.minimum(q, g[pidx - sx - 2]),
                                              g[pidx + sx + 2])
                        g = torch.full_like(g, bad)
                        g[pidx] = q
                        r = q
                        if sx > 1:
                            r = torch.minimum(torch.minimum(r, g[pidx - 1]), g[pidx + 1])
                        v = cx + (torch.minimum(torch.minimum(p, r + p1), mp + p2m) - mp)
                        carry[w] = torch.where(cx >= bad, torch.full_like(v, bad), v)
                        out[row, :, :, lane] += carry[w].reshape(sy, sx)
    return out


@pytest.mark.parametrize("case", [(7, 3, 11, 20, (0, 1, -1), 8), (12, 8, 64, 9, (1, -1), 2),
                                  (9, 1, 17, 30, (0, 1, -1), 1), (5, 17, 1, 3, (1, -1), 4),
                                  (1, 8, 8, 33, (0, 1, -1), 8), (20, 2, 3, 1, (0,), 2)])
def test_path_line_model_matches_plain(case):
    """The path-line kernel's decomposition computes ``scan_bidir``: the
    model of it equals the plain version bit for bit, with N < L and N > L
    (diagonal lines entering and leaving the frame), N = 1 and L = 1."""
    n, sy, sx, nl, shifts, lines = case
    cost, pf, pr = _t(_scan_inputs(35, n, sy, sx, nl, len(shifts)))
    got = _path_line_model(cost, pf, pr, shifts, P1, P2, BAD, lines)
    ref = tscan.scan_bidir_plain(cost, pf, pr, shifts, P1, P2, BAD)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


# The MGM shapes that run a cluster a line on a card (csrc/mgm_cluster_scan.cu;
# one thread a lane: csrc/mgm_scan.cu's kernel): (sy, sx, L) -> (threads a
# lane, cells a thread, threads a block, blocks a cluster)
_CLUSTER_SHAPES = {
    # calc_disparity_sgm(use_mgm=True) at the 64x8 search, 256^2: mgm_bidir
    # (256, 8, 64, 256) and mgm_fwd (512, 4, 8, 64, 256); 512 cells, a lane a
    # warp, 16 lanes a block, 16 blocks (the non-portable cluster size)
    (8, 64, 256): (32, 16, 512, 16),
    # config 6 at 1024^2, level 0: mgm_bidir (1024, 2, 5, 1024), mgm_fwd
    # (2048, 4, 2, 5, 1024); one thread a lane (mgm_scan.cu), 16 blocks of 64
    (2, 5, 1024): (1, 0, 64, 16),
    # one-level MGM with config 6's 64x2 search on 64x512: 128 cells; mgm_bidir
    # (64, 2, 64, 512) and (512, 2, 64, 64), mgm_fwd (576, 4, 2, 64, 64)
    (2, 64, 512): (16, 8, 512, 16),
    (2, 64, 64): (16, 8, 64, 16)}


@pytest.mark.parametrize("shape", sorted(_CLUSTER_SHAPES))
def test_mgm_pick_takes_the_cluster_kernel(shape):
    """Each MGM shape of the main paths that the register-carry kernel does
    not take runs the cluster kernel, with the launch above."""
    assert tscan._mgm_variant(*shape) is None
    assert tscan._mgm_pick(*shape) == (None, _CLUSTER_SHAPES[shape])


@pytest.mark.parametrize("shape,want", [
    # the register-carry kernel's shapes stay there
    ((2, 5, 512), (512, None)), ((1, 16, 33), (64, None)),
    # one thread a lane past 512 lanes, over 16 blocks of the fewest warps
    ((1, 1, 513), (None, (1, 0, 64, 16))), ((4, 4, 4096), (None, (1, 0, 256, 16))),
    ((2, 5, 8192), (None, (1, 0, 512, 16))),
    # 17-256 cells: a lane over 16 threads; 257-512: over a warp; blocks of
    # a power of two of lanes, up to 16 blocks
    ((1, 17, 1), (None, (16, 2, 32, 1))), ((3, 11, 45), (None, (16, 4, 64, 12))),
    ((16, 16, 40), (None, (16, 16, 64, 10))), ((1, 257, 16), (None, (32, 16, 32, 16))),
    ((16, 16, 300), (None, (16, 16, 512, 10))), ((512, 1, 100), (None, (32, 16, 256, 13))),
    # past the limits: line_scan_kernel<1>
    ((2, 5, 8193), (None, None)), ((8, 64, 257), (None, None)),
    ((8, 65, 64), (None, None)), ((16, 16, 600), (None, None)),
    # a long padded grid: 16 lanes a block do not fit shared memory
    ((1, 256, 300), (None, None))])
def test_mgm_pick_by_grid_and_line(shape, want):
    assert tscan._mgm_pick(*shape) == want


@pytest.mark.parametrize("grid", [(1, 1), (2, 5), (4, 4), (1, 17), (17, 1), (3, 11), (8, 8),
                                  (16, 16), (1, 256), (2, 64), (8, 64), (1, 512), (512, 1)])
def test_cluster_variant_fits_the_card(grid):
    """Every launch the picker gives holds the line within the kernel's
    limits: lanes a block a power of two (mgm_cluster_scan.cu), threads a multiple
    of 32, the shared memory of a block, at most 16 blocks, and the line's
    lanes covered; where it gives none, no layout within the limits holds
    the line."""
    from visionworkbench_torch.ops import _build
    sy, sx = grid
    for nl in (1, 31, 64, 100, 256, 513, 1024, 4096, 8192):
        v = tscan._cluster_variant(sy, sx, nl)
        if v is None:
            if sy * sx <= _build.MGM_MAX_CELLS:
                assert nl > _build.CLUSTER_MAX_BLOCKS * _build.MGM_MAX_LANES
            elif sy * sx <= _build.CLUSTER_MAX_CELLS:
                per_warp = 32 // (16 if sy * sx <= 256 else 32)
                most = max(w * per_warp for w in (1, 2, 4, 8, 16) if tscan._cluster_smem(
                    sy, sx, w * per_warp) <= tscan._MAX_SMEM)
                assert _build.CLUSTER_MAX_BLOCKS * most < nl
            continue
        t, k, threads, blocks = v
        assert threads % 32 == 0 and threads >= 32
        assert 1 <= blocks <= _build.CLUSTER_MAX_BLOCKS
        if t == 1:
            # csrc/mgm_scan.cu's kernel over a cluster
            assert sy * sx <= _build.MGM_MAX_CELLS and threads * blocks >= nl
            assert threads <= _build.MGM_MAX_LANES
            continue
        assert threads <= _build.CLUSTER_MAX_THREADS
        lanes = threads // t
        assert lanes & (lanes - 1) == 0 and lanes * blocks >= nl
        assert t * k >= sy * sx and k <= _build.CLUSTER_MAX_CELLS // 32
        assert tscan._cluster_smem(sy, sx, lanes) <= tscan._MAX_SMEM


def test_mgm_pick_takes_the_cluster_kernel_at_config6_level0_1024(monkeypatch):
    """Config 6's MGM pyramid at 1024^2: level 0's three scans (mgm_bidir
    (1024, 2, 5, 1024) twice, mgm_fwd (2048, 4, 2, 5, 1024) once) run the
    cluster kernel, levels 1-4 (at most 512 lanes) the register-carry
    kernel. The scans are replaced by a recorder (no scan runs)."""
    from visionworkbench_torch.math.bbox import BBox2i
    from visionworkbench_torch.stereo import sgm as tsgm
    from visionworkbench_torch.stereo.pyramid_correlation import pyramid_correlate
    seen = {}

    def recorder(kind):
        def scan(cost_t, *args):
            key = (kind, tuple(cost_t.shape))
            seen[key] = seen.get(key, 0) + 1
            return torch.zeros_like(cost_t)
        return scan

    monkeypatch.setattr(tsgm, "mgm_fwd", recorder("mgm_fwd"))
    monkeypatch.setattr(tsgm, "mgm_bidir", recorder("mgm_bidir"))
    img = np.random.default_rng(40).random((1024, 1024)).astype(np.float32)
    pyramid_correlate(img, img, BBox2i(0, -1, 64, 2), kernel_size=(5, 5),
                      max_pyramid_levels=4, tile_size=64, stereo_algorithm="mgm",
                      subpixel="none", device="cpu")
    level0 = {("mgm_fwd", (2048, 4, 2, 5, 1024)): 1, ("mgm_bidir", (1024, 2, 5, 1024)): 2}
    assert {k: v for k, v in seen.items() if k[1][-1] > 512} == level0
    assert sum(seen.values()) == 15
    for (_, shape) in seen:
        threads, cluster = tscan._mgm_pick(*shape[-3:])
        assert (cluster is not None) == (shape[-1] > 512)
        assert (threads is not None) == (shape[-1] <= 512)


def test_cluster_limits_are_built_from_the_macros(monkeypatch):
    """``_cluster_variant`` reads the limits nvcc builds
    ``csrc/mgm_cluster_scan.cu`` and ``csrc/mgm_scan.cu``'s clusters with
    (part of the library's name: a change rebuilds), and the kernel's modes
    are the wrapper's."""
    import re

    from visionworkbench_torch.ops import _build
    flags = _build.flags("mgm_cluster_scan")
    assert f"-DVW_CLUSTER_MAX_BLOCKS={_build.CLUSTER_MAX_BLOCKS}" in _build.flags("mgm_scan")
    for macro, value in (("VW_CLUSTER_MAX_CELLS", _build.CLUSTER_MAX_CELLS),
                         ("VW_CLUSTER_MAX_BLOCKS", _build.CLUSTER_MAX_BLOCKS),
                         ("VW_CLUSTER_MAX_THREADS", _build.CLUSTER_MAX_THREADS)):
        assert f"-D{macro}={value}" in flags
    assert "mgm_cluster_scan" in _build.SOURCES
    cells, blocks = _build.CLUSTER_MAX_CELLS, _build.CLUSTER_MAX_BLOCKS
    # at most cells / 32 a thread, a lane a warp, 16 warps a block
    assert tscan._cluster_variant(8, cells // 8, blocks * 16) is not None
    assert tscan._cluster_variant(1, cells + 1, 16) is None
    assert tscan._cluster_variant(8, cells // 8, blocks * 16 + 1) is None
    lanes = blocks * _build.MGM_MAX_LANES
    assert tscan._cluster_variant(1, _build.MGM_MAX_CELLS, lanes)[3] == blocks
    assert tscan._cluster_variant(1, _build.MGM_MAX_CELLS, lanes + 1) is None
    src = (_build.CSRC / "mgm_cluster_scan.cu").read_text()
    enum = re.search(r"enum Mode \{ kFwd = (\d), kBidir = (\d) \}", src)
    assert tuple(int(x) for x in enum.groups()) == (tscan._MODES["mgm_fwd"],
                                                    tscan._MODES["mgm_bidir"])
    name = _build.library_path("mgm_cluster_scan")
    monkeypatch.setitem(_build.DEFINES, "mgm_cluster_scan", flags[len(_build.NVCC_FLAGS):-1]
                        + (f"-DVW_CLUSTER_MAX_THREADS={_build.CLUSTER_MAX_THREADS // 2}",))
    assert _build.library_path("mgm_cluster_scan") != name


def _grid_terms(p, sy, sx, p1, bad):
    """min_prior and m1 = min(P, min3x3(P) + P1) of priors ``p`` (X, cells),
    the 3x3 grid min through a grid padded with bad, y pass then x pass, as
    the cluster kernel computes them."""
    x = p.shape[0]
    g = torch.full((x, sy + 2, sx + 2), bad)
    g[:, 1:-1, 1:-1] = p.reshape(x, sy, sx)
    q = p.reshape(x, sy, sx)
    if sy > 1:
        q = torch.minimum(torch.minimum(q, g[:, :-2, 1:-1]), g[:, 2:, 1:-1])
    g = torch.full_like(g, bad)
    g[:, 1:-1, 1:-1] = q
    r = q
    if sx > 1:
        r = torch.minimum(torch.minimum(r, g[:, 1:-1, :-2]), g[:, 1:-1, 2:])
    return p.amin(1), torch.minimum(p, r.reshape(x, -1) + p1)


def _cluster_line_model(cost, pd, guard, rev, bidir, lanes, p1, p2, bad):
    """A plain model of ``csrc/mgm_cluster_scan.cu``'s decomposition for one
    line (a cluster): ``cost`` (N, sy, sx, L), ``pd``/``guard`` (N, L). The
    lanes are split into tiles (blocks) of ``lanes``; the lanes past L in
    the last tile compute from garbage and are read by nobody. Each step
    every lane posts (m1 of each cell, mp) to its tile's row in buffer t % 2
    (stamped with t), and a tile's first and last lane also to the
    neighbour tiles' halos (distributed shared memory; unwritten halo
    entries are NaN); then every lane reads its source lanes' rows only
    from there: inside its tile, its tile's halo at the tile's edges, or the
    outside row at the line's ends (a stale buffer fails the stamp check).
    Returns every step's carry in the line's order of rows (n = N - 1 - t
    for ``rev``)."""
    n, sy, sx, nl = cost.shape
    cells = sy * sx
    tiles = -(-nl // lanes)
    pad = tiles * lanes
    c = torch.zeros((n, cells, pad))                  # zeros past L (cp.async fill)
    c[:, :, :nl] = cost.reshape(n, cells, nl)
    pdv = torch.zeros((n, pad))
    pdv[:, :nl] = pd
    keep = torch.ones((n, pad), dtype=torch.bool)
    keep[:, :nl] = guard
    outside = torch.cat([torch.full((cells,), min(bad, bad + p1)), torch.tensor([bad])])
    rows = torch.zeros((2, tiles, lanes, cells + 1))
    halo = torch.full((2, tiles, 2, cells + 1), float("nan"))
    stamp = [-1, -1]
    carry = torch.full((pad, cells), bad)
    out = torch.empty((n, cells, nl))
    for t in range(n):
        row = n - 1 - t if rev else t
        buf = t % 2
        mp, m1 = _grid_terms(carry, sy, sx, p1, bad)
        rows[buf] = torch.cat([m1, mp[:, None]], 1).reshape(tiles, lanes, cells + 1)
        halo[buf, 1:, 0] = rows[buf, :-1, -1]        # a tile's last lane, to the next
        halo[buf, :-1, 1] = rows[buf, 1:, 0]         # its first lane, to the previous
        stamp[buf] = t
        # ---- cluster barrier ----
        assert stamp[buf] == t
        x = rows[buf]
        up = torch.empty_like(x)
        up[:, 1:] = x[:, :-1]
        up[:, 0] = halo[buf, :, 0]
        up[0, 0] = outside
        dn = torch.empty_like(x)
        dn[:, :-1] = x[:, 1:]
        dn[:, -1] = halo[buf, :, 1]
        up, dn = up.reshape(pad, -1), dn.reshape(pad, -1)
        dn[nl - 1:] = outside                        # lane + 1 >= L
        own = torch.cat([m1, mp[:, None]], 1)
        s0, s1 = (up, dn) if bidir else (own, up)
        cx = c[row].T                                # (pad, cells)
        p2m = torch.clamp(torch.floor(torch.full_like(pdv[row], p2)
                                      / torch.clamp(pdv[row], min=1.0)), min=p1)[:, None]
        va = cx + (torch.minimum(s0[:, :cells], s0[:, cells:] + p2m) - s0[:, cells:])
        vb = cx + (torch.minimum(s1[:, :cells], s1[:, cells:] + p2m) - s1[:, cells:])
        v = torch.where(keep[row][:, None], torch.floor((va + vb) * 0.5), cx)
        carry = torch.where(cx >= bad, torch.full_like(v, bad), v)
        out[row] = carry[:nl].T
    return out.reshape(n, sy, sx, nl)


# (N, sy, sx, L, lanes a tile, inputs): L not a multiple of the tile, L = 1,
# one tile, N = 1, guards off, absent candidates, grids of up to 16 cells
# (mgm_scan.cu's clusters) and wider (mgm_cluster_scan.cu)
_CLUSTER_MODEL_CASES = [
    (7, 3, 11, 20, 8, {}), (5, 8, 8, 1, 16, {}), (6, 2, 5, 16, 16, {}),
    (1, 8, 64, 9, 4, {}), (9, 1, 17, 33, 4, dict(guard_off=1.0)),
    (8, 2, 5, 40, 8, dict(bad_frac=0.9)), (12, 17, 1, 30, 2, dict(guard_off=0.0)),
    (10, 2, 64, 24, 4, {})]


@pytest.mark.parametrize("case", _CLUSTER_MODEL_CASES)
def test_cluster_line_model_matches_plain(case):
    """The cluster kernel's decomposition computes ``mgm_bidir`` (two
    lines, group 1 reverse, added) and ``mgm_fwd`` (a line per orientation):
    the model of it equals the plain versions bit for bit."""
    n, sy, sx, nl, lanes, fill = case
    cost, pf, pr, gf, gr = _t(_mgm_inputs(41, n, sy, sx, nl, **fill))
    got = sum(_cluster_line_model(cost, pd, g, rev, True, lanes, P1, P2, BAD)
              for pd, g, rev in ((pf, gf, False), (pr, gr, True)))
    ref = tscan.mgm_bidir_plain(cost, pf, pr, gf, gr, (1, -1), P1, P2, BAD)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    cost, pd, g = _t(_fwd_inputs(42, n, 2, sy, sx, nl, **fill))
    got = torch.stack([_cluster_line_model(cost[:, b], pd[:, b], g[:, b], False, False,
                                           lanes, P1, P2, BAD) for b in range(2)], 1)
    ref = tscan.mgm_fwd_plain(cost, pd, g, (0, 1), P1, P2, BAD)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


def test_ablation_variants_edit_the_kernel_source(tmp_path):
    """Each variant of ``tools/mgm_scan_ablation.py`` is a text edit of
    ``csrc/mgm_scan.cu`` whose text occurs there exactly once."""
    from visionworkbench_torch.tools import mgm_scan_ablation as ablation
    paths = ablation._variant_sources(tmp_path, [])
    assert set(paths) == set(ablation.ABLATIONS)
    as_is = paths["as_is"].read_text()
    for name, path in paths.items():
        assert (path.read_text() != as_is) == bool(ablation.ABLATIONS[name])


def test_path_ablation_variants_edit_the_kernel_source(tmp_path):
    """Each variant of ``tools/path_scan_ablation.py`` is a text edit of
    ``csrc/sgm_path_scan.cu`` whose text occurs there exactly once."""
    from visionworkbench_torch.tools import path_scan_ablation as ablation
    paths = ablation._variant_sources(tmp_path)
    assert set(paths) == set(ablation.ABLATIONS)
    as_is = paths["as_is"].read_text()
    for name, path in paths.items():
        assert (path.read_text() != as_is) == bool(ablation.ABLATIONS[name])


def test_cluster_ablation_variants_edit_the_kernel_source(tmp_path):
    """Each variant of ``tools/mgm_cluster_ablation.py`` is a text edit of
    ``csrc/mgm_cluster_scan.cu`` whose text occurs there exactly once."""
    from visionworkbench_torch.tools import mgm_cluster_ablation as ablation
    paths = ablation._variant_sources(tmp_path)
    assert set(paths) == set(ablation.ABLATIONS)
    as_is = paths["as_is"].read_text()
    for name, path in paths.items():
        assert (path.read_text() != as_is) == bool(ablation.ABLATIONS[name])


def test_wrappers_reject_bad_arguments():
    cost, pf, pr = _t(_scan_inputs(23, 4, 1, 2, 8, 1))
    with pytest.raises(ArgumentErr):
        tscan.scan_bidir(cost, pf, pr, (0, 1), P1, P2, BAD)     # B mismatch
    with pytest.raises(ArgumentErr):
        tscan.scan_bidir(cost, pf, pr, (2,), P1, P2, BAD)       # shift > 1
    with pytest.raises(ArgumentErr):
        tscan.mgm_bidir(cost, pf[:, 0], pr[:, 0], pf[:, 0] > 0, pr[:, 0] > 0,
                        (1,), P1, P2, BAD)
    with pytest.raises(ArgumentErr):
        tscan.mgm_fwd(cost, pf, pf > 0, (0, 1), P1, P2, BAD)     # not 5D


# ---- the CUDA kernels against the plain versions (on the card) --------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", [(24, 2, 5, 128, (0, 1, -1)), (40, 1, 4, 1100, (0,)),
                                  (7, 3, 3, 33, (1, -1)),
                                  # a 64x8 search (512 cells)
                                  (24, 8, 64, 256, (0, 1, -1))])
def test_scan_bidir_kernel_matches_plain(cuda, case):
    """The wrapper's pick: the register-carry kernel, or the path-line
    kernel for lines past 512 lanes (1100) and the 64x8 search, as the
    counts show."""
    n, sy, sx, nl, shifts = case
    args = _t(_scan_inputs(24, n, sy, sx, nl, len(shifts)), cuda)
    before = tscan.launches["scan_bidir"]
    reg = tscan.mgm_scan_launches["scan_bidir"]
    path = tscan.path_scan_launches["scan_bidir"]
    got = tscan.scan_bidir(*args, shifts, P1, P2, BAD)
    assert tscan.launches["scan_bidir"] == before + 1
    on_reg = int(tscan._scan_variant(sy, sx, nl, len(shifts)) is not None)
    assert on_reg == int(nl <= 512 and sy * sx <= 16)
    assert tscan.mgm_scan_launches["scan_bidir"] == reg + on_reg
    assert tscan.path_scan_launches["scan_bidir"] == path + 1 - on_reg
    ref = tscan.scan_bidir_plain(*args, shifts, P1, P2, BAD)
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())


def _scan_both_kernels(args, shifts):
    """scan_bidir through its wrapper on the register-carry kernel, held bit
    for bit against its plain version and against line_scan_kernel<0> on
    the same inputs; the counts show which kernel ran each time."""
    before = tscan.launches["scan_bidir"]
    reg = tscan.mgm_scan_launches["scan_bidir"]
    got = tscan.scan_bidir(*args, shifts, P1, P2, BAD)
    assert tscan.mgm_scan_launches["scan_bidir"] == reg + 1
    old = tscan._scan_bidir_cuda(*args, shifts, P1, P2, BAD, None)
    assert tscan.launches["scan_bidir"] == before + 2
    assert tscan.mgm_scan_launches["scan_bidir"] == reg + 1
    ref = tscan.scan_bidir_plain(*args, shifts, P1, P2, BAD)
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())
    np.testing.assert_array_equal(got.cpu().numpy(), old.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("shifts", [(0,), (0, 1, -1), (1, -1)])
@pytest.mark.parametrize("grid", [(2, 5), (1, 5), (1, 4)])
def test_scan_bidir_register_kernel_matches_plain(cuda, shifts, grid):
    """Config 6's grids over two whole warps and more, each shift set."""
    args = _t(_scan_inputs(33, 20, *grid, 128, len(shifts)), cuda)
    _scan_both_kernels(args, shifts)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    (24, 1, 5, 65, (0, 1, -1), 0.05),     # a ragged line (partial warp)
    (24, 2, 5, 96, (1, -1), 0.03),        # a 3 % share of absent costs
    (24, 2, 5, 64, (0, 1, -1), 0.9),      # a cost plane that is mostly bad
    (512, 2, 5, 512, (0, 1, -1), 0.03),   # config 6's level-0 x-scan
    (512, 2, 5, 512, (0,), 0.03)])        # and y-scan
def test_scan_bidir_register_kernel_edges_and_level0(cuda, case):
    n, sy, sx, nl, shifts, bad_frac = case
    args = _t(_scan_inputs(34, n, sy, sx, nl, len(shifts), bad_frac), cuda)
    _scan_both_kernels(args, shifts)


# (N, sy, sx, L, shifts): 17, 33, 64 and 512 cells; grids (1, 17), (17, 1),
# (3, 11), (8, 8), (8, 64), (16, 32); lanes 1, 33, 256, 1100; N = 1, N < L,
# N > L; a 3 % share of absent costs
_PATH_CASES = [
    (20, 1, 17, 33, (0, 1, -1)), (40, 17, 1, 33, (1, -1)), (1, 3, 11, 256, (0,)),
    (50, 3, 11, 33, (0, 1, -1)), (12, 8, 8, 1, (0, 1, -1)), (1, 8, 8, 33, (1, -1)),
    (24, 8, 64, 256, (0, 1, -1)), (300, 8, 64, 33, (1, -1)), (7, 16, 32, 1100, (0,)),
    (40, 16, 32, 256, (0, 1, -1)), (256, 8, 64, 256, (0,))]


def _path_both_kernels(args, shifts, path=None):
    """scan_bidir on the path-line kernel (the wrapper's pick, or ``path``
    forced), held bit for bit against its plain version and against
    line_scan_kernel<0> on the same inputs; the counts show which kernel
    ran each time."""
    before = tscan.launches["scan_bidir"]
    runs = tscan.path_scan_launches["scan_bidir"]
    if path is None:
        got = tscan.scan_bidir(*args, shifts, P1, P2, BAD)
    else:
        got = tscan._scan_bidir_cuda(*args, shifts, P1, P2, BAD, None, path)
    assert tscan.path_scan_launches["scan_bidir"] == runs + 1
    old = tscan._scan_bidir_cuda(*args, shifts, P1, P2, BAD, None)
    assert tscan.launches["scan_bidir"] == before + 2
    assert tscan.path_scan_launches["scan_bidir"] == runs + 1
    ref = tscan.scan_bidir_plain(*args, shifts, P1, P2, BAD)
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())
    np.testing.assert_array_equal(got.cpu().numpy(), old.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("case", _PATH_CASES)
def test_path_scan_kernel_matches_plain_and_line_scan(cuda, case):
    n, sy, sx, nl, shifts = case
    args = _t(_scan_inputs(36, n, sy, sx, nl, len(shifts), 0.03), cuda)
    _path_both_kernels(args, shifts)


@pytest.mark.cuda
@pytest.mark.parametrize("lines", [1, 2, 4, 8])
@pytest.mark.parametrize("case", [(30, 3, 11, 45, (0, 1, -1)), (9, 8, 64, 70, (1, -1))])
def test_path_scan_kernel_every_block_width(cuda, case, lines):
    """Each number of lines a block, forced, on shapes whose lines do not
    divide into whole blocks."""
    n, sy, sx, nl, shifts = case
    args = _t(_scan_inputs(37, n, sy, sx, nl, len(shifts), 0.03), cuda)
    _path_both_kernels(args, shifts, (tscan._path_scan_variant(sy, sx, len(shifts)), lines))


def _mgm_both_kernels(args, fargs):
    """mgm_bidir and mgm_fwd through their wrappers, each held bit for bit
    against its plain version and, where the wrapper ran the register-carry
    or the cluster kernel, against line_scan_kernel<1> on the same inputs.
    Returns the kernel each ran, by the counts: "mgm_scan", "cluster_scan"
    or "line_scan"."""
    ran = {}
    for name, a, shifts, plain in (("mgm_bidir", args, (1, -1), tscan.mgm_bidir_plain),
                                   ("mgm_fwd", fargs, (0, 1), tscan.mgm_fwd_plain)):
        before = (tscan.launches[name], tscan.mgm_scan_launches[name],
                  tscan.cluster_scan_launches[name])
        got = getattr(tscan, name)(*a, shifts, P1, P2, BAD)
        after = (tscan.launches[name], tscan.mgm_scan_launches[name],
                 tscan.cluster_scan_launches[name])
        assert after[0] == before[0] + 1
        ran[name] = ("mgm_scan" if after[1] > before[1] else
                     "cluster_scan" if after[2] > before[2] else "line_scan")
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      plain(*a, shifts, P1, P2, BAD).cpu().numpy())
        if ran[name] != "line_scan":
            old = getattr(tscan, f"_{name}_cuda")(*a, shifts, P1, P2, BAD, None)
            np.testing.assert_array_equal(got.cpu().numpy(), old.cpu().numpy())
    return ran


def _picked(sy, sx, nl):
    """The kernel the MGM wrappers pick for a shape, named as
    :func:`_mgm_both_kernels` returns it."""
    threads, cluster = tscan._mgm_pick(sy, sx, nl)
    return ("mgm_scan" if threads is not None else
            "cluster_scan" if cluster is not None else "line_scan")


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    (16, 2, 5, 128),
    # grids (1, 1), (1, 4), (3, 3) and 16 cells; partial warps (33, 65),
    # whole warps (64, 512, the longest line an instance takes)
    (12, 1, 1, 33), (12, 1, 4, 64), (12, 3, 3, 65), (10, 4, 4, 512),
    (10, 1, 16, 64), (10, 16, 1, 33),
    # lines too long for any instance (1024, 1030, 600) and a wide window:
    # the cluster kernel (line_scan_kernel<1> before it)
    (9, 2, 3, 1024),
    (9, 1, 1, 1030), (9, 1, 7, 600), (9, 3, 3, 600), (9, 8, 16, 256),
    # the (1, 5) grid of config 6's levels 1-3
    (12, 1, 5, 64), (16, 1, 5, 256)])
def test_mgm_kernels_match_plain(cuda, case):
    n, sy, sx, nl = case
    args = _t(_mgm_inputs(25, n, sy, sx, nl), cuda)
    fargs = _t(_fwd_inputs(26, n, 4, sy, sx, nl), cuda)
    want = _picked(sy, sx, nl)
    assert want == ("mgm_scan" if sy * sx <= 16 and nl <= 512 else "cluster_scan")
    assert _mgm_both_kernels(args, fargs) == {"mgm_bidir": want, "mgm_fwd": want}


@pytest.mark.cuda
@pytest.mark.parametrize("fill", [dict(guard_off=1.0), dict(guard_off=0.0),
                                  dict(bad_frac=0.9)])
def test_mgm_kernels_guards_and_absent_costs(cuda, fill):
    """Guards all false, all true, and a cost plane that is mostly bad."""
    args = _t(_mgm_inputs(28, 24, 2, 5, 65, **fill), cuda)
    fargs = _t(_fwd_inputs(29, 24, 4, 2, 5, 65, **fill), cuda)
    assert _mgm_both_kernels(args, fargs) == {"mgm_bidir": "mgm_scan",
                                              "mgm_fwd": "mgm_scan"}


@pytest.mark.cuda
def test_mgm_kernels_match_plain_at_level0(cuda):
    """Config 6's level-0 shapes: mgm_fwd (1024, 4, 2, 5, 512) and
    mgm_bidir (512, 2, 5, 512)."""
    args = _t(_mgm_inputs(30, 512, 2, 5, 512), cuda)
    fargs = _t(_fwd_inputs(31, 1024, 4, 2, 5, 512), cuda)
    assert _mgm_both_kernels(args, fargs) == {"mgm_bidir": "mgm_scan",
                                              "mgm_fwd": "mgm_scan"}


# (N, sy, sx, L, inputs): the cluster kernel's main-path shapes with fewer
# steps (the 64x8 search over 256 lanes, 16 blocks; config 6's level 0 at
# 1024^2; the one-level 64x2 search's 128 cells over 512 and 64 lanes), an
# odd grid over lanes that do not fill the last block, N = 1, L = 1, one
# thread a lane over 513 and 4096 lanes (3 and 16 blocks), guards all off,
# a mostly absent cost plane
_CLUSTER_CASES = [
    (24, 8, 64, 256, {}), (40, 2, 5, 1024, {}), (12, 2, 64, 512, {}), (30, 2, 64, 64, {}),
    (20, 3, 11, 45, {}), (1, 8, 64, 40, {}), (9, 3, 11, 1, {}), (20, 1, 17, 33, {}),
    (16, 17, 1, 70, {}), (12, 1, 1, 513, {}), (6, 4, 4, 4096, {}),
    (16, 16, 16, 100, {}), (10, 1, 300, 20, {}),
    (20, 2, 5, 700, dict(guard_off=1.0)), (20, 8, 8, 90, dict(bad_frac=0.9))]


@pytest.mark.cuda
@pytest.mark.parametrize("case", _CLUSTER_CASES)
def test_cluster_kernel_matches_plain_and_line_scan(cuda, case):
    n, sy, sx, nl, fill = case
    args = _t(_mgm_inputs(43, n, sy, sx, nl, **fill), cuda)
    fargs = _t(_fwd_inputs(44, 2 * n, 4, sy, sx, nl, **fill), cuda)
    assert _picked(sy, sx, nl) == "cluster_scan"
    assert _mgm_both_kernels(args, fargs) == {"mgm_bidir": "cluster_scan",
                                              "mgm_fwd": "cluster_scan"}


@pytest.mark.cuda
def test_cluster_kernel_at_the_64x8_search(cuda):
    """calc_disparity_sgm(use_mgm=True)'s scans at the 64x8 search on 256^2,
    full length: mgm_bidir (256, 8, 64, 256), mgm_fwd (512, 4, 8, 64, 256)."""
    args = _t(_mgm_inputs(45, 256, 8, 64, 256, 0.03), cuda)
    fargs = _t(_fwd_inputs(46, 512, 4, 8, 64, 256, 0.03), cuda)
    assert _mgm_both_kernels(args, fargs) == {"mgm_bidir": "cluster_scan",
                                              "mgm_fwd": "cluster_scan"}
