"""SGM/MGM aggregation scans: the CUDA kernels of ``csrc/sgm_scan.cu``,
``csrc/mgm_scan.cu``, ``csrc/sgm_path_scan.cu`` and
``csrc/mgm_cluster_scan.cu``, their plain PyTorch versions and the wrappers
that pick between them by device.

Replaces the TPU kernels of ``visionworkbench_tpu/ops/sgm_scan.py``:

* ``scan_bidir`` — ``pallas_scan_bidir`` (``pl.pallas_call`` at ``:149``):
  the 8-path SGM recurrence, forward and reverse over B path directions
  whose carry is lane-shifted by {0, +-1};
* ``mgm_bidir`` — ``pallas_mgm_bidir`` (``:222``): the MGM diagonal-pair
  tasks, forward and reverse, each step averaging the path update at lane
  shifts +1 and -1;
* ``mgm_fwd`` — ``pallas_mgm_fwd`` (``:272``): the same MGM step as a
  forward scan over B sheared orientations with prior shifts (0, +1),
  returning every step's carry.

The plain versions are the ``lax.scan`` engines of the JAX package's
``stereo/sgm.py`` (``_scan_bidir`` ``:201``, the scan of ``_mgm_plain_scan``
``:320-336`` and the scan body of ``_mgm_sheared_scan`` ``:390-401``),
written as Python loops over the N steps with the helpers below
(``_grid_min3`` ``:133``, ``_path_update`` ``:152``, ``_force_bad`` ``:170``,
``_shift_lane`` ``:177``).

Every value is an integer-valued fp32 below 2^24 (census costs <= 64, the
absent-candidate value ``bad = 255 + P2``, sums of 8 paths), so sums are
exact in any order and each kernel equals its plain version bit for bit.

On the card, the three wrappers take the register-carry kernel of
``csrc/mgm_scan.cu`` where it has an instance for the grid and line (up to
``_build.MGM_MAX_CELLS`` disparity cells over up to ``_build.MGM_MAX_LANES``
lanes; :func:`_mgm_variant`, :func:`_scan_variant`), with the MGM wrapper's
own pair of lane shifts or, for ``scan_bidir``, up to 3 path directions.
Every other ``scan_bidir`` of up to ``_build.PATH_SCAN_MAX_CELLS`` cells
(``calc_disparity_sgm``'s 64x8 search: 512), at any line length, runs
``csrc/sgm_path_scan.cu``, one warp per path line
(:func:`_path_scan_variant`, :func:`_path_scan_lines`). Every other MGM
scan whose line fits one thread-block cluster spreads the line's lanes over
the cluster's blocks (:func:`_cluster_variant`; :func:`_mgm_pick` picks):
grids of up to ``_build.MGM_MAX_CELLS`` cells on longer lines (config 6's
level 0 past 512^2: 1024 lanes) run the register-carry kernel of
``csrc/mgm_scan.cu`` as a cluster, wider grids of up to
``_build.CLUSTER_MAX_CELLS`` cells (``calc_disparity_sgm(use_mgm=True)``'s
64x8 search: 512) ``csrc/mgm_cluster_scan.cu``. Wider grids run
``line_scan_kernel<0>`` (``scan_bidir``), and MGM shapes past the cluster
kernel's limits ``line_scan_kernel<1>``, of ``csrc/sgm_scan.cu``, which
compute the same functions. Any search window runs on the card:
``line_scan_kernel``'s carry goes to a global scratch buffer where it does
not fit a block's shared memory. What bounds the kernels on the H100, and
what their design does about it: see the notes at the top of the sources.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.ops import _build

# Kernel launches since the count was last set to 0, one count per wrapper
# (each wrapper adds one per launch of a CUDA kernel, and nowhere else), and
# of those the launches that went to the register-carry kernel of
# csrc/mgm_scan.cu with one block a line, to the path-line kernel of
# csrc/sgm_path_scan.cu and to a cluster a line (csrc/mgm_cluster_scan.cu,
# or csrc/mgm_scan.cu's MGM modes over more than one block); the rest ran
# line_scan_kernel of csrc/sgm_scan.cu.
launches = {"scan_bidir": 0, "mgm_bidir": 0, "mgm_fwd": 0}
mgm_scan_launches = {"scan_bidir": 0, "mgm_bidir": 0, "mgm_fwd": 0}
path_scan_launches = {"scan_bidir": 0}
cluster_scan_launches = {"mgm_bidir": 0, "mgm_fwd": 0}

_MAX_THREADS = 1024
_MAX_SMEM = 232448        # bytes of shared memory one H100 block may opt into
# Each MGM wrapper's lane shifts on the main path, the pair its instances take.
_MGM_SHIFTS = {"mgm_bidir": (-1, 1), "mgm_fwd": (0, 1)}
# csrc/mgm_scan.cu's modes (its vw_mgm_scan mode argument).
_MODES = {"mgm_fwd": 0, "mgm_bidir": 1, "scan_bidir": 2}
_MAX_DIRECTIONS = 3       # path directions a scan_bidir launch takes
_lib = None
_mgm_lib = None
_path_lib = None
_cluster_lib = None


def _mgm_variant(sy: int, sx: int, nl: int):
    """Threads per block of the register-carry MGM kernel
    (``csrc/mgm_scan.cu``) for a (``sy``, ``sx``) grid over ``nl`` lanes,
    or None where ``line_scan_kernel<1>`` (``csrc/sgm_scan.cu``) runs the
    shape: more than ``_build.MGM_MAX_CELLS`` cells (wide search windows,
    those whose carry is in global scratch included), lines of more than
    ``_build.MGM_MAX_LANES`` lanes. The limits are the instances' own: nvcc
    builds them from the same numbers."""
    if sy * sx > _build.MGM_MAX_CELLS or nl > _build.MGM_MAX_LANES:
        return None
    return -(-nl // 32) * 32


def _scan_variant(sy: int, sx: int, nl: int, b: int):
    """Threads per block of the register-carry kernel's SGM mode for
    ``b`` path directions over a (``sy``, ``sx``) grid of ``nl`` lanes, or
    None where ``line_scan_kernel<0>`` runs the shape: the limits of
    :func:`_mgm_variant` (the same instances), and more than 3 directions."""
    if b > _MAX_DIRECTIONS:
        return None
    return _mgm_variant(sy, sx, nl)


def _path_scan_variant(sy: int, sx: int, b: int):
    """Cells a thread (K) of the path-line kernel's instance
    (``csrc/sgm_path_scan.cu``) for ``b`` path directions over a (``sy``,
    ``sx``) grid, or None where ``line_scan_kernel<0>`` runs the shape: more
    than ``_build.PATH_SCAN_MAX_CELLS`` cells, or more than 3 directions.
    A warp holds a line's cells, K = 1, 2, 4, ... a thread; nvcc builds the
    instances from the same limit."""
    cells = sy * sx
    if b > _MAX_DIRECTIONS or cells > _build.PATH_SCAN_MAX_CELLS:
        return None
    k = 1
    while 32 * k < cells:
        k *= 2
    return k


def _path_scan_smem(sy: int, sx: int, lines: int) -> int:
    """Shared memory (bytes) of a path-scan block of ``lines`` warps (as
    ``csrc/sgm_path_scan.cu:smem_bytes``): the double-buffered slab of
    cells x lines costs (row stride: the cells rounded up to a warp, plus
    32 / lines) and of its |dI|, and each warp's two padded (sy + 2, sx + 2)
    grids."""
    stride = -(-sy * sx // 32) * 32 + (32 // lines) % 32
    return 4 * (2 * lines * (stride + 1) + 2 * lines * (sy + 2) * (sx + 2))


def _path_scan_lines(sy: int, sx: int, n: int, nl: int, shifts, sms: int) -> int:
    """Path lines (warps) a block of the path-line kernel: the most, up to
    ``_build.PATH_SCAN_MAX_LINES`` (8 lanes: a 32-byte sector a cell row of
    the slab and of the atomics), whose shared memory fits a block, halved
    while the launch has fewer blocks than half the ``sms`` SMs. The lines
    of a launch: 2 groups x (``nl`` a direction with shift 0, ``nl`` + ``n``
    - 1 diagonals with shift +-1). At ``calc_disparity_sgm``'s 64x8 search
    on 256^2 this gives the x-scan 8 and the y-scan 4 lines a block (128
    blocks), the fastest of 1-8 for each on an H100 (``chip_smoke.py``
    phase 5; ``PERF.md``): fewer lines fill more SMs, but each request of
    the slab and the atomics then carries less of its 32-byte sector."""
    lines = _build.PATH_SCAN_MAX_LINES
    while lines > 1 and _path_scan_smem(sy, sx, lines) > _MAX_SMEM:
        lines //= 2

    def blocks(g):
        return 2 * sum(-(-(nl if s == 0 else nl + n - 1) // g) for s in shifts)

    while lines > 1 and 2 * blocks(lines) < sms:
        lines //= 2
    return lines


def _scan_bidir_pick(n: int, sy: int, sx: int, nl: int, shifts, sms: int):
    """The kernel of a ``scan_bidir`` on the card, as ``(threads, path)``
    for :func:`_scan_bidir_cuda`: the register-carry kernel where
    :func:`_scan_variant` has an instance (``threads``), else the path-line
    kernel where :func:`_path_scan_variant` has one (``path`` = (cells a
    thread, lines a block) for a card of ``sms`` SMs), else
    ``line_scan_kernel<0>`` (both None)."""
    threads = _scan_variant(sy, sx, nl, len(shifts))
    k = None if threads is not None else _path_scan_variant(sy, sx, len(shifts))
    if k is None:
        return threads, None
    return None, (k, _path_scan_lines(sy, sx, n, nl, shifts, sms))


def _cluster_smem(sy: int, sx: int, lanes: int) -> int:
    """Shared memory (bytes) of a block of the cluster kernel holding ``lanes`` lanes (as ``csrc/mgm_cluster_scan.cu:
    vw_mgm_cluster_scan``): the double-buffered exchange rows (m1 of each
    cell and mp), the outside row, each lane's padded (sy + 2, sx + 2) grid,
    the double-buffered slab of cells x (lanes + 1), the double-buffered two
    halo rows; rows padded to 16 mod 32 floats."""
    def stride16(v):
        return v + (16 - v % 32) % 32

    cells = sy * sx
    rs, pgs = stride16(cells + 1), stride16((sy + 2) * (sx + 2))
    return 4 * (2 * lanes * rs + rs + lanes * pgs + 2 * cells * (lanes + 1) + 4 * rs)


def _cluster_variant(sy: int, sx: int, nl: int):
    """The launch of a line over a thread-block cluster for a (``sy``,
    ``sx``) grid over ``nl`` lanes, as ``(t, k, threads, blocks)``: threads a
    lane (1: ``mgm_scan_kernel`` of ``csrc/mgm_scan.cu``, one thread a lane
    with its cells in registers, for grids of up to ``_build.MGM_MAX_CELLS``
    cells, k unused (0); 16, or 32 past 256 cells: ``cluster_wide_kernel``
    of ``csrc/mgm_cluster_scan.cu``, k cells a thread), threads a block and
    blocks a cluster (one cluster a line). None where ``line_scan_kernel<1>``
    runs the shape: more than ``_build.CLUSTER_MAX_CELLS`` cells, or a line
    that ``_build.CLUSTER_MAX_BLOCKS`` blocks (of ``_build.MGM_MAX_LANES``
    threads, or of ``_build.CLUSTER_MAX_THREADS`` threads and the shared
    memory a block has) do not hold. A line is spread over as many blocks as
    it fills, up to ``_build.CLUSTER_MAX_BLOCKS``, each of the fewest warps
    (lanes a block a power of two for ``cluster_wide_kernel``) that hold it:
    config 6's level 0 at 1024^2 takes 1.59 / 3.12 ms (bidir / fwd) over 16
    blocks of 64 lanes, 1.68 / 3.19 over 8, 1.95 / 3.58 over 4 and 2.47 /
    4.37 over 2 (chip_smoke.py phase 5, PERF.md)."""
    cells = sy * sx
    max_blocks, max_threads = _build.CLUSTER_MAX_BLOCKS, _build.CLUSTER_MAX_THREADS
    if cells <= _build.MGM_MAX_CELLS:
        blocks = min(max_blocks, -(-nl // 32))
        threads = -(-nl // (32 * blocks)) * 32
        return (1, 0, threads, blocks) if threads <= _build.MGM_MAX_LANES else None
    max_k = _build.CLUSTER_MAX_CELLS // 32
    if cells > 32 * max_k:
        return None
    t = 16 if cells <= 16 * max_k else 32
    k = 1
    while t * k < cells:
        k *= 2
    per_warp = 32 // t
    warps = -(-nl // per_warp)
    w = 1
    while w * max_blocks < warps:
        w *= 2
    if 32 * w > max_threads or _cluster_smem(sy, sx, w * per_warp) > _MAX_SMEM:
        return None
    return t, k, 32 * w, -(-warps // w)


def _mgm_pick(sy: int, sx: int, nl: int):
    """The kernel of an MGM scan (main-path shifts) on the card, as
    ``(threads, cluster)`` for :func:`_mgm_bidir_cuda` /
    :func:`_mgm_fwd_cuda`: the register-carry kernel where
    :func:`_mgm_variant` has an instance (``threads``), else the cluster
    kernel where :func:`_cluster_variant` has a launch (``cluster``), else
    ``line_scan_kernel<1>`` (both None)."""
    threads = _mgm_variant(sy, sx, nl)
    if threads is not None:
        return threads, None
    return None, _cluster_variant(sy, sx, nl)


def _bind_mgm(lib):
    """Set the argument types of ``vw_mgm_scan`` on a loaded library."""
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.vw_mgm_scan.argtypes = [
        i, p, p, p, p, p, p, p, p,     # mode, cost/pd/guard/out per group
        i, i, i, i, i, i,              # groups, B, N, sy, sx, L
        ll, ll, ll, ll, ll, ll,        # strides
        i, i, i,                       # lane shifts (SGM)
        f, f, f, i, i, p]              # p1, p2, bad, threads, blocks, stream
    lib.vw_mgm_scan.restype = i
    return lib


def _mgm_library():
    global _mgm_lib
    if _mgm_lib is None:
        _mgm_lib = _bind_mgm(_build.load("mgm_scan"))
    return _mgm_lib


def _bind_cluster(lib):
    """Set the argument types of ``vw_mgm_cluster_scan`` on a loaded
    library."""
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.vw_mgm_cluster_scan.argtypes = [
        i, p, p, p, p, p, p, p, p,     # mode, cost/pd/guard/out per group
        i, i, i, i, i,                 # lines, N, sy, sx, L
        ll, ll, ll, ll, ll, ll,        # strides
        f, f, f,                       # p1, p2, bad
        i, i, i, i, p]                 # t, k, threads, blocks, stream
    lib.vw_mgm_cluster_scan.restype = i
    return lib


def _cluster_library():
    global _cluster_lib
    if _cluster_lib is None:
        _cluster_lib = _bind_cluster(_build.load("mgm_cluster_scan"))
    return _cluster_lib


def _bind_path(lib):
    """Set the argument types of ``vw_path_scan`` on a loaded library."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.vw_path_scan.argtypes = [
        p, p, p, p,                    # cost, pd_f, pd_r, out
        i, i, i, i, i,                 # B, N, sy, sx, L
        i, i, i,                       # lane shifts
        f, f, f, i, i, p]              # p1, p2, bad, k, lines, stream
    lib.vw_path_scan.restype = i
    return lib


def _path_library():
    global _path_lib
    if _path_lib is None:
        _path_lib = _bind_path(_build.load("sgm_path_scan"))
    return _path_lib


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("sgm_scan")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.vw_line_scan.argtypes = [
            i, p, p, p, p, p, p, p, p,     # mode, cost/pd/guard/out per group
            p,                             # scratch (null: shared memory)
            i, i, i, i, i, i,              # groups, B, N, sy, sx, L
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            i, i, i, i, i,                 # reverse group 1, shifts[3], store
            f, f, f, i, ctypes.c_longlong, p]
        lib.vw_line_scan.restype = i
        _lib = lib
    return _lib


# ---- helpers of the plain versions (twins of stereo/sgm.py's) --------------

def _grid_min3(p: torch.Tensor, bad: float) -> torch.Tensor:
    """Exact 3x3 neighbourhood min over the (sy, sx) disparity grid of
    ``p`` (..., sy, sx, L); out-of-grid neighbours count as ``bad``. Two
    separable shifted-min passes."""
    sy, sx = p.shape[-3], p.shape[-2]
    q = p
    if sy > 1:
        big = torch.full_like(p[..., :1, :, :], bad)
        q = torch.minimum(q, torch.cat([big, p[..., :-1, :, :]], -3))
        q = torch.minimum(q, torch.cat([p[..., 1:, :, :], big], -3))
    if sx > 1:
        big = torch.full_like(q[..., :, :1, :], bad)
        r = torch.minimum(q, torch.cat([big, q[..., :, :-1, :]], -2))
        q = torch.minimum(r, torch.cat([q[..., :, 1:, :], big], -2))
    return q


def _path_update(prior, cost, pdiff, p1: float, p2: float, bad: float):
    """One SGM step for a batch of whole lines: ``C + min(prior,
    nbhd3x3(prior)+P1, min_prior+P2') - min_prior`` with ``P2' = max(
    floor(P2 / max(|dI|, 1)), P1)`` (ref ``evaluate_path``,
    SGM.cc:806-850). ``prior``/``cost`` (..., sy, sx, L), ``pdiff`` (..., L)."""
    min_prior = prior.amin(dim=(-3, -2))
    # tensor / tensor: PyTorch computes ``scalar / tensor`` as a reciprocal
    # times the scalar, which is not the IEEE quotient this floor needs
    p2m = torch.clamp(torch.floor(torch.full_like(pdiff, p2)
                                  / torch.clamp(pdiff, min=1.0)), min=p1)
    nb = _grid_min3(prior, bad) + p1
    best = torch.minimum(torch.minimum(prior, nb),
                         (min_prior + p2m)[..., None, None, :])
    return cost + (best - min_prior[..., None, None, :])


def _force_bad(out, cost, bad: float):
    """Re-force absent candidates (cost >= bad) to exactly ``bad`` (ref
    ``full_prior_buffer`` refill, SGM.cc:920-931)."""
    return torch.where(cost >= bad, torch.full_like(out, bad), out)


def _shift_lane(a, d: int, bad: float):
    """``out[..., i] = a[..., i - d]`` along the lane axis, ``bad`` fill."""
    if d == 0:
        return a
    big = torch.full_like(a[..., :1], bad)
    if d > 0:
        return torch.cat([big, a[..., :-1]], -1)
    return torch.cat([a[..., 1:], big], -1)


def _mgm_step(carry, cx, px, gx, shifts, p1, p2, bad):
    """One MGM task step: integer average of the path updates at the two
    prior shifts, guard reset to the local cost, absent candidates forced."""
    a = _path_update(_shift_lane(carry, shifts[0], bad), cx, px, p1, p2, bad)
    b = _path_update(_shift_lane(carry, shifts[1], bad), cx, px, p1, p2, bad)
    out = torch.floor((a + b) * 0.5)                    # uint16 (a+b)/2
    out = torch.where(gx[..., None, None, :], out, cx)
    return _force_bad(out, cx, bad)


# ---- plain versions ----------------------------------------------------------

def scan_bidir_plain(cost_t, pdiffs_f, pdiffs_r, shifts: Sequence[int],
                     p1: float, p2: float, bad: float):
    """Plain version of :func:`scan_bidir` (``stereo/sgm.py:_scan_bidir``):
    step t updates line t of the forward paths and line N-1-t of the
    reverse paths."""
    n, sy, sx, nl = cost_t.shape
    carry = torch.full((2, len(shifts), sy, sx, nl), bad,
                       dtype=cost_t.dtype, device=cost_t.device)
    ys = torch.empty((2, n, sy, sx, nl), dtype=cost_t.dtype,
                     device=cost_t.device)
    for t in range(n):
        cx = torch.stack([cost_t[t], cost_t[n - 1 - t]], 0)[:, None]
        px = torch.stack([pdiffs_f[t], pdiffs_r[n - 1 - t]], 0)
        prior = torch.stack([_shift_lane(carry[:, i], s, bad)
                             for i, s in enumerate(shifts)], 1)
        carry = _force_bad(_path_update(prior, cx, px, p1, p2, bad), cx, bad)
        ys[:, t] = carry.sum(1)
    return ys[0] + ys[1].flip(0)


def mgm_bidir_plain(cost_t, pd_f, pd_r, g_f, g_r, shifts: Sequence[int],
                    p1: float, p2: float, bad: float):
    """Plain version of :func:`mgm_bidir` (the scan of
    ``stereo/sgm.py:_mgm_plain_scan``)."""
    n, sy, sx, nl = cost_t.shape
    carry = torch.full((2, sy, sx, nl), bad, dtype=cost_t.dtype,
                       device=cost_t.device)
    ys = torch.empty((2, n, sy, sx, nl), dtype=cost_t.dtype,
                     device=cost_t.device)
    for t in range(n):
        cx = torch.stack([cost_t[t], cost_t[n - 1 - t]], 0)
        px = torch.stack([pd_f[t], pd_r[n - 1 - t]], 0)
        gx = torch.stack([g_f[t], g_r[n - 1 - t]], 0).bool()
        carry = _mgm_step(carry, cx, px, gx, shifts, p1, p2, bad)
        ys[:, t] = carry
    return ys[0] + ys[1].flip(0)


def mgm_fwd_plain(cost_t, pd_t, g_t, shifts: Sequence[int], p1: float,
                  p2: float, bad: float):
    """Plain version of :func:`mgm_fwd` (the scan body of
    ``stereo/sgm.py:_mgm_sheared_scan``)."""
    n, b, sy, sx, nl = cost_t.shape
    carry = torch.full((b, sy, sx, nl), bad, dtype=cost_t.dtype,
                       device=cost_t.device)
    ys = torch.empty_like(cost_t)
    for t in range(n):
        carry = _mgm_step(carry, cost_t[t], pd_t[t], g_t[t].bool(), shifts,
                          p1, p2, bad)
        ys[t] = carry
    return ys


# ---- wrappers ----------------------------------------------------------------

def _check(name, cost_t, side, shifts, n_shifts):
    """Shapes of the JAX contract; ``n_shifts`` lane shifts, each of -1, 0,
    +1. Returns ``(sy, sx)``."""
    if cost_t.dtype != torch.float32 or min(cost_t.shape) < 1:
        raise ArgumentErr(f"{name}: cost_t must be a non-empty float32 "
                          f"line volume")
    for what, t, shape in side:
        if tuple(t.shape) != shape:
            raise ArgumentErr(f"{name}: {what} must be {shape}, got "
                              f"{tuple(t.shape)}")
    if len(shifts) != n_shifts or any(s not in (-1, 0, 1) for s in shifts):
        raise ArgumentErr(f"{name}: shifts must be {n_shifts} of -1, 0, +1, "
                          f"got {tuple(shifts)}")
    return int(cost_t.shape[-3]), int(cost_t.shape[-2])


def _check_tensors(name, cost, pd, guard, out):
    """Every tensor on the cost's device, contiguous, of its dtype."""
    tensors = [("cost_t", cost[0], torch.float32), ("out", out[0], torch.float32)]
    tensors += [(f"pd[{g}]", t, torch.float32) for g, t in enumerate(pd)]
    tensors += [(f"guard[{g}]", t, torch.bool) for g, t in enumerate(guard)
                if t is not None]
    dev = cost[0].device
    for what, t, dt in tensors:
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ArgumentErr(f"{name}: {what} must be a contiguous {dt} "
                              f"tensor on {dev}")
    return dev


def _launch(name, mode, groups, b, n, sy, sx, nl, cost, pd, guard, out,
            strides, reverse, shifts, store, p1, p2, bad):
    """Check device, type and contiguity, then launch one block per (group,
    direction) of ``csrc/sgm_scan.cu``. The double-buffered carry is in
    shared memory when it fits a block's opt-in limit, else in a global
    scratch buffer, one slice per block."""
    dev = _check_tensors(name, cost, pd, guard, out)
    threads = min(-(-nl // 32) * 32, _MAX_THREADS)
    smem = 2 * sy * sx * nl * 4                        # the carry, twice
    scratch = None
    if smem > _MAX_SMEM:
        scratch = torch.empty(groups * b * 2 * sy * sx * nl,
                              dtype=torch.float32, device=dev)
        smem = 0
    lib = _library()
    ptr = [t.data_ptr() if t is not None else None
           for t in (cost[0], cost[-1], pd[0], pd[-1], guard[0], guard[-1],
                     out[0], out[-1], scratch)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vw_line_scan(mode, *ptr, groups, b, n, sy, sx, nl, *strides,
                               int(reverse), *shifts, int(store), float(p1),
                               float(p2), float(bad), threads, smem, stream)
    _build.check(err, name)
    launches[name] += 1


def _launch_mgm(name, threads, groups, b, n, sy, sx, nl, cost, pd, guard, out,
                strides, p1, p2, bad, shifts=(0, 0, 0), blocks=1):
    """Check device, type and contiguity, then launch the register-carry
    kernel of ``csrc/mgm_scan.cu`` with ``blocks`` blocks of ``threads`` per
    (group, direction or orientation) line (more than one: a cluster, MGM
    only; the card refusing it raises): scan_bidir and mgm_bidir as 2
    groups (group 1 reverse) adding into a zeroed ``out``, mgm_fwd as 1
    group storing every step. ``shifts``: scan_bidir's lane shift per
    direction; ``guard``: None for scan_bidir."""
    dev = _check_tensors(name, cost, pd, guard, out)
    lib = _mgm_library()
    ptr = [t.data_ptr() if t is not None else None
           for t in (cost[0], cost[-1], pd[0], pd[-1], guard[0], guard[-1],
                     out[0], out[-1])]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vw_mgm_scan(_MODES[name], *ptr, groups, b, n, sy, sx, nl,
                              *strides, *shifts, float(p1), float(p2),
                              float(bad), threads, blocks, stream)
    _build.check(err, name)
    launches[name] += 1
    (cluster_scan_launches if blocks > 1 else mgm_scan_launches)[name] += 1


def _launch_cluster(name, variant, lines, n, sy, sx, nl, cost, pd, guard, out,
                    strides, p1, p2, bad):
    """Check device, type and contiguity, then launch a cluster per line
    (``variant`` from :func:`_cluster_variant`): ``csrc/mgm_scan.cu``'s
    kernel where a thread holds a lane, else ``csrc/mgm_cluster_scan.cu``'s;
    mgm_bidir as 2 lines (group 1 reverse) adding into a zeroed ``out``,
    mgm_fwd as one line per orientation storing every step. Raises where the
    card cannot schedule the cluster."""
    t, _, threads, blocks = variant
    if t == 1:
        groups, b = (2, 1) if name == "mgm_bidir" else (1, lines)
        _launch_mgm(name, threads, groups, b, n, sy, sx, nl, cost, pd, guard, out,
                    strides, p1, p2, bad, blocks=blocks)
        return
    dev = _check_tensors(name, cost, pd, guard, out)
    lib = _cluster_library()
    ptr = [t.data_ptr() for t in (cost[0], cost[-1], pd[0], pd[-1], guard[0],
                                  guard[-1], out[0], out[-1])]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vw_mgm_cluster_scan(_MODES[name], *ptr, lines, n, sy, sx, nl,
                                      *strides, float(p1), float(p2),
                                      float(bad), *variant, stream)
    _build.check(err, name)
    launches[name] += 1
    cluster_scan_launches[name] += 1


def _launch_path(cost_t, pdiffs_f, pdiffs_r, out, shifts, p1, p2, bad, k,
                 lines):
    """Check device, type and contiguity, then launch the path-line kernel
    of ``csrc/sgm_path_scan.cu`` (instance ``k``, ``lines`` warps a block)
    adding both groups of every direction into the zeroed ``out``.
    ``shifts``: the lane shift of each of the B directions of ``pdiffs_*``
    (N, B, L), padded to 3."""
    dev = _check_tensors("scan_bidir", (cost_t,), (pdiffs_f, pdiffs_r),
                         (None, None), (out,))
    n, sy, sx, nl = (int(d) for d in cost_t.shape)
    lib = _path_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vw_path_scan(cost_t.data_ptr(), pdiffs_f.data_ptr(),
                               pdiffs_r.data_ptr(), out.data_ptr(),
                               int(pdiffs_f.shape[1]), n, sy, sx, nl, *shifts,
                               float(p1), float(p2), float(bad), k, lines,
                               stream)
    _build.check(err, "scan_bidir")
    launches["scan_bidir"] += 1
    path_scan_launches["scan_bidir"] += 1


def _plain_or_cuda(name, t):
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ArgumentErr(f"{name}: unsupported device {t.device}")
    return False


def scan_bidir(cost_t, pdiffs_f, pdiffs_r, shifts: Sequence[int], p1: float,
               p2: float, bad: float):
    """Both scan directions of all ``shifts`` path directions. ``cost_t``
    (N, sy, sx, L); ``pdiffs_f``/``pdiffs_r`` (N, B, L) per-direction path
    gradients of the forward / reverse groups; ``shifts`` the lane shift of
    each direction's carry (0 straight, +-1 diagonal). Returns the per-step
    sum over the B directions of both groups, (N, sy, sx, L).

    CPU tensors run :func:`scan_bidir_plain`; CUDA tensors launch a kernel
    or raise: the register-carry one where :func:`_scan_variant` has an
    instance, else the path-line one where :func:`_path_scan_variant` has
    one, else ``line_scan_kernel<0>``."""
    shifts = tuple(int(s) for s in shifts)
    if cost_t.dim() != 4 or not shifts:
        raise ArgumentErr("scan_bidir: cost_t must be (N, sy, sx, L) and "
                          "shifts non-empty")
    n, nl, b = int(cost_t.shape[0]), int(cost_t.shape[-1]), len(shifts)
    sy, sx = _check("scan_bidir", cost_t,
                    [("pdiffs_f", pdiffs_f, (n, b, nl)),
                     ("pdiffs_r", pdiffs_r, (n, b, nl))], shifts, b)
    if _plain_or_cuda("scan_bidir", cost_t):
        return scan_bidir_plain(cost_t, pdiffs_f, pdiffs_r, shifts, p1, p2, bad)
    if b > _MAX_DIRECTIONS:
        raise ArgumentErr(f"scan_bidir: the CUDA scan takes at most "
                          f"{_MAX_DIRECTIONS} path directions, got {b}")
    sms = torch.cuda.get_device_properties(cost_t.device).multi_processor_count
    return _scan_bidir_cuda(cost_t, pdiffs_f, pdiffs_r, shifts, p1, p2, bad,
                            *_scan_bidir_pick(n, sy, sx, nl, shifts, sms))


def _scan_bidir_cuda(cost_t, pdiffs_f, pdiffs_r, shifts, p1, p2, bad,
                     threads, path=None):
    """The card's :func:`scan_bidir`: the register-carry kernel with
    ``threads`` per block; where ``threads`` is None, the path-line kernel
    with ``path`` = (cells a thread, lines a block), or
    ``line_scan_kernel<0>`` where that is None too."""
    n, sy, sx, nl = (int(d) for d in cost_t.shape)
    b = len(shifts)
    out = torch.zeros_like(cost_t)
    if threads is None and path is not None:
        _launch_path(cost_t, pdiffs_f, pdiffs_r, out,
                     tuple(shifts) + (0,) * (_MAX_DIRECTIONS - b), p1, p2, bad,
                     *path)
        return out
    cells = sy * sx * nl
    # (cost n, cost b, pd n, pd b, out n, out b) strides in elements
    strides = (cells, 0, b * nl, nl, cells, 0)
    shifts = tuple(shifts) + (0,) * (_MAX_DIRECTIONS - b)
    if threads is not None:
        _launch_mgm("scan_bidir", threads, 2, b, n, sy, sx, nl,
                    (cost_t, cost_t), (pdiffs_f, pdiffs_r), (None, None),
                    (out, out), strides, p1, p2, bad, shifts)
    else:
        _launch("scan_bidir", 0, 2, b, n, sy, sx, nl, (cost_t, cost_t),
                (pdiffs_f, pdiffs_r), (None, None), (out, out), strides, True,
                shifts, False, p1, p2, bad)
    return out


def mgm_bidir(cost_t, pd_f, pd_r, g_f, g_r, shifts: Sequence[int], p1: float,
              p2: float, bad: float):
    """The forward and reverse diagonal-pair MGM tasks. ``cost_t``
    (N, sy, sx, L); ``pd_*`` (N, L) float32 and ``g_*`` (N, L) bool guards
    of the forward / reverse task. Returns the sum of both, (N, sy, sx, L).

    CPU tensors run :func:`mgm_bidir_plain`; CUDA tensors launch the kernel
    that :func:`_mgm_pick` picks, or raise."""
    shifts = tuple(int(s) for s in shifts)
    if cost_t.dim() != 4:
        raise ArgumentErr("mgm_bidir: cost_t must be (N, sy, sx, L)")
    n, nl = int(cost_t.shape[0]), int(cost_t.shape[-1])
    side = [(w, t, (n, nl)) for w, t in (("pd_f", pd_f), ("pd_r", pd_r),
                                          ("g_f", g_f), ("g_r", g_r))]
    sy, sx = _check("mgm_bidir", cost_t, side, shifts, 2)
    if _plain_or_cuda("mgm_bidir", cost_t):
        return mgm_bidir_plain(cost_t, pd_f, pd_r, g_f, g_r, shifts, p1, p2,
                               bad)
    pick = (_mgm_pick(sy, sx, nl)
            if tuple(sorted(shifts)) == _MGM_SHIFTS["mgm_bidir"] else (None, None))
    return _mgm_bidir_cuda(cost_t, pd_f, pd_r, g_f, g_r, shifts, p1, p2, bad,
                           *pick)


def _mgm_bidir_cuda(cost_t, pd_f, pd_r, g_f, g_r, shifts, p1, p2, bad,
                    threads, cluster=None):
    """The card's :func:`mgm_bidir`: the register-carry kernel with
    ``threads`` per block; where ``threads`` is None, the cluster kernel
    with the launch ``cluster`` (:func:`_cluster_variant`), or
    ``line_scan_kernel<1>`` where that is None too."""
    n, sy, sx, nl = (int(d) for d in cost_t.shape)
    out = torch.zeros_like(cost_t)
    cells = sy * sx * nl
    strides = (cells, 0, nl, 0, cells, 0)
    if threads is not None:
        _launch_mgm("mgm_bidir", threads, 2, 1, n, sy, sx, nl, (cost_t, cost_t),
                    (pd_f, pd_r), (g_f, g_r), (out, out), strides, p1, p2, bad)
    elif cluster is not None:
        _launch_cluster("mgm_bidir", cluster, 2, n, sy, sx, nl, (cost_t, cost_t),
                        (pd_f, pd_r), (g_f, g_r), (out, out), strides, p1, p2,
                        bad)
    else:
        _launch("mgm_bidir", 1, 2, 1, n, sy, sx, nl, (cost_t, cost_t),
                (pd_f, pd_r), (g_f, g_r), (out, out), strides, True,
                shifts + (0,), False, p1, p2, bad)
    return out


def mgm_fwd(cost_t, pd_t, g_t, shifts: Sequence[int], p1: float, p2: float,
            bad: float):
    """Forward MGM scan over B orientations. ``cost_t`` (N, B, sy, sx, L);
    ``pd_t`` (N, B, L) float32 and ``g_t`` (N, B, L) bool. Returns every
    step's carry, (N, B, sy, sx, L).

    CPU tensors run :func:`mgm_fwd_plain`; CUDA tensors launch the kernel
    that :func:`_mgm_pick` picks, or raise."""
    shifts = tuple(int(s) for s in shifts)
    if cost_t.dim() != 5:
        raise ArgumentErr("mgm_fwd: cost_t must be (N, B, sy, sx, L)")
    n, b, nl = int(cost_t.shape[0]), int(cost_t.shape[1]), int(cost_t.shape[-1])
    sy, sx = _check("mgm_fwd", cost_t, [("pd_t", pd_t, (n, b, nl)),
                                        ("g_t", g_t, (n, b, nl))], shifts, 2)
    if _plain_or_cuda("mgm_fwd", cost_t):
        return mgm_fwd_plain(cost_t, pd_t, g_t, shifts, p1, p2, bad)
    pick = (_mgm_pick(sy, sx, nl)
            if tuple(sorted(shifts)) == _MGM_SHIFTS["mgm_fwd"] else (None, None))
    return _mgm_fwd_cuda(cost_t, pd_t, g_t, shifts, p1, p2, bad, *pick)


def _mgm_fwd_cuda(cost_t, pd_t, g_t, shifts, p1, p2, bad, threads,
                  cluster=None):
    """The card's :func:`mgm_fwd`: the register-carry kernel with
    ``threads`` per block; where ``threads`` is None, the cluster kernel
    with the launch ``cluster`` (:func:`_cluster_variant`), or
    ``line_scan_kernel<1>`` where that is None too."""
    n, b, sy, sx, nl = (int(d) for d in cost_t.shape)
    out = torch.empty_like(cost_t)
    cells = sy * sx * nl
    strides = (b * cells, cells, b * nl, nl, b * cells, cells)
    if threads is not None:
        _launch_mgm("mgm_fwd", threads, 1, b, n, sy, sx, nl, (cost_t,), (pd_t,),
                    (g_t,), (out,), strides, p1, p2, bad)
    elif cluster is not None:
        _launch_cluster("mgm_fwd", cluster, b, n, sy, sx, nl, (cost_t,), (pd_t,),
                        (g_t,), (out,), strides, p1, p2, bad)
    else:
        _launch("mgm_fwd", 1, 1, b, n, sy, sx, nl, (cost_t,), (pd_t,), (g_t,),
                (out,), strides, False, shifts + (0,), True, p1, p2, bad)
    return out
