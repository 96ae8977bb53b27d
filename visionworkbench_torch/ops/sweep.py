"""Per-tile block-matching sweep: the CUDA kernel ``csrc/sweep.cu``, its
plain PyTorch version and the wrapper that picks between them by device.

Replaces the TPU kernel ``visionworkbench_tpu/ops/sweep.py:_pallas_sweep``
(``pl.pallas_call`` at ``:603``; wrapper ``pallas_sweep`` ``:454``) for all
five costs: abs, sq, ncc, census and ternary_census (every census window).
Contract, as ``_tiled_search`` / ``_tiled_search_patches`` of the JAX
package: ``base`` is the padded left frame, tile (ty, tx) reads rows
``ty*tile .. ty*tile + tile + kh - 2``; ``match`` is the frame searched,
tile (ty, tx) reads its window at ``(ty*tile + off_y, tx*tile + off_x)``
(start clamped into the frame like ``lax.dynamic_slice``). With
``want_patches`` the window carries a ±1 ring (``match`` origin shifted by
(-1, -1) by the caller) and the nine costs around each winner come back as
(9, H, W) planes, dx fastest; NCC has no patch mode.

Census costs take either the float frames, whose codes are computed over
each tile's crop as the XLA engine does (the pyramid path), or int32 code
planes (H, W, n_words) computed beforehand over whole frames
(:func:`search_frame`, the path of ``best_of_search_convolution``).

On the card (:func:`_sweep_variant` picks the kernel and its instance):
the abs, sq and NCC costs run ``band_sweep_kernel``, census and ternary
census ``band_census_kernel`` (both one block per band of output rows of
a tile), the shapes past the band kernels' limits ``sweep_kernel``. The
abs/sq/NCC kernels sum every window (NCC's energies too) in the plain
version's order; the census kernel takes running sums, exact since census
sums are integers. So every kernel agrees with the plain version, and with
the others, bit for bit on any input. What bounds each on the H100, and
what its design does about it: see the note at the top of
``csrc/sweep.cu`` (the abs/sq/NCC band kernel: the issue of the
exact-order adds; the census band kernel: its column pass's popcounts,
then making the codes; ``sweep_kernel``: shared-memory loads).
"""

from __future__ import annotations

import ctypes

import torch

from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.image.census import census_positions, census_words
from visionworkbench_torch.image.edge import crop_extended
from visionworkbench_torch.ops import _build
from visionworkbench_torch.stereo.correlation import (
    ABSOLUTE_DIFFERENCE, CENSUS_COSTS, CENSUS_TRANSFORM, CROSS_CORRELATION,
    SQUARED_DIFFERENCE, TERNARY_CENSUS_TRANSFORM, _best_of_search,
    _search_with_patches, census_codes, check_cost_type,
)

# Kernel launches since the count was last set to 0 (the wrapper adds one
# per launch of a CUDA kernel, and nowhere else), and of those the launches
# of band_sweep_kernel (abs, sq, NCC) and of band_census_kernel (census,
# ternary census); the rest ran sweep_kernel.
launches = 0
band_launches = 0
census_band_launches = 0

_MAX_SMEM = 232448        # bytes of shared memory one H100 block may opt into
_COST_CODE = {ABSOLUTE_DIFFERENCE: 0, SQUARED_DIFFERENCE: 1,
              CROSS_CORRELATION: 2, CENSUS_TRANSFORM: 3,
              TERNARY_CENSUS_TRANSFORM: 3}
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("sweep")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.vw_sweep.argtypes = [p, i, i, p, i, i, p, i, i, i, i, i, i, i, i,
                                 i, i, i, p, i, i, p, p, p, p, i,
                                 ctypes.c_longlong, p]
        lib.vw_sweep.restype = i
        lib.vw_sweep_pixels_per_thread.argtypes = []
        lib.vw_sweep_pixels_per_thread.restype = i
        lib.vw_band_sweep.argtypes = [p, i, i, p, i, i, p, i, i, i, i, i, i,
                                      i, i, i, i, p, p, p, p, i, i,
                                      ctypes.c_longlong, p]
        lib.vw_band_sweep.restype = i
        lib.vw_band_census.argtypes = [p, i, p, i, i, p, i, i, i, i, i, i, i, i,
                                       i, i, i, p, i, i, p, p, p, p, i, i,
                                       ctypes.c_longlong, p]
        lib.vw_band_census.restype = i
        lib.vw_sweep_max_threads.argtypes = [i, i]
        lib.vw_sweep_max_threads.restype = i
        _lib = lib
    return _lib


def smem_bytes(tile: int, s_x: int, s_y: int, kw: int, kh: int, ring: int,
               cost_type: str, n_words: int = 1, codes_in: bool = False,
               rows: int = None) -> int:
    """Shared memory of one block of ``sweep_kernel``, laid out as in
    ``csrc/sweep.cu``: the left block and right window (1-2 words a pixel),
    the column sums of ``rows`` output rows (a round's; the whole tile by
    default), then NCC's right precisions of those rows or the census
    crops' quantized pixels."""
    lh, lw = tile + kh - 1, tile + kw - 1
    rh, rw = lh + s_y + 2 * ring - 1, lw + s_x + 2 * ring - 1
    rows = tile if rows is None else rows
    census = cost_type in CENSUS_COSTS
    words = n_words if census else 1
    total = 4 * (words * (lh * lw + rh * rw) + rows * lw)
    if cost_type == CROSS_CORRELATION:
        total += 4 * (rows + s_y - 1) * (tile + s_x - 1)
    if census and not codes_in:
        total += lh * lw + rh * rw
    return total


def _check_shapes(base, match, offsets, tile, s_x, s_y, kw, kh, ring, codes_in):
    dims = 3 if codes_in else 2
    if base.dim() != dims or match.dim() != dims:
        raise ArgumentErr("sweep: base and match must be 2D frames, or for "
                          "census (H, W, n_words) code planes")
    if codes_in and base.shape[2] != match.shape[2]:
        raise ArgumentErr("sweep: base and match code planes differ in words")
    if offsets.dim() != 3 or offsets.shape[2] != 2:
        raise ArgumentErr("sweep: offsets must be (nty, ntx, 2)")
    if min(tile, s_x, s_y, kw, kh) < 1:
        raise ArgumentErr("sweep: tile, window and kernel must be positive")
    nty, ntx = int(offsets.shape[0]), int(offsets.shape[1])
    lh, lw = tile + kh - 1, tile + kw - 1
    rh, rw = lh + s_y + 2 * ring - 1, lw + s_x + 2 * ring - 1
    if base.shape[0] < (nty - 1) * tile + lh or base.shape[1] < (ntx - 1) * tile + lw:
        raise ArgumentErr(f"sweep: base {tuple(base.shape)} too small for "
                          f"{nty}x{ntx} tiles of {tile} with kernel {kw}x{kh}")
    if match.shape[0] < rh or match.shape[1] < rw:
        raise ArgumentErr(f"sweep: match {tuple(match.shape)} smaller than "
                          f"one window ({rh}, {rw})")
    return nty, ntx, lh, lw, rh, rw


def _check_cost(cost_type, want_patches, census_window, base):
    """Returns (census, codes_in, n_words)."""
    check_cost_type(cost_type, census_window)
    if cost_type == CROSS_CORRELATION and want_patches:
        raise ArgumentErr("sweep: NCC has no parabola-patch mode; use "
                          "want_patches=False")
    census = cost_type in CENSUS_COSTS
    codes_in = census and base.dtype == torch.int32
    n_words = (census_words(int(census_window), cost_type == TERNARY_CENSUS_TRANSFORM)
               if census else 1)
    if codes_in and base.dim() == 3 and base.shape[2] != n_words:
        raise ArgumentErr(f"sweep: {cost_type} {census_window} codes have "
                          f"{n_words} words, got {base.shape[2]}")
    return census, codes_in, n_words


def sweep_plain(base, match, offsets, tile: int, s_x: int, s_y: int, kw: int,
                kh: int, cost_type: str = ABSOLUTE_DIFFERENCE,
                want_patches: bool = True, census_window: int = 5,
                best_out=None):
    """Plain PyTorch version of the kernel: gathers every tile and window
    and runs ``stereo.correlation``'s search batched over tiles."""
    _, codes_in, _ = _check_cost(cost_type, want_patches, census_window, base)
    ring = 1 if want_patches else 0
    nty, ntx, lh, lw, rh, rw = _check_shapes(base, match, offsets, tile, s_x,
                                             s_y, kw, kh, ring, codes_in)
    dev = base.device
    ty0 = torch.arange(nty, device=dev) * tile
    tx0 = torch.arange(ntx, device=dev) * tile
    rows = (ty0[:, None] + torch.arange(lh, device=dev))[:, None, :, None]
    cols = (tx0[:, None] + torch.arange(lw, device=dev))[None, :, None, :]
    left = base[rows, cols]                         # (nty, ntx, lh, lw[, nw])
    off = offsets.long()
    y0 = (ty0[:, None] + off[..., 1]).clamp(0, match.shape[0] - rh)
    x0 = (tx0[None, :] + off[..., 0]).clamp(0, match.shape[1] - rw)
    right = match[y0[..., None, None] + torch.arange(rh, device=dev)[:, None],
                  x0[..., None, None] + torch.arange(rw, device=dev)[None, :]]
    search = _search_with_patches if want_patches else _best_of_search
    out = search(left, right, s_x, s_y, kw, kh, cost_type, census_window)
    disp, valid, best = out[:3]
    disp = disp + offsets.to(torch.int32)[:, :, None, None, :]

    def untile(a):                    # (nty, ntx, T, T, ...) -> (H, W, ...)
        a = a.transpose(1, 2)
        return a.reshape((nty * tile, ntx * tile) + tuple(a.shape[4:]))

    if best_out is not None:
        best_out.copy_(untile(best))
    patch = untile(out[3]).movedim(-1, 0).contiguous() if want_patches else None
    return untile(disp), untile(valid), patch


def _band_grid(tile: int, kw: int):
    """``(bands, threads)`` of one tile of either band kernel: bands of
    ``_build.SWEEP_BAND_ROWS`` output rows (the last one cut at the tile's
    edge); threads for the tile + kw - 1 columns of the column pass and the
    rows x segments of the row pass."""
    rows, seg = _build.SWEEP_BAND_ROWS, _build.SWEEP_SEG
    return -(-tile // rows), -(-max(rows * (tile // seg), tile + kw - 1) // 32) * 32


def _band_geometry(tile: int, s_x: int, s_y: int, kw: int, ring: int,
                   k: int, ncc: bool = False):
    """``(bands, threads, smem bytes)`` of one tile of
    ``band_sweep_kernel<., k>`` (:func:`_band_grid`); shared memory laid out
    as in ``csrc/sweep.cu``: the band's right rows, two buffers of column
    sums (an odd row stride; for ``ncc`` at least the right energies'
    column sums over the band's right positions), the patch pass's bit set
    over the ring window, then for ``ncc`` the plane of right precisions
    (an odd row stride)."""
    rows = _build.SWEEP_BAND_ROWS
    bands, threads = _band_grid(tile, kw)
    sx_e, sy_e = s_x + 2 * ring, s_y + 2 * ring
    rw = tile + kw - 1 + sx_e - 1
    right = (rows + k - 1 + sy_e - 1) * rw
    sums = 2 * rows * ((tile + k - 1) | 1)
    prec = 0
    if ncc:
        sums = max(sums, (rows + s_y - 1) * rw)
        prec = (rows + s_y - 1) * ((tile + s_x - 1) | 1)
    return bands, threads, 4 * (right + sums + -(-sx_e * sy_e // 32) + prec)


def _census_band_geometry(tile: int, s_x: int, s_y: int, kw: int, kh: int,
                          ring: int, n_words: int, radius: int, n_pos: int,
                          codes_in: bool):
    """``(bands, threads, smem bytes)`` of one tile of
    ``band_census_kernel`` (:func:`_band_grid`); shared memory laid out as
    in ``csrc/sweep.cu``: the band's left and right codes (one word of
    ``4 * n_words`` bytes a pixel), then the larger of what the codes are
    made from (the quantized crop rows, ``radius`` more rows and columns
    each side, edges replicated, and the ``n_pos`` sample positions'
    offsets in each crop; nothing with ``codes_in``) and, reusing those
    bytes, two buffers of column sums (an odd row stride) and the patch
    pass's bit set."""
    rows = _build.SWEEP_BAND_ROWS
    bands, threads = _band_grid(tile, kw)
    sx_e, sy_e = s_x + 2 * ring, s_y + 2 * ring
    lw, rw = tile + kw - 1, tile + kw + sx_e - 2
    lrows = rows + kh - 1
    rrows = lrows + sy_e - 1
    codes = 4 * n_words * (lrows * lw + rrows * rw)
    pixels = ((lrows + 2 * radius) * (lw + 2 * radius)
              + (rrows + 2 * radius) * (rw + 2 * radius))
    pixels = 0 if codes_in else -(-pixels // 4) * 4 + 8 * n_pos
    sums = 4 * (2 * rows * (lw | 1) + -(-sx_e * sy_e // 32))
    return bands, threads, codes + max(pixels, sums)


def _census_shape(cost_type: str, census_window: int):
    """``(n_words, radius, sample positions)`` of a census variant."""
    ternary = cost_type == TERNARY_CENSUS_TRANSFORM
    return (census_words(census_window, ternary), census_window // 2,
            len(census_positions(census_window, ternary)))


def _sweep_variant(cost_type: str, tile: int, s_x: int, s_y: int, kw: int,
                   kh: int, ring: int, census_window: int = 5,
                   codes_in: bool = False):
    """The bound K of the band kernel instance that runs the shape (the
    smallest of ``_build.SWEEP_BAND_K`` that holds kw and kh):
    ``band_sweep_kernel<cost, K>`` for abs, sq and NCC,
    ``band_census_kernel<n_words, K>`` for census and ternary census (codes
    from the float crops, or ``codes_in`` planes). None where
    ``sweep_kernel`` runs it: tiles not a multiple of ``_build.SWEEP_SEG``,
    kernels past the largest bound, and shapes that would need more than
    ``_build.SWEEP_BAND_MAX_THREADS`` threads or more shared memory than a
    block may have."""
    census = cost_type in CENSUS_COSTS
    if (cost_type not in (ABSOLUTE_DIFFERENCE, SQUARED_DIFFERENCE, CROSS_CORRELATION)
            and not census or tile % _build.SWEEP_SEG):
        return None
    k = next((b for b in _build.SWEEP_BAND_K if max(kw, kh) <= b), None)
    if k is None:
        return None
    if census:
        _, threads, smem = _census_band_geometry(
            tile, s_x, s_y, kw, kh, ring, *_census_shape(cost_type, census_window),
            codes_in)
    else:
        _, threads, smem = _band_geometry(tile, s_x, s_y, kw, ring, k,
                                          cost_type == CROSS_CORRELATION)
    if threads > _build.SWEEP_BAND_MAX_THREADS or smem > _MAX_SMEM:
        return None
    return k


def sweep(base, match, offsets, tile: int, s_x: int, s_y: int, kw: int,
          kh: int, cost_type: str = ABSOLUTE_DIFFERENCE,
          want_patches: bool = True, census_window: int = 5, best_out=None):
    """Fused per-tile disparity sweep. ``base``/``match`` (H, W) float32
    (or, for census costs, (H, W, n_words) int32 code planes), ``offsets``
    (nty, ntx, 2) int32 per-tile (dx, dy). Returns
    ``(disp (nty*tile, ntx*tile, 2) int32, valid bool, patches)``, patches
    (9, H, W) float32 with ``want_patches`` else None; disp = offset +
    in-window argbest, with the argbest zeroed where invalid. ``best_out``,
    an optional (nty*tile, ntx*tile) float32 tensor, receives the best
    metric.

    CPU tensors run :func:`sweep_plain`; CUDA tensors launch the kernel
    (a band kernel where :func:`_sweep_variant` has an instance, else
    ``sweep_kernel``) or raise."""
    tile, s_x, s_y, kw, kh = int(tile), int(s_x), int(s_y), int(kw), int(kh)
    census_window = int(census_window)
    if base.device.type == "cpu":
        return sweep_plain(base, match, offsets, tile, s_x, s_y, kw, kh,
                           cost_type, want_patches, census_window, best_out)
    if base.device.type != "cuda":
        raise ArgumentErr(f"sweep: unsupported device {base.device}")
    k = _sweep_variant(cost_type, tile, s_x, s_y, kw, kh, int(want_patches),
                       census_window, base.dtype == torch.int32)
    return _sweep_cuda(base, match, offsets, tile, s_x, s_y, kw, kh,
                       cost_type, want_patches, census_window, best_out, k)


def _sweep_cuda(base, match, offsets, tile, s_x, s_y, kw, kh, cost_type,
                want_patches, census_window, best_out, k):
    """The card's :func:`sweep`: ``band_sweep_kernel<cost, k>`` (abs, sq,
    NCC) or ``band_census_kernel<n_words, k>`` (census), or ``sweep_kernel``
    where ``k`` is None."""
    global launches, band_launches, census_band_launches
    census, codes_in, n_words = _check_cost(cost_type, want_patches,
                                            census_window, base)
    ring = 1 if want_patches else 0
    nty, ntx, lh, lw, rh, rw = _check_shapes(base, match, offsets, tile, s_x,
                                             s_y, kw, kh, ring, codes_in)
    frame_dt = torch.int32 if codes_in else torch.float32
    h, w = nty * tile, ntx * tile
    for name, t, dt in (("base", base, frame_dt), ("match", match, frame_dt),
                        ("offsets", offsets, torch.int32),
                        ("best_out", best_out, torch.float32)):
        if t is None:
            continue
        if t.device != base.device or t.dtype != dt or not t.is_contiguous():
            raise ArgumentErr(f"sweep: {name} must be a contiguous {dt} "
                              f"tensor on {base.device}")
    if best_out is not None and tuple(best_out.shape) != (h, w):
        raise ArgumentErr(f"sweep: best_out must be {(h, w)}")
    lib = _library()
    if k is not None and census:
        bands, threads, smem = _census_band_geometry(
            tile, s_x, s_y, kw, kh, ring, *_census_shape(cost_type, census_window),
            codes_in)
    elif k is not None:
        bands, threads, smem = _band_geometry(tile, s_x, s_y, kw, ring, k,
                                              cost_type == CROSS_CORRELATION)
    else:
        threads, smem = _sweep_block(lib, tile, s_x, s_y, kw, kh, ring, cost_type,
                                     n_words, codes_in, base.device)
    dev = base.device
    disp = torch.empty((h, w, 2), dtype=torch.int32, device=dev)
    valid = torch.empty((h, w), dtype=torch.bool, device=dev)
    patches = (torch.empty((9, h, w), dtype=torch.float32, device=dev)
               if want_patches else None)
    outs = (disp.data_ptr(), valid.data_ptr(),
            patches.data_ptr() if want_patches else None,
            best_out.data_ptr() if best_out is not None else None)
    frames = (base.data_ptr(), base.shape[0], base.shape[1], match.data_ptr(),
              match.shape[0], match.shape[1], offsets.data_ptr(), nty, ntx,
              tile, s_x, s_y, kw, kh, _COST_CODE[cost_type], ring)
    ternary = cost_type == TERNARY_CENSUS_TRANSFORM
    pos = census_positions(census_window, ternary) if census else []
    pos_arr = (ctypes.c_int * max(2 * len(pos), 1))(*[v for p in pos for v in p])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if k is not None and census:
            err = lib.vw_band_census(
                base.data_ptr(), base.shape[1], match.data_ptr(), match.shape[0],
                match.shape[1], offsets.data_ptr(), nty, ntx, tile, s_x, s_y, kw, kh,
                ring, k, n_words, int(codes_in), pos_arr, len(pos), int(ternary),
                *outs, bands, threads, smem, stream)
        elif k is not None:
            err = lib.vw_band_sweep(*frames, k, *outs, bands, threads, smem,
                                    stream)
        else:
            err = lib.vw_sweep(*frames, n_words, int(codes_in), pos_arr,
                               len(pos), int(ternary), *outs, threads, smem, stream)
    _build.check(err, "sweep")
    launches += 1
    if k is not None and census:
        census_band_launches += 1
    elif k is not None:
        band_launches += 1
    return disp, valid, patches


_max_threads = {}


def _sweep_block(lib, tile, s_x, s_y, kw, kh, ring, cost_type, n_words, codes_in,
                 dev):
    """``(threads, smem bytes)`` of one ``sweep_kernel`` block: one thread per
    ``kPer`` pixels of the tile, at most what the instance may launch
    (``vw_sweep_max_threads``: its launch bound), and fewer while the rows of a round (:func:`_round_rows`)
    need more shared memory than a block may have; the kernel runs the
    tile's pixels in rounds of ``kPer`` x threads. Raises where 32 threads
    do not fit either."""
    cost = _COST_CODE[cost_type]
    key = (cost, n_words, dev)
    if key not in _max_threads:
        with torch.cuda.device(dev):
            cap = lib.vw_sweep_max_threads(cost, n_words)
        _build.check(-cap if cap < 0 else 0, "sweep (attributes)")
        _max_threads[key] = cap
    per = lib.vw_sweep_pixels_per_thread()
    threads = -(-tile * tile // per)
    threads = min(-(-threads // 32) * 32, _max_threads[key])
    while True:
        smem = smem_bytes(tile, s_x, s_y, kw, kh, ring, cost_type, n_words,
                          codes_in, _round_rows(tile, threads, per))
        if smem <= _MAX_SMEM:
            return threads, smem
        if threads <= 32:
            raise ArgumentErr(
                f"sweep: tile {tile} with kernel {kw}x{kh} and window "
                f"{s_x}x{s_y} ({cost_type}) needs {smem} B of shared memory "
                f"per block; the CUDA sweep takes at most {_MAX_SMEM}")
        threads -= 32


def _round_rows(tile: int, threads: int, per: int) -> int:
    """Output rows one round of ``sweep_kernel`` covers, at most: its
    ``per`` x ``threads`` pixels, which may start inside a row."""
    return min(tile, -(-per * threads // tile) + 1)


def frame_tile(out_h: int, out_w: int, s_x: int, s_y: int, kw: int, kh: int,
               cost_type: str, n_words: int = 1, tile: int = 64) -> int:
    """Tile of a whole-frame search: the smallest power of two (>= 8) that
    covers the output, at most ``tile`` (capped at 64, 256 threads a
    block), halved while a block's shared memory would not fit. The result
    does not depend on the tile."""
    t = 8
    while t < min(max(out_h, out_w), min(int(tile), 64)):
        t *= 2
    while t > 8 and smem_bytes(t, s_x, s_y, kw, kh, 0, cost_type, n_words,
                               True) > _MAX_SMEM:
        t //= 2
    return t


def frame_sweep_args(left, right, s_x: int, s_y: int, kw: int, kh: int,
                     cost_type: str = ABSOLUTE_DIFFERENCE,
                     census_window: int = 5, tile: int = 64):
    """``(base, match, offsets, tile)`` of the sweep that searches ``left``
    (H, W) over ``right`` (H+s_y-1, W+s_x-1) (see :func:`search_frame`)."""
    h, w = left.shape
    oh, ow = h - kh + 1, w - kw + 1
    n_words = 1
    if cost_type in CENSUS_COSTS:
        left = census_codes(left, cost_type, census_window)
        right = census_codes(right, cost_type, census_window)
        n_words = left.shape[-1]
    t = frame_tile(oh, ow, s_x, s_y, kw, kh, cost_type, n_words, tile)
    nty, ntx = -(-oh // t), -(-ow // t)
    base = crop_extended(left, 0, 0, ntx * t + kw - 1, nty * t + kh - 1)
    match = crop_extended(right, 0, 0, ntx * t + kw + s_x - 2,
                          nty * t + kh + s_y - 2)
    offsets = torch.zeros((nty, ntx, 2), dtype=torch.int32, device=base.device)
    return base, match, offsets, t


def search_frame(left, right, s_x: int, s_y: int, kw: int, kh: int,
                 cost_type: str = ABSOLUTE_DIFFERENCE, census_window: int = 5,
                 tile: int = 64, want_best: bool = False, plain: bool = False):
    """Whole-frame search on the sweep (the engine of
    ``best_of_search_convolution`` and of ``ops/cost_volume.py``'s
    ``best_of_search``). ``left`` (H, W), ``right`` (H+s_y-1, W+s_x-1)
    float32. Returns ``(disp (oh, ow, 2) int32 in [0, s_x) x [0, s_y),
    valid, best or None)``, (oh, ow) = (H-kh+1, W-kw+1).

    Census codes are computed over the whole frames (edges replicated at
    the frame border) and handed to the sweep as code planes. The frames
    are edge-padded to a whole grid of :func:`frame_tile` tiles with zero
    offsets; the padding reaches only outputs that are cropped away.
    ``plain`` runs :func:`sweep_plain` on any device (the plain version)."""
    oh, ow = left.shape[0] - kh + 1, left.shape[1] - kw + 1
    base, match, offsets, t = frame_sweep_args(left, right, s_x, s_y, kw, kh,
                                               cost_type, census_window, tile)
    best = (torch.empty(offsets.shape[0] * t, offsets.shape[1] * t,
                        dtype=torch.float32, device=base.device)
            if want_best else None)
    fn = sweep_plain if plain else sweep
    disp, valid, _ = fn(base, match, offsets, t, s_x, s_y, kw, kh, cost_type,
                        False, census_window, best_out=best)
    return (disp[:oh, :ow], valid[:oh, :ow],
            None if best is None else best[:oh, :ow])
