"""Per-tile block-matching sweep: the CUDA kernel ``csrc/sweep.cu``, its
plain PyTorch version and the wrapper that picks between them by device.

Replaces the TPU kernel ``visionworkbench_tpu/ops/sweep.py:_pallas_sweep``
(``pl.pallas_call`` at ``:603``; wrapper ``pallas_sweep`` ``:454``) for the
absolute- and squared-difference costs; census and NCC come with a later
slice. Contract, as ``_tiled_search`` / ``_tiled_search_patches`` of the JAX
package: ``base`` is the padded left frame, tile (ty, tx) reads rows
``ty*tile .. ty*tile + tile + kh - 2``; ``match`` is the frame searched,
tile (ty, tx) reads its window at ``(ty*tile + off_y, tx*tile + off_x)``
(start clamped into the frame like ``lax.dynamic_slice``). With
``want_patches`` the window carries a ±1 ring (``match`` origin shifted by
(-1, -1) by the caller) and the nine costs around each winner come back as
(9, H, W) planes, dx fastest.

What bounds the kernel on the H100, and what its design does about it: see
the note at the top of ``csrc/sweep.cu`` (shared-memory loads; the tile and
its window are staged once per block, window sums are exact fp32 in a fixed
order, and the patches are recomputed at each winner in a second pass).
"""

from __future__ import annotations

import ctypes

import torch

from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.ops import _build
from visionworkbench_torch.stereo.correlation import (
    ABSOLUTE_DIFFERENCE, _best_of_search, _search_with_patches,
    check_cost_type,
)

# Kernel launches since the count was last set to 0 (the wrapper adds one
# per launch of the CUDA kernel, and nowhere else).
launches = 0

_MAX_THREADS = 1024
_MAX_SMEM = 232448        # bytes of shared memory one H100 block may opt into
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("sweep")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.vw_sweep.argtypes = [p, i, p, i, i, p, i, i, i, i, i, i, i, i, i,
                                 p, p, p, i, ctypes.c_longlong, p]
        lib.vw_sweep.restype = i
        lib.vw_sweep_pixels_per_thread.argtypes = []
        lib.vw_sweep_pixels_per_thread.restype = i
        _lib = lib
    return _lib


def _check_shapes(base, match, offsets, tile, s_x, s_y, kw, kh, ring):
    if base.dim() != 2 or match.dim() != 2:
        raise ArgumentErr("sweep: base and match must be 2D")
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


def sweep_plain(base, match, offsets, tile: int, s_x: int, s_y: int, kw: int,
                kh: int, cost_type: str = ABSOLUTE_DIFFERENCE,
                want_patches: bool = True):
    """Plain PyTorch version of the kernel: gathers every tile and window
    and runs ``stereo.correlation``'s search batched over tiles."""
    ring = 1 if want_patches else 0
    nty, ntx, lh, lw, rh, rw = _check_shapes(base, match, offsets, tile, s_x,
                                             s_y, kw, kh, ring)
    dev = base.device
    ty0 = torch.arange(nty, device=dev) * tile
    tx0 = torch.arange(ntx, device=dev) * tile
    rows = (ty0[:, None] + torch.arange(lh, device=dev))[:, None, :, None]
    cols = (tx0[:, None] + torch.arange(lw, device=dev))[None, :, None, :]
    left = base[rows, cols]                               # (nty, ntx, lh, lw)
    off = offsets.long()
    y0 = (ty0[:, None] + off[..., 1]).clamp(0, match.shape[0] - rh)
    x0 = (tx0[None, :] + off[..., 0]).clamp(0, match.shape[1] - rw)
    right = match[y0[..., None, None] + torch.arange(rh, device=dev)[:, None],
                  x0[..., None, None] + torch.arange(rw, device=dev)[None, :]]
    if want_patches:
        disp, valid, _, patch = _search_with_patches(left, right, s_x, s_y,
                                                     kw, kh, cost_type)
    else:
        disp, valid, _ = _best_of_search(left, right, s_x, s_y, kw, kh,
                                         cost_type)
        patch = None
    disp = disp + offsets.to(torch.int32)[:, :, None, None, :]

    def untile(a):                    # (nty, ntx, T, T, ...) -> (H, W, ...)
        a = a.transpose(1, 2)
        return a.reshape((nty * tile, ntx * tile) + tuple(a.shape[4:]))

    disp, valid = untile(disp), untile(valid)
    if patch is not None:
        patch = untile(patch).movedim(-1, 0).contiguous()
    return disp, valid, patch


def sweep(base, match, offsets, tile: int, s_x: int, s_y: int, kw: int,
          kh: int, cost_type: str = ABSOLUTE_DIFFERENCE,
          want_patches: bool = True):
    """Fused per-tile disparity sweep. ``base``/``match`` (H, W) float32,
    ``offsets`` (nty, ntx, 2) int32 per-tile (dx, dy). Returns
    ``(disp (nty*tile, ntx*tile, 2) int32, valid bool, patches)``, patches
    (9, H, W) float32 with ``want_patches`` else None; disp = offset +
    in-window argbest, with the argbest zeroed where invalid.

    CPU tensors run :func:`sweep_plain`; CUDA tensors launch the kernel or
    raise."""
    global launches
    check_cost_type(cost_type)
    tile, s_x, s_y, kw, kh = int(tile), int(s_x), int(s_y), int(kw), int(kh)
    if base.device.type == "cpu":
        return sweep_plain(base, match, offsets, tile, s_x, s_y, kw, kh,
                           cost_type, want_patches)
    if base.device.type != "cuda":
        raise ArgumentErr(f"sweep: unsupported device {base.device}")
    ring = 1 if want_patches else 0
    nty, ntx, lh, lw, rh, rw = _check_shapes(base, match, offsets, tile, s_x,
                                             s_y, kw, kh, ring)
    for name, t, dt in (("base", base, torch.float32),
                        ("match", match, torch.float32),
                        ("offsets", offsets, torch.int32)):
        if t.device != base.device or t.dtype != dt or not t.is_contiguous():
            raise ArgumentErr(f"sweep: {name} must be a contiguous {dt} "
                              f"tensor on {base.device}")
    lib = _library()
    per = lib.vw_sweep_pixels_per_thread()
    threads = -(-tile * tile // per)
    threads = -(-threads // 32) * 32
    smem = 4 * (lh * lw + rh * rw + tile * lw)
    if threads > _MAX_THREADS or smem > _MAX_SMEM:
        raise ArgumentErr(
            f"sweep: tile {tile} with kernel {kw}x{kh} and window "
            f"{s_x}x{s_y} needs {threads} threads and {smem} B of shared "
            f"memory per block; the CUDA sweep takes at most "
            f"{_MAX_THREADS} and {_MAX_SMEM}")
    h, w = nty * tile, ntx * tile
    dev = base.device
    disp = torch.empty((h, w, 2), dtype=torch.int32, device=dev)
    valid = torch.empty((h, w), dtype=torch.bool, device=dev)
    patches = (torch.empty((9, h, w), dtype=torch.float32, device=dev)
               if want_patches else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vw_sweep(
            base.data_ptr(), base.shape[1], match.data_ptr(), match.shape[0],
            match.shape[1], offsets.data_ptr(), nty, ntx, tile, s_x, s_y, kw,
            kh, 0 if cost_type == ABSOLUTE_DIFFERENCE else 1, ring,
            disp.data_ptr(), valid.data_ptr(),
            patches.data_ptr() if want_patches else None, threads, smem,
            stream)
    _build.check(err, "sweep")
    launches += 1
    return disp, valid, patches
