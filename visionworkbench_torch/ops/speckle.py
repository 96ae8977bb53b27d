"""Neighbour-agreement speckle stencil: the CUDA kernel ``csrc/speckle.cu``,
its plain PyTorch version and the wrapper that picks between them by device.

Replaces the TPU kernel ``visionworkbench_tpu/ops/speckle.py:
speckle_keep_mask`` (``pl.pallas_call`` at ``:93``). Input is the packed code
plane of ``stereo.disparity._pack_code`` — ``(dx + 8192) << 14 | (dy + 8192)``,
0 for invalid pixels — and a pixel keeps iff at least ``min_match`` of its
(2*half_h+1) x (2*half_v+1) edge-replicated neighbours (itself included)
agree within ``t`` in both fields. Any frame shape: the TPU dispatch's
``W % 128 == 0 and H % 8 == 0`` condition is dropped.

What bounds the kernel on the H100, and what its design does about it: see
the note at the top of ``csrc/speckle.cu`` (issuing the per-pair work: the
fields unpacked once into floats at staging, five fp32 instructions a pair,
a thread's strip of pixels sharing each staged neighbour it loads).
"""

from __future__ import annotations

import ctypes

import torch

from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.ops import _build

# Kernel launches since the count was last set to 0 (the wrapper adds one
# per launch of the CUDA kernel, and nowhere else).
launches = 0

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("speckle")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.vw_speckle.argtypes = [p, i, i, i, i, i, i, p, p]
        lib.vw_speckle.restype = i
        _lib = lib
    return _lib


def speckle_keep_mask_plain(code, half_h: int, half_v: int, t: int,
                            min_match: int):
    """Plain PyTorch version of the kernel (the window count of
    ``_rm_outliers_int`` in the JAX package)."""
    h, w = code.shape
    dev = code.device
    rows = torch.arange(-half_v, h + half_v, device=dev).clamp_(0, h - 1)
    cols = torch.arange(-half_h, w + half_h, device=dev).clamp_(0, w - 1)
    pc = code.index_select(0, rows).index_select(1, cols)   # edge-replicated
    cdx, cdy = code >> 14, code & 0x3FFF
    count = torch.zeros((h, w), dtype=torch.int32, device=dev)
    for i in range(2 * half_v + 1):
        for j in range(2 * half_h + 1):
            nc = pc[i:i + h, j:j + w]
            count += (((cdx - (nc >> 14)).abs() <= t)
                      & ((cdy - (nc & 0x3FFF)).abs() <= t)).to(torch.int32)
    return (count >= min_match).to(torch.int32)


def speckle_keep_mask(code, half_h: int, half_v: int, t: int, min_match: int):
    """(H, W) int32 packed-code plane -> (H, W) int32 0/1 keep mask.

    CPU tensors run :func:`speckle_keep_mask_plain`; CUDA tensors launch the
    kernel or raise."""
    global launches
    half_h, half_v, t, min_match = int(half_h), int(half_v), int(t), int(min_match)
    if code.dim() != 2 or min(code.shape) < 1:
        raise ArgumentErr("speckle_keep_mask: code must be a non-empty 2D plane")
    if half_h < 0 or half_v < 0:
        raise ArgumentErr("speckle_keep_mask: half window sizes must be >= 0")
    if code.device.type == "cpu":
        return speckle_keep_mask_plain(code, half_h, half_v, t, min_match)
    if code.device.type != "cuda":
        raise ArgumentErr(f"speckle_keep_mask: unsupported device {code.device}")
    if code.dtype != torch.int32 or not code.is_contiguous():
        raise ArgumentErr("speckle_keep_mask: code must be contiguous int32")
    h, w = code.shape
    keep = torch.empty((h, w), dtype=torch.int32, device=code.device)
    lib = _library()
    with torch.cuda.device(code.device):
        stream = torch.cuda.current_stream(code.device).cuda_stream
        err = lib.vw_speckle(code.data_ptr(), h, w, half_h, half_v, t,
                             min_match, keep.data_ptr(), stream)
    _build.check(err, "speckle")
    launches += 1
    return keep
