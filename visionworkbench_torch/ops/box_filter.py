"""Sliding box sums (port of ``visionworkbench_tpu/ops/box_filter.py``; ref
``fast_box_sum``, ``src/vw/Stereo/Algorithms.h:41-131``).

Sums are direct, in one fixed order: column sums over ``kh`` rows (row 0
first), then row sums of those over ``kw`` columns (left to right). The CUDA
sweep (``csrc/sweep.cu``) adds in the same order, so the two agree bit for
bit on any input; on inputs quantized to the 1/256 grid every window sum of
the correlator is exact, and any order agrees with the JAX package's
``reduce_window`` and cumsum formulations too.
"""

from __future__ import annotations

import torch

from visionworkbench_torch.core.device import on_device
from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.image.edge import edge_extend


def box_sum_valid(image: torch.Tensor, kernel_w: int, kernel_h: int) -> torch.Tensor:
    """'valid'-mode box sum over the last two axes: (..., H, W) ->
    (..., H-kh+1, W-kw+1), accumulated in the input's dtype."""
    h, w = image.shape[-2], image.shape[-1]
    if h < kernel_h or w < kernel_w:
        raise ArgumentErr("box_sum_valid: image smaller than kernel")
    oh, ow = h - kernel_h + 1, w - kernel_w + 1
    col = image[..., 0:oh, :]
    for i in range(1, kernel_h):
        col = col + image[..., i:i + oh, :]
    out = col[..., :, 0:ow]
    for j in range(1, kernel_w):
        out = out + col[..., :, j:j + ow]
    return out


def box_sum_same(image: torch.Tensor, kernel_w: int, kernel_h: int,
                 edge: str = "zero") -> torch.Tensor:
    """Same-size box sum of a 2D image over a centered window, with the
    image edge-extended (``zero`` or ``constant``, i.e. replicate)."""
    padded = edge_extend(image, (kernel_w // 2, kernel_w - 1 - kernel_w // 2),
                         (kernel_h // 2, kernel_h - 1 - kernel_h // 2), mode=edge)
    return box_sum_valid(padded, kernel_w, kernel_h)


def box_sum_valid_int(image, kernel_w: int, kernel_h: int, device=None) -> torch.Tensor:
    """Integer-accumulator variant for census hamming costs: the int32
    'valid' window sum (exact in any order). A tensor keeps its device; an
    array goes to ``device`` (``None`` = the card)."""
    return box_sum_valid(on_device(image, device, torch.int32), kernel_w, kernel_h)


def box_filter_same(image: torch.Tensor, kernel_w: int, kernel_h: int,
                    edge: str = "constant") -> torch.Tensor:
    """Mean (box) filter, same size: the box sum over the count, an IEEE
    quotient on either device. The JAX package sums a plane of 64^2 or more
    as prefix-sum differences, so the two differ by the prefixes' rounding."""
    count = torch.tensor(float(kernel_w * kernel_h), dtype=image.dtype, device=image.device)
    return box_sum_same(image, kernel_w, kernel_h, edge) / count
