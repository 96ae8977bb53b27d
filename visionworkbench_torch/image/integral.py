"""Integral images and box/Haar filters (port of
``visionworkbench_tpu/image/integral.py``; ref
``src/vw/InterestPoint/IntegralImage.h:42-217`` and ``BoxFilter.h``).

The summed-area table is float64 here, where the JAX package's is fp32: a
box sum is a difference of four prefixes, and an fp32 prefix carries an
error that grows with the prefix (up to ~0.1 at 1024^2 on [0, 1) noise,
where a 3x3 box sums to ~4.5). In float64 the prefixes of an fp32 image
are exact or within a relative 2^-53, so each box sum, rounded once to
fp32 at the end, is the same on the card (a parallel scan) and on the CPU
(a sequential one), and within the JAX package's prefix rounding of its
value. The formulation is otherwise the JAX package's: a zero top row and
left column, edge-extended inputs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from visionworkbench_torch.core.device import on_device
from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.image.edge import edge_extend


def integral_image(img, device=None) -> torch.Tensor:
    """Summed-area table (float64) with a zero top row/left column, so
    ``box = I[y1, x1] - I[y0, x1] - I[y1, x0] + I[y0, x0]`` sums
    ``img[y0:y1, x0:x1]`` (ref ``IntegralImage.h:42-91``). A tensor keeps
    its device, an array goes to ``device`` (``None`` = the card)."""
    s = on_device(img, device, torch.float32).double().cumsum(0).cumsum(1)
    return F.pad(s, (1, 0, 1, 0))


def integral_box_sum(ii, x0, y0, x1, y1):
    """Sum of img[y0:y1, x0:x1] from the integral image; index args may be
    tensors (vectorized box queries)."""
    return ii[y1, x1] - ii[y0, x1] - ii[y1, x0] + ii[y0, x0]


def _box_sums(ii, x0: int, y0: int, x1: int, y1: int, h: int, w: int):
    """(h, w) box sums of ``ii``: the box of output pixel (y, x) is
    [y + y0, y + y1) x [x + x0, x + x1) of the table's image."""
    return (ii[y1:y1 + h, x1:x1 + w] - ii[y0:y0 + h, x1:x1 + w]
            - ii[y1:y1 + h, x0:x0 + w] + ii[y0:y0 + h, x0:x0 + w])


def box_filter_same(img, size: int, device=None) -> torch.Tensor:
    """Centered box sum via the integral image (O(1) per pixel regardless of
    size — the property the OBALoG detector exploits), fp32."""
    img = on_device(img, device, torch.float32)
    h, w = img.shape
    r = size // 2
    ii = integral_image(edge_extend(img, r + 1, r + 1, "constant"))
    return _box_sums(ii, 1, 1, 1 + size, 1 + size, h, w).to(torch.float32)


def _haar_table(img, size: int, device):
    if size % 2:
        raise ArgumentErr("haar size must be even")
    img = on_device(img, device, torch.float32)
    return integral_image(edge_extend(img, size, size, "constant")), img.shape


def haar_x(img, size: int, device=None) -> torch.Tensor:
    """Horizontal Haar wavelet response: right half minus left half
    (ref ``IntegralImage.h:131-217``)."""
    ii, (h, w) = _haar_table(img, size, device)
    o, half = size, size // 2
    left = _box_sums(ii, o - half, o - half, o, o + half, h, w)
    right = _box_sums(ii, o, o - half, o + half, o + half, h, w)
    return (right - left).to(torch.float32)


def haar_y(img, size: int, device=None) -> torch.Tensor:
    ii, (h, w) = _haar_table(img, size, device)
    o, half = size, size // 2
    top = _box_sums(ii, o - half, o - half, o + half, o, h, w)
    bot = _box_sums(ii, o - half, o, o + half, o + half, h, w)
    return (bot - top).to(torch.float32)


def obalog_interest(img, scale_level: int = 0, device=None) -> torch.Tensor:
    """Optimized Box Approximation of the Laplacian of Gaussian
    (ref ``IntegralInterestOperator.h:43-79``): a center-surround
    difference-of-box-sums response computed from the integral image; box
    sizes double per scale level. The means are IEEE quotients on either
    device."""
    inner = 3 * (1 << scale_level)
    outer = 3 * inner
    if inner % 2 == 0:
        inner += 1
    if outer % 2 == 0:
        outer += 1
    s_in = box_filter_same(img, inner, device)
    s_out = box_filter_same(img, outer, device)
    n_in, n_out = (torch.tensor(float(n * n), device=s_in.device) for n in (inner, outer))
    # Normalize to zero response on constant images.
    return s_in / n_in - s_out / n_out
