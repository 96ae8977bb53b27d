"""2D and separable convolution (port of
``visionworkbench_tpu/image/convolution.py``; ref
``src/vw/Image/Convolution.h:51-335``).

The reference's ``ConvolutionView`` correlates with a 180-degree-rotated
kernel — true convolution — with the kernel origin defaulting to the
center (``Convolution.h:105-170``); here over an edge-extended input.

Conventions: images are (H, W) or (H, W, C); 2D kernels are (Kh, Kw)
indexed [row, col]; 1D kernels run along x (cols) or y (rows). The output
has the input's spatial shape.

Kernels of up to ``_STENCIL_MAX_TAPS`` taps run as a weighted sum of
shifted slices in the JAX package's order: row i, then column j, each term
``tap * slice`` (the tap rounded to fp32) a multiply of its own, added to
the running sum left to right. No step can fuse into an FMA (each is its
own tensor operation), so the CPU and the card agree bit for bit, and both
with the JAX package. Larger kernels run ``F.conv2d`` in fp32 (TF32 is off
package-wide): its summation order is cuDNN's or the CPU backend's, so
they agree with the JAX package's ``conv_general_dilated`` to fp32
rounding only.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.image.edge import edge_extend

# Tap count up to which a 'valid' correlation is the shifted-slice stencil
# (ref ``_STENCIL_MAX_TAPS`` of the JAX package).
_STENCIL_MAX_TAPS = 49


def _default_origin(n: int) -> int:
    """VW's default kernel origin after rotation is cols/2
    (Convolution.h:127); in true-convolution terms (n-1) - n//2."""
    return (n - 1) - n // 2


def _correlate_valid_stencil(image: torch.Tensor, kernel2d: np.ndarray) -> torch.Tensor:
    """'valid' correlation as an unrolled shifted-slice weighted sum; every
    tap, zeros included, is one multiply and one add."""
    kh, kw = kernel2d.shape
    oh = image.shape[0] - kh + 1
    ow = image.shape[1] - kw + 1
    out = None
    for i in range(kh):
        for j in range(kw):
            term = float(kernel2d[i, j]) * image[i:i + oh, j:j + ow]
            out = term if out is None else out + term
    return out


def _correlate_valid(image: torch.Tensor, kernel2d) -> torch.Tensor:
    """'valid' cross-correlation of an (H, W[, C]) image with a (Kh, Kw)
    kernel, the taps rounded to fp32."""
    kernel2d = np.asarray(kernel2d, np.float32)
    if kernel2d.shape[0] * kernel2d.shape[1] <= _STENCIL_MAX_TAPS:
        return _correlate_valid_stencil(image, kernel2d)
    if image.dim() == 2:
        arr = image[None, None]
    elif image.dim() == 3:
        arr = image.permute(2, 0, 1)[:, None]
    else:
        raise ArgumentErr(f"convolution expects (H, W[, C]) image, got shape "
                          f"{tuple(image.shape)}")
    weight = torch.as_tensor(np.ascontiguousarray(kernel2d), dtype=arr.dtype,
                             device=arr.device)[None, None]
    out = F.conv2d(arr, weight)
    return out[0, 0] if image.dim() == 2 else out[:, 0].permute(1, 2, 0)


def convolution_filter(src: torch.Tensor, kernel2d, cx: Optional[int] = None,
                       cy: Optional[int] = None, edge: str = "constant",
                       edge_value: float = 0.0) -> torch.Tensor:
    """True 2D convolution with kernel origin (cx, cy) (ref
    ``convolution_filter``, Filter.h:113-142; the default edge mode
    replicates):

    ``out(y, x) = sum_{n,m} kernel(n, m) * src(y + cy - n, x + cx - m)``
    """
    kernel2d = np.asarray(kernel2d, np.float32)
    kh, kw = kernel2d.shape
    cx = _default_origin(kw) if cx is None else cx
    cy = _default_origin(kh) if cy is None else cy
    padded = edge_extend(src, x_pad=(kw - 1 - cx, cx), y_pad=(kh - 1 - cy, cy),
                         mode=edge, value=edge_value)
    return _correlate_valid(padded, kernel2d[::-1, ::-1])


def separable_convolution_filter(src: torch.Tensor, x_kernel: Sequence[float],
                                 y_kernel: Sequence[float],
                                 cx: Optional[int] = None, cy: Optional[int] = None,
                                 edge: str = "constant",
                                 edge_value: float = 0.0) -> torch.Tensor:
    """Separable true convolution: the 1D kernel along x, then along y
    (ref ``SeparableConvolutionView``, Convolution.h:184-335). Either kernel
    may be empty or None: identity along that axis."""
    out = src
    if x_kernel is not None and np.size(x_kernel) > 0:
        xk = np.asarray(x_kernel, np.float32).reshape(-1)
        ox = _default_origin(xk.size) if cx is None else cx
        padded = edge_extend(out, x_pad=(xk.size - 1 - ox, ox), y_pad=0,
                             mode=edge, value=edge_value)
        out = _correlate_valid(padded, xk[::-1][None, :])
    if y_kernel is not None and np.size(y_kernel) > 0:
        yk = np.asarray(y_kernel, np.float32).reshape(-1)
        oy = _default_origin(yk.size) if cy is None else cy
        padded = edge_extend(out, x_pad=0, y_pad=(yk.size - 1 - oy, oy),
                             mode=edge, value=edge_value)
        out = _correlate_valid(padded, yk[::-1][:, None])
    return out


def correlate_2d(src: torch.Tensor, kernel2d, edge: str = "constant",
                 edge_value: float = 0.0) -> torch.Tensor:
    """Centered cross-correlation (no kernel flip; ref
    ``correlate_2d_at_point``, Convolution.h:69-91)."""
    kernel2d = np.asarray(kernel2d, np.float32)
    kh, kw = kernel2d.shape
    padded = edge_extend(src, x_pad=(kw // 2, kw - 1 - kw // 2),
                         y_pad=(kh // 2, kh - 1 - kh // 2), mode=edge,
                         value=edge_value)
    return _correlate_valid(padded, kernel2d)
