"""Edge extension (port of ``visionworkbench_tpu/image/edge.py``; ref
``src/vw/Image/EdgeExtension.h:73-187``), in every mode of the JAX
package:

* ``zero``        — outside pixels are 0 (``ZeroEdgeExtension``)
* ``constant``    — replicate the nearest edge pixel (VW's
                    ``ConstantEdgeExtension``: constant *continuation*,
                    numpy's ``edge``)
* ``value``       — a caller-provided fill value (``ValueEdgeExtension``)
* ``periodic``    — wrap around (``PeriodicEdgeExtension``)
* ``cylindrical`` — periodic in x, replicate in y
                    (``CylindricalEdgeExtension``)
* ``reflect``     — mirror about the edge pixel, edge not repeated
                    (``ReflectEdgeExtension``)
* ``linear``      — linear extrapolation from the last two pixels
                    (``LinearEdgeExtension``)

``constant``, ``periodic``, ``reflect`` and ``cylindrical`` are one index
gather per axis (pads wider than the image included, as numpy's ``pad``
extends them); ``zero`` and ``value`` copy the image into a filled frame;
``linear`` extrapolates x first, then y, as ``last + k * (last - penult)``
in the JAX package's order, so every mode equals the JAX package's bit for
bit.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from visionworkbench_torch.core.exceptions import ArgumentErr

EDGE_MODES = ("zero", "constant", "value", "periodic", "cylindrical", "reflect",
              "linear")


def _source_index(start: int, count: int, n: int, mode: str, device):
    """Indices into an axis of length ``n`` that serve positions
    ``start .. start + count - 1`` under an index-mapping ``mode``."""
    idx = torch.arange(start, start + count, device=device)
    if mode == "periodic":
        return torch.remainder(idx, n)
    if mode == "reflect" and n > 1:
        period = 2 * n - 2
        m = torch.remainder(idx, period)
        return torch.where(m >= n, period - m, m)
    return idx.clamp_(0, n - 1)       # constant (and reflect of one sample)


def _fill_crop(image, x0, y0, width, height, value):
    """Crop with every outside pixel ``value``."""
    h, w = image.shape[0], image.shape[1]
    out = image.new_full((height, width) + tuple(image.shape[2:]), value)
    ya, yb = max(y0, 0), min(y0 + height, h)
    xa, xb = max(x0, 0), min(x0 + width, w)
    if ya < yb and xa < xb:
        out[ya - y0:yb - y0, xa - x0:xb - x0] = image[ya:yb, xa:xb]
    return out


def _linear_extrapolate(image: torch.Tensor, axis: int, before: int,
                        after: int) -> torch.Tensor:
    """Linear extrapolation pad along one axis (ref ``LinearEdgeExtension``):
    ``first + k * (first - second)`` before, ``last + k * (last - penult)``
    after; an axis of one sample is replicated."""
    n = image.shape[axis]
    if n < 2:
        idx = torch.arange(-before, n + after, device=image.device).clamp_(0, n - 1)
        return image.index_select(axis, idx)
    shape = [1] * image.dim()
    parts = []
    if before > 0:
        first, second = image.narrow(axis, 0, 1), image.narrow(axis, 1, 1)
        shape[axis] = before
        ks = torch.arange(before, 0, -1, device=image.device).to(image.dtype)
        parts.append(first + ks.reshape(shape) * (first - second))
    parts.append(image)
    if after > 0:
        last, penult = image.narrow(axis, n - 1, 1), image.narrow(axis, n - 2, 1)
        shape[axis] = after
        ks = torch.arange(1, after + 1, device=image.device).to(image.dtype)
        parts.append(last + ks.reshape(shape) * (last - penult))
    return torch.cat(parts, axis)


def crop_extended(image: torch.Tensor, x0: int, y0: int, width: int,
                  height: int, mode: str = "constant",
                  value: float = 0.0) -> torch.Tensor:
    """Crop a (possibly out-of-bounds) region of ``image`` (H, W[, C]),
    serving outside pixels from the edge-extension policy — the reference's
    ``crop(edge_extend(img, ...), bbox)`` idiom. (x0, y0) may be negative."""
    if mode not in EDGE_MODES:
        raise ArgumentErr(f"Unknown edge extension mode: {mode!r}; one of "
                          f"{EDGE_MODES}")
    h, w = image.shape[0], image.shape[1]
    x0, y0, width, height = int(x0), int(y0), int(width), int(height)
    if mode in ("zero", "value"):
        return _fill_crop(image, x0, y0, width, height,
                          0 if mode == "zero" else value)
    if mode == "linear":
        padded = _linear_extrapolate(image, 1, max(0, -x0), max(0, x0 + width - w))
        padded = _linear_extrapolate(padded, 0, max(0, -y0), max(0, y0 + height - h))
        ys, xs = y0 + max(0, -y0), x0 + max(0, -x0)
        return padded[ys:ys + height, xs:xs + width]
    dev = image.device
    x_mode = "periodic" if mode == "cylindrical" else mode
    y_mode = "constant" if mode == "cylindrical" else mode
    rows = _source_index(y0, height, h, y_mode, dev)
    cols = _source_index(x0, width, w, x_mode, dev)
    return image.index_select(0, rows).index_select(1, cols)


def edge_extend(image: torch.Tensor,
                x_pad: Union[int, Tuple[int, int]] = 0,
                y_pad: Union[int, Tuple[int, int]] = 0,
                mode: str = "constant", value: float = 0.0) -> torch.Tensor:
    """Pad ``image`` (H, W[, C]) by ``y_pad`` rows / ``x_pad`` cols per side;
    each may be an int (symmetric) or a (before, after) pair."""
    if isinstance(x_pad, int):
        x_pad = (x_pad, x_pad)
    if isinstance(y_pad, int):
        y_pad = (y_pad, y_pad)
    h, w = image.shape[0], image.shape[1]
    return crop_extended(image, -int(x_pad[0]), -int(y_pad[0]),
                         w + int(x_pad[0]) + int(x_pad[1]),
                         h + int(y_pad[0]) + int(y_pad[1]), mode=mode, value=value)


def crop_to_interior(image, x_pad: int, y_pad: int):
    """Inverse of a symmetric :func:`edge_extend`."""
    h, w = image.shape[0], image.shape[1]
    return image[y_pad:h - y_pad if y_pad else h, x_pad:w - x_pad if x_pad else w]
