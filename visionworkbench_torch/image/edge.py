"""Edge extension (port of ``visionworkbench_tpu/image/edge.py``; ref
``src/vw/Image/EdgeExtension.h:73-187``), in the two modes the correlator
uses:

* ``constant`` — replicate the nearest edge pixel (VW's
  ``ConstantEdgeExtension``: constant *continuation*, numpy's ``edge``)
* ``zero``     — outside pixels are 0 (``ZeroEdgeExtension``)

The other modes of the JAX package wait for the image-substrate slice.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from visionworkbench_torch.core.exceptions import ArgumentErr

EDGE_MODES = ("zero", "constant")


def crop_extended(image: torch.Tensor, x0: int, y0: int, width: int,
                  height: int, mode: str = "constant") -> torch.Tensor:
    """Crop a (possibly out-of-bounds) region of ``image`` (H, W[, C]),
    serving outside pixels from the edge-extension policy — the reference's
    ``crop(edge_extend(img, ...), bbox)`` idiom. (x0, y0) may be negative."""
    if mode not in EDGE_MODES:
        raise ArgumentErr(f"Unknown edge extension mode: {mode!r}; one of "
                          f"{EDGE_MODES} (the others wait for a later slice)")
    h, w = image.shape[0], image.shape[1]
    x0, y0, width, height = int(x0), int(y0), int(width), int(height)
    if mode == "constant":
        dev = image.device
        rows = torch.arange(y0, y0 + height, device=dev).clamp_(0, h - 1)
        cols = torch.arange(x0, x0 + width, device=dev).clamp_(0, w - 1)
        return image.index_select(0, rows).index_select(1, cols)
    out = image.new_zeros((height, width) + tuple(image.shape[2:]))
    ya, yb = max(y0, 0), min(y0 + height, h)
    xa, xb = max(x0, 0), min(x0 + width, w)
    if ya < yb and xa < xb:
        out[ya - y0:yb - y0, xa - x0:xb - x0] = image[ya:yb, xa:xb]
    return out


def edge_extend(image: torch.Tensor,
                x_pad: Union[int, Tuple[int, int]] = 0,
                y_pad: Union[int, Tuple[int, int]] = 0,
                mode: str = "constant") -> torch.Tensor:
    """Pad ``image`` (H, W[, C]) by ``y_pad`` rows / ``x_pad`` cols per side;
    each may be an int (symmetric) or a (before, after) pair."""
    if isinstance(x_pad, int):
        x_pad = (x_pad, x_pad)
    if isinstance(y_pad, int):
        y_pad = (y_pad, y_pad)
    h, w = image.shape[0], image.shape[1]
    return crop_extended(image, -int(x_pad[0]), -int(y_pad[0]),
                         w + int(x_pad[0]) + int(x_pad[1]),
                         h + int(y_pad[0]) + int(y_pad[1]), mode=mode)
