"""Bayer demosaicing (port of ``visionworkbench_tpu/camera/bayer.py``; ref
``src/vw/Camera/BayerFilter.h``): bilinear interpolation of a mosaic into
RGB, fully vectorized on the port's ``correlate_2d`` (a multiply and an add
a tap), each channel the IEEE quotient of its weighted sum by its weight
sum, so the card and the CPU agree bit for bit."""

from __future__ import annotations

import numpy as np
import torch

from visionworkbench_torch.core.device import on_device
from visionworkbench_torch.image.convolution import correlate_2d

# (red, first green, second green, blue) sites of the 2x2 cell, (row, col)
PATTERNS = {"rggb": ((0, 0), (0, 1), (1, 0), (1, 1)),
            "bggr": ((1, 1), (0, 1), (1, 0), (0, 0)),
            "grbg": ((0, 1), (0, 0), (1, 1), (1, 0)),
            "gbrg": ((1, 0), (0, 0), (1, 1), (0, 1))}

_K_RB = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]], np.float32) / 4.0
_K_G = np.array([[0, 1, 0], [1, 4, 1], [0, 1, 0]], np.float32) / 4.0


def bayer_demosaic(mosaic, pattern: str = "rggb", device=None):
    """(H, W) mosaic -> (H, W, 3) RGB via bilinear kernels. A tensor keeps
    its device; an array goes to ``device`` (``None`` = the card)."""
    mosaic = on_device(mosaic, device, torch.float32)
    h, w = mosaic.shape
    ys = torch.arange(h, device=mosaic.device)[:, None] % 2
    xs = torch.arange(w, device=mosaic.device)[None, :] % 2
    (ry, rx), (g1y, g1x), (g2y, g2x), (by, bx) = PATTERNS[pattern.lower()]
    r_mask = ((ys == ry) & (xs == rx)).to(torch.float32)
    g_mask = (((ys == g1y) & (xs == g1x)) | ((ys == g2y) & (xs == g2x))).to(torch.float32)
    b_mask = ((ys == by) & (xs == bx)).to(torch.float32)

    def interp(channel_mask, kern):
        num = correlate_2d(mosaic * channel_mask, kern, edge="reflect")
        den = correlate_2d(channel_mask, kern, edge="reflect")
        return num / torch.clamp(den, min=1e-8)

    return torch.stack([interp(r_mask, _K_RB), interp(g_mask, _K_G),
                        interp(b_mask, _K_RB)], -1)
