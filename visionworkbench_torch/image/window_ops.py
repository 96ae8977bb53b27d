"""Sliding-window algorithms and utility views (port of
``visionworkbench_tpu/image/window_ops.py``; ref
``src/vw/Image/WindowAlgorithms.h:37-124``, ``UtilityViews.h``,
``AntiAliasing.h``, ``Fourier.h:35-56``).

``uniform_noise_view`` draws from a ``torch.Generator`` seeded with the
seed (on the CPU, then sent to the device, so both devices get the same
array); the JAX package draws from ``jax.random``, whose stream the port
does not reproduce.
"""

from __future__ import annotations

import numpy as np
import torch

from visionworkbench_torch.core.device import on_device, resolve_device
from visionworkbench_torch.image.edge import edge_extend
from visionworkbench_torch.image.filters import gaussian_filter
from visionworkbench_torch.ops.box_filter import box_filter_same


def gaussian_blur_approx(img, sigma: float, passes: int = 3, device=None):
    """Iterated-box approximation of a Gaussian blur
    (ref ``gaussian_blur_approx``, WindowAlgorithms.h): box width chosen so
    ``passes`` box filters approximate sigma."""
    w = int(np.sqrt(12.0 * sigma * sigma / passes + 1))
    if w % 2 == 0:
        w += 1
    out = on_device(img, device, torch.float32)
    for _ in range(passes):
        out = box_filter_same(out, w, w)
    return out


def median_filter(img, size: int = 3, device=None):
    """Windowed median over the edge-extended ``size`` x ``size`` window:
    the mean of the two middle values of an even count (``jnp.median``'s
    midpoint; ``torch.median`` would take the lower one), NaN where the
    window holds a NaN."""
    img = on_device(img, device, torch.float32)
    h, w = img.shape
    pad = size // 2
    p = edge_extend(img, pad, pad, "constant")
    stack = torch.stack([p[dy:dy + h, dx:dx + w]
                         for dy in range(size) for dx in range(size)])
    srt = torch.sort(stack, dim=0).values
    n = size * size
    mid = (srt[(n - 1) // 2] + srt[n // 2]) * 0.5
    return torch.where(torch.isnan(stack).any(dim=0), float("nan"), mid)


def constant_view(value, rows: int, cols: int, dtype=torch.float32, device=None):
    """(ref ``constant_view``, UtilityViews.h)"""
    return torch.full((rows, cols), value, dtype=dtype, device=resolve_device(device))


def uniform_noise_view(seed: int, rows: int, cols: int, device=None):
    """Deterministic uniform noise in [0, 1) (ref ``uniform_noise_view`` —
    the correlator tests' synthetic source): the same array for a seed on
    every device."""
    gen = torch.Generator().manual_seed(seed)
    return torch.rand((rows, cols), generator=gen).to(resolve_device(device))


def antialiased_downsample(img, factor: int, device=None):
    """Gaussian prefilter + subsample (ref ``AntiAliasing.h``)."""
    img = on_device(img, device, torch.float32)
    return gaussian_filter(img, factor / 2.0)[::factor, ::factor]


# --------------------------------------------------------------------------
# Fourier helpers (ref Fourier.h — OpenCV DFT wrappers in the reference;
# torch.fft here)
# --------------------------------------------------------------------------

def fft2(img, device=None):
    return torch.fft.fft2(on_device(img, device, torch.float32))


def ifft2(spec):
    return torch.fft.ifft2(spec)


def fftshift(x):
    """(ref ``fftshift``, Fourier.h)"""
    return torch.fft.fftshift(x)


def raised_cosine_window(rows: int, cols: int, beta: float = 0.35, device=None):
    """Separable raised-cosine window (ref the phase-correlation filter in
    Fourier.h)."""
    dev = resolve_device(device)

    def rc(n):
        t = torch.linspace(-0.5, 0.5, n, device=dev).abs()
        a = (1 - beta) / 2
        edge = 0.5 * (1 + torch.cos(torch.pi * (t - a) / (0.5 - a)))
        return torch.where(t <= a, 1.0, edge)
    return rc(rows)[:, None] * rc(cols)[None, :]
