"""Image interpolation (port of ``visionworkbench_tpu/image/interpolation.py``;
ref ``src/vw/Image/Interpolation.h:75-190``).

Samples an image at float coordinates ``(x, y)`` = (col, row), vectorized
over arbitrary coordinate-array shapes, with the reference's weights:

* bilinear — separable (1-t, t) (``BilinearInterpolationImpl``,
  ``Interpolation.h:75-112``)
* bicubic  — the reference's 2x Catmull-Rom basis with a global 0.25
  normalization (``BicubicInterpolationImpl``, ``Interpolation.h:138-182``):
  ``s0=((2-t)t-1)t, s1=(3t-5)t^2+2, s2=((4-3t)t+1)t, s3=(t-1)t^2``
* nearest  — round-half-up in each axis (``NearestPixelInterpolation``)

Every gather clamps to the border. The arithmetic is elementwise, one
tensor operation a step in the JAX package's order, with no reduction.
"""

from __future__ import annotations

import torch

from visionworkbench_torch.core.device import as_tensor, resolve_device
from visionworkbench_torch.core.exceptions import ArgumentErr

METHODS = ("nearest", "bilinear", "bicubic")


def pixel_buffer(method: str) -> int:
    """Out-of-bounds reach of ``method`` (the reference's ``pixel_buffer``)."""
    return {"nearest": 0, "bilinear": 1, "bicubic": 2}[method]


def _gather(image, xi, yi):
    """Clamped integer gather; image (H, W[, C]), xi/yi integer tensors."""
    h, w = image.shape[0], image.shape[1]
    return image[yi.clamp(0, h - 1).long(), xi.clamp(0, w - 1).long()]


def interpolate(image, x, y, method: str = "bilinear", device=None):
    """Sample ``image`` at float (x=col, y=row) coordinates.

    Returns a tensor of shape ``x.shape`` (plus the trailing channel axis if
    the image has one). Out-of-range coordinates clamp to the border. The
    work runs on ``image``'s device when it is a tensor, else on
    ``device`` (``None`` = the card)."""
    dev = image.device if isinstance(image, torch.Tensor) else resolve_device(device)
    if not isinstance(image, torch.Tensor):
        image = as_tensor(image, None, dev)
    x = as_tensor(x, torch.float32, dev)
    y = as_tensor(y, torch.float32, dev)
    if method == "nearest":
        xi = torch.floor(x + 0.5).to(torch.int32)
        yi = torch.floor(y + 0.5).to(torch.int32)
        return _gather(image, xi, yi)
    if method == "bilinear":
        return _bilinear(image, x, y)
    if method == "bicubic":
        return _bicubic(image, x, y)
    raise ArgumentErr(f"Unknown interpolation method {method!r}; one of {METHODS}")


def _expand(w, image):
    """Broadcast a weight tensor against the optional channel axis."""
    return w[..., None] if image.ndim == 3 else w


def _bilinear(image, x, y):
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    tx = x - x0
    ty = y - y0
    x0i = x0.to(torch.int32)
    y0i = y0.to(torch.int32)
    p00 = _gather(image, x0i, y0i)
    p10 = _gather(image, x0i + 1, y0i)
    p01 = _gather(image, x0i, y0i + 1)
    p11 = _gather(image, x0i + 1, y0i + 1)
    tx = _expand(tx, image)
    ty = _expand(ty, image)
    top = p00 * (1 - tx) + p10 * tx
    bot = p01 * (1 - tx) + p11 * tx
    return top * (1 - ty) + bot * ty


def _cubic_weights(t):
    """The reference's bicubic taps (Interpolation.h:155-158); sum == 2."""
    s0 = ((2 - t) * t - 1) * t
    s1 = (3 * t - 5) * t * t + 2
    s2 = ((4 - 3 * t) * t + 1) * t
    s3 = (t - 1) * t * t
    return s0, s1, s2, s3


def _bicubic(image, x, y):
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    tx = x - x0
    ty = y - y0
    x0i = x0.to(torch.int32)
    y0i = y0.to(torch.int32)
    sx = _cubic_weights(tx)
    sy = _cubic_weights(ty)
    acc = None
    for j in range(4):
        row = None
        for i in range(4):
            p = _gather(image, x0i + (i - 1), y0i + (j - 1))
            term = p * _expand(sx[i], image)
            row = term if row is None else row + term
        term = row * _expand(sy[j], image)
        acc = term if acc is None else acc + term
    return acc * 0.25


def interpolate_image(image, method: str = "bilinear"):
    """Return a sampler closure ``f(x, y)`` (parity with the reference's
    ``interpolate(view, interp)`` wrapper, Interpolation.h:243)."""
    def sampler(x, y):
        return interpolate(image, x, y, method)
    return sampler
