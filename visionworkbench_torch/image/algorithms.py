"""Per-image algorithms (port of ``visionworkbench_tpu/image/algorithms.py``;
ref ``src/vw/Image/Algorithms.h:33-266`` and ``AlgorithmFunctions.h``):
clamp / normalize / threshold / fill and the opacity queries.

Each function works on a tensor's device; a NumPy array goes to ``device``
(``None`` = the card). The opacity queries and the data bounding box are
host queries that read the image back, as the reference's pixel loops do.
"""

from __future__ import annotations

import numpy as np
import torch

from visionworkbench_torch.core.device import as_tensor, on_device, resolve_device
from visionworkbench_torch.math.bbox import BBox2i


def clamp(image, low=0.0, high=1.0, device=None):
    """(ref ``clamp``, Algorithms.h:60)"""
    return torch.clamp(on_device(image, device), low, high)


def normalize(image, new_low=0.0, new_high=1.0, old_low=None, old_high=None,
              valid=None, device=None):
    """Rescale [old_low, old_high] -> [new_low, new_high]; old range defaults
    to the image min/max over all channels — the reference's auto-detecting
    ``normalize`` overloads (ref ``AutoNormalize.h:1-90``, which call
    ``min_max_channel_values``; explicit-range form: Algorithms.h:110-160).
    ``valid`` restricts the auto range to a boolean mask, matching the
    PixelMask behavior of ``min_max_channel_values`` (invalid pixels are
    skipped when detecting the range but still rescaled).

    The range and the scale are fp32 0-d tensors and the scale is an IEEE
    quotient, as in the JAX package."""
    image = on_device(image, device)
    if valid is not None and (old_low is None or old_high is None):
        v = as_tensor(valid, torch.bool, image.device)
        if v.ndim < image.ndim:
            v = v[..., None]
        if old_low is None:
            old_low = torch.where(v, image, float("inf")).min()
        if old_high is None:
            old_high = torch.where(v, image, float("-inf")).max()
    dtype, dev = image.dtype, image.device
    old_low = as_tensor(image.min() if old_low is None else old_low, dtype, dev)
    old_high = as_tensor(image.max() if old_high is None else old_high, dtype, dev)
    old_range = old_high - old_low
    # Degenerate range maps everything to new_low, as the reference does.
    degenerate = old_range == 0
    scale = torch.where(degenerate, 0.0, as_tensor(new_high - new_low, dtype, dev)
                        / torch.where(degenerate, 1.0, old_range))
    return (image - old_low) * scale + new_low


def threshold(image, thresh=0.0, low=0.0, high=1.0, device=None):
    """Binary threshold: > thresh -> high else low (ref ``threshold``,
    Algorithms.h:206-240)."""
    return torch.where(on_device(image, device) > thresh, high, low)


def fill(shape_or_image, value, dtype=torch.float32, device=None):
    """Constant image (ref eager ``fill``, AlgorithmFunctions.h): the shape
    and dtype of a tensor or array, or a shape and ``dtype``."""
    if isinstance(shape_or_image, torch.Tensor):
        return torch.full_like(shape_or_image, value)
    if hasattr(shape_or_image, "shape"):
        return on_device(np.full(shape_or_image.shape, value, shape_or_image.dtype), device)
    return torch.full(tuple(shape_or_image), value, dtype=dtype,
                      device=resolve_device(device))


def _alpha_of(image, valid=None):
    """Alpha plane of an image as a host array: an explicit ``valid`` mask
    (MaskedImage convention), else the last channel of an even-channel array
    (GrayA / RGBA), else None (no alpha => opaque, like ``PixelHasAlpha``)."""
    if valid is not None:
        return _host(valid).astype(np.float32)
    if image.ndim == 3 and image.shape[-1] in (2, 4):
        return _host(image)[..., -1]
    return None


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def is_opaque(image, valid=None) -> bool:
    """True iff the image is entirely opaque (ref ``is_opaque``,
    ``ImageOpacity.h:33-52``: alpha-less pixel types are opaque by
    definition; otherwise every pixel's alpha must be at maximum)."""
    a = _alpha_of(image, valid)
    if a is None:
        return True
    return bool(np.all(a >= 1.0))


def is_transparent(image, valid=None) -> bool:
    """True iff the image is entirely transparent (ref ``is_transparent``,
    ``ImageOpacity.h:54-76``: alpha-less pixel types are never
    transparent)."""
    a = _alpha_of(image, valid)
    if a is None:
        return False
    return bool(np.all(a <= 0.0))


def nonzero_data_bounding_box(image, nodata=0.0) -> BBox2i:
    """Tight box around pixels != nodata (ref ``nonzero_data_bounding_box``,
    ``ImageOpacity.h:78-123``). Returns a BBox2i (empty if no valid data)."""
    arr = _host(image)
    spatial = arr if arr.ndim == 2 else arr.any(axis=-1)
    ys, xs = np.nonzero(spatial != nodata)
    if len(ys) == 0:
        return BBox2i(0, 0, 0, 0)
    return BBox2i.from_bounds(int(xs.min()), int(ys.min()),
                              int(xs.max()) + 1, int(ys.max()) + 1)
