"""Image statistics (port of ``visionworkbench_tpu/image/statistics.py``;
ref ``src/vw/Image/Statistics.h``): min/max/mean/stddev and histograms,
with masked variants that ignore invalid pixels.

Histogram counts are integers from ``torch.bincount`` (no float
scatter-add), so they equal the JAX package's exactly.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from visionworkbench_torch.core.device import as_tensor, on_device
from visionworkbench_torch.image.types import MaskedImage


def min_pixel_value(image):
    return torch.min(image)


def max_pixel_value(image):
    return torch.max(image)


def min_max_pixel_values(image) -> Tuple:
    return torch.min(image), torch.max(image)


def mean_pixel_value(image):
    return torch.mean(image)


def stddev_pixel_value(image):
    """Population standard deviation (``jnp.std``'s ddof 0)."""
    return torch.std(image, correction=0)


def sum_of_pixel_values(image):
    return torch.sum(image)


def _masked(mi: MaskedImage):
    valid = mi.valid[..., None] if mi.data.ndim == 3 else mi.valid
    return mi.data, valid


def _count(valid):
    return torch.clamp_min(valid.sum(), 1)


def masked_mean(mi: MaskedImage):
    data, valid = _masked(mi)
    return torch.where(valid, data, 0.0).sum() / _count(valid)


def masked_min(mi: MaskedImage, fill=float("inf")):
    data, valid = _masked(mi)
    return torch.where(valid, data, fill).min()


def masked_max(mi: MaskedImage, fill=float("-inf")):
    data, valid = _masked(mi)
    return torch.where(valid, data, fill).max()


def masked_stddev(mi: MaskedImage):
    data, valid = _masked(mi)
    count = _count(valid)
    mean = torch.where(valid, data, 0.0).sum() / count
    var = torch.where(valid, (data - mean) ** 2, 0.0).sum() / count
    return torch.sqrt(var)


def histogram(image, num_bins: int, lo=None, hi=None,
              valid: Optional[torch.Tensor] = None, device=None):
    """Histogram over [lo, hi] with ``num_bins`` buckets (ref ``histogram``,
    Statistics.h) as fp32 counts; masked pixels excluded when ``valid``
    given. A pixel's bucket is ``int((v - lo) / span * num_bins)`` clipped
    to the range, the quotient an IEEE one, as in the JAX package."""
    image = on_device(image, device)
    dev = image.device
    lo = image.min() if lo is None else as_tensor(lo, torch.float32, dev)
    hi = image.max() if hi is None else as_tensor(hi, torch.float32, dev)
    span = torch.where(hi == lo, 1.0, hi - lo)
    idx = torch.clamp(((image - lo) / span * num_bins).to(torch.int32), 0, num_bins - 1)
    idx = idx.reshape(-1).to(torch.int64)
    if valid is not None:
        # invalid pixels go to one more bucket, dropped
        idx = torch.where(as_tensor(valid, torch.bool, dev).reshape(-1), idx, num_bins)
    counts = torch.bincount(idx, minlength=num_bins + 1)[:num_bins]
    return counts.to(torch.float32)


def cdf_quantile(image, quantile: float, num_bins: int = 1024,
                 valid: Optional[torch.Tensor] = None, device=None):
    """Approximate quantile via histogram CDF (the role of the reference's
    ``CDFAccumulator``, ``src/vw/Math/CDFAccumulator.cc`` — a dense
    histogram instead of streaming percentiles): the centre of the first
    bucket whose cumulative count reaches ``quantile`` of the total."""
    image = on_device(image, device)
    lo = image.min()
    hi = image.max()
    cdf = torch.cumsum(histogram(image, num_bins, lo, hi, valid), 0)
    target = quantile * cdf[-1]
    bin_idx = torch.clamp(torch.searchsorted(cdf, target[None]), 0, num_bins - 1)[0]
    n = torch.tensor(float(num_bins), device=image.device)
    return lo + (bin_idx.to(torch.float32) + 0.5) / n * (hi - lo)
