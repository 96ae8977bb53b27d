"""Image conventions and the masked-image container (port of
``visionworkbench_tpu/image/types.py``).

The reference carries validity in ``PixelMask<T>`` pixels
(``src/vw/Image/PixelMask.h:105-198``). As in the JAX package, a
``MaskedImage`` is a struct of arrays ``(data, valid)``: ``valid`` is a
boolean tensor of ``data``'s spatial shape. All mask-propagating math lives
in :mod:`visionworkbench_torch.image.masks`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from visionworkbench_torch.core.device import as_tensor, on_device


class MaskedImage(NamedTuple):
    data: torch.Tensor   # (H, W[, C]) float32 typically
    valid: torch.Tensor  # (H, W) bool

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    def filled(self, fill_value=0.0) -> torch.Tensor:
        """Data with invalid pixels replaced by ``fill_value``
        (ref ``apply_mask``, ``src/vw/Image/MaskViews.h``)."""
        v = self.valid[..., None] if self.data.ndim == 3 else self.valid
        return torch.where(v, self.data, as_tensor(fill_value, self.data.dtype,
                                                   self.data.device))


def create_mask(data, nodata_value: Optional[float] = None, device=None) -> MaskedImage:
    """Wrap an image with a validity mask (ref ``create_mask``, MaskViews.h):
    pixels equal to ``nodata_value`` (in every channel) or non-finite (in
    the first channel) are invalid. A tensor keeps its device, an array
    goes to ``device`` (``None`` = the card)."""
    data = on_device(data, device)
    spatial = data if data.ndim == 2 else data[..., 0]
    valid = torch.isfinite(spatial)
    if nodata_value is not None:
        nd = as_tensor(nodata_value, data.dtype, data.device)
        if data.ndim == 3:
            valid = valid & (data != nd).any(dim=-1)
        else:
            valid = valid & (data != nd)
    return MaskedImage(data, valid)


def all_valid(data, device=None) -> MaskedImage:
    data = on_device(data, device)
    return MaskedImage(data, torch.ones(data.shape[:2], dtype=torch.bool,
                                        device=data.device))


def as_float32(image, device=None) -> torch.Tensor:
    """Convert to the framework compute dtype. Integer images are rescaled to
    [0, 1] following the reference's channel_cast_rescale semantics
    (``src/vw/Image/PixelTypeInfo.h``): an fp32 quotient by the type's
    largest value. A NumPy integer array is rescaled on the host, then sent
    to ``device``."""
    if isinstance(image, torch.Tensor):
        if image.dtype.is_floating_point:
            return image.to(torch.float32)
        top = torch.tensor(float(torch.iinfo(image.dtype).max), dtype=torch.float32,
                           device=image.device)
        return image.to(torch.float32) / top
    arr = np.asarray(image)
    if not np.issubdtype(arr.dtype, np.integer):
        return on_device(arr, device, torch.float32)
    out = arr.astype(np.float32) / np.float32(np.iinfo(arr.dtype).max)
    return on_device(out, device, torch.float32)
