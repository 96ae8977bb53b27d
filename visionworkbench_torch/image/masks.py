"""Mask views and mask-propagating math (port of
``visionworkbench_tpu/image/masks.py``; ref ``src/vw/Image/MaskViews.h``
and ``PixelMask.h:105-198``).

The reference's masked pixel lattice: a binary op's result is valid iff both
operands are valid; unary ops preserve validity. Struct-of-arrays here.
"""

from __future__ import annotations

from typing import Callable

import torch

from visionworkbench_torch.core.device import on_device
from visionworkbench_torch.image.types import (  # noqa: F401 (re-export)
    MaskedImage, all_valid, create_mask,
)


def apply_mask(mi: MaskedImage, fill_value=0.0):
    """Collapse to a plain tensor with invalid pixels filled
    (ref ``apply_mask``, MaskViews.h)."""
    return mi.filled(fill_value)


def copy_mask(data, mask_source: MaskedImage) -> MaskedImage:
    """New image carrying another image's validity (ref ``copy_mask``); the
    data goes to the mask's device."""
    return MaskedImage(on_device(data, mask_source.valid.device), mask_source.valid)


def invert_mask(mi: MaskedImage) -> MaskedImage:
    return MaskedImage(mi.data, ~mi.valid)


def validate_all(mi: MaskedImage) -> MaskedImage:
    return MaskedImage(mi.data, torch.ones_like(mi.valid))


def invalidate_all(mi: MaskedImage) -> MaskedImage:
    return MaskedImage(mi.data, torch.zeros_like(mi.valid))


def intersect_masks(*mis: MaskedImage) -> torch.Tensor:
    valid = mis[0].valid
    for m in mis[1:]:
        valid = valid & m.valid
    return valid


def union_masks(*mis: MaskedImage) -> torch.Tensor:
    valid = mis[0].valid
    for m in mis[1:]:
        valid = valid | m.valid
    return valid


def edge_mask(image, edge_value=0.0, device=None) -> MaskedImage:
    """Invalidate the border region of constant ``edge_value`` pixels creeping
    in from each edge (ref ``edge_mask``, MaskViews.h): a pixel is valid
    when a pixel other than ``edge_value`` lies at or before it along its
    row from each side and along its column from each side (four running
    counts)."""
    image = on_device(image, device)
    spatial = image if image.ndim == 2 else image[..., 0]
    interior = spatial != edge_value

    def seen(dim, reverse):
        x = torch.flip(interior, (dim,)) if reverse else interior
        run = x.cumsum(dim) > 0
        return torch.flip(run, (dim,)) if reverse else run
    valid = seen(1, False) & seen(1, True) & seen(0, False) & seen(0, True)
    return MaskedImage(image, valid)


def masked_unary(fn: Callable, mi: MaskedImage) -> MaskedImage:
    """Unary op preserving validity (ref unary PixelMask math)."""
    return MaskedImage(fn(mi.data), mi.valid)


def masked_binary(fn: Callable, a: MaskedImage, b) -> MaskedImage:
    """Binary op; result valid where both inputs valid (ref binary PixelMask
    math lattice, PixelMask.h)."""
    if isinstance(b, MaskedImage):
        return MaskedImage(fn(a.data, b.data), a.valid & b.valid)
    return MaskedImage(fn(a.data, b), a.valid)
