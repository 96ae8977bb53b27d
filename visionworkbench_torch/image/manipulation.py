"""Image manipulation (port of ``visionworkbench_tpu/image/manipulation.py``;
ref ``src/vw/Image/Manipulation.h:79-``).

crop / subsample / upsample / flips / rotations / transpose / channel and
plane selection as tensor views or copies. Coordinates: x = column, y = row.

:func:`subsample2` is a strided slice where the JAX package's
``subsample2_mxu`` selects the even rows and columns with two banded 0/1
matmuls (a TPU workaround for its slow strided slices): the two are equal
bit for bit on finite images; there a NaN or inf spreads along its row and
column, here it does not.
"""

from __future__ import annotations

import torch

from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.math.bbox import BBox2i


def crop(image, x0=None, y0=None, width=None, height=None, bbox: BBox2i = None):
    """Crop to (x0, y0, w, h) or a BBox2i (ref ``crop``, Manipulation.h:1009).

    The region must lie inside the image (use
    :func:`~visionworkbench_torch.image.edge.crop_extended` for out-of-bounds
    crops, as the reference requires an edge-extended view for that).
    """
    if bbox is not None:
        x0, y0 = int(bbox.min_x), int(bbox.min_y)
        width, height = int(bbox.width), int(bbox.height)
    return image[y0:y0 + height, x0:x0 + width]


def subsample(image, xfactor: int, yfactor: int = None):
    """Every Nth pixel starting at (0, 0) (ref ``subsample``, Manipulation.h:584)."""
    if yfactor is None:
        yfactor = xfactor
    return image[::yfactor, ::xfactor]


def subsample2(image):
    """``subsample(image, 2)`` of a 2D image as fp32: the octave decimation
    of the DoG ladder and of the EM refiner's pyramid."""
    return image[::2, ::2].to(torch.float32).contiguous()


def upsample(image, xfactor: int, yfactor: int = None):
    """Nearest upsample by integer factors (ref ``upsample``)."""
    if yfactor is None:
        yfactor = xfactor
    return image.repeat_interleave(yfactor, dim=0).repeat_interleave(xfactor, dim=1)


def flip_vertical(image):
    return torch.flip(image, dims=(0,))


def flip_horizontal(image):
    return torch.flip(image, dims=(1,))


def rotate_180(image):
    return torch.flip(image, dims=(0, 1))


def rotate_90_cw(image):
    # (x, y) -> (rows-1-y, x): new[y', x'] = old[H-1-x', y']
    return torch.flip(image.transpose(0, 1), dims=(1,))


def rotate_90_ccw(image):
    return torch.flip(image.transpose(0, 1), dims=(0,))


def transpose(image):
    return image.transpose(0, 1)


def select_channel(image, channel: int):
    if image.ndim == 2:
        if channel != 0:
            raise ArgumentErr("select_channel: single-channel image")
        return image
    return image[..., channel]


def select_plane(image, plane: int):
    """Planes in the reference are a third index; here synonymous with channels."""
    return select_channel(image, plane)


def channels_to_planes(image):
    """(H, W, C) -> (C, H, W) (ref ``channels_to_planes``)."""
    return torch.movedim(image, -1, 0)


def planes_to_channels(image):
    return torch.movedim(image, 0, -1)
