"""Interest point containers (port of ``visionworkbench_tpu/interest/types.py``;
ref ``src/vw/InterestPoint/InterestPoint.h``).

The reference holds ragged ``InterestPointList``s; here, as in the JAX
package, points live in fixed-capacity struct-of-arrays tensors with a
validity mask (ragged outputs become top-k buffers + valid counts). The
host conversions give plain NumPy record views for IO and matching
bookkeeping.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from visionworkbench_torch.core.device import as_tensor, resolve_device
from visionworkbench_torch.core.exceptions import ArgumentErr


class InterestPoints(NamedTuple):
    """Fixed-capacity interest point set; invalid slots have valid=False."""
    x: torch.Tensor            # (K,) float32 — column
    y: torch.Tensor            # (K,) float32 — row
    scale: torch.Tensor        # (K,) float32
    orientation: torch.Tensor  # (K,) float32 radians
    interest: torch.Tensor     # (K,) float32 response
    valid: torch.Tensor        # (K,) bool
    descriptor: Optional[torch.Tensor] = None  # (K, D) float32 or None

    @property
    def capacity(self) -> int:
        return int(self.x.shape[0])

    def count(self) -> int:
        return int(self.valid.sum())

    def to_numpy(self):
        """Compact to host arrays (valid points only, interest-sorted,
        stable among equal responses); one read-back per field group."""
        fields = torch.stack([self.x, self.y, self.scale, self.orientation,
                              self.interest]).cpu().numpy()
        valid = self.valid.cpu().numpy()
        idx = np.nonzero(valid)[0]
        order = np.argsort(-fields[4][idx], kind="stable")
        idx = idx[order]
        out = {k: fields[i][idx] for i, k in enumerate(
            ("x", "y", "scale", "orientation", "interest"))}
        if self.descriptor is not None:
            out["descriptor"] = self.descriptor.cpu().numpy()[idx]
        return out


def from_numpy(d, device=None) -> InterestPoints:
    """Host records (``to_numpy``'s or ``read_binary_ip_file``'s dict) as an
    all-valid point set on ``device`` (``None`` = the card)."""
    dev = resolve_device(device)
    n = len(d["x"])

    def f32(v):
        return as_tensor(v, torch.float32, dev)
    return InterestPoints(
        x=f32(d["x"]), y=f32(d["y"]),
        scale=f32(d.get("scale", np.ones(n))),
        orientation=f32(d.get("orientation", np.zeros(n))),
        interest=f32(d.get("interest", np.zeros(n))),
        valid=torch.ones((n,), dtype=torch.bool, device=dev),
        descriptor=f32(d["descriptor"]) if "descriptor" in d else None,
    )


def scale_to_plane_index(base: int, scales: int, scale: float) -> int:
    """Plane index in an octave most closely matching ``scale``
    (ref ``ImageOctave::scale_to_plane_index``, ImageOctave.h:87-94)."""
    return int(scales * (math.log(scale) - math.log(float(base)))
               / math.log(2.0) + 0.00001)


class ImageOctaveHistory(list):
    """Container for the intermediate scale-space images produced while
    iterating octaves — kept for descriptor generation after detection
    (ref ``ImageOctaveHistory``, ImageOctaveHistory.h:40-76). A list of
    octaves, each a list of per-plane images (scales + 2 planes: one
    below, one above)."""

    def __init__(self):
        super().__init__()
        self._num_scales = 0

    def octaves(self) -> int:
        return len(self)

    def scales(self) -> int:
        """Scales per octave (two less than the plane count)."""
        return self._num_scales

    def add_octave(self, octave) -> None:
        self.append(list(octave))
        self._num_scales = len(octave) - 2

    def image_at_scale(self, scale: float):
        """Image most closely matching ``scale``
        (ref ``image_at_scale``, ImageOctaveHistory.h:64-75)."""
        octave = int(math.log(scale) / math.log(2.0))
        if octave == self.octaves():
            octave = self.octaves() - 1
        if not 0 <= octave < self.octaves():
            raise ArgumentErr(
                "ImageOctaveHistory.image_at_scale: no image matching scale")
        plane = scale_to_plane_index(1 << octave, self._num_scales, scale)
        if not 0 <= plane < self.scales() + 2:
            raise ArgumentErr(
                "ImageOctaveHistory.image_at_scale: no image matching scale")
        return self[octave][plane]
