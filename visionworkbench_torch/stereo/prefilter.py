"""Stereo prefilters (port of ``visionworkbench_tpu/stereo/prefilter.py``;
ref ``src/vw/Stereo/PreFilter.h:41-100``, ``PrefilterEnum.h:24-28``):
per-level image conditioning before correlation.

* ``none``    — identity (``NullOperation``)
* ``meansub`` — image minus its Gaussian blur (``SubtractedMean``)
* ``log``     — 3x3 Laplacian of a Gaussian blur (``LaplacianOfGaussian``)

Both filters are the shifted-slice stencils of ``image/convolution.py``
in the JAX package's order: the result equals the JAX package's bit for
bit, on the CPU and on the card.
"""

from __future__ import annotations

from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.image.filters import gaussian_filter, laplacian_filter

PREFILTER_NONE = "none"
PREFILTER_MEANSUB = "meansub"
PREFILTER_LOG = "log"
PREFILTER_MODES = (PREFILTER_NONE, PREFILTER_MEANSUB, PREFILTER_LOG)


def check_prefilter_mode(mode: str) -> None:
    """Raise on an unknown prefilter mode."""
    if mode not in PREFILTER_MODES:
        raise ArgumentErr(f"Unknown prefilter mode {mode!r}; one of {PREFILTER_MODES}")


def prefilter_image(image, mode: str = PREFILTER_NONE, width: float = 1.4):
    """Apply the selected prefilter (ref ``prefilter_image``, PreFilter.h:78-100)
    to an (H, W) tensor."""
    check_prefilter_mode(mode)
    if mode == PREFILTER_LOG:
        return laplacian_filter(gaussian_filter(image, width))
    if mode == PREFILTER_MEANSUB:
        return image - gaussian_filter(image, width)
    return image
