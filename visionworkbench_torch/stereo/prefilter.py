"""Stereo prefilters (port of ``visionworkbench_tpu/stereo/prefilter.py``;
ref ``src/vw/Stereo/PreFilter.h:41-100``). Only ``none`` is ported; the
LoG and mean-subtract modes wait for the prefilter slice."""

from __future__ import annotations

from visionworkbench_torch.core.exceptions import ArgumentErr

PREFILTER_NONE = "none"
PREFILTER_MEANSUB = "meansub"
PREFILTER_LOG = "log"
PREFILTER_MODES = (PREFILTER_NONE, PREFILTER_MEANSUB, PREFILTER_LOG)


def check_prefilter_mode(mode: str) -> None:
    """Raise unless ``mode`` is a prefilter this slice runs."""
    if mode == PREFILTER_NONE:
        return
    if mode in PREFILTER_MODES:
        raise ArgumentErr(f"prefilter mode {mode!r} is not ported yet (it "
                          "comes with the prefilter slice of the port)")
    raise ArgumentErr(f"Unknown prefilter mode {mode!r}; one of {PREFILTER_MODES}")


def prefilter_image(image, mode: str = PREFILTER_NONE, width: float = 1.4):
    """Apply the selected prefilter (ref ``prefilter_image``, PreFilter.h:78-100)."""
    check_prefilter_mode(mode)
    return image
