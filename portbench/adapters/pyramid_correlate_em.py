"""Adapter of the configurations whose item is one stereo job refined by
the affine / Bayes-EM subpixel refiner: one call of
``visionworkbench_torch.stereo.pyramid_correlation.pyramid_correlate`` with
``subpixel`` ``em`` or ``affine`` and the configuration's
``subpixel_kernel``, its ``disparity`` and ``valid`` the outputs.

The pairs, the timed call, the item's pixels, the comparison that decides
``correct`` and the quality readings are the block-matching adapter's
(``pyramid_correlate.py``). Only the reference differs: the frozen integer
correlator (``portbench/reference/pyramid.py``) with subpixel ``none``, then
the frozen refiner (``portbench/reference/bayes_em.py``) on its map.
"""

from __future__ import annotations

from typing import Tuple

import torch

from portbench import scenes
from portbench.adapters.pyramid_correlate import (  # noqa: F401  (the adapter's functions)
    call, compare, item_pixels, prepare, quality,
)
from portbench.reference import bayes_em
from portbench.reference import pyramid as reference_pyramid


def reference(config: dict, workload: dict, pair: scenes.Pair,
              dtype=torch.float32) -> Tuple[torch.Tensor, ...]:
    """The plain reference's outputs for the same pair, both stages in
    ``dtype``."""
    settings = dict(config["settings"])
    kernel = settings.pop("subpixel_kernel", None) or settings.get("kernel_size", (21, 21))
    subpixel = settings["subpixel"]
    settings["subpixel"] = "none"
    disp, valid = reference_pyramid.correlate(pair.left, pair.right, workload["search"],
                                              settings, dtype)
    return bayes_em.refine(disp, valid, pair.left, pair.right, kernel, subpixel,
                           settings.get("prefilter_mode", "none"),
                           float(settings.get("prefilter_width", 1.4)), dtype)
