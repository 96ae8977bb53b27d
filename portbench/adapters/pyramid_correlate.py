"""Adapter of the configurations whose item is one stereo job: one call of
``visionworkbench_torch.stereo.pyramid_correlation.pyramid_correlate`` on
one pair, its ``disparity`` and ``valid`` the outputs.

A configuration file gives ``settings``, the call's keyword arguments; a
workload file gives the pairs' ``traffic`` and the ``search`` box
(x, y, w, h). The comparison that decides ``correct`` is
:func:`compare`: the share of pixels whose validity differs from the plain
reference's, or whose disparity lies more than ``tolerance_px`` from it in
either channel.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench import scenes
from portbench.reference import pyramid as reference_pyramid


def prepare(config: dict, workload: dict, seed: int, device) -> List[scenes.Pair]:
    """The run's distinct pairs, made on the device from the seed."""
    return scenes.make_pairs(workload["traffic"], seed, device)


def item_pixels(config: dict, workload: dict) -> int:
    """Input pixels of one item: its left frame's H * W."""
    return int(workload["traffic"]["height"]) * int(workload["traffic"]["width"])


def call(config: dict, workload: dict, pair: scenes.Pair) -> Tuple[torch.Tensor, ...]:
    """The timed call: one job through the program."""
    from visionworkbench_torch.math.bbox import BBox2i
    from visionworkbench_torch.stereo.pyramid_correlation import pyramid_correlate
    dm = pyramid_correlate(pair.left, pair.right, BBox2i(*workload["search"]),
                           device=pair.left.device, **config["settings"])
    return dm.disparity, dm.valid


def reference(config: dict, workload: dict, pair: scenes.Pair,
              dtype=torch.float32) -> Tuple[torch.Tensor, ...]:
    """The plain reference's outputs for the same pair."""
    return reference_pyramid.correlate(pair.left, pair.right, workload["search"],
                                       config["settings"], dtype)


def compare(config: dict, workload: dict, outs, ref_outs) -> Dict[str, float]:
    """``mismatch_share``: pixels whose validity differs, or that are valid
    on both sides with a disparity more than ``tolerance_px`` apart, over
    all pixels. ``max_gap_px`` (information only): the widest gap of a
    pixel valid on both sides."""
    tol = float(workload["check"]["tolerance_px"])
    disp, valid = outs[0].to(torch.float32), outs[1].bool()
    rdisp, rvalid = ref_outs[0].to(torch.float32), ref_outs[1].bool()
    both = valid & rvalid
    gap = (disp - rdisp).abs().amax(-1)
    bad = (valid != rvalid) | (both & (gap > tol))
    return {"mismatch_share": float(bad.to(torch.float64).mean()),
            "max_gap_px": float(gap[both].amax()) if bool(both.any()) else 0.0}


def quality(config: dict, workload: dict, pair: scenes.Pair, outs) -> Dict[str, float]:
    """Information only: the share of pixels valid, and of pixels valid
    and within 1 px of the scene's true disparity in both channels."""
    disp, valid = outs[0].to(torch.float32), outs[1].bool()
    near = (disp - pair.truth).abs().amax(-1) <= 1.0
    return {"valid_share": float(valid.to(torch.float64).mean()),
            "within_1px_share": float((valid & near).to(torch.float64).mean())}
