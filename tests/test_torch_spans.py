"""The port's step spans (``visionworkbench_torch/core/profiling.span``) on
the CPU: the shared no-op when nothing records, the nesting of a
recording, the span tree ``pyramid_correlate`` records in BM, MGM and
Bayes-EM mode (outputs bit-identical with recording on and off), the spans
a profiler keeps, and the span in the Chrome trace of
``profiling.trace``."""

import json
import os
import tracemalloc

import numpy as np
import pytest
import torch

from torch_parity import _torch_threads, quantized  # noqa: F401
from visionworkbench_torch.core import profiling
from visionworkbench_torch.math.bbox import BBox2i
from visionworkbench_torch.stereo.pyramid_correlation import pyramid_correlate

SEARCH = BBox2i(0, -1, 16, 3)
SETTINGS = {
    # ASP's block matching at a small size: NCC, LoG, parabola, L<->R
    "bm": dict(cost_type="ncc", prefilter_mode="log", kernel_size=(7, 7),
               consistency_threshold=2, subpixel="parabola", tile_size=16),
    "bm_no_lr": dict(cost_type="ncc", prefilter_mode="log", kernel_size=(7, 7),
                     subpixel="parabola", tile_size=16),
    "mgm": dict(stereo_algorithm="mgm", cost_type="ternary_census", census_window=5,
                consistency_threshold=2, subpixel="parabola", tile_size=16),
    # ASP's subpixel-mode 2: the Bayes-EM refiner over its own window
    "em": dict(cost_type="ncc", prefilter_mode="log", kernel_size=(7, 7),
               consistency_threshold=2, subpixel="em", subpixel_kernel=(9, 9),
               tile_size=16),
}
# the refiner's steps inside ``subpixel``: the prefiltered frames, then its
# one full-resolution level's derivatives, weights, warp, 3 outer iterations
EM_STEPS = ["em.inputs", "em.inputs", "em.weights", "em.warp"] + ["em.iter"] * 3 + ["em.finish"]


def _pair(seed=0, h=96, w=128):
    wide = quantized(np.random.default_rng(seed), (h, w + 24))
    return wide[:, 8:8 + w].copy(), wide


def _tree(spans):
    """Each span as (depth, name), in the order they opened."""
    depth = []
    for _, parent, _, _, _ in spans:
        depth.append(0 if parent < 0 else depth[parent] + 1)
    return [(d, s[2]) for d, s in zip(depth, spans)]


def _levels(tree):
    return max(int(n[1:]) for _, n in tree if n[0] == "L" and "." not in n)


def _expected(mode, levels):
    sgm = ("sgm.census", "sgm.volume", "sgm.scans", "sgm.wta")
    tree = [(0, "pyramid_correlate"), (1, "crop"), (1, "pyramid"), (1, "prefilter")]
    for n in range(levels, -1, -1):
        tree += [(1, f"L{n}"), (2, f"L{n}.offsets")]
        if mode == "mgm":
            tree += [(2, f"L{n}.sgm")] + [(3, s) for s in sgm]
        else:
            tree.append((2, f"L{n}.sweep"))
        if n == 0 and mode != "bm_no_lr":
            tree.append((2, "L0.rl"))
            tree += [(3, s) for s in sgm] if mode == "mgm" else []
            tree.append((2, "L0.lr_check"))
        tree.append((2, f"L{n}.speckle"))
    return tree + [(1, "subpixel")] + ([(2, e) for e in EM_STEPS] if mode == "em" else [])


def test_span_is_the_shared_noop_when_nothing_records():
    assert not torch.autograd._profiler_enabled()
    first = profiling.span("pyramid_correlate")
    assert first is profiling.span("L0.sweep")
    with first:
        pass
    tracemalloc.start()
    try:
        for _ in range(1000):
            with profiling.span("L0.sweep"):
                pass
        snap = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    mine = snap.filter_traces([tracemalloc.Filter(True, profiling.__file__)])
    assert mine.statistics("lineno") == []


def test_recording_nests_spans_by_parent_and_item():
    with profiling.recording() as spans:
        for _ in range(2):
            with profiling.span("a"):
                with profiling.span("b"):
                    with profiling.span("c"):
                        pass
                with profiling.span("d"):
                    pass
        with pytest.raises(ValueError):
            with profiling.span("e"):
                raise ValueError
    with profiling.span("after"):
        pass
    assert [(s[0], s[1], s[2]) for s in spans] == [
        (0, -1, "a"), (0, 0, "b"), (0, 1, "c"), (0, 0, "d"),
        (1, -1, "a"), (1, 4, "b"), (1, 5, "c"), (1, 4, "d"), (2, -1, "e")]
    for item, parent, _, t0, t1 in spans:
        assert t0 <= t1
        if parent >= 0:
            assert spans[parent][3] <= t0 and t1 <= spans[parent][4]


@pytest.mark.parametrize("mode", sorted(SETTINGS))
def test_pyramid_correlate_records_its_steps(mode):
    """Each level once, ``L0.rl`` only with L<->R, the SGM steps inside
    every SGM search; the outputs bit-identical with recording on and
    off."""
    left, right = _pair()
    off = pyramid_correlate(left, right, SEARCH, device="cpu", **SETTINGS[mode])
    with profiling.recording() as spans:
        on = pyramid_correlate(left, right, SEARCH, device="cpu", **SETTINGS[mode])
    tree = _tree(spans)
    assert _levels(tree) >= 2
    assert tree == _expected(mode, _levels(tree))
    assert {s[0] for s in spans} == {0}
    assert torch.equal(off.disparity, on.disparity) and torch.equal(off.valid, on.valid)


def test_profiled_spans_hold_the_calls_made_under_a_profiler():
    from torch.profiler import ProfilerActivity, profile
    left, right = _pair(1)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            pyramid_correlate(left, right, SEARCH, device="cpu", **SETTINGS["bm"])
    spans = profiling.profiled_spans()
    roots = [s for s in spans if s[1] < 0]
    assert [(s[0], s[2]) for s in roots] == [(0, "pyramid_correlate"), (1, "pyramid_correlate")]
    tree, half = _tree(spans), len(spans) // 2
    assert tree[:half] == tree[half:] == _expected("bm", _levels(tree))
    # a span opened without a profiler keeps nothing and drops nothing, but
    # ends the stretch: the next span under a profiler starts a new one
    with profiling.span("y"):
        pass
    assert profiling.profiled_spans() == spans
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("x"):
            pass
    assert [s[2] for s in profiling.profiled_spans()] == ["x"]


def test_trace_writes_the_pyramid_correlate_span(tmp_path):
    left, right = _pair(2)
    logdir = tmp_path / "trace"
    with profiling.trace(str(logdir)):
        pyramid_correlate(left, right, SEARCH, device="cpu", **SETTINGS["bm"])
    (name,) = os.listdir(logdir)
    events = json.loads((logdir / name).read_text())["traceEvents"]
    names = {e.get("name") for e in events if e.get("cat") == "user_annotation"}
    assert {"pyramid_correlate", "crop", "L0.sweep", "L0.rl", "subpixel"} <= names
