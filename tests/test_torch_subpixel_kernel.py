"""``pyramid_correlate``'s ``subpixel_kernel`` (ASP's ``subpixel-kernel``,
the affine / Bayes-EM refiner's own window) on the CPU: left out, every
mode gives what it gave before, bit for bit; a 35x35 window gives what the
refiner gives on the same integer map; bad sizes raise. The refiner's
counters, and its weight template copied to the device once (on the CPU,
and on the card)."""

import numpy as np
import pytest
import torch

from torch_parity import _torch_threads, quantized  # noqa: F401
from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.math.bbox import BBox2i
from visionworkbench_torch.stereo import subpixel_refine as sr
from visionworkbench_torch.stereo.pyramid_correlation import pyramid_correlate

SEARCH = BBox2i(0, -1, 16, 3)
# ASP's block matching at a small size: NCC, LoG, L<->R
BM = dict(cost_type="ncc", prefilter_mode="log", kernel_size=(7, 7),
          consistency_threshold=2, tile_size=16)


@pytest.fixture(scope="module")
def pair():
    wide = quantized(np.random.default_rng(5), (48, 64 + 24))
    return wide[:, 8:8 + 64].copy(), wide


def _run(pair, **kw):
    return pyramid_correlate(pair[0], pair[1], SEARCH, device="cpu", **BM, **kw)


def _refine(pair, base, kernel, subpixel):
    """What ``pyramid_correlate`` runs on its integer map: full resolution,
    3 outer iterations, 2 EM passes (``em``) or none (``affine``)."""
    return sr.bayes_em_subpixel(base, pair[0], pair[1], kernel,
                                em_iters=2 if subpixel == "em" else 0,
                                prefilter_mode="log", prefilter_width=1.4,
                                max_pyramid_levels=0, outer_iters=3)


def _equal(a, b):
    return torch.equal(a.disparity, b.disparity) and torch.equal(a.valid, b.valid)


@pytest.fixture(scope="module")
def base(pair):
    return _run(pair, subpixel="none")


@pytest.mark.parametrize("subpixel", ["em", "affine"])
def test_left_out_the_refiner_takes_the_correlation_kernel(pair, base, subpixel):
    left_out = _run(pair, subpixel=subpixel)
    assert _equal(left_out, _refine(pair, base, (7, 7), subpixel))
    assert _equal(left_out, _run(pair, subpixel=subpixel, subpixel_kernel=(7, 7)))
    assert left_out.valid.float().mean() > 0.5


@pytest.mark.parametrize("subpixel", ["none", "parabola"])
def test_other_modes_ignore_the_subpixel_kernel(pair, subpixel):
    assert _equal(_run(pair, subpixel=subpixel),
                  _run(pair, subpixel=subpixel, subpixel_kernel=(35, 35)))


def test_35x35_em_equals_the_refiner_on_the_integer_map(pair, base):
    got = _run(pair, subpixel="em", subpixel_kernel=(35, 35))
    assert _equal(got, _refine(pair, base, (35, 35), "em"))
    # the window is the refiner's own: not the 7x7 refinement
    assert not torch.equal(got.disparity, _run(pair, subpixel="em").disparity)


@pytest.mark.parametrize("bad", [(34, 35), (35, 0), (-3, 3), (35,), (35, 35, 35),
                                 (35.5, 35), "35", 35])
def test_bad_subpixel_kernel_raises(pair, bad):
    with pytest.raises(ArgumentErr):
        _run(pair, subpixel="em", subpixel_kernel=bad)


def test_counters_count_refiner_calls_and_outer_iterations(monkeypatch, pair, base):
    monkeypatch.setattr(sr, "em_calls", 0)
    monkeypatch.setattr(sr, "em_outer_iterations", 0)
    _run(pair, subpixel="parabola", subpixel_kernel=(9, 9))
    assert (sr.em_calls, sr.em_outer_iterations) == (0, 0)
    _run(pair, subpixel="em", subpixel_kernel=(9, 9))
    assert (sr.em_calls, sr.em_outer_iterations) == (1, 3)
    sr.affine_subpixel(base, pair[0], pair[1], (5, 5), iterations=2)
    assert (sr.em_calls, sr.em_outer_iterations) == (2, 5)


def _template_is_copied_once(device):
    for kw, kh in ((35, 35), (21, 21), (7, 5)):
        on = sr._weight_template_on(kw, kh, device)
        assert sr._weight_template_on(kw, kh, device) is on
        assert on.device == device
        assert torch.equal(on.cpu(), torch.from_numpy(sr._weight_template(kw, kh)))


def test_weight_template_is_copied_once_a_device():
    _template_is_copied_once(torch.device("cpu"))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_weight_template_on_the_card_equals_the_host_copy(card):
    _template_is_copied_once(card)
