"""A short run of each cell's harness on the card at a small size: the
kernels' path against the plain reference (runs where there is a card)."""

import copy
import sys
import time

import pytest
import torch

from portbench import harness


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["asp-bm.job2048-epi", "asp-mgm.tile1536-epi",
                                  "asp-bm.job2048-mapproj"])
def test_small_run_on_the_card_is_correct(card, name):
    cell = copy.deepcopy(harness.load_cell(name))
    cell["workload"]["traffic"].update(height=256, width=320, pairs=2)
    cell["workload"].update(check_within=4, check_items=2, trace_items=2)
    result = harness.run_cell(cell, 2 ** 31 + 77, 1.0, True, time.perf_counter(),
                              device=card, log=lambda *a, **k: print(*a, file=sys.stderr))
    assert result["correct"] is True
    assert result["device"]["busy_s"] > 0
