"""The plain reference against the program's CPU path on tiny pairs, and
the control (the reference in bfloat16) caught by the cells' limits."""

import copy

import pytest
import torch

from portbench import harness, scenes

CELLS = {"asp-bm.job2048-epi": 160, "asp-mgm.tile1536-epi": 128,
         "asp-bm.job2048-mapproj": 160}


def _cell(name):
    cell = copy.deepcopy(harness.load_cell(name))
    n = CELLS[name]
    cell["workload"]["traffic"].update(height=n, width=n + 32, pairs=1)
    return cell


@pytest.fixture(scope="module", params=sorted(CELLS))
def outputs(request):
    cell = _cell(request.param)
    cfg, wl = cell["config"], cell["workload"]
    adapter = harness.load_adapter(cfg)
    pair = scenes.make_pair(wl["traffic"], 2 ** 31 + 3, 0, "cpu")
    return (cell, adapter, pair, adapter.call(cfg, wl, pair),
            adapter.reference(cfg, wl, pair),
            adapter.reference(cfg, wl, pair, dtype=torch.bfloat16))


def test_reference_agrees_with_the_programs_cpu_path(outputs):
    cell, adapter, pair, prog, ref, _ = outputs
    got = adapter.compare(cell["config"], cell["workload"], prog, ref)
    assert got["mismatch_share"] == 0.0
    assert got["max_gap_px"] == 0.0
    assert float(ref[1].float().mean()) > 0.3     # the pair correlates


def test_control_fails_the_limit(outputs):
    cell, adapter, pair, _, ref, low = outputs
    got = adapter.compare(cell["config"], cell["workload"], low, ref)
    assert got["mismatch_share"] > cell["workload"]["check"]["limits"]["mismatch_share"]


def test_compare_counts_validity_and_gaps():
    cell = _cell("asp-bm.job2048-epi")
    adapter = harness.load_adapter(cell["config"])
    disp = torch.zeros((4, 5, 2))
    valid = torch.ones((4, 5), dtype=torch.bool)
    other = disp.clone()
    other[0, 0, 1] = 0.02           # past the 0.01 px tolerance
    other[1, 1, 0] = 0.005          # within it
    ov = valid.clone()
    ov[2, 2] = False
    got = adapter.compare(cell["config"], cell["workload"], (disp, valid), (other, ov))
    assert got["mismatch_share"] == pytest.approx(2 / 20)
    assert got["max_gap_px"] == pytest.approx(0.02)
