"""A whole run of the harness on the CPU at a tiny size (the look for a
card skipped), with the timed path broken underneath: ``correct`` comes out
false for every fault the cells can have, and true with nothing broken."""

import copy
import sys
import time

import pytest
import torch

from portbench import harness

SIZES = {"asp-bm.job2048-epi": 160, "asp-mgm.tile1536-epi": 128}


def _run(name, trace=False):
    cell = copy.deepcopy(harness.load_cell(name))
    n = SIZES[name]
    cell["workload"]["traffic"].update(height=n, width=n + 32, pairs=2)
    cell["workload"].update(check_within=2, check_items=2, warmup_items=1, trace_items=1)
    return harness.run_cell(cell, 2 ** 32 + 9, 0.05, trace, time.perf_counter(),
                            device="cpu", log=lambda *a, **k: print(*a, file=sys.stderr))


def _bm_answer_altered(monkeypatch):
    """The sweep's answers altered where they are produced (dx + 1)."""
    from visionworkbench_torch.stereo import pyramid_correlation as pc
    real = pc.sweep

    def sweep(*a, **k):
        disp, valid, patches = real(*a, **k)
        return disp + torch.tensor([1, 0], dtype=disp.dtype), valid, patches
    monkeypatch.setattr(pc, "sweep", sweep)


def _bm_subpixel_skipped(monkeypatch):
    """The parabola step returns the integer map unchanged."""
    from visionworkbench_torch.stereo import pyramid_correlation as pc
    monkeypatch.setattr(pc, "parabola_subpixel", lambda dm, *a, **k: dm)


def _half_left_out(monkeypatch, name):
    """Half of each item's rows left out (the batch halved)."""
    real = harness.load_adapter

    def load_adapter(config):
        d = real(config)
        call = d.call

        def half(cfg, wl, pair):
            disp, valid = call(cfg, wl, pair)
            valid = valid.clone()
            valid[valid.shape[0] // 2:] = False
            return disp, valid
        d.call = half
        return d
    monkeypatch.setattr(harness, "load_adapter", load_adapter)


def _mgm_scan_skipped(monkeypatch):
    """The MGM edge-task scan returns its costs (its state) unchanged."""
    from visionworkbench_torch.stereo import sgm
    monkeypatch.setattr(sgm, "mgm_fwd", lambda cost_t, *a, **k: cost_t.clone())


def _lr_check_skipped(monkeypatch):
    """The L<->R check returns the L->R map unchanged."""
    from visionworkbench_torch.stereo import pyramid_correlation as pc
    monkeypatch.setattr(pc, "cross_corr_consistency_check", lambda dm, *a, **k: dm)


@pytest.mark.parametrize("name", sorted(SIZES))
def test_unbroken_run_is_correct(name):
    result = _run(name)
    assert result["correct"] is True
    assert result["checks"]["mismatch_share"]["value"] == 0.0
    assert set(result["metrics"]) == {"mp_s", "latency_p95_ms", "setup_s"}


@pytest.mark.parametrize("name,fault", [
    ("asp-bm.job2048-epi", "answer_altered"),
    ("asp-bm.job2048-epi", "subpixel_skipped"),
    ("asp-bm.job2048-epi", "half_left_out"),
    ("asp-mgm.tile1536-epi", "scan_skipped"),
    ("asp-mgm.tile1536-epi", "lr_check_skipped"),
    ("asp-mgm.tile1536-epi", "half_left_out"),
])
def test_broken_path_is_not_correct(monkeypatch, name, fault):
    if fault == "answer_altered":
        _bm_answer_altered(monkeypatch)
    elif fault == "subpixel_skipped":
        _bm_subpixel_skipped(monkeypatch)
    elif fault == "scan_skipped":
        _mgm_scan_skipped(monkeypatch)
    elif fault == "lr_check_skipped":
        _lr_check_skipped(monkeypatch)
    else:
        _half_left_out(monkeypatch, name)
    result = _run(name)
    assert result["correct"] is False
    check = result["checks"]["mismatch_share"]
    assert check["value"] > check["limit"]


def test_traced_run_reports_the_host_metric():
    result = _run("asp-bm.job2048-epi", trace=True)
    assert result["correct"] is True
    assert "host_ms_per_item" in result["metrics"]
    assert "mp_s" not in result["metrics"]


def test_idle_share_is_read_against_the_untraced_window():
    from portbench import trace as tracemod
    ops = [tracemod.Op("k", 0, 4_000_000), tracemod.Op("k", 10_000_000, 14_000_000)]
    tr = tracemod.Trace(ops, [], (0, 20_000_000), 2)
    reader = harness.load_reader("device_idle_pct")
    ctx = {"trace": tr, "tracemod": tracemod, "window_s": 1.0, "completed": 100}
    # 4 ms busy an item, 100 items in 1 s: the card busy 40 % of the window
    assert reader.read(ctx) == pytest.approx(60.0)
    assert reader.read({**ctx, "trace": None}) is None


def test_no_card_exits_without_a_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "asp-bm.job2048-epi", "--seed", "1",
                       "--seconds", "1", "--trace", "0"], time.perf_counter())
    assert rc != 0
    assert capsys.readouterr().out == ""
