"""The Bayes-EM cell (``asp-bm-em.job1024-epi``) on the CPU at small sizes:
the program against the frozen reference (``portbench/reference/
bayes_em.py`` after the integer reference), the bfloat16 control caught by
the cell's limit, a whole run of the harness correct with nothing broken
and not correct with the refiner broken underneath, the refiner's roofline
counts worked by hand, and its readers.

Tolerances: the program and the reference run the same operations in the
same order on one device, so ``mismatch_share`` and ``max_gap_px`` read
0.0 exactly; the control (every float in bfloat16) and each fault read
over the cell's limit of 0.01."""

import ast
import copy
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench import harness, roofline, roofline_em, scenes, spans
from portbench.spans import Row, Steps
from portbench.trace import Op, Trace

CELL = "asp-bm-em.job1024-epi"
BENCH = Path(__file__).resolve().parents[1]


def _cell(h, w, pairs=1):
    cell = copy.deepcopy(harness.load_cell(CELL))
    cell["workload"]["traffic"].update(height=h, width=w, pairs=pairs)
    return cell


@pytest.fixture(scope="module")
def outputs():
    cell = _cell(160, 192)
    cfg, wl = cell["config"], cell["workload"]
    adapter = harness.load_adapter(cfg)
    pair = scenes.make_pair(wl["traffic"], 2 ** 31 + 11, 0, "cpu")
    return (cell, adapter, adapter.call(cfg, wl, pair), adapter.reference(cfg, wl, pair),
            adapter.reference(cfg, wl, pair, dtype=torch.bfloat16))


def test_the_cell_refines_with_bayes_em_at_35x35():
    cell = harness.load_cell(CELL)
    s = cell["config"]["settings"]
    assert (s["subpixel"], s["subpixel_kernel"]) == ("em", [35, 35])
    assert cell["config"]["asp"]["subpixel-mode"] == 2
    assert {"em_device_ms", "em_roofline_pct"} <= {m["name"] for m in cell["per_layer"]}


def test_reference_agrees_with_the_programs_cpu_path(outputs):
    cell, adapter, prog, ref, _ = outputs
    got = adapter.compare(cell["config"], cell["workload"], prog, ref)
    assert got == {"mismatch_share": 0.0, "max_gap_px": 0.0}
    assert float(ref[1].float().mean()) > 0.3     # the pair correlates


def test_control_fails_the_limit(outputs):
    cell, adapter, _, ref, low = outputs
    got = adapter.compare(cell["config"], cell["workload"], low, ref)
    assert got["mismatch_share"] > cell["workload"]["check"]["limits"]["mismatch_share"]


def _run(trace=False):
    cell = _cell(128, 160, pairs=2)
    cell["workload"].update(check_within=2, check_items=2, warmup_items=1, trace_items=1)
    return harness.run_cell(cell, 2 ** 32 + 9, 0.05, trace, time.perf_counter(),
                            device="cpu", log=lambda *a, **k: print(*a, file=sys.stderr))


def test_unbroken_run_is_correct():
    result = _run()
    assert result["correct"] is True
    assert result["checks"]["mismatch_share"]["value"] == 0.0
    assert set(result["metrics"]) == {"mp_s", "latency_p95_ms", "setup_s"}


def _refiner(monkeypatch, **change):
    """The program's refiner called with ``change`` in its arguments, or
    skipped (the integer map returned) when ``change`` is empty."""
    from visionworkbench_torch.stereo import pyramid_correlation as pc
    real = pc.bayes_em_subpixel

    def refine(dm, *a, **k):
        if not change:
            return dm
        k.update({key: f(k[key]) for key, f in change.items()})
        return real(dm, *a, **k)
    monkeypatch.setattr(pc, "bayes_em_subpixel", refine)


def _half_left_out(monkeypatch):
    """Half of each item's rows left out."""
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


@pytest.mark.parametrize("fault", ["refiner_skipped", "one_outer_iteration_fewer",
                                   "em_weighting_off", "half_left_out"])
def test_broken_refiner_is_not_correct(monkeypatch, fault):
    if fault == "refiner_skipped":
        _refiner(monkeypatch)
    elif fault == "one_outer_iteration_fewer":
        _refiner(monkeypatch, outer_iters=lambda n: n - 1)
    elif fault == "em_weighting_off":
        _refiner(monkeypatch, em_iters=lambda n: 0)
    else:
        _half_left_out(monkeypatch)
    result = _run()
    assert result["correct"] is False
    check = result["checks"]["mismatch_share"]
    assert check["value"] > check["limit"]


def test_em_work_at_one_shape_by_hand():
    settings = {"subpixel": "em", "subpixel_kernel": [3, 5], "kernel_size": [21, 21]}
    nbytes, ops = roofline_em.em_work(settings, 4, 8)
    # 32 px; 3 outer iterations x 2 EM passes; 15 taps of 13 + 31 + 26 ops,
    # 5 rows of 28, the solve's 169; once 120 input ops and 15 taps x 3
    per_pass = 15 * (13 + 31 + 26) + 5 * 28 + 169
    assert per_pass == 1359
    assert ops == 32 * (6 * 1359 + 120 + 45)
    assert nbytes == 32 * (8 + 9 + 3 * 9)
    # the plain affine fit: one unweighted pass an outer iteration
    _, affine = roofline_em.em_work({**settings, "subpixel": "affine"}, 4, 8)
    assert affine == 32 * (3 * (15 * 44 + 5 * 28 + 169) + 120 + 45)
    # no subpixel_kernel: the correlation kernel's window
    _, ops21 = roofline_em.em_work({"subpixel": "em", "kernel_size": [21, 21]}, 1, 1)
    assert ops21 == 6 * (441 * 70 + 21 * 28 + 169) + 120 + 441 * 3
    assert roofline_em.em_work({"subpixel": "parabola"}, 4, 8) == (0.0, 0.0)


def test_the_cell_counts_positive_work_bound_by_operations():
    cell = harness.load_cell(CELL)
    nbytes, ops = roofline_em.em_work(cell["config"]["settings"], 1024, 1024)
    assert ops / roofline.PEAK_OPS_PER_S > nbytes / roofline.PEAK_BYTES_PER_S > 0


def _steps(rows, items=2):
    return Steps(items, {k: Row(*v) for k, v in rows.items()}, 0, 0, 0.0, 0.0, 0, 0, 1.0,
                 [], [])


def test_em_readers_sum_the_em_steps():
    row = lambda ns: (2, 1, 0, 0, 1, ns, 0)  # noqa: E731
    steps = _steps({"pyramid_correlate": row(10_000_000), "subpixel": row(7_000_000),
                    "subpixel/em.inputs": row(1_000_000), "subpixel/em.iter": row(5_000_000),
                    "subpixel/em.finish": row(500_000), "L0.sweep": row(2_000_000)})
    cell = harness.load_cell(CELL)
    ctx = {"spans": steps, "trace": None, "cell": cell}
    assert harness.load_reader("em_device_ms").read(ctx) == pytest.approx(3.25)
    nbytes, ops = roofline_em.em_work(cell["config"]["settings"], 1024, 1024)
    share = harness.load_reader("em_roofline_pct").read(ctx)
    assert share == pytest.approx(100 * roofline.least_seconds(nbytes, ops) / 3.25e-3)
    # a program that names no em step: nothing read, nothing raised
    bare = {"spans": _steps({"pyramid_correlate": row(10), "subpixel": row(7)}),
            "trace": None, "cell": cell}
    for name in ("em_device_ms", "em_roofline_pct"):
        assert harness.load_reader(name).read(bare) is None
        assert harness.load_reader(name).read({"spans": None, "trace": None,
                                                "cell": cell}) is None


# Two items on a hand-built trace (perf_counter_ns; the profiler's clock is
# OFF later): a crop, then a subpixel span with em.inputs and em.iter.
OFF = 1_000_000
EM_SPANS = [
    (0, -1, "pyramid_correlate", 1000, 5000), (0, 0, "crop", 1100, 1500),
    (0, 0, "subpixel", 1600, 4900), (0, 2, "em.inputs", 1700, 2500),
    (0, 2, "em.iter", 2600, 4800),
    (1, -1, "pyramid_correlate", 6000, 9000), (1, 5, "crop", 6100, 6500),
    (1, 5, "subpixel", 6600, 8900), (1, 7, "em.iter", 6700, 8800),
]
# (launch time, device op, its ns): the marker, item 0, its output copy,
# item 1, its output copy
EM_OPS = [(500, "k_marker", 5), (1200, "k_crop", 10), (1300, "k_crop", 20),
          (1800, "k_log", 100), (2700, "k_em", 1000), (2800, "k_em", 2000),
          (5100, "Memcpy DtoH (Device -> Pinned)", 7), (6200, "k_crop", 30),
          (6800, "k_em", 3000), (6900, "k_em", 4000),
          (9100, "Memcpy DtoH (Device -> Pinned)", 7)]


def _em_trace(lost=()):
    """The trace of EM_OPS, the device records at the indices ``lost``
    left out (as CUPTI leaves out records when its buffers fill)."""
    host, dev, t = [], [], OFF + 510
    for k, (at, name, ns) in enumerate(EM_OPS):
        copy_ = name.startswith("Memcpy")
        host.append(Op("cudaMemcpyAsync" if copy_ else "cudaLaunchKernel", OFF + at, OFF + at + 5))
        if k not in lost:
            dev.append(Op(name, t, t + ns))
        t += ns + 50
    return Trace(dev[1:], host, (dev[0].start_ns, t), 2)


@pytest.mark.parametrize("lost, ns", [
    ((), 100 + 1000 + 2000 + 3000 + 4000),   # every record: the steps' own rows
    ((9, 10), 100 + 1000 + 2000 + 3000),     # the trace's last kernel and copy lost
    ((2,), 1000 + 2000 + 3000 + 4000),       # a crop kernel of item 0 lost
])
def test_em_device_time_survives_lost_records(lost, ns):
    """Records lost at the trace's end leave every other operation with its
    launch; one lost inside moves the operations of its kind after it onto
    earlier launches only up to the next operation of another kind (here
    item 0's output copy), so item 1 reads its own time."""
    tr = _em_trace(lost)
    steps = spans.attribute(tr, EM_SPANS, OFF, 0.0)
    assert (roofline_em.em_step_ns(steps) == 10_100) == (not lost)
    assert roofline_em.em_device_ns(tr, steps) == ns
    cell = harness.load_cell(CELL)
    ctx = {"spans": steps, "trace": tr, "cell": cell}
    assert harness.load_reader("em_device_ms").read(ctx) == pytest.approx(ns / 1e6 / 2)
    assert harness.load_reader("em_roofline_pct").read(ctx) > 0


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("name", ["reference/bayes_em.py", "roofline_em.py"])
def test_the_reference_and_the_count_import_nothing_of_the_program(name):
    for mod in _imports(BENCH / name):
        assert mod.split(".")[0] not in {"visionworkbench_torch", "jax", "jaxlib",
                                         "visionworkbench_tpu"}, (name, mod)
