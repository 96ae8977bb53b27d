"""``portbench/spans.py`` and the two readers of the program's spans, on a
trace built by hand: the clock mapping, the attribution of runtime calls,
kernels, copies and idle gaps to the innermost span, the per-step rows,
``host_syncs_per_item`` and ``host_blocked_ms``, and the named gaps
against ``portbench.trace.idle_gaps`` on the same trace."""

import pytest

from portbench import harness, spans
from portbench import trace as tracemod
from portbench.trace import Op, Trace

OFF = 10_000_000          # the profiler's clock less perf_counter_ns

# (item_id, parent_index, name, t0_ns, t1_ns) on perf_counter_ns's clock
SPANS = [
    (0, -1, "pyramid_correlate", 1000, 5000),   # 0
    (0, 0, "crop", 1100, 1500),                 # 1
    (0, 0, "L0", 1600, 4500),                   # 2
    (0, 2, "L0.sweep", 1700, 3000),             # 3
    (0, 2, "L0.rl", 3100, 4000),                # 4
    (0, 4, "sgm.scans", 3200, 3900),            # 5
    (0, 0, "subpixel", 4600, 4900),             # 6
    (1, -1, "pyramid_correlate", 6000, 9000),   # 7
    (1, 7, "crop", 6100, 6500),                 # 8
    (1, 7, "subpixel", 6600, 8800),             # 9
]


def _host(name, s, e):
    return Op(name, OFF + s, OFF + e)


HOST = [
    _host("cudaLaunchKernel", 500, 510),          # the marker
    _host("cudaLaunchKernel", 1200, 1210),        # crop
    _host("cudaLaunchKernel", 1800, 1810),        # L0.sweep
    _host("cudaMemcpyAsync", 3250, 3260),         # sgm.scans: a pageable copy ...
    _host("cudaStreamSynchronize", 3300, 3500),   # ... and its sync
    _host("cudaLaunchKernel_v7000", 3600, 3610),  # sgm.scans
    _host("cudaStreamSynchronize", 4700, 4800),   # subpixel
    _host("cudaMemcpyAsync", 5100, 5110),         # the harness's output copy
    _host("cudaEventRecord", 5150, 5160),
    _host("cudaEventSynchronize", 5200, 5900),    # the harness's wait: no span
    _host("cudaLaunchKernel", 6200, 6210),        # item 1 crop
    _host("cudaLaunchKernel", 6700, 6710),        # item 1 subpixel
    _host("cudaStreamSynchronize", 7000, 8000),   # item 1 subpixel
    _host("cudaMemcpyAsync", 9100, 9110),         # the harness's output copy
]

DEVICE = [   # the marker left out, as trace.read leaves it
    Op("k_crop", OFF + 1300, OFF + 1400),
    Op("k_sweep", OFF + 1900, OFF + 2100),
    Op("Memcpy HtoD (Pageable -> Device)", OFF + 3300, OFF + 3310),
    Op("k_scan", OFF + 3700, OFF + 4000),
    Op("Memcpy DtoH (Device -> Pinned)", OFF + 5200, OFF + 5220),
    Op("k_crop1", OFF + 6300, OFF + 6350),
    Op("k_sub1", OFF + 6800, OFF + 7200),
    Op("Memcpy DtoH (Device -> Pinned)", OFF + 9200, OFF + 9220),
]

TRACE = Trace(DEVICE, HOST, (OFF + 505, OFF + 9220), 2)


@pytest.fixture
def steps():
    return spans.attribute(TRACE, SPANS, OFF, 0.0)


def test_bracket_offset_is_where_every_bracket_holds_its_launch():
    brackets = [(100, 200), (300, 420)]
    launches = [(OFF + 130, OFF + 150), (OFF + 350, OFF + 380)]
    # bracket 1 allows [OFF - 50, OFF + 30], bracket 2 [OFF - 40, OFF + 50]
    assert spans.bracket_offset(brackets, launches) == (OFF - 5, 70.0)
    # brackets that do not meet: the middle of the gap, its width the error
    assert spans.bracket_offset([(100, 110)], [(OFF + 200, OFF + 205)]) == (OFF + 97.5, 5.0)


def test_call_classes():
    assert spans.call_kind("cudaLaunchKernel_v7000") == "kernel"
    assert spans.call_kind("cudaLaunchKernelExC_v11060") == "kernel"
    assert spans.call_kind("cudaMemcpyAsync") == "copy"
    assert spans.call_kind("cudaEventRecord") is None
    assert spans.is_sync("cudaStreamSynchronize") and spans.is_sync("cudaMemcpy")
    assert not spans.is_sync("cudaMemcpyAsync") and not spans.is_sync("cudaLaunchKernel")


def test_innermost_span_of_a_time():
    inner = spans.innermost_fn(SPANS, OFF)
    assert [inner(OFF + t) for t in (900, 1050, 1200, 1550, 3400, 4100, 5100, 7000)] == \
        [-1, 0, 1, 0, 5, 2, -1, 9]


def test_step_names():
    assert spans.step_names(SPANS) == [
        "pyramid_correlate", "crop", "L0", "L0.sweep", "L0.rl", "L0.rl/sgm.scans",
        "subpixel", "pyramid_correlate", "crop", "subpixel"]


def test_attribution_of_calls_kernels_and_syncs(steps):
    assert steps.items == 2
    assert steps.where == [-1, 1, 3, 5, 5, 5, 6, -1, -1, -1, 8, 9, 9, -1]
    # the syncs inside the items' spans; the harness's event wait is left out
    assert steps.syncs == 3 and steps.blocked_ns == 200 + 100 + 1000
    assert steps.launches_outside == 0 and steps.kernels_unattributed == 0
    assert steps.named_step_share == 1.0
    r = steps.rows
    assert list(r) == ["pyramid_correlate", "crop", "L0", "L0.sweep", "L0.rl",
                       "L0.rl/sgm.scans", "subpixel"]
    assert r["pyramid_correlate"] == spans.Row(0, 2, 4000 + 3000, 1300, 5, 1060, 3)
    assert r["crop"] == spans.Row(1, 2, 400 + 400, 0, 2, 150, 0)
    assert r["L0.rl/sgm.scans"] == spans.Row(3, 1, 700, 200, 1, 310, 1)
    assert r["L0.rl"] == spans.Row(2, 1, 900, 200, 1, 310, 1)
    assert r["L0"] == spans.Row(1, 1, 2900, 200, 2, 510, 1)
    assert r["subpixel"] == spans.Row(1, 2, 300 + 2200, 1100, 1, 400, 2)


def test_a_mapping_off_by_less_than_the_slack_changes_nothing(steps):
    for err in (-40, 40):
        assert spans.attribute(TRACE, SPANS, OFF + err, 0.0).rows == steps.rows


def test_unmatched_kernels_are_counted_unattributed():
    tr = TRACE._replace(device_ops=DEVICE[1:])     # a kernel missing from the trace
    got = spans.attribute(tr, SPANS, OFF, 0.0)
    assert got.kernels_unattributed == 4 and got.rows["pyramid_correlate"].device_ns == 10
    assert got.syncs == 3


def test_spans_outside_the_window_are_not_items():
    got = spans.attribute(TRACE._replace(window=(OFF + 5500, OFF + 9220)), SPANS, OFF, 0.0)
    assert got.items == 1 and got.syncs == 1 and got.blocked_ns == 1000
    assert spans.attribute(TRACE, SPANS, OFF + 10**6, 0.0) is None


def test_readers(steps):
    ctx = {"trace": TRACE, "spans": steps}
    assert harness.load_reader("host_syncs_per_item").read(ctx) == 1.5
    assert harness.load_reader("host_blocked_ms").read(ctx) == 1300 / 1e6 / 2
    for name in ("host_syncs_per_item", "host_blocked_ms"):
        assert harness.load_reader(name).read({"trace": TRACE, "spans": None}) is None


def test_readers_without_the_programs_spans(monkeypatch):
    """A program that keeps no spans (before it named its steps): the
    readers find nothing and raise nothing."""
    monkeypatch.setattr(spans, "program_spans", lambda: None)
    ctx = {"trace": TRACE}
    assert harness.load_reader("host_syncs_per_item").read(ctx) is None
    assert ctx["spans"] is None
    assert harness.load_reader("host_blocked_ms").read({"trace": None}) is None


def test_named_gaps_keep_the_gaps_and_their_seconds(steps):
    plain = tracemod.idle_gaps(TRACE)
    named = spans.idle_gaps(TRACE, steps)
    assert [s for _, s in named] == [s for _, s in plain]
    assert len(named) == len(plain) == 8
    by_start = dict(zip([n for n, _ in plain], [n for n, _ in named]))
    assert by_start["cudaEventSynchronize"] == "cudaEventSynchronize"       # no span
    names = [n for n, _ in named]
    assert "L0.rl/sgm.scans|cudaStreamSynchronize" in names
    assert "subpixel|cudaStreamSynchronize" in names
    assert "crop|Python" in names
    assert spans.idle_gaps(TRACE, None) == plain


def test_table_has_a_row_a_step(steps):
    text = spans.table(steps).splitlines()
    assert len(text) == 1 + len(steps.rows)
    assert text[1].split()[:3] == ["pyramid_correlate", "1.00", "0.004"]
