"""Port's host runtime (``visionworkbench_torch/core/``: settings, log,
progress, cache, threadpool, cmdutils, profiling) against the JAX package's
modules on the CPU, on the same inputs. These modules compute no pixels:
every comparison is exact (the same values, decisions, counts and text).
"""

import dataclasses
import io
import os
import threading
import time

import numpy as np
import pytest
import torch

from torch_parity import _torch_threads  # noqa: F401
import visionworkbench_tpu.core as jcore
import visionworkbench_tpu.core.cache as jcache
import visionworkbench_tpu.core.cmdutils as jcmd
import visionworkbench_tpu.core.log as jlog
import visionworkbench_tpu.core.profiling as jprof
import visionworkbench_tpu.core.progress as jprog
import visionworkbench_tpu.core.settings as jset
import visionworkbench_tpu.core.threadpool as jtp
import visionworkbench_torch.core as tcore
import visionworkbench_torch.core.cache as tcache
import visionworkbench_torch.core.cmdutils as tcmd
import visionworkbench_torch.core.log as tlog
import visionworkbench_torch.core.profiling as tprof
import visionworkbench_torch.core.progress as tprog
import visionworkbench_torch.core.settings as tset
import visionworkbench_torch.core.threadpool as ttp

PAIRS = {"settings": (jset, tset), "log": (jlog, tlog), "progress": (jprog, tprog),
         "cache": (jcache, tcache), "threadpool": (jtp, ttp), "cmdutils": (jcmd, tcmd),
         "profiling": (jprof, tprof)}
# the JAX package's names the port left out on purpose: the per-stage
# megapixel counter and the stage timer that syncs the device at every
# stage (the port names its steps with ``profiling.span`` instead)
NOT_PORTED = {"profiling": {"RateCounter", "timed_stage"}}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_public_names(name):
    """Each module has the JAX module's public names, but those it left
    out on purpose."""
    j, t = PAIRS[name]
    public = {n for n in vars(j) if not n.startswith("_") and n not in ("annotations",)
              and getattr(getattr(j, n), "__module__", j.__name__) == j.__name__}
    public -= NOT_PORTED.get(name, set())
    assert public <= set(vars(t)), public - set(vars(t))


def test_core_all():
    assert tcore.__all__ == jcore.__all__
    for n in tcore.__all__:
        assert hasattr(tcore, n)


RC = """# comment
[general]
default_tile_size = 512
default_num_threads=7   # trailing comment
system_cache_size = not-a-number
write_pool_size = 9
tmp_directory = /some/where
hbm_budget_bytes = 1024
shard_tile_size = 2048
unknown_key = 3
no equals sign here
"""


@pytest.mark.parametrize("rc", [None, RC], ids=["defaults", "rc_file"])
def test_settings(tmp_path, monkeypatch, rc):
    """The same fields and values: defaults (no rc file), an rc file named
    by VWTPU_RC, and reload_config of a second file."""
    path = tmp_path / "vwtpurc"
    if rc is not None:
        path.write_text(rc)
    monkeypatch.setenv("VWTPU_RC", str(path))
    monkeypatch.setattr(jset, "_settings", None)
    monkeypatch.setattr(tset, "_settings", None)
    js, ts = jset.vw_settings(), tset.vw_settings()
    assert [f.name for f in dataclasses.fields(ts)] == [f.name for f in dataclasses.fields(js)]
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert tset.vw_settings() is ts
    second = tmp_path / "second"
    second.write_text("default_tile_size = 64\nwrite_pool_size = 3\n")
    jset.reload_config(str(second))
    tset.reload_config(str(second))
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    ts.set_default_num_threads(3)
    ts.set_default_tile_size(128)
    ts.set_system_cache_size(4096)
    js.set_default_num_threads(3)
    js.set_default_tile_size(128)
    js.set_system_cache_size(4096)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)


LEVELS = [jlog.VERBOSE_DEBUG, jlog.DEBUG, jlog.INFO, jlog.WARNING, jlog.ERROR]
NAMESPACES = ["console", "stereo", "stereo.sgm", "cache", "fileio", ""]
RULES = {"none": [], "stereo_debug": [(jlog.DEBUG, "stereo*")],
         "mixed": [(jlog.WARNING, "*"), (jlog.VERBOSE_DEBUG, "cache"),
                   (jlog.INFO, "f?leio")]}


@pytest.mark.parametrize("rules", sorted(RULES))
def test_log_rules(monkeypatch, rules):
    """The same (level, namespace) pairs pass the same rule set, and
    ``vw_out`` hands out a live or a silent logger alike."""
    assert (tlog.ERROR, tlog.WARNING, tlog.INFO, tlog.DEBUG, tlog.VERBOSE_DEBUG) == \
        (jlog.ERROR, jlog.WARNING, jlog.INFO, jlog.DEBUG, jlog.VERBOSE_DEBUG)
    jr, tr = jlog.LogRuleSet(), tlog.LogRuleSet()
    for level, pat in RULES[rules]:
        jr.add_rule(level, pat)
        tr.add_rule(level, pat)
    monkeypatch.setattr(jlog, "_rules", jr)
    monkeypatch.setattr(tlog, "_rules", tr)
    for level in LEVELS:
        for ns in NAMESPACES:
            want = jr.operator_matches(level, ns)
            assert tr.operator_matches(level, ns) == want, (level, ns)
            jl, tl = jlog.vw_out(level, ns), tlog.vw_out(level, ns)
            assert tl.disabled == jl.disabled
            assert tl.name == (tlog.ROOT + "._silent" if jl.disabled
                               else jl.name.replace("vwtpu", tlog.ROOT, 1))
    assert tlog.vw_log_rules() is tr
    tr.clear()
    jr.clear()
    assert tr.operator_matches(jlog.DEBUG, "x") == jr.operator_matches(jlog.DEBUG, "x")


def test_set_console_level():
    prev = tlog._root.level
    try:
        tlog.set_console_level(tlog.WARNING)
        assert tlog._root.level == tlog.WARNING
        assert tlog._root.name == tlog.ROOT and not tlog._root.propagate
    finally:
        tlog.set_console_level(prev)


def _progress_run(mod):
    s = io.StringIO()
    bar = mod.TerminalProgressCallback(desc="Writing: ", width=20, stream=s)
    for p in (0.0, 0.123, 0.5, 1.7, -0.2):
        bar.report_progress(p)
    bar.report_incremental_progress(0.25)
    bar.report_finished()
    sub = mod.SubProgressCallback(bar, 0.2, 0.6)
    sub.report_progress(0.5)
    parent_after_sub = bar.progress()
    base = mod.ProgressCallback()
    base.report_progress(0.3)
    base.report_incremental_progress(0.2)
    sub2 = mod.SubProgressCallback(base, 0.0, 0.5)
    flags = [sub2.abort_requested()]
    base.request_abort()
    flags += [sub2.abort_requested(), base.abort_requested()]
    return s.getvalue(), parent_after_sub, base.progress(), flags


def test_progress_text_and_abort():
    """The same bar text, sub-range mapping and abort plumbing."""
    assert _progress_run(tprog) == _progress_run(jprog)
    cb = tprog.ProgressCallback()
    cb.abort_if_requested()
    cb.request_abort()
    from visionworkbench_torch.core.exceptions import AbortedErr
    with pytest.raises(AbortedErr, match="aborted"):
        cb.abort_if_requested()
    assert tprog.dummy_progress() is tprog.dummy_progress()


def _cache_run(mod):
    """A sequence of cache operations; the counters after each."""
    c = mod.Cache(1000)
    calls = []

    def gen(name, n):
        def g():
            calls.append(name)
            return np.full(n, len(calls), np.float32)
        return g

    log = []

    def snap(what):
        log.append((what, c.hits, c.misses, c.evictions, c.size))

    ha = c.insert(gen("a", 100), "a")           # 400 B
    hb = c.insert(gen("b", 100), "b")
    hc = c.insert(gen("c", 100), "c")
    hbig = c.insert(gen("big", 400), "big")     # 1600 B: over the budget alone
    ha.value(); snap("a miss")
    hb.value(); snap("b miss")
    ha.value(); snap("a hit")
    hc.value(); snap("c miss, b evicted")
    log.append(("valid", ha.valid(), hb.valid(), hc.valid()))
    v = hb.value(); snap("b regenerated, a evicted")
    log.append(("b value", float(v[0])))
    hc.release(); snap("c released")
    log.append(("valid", ha.valid(), hb.valid(), hc.valid()))
    hbig.value(); snap("big alone")
    opaque = c.insert(lambda: object(), "opaque")
    opaque.value(); snap("opaque 1024 B")
    c.invalidate("missing"); snap("invalidate missing")
    c.clear(); snap("clear")
    log.append(("calls", tuple(calls)))
    return log


def _cache_threads(mod, n=8):
    """``n`` threads fetch one key at once: one generates, the rest hit."""
    c = mod.Cache(1 << 20)
    calls = []
    start = threading.Barrier(n)

    def gen():
        calls.append(1)
        time.sleep(0.05)
        return np.zeros(16, np.float32)

    def worker():
        start.wait()
        c.insert(gen, "k").value()

    threads = [threading.Thread(target=worker) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    return len(calls), c.hits, c.misses, c.evictions, c.size


@pytest.mark.parametrize("run", [_cache_run, _cache_threads], ids=["sequence", "threads"])
def test_cache_counts(run):
    """The same hits, misses, evictions and size after each operation."""
    assert run(tcache) == run(jcache)


def test_system_cache_sized_from_settings(monkeypatch):
    monkeypatch.setattr(tcache, "_system_cache", None)
    monkeypatch.setattr(tset, "_settings", tset.Settings(system_cache_size=12345))
    c = tcache.vw_system_cache()
    assert c.max_size == 12345 and tcache.vw_system_cache() is c


def _queues(mod, fail_at=None):
    """FIFO and ordered queues over tasks that finish out of order."""
    delays = np.random.default_rng(3).random(24) * 0.004
    fifo_out, lock = [], threading.Lock()

    def task(i):
        def run():
            time.sleep(delays[i])
            if i == fail_at:
                raise ValueError(f"task {i}")
            with lock:
                fifo_out.append(i)
            return i * i
        return run

    fifo = mod.FifoWorkQueue(num_threads=4)
    for i in range(24):
        fifo.add_task(task(i))
    err = None
    try:
        fifo.join_all()
    except ValueError as e:
        err = str(e)
    consumed = []
    ordered = mod.OrderedWorkQueue(lambda i, v: consumed.append((i, v)), num_threads=4)
    for i in reversed(range(24)):
        ordered.add_task(i, task(i))
    oerr = None
    try:
        ordered.join_all()
    except ValueError as e:
        oerr = str(e)
    return sorted(fifo_out), err, consumed, oerr


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
@pytest.mark.parametrize("fail_at", [None, 5], ids=["ok", "error"])
def test_work_queues(fail_at):
    """FIFO and ordered queues give the same results in the same order, and
    a task's error reaches the caller of the FIFO queue's ``join_all``. In
    both packages the ordered queue leaves a task's error to its worker
    thread, which ends; the other workers consume the rest in order."""
    t = _queues(ttp, fail_at)
    assert t == _queues(jtp, fail_at)
    assert t[1] == (None if fail_at is None else "task 5")


def test_thread_queue_and_semaphore():
    for mod in (ttp, jtp):
        q = mod.ThreadQueue()
        assert q.empty() and q.try_pop() == (False, None)
        q.push(1)
        q.push(2)
        assert q.size() == 2 and q.wait_pop(timeout=1) == 1 and q.try_pop() == (True, 2)
    sem = ttp.CountingSemaphore(2)
    held = []
    with sem:
        sem.wait()
        t = threading.Thread(target=lambda: (sem.wait(), held.append(1), sem.release()))
        t.start()
        time.sleep(0.05)
        assert held == []          # the window is full
        sem.release()
    t.join(timeout=10)
    assert not t.is_alive() and held == [1]


def test_cmdutils(tmp_path):
    assert tcmd.exec_cmd("echo hello; echo world") == jcmd.exec_cmd("echo hello; echo world")
    assert tcmd.find_executable_in_path("sh") == jcmd.find_executable_in_path("sh")
    from visionworkbench_torch.core.exceptions import NotFoundErr
    with pytest.raises(NotFoundErr, match="Could not find path"):
        tcmd.find_executable_in_path("no-such-program-xyz")
    libs = tmp_path / "bin" / ".libs"
    libs.mkdir(parents=True)
    (tmp_path / "bin" / "sibling").write_text("")
    exe = str(libs / "prog")
    for prog in ("sibling", "sh"):
        assert tcmd.program_path(prog, exe) == jcmd.program_path(prog, exe)
    with pytest.raises(NotFoundErr):
        tcmd.program_path("no-such-program-xyz", exe)


def test_materialize():
    tree = {"a": [torch.arange(4, dtype=torch.float32), (torch.ones(2, 3), 2.5)],
            "b": {"c": torch.tensor(7, dtype=torch.int32), "d": None}}
    jtree = {"a": [np.arange(4, dtype=np.float32), (np.ones((2, 3), np.float32), 2.5)],
             "b": {"c": np.int32(7), "d": None}}
    got, want = tprof.materialize(tree), jprof.materialize(jtree)
    assert isinstance(got["a"], list) and isinstance(got["a"][1], tuple)
    assert got["b"]["d"] is None and want["b"]["d"] is None
    for g, w in ((got["a"][0], want["a"][0]), (got["a"][1][0], want["a"][1][0]),
                 (got["a"][1][1], want["a"][1][1]), (got["b"]["c"], want["b"]["c"])):
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_trace_writes_chrome_trace(tmp_path):
    """``trace`` records the block with torch.profiler (CPU activity here)
    and writes one Chrome trace into the log directory."""
    logdir = tmp_path / "trace"
    with tprof.trace(str(logdir)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    text = (logdir / files[0]).read_text()
    assert "traceEvents" in text and "aten::mm" in text
