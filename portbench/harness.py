"""The benchmark's runner: one cell, one seed, one run.

``python portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout. The run

1. finds the cell in ``BENCHMARK.json``, its workload file
   ``portbench/workloads/<cell>.json``, its configuration's file and the
   configuration's adapter ``portbench/adapters/<adapter>.py``;
2. makes the cell's distinct items on the card from the seed;
3. warms up on the cell's own items (the program builds its kernels into
   its checkout at first use);
4. streams items for ``--seconds`` in a closed loop with one client and at
   most two items in flight: the next call as soon as the last returned,
   each item's outputs copied to pinned host memory without blocking, an
   item done when its copy's CUDA event completes;
5. with ``--trace 1``, then traces a fixed number of items with
   ``torch.profiler`` and reads the per-layer metrics from
   ``portbench/metrics/<metric>.py``;
6. checks a sample of the window's items, drawn from the seed, against the
   plain reference, once the window has closed and the program's state is
   freed, and prints the result as the last line of standard output.

A cell on more than one card starts one process a card (the same entry,
``--rank``), joined by ``torch.distributed``; rank 0 prints.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import random
import statistics
import subprocess
import sys
import time
from collections import deque
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
CACHE = ROOT / ".portbench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "visionworkbench_tpu")


# ---------------------------------------------------------------------------
# finding a cell's files by name
# ---------------------------------------------------------------------------


def manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, bench: Optional[dict] = None) -> dict:
    """The cell ``name``: its ``BENCHMARK.json`` entry, workload file,
    configuration entry and file, and the metrics it reports."""
    bench = manifest() if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    reports = lambda m: "workloads" not in m or name in m["workloads"]  # noqa: E731
    return {"name": name, "entry": entry, "config_entry": cfg_entry,
            "config": _load_json(ROOT / cfg_entry["file"]),
            "workload": _load_json(BENCH / "workloads" / f"{name}.json"),
            "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
            "per_layer": [m for m in bench["per_layer"] if reports(m)]}


def _module(path: Path, label: str):
    spec = importlib.util.spec_from_file_location(label, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_adapter(config: dict):
    return _module(BENCH / "adapters" / f"{config['adapter']}.py",
                   f"portbench_adapter_{config['adapter']}")


def load_reader(metric: str):
    return _module(BENCH / "metrics" / f"{metric}.py",
                   "portbench_metric_" + metric.replace(".", "_").replace("-", "_"))


# ---------------------------------------------------------------------------
# the closed loop
# ---------------------------------------------------------------------------


class Record:
    __slots__ = ("index", "t_dispatch", "t_return", "event", "t_done")

    def __init__(self, index, t_dispatch, t_return, event):
        self.index, self.t_dispatch, self.t_return = index, t_dispatch, t_return
        self.event, self.t_done = event, None


class _HostEvent:
    """A CPU run's stand-in for a CUDA event: work on the CPU is done when
    the call returns, so the event is the host's clock at ``record``."""

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


class Device:
    """What the loop needs of the device: the card, or the CPU for the
    harness's own tests (no pinned memory, events from the host clock)."""

    def __init__(self, name: str):
        import torch
        self.name = name
        self.cuda = torch.device(name).type == "cuda"

    def synchronize(self):
        import torch
        if self.cuda:
            torch.cuda.synchronize()

    def event(self):
        import torch
        return torch.cuda.Event(enable_timing=True) if self.cuda else _HostEvent()

    def host_buffers(self, outs):
        import torch
        return [torch.empty(o.shape, dtype=o.dtype, pin_memory=self.cuda) for o in outs]

    def peak_bytes(self) -> int:
        import torch
        return int(torch.cuda.max_memory_allocated()) if self.cuda else 0

    def kind(self) -> str:
        import torch
        return torch.cuda.get_device_name(0) if self.cuda else "cpu"

    def free(self):
        import torch
        if self.cuda:
            torch.cuda.empty_cache()


class Stream:
    """Items through the program in a closed loop: one client, at most
    ``depth`` items in flight, each item's outputs copied without blocking
    into pinned host buffers (a ring of ``depth`` sets; an item of the
    ``keep`` set into buffers of its own, kept for the check)."""

    def __init__(self, dev: Device, adapter, config, workload, items, outs, keep=(),
                 depth=2):
        self.dev, self.adapter, self.config, self.workload = dev, adapter, config, workload
        self.items, self.depth = items, depth
        self.ring = [dev.host_buffers(outs) for _ in range(depth)]
        self.keep = {int(i): dev.host_buffers(outs) for i in keep}
        self.next_index = 0

    def _dispatch(self, i: int):
        t0 = time.perf_counter()
        outs = self.adapter.call(self.config, self.workload, self.items[i % len(self.items)])
        t1 = time.perf_counter()
        dst = self.keep.get(i, self.ring[i % self.depth])
        for d, o in zip(dst, outs):
            d.copy_(o, non_blocking=True)
        ev = self.dev.event()
        ev.record()
        return Record(i, t0, t1, ev)

    def run(self, seconds: Optional[float] = None,
            count: Optional[int] = None) -> List[Record]:
        """Dispatch until ``seconds`` have passed (or ``count`` items), then
        wait for every item in flight. Done times come from each copy's
        event against a reference event taken with the card idle, so they
        are the event's own completion times on the host's clock."""
        self.dev.synchronize()
        ref = self.dev.event()
        ref.record()
        ref.synchronize()
        t_ref = time.perf_counter()
        t_end = None if seconds is None else t_ref + seconds
        flight: deque = deque()
        done: List[Record] = []
        n = 0
        while True:
            if count is not None and n >= count:
                break
            if t_end is not None and time.perf_counter() >= t_end:
                break
            if len(flight) == self.depth:
                oldest = flight.popleft()
                oldest.event.synchronize()
                done.append(oldest)
                if t_end is not None and time.perf_counter() >= t_end:
                    break
            flight.append(self._dispatch(self.next_index))
            self.next_index += 1
            n += 1
        while flight:
            rec = flight.popleft()
            rec.event.synchronize()
            done.append(rec)
        for rec in done:
            rec.t_done = t_ref + ref.elapsed_time(rec.event) / 1e3
            rec.event = None
        self.t_start, self.t_end = t_ref, t_end
        return done


def _quantile95(values: List[float]) -> float:
    """The 95th percentile, linear between order statistics."""
    v = sorted(values)
    if len(v) == 1:
        return v[0]
    pos = 0.95 * (len(v) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def quiet_host() -> None:
    """Before the window: collect once, move what set-up made into the
    collector's permanent generation, and keep the collector off until the
    window closes, so that no collection pauses a dispatch in it."""
    gc.collect()
    gc.freeze()
    gc.disable()


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", log=print, sync=None) -> dict:
    """One run of ``cell``; returns the result line's object. ``t_start``
    is the process's start on ``time.perf_counter``'s clock; ``sync``, if
    given, is called as the window opens (the ranks of a cell on several
    cards start their windows together)."""
    import torch
    t_entry = time.perf_counter()
    cfg, wl = cell["config"], cell["workload"]
    dev = Device(device)
    adapter = load_adapter(cfg)
    items = adapter.prepare(cfg, wl, seed, device)
    dev.synchronize()
    t_items = time.perf_counter()
    for k in range(int(wl["warmup_items"])):
        outs = adapter.call(cfg, wl, items[k % len(items)])
    dev.synchronize()
    t_warm = time.perf_counter()
    log(f"[portbench] set-up: start to the run {t_entry - t_start:.3f} s (interpreter, "
        f"torch), items {t_items - t_entry:.3f} s (the CUDA context, the pairs), warm-up "
        f"{t_warm - t_items:.3f} s (the program's imports, kernel build or load, first "
        "calls)", file=sys.stderr)
    keep = sorted(random.Random(int(seed)).sample(range(int(wl["check_within"])),
                                                  int(wl["check_items"])))
    stream = Stream(dev, adapter, cfg, wl, items, outs, keep)
    del outs
    quiet_host()
    if sync is not None:
        sync()
    setup_s = time.perf_counter() - t_start
    recs = stream.run(seconds=seconds)
    gc.enable()
    t_end = stream.t_end
    window = t_end - stream.t_start
    completed = [r for r in recs if r.t_done <= t_end]
    lat_ms = [(r.t_done - r.t_dispatch) * 1e3 for r in recs]
    host_ms = [(r.t_return - r.t_dispatch) * 1e3 for r in recs]
    log(f"[portbench] {cell['name']} seed {seed}: {len(recs)} items dispatched in "
        f"{window:.3f} s, {len(completed)} completed in the window; set-up "
        f"{setup_s:.3f} s; latency median {statistics.median(lat_ms):.3f} ms, "
        f"host {statistics.median(host_ms):.3f} ms an item", file=sys.stderr)
    result: Dict = {"correct": None, "attempted": len(recs), "failed": 0}
    metrics: Dict[str, dict] = {}
    device_info = {"platform": "gpu" if dev.cuda else "cpu", "kind": dev.kind(),
                   "count": 1}
    if trace:
        ctx, tr = _traced_segment(stream, cell, recs, host_ms, log)
        ctx.update(window_s=window, completed=len(completed))
        for m in cell["per_layer"]:
            value = load_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        if tr is not None:
            from portbench import trace as tracemod
            device_info["busy_s"] = tracemod.busy_seconds(tr)
            device_info["window_s"] = tracemod.window_seconds(tr)
            result["breakdown"] = {"device_ops": tracemod.top_device_ops(tr),
                                   "idle_gaps": tracemod.idle_gaps(tr)}
    else:
        values = {"mp_s": len(completed) * adapter.item_pixels(cfg, wl) / 1e6 / window,
                  "latency_p95_ms": _quantile95(lat_ms), "setup_s": setup_s}
        for m in cell["end_to_end"]:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    device_info["memory_peak_bytes"] = dev.peak_bytes()
    if dev.cuda:
        power = _power_limit()
        if power:
            device_info["power"] = power
            log(f"[portbench] card, power limit: {power}", file=sys.stderr)
    # the program's state is freed before the reference runs
    dispatched = {r.index for r in recs}
    kept = {i: bufs for i, bufs in stream.keep.items() if i in dispatched}
    del stream, recs
    gc.collect()
    dev.free()
    checks = check_items(dev, adapter, cfg, wl, items, kept, log)
    bad = forbidden_modules()
    if bad:
        raise RuntimeError("modules of JAX or the JAX package were loaded: " + ", ".join(bad))
    limits = wl["check"]["limits"]
    ok = bool(kept) and all(checks[k] <= limits[k] for k in limits)
    result.update({"correct": ok, "metrics": metrics, "device": device_info})
    result["checks"] = {k: {"value": checks[k], "limit": limits[k]} for k in limits}
    return result


def _traced_segment(stream: Stream, cell: dict, recs, host_ms, log):
    """Trace ``trace_items`` more items in the same closed loop, with the
    profiler recording the device's activity and the CUDA calls only (host
    operators unrecorded, so that the window's pace stays the untraced
    one); returns the readers' context and the trace (None when the
    profiler saw no device operation)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from portbench import roofline, trace as tracemod
    n = int(cell["workload"]["trace_items"])
    acts = [ProfilerActivity.CUDA] if stream.dev.cuda else [ProfilerActivity.CPU]
    marker = torch.zeros(1, device=stream.dev.name)
    stream.dev.synchronize()
    with profile(activities=acts) as prof:
        marker.fill_(1.0)          # the window opens with the card idle
        stream.run(count=n)
        stream.dev.synchronize()
    tr = tracemod.read(prof, n)
    if tr is None:
        log("[portbench] the profiler saw no device operation: per-layer device "
            "metrics not measured", file=sys.stderr)
    ctx = {"records": recs, "host_ms": host_ms, "trace": tr, "cell": cell,
           "roofline": roofline, "tracemod": tracemod,
           "program_kernels": tracemod.program_kernel_names(ROOT)}
    return ctx, tr


def check_items(dev: Device, adapter, cfg, wl, items, kept: dict, log) -> Dict[str, float]:
    """Each kept item's outputs against the plain reference on the same
    pair; every compared number is the worst over the items."""
    worst: Dict[str, float] = {}
    if not kept:
        log("[portbench] no sampled item was dispatched in the window: nothing "
            "checked, not correct", file=sys.stderr)
        return {k: float("inf") for k in wl["check"]["limits"]}
    for i, bufs in sorted(kept.items()):
        pair = items[i % len(items)]
        t0 = time.perf_counter()
        ref = adapter.reference(cfg, wl, pair)
        outs = [b.to(pair.left.device) for b in bufs]
        got = adapter.compare(cfg, wl, outs, ref)
        info = adapter.quality(cfg, wl, pair, outs) if hasattr(adapter, "quality") else {}
        log(f"[portbench] item {i} (pair {i % len(items)}): "
            + ", ".join(f"{k} {v!r}" for k, v in {**got, **info}.items())
            + f"; reference {time.perf_counter() - t0:.2f} s", file=sys.stderr)
        for k in wl["check"]["limits"]:
            worst[k] = max(worst.get(k, 0.0), float(got[k]))
        del ref, outs
        dev.free()
    return worst


# ---------------------------------------------------------------------------
# entry
# ---------------------------------------------------------------------------


def process_start() -> float:
    """The process's start on ``time.perf_counter``'s clock, from its age
    in ``/proc`` (10 ms ticks); now, where that cannot be read."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return now
    return now - max(age, 0.0)


def set_cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"


def parse(argv):
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    p.add_argument("--init", default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def _print_result(result: dict) -> None:
    for k, v in result.get("checks", {}).items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()


def main(argv, t_start: float) -> int:
    args = parse(argv)
    set_cache_dirs()
    cell = load_cell(args.workload)
    chips = int(cell["entry"]["chips"])
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if chips > 1:
        from portbench import ranks
        if args.rank is None:
            return ranks.launch(argv, chips)
        result = ranks.run_rank(cell, args, t_start)
        if args.rank != 0:
            return 0
    else:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace), t_start)
    _print_result(result)
    return 0
