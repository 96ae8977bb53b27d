"""The program's spans against the traced segment's trace.

``visionworkbench_torch.core.profiling.span`` names the steps of
``pyramid_correlate`` (``pyramid_correlate`` the whole call; ``crop``,
``pyramid``, ``prefilter``; per level ``L<n>`` with ``L<n>.offsets``,
``L<n>.sweep`` or ``L<n>.sgm``, at level 0 ``L0.rl`` and ``L0.lr_check``,
``L<n>.speckle``; ``subpixel``; inside each SGM search ``sgm.census``,
``sgm.volume``, ``sgm.scans``, ``sgm.wta``). While a profiler runs the
program keeps them, on ``time.perf_counter_ns``'s clock, in
``profiling.profiled_spans()``; the profiler's trace of CUDA activity holds
the runtime's calls and the device's operations on its own clock. This
module

1. maps the spans onto the profiler's clock (:func:`calibrate`: a
   one-element fill bracketed by ``perf_counter_ns`` in a short profile of
   its own; the offset lies where every bracket holds its launch, and the
   width of that interval is the mapping's error);
2. attributes to the innermost span that holds it (by time) each runtime
   call, each device operation through the call that launched it (in
   launch order: the program and the harness run on one stream, so the
   n-th kernel is the n-th kernel launch, and likewise for copies and
   sets), and the start of each idle gap;
3. sums each step per item and prints the table on standard error.

Readers get the result as ``ctx["spans"]`` through :func:`of` (None when
the program keeps no spans, as before it named its steps, or the trace
holds no device operation). Only calls inside a ``pyramid_correlate`` span
count, so the harness's own waits between items are left out.
"""

from __future__ import annotations

import bisect
import re
import sys
import time
import traceback
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from portbench import trace as tracemod

ROOT = "pyramid_correlate"
SYNCS = frozenset(("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
                   "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize"))
MAX_ERROR_NS = 20_000


def call_name(name: str) -> str:
    """A runtime call's name without its version suffix (``_v3020``)."""
    return re.sub(r"_v\d+$", "", name)


def call_kind(name: str) -> Optional[str]:
    """``kernel``, ``copy`` or ``set`` for a call that puts an operation
    on the device, None for any other."""
    base = call_name(name)
    if base.startswith(("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchCooperativeKernel",
                        "cuLaunchCooperativeKernel")):
        return "kernel"
    if base.startswith(("cudaMemcpy", "cuMemcpy")):
        return "copy"
    if base.startswith(("cudaMemset", "cuMemset")):
        return "set"
    return None


def is_sync(name: str) -> bool:
    """A runtime call that blocks the host until the device catches up:
    the synchronize calls and the synchronous copies."""
    base = call_name(name)
    return base in SYNCS or (call_kind(base) == "copy" and "Async" not in base)


def op_kind(name: str) -> str:
    """``kernel``, ``copy`` or ``set`` for a device operation."""
    return "copy" if name.startswith("Memcpy") else "set" if name.startswith("Memset") else "kernel"


# ---------------------------------------------------------------------------
# the clock
# ---------------------------------------------------------------------------


def bracket_offset(brackets: Sequence[Tuple[int, int]],
                   launches: Sequence[Tuple[int, int]]) -> Tuple[float, float]:
    """The offset (profiler's ns less ``perf_counter_ns``) and its error
    from pairs of a ``perf_counter_ns`` bracket ``(p0, p1)`` and the
    profiler's interval ``(s, e)`` of the call made inside it: each pair
    holds the offset within ``[e - p1, s - p0]``. Returns the middle of
    the pairs' common interval and its width (when the intervals do not
    meet, the middle of the gap and the gap's width)."""
    lo = max(e - p1 for (p0, p1), (s, e) in zip(brackets, launches))
    hi = min(s - p0 for (p0, p1), (s, e) in zip(brackets, launches))
    return (lo + hi) / 2.0, float(abs(hi - lo))


def calibrate(device: str = "cuda", tries: int = 8) -> Optional[Tuple[float, float]]:
    """Measure the offset from ``perf_counter_ns`` to the profiler's clock
    on the card: ``tries`` one-element fills, each bracketed by
    ``perf_counter_ns``, in a profile of CUDA activity. None when the
    profile holds no launch for every fill."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    x = torch.zeros(1, device=device)
    torch.cuda.synchronize()
    brackets = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(tries):
            p0 = time.perf_counter_ns()
            x.fill_(1.0)
            p1 = time.perf_counter_ns()
            brackets.append((p0, p1))
        torch.cuda.synchronize()
    from torch.autograd import DeviceType
    launches = sorted((int(e.start_ns()), int(e.start_ns()) + int(e.duration_ns()))
                      for e in prof.profiler.kineto_results.events()
                      if e.device_type() != DeviceType.CUDA and call_kind(e.name()) == "kernel")
    if len(launches) != tries:
        return None
    return bracket_offset(brackets, launches)


# ---------------------------------------------------------------------------
# attribution
# ---------------------------------------------------------------------------


class Row(NamedTuple):
    """One step's totals over the traced items (inclusive of its inner
    steps): its depth below the root, spans, host ns inside them, ns
    blocked in sync calls, kernel launches, device ns of the operations
    launched, sync calls."""
    depth: int
    calls: int
    host_ns: int
    blocked_ns: int
    kernels: int
    device_ns: int
    syncs: int


class Steps(NamedTuple):
    items: int                      # pyramid_correlate spans in the window
    rows: Dict[str, Row]            # by step name (see step_names), in tree order
    syncs: int                      # sync calls inside the items' spans
    blocked_ns: int                 # their ns
    offset_ns: float                # profiler ns = perf_counter ns + offset
    error_ns: float
    launches_outside: int           # kernel launches in no item's span
    kernels_unattributed: int       # kernels of the trace not matched to a launch in an item
    named_step_share: float         # of the items' device ns, the share under a step
    where: List[int]                # per host op of the trace, its span's index (-1: none)
    spans: List                     # the program's spans


def step_names(spans) -> List[str]:
    """Each span's step name: its name after those of its ancestors below
    the root, leaving out an ancestor whose name its child's name begins
    with (``L0`` above ``L0.rl``): ``crop``, ``L0``, ``L0.rl``,
    ``L0.rl/sgm.scans``; the root keeps its own name."""
    out: List[str] = []
    for item, parent, name, _, _ in spans:
        if parent < 0:
            out.append(name)
            continue
        chain, p = [name], parent
        while spans[p][1] >= 0:
            above = spans[p][2]
            if not chain[0].startswith(above + "."):
                chain.insert(0, above)
            p = spans[p][1]
        out.append("/".join(chain))
    return out


def innermost_fn(spans, offset_ns: float):
    """A function from a time on the profiler's clock to the index of the
    innermost span that holds it (-1 for none). The spans come in the
    order they opened, properly nested (one thread)."""
    starts = [s[3] + offset_ns for s in spans]

    def innermost(t: float) -> int:
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and spans[i][4] + offset_ns < t:
            i = spans[i][1]
        return i
    return innermost


def _match(ops, calls, kind: str, skip: int = 0) -> Optional[Dict[int, int]]:
    """Device operations of ``kind`` (indices into ``ops``) to the calls
    that launched them (indices into ``calls``), in order, leaving out the
    first ``skip`` calls; None when the counts differ."""
    mine = [i for i, o in enumerate(ops) if op_kind(o.name) == kind]
    launched = [j for j, c in enumerate(calls) if call_kind(c.name) == kind][skip:]
    if len(mine) != len(launched):
        return None
    return dict(zip(mine, launched))


def attribute(tr, spans, offset_ns: float, error_ns: float, log=None) -> Optional[Steps]:
    """The steps of the trace ``tr`` (``portbench.trace.Trace``, the marker
    left out of its device operations, its launch first among the calls)
    from the program's ``spans``, mapped by ``offset_ns``."""
    def say(msg):
        if log is not None:
            log(f"[portbench] spans: {msg}", file=sys.stderr)

    innermost = innermost_fn(spans, offset_ns)
    calls = tr.host_ops
    where = [innermost(c.start_ns) for c in calls]
    root_of: List[int] = []
    for i, s in enumerate(spans):
        root_of.append(i if s[1] < 0 else root_of[s[1]])
    lo, hi = tr.window
    roots = {i for i, s in enumerate(spans) if s[1] < 0 and s[2] == ROOT
             and lo <= s[3] + offset_ns <= hi}
    if not roots:
        say("no pyramid_correlate span in the traced window")
        return None
    in_item = [w >= 0 and root_of[w] in roots for w in where]
    self_ = {i: [0, 0, 0, 0] for i in range(len(spans)) if root_of[i] in roots}
    # each span's own [blocked_ns, kernels, device_ns, syncs]
    syncs = blocked = 0
    outside = 0
    for j, c in enumerate(calls):
        kind = call_kind(c.name)
        if not in_item[j]:
            outside += kind == "kernel"
            continue
        acc = self_[where[j]]
        if kind == "kernel":
            acc[1] += 1
        if is_sync(c.name):
            acc[0] += c.end_ns - c.start_ns
            acc[3] += 1
            syncs += 1
            blocked += c.end_ns - c.start_ns
    first_kernel = next((j for j, c in enumerate(calls) if call_kind(c.name) == "kernel"), None)
    outside -= first_kernel is not None and not in_item[first_kernel]     # the marker
    unattributed = 0
    under_step = item_ns = 0
    for kind, skip in (("kernel", 1), ("copy", 0), ("set", 0)):
        pairs = _match(tr.device_ops, calls, kind, skip)
        if pairs is None:
            say(f"the trace's {kind} operations and launches differ in number: "
                f"{kind} device time not attributed")
            if kind == "kernel":
                unattributed = sum(op_kind(o.name) == "kernel" for o in tr.device_ops)
            continue
        for i, j in pairs.items():
            op = tr.device_ops[i]
            if not in_item[j]:
                unattributed += kind == "kernel"
                continue
            ns = op.end_ns - op.start_ns
            self_[where[j]][2] += ns
            item_ns += ns
            under_step += ns if where[j] not in roots else 0
    names = step_names(spans)
    totals: Dict[int, List[int]] = {i: list(v) for i, v in self_.items()}
    for i in sorted(self_, reverse=True):          # children after their parents
        p = spans[i][1]
        if p >= 0 and p in totals:
            totals[p] = [a + b for a, b in zip(totals[p], totals[i])]
    depth = [0] * len(spans)
    for i, sp in enumerate(spans):
        depth[i] = 0 if sp[1] < 0 else depth[sp[1]] + 1
    rows: Dict[str, List[int]] = {}
    for i in sorted(self_):
        blocked_i, kernels_i, device_i, syncs_i = totals[i]
        r = rows.setdefault(names[i], [depth[i], 0, 0, 0, 0, 0, 0])
        for k, v in enumerate((1, spans[i][4] - spans[i][3], blocked_i, kernels_i,
                               device_i, syncs_i), start=1):
            r[k] += v
    return Steps(len(roots), {k: Row(*v) for k, v in rows.items()}, syncs, blocked,
                 offset_ns, error_ns, outside, unattributed,
                 under_step / item_ns if item_ns else 0.0, where, list(spans))


def table(steps: Steps) -> str:
    """The per-step table, per item."""
    n = steps.items
    head = (f"{'step':<28} {'calls':>6} {'host ms':>9} {'blocked':>8} {'kernels':>8} "
            f"{'device ms':>10} {'syncs':>6} {'host us/kernel':>15}")
    lines = [head]
    for name, r in steps.rows.items():
        per_kernel = f"{r.host_ns / 1e3 / r.kernels:15.2f}" if r.kernels else f"{'':>15}"
        lines.append(f"{'  ' * r.depth + name:<28} {r.calls / n:6.2f} {r.host_ns / 1e6 / n:9.3f} "
                     f"{r.blocked_ns / 1e6 / n:8.3f} {r.kernels / n:8.2f} "
                     f"{r.device_ns / 1e6 / n:10.3f} {r.syncs / n:6.2f} {per_kernel}")
    return "\n".join(lines)


def idle_gaps(tr, steps: Optional[Steps], n: int = 10) -> List[List]:
    """``portbench.trace.idle_gaps`` with each gap named
    ``<innermost span>|<CUDA call or Python>`` by where the host was at
    its start (the name as that function gives it where no span held the
    host): the same gaps, in the same order, with the same seconds."""
    busy = tracemod.busy_intervals(tr.device_ops, tr.window)
    gaps, t = [], tr.window[0]
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if tr.window[1] > t:
        gaps.append((t, tr.window[1]))
    gaps.sort(key=lambda g: g[0] - g[1])
    if steps is not None:
        innermost = innermost_fn(steps.spans, steps.offset_ns)
        names = step_names(steps.spans)
    out = []
    for s, e in gaps[:n]:
        running = [o for o in tr.host_ops if o.start_ns <= s < o.end_ns]
        name = (min(running, key=lambda o: o.end_ns - o.start_ns).name
                if running else "host: Python between CUDA calls")
        where = innermost(s) if steps is not None else -1
        if where >= 0:
            name = f"{names[where]}|{call_name(name) if running else 'Python'}"
        out.append([name[:120], (e - s) / 1e9])
    return out


# ---------------------------------------------------------------------------
# readers' entry
# ---------------------------------------------------------------------------


def program_spans() -> Optional[list]:
    """The spans the program kept while the profiler ran; None when the
    program keeps none (it has no ``profiled_spans``)."""
    try:
        from visionworkbench_torch.core import profiling
    except ImportError:
        return None
    get = getattr(profiling, "profiled_spans", None)
    return None if get is None else get()


def of(ctx: dict) -> Optional[Steps]:
    """``ctx["spans"]``, made on the first call: the traced segment's steps,
    with the table and the named gaps printed on standard error."""
    if "spans" not in ctx:
        ctx["spans"] = None
        try:
            ctx["spans"] = _make(ctx)
        except Exception:                # a reader's fault must not end the run
            print("[portbench] spans: not measured:\n" + traceback.format_exc(),
                  file=sys.stderr)
    return ctx["spans"]


def _make(ctx: dict) -> Optional[Steps]:
    tr = ctx.get("trace")
    spans = program_spans()
    if tr is None or not spans:
        return None
    cal = calibrate()
    if cal is None:
        print("[portbench] spans: the calibration profile held no launch for every "
              "fill: not measured", file=sys.stderr)
        return None
    offset, error = cal
    realtime = time.time_ns() - time.perf_counter_ns()
    print(f"[portbench] spans: clock offset {offset:.0f} ns, mapping error {error / 1e3:.3f} us "
          f"(the calibration's brackets; {(offset - realtime) / 1e3:+.3f} us from the realtime "
          "clock's offset)", file=sys.stderr)
    if error > MAX_ERROR_NS:
        print(f"[portbench] spans: mapping error over {MAX_ERROR_NS / 1e3:.0f} us: "
              "not measured", file=sys.stderr)
        return None
    steps = attribute(tr, spans, offset, error, log=print)
    if steps is None:
        return None
    print(f"[portbench] spans: {steps.items} items traced ({tr.items} dispatched); kernel "
          f"launches outside every item's span, the marker's left out: "
          f"{steps.launches_outside}; kernels not attributed to an item: "
          f"{steps.kernels_unattributed}; the items' device time under a named step: "
          f"{100 * steps.named_step_share:.2f} %; per item:\n{table(steps)}", file=sys.stderr)
    print("[portbench] spans: idle gaps by step: "
          + "; ".join(f"{name} {sec * 1e3:.3f} ms" for name, sec in idle_gaps(tr, steps)),
          file=sys.stderr)
    return steps
