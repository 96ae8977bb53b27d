"""Reading a ``torch.profiler`` trace of the traced segment: device
operations with their intervals, host operations, the busy union, the
longest idle gaps and what the host was doing in them."""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Set, Tuple



class Op(NamedTuple):
    name: str
    start_ns: int
    end_ns: int


class Trace(NamedTuple):
    device_ops: List[Op]      # kernels, copies and sets on the card, in time order
    host_ops: List[Op]        # host-side operations and spans
    window: Tuple[int, int]   # the traced window (ns, the profiler's clock)
    items: int                # items dispatched in the window


def _span(e) -> Tuple[int, int]:
    start = int(e.start_ns())
    return start, start + int(e.duration_ns())


def read(prof, items: int) -> Optional[Trace]:
    """The trace of a finished ``torch.profiler.profile`` of the device's
    activity whose first device operation is the window's marker,
    launched with the card idle as the window opened: the window runs
    from the marker's start to the end of the last device operation, and
    the marker is no operation of the items. Host events are the CUDA
    runtime's calls. None when the trace holds no device operation of the
    items."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start, end = _span(e)
        if e.device_type() == DeviceType.CUDA:
            # a span's mirror on the device's timeline is no operation
            if end > start and not e.is_user_annotation():
                dev.append(Op(e.name(), start, end))
        else:
            host.append(Op(e.name(), start, end))
    if len(dev) < 2:
        return None
    dev.sort(key=lambda o: o.start_ns)
    host.sort(key=lambda o: o.start_ns)
    window = (dev[0].start_ns, max(o.end_ns for o in dev))
    return Trace(dev[1:], host, window, int(items))


def is_kernel(op: Op) -> bool:
    return not op.name.startswith(("Memcpy", "Memset"))


def is_output_copy(op: Op) -> bool:
    """The harness's copy of each item's outputs to pinned host memory."""
    return op.name.startswith("Memcpy DtoH")


def busy_intervals(ops: List[Op], window: Tuple[int, int]) -> List[Tuple[int, int]]:
    """The union of the operations' intervals, clipped to the window."""
    out: List[Tuple[int, int]] = []
    for o in ops:
        s, e = max(o.start_ns, window[0]), min(o.end_ns, window[1])
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def busy_seconds(tr: Trace) -> float:
    return sum(e - s for s, e in busy_intervals(tr.device_ops, tr.window)) / 1e9


def window_seconds(tr: Trace) -> float:
    return (tr.window[1] - tr.window[0]) / 1e9


def _short(name: str) -> str:
    """A kernel's name without its return type and parameter list."""
    name = re.sub(r"^void ", "", name.replace("(anonymous namespace)::", ""))
    depth, out = 0, []
    for ch in name:        # drop the parameter list, keep template arguments
        if ch == "(" and depth == 0:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out)[:120]


def top_device_ops(tr: Trace, n: int = 10) -> List[List]:
    """The device operations that took most time in the window, summed by
    name: [[name, seconds], ...]."""
    sums: Dict[str, int] = {}
    for o in tr.device_ops:
        k = _short(o.name)
        sums[k] = sums.get(k, 0) + (o.end_ns - o.start_ns)
    top = sorted(sums.items(), key=lambda kv: -kv[1])[:n]
    return [[k, v / 1e9] for k, v in top]


def idle_gaps(tr: Trace, n: int = 10) -> List[List]:
    """The longest stretches of the window with no device operation, each
    named by the innermost CUDA call the host was in at its start, or as
    Python between CUDA calls: [[name, seconds], ...]."""
    busy = busy_intervals(tr.device_ops, tr.window)
    gaps, t = [], tr.window[0]
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if tr.window[1] > t:
        gaps.append((t, tr.window[1]))
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for s, e in gaps[:n]:
        running = [o for o in tr.host_ops if o.start_ns <= s < o.end_ns]
        name = (min(running, key=lambda o: o.end_ns - o.start_ns).name
                if running else "host: Python between CUDA calls")
        out.append([name[:120], (e - s) / 1e9])
    return out


def program_kernel_names(root: Path) -> Set[str]:
    """Names of the program's hand-written kernels: every ``__global__``
    function of ``visionworkbench_torch/csrc/*.cu``."""
    names = set()
    pat = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*\)\s*)?"
                     r"(?:void\s+)?(\w+)\s*\(")
    for src in sorted((root / "visionworkbench_torch" / "csrc").glob("*.cu")):
        names.update(pat.findall(src.read_text()))
    return names


def kernel_matches(op: Op, names) -> bool:
    short = _short(op.name)
    base = re.split(r"[<\s(]", short, maxsplit=1)[0].split("::")[-1]
    return base in names
