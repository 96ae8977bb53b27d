"""Cells on more than one card: one process a card, through the same entry.

``launch`` starts ``portbench/run.py`` once a rank with ``--rank r --world
n --init tcp://localhost:<port>``, waits for every rank (ending the others
when one fails or the time runs out) and passes rank 0's result line on.
Each rank joins the process group on its own card and runs the cell like a
one-card run, in step with the others at the window's start; rank 0
prints the cell's result: correct where every rank is, the fullest card's
memory peak, the device's busy seconds averaged over the cards, the worst
of each compared number.
"""

from __future__ import annotations

import socket
import subprocess
import sys
import time
from pathlib import Path

RUN = Path(__file__).resolve().with_name("run.py")
WALL_S = 340


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(argv, world: int) -> int:
    init = f"tcp://localhost:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, str(RUN), *argv, "--rank", str(r),
                               "--world", str(world), "--init", init],
                              stdout=subprocess.PIPE if r == 0 else subprocess.DEVNULL,
                              text=True)
             for r in range(world)]
    out0 = ""
    deadline = time.monotonic() + WALL_S
    try:
        out0, _ = procs[0].communicate(timeout=WALL_S)
        rcs = [p.wait(timeout=max(1.0, deadline - time.monotonic())) for p in procs]
    except subprocess.TimeoutExpired:
        rcs = [1]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    bad = next((rc for rc in rcs if rc != 0), 0)
    if bad:
        print(f"portbench: a rank failed (exit codes {rcs})", file=sys.stderr)
        return bad
    sys.stdout.write(out0)
    return 0


def run_rank(cell: dict, args, t_start: float) -> dict:
    """This rank's run; on rank 0 the cell's merged result."""
    import torch
    import torch.distributed as dist
    from portbench import harness
    rank, world = int(args.rank), int(args.world)
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=args.init, rank=rank, world_size=world,
                            device_id=torch.device("cuda", rank))
    try:
        res = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), t_start,
                               device=f"cuda:{rank}", sync=dist.barrier)
        every = [None] * world
        dist.all_gather_object(every, res)
    finally:
        dist.destroy_process_group()
    if rank != 0:
        return res
    out = every[0]
    dev = out["device"]
    dev["count"] = world
    dev["memory_peak_bytes"] = max(r["device"]["memory_peak_bytes"] for r in every)
    if "busy_s" in dev:
        dev["busy_s"] = sum(r["device"]["busy_s"] for r in every) / world
    out["correct"] = all(r["correct"] for r in every)
    out["failed"] = sum(r["failed"] for r in every)
    for k, v in out["checks"].items():
        v["value"] = max(r["checks"][k]["value"] for r in every)
    out["checks"] = out.pop("checks")       # stays the last key
    return out
