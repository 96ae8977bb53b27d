"""The two readings that a cell's limits are set from, on the card:

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,13 [--items 1]

For each seed, ``--items`` of the cell's pairs go through the timed call
(the program) and through the plain reference, and the reference is also
computed in the control's precision (``--control``, bfloat16 by default:
the nearest precision below the configuration's float32). The program and
the control are each compared with the reference by the cell's own
comparison. Prints one JSON line a seed and item, then the lower reading
(the largest the program gives) and the upper one (the smallest the
control gives) of every compared number. The benchmark's runs do not run
this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402


def main(argv) -> int:
    p = argparse.ArgumentParser(prog="portbench/calibrate.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--items", type=int, default=1)
    p.add_argument("--control", default="bfloat16")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    harness.set_cache_dirs()
    import torch
    from portbench import scenes
    cell = harness.load_cell(args.workload)
    cfg, wl = cell["config"], cell["workload"]
    adapter = harness.load_adapter(cfg)
    control = getattr(torch, args.control)
    names = list(wl["check"]["limits"])
    lower = {k: 0.0 for k in names}
    upper = {k: float("inf") for k in names}
    for seed in (int(s) for s in args.seeds.split(",")):
        for i in range(args.items):
            pair = scenes.make_pair(wl["traffic"], seed, i, args.device)
            t0 = time.perf_counter()
            outs = adapter.call(cfg, wl, pair)
            outs = [o.clone() for o in outs]
            t1 = time.perf_counter()
            ref = adapter.reference(cfg, wl, pair)
            t2 = time.perf_counter()
            low = adapter.reference(cfg, wl, pair, dtype=control)
            t3 = time.perf_counter()
            got = adapter.compare(cfg, wl, outs, ref)
            ctl = adapter.compare(cfg, wl, low, ref)
            for k in names:
                lower[k] = max(lower[k], got[k])
                upper[k] = min(upper[k], ctl[k])
            print(json.dumps({"seed": seed, "pair": i, "program": got, "control": ctl,
                              "quality": adapter.quality(cfg, wl, pair, outs),
                              "seconds": {"program": t1 - t0, "reference": t2 - t1,
                                          "control": t3 - t2}}), flush=True)
            del outs, ref, low
    print(json.dumps({"workload": args.workload, "control": args.control,
                      "lower": lower, "upper": upper}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
