"""What each part of the register-carry SGM/MGM kernel costs on the card.

    python3 -m visionworkbench_torch.tools.mgm_scan_ablation \
        [--also NAME=FILE.cu ...] [--reps 20]

Builds ``visionworkbench_torch/csrc/mgm_scan.cu`` as it is and with one part
taken out at a time, and times each variant with CUDA events, in turns
(v0, v1, ..., vk, vk, ..., v0), at config 6's level-0 and level-4 shapes
as ``chip_smoke.py`` makes them: ``mgm_fwd`` (1024, 4, 2, 5, 512) and
(128, 4, 1, 4, 64), ``mgm_bidir`` (512, 2, 5, 512) and (64, 1, 4, 64),
``scan_bidir`` (512, 2, 5, 512) with shifts (0, 1, -1) and (0,), one block
a line; and at level 0 of config 6 at 1024^2, ``mgm_bidir`` (1024, 2, 5,
1024) and ``mgm_fwd`` (2048, 4, 2, 5, 1024), a line over a cluster of the
blocks the wrapper picks. A variant with a part taken out computes wrong
values; only its time counts, and the difference to ``as_is`` is what that
part costs:

  no_loads            each lane loads its costs, |dI| and guard at step 0 only
  no_stores           no step is stored (fwd) or added (bidir, SGM)
  no_barrier          the per-step barrier is dropped (warp-edge lanes race)
  no_cluster_barrier  over a cluster, the per-step cluster barrier becomes a
                      block barrier (the neighbour blocks' rows race)
  no_dsmem            over a cluster, the block's edge warps read their own
                      block's rows, not the neighbour blocks' (no
                      distributed shared memory access)

``--also NAME=FILE`` adds another source with the same C interface (an
earlier version of the kernel) as one more variant. Prints the card's name
and power limit, the SASS instruction mix of the level-0 instances
(``cuobjdump``, where the toolkit has it; modes 0 fwd, 1 bidir, 2 SGM), and per variant and shape the ms
per launch and the us per step. Needs one CUDA card and nvcc, and the
repository root as the working directory (shapes and inputs are those of
``chip_smoke.py``). The variants are text edits of the source, each of
which must match exactly once; ``tests/test_torch_sgm_scan.py`` checks
that they still do.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import statistics
import subprocess
from collections import Counter
from pathlib import Path

# (text in the source, its replacement): each must occur exactly once
ABLATIONS = {
    "as_is": [],
    "no_loads": [("    if (t + 1 < N) load();\n", "")],
    "no_stores": [("    if (active) {\n      float* on = out;",
                   "    if (false) {\n      float* on = out;")],
    "no_barrier": [("    if constexpr (CLUSTER)\n      cg::this_cluster().sync();\n"
                    "    else if (!SGM || s != 0)\n      __syncthreads();\n", "")],
    "no_cluster_barrier": [("      cg::this_cluster().sync();\n    else if",
                            "      __syncthreads();\n    else if")],
    "no_dsmem": [("      up_row = cg::this_cluster().map_shared_rank(&edge[0][warps][0][0], rank - 1);",
                  "      up_row = &edge[0][warps][0][0];"),
                 ("      dn_row = cg::this_cluster().map_shared_rank(&edge[0][1][SIDES - 1][0], "
                  "rank + 1);", "      dn_row = &edge[0][1][SIDES - 1][0];")],
}
SHAPES = ("level0_sheared", "level0", "level4_sheared", "level4", "level0_x",
          "level0_y", "level0_1024", "level0_sheared_1024")


def _variant_sources(out_dir: Path, also):
    from visionworkbench_torch.ops import _build
    src = (_build.CSRC / "mgm_scan.cu").read_text()
    out = {}
    for name, edits in ABLATIONS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: {old!r} occurs {text.count(old)} times "
                                 "in mgm_scan.cu")
            text = text.replace(old, new)
        out[name] = out_dir / f"{name}.cu"
        out[name].write_text(text)
    for item in also:
        name, path = item.split("=", 1)
        out[name] = out_dir / f"{name}.cu"
        shutil.copy(path, out[name])
    return out


def _build_all(sources):
    """One nvcc per variant, all started together; {name: loaded library}."""
    from visionworkbench_torch.ops import _build, sgm_scan
    procs = {}
    for name, cu in sources.items():
        so = cu.with_suffix(".so")
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.flags("mgm_scan"), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed:\n{log}")
        libs[name] = sgm_scan._bind_mgm(ctypes.CDLL(str(so)))
    return libs


def _sass_mix(so: Path):
    """Instruction count and the commonest opcodes of the (2, 5)
    instances, from cuobjdump -sass."""
    from visionworkbench_torch.ops import _build
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        print("[ablation] cuobjdump not found: instruction mix not measured")
        return
    text = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    for func in re.split(r"\n\s*Function : ", text)[1:]:
        m = re.search(r"mgm_scan_kernelILi(\d+)ELi(\d+)ELi([012])ELb([01])E", func)
        if not m or (m[1], m[2]) != ("2", "5"):
            continue
        ops = Counter(re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                                 func))
        kind = ("fwd", "bidir", "sgm")[int(m[3])] + (", cluster" if m[4] == "1" else "")
        print(f"[ablation] SASS mgm_scan_kernel<2, 5, {kind}>: "
              f"{sum(ops.values())} instructions; "
              + ", ".join(f"{k} {v}" for k, v in ops.most_common(16)))


def main() -> int:
    import torch

    import chip_smoke as cs
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--also", action="append", default=[],
                    help="NAME=FILE.cu: another source of vw_mgm_scan")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("mgm_scan_ablation: needs a CUDA card")
    from visionworkbench_torch.ops import _build, sgm_scan
    out_dir = _build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = _build_all(_variant_sources(out_dir, args.also))
    print(cs._smi())
    _sass_mix(out_dir / "as_is.so")
    names = list(libs)
    for i, case in enumerate(cs.scan_cases()):
        if case["name"] not in SHAPES:
            continue
        inputs = cs._scan_inputs(case, "cuda", 300 + i)
        shape = case["shape"]
        which, variant = cs._scan_pick(case)
        # one block a line (threads), or a cluster a line (its launch)
        pick = (variant,) if which == "mgm_scan" else (None, variant)
        if which not in ("mgm_scan", "cluster_scan") or (
                which == "cluster_scan" and variant[0] != 1):
            raise SystemExit(f"{case['name']}: the wrapper picks {which} {variant}")
        fn = getattr(sgm_scan, f"_{case['kernel']}_cuda")
        times = {n: [] for n in names}
        try:        # the wrappers launch whichever library is loaded
            for name in names + names[::-1]:
                sgm_scan._mgm_lib = libs[name]
                times[name].append(cs._time_ms(
                    lambda: fn(*inputs, case["shifts"], cs.SGM_P1, cs.SGM_P2,
                               cs.SGM_BAD, *pick), reps=args.reps))
        finally:
            sgm_scan._mgm_lib = None
        for name in names:
            ms = statistics.median(times[name])
            print(f"[ablation] {case['kernel']} {case['name']} {shape} {name}: {ms:.4f} ms "
                  f"({', '.join(f'{t:.4f}' for t in times[name])}), "
                  f"{ms * 1e3 / shape[0]:.4f} us per step")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
