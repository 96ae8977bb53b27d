"""What each part of the MGM cluster kernel costs on the card.

    python3 -m visionworkbench_torch.tools.mgm_cluster_ablation [--reps 10]

Builds ``visionworkbench_torch/csrc/mgm_cluster_scan.cu`` as it is and with
one part taken out or changed at a time, and times each variant with CUDA
events, in turns (v0, v1, ..., vk, vk, ..., v0), at the shapes
``chip_smoke.py`` runs on it: ``calc_disparity_sgm(use_mgm=True)``'s scans at
the 64x8 search on 256^2 (``cluster_wide_kernel``, 16 blocks a cluster), at
the launch the wrapper picks. (Config 6's level 0 at 1024^2 runs
``csrc/mgm_scan.cu``'s kernel over a cluster: ``tools/mgm_scan_ablation.py``
takes its parts out.) A variant with a part taken out computes wrong
values; only its time counts, and the difference to ``as_is`` is what that
part costs:

  no_cluster_barrier  the cluster barrier of a step becomes a block barrier
                      (the reads of the neighbour blocks' rows race)
  no_dsmem            the block's edge lanes store into their own block's
                      halo, not the neighbour's (no distributed shared
                      memory access)
  no_stores           no step is stored or added into the output
  plain_stores        mgm_bidir stores its steps instead of adding them
                      (the time of storing once)
  no_staging          the slab is staged for the first step only
  no_grid             the 3x3 grid min reads no neighbour

Prints the card's name and power limit, and per variant and shape the ms
per launch and the us per step. Needs one CUDA card and nvcc, and the
repository root as the working directory. The variants are text edits of
the source, each of which must match exactly once;
``tests/test_torch_sgm_scan.py`` checks that they still do.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
from pathlib import Path

# (text in the source, its replacement): each must occur exactly once
ABLATIONS = {
    "as_is": [],
    "no_cluster_barrier": [
        ("    cluster.sync();  // the rows are posted", "    __syncthreads();  // the rows "
         "are posted")],
    "no_dsmem": [
        ("cluster.map_shared_rank(halo + cur * 2 * rs, rank + 1)",
         "halo + cur * 2 * rs"),
        ("cluster.map_shared_rank(halo + (cur * 2 + 1) * rs, rank - 1)",
         "halo + (cur * 2 + 1) * rs")],
    "no_stores": [("    if (s_in) {\n      float* dst = out0", "    if (false) {\n"
                   "      float* dst = out0")],
    "plain_stores": [("            atomicAdd(dst, src[T * r * ss]);",
                      "            __stcs(dst, src[T * r * ss]);")],
    "no_staging": [("    if (t + 1 < N) stage(t + 1, cur ^ 1);\n", "")],
    "no_grid": [("      if (a.sy > 1 && j + T * i < cells)\n", "      if (false)\n"),
                ("        if (sx > 1) r =", "        if (false) r =")],
}
SHAPES = ("calc", "calc_sheared")


def _variant_sources(out_dir: Path):
    from visionworkbench_torch.ops import _build
    src = (_build.CSRC / "mgm_cluster_scan.cu").read_text()
    out = {}
    for name, edits in ABLATIONS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: {old!r} occurs {text.count(old)} times "
                                 "in mgm_cluster_scan.cu")
            text = text.replace(old, new)
        out[name] = out_dir / f"{name}.cu"
        out[name].write_text(text)
    return out


def _build_all(sources):
    """One nvcc per variant, all started together; {name: loaded library}."""
    from visionworkbench_torch.ops import _build, sgm_scan
    procs = {}
    for name, cu in sources.items():
        so = cu.with_suffix(".so")
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.flags("mgm_cluster_scan"), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed:\n{log}")
        libs[name] = sgm_scan._bind_cluster(ctypes.CDLL(str(so)))
    return libs


def main() -> int:
    import torch

    import chip_smoke as cs
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("mgm_cluster_ablation: needs a CUDA card")
    from visionworkbench_torch.ops import _build, sgm_scan
    out_dir = _build.BUILD_DIR / "cluster_ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = _build_all(_variant_sources(out_dir))
    print(cs._smi())
    names = list(libs)
    for i, case in enumerate(cs.scan_cases()):
        if case["name"] not in SHAPES:
            continue
        inputs = cs._scan_inputs(case, "cuda", 300 + i)
        shape = case["shape"]
        which, variant = cs._scan_pick(case)
        if which != "cluster_scan":
            raise SystemExit(f"{case['name']}: the wrapper picks {which}")
        fn = getattr(sgm_scan, f"_{case['kernel']}_cuda")
        times = {n: [] for n in names}

        def run():
            return fn(*inputs, case["shifts"], cs.SGM_P1, cs.SGM_P2, cs.SGM_BAD, None,
                      variant)

        try:        # the wrapper launches whichever library is loaded
            for name in names + names[::-1]:
                sgm_scan._cluster_lib = libs[name]
                times[name].append(cs._time_ms(run, reps=args.reps))
        finally:
            sgm_scan._cluster_lib = None
        for name in names:
            ms = statistics.median(times[name])
            print(f"[ablation] {case['kernel']} {case['name']} {shape} {variant} {name}: "
                  f"{ms:.4f} ms ({', '.join(f'{t:.4f}' for t in times[name])}), "
                  f"{ms * 1e3 / shape[0]:.4f} us per step")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
