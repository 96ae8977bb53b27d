"""What each part of the path-line SGM kernel costs on the card.

    python3 -m visionworkbench_torch.tools.path_scan_ablation [--reps 20]

Builds ``visionworkbench_torch/csrc/sgm_path_scan.cu`` as it is and with one
part taken out or changed at a time, and times each variant with CUDA
events, in turns (v0, v1, ..., vk, vk, ..., v0), at ``calc_disparity_sgm``'s
x- and y-scan as ``chip_smoke.py`` makes them ((256, 8, 64, 256), shifts
(0, +1, -1) and (0,)), at the lines a block the wrapper picks. A variant
with a part taken out computes wrong values; only its time counts, and the
difference to ``as_is`` is what that part costs:

  no_atomics  no step is added into the output
  no_staging  the slab is staged for the first step only
  no_grid     no 3x3 grid min: the neighbours are not read
  no_barrier  the barrier between a step's arithmetic and its atomics is
              dropped (the atomics race the arithmetic)
  no_compute  no line computes a step: the slab is staged and added as it is
  float4_atomics  the output added with float4 / float2 atomics where the
              lanes allow, one cell row a thread (right values)
  set_order   the diagonal sets' blocks run set after set, not interleaved
              (right values)
  all_steps   every block runs all N steps (right values: the steps outside
              the frame only stage zeros), so that all blocks of a group
              walk the same rows at the same time

Prints the card's name and power limit, and per variant and shape the ms
per launch and the us per step; fails if a variant marked "right values"
(``SAME_OUTPUT``) gives another output than ``as_is``. Needs one CUDA card and nvcc, and the
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

# The slab's atomic adds as they are (one float a thread, 8 lanes of a cell
# row a 32-byte sector), and with float4 / float2 adds where 4 / 2 lanes of
# a cell row are aligned and in the frame (one cell row a thread).
FLOAT_ADDS = """      if (ol >= 0 && ol < L) {
        float* dst = a.out + n * row_n + first_cell + ol;
        const float* const src = slab + (cur * G + sg) * cp + sc0;
#pragma unroll
        for (int r = 0; r < K; ++r, dst += warp_cells)
          if (sc0 + 32 * r < cells) atomicAdd(dst, src[32 * r]);
      }
"""
FLOAT4_ADDS = """      const int lb = k0 + s * t, a0 = max(lb, 0), a1 = min(lb + G, L);
      const float* const sl = slab + cur * G * cp;
      for (int c = tid; c < cells; c += 32 * G) {
        float* const o = a.out + n * row_n + (long long)c * L;
        for (int l = a0; l < a1;) {
          const int g = l - lb;
          if ((L & 3) == 0 && (l & 3) == 0 && l + 4 <= a1) {
            atomicAdd(reinterpret_cast<float4*>(o + l),
                      make_float4(sl[g * cp + c], sl[(g + 1) * cp + c],
                                  sl[(g + 2) * cp + c], sl[(g + 3) * cp + c]));
            l += 4;
          } else if ((L & 1) == 0 && (l & 1) == 0 && l + 2 <= a1) {
            atomicAdd(reinterpret_cast<float2*>(o + l),
                      make_float2(sl[g * cp + c], sl[(g + 1) * cp + c]));
            l += 2;
          } else {
            atomicAdd(o + l, sl[g * cp + c]);
            ++l;
          }
        }
      }
"""

# (text in the source, its replacement): each must occur exactly once
ABLATIONS = {
    "as_is": [],
    "no_atomics": [("if (sc0 + 32 * r < cells) atomicAdd(dst, src[32 * r]);",
                    "if (false) atomicAdd(dst, src[32 * r]);")],
    "no_staging": [("    if (t + 1 < t_hi) stage(t + 1, cur ^ 1);\n", "")],
    "no_grid": [("          if (a.sy > 1)\n", "          if (false)\n"),
                ("          if (sx > 1) r =", "          if (false) r =")],
    "no_barrier": [("    __syncthreads();  // every line's step t is in the slab\n", "")],
    "no_compute": [("    if (lane >= 0 && lane < L) {  // uniform in the warp\n",
                    "    if (false) {\n")],
    "float4_atomics": [(FLOAT_ADDS, FLOAT4_ADDS)],
    "set_order": [("    e = pick(a.diag, m % a.n_diag);\n    jb = m / a.n_diag;\n",
                   "    e = pick(a.diag, m / a.nb_diag);\n    jb = m % a.nb_diag;\n")],
    "all_steps": [("  if (s > 0) {\n    t_lo", "  if (false) {\n    t_lo"),
                  ("  } else if (s < 0) {\n    t_lo", "  } else if (false) {\n    t_lo")],
}
# the variants that compute the same output: checked equal to as_is's
SAME_OUTPUT = ("float4_atomics", "set_order", "all_steps")
SHAPES = ("calc_x", "calc_y")


def _variant_sources(out_dir: Path):
    from visionworkbench_torch.ops import _build
    src = (_build.CSRC / "sgm_path_scan.cu").read_text()
    out = {}
    for name, edits in ABLATIONS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: {old!r} occurs {text.count(old)} times "
                                 "in sgm_path_scan.cu")
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
            [_build._nvcc(), *_build.flags("sgm_path_scan"), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed:\n{log}")
        libs[name] = sgm_scan._bind_path(ctypes.CDLL(str(so)))
    return libs


def main() -> int:
    import torch

    import chip_smoke as cs
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("path_scan_ablation: needs a CUDA card")
    from visionworkbench_torch.ops import _build, sgm_scan
    out_dir = _build.BUILD_DIR / "path_ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = _build_all(_variant_sources(out_dir))
    print(cs._smi())
    names = list(libs)
    for i, case in enumerate(cs.scan_cases()):
        if case["name"] not in SHAPES:
            continue
        inputs = cs._scan_inputs(case, "cuda", 300 + i)
        shape = case["shape"]
        path = cs._scan_pick(case)[1]
        times = {n: [] for n in names}

        def run():
            return sgm_scan._scan_bidir_cuda(*inputs, case["shifts"], cs.SGM_P1,
                                             cs.SGM_P2, cs.SGM_BAD, None, path)

        try:        # the wrapper launches whichever library is loaded
            sgm_scan._path_lib = libs["as_is"]
            ref = run()
            for name in SAME_OUTPUT:
                sgm_scan._path_lib = libs[name]
                if not torch.equal(run(), ref):
                    raise SystemExit(f"{name}: output differs from as_is at {case['name']}")
            for name in names + names[::-1]:
                sgm_scan._path_lib = libs[name]
                times[name].append(cs._time_ms(run, reps=args.reps))
        finally:
            sgm_scan._path_lib = None
        for name in names:
            ms = statistics.median(times[name])
            print(f"[ablation] scan_bidir {case['name']} {shape} lines {path[1]} {name}: "
                  f"{ms:.4f} ms ({', '.join(f'{t:.4f}' for t in times[name])}), "
                  f"{ms * 1e3 / shape[0]:.4f} us per step")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
