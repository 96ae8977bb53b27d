"""What each part of the census band kernel costs on the card.

    python3 -m visionworkbench_torch.tools.sweep_census_ablation [--reps 10]

Builds ``visionworkbench_torch/csrc/sweep.cu`` as it is and with one part of
``band_census_kernel`` taken out at a time, and measures the device time of
one launch of each variant (torch.profiler), in turns (v0, v1, ..., vk, vk,
..., v0), at every census shape of ``chip_smoke.py``'s sweep phase (config
4's levels 4 to 0 with the ring and its R->L pass, ternary 7x7, tile 128).
A variant with a part taken out computes wrong values; only its time
counts, and the difference to ``as_is`` is what that part costs:

  no_codes   each code is the staged pixel itself (staging kept)
  no_column  no column pass (the row pass reads stale sums)
  no_row     no row pass (every window sum is its pixel's index)
  no_sweep   no candidate of the search window runs

At the ring shapes ``no_row`` and ``no_column`` also change the winners,
and with them the patch pass's work: read those at the shapes without a
ring. Prints the card's name and power limit, each variant's registers and
spills, and per variant and shape the device ms per launch. Needs one CUDA
card and nvcc, and the repository root as the working directory (shapes and
inputs are those of ``chip_smoke.py``). The variants are text edits of the
kernel's body, each of which must match there exactly once;
``tests/test_torch_census_sweep.py`` checks that they still do.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
from pathlib import Path

# (text in band_census_kernel's body, its replacement): each must occur
# there exactly once
ABLATIONS = {
    "as_is": [],
    "no_codes": [("pixel_code<W>(QL + (r + rad) * lpw + c + rad, a.pat, offL)",
                  "W(QL[(r + rad) * lpw + c + rad])"),
                 ("pixel_code<W>(QR + (r + rad) * rpw + c + rad, a.pat, offR)",
                  "W(QR[(r + rad) * rpw + c + rad])")],
    "no_column": [("      if (colt)\n        census_columns<NW, K>(lv, L + tid, lw, "
                   "R + ey * rw + ex + tid, rw, kh, Cb + tid, cs);\n"
                   "      __syncthreads();\n      if (rowt) {",
                   "      __syncthreads();\n      if (rowt) {")],
    "no_row": [("        census_windows<K>(Cb + o * cs + x0, kw, s);\n        const int cand",
                "        for (int q = 0; q < kSeg; ++q) s[q] = q;\n        const int cand")],
    "no_sweep": [("  for (int ey = ring; ey < ring + sy; ++ey) {\n"
                  "    for (int ex = ring; ex < ring + sx; ++ex, ++k) {",
                  "  for (int ey = ring; ey < ring; ++ey) {\n"
                  "    for (int ex = ring; ex < ring + sx; ++ex, ++k) {")],
}
_BODY_START = "band_census_kernel(const CensusBandArgs a) {"
_BODY_END = "cudaError_t launch_census("


def _variant_sources(out_dir: Path):
    """{variant: path of its sweep.cu}, each edit applied inside the census
    band kernel's body."""
    from visionworkbench_torch.ops import _build
    src = (_build.CSRC / "sweep.cu").read_text()
    i, j = src.index(_BODY_START), src.index(_BODY_END)
    out = {}
    for name, edits in ABLATIONS.items():
        body = src[i:j]
        for old, new in edits:
            if body.count(old) != 1:
                raise SystemExit(f"{name}: {old!r} occurs {body.count(old)} times "
                                 "in band_census_kernel")
            body = body.replace(old, new)
        out[name] = out_dir / f"sweep_{name}.cu"
        out[name].write_text(src[:i] + body + src[j:])
    return out


def _build_all(sources):
    """One nvcc per variant, all started together; {name: (library,
    ptxas table)}."""
    import chip_smoke as cs
    from visionworkbench_torch.ops import _build
    procs = {}
    for name, cu in sources.items():
        so = cu.with_suffix(".so")
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.flags("sweep"), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed:\n{log}")
        libs[name] = (ctypes.CDLL(str(so)), cs._band_instances(cs._ptxas_table(log)))
    return libs


def main() -> int:
    import torch

    import chip_smoke as cs
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sweep_census_ablation: needs a CUDA card")
    from visionworkbench_torch.ops import _build, sweep
    out_dir = _build.BUILD_DIR / "census_ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = _build_all(_variant_sources(out_dir))
    print(cs._smi())
    for name, (_, band) in libs.items():
        print(f"[ablation] {name}: " + ", ".join(
            f"{key} {v['regs']} registers, {v['spill']} B spilled"
            for key, v in sorted(band.items()) if key[0].startswith("census")))
    names = list(libs)
    kw, kh = cs.KERNEL
    saved = _build._loaded.get("sweep")
    try:        # the wrapper launches whichever library is loaded
        for i, (key, c, cost, cw) in enumerate(cs.sweep_mode_cases()):
            if cost not in ("census", "ternary_census"):
                continue
            base, match, offs = cs._sweep_inputs(c, "cuda", 100 + i)
            call = (base, match, offs, c.get("tile", cs.TILE), c["sx"], c["sy"], kw, kh,
                    cost, bool(c["ring"]), cw, None, cs._band(c, cost, cw))
            times = {n: [] for n in names}
            for name in names + names[::-1]:
                _build._loaded["sweep"] = libs[name][0]
                sweep._lib = None
                times[name].append(cs._device_ms(lambda: sweep._sweep_cuda(*call),
                                                 reps=args.reps))
            for name in names:
                ts = [t for t in times[name] if t is not None]
                ms = f"{statistics.median(ts):.4f}" if ts else "not measured"
                print(f"[ablation] {key} {c['name']} {name}: device {ms} ms "
                      f"({', '.join('-' if t is None else f'{t:.4f}' for t in times[name])})")
    finally:
        if saved is None:
            _build._loaded.pop("sweep", None)
        else:
            _build._loaded["sweep"] = saved
        sweep._lib = None
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
