"""Frame time and device time of the port's driven frames on the card.

    python3 -m visionworkbench_torch.tools.frame_times [--reps 5] [--frames NAME ...]

Runs each named frame of ``chip_smoke.py`` (bm: the bench configuration;
config4: the bench frame with census 5x5 costs; ncc: with NCC costs;
calc3_ncc: config 3's NCC ``calc_disparity``; sgm, mgm: config 6 at 512^2;
calc_sgm, calc_mgm: ``calc_disparity_sgm`` at the 64x8 search on 256^2
without and with ``use_mgm``; mgm_1024: config 6's MGM pyramid at 1024^2;
cli_log: the correlate CLI's defaults on the bench pair -- 21x21, the LoG
prefilter, 5 levels, subpixel none)
and two single kernel launches (speckle_1024: the speckle stencil at level
0's 11x11 window on 1024^2; speckle_512: a coarse level's 3x3 on 512^2),
and prints, with the card's name and power limit, its median time between
CUDA events over ``--reps`` frames after two warm-up frames, and its
device time per frame from torch.profiler (the sum of every kernel's time
over three frames, divided by three). It calls only the package's public
entry points and ``chip_smoke.py``'s frame pairs, so it also runs against
an older checkout: copy it there and run it from that checkout's root, to
compare two trees in turns (parent, change, change, parent) in one call
(name the frames with ``--frames`` there: a checkout without the LoG
prefilter cannot run cli_log).
Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import sys


def _frames(dev):
    """{name: a call that runs one frame on ``dev``}."""
    import torch

    import chip_smoke as cs
    from visionworkbench_torch.math.bbox import BBox2i
    from visionworkbench_torch.ops.speckle import speckle_keep_mask
    from visionworkbench_torch.stereo.pyramid_correlation import pyramid_correlate
    from visionworkbench_torch.stereo.sgm import calc_disparity_sgm

    def t(a):
        return torch.as_tensor(a, device=dev)

    big = [t(a) for a in cs._make_pair(cs.H, cs.W)]
    small = [t(a) for a in cs._make_pair(cs.SGM_HW, cs.SGM_HW)]
    calc = [t(a) for a in cs._make_calc_pair(cs.CALC_HW, cs.CALC_HW)]
    calc3 = [t(a) for a in cs._calc3_pair()]

    def pyramid(pair, algo, search, kernel, **kw):
        return lambda: pyramid_correlate(*pair, BBox2i(*search), kernel_size=kernel,
                                         max_pyramid_levels=cs.LEVELS, tile_size=cs.TILE,
                                         stereo_algorithm=algo, subpixel="parabola",
                                         device=dev, **kw)

    def speckle(hw, half, min_match):
        code = cs._speckle_input(dict(h=hw, w=hw), dev, 200)
        return lambda: speckle_keep_mask(code, half, half, 3, min_match)

    def sgm_call(use_mgm):
        return lambda: calc_disparity_sgm(*calc, cs.CALC_SEARCH, kernel_size=5,
                                          cost_type="census", use_mgm=use_mgm,
                                          subpixel="parabola", device=dev)

    return {"bm": pyramid(big, "bm", cs.SEARCH, cs.KERNEL),
            "config4": pyramid(big, "bm", cs.SEARCH, cs.KERNEL, cost_type="census",
                               census_window=cs.CENSUS_WINDOW),
            "ncc": pyramid(big, "bm", cs.SEARCH, cs.KERNEL, cost_type="ncc"),
            "calc3_ncc": lambda: cs._calc3_run(*calc3, dev, "ncc"),
            "sgm": pyramid(small, "sgm", cs.SGM_SEARCH, (5, 5)),
            "mgm": pyramid(small, "mgm", cs.SGM_SEARCH, (5, 5)),
            "calc_sgm": sgm_call(False), "calc_mgm": sgm_call(True),
            "mgm_1024": pyramid(big, "mgm", cs.SGM_SEARCH, (5, 5)),
            "cli_log": lambda: cs._cli_run(*big, dev),
            "speckle_1024": speckle(cs.H, 5, 61), "speckle_512": speckle(cs.SGM_HW, 1, 2)}


def _device_ms(run, frames=3, tries=3):
    """Device time per frame: every CUDA kernel's time over ``frames``
    frames, by torch.profiler. The profiler may miss a short session (a
    single launch): tried ``tries`` times, then None (not measured)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(frames):
                run()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
        if total:
            return total / 1e3 / frames
    return None


def main() -> int:
    import torch

    import chip_smoke as cs
    frames = ("bm", "config4", "ncc", "calc3_ncc", "sgm", "mgm", "calc_sgm", "calc_mgm",
              "mgm_1024", "cli_log", "speckle_1024", "speckle_512")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--frames", nargs="+", choices=frames, default=list(frames))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("frame_times: needs a CUDA card")
    runs = _frames("cuda")
    print(cs._smi())
    for name in args.frames:
        ms = cs._time_ms(runs[name], reps=args.reps)
        # a speckle run is one short launch: profile more of them
        dev_ms = _device_ms(runs[name], frames=20 if name.startswith("speckle") else 3)
        print(f"[frame] {name}: {ms:.4f} ms, device "
              + ("not measured" if dev_ms is None else f"{dev_ms:.4f} ms"))
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
