"""The least time the card could take for one item's kernels: published
peaks and the work the algorithm needs, counted from the configuration, the
frame size and the pyramid arithmetic, never from which kernel ran.

The peaks and operation counts are the port's own measurement constants,
frozen here (their comments kept). A share of the roofline is the least
time, the larger of operations over the fp32 peak and bytes over the HBM
peak, over the measured device time; each input byte is counted read once
and each output byte written once.
"""

from __future__ import annotations

from typing import Tuple

from portbench.reference.pyramid import level_plan, max_levels

# Published H100 SXM peaks (NVIDIA's data sheet): HBM rate and fp32
# rate outside the tensor cores. int32 ALU work is counted at the fp32 rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# Least operations per pixel and candidate of a sweep with sliding window
# sums: cost (2), column running sum (2), row running sum (2); plus the
# best/worst update (2) for each searched (not ring) candidate.
SWEEP_OPS_BOX = 6
SWEEP_OPS_SELECT = 2
# Census: an xor and a popcount per code word and the adds joining the
# words, then the two running sums (4); computing the codes once per frame
# pixel: a compare and an or per sample position (two of each, ternary).
CENSUS_CODE_OPS = 2
# NCC per pixel and candidate: the product, the two running sums (4),
# lprec * rprec, the square root and the scale (3); each window energy
# (left per pixel, right per window position): square, the two running
# sums, the reciprocal.
SWEEP_OPS_NCC = 8
NCC_ENERGY_OPS = 6
# Per pixel and window neighbour of the speckle stencil: two field
# extracts, two differences, two abs, two compares, an and, an add.
SPECKLE_OPS = 10
# Per disparity cell, lane, step and path direction of an SGM scan: the
# separable 3x3 grid min (4), + P1, two mins, - min_prior, + cost (5), the
# absent-candidate compare and select (2), the min_prior reduction (1) and
# the sum into the output (1). An MGM step evaluates two path updates
# (2 x 10), averages them (add, multiply, floor), applies the guard (1) and
# forces absent candidates (2).
SCAN_OPS = 13
MGM_OPS = 26


def least_seconds(nbytes: float, ops: float) -> float:
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _plan(settings: dict, h: int, w: int, search) -> Tuple[list, int, int]:
    """(plan, kw, kh) of the pyramid the settings run on (h, w)."""
    sgm = settings.get("stereo_algorithm", "bm") != "bm"
    kw, kh = (int(v) for v in settings.get("kernel_size", (21, 21)))
    if sgm:
        kw = kh = int(settings.get("census_window", 5))
    s_w, s_h = int(search[2]), int(search[3])
    levels = max_levels(w, h, (kw, kh), s_w, s_h, int(settings.get("max_pyramid_levels", 5)))
    plan = level_plan(h, w, levels, s_w, s_h, int(settings.get("refine_window", 11)),
                      int(settings.get("sgm_search_buffer", 2)) if sgm else None)
    return plan, kw, kh


def _sweep_call(npx: int, base_px: int, match_px: int, tiles: int, sx: int, sy: int,
                cost: str) -> Tuple[float, float]:
    """(bytes, operations) of one sweep over ``npx`` output pixels: the two
    frames and the offsets read, disparities (2 x int32) and validity
    written."""
    nbytes = 4 * (base_px + match_px) + 8 * tiles + npx * (8 + 1)
    if cost == "ncc":
        ops = npx * (SWEEP_OPS_NCC + SWEEP_OPS_SELECT) * sx * sy
        ops += NCC_ENERGY_OPS * (npx + match_px)
    elif cost in ("abs", "sq"):
        ops = npx * (SWEEP_OPS_BOX + SWEEP_OPS_SELECT) * sx * sy
    else:
        raise ValueError(f"roofline: no sweep count for {cost!r}")
    return float(nbytes), float(ops)


def sweep_work(settings: dict, h: int, w: int, search) -> Tuple[float, float]:
    """(bytes, operations) of every block-matching sweep of one item: one a
    level, and the R->L pass at level 0 with the L<->R check."""
    if settings.get("stereo_algorithm", "bm") != "bm":
        return 0.0, 0.0
    plan, kw, kh = _plan(settings, h, w, search)
    t = int(settings.get("tile_size", 64))
    cost = settings.get("cost_type", "abs")
    s_w, s_h = int(search[2]), int(search[3])
    nbytes = ops = 0.0
    for level, s_w_l, s_h_l, sx, sy in plan:
        out_h, out_w = _cdiv(h, 1 << level), _cdiv(w, 1 << level)
        nty, ntx = _cdiv(out_h, t), _cdiv(out_w, t)
        lbh, lbw = nty * t + kh - 1, ntx * t + kw - 1
        b, o = _sweep_call(nty * ntx * t * t, lbh * lbw,
                           (lbh + s_h_l - 1) * (lbw + s_w_l - 1), nty * ntx, sx, sy, cost)
        nbytes, ops = nbytes + b, ops + o
        if level == 0 and float(settings.get("consistency_threshold", -1)) >= 0:
            rnty, rntx = _cdiv(out_h + s_h, t), _cdiv(out_w + s_w, t)
            rbh, rbw = rnty * t + kh - 1, rntx * t + kw - 1
            mx, my = s_w_l - 1, s_h_l - 1
            b, o = _sweep_call(rnty * rntx * t * t, rbh * rbw,
                               (rbh + sy - 1 + my) * (rbw + sx - 1 + mx), rnty * rntx,
                               sx, sy, cost)
            nbytes, ops = nbytes + b, ops + o
    return nbytes, ops


def scan_work(settings: dict, h: int, w: int, search) -> Tuple[float, float]:
    """(bytes, operations) of the SGM/MGM aggregation of one item: at every
    level, the eight path directions over every pixel and disparity cell
    of the level's tile grid, and over the R->L pass's grid at level 0
    with the L<->R check; the cost volume and the image read once, the
    summed volume written once."""
    algo = settings.get("stereo_algorithm", "bm")
    if algo == "bm":
        return 0.0, 0.0
    per = MGM_OPS if algo == "mgm" else SCAN_OPS
    plan, _, _ = _plan(settings, h, w, search)
    t = int(settings.get("tile_size", 64))
    s_w, s_h = int(search[2]), int(search[3])
    check = float(settings.get("consistency_threshold", -1)) >= 0
    nbytes = ops = 0.0
    for level, _, _, sx, sy in plan:
        out_h, out_w = _cdiv(h, 1 << level), _cdiv(w, 1 << level)
        grids = [(out_h, out_w)] + ([(out_h + s_h, out_w + s_w)]
                                    if level == 0 and check else [])
        for gh, gw in grids:
            px = _cdiv(gh, t) * t * _cdiv(gw, t) * t
            cells = sx * sy
            nbytes += 4.0 * px * (2 * cells + 1)
            ops += float(per) * 8 * px * cells
    return nbytes, ops


# The program's kernels that do each counted kind of work, by name.
KERNELS = {"sweep": ("band_sweep_kernel", "band_census_kernel", "sweep_kernel"),
           "scan": ("mgm_scan_kernel", "cluster_wide_kernel", "path_scan_kernel",
                    "line_scan_kernel")}


def traced_share(ctx, kind: str):
    """The least time of the traced items' ``kind`` of work over the
    measured device time of the kernels that did it, in %; None where no
    such kernel ran or the configuration does no such work."""
    tr = ctx["trace"]
    if tr is None:
        return None
    tm = ctx["tracemod"]
    ns = sum(op.end_ns - op.start_ns for op in tr.device_ops
             if tm.kernel_matches(op, KERNELS[kind]))
    cell = ctx["cell"]
    traffic = cell["workload"]["traffic"]
    work = sweep_work if kind == "sweep" else scan_work
    nbytes, ops = work(cell["config"]["settings"], int(traffic["height"]),
                       int(traffic["width"]), cell["workload"]["search"])
    if ns <= 0 or ops <= 0:
        return None
    return 100.0 * least_seconds(nbytes, ops) * tr.items / (ns / 1e9)
