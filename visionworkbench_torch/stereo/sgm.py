"""Semi-global matching, SGM and MGM (port of
``visionworkbench_tpu/stereo/sgm.py``; ref ``SemiGlobalMatcher``,
``src/vw/Stereo/SGM.h:75-375``, ``SGM.cc``, ``SGMAssist.h:36-553``).

The reference semantics of the JAX package, kept here:

* census / ternary-census hamming costs over the 2D (dx, dy) search volume,
  with the reference's per-kernel default penalties (``SGM.cc:104-160``);
* the path update ``C + min(prior, min3x3(prior)+P1, min_prior+P2') -
  min_prior`` with ``P2' = max(P2 // max(|dI|, 1), P1)``; absent candidates
  carry ``bad = 255 + P2`` and are re-forced to it after every step;
* SGM: 8 directional line recurrences summed, as two bidirectional scans
  (the three dx=+1 paths batch into one x-scan, a diagonal being a one-lane
  shift of the carry, plus one y-scan); MGM: the 8 ``SmoothPathAccumTask``
  directions as one sheared forward scan (the four edge tasks, x' = x + y)
  plus two plain bidirectional scans (the diagonal task pairs);
* WTA with the reference's multiple-minimum smoothing cascade and the
  subpixel modes none/parabola/linear/poly4/cosine/lc_blend.

The scans run in ``ops/sgm_scan.py`` and the WTA with the subpixel step in
``ops/sgm_wta.py``: the CUDA kernels for tensors on the card, their plain
versions on the CPU. Everything else is plain tensor work. All arithmetic
is integer-valued fp32 below 2^24, so the port's integer winners equal the
JAX package's exactly; the subpixel fits agree to fp32 rounding. The
parabola fit runs in float64, as the C++ reference's does, where the JAX
package fits in fp32 (see ``ops/sgm_wta.py:_parabola_2d``).

Only the reference-semantics branch is ported: the JAX package's A/B knobs
(``VWTPU_SGM_EXACT_TIES``, ``VWTPU_SGM_ITER_COND``, ``VWTPU_SGM_TIE_STATS``,
``VWTPU_SGM_PALLAS``, ``VWTPU_SGM_UNROLL``) are not. The tie-smoothing
cascade runs without the JAX package's ``lax.cond(any tie)``: pixels whose
minimum is unique are frozen at iteration 0, so the result is the same and
no device-to-host sync is needed.
"""

from __future__ import annotations

from typing import Optional

import torch

from visionworkbench_torch.core.device import as_tensor, resolve_device
from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.core.profiling import span
from visionworkbench_torch.image.census import (
    census_transform, hamming_distance, ternary_census_transform,
)
from visionworkbench_torch.image.edge import crop_extended
from visionworkbench_torch.ops.sgm_scan import mgm_bidir, mgm_fwd, scan_bidir
from visionworkbench_torch.ops.sgm_wta import volume_argmin_subpixel
from visionworkbench_torch.stereo.correlation import DisparityMap

# Default penalties by (cost, census kernel size) (ref SGM.cc:104-160).
_P1_TABLE = {("census", 3): 3, ("census", 5): 15, ("census", 7): 30,
             ("census", 9): 20,
             ("ternary_census", 3): 12, ("ternary_census", 5): 30,
             ("ternary_census", 7): 40, ("ternary_census", 9): 40}
_P2_TABLE = {("census", 3): 70, ("census", 5): 750, ("census", 7): 1500,
             ("census", 9): 1000,
             ("ternary_census", 3): 600, ("ternary_census", 5): 1500,
             ("ternary_census", 7): 2000, ("ternary_census", 9): 2000}

SUBPIXEL_MODES = ("none", "parabola", "linear", "poly4", "cosine", "lc_blend")


def _bad_val(p2: float) -> float:
    """``get_bad_accum_val`` = CostType max + P2 (ref SGM.h:240)."""
    return 255.0 + float(p2)


def _census(img, window: int, ternary: bool, thresh: int):
    if ternary:
        return ternary_census_transform(img, window, thresh)
    return census_transform(img, window)


def _census_cost_volume(left_u8, right_u8, sx: int, sy: int, window: int,
                        ternary: bool, thresh: int):
    """(H, W, sy, sx) float32 hamming cost volume; the right codes are read
    at (dy, dx), the start clamped into the frame like ``lax.dynamic_slice``."""
    h, w = left_u8.shape
    lc = _census(left_u8, window, ternary, thresh)
    rc = _census(right_u8, window, ternary, thresh)
    rows = []
    for dy in range(sy):
        y0 = min(dy, rc.shape[0] - h)
        row = []
        for dx in range(sx):
            x0 = min(dx, rc.shape[1] - w)
            row.append(hamming_distance(lc, rc[y0:y0 + h, x0:x0 + w])
                       .to(torch.float32))
        rows.append(torch.stack(row, -1))
    return torch.stack(rows, -2)


def _shift_img(img, dy: int, dx: int):
    """Edge-extended shift: ``out[y, x] = img[y - dy, x - dx]``."""
    h, w = img.shape
    return crop_extended(img, -dx, -dy, w, h, mode="constant")


def _sgm_aggregate(cost, img, p1: float, p2: float, bad: float):
    """8-path SGM aggregation as two bidirectional batched scans (ref
    ``accum_sgm_multithread``, SGM.cc:2462-2612). ``cost`` (H, W, sy, sx);
    ``img`` integer-valued (H, W)."""
    cost_tx = cost.permute(1, 2, 3, 0).contiguous()        # (W, sy, sx, H)

    def pdx(dx):
        # (W, 3, H) for dy = 0, +1, -1 at the given dx predecessor offset
        pd = torch.stack([(img - _shift_img(img, dy, dx)).abs()
                          for dy in (0, 1, -1)], 0)         # (3, H, W)
        return pd.permute(2, 0, 1).contiguous()

    acc_x = scan_bidir(cost_tx, pdx(1), pdx(-1), (0, 1, -1), p1, p2, bad)
    del cost_tx
    cost_ty = cost.permute(0, 2, 3, 1).contiguous()        # (H, sy, sx, W)
    pd_d = (img - _shift_img(img, 1, 0)).abs()[:, None, :].contiguous()
    pd_u = (img - _shift_img(img, -1, 0)).abs()[:, None, :].contiguous()
    acc_y = scan_bidir(cost_ty, pd_d, pd_u, (0,), p1, p2, bad)
    return acc_x.permute(3, 0, 1, 2) + acc_y.permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# MGM: the reference's eight SmoothPathAccumTask directions
# (SGMAssist.h:835-1239), each averaging two prior-neighbour evaluations
# that share one pixel_diff (task_L diffs against the RIGHT neighbour).
#   L, R, T, B — sheared forward column scan (x' = x + y puts both causal
#                neighbours in column x' - 1), the four under axis flips
#   TL, BR     — both priors in the previous ROW: row scan
#   TR, BL     — both priors in the previous COLUMN: column scan
# ---------------------------------------------------------------------------


def _mgm_step_tensors(img, dir_xy, guard_expr, h, w):
    """Per-task pixel-diff map |img(p) - img(p - dir)| and guard mask."""
    pd = (img - _shift_img(img, dir_xy[1], dir_xy[0])).abs()
    r = torch.arange(h, dtype=torch.int32, device=img.device)[:, None].expand(h, w)
    c = torch.arange(w, dtype=torch.int32, device=img.device)[None, :].expand(h, w)
    return pd, guard_expr(r, c, h - 1, w - 1)


def _mgm_plain_scan(cost_t, pd_f, pd_r, g_f, g_r, p1, p2, bad):
    """Bidirectional previous-line MGM scan of a diagonal task pair.
    ``cost_t`` (N, sy, sx, L); pd/g (N, L). Returns the sum (N, sy, sx, L)."""
    return mgm_bidir(cost_t, pd_f.contiguous(), pd_r.contiguous(),
                     g_f.contiguous(), g_r.contiguous(), (1, -1), p1, p2, bad)


def _shear_rows(a, pad_value=0):
    """Skew ``a`` (B, H, W, ...) to (B, H, W+H, ...) with ``out[b, y, x'] =
    a[b, y, x' - y]`` (``pad_value`` outside): store rows at width S = W+H+1,
    re-view the flat buffer at width S-1 (a pad and a reshape, no gather)."""
    b, h, w = a.shape[:3]
    rest = tuple(a.shape[3:])
    s = w + h + 1
    p = torch.full((b, h, s) + rest, pad_value, dtype=a.dtype, device=a.device)
    p[:, :, :w] = a
    flat = p.reshape((b, h * s) + rest)
    return flat[:, :h * (s - 1)].reshape((b, h, s - 1) + rest)


def _unshear_rows(a, w: int):
    """Inverse skew: ``a`` (B, H, T=W+H, ...) -> (B, H, W, ...) with
    ``out[b, y, x] = a[b, y, x + y]`` (flat re-view at width T+1)."""
    b, h, t = a.shape[:3]
    rest = tuple(a.shape[3:])
    flat = torch.zeros((b, h * t + h) + rest, dtype=a.dtype, device=a.device)
    flat[:, :h * t] = a.reshape((b, h * t) + rest)
    return flat.reshape((b, h, t + 1) + rest)[:, :, :w]


def _mgm_sheared_scan(cb, pdb, gb, p1, p2, bad):
    """Sheared left+up MGM scan for B pre-flipped orientations. ``cb``
    (B, H, W, sy, sx); ``pdb``/``gb`` (B, H, W). Returns (B, H, W, sy, sx).
    Out-of-shear cells carry guard False (the shear pads False), so they
    never feed an inside cell."""
    w = cb.shape[2]
    cs = _shear_rows(cb, 0)                                  # (B, H, WW, ..)
    pds = _shear_rows(pdb, 0)
    gs = _shear_rows(gb, False)
    c_t = cs.permute(2, 0, 3, 4, 1).contiguous()             # (WW, B, sy, sx, H)
    p_t = pds.permute(2, 0, 1).contiguous()                  # (WW, B, H)
    g_t = gs.permute(2, 0, 1).contiguous()
    ys = mgm_fwd(c_t, p_t, g_t, (0, 1), p1, p2, bad)
    return _unshear_rows(ys.permute(1, 4, 0, 2, 3), w)       # (B, H, W, sy, sx)


def _mgm_aggregate(cost, img, p1: float, p2: float, bad: float):
    """All eight MGM direction tasks (ref accum_mgm_multithread,
    SGM.cc:2619-2700 + SGMAssist.h:911-1237), summed."""
    h, w, sy, sx = cost.shape
    # the four edge tasks L, T, B, R: the left+up recurrence under one of
    # the four axis-flip combinations, batched into ONE sheared scan
    #   orientation (flip_rows, flip_cols), pd dir, guard
    edge_tasks = [
        ((False, False), (-1, 0),
         lambda r, c, lr, lc: (r > 0) & (c > 0)),          # L
        ((False, True), (0, -1),
         lambda r, c, lr, lc: (r > 0) & (c < lc)),         # T
        ((True, False), (0, 1),
         lambda r, c, lr, lc: (r < lr) & (c > 0)),         # B
        ((True, True), (1, 0),
         lambda r, c, lr, lc: (r < lr) & (c < lc)),        # R
    ]

    def apply_flips(a, fl):
        dims = [d for d, f in enumerate(fl) if f]
        return a.flip(dims) if dims else a

    cbs, pdbs, gbs = [], [], []
    for fl, d, guard in edge_tasks:
        pd, g = _mgm_step_tensors(img, d, guard, h, w)
        cbs.append(apply_flips(cost, fl))
        pdbs.append(apply_flips(pd, fl))
        gbs.append(apply_flips(g, fl))
    out = _mgm_sheared_scan(torch.stack(cbs, 0), torch.stack(pdbs, 0),
                            torch.stack(gbs, 0), p1, p2, bad)
    total = torch.zeros_like(cost)
    for o, (fl, _, _) in enumerate(edge_tasks):
        total = total + apply_flips(out[o], fl)

    # TL (rows forward) and BR (rows reverse)
    pd_tl, g_tl = _mgm_step_tensors(
        img, (-1, -1), lambda r, c, lr, lc: (r > 0) & (c > 0) & (c < lc), h, w)
    pd_br, g_br = _mgm_step_tensors(
        img, (1, 1), lambda r, c, lr, lc: (r < lr) & (c > 0) & (c < lc), h, w)
    cost_ty = cost.permute(0, 2, 3, 1).contiguous()          # (H, sy, sx, W)
    out = _mgm_plain_scan(cost_ty, pd_tl, pd_br, g_tl, g_br, p1, p2, bad)
    total = total + out.permute(0, 3, 1, 2)

    # BL (columns forward) and TR (columns reverse)
    pd_bl, g_bl = _mgm_step_tensors(
        img, (-1, 1), lambda r, c, lr, lc: (r > 0) & (r < lr) & (c > 0), h, w)
    pd_tr, g_tr = _mgm_step_tensors(
        img, (1, -1), lambda r, c, lr, lc: (r > 0) & (r < lr) & (c < lc), h, w)
    cost_tx = cost.permute(1, 2, 3, 0).contiguous()          # (W, sy, sx, H)
    out = _mgm_plain_scan(cost_tx, pd_bl.T, pd_tr.T, g_bl.T, g_tr.T,
                          p1, p2, bad)
    return total + out.permute(3, 0, 1, 2)


def _apply_pixel_bounds(cost, base, seed_disp, seed_valid, buffer: int,
                        range_x: int, range_y: int, bad: float):
    """Per-pixel disparity bounds (ref ``m_disp_bound_image``, SGM.h:180-198,
    ``populate_disp_bound_image``, SGM.cc:241-470): pixels with a trusted
    seed keep only the candidates in ``seed +- buffer`` (clamped into the
    pixel's window); the others get ``bad``. Seeds that are invalid, or on
    the edge of a range of at least 10 (SGM.cc:372-384), are not trusted.
    ``cost`` (H, W, ry, rx); ``base`` (H, W, 2) absolute window origin."""
    ry, rx = cost.shape[-2], cost.shape[-1]
    sdx = torch.round(seed_disp[..., 0]).to(torch.int32)
    sdy = torch.round(seed_disp[..., 1]).to(torch.int32)
    on_edge = torch.zeros_like(seed_valid)
    if range_x >= 10:
        on_edge = on_edge | (sdx <= 0) | (sdx >= range_x - 1)
    if range_y >= 10:
        on_edge = on_edge | (sdy <= 0) | (sdy >= range_y - 1)
    trusted = seed_valid & ~on_edge
    bx, by = base[..., 0], base[..., 1]
    lo_x = torch.minimum(torch.maximum(sdx - buffer, bx), bx + rx - 1)
    hi_x = torch.minimum(torch.maximum(sdx + buffer, bx), bx + rx - 1)
    lo_y = torch.minimum(torch.maximum(sdy - buffer, by), by + ry - 1)
    hi_y = torch.minimum(torch.maximum(sdy + buffer, by), by + ry - 1)
    ax = bx[..., None] + torch.arange(rx, dtype=torch.int32, device=cost.device)
    ay = by[..., None] + torch.arange(ry, dtype=torch.int32, device=cost.device)
    ok_x = (ax >= lo_x[..., None]) & (ax <= hi_x[..., None])
    ok_y = (ay >= lo_y[..., None]) & (ay <= hi_y[..., None])
    allowed = (ok_y[..., :, None] & ok_x[..., None, :]) | ~trusted[..., None, None]
    return torch.where(allowed, cost, torch.full_like(cost, bad))


def _mask_cost_volume(cost, lmask, bad: float):
    """Masked left pixels get ZERO_SEARCH_AREA (every candidate absent)."""
    if lmask is None:
        return cost
    return torch.where(lmask.bool()[..., None, None], cost,
                       torch.full_like(cost, bad))


def _aggregate(cost, img, p1, p2, bad, use_mgm: bool):
    if use_mgm:
        return _mgm_aggregate(cost, img, p1, p2, bad)
    return _sgm_aggregate(cost, img, p1, p2, bad)


def _sgm_core(left_u8, right_u8, sx: int, sy: int, window: int, ternary: bool,
              thresh: int, p1: float, p2: float, use_mgm: bool, subpixel: str,
              seed_disp=None, seed_valid=None, search_buffer: int = 2,
              lmask=None):
    h, w = left_u8.shape
    bad = _bad_val(p2)
    cost = _census_cost_volume(left_u8, right_u8, sx, sy, window, ternary,
                               thresh)
    if seed_disp is not None:
        base = torch.zeros((h, w, 2), dtype=torch.int32, device=cost.device)
        cost = _apply_pixel_bounds(cost, base, seed_disp, seed_valid,
                                   search_buffer, sx, sy, bad)
    cost = _mask_cost_volume(cost, lmask, bad)
    acc = _aggregate(cost, left_u8.to(torch.float32), p1, p2, bad, use_mgm)
    fdisp = volume_argmin_subpixel(acc, subpixel, bad)
    valid = (torch.ones((h, w), dtype=torch.bool, device=cost.device)
             if lmask is None else lmask.bool())
    return torch.where(valid[..., None], fdisp, torch.zeros_like(fdisp)), valid


def sgm_relative_search(lbase, mbase, offsets, tile: int, rx: int, ry: int,
                        window: int, ternary: bool, thresh: int,
                        p1: float, p2: float, use_mgm: bool, subpixel: str,
                        seed_disp=None, seed_valid=None,
                        search_buffer: int = 2, range_x: int = 0,
                        range_y: int = 0, lmask=None):
    """Pyramid-level SGM: per-tile base offsets + a static relative window
    (ref ``m_disp_bound_image``, SGM.h:180-198, CorrelationView.cc SGM
    branch). Census costs are read at ``base(tile) + (0..ry) x (0..rx)`` and
    the whole level aggregates in one pass over the relative volume.

    ``lbase`` ((nty*tile + window - 1), (ntx*tile + window - 1)): level crop
    with the census half-window margins; ``mbase``: match frame with the
    same origin and the level's full search extent; ``offsets`` (nty, ntx,
    2) int32 absolute (dx, dy) per tile — each tile's window start is
    clamped into ``mbase`` like ``lax.dynamic_slice``. ``seed_disp`` /
    ``seed_valid`` ((H, W, 2) / (H, W)): per-pixel previous-level seeds that
    bound each pixel's candidates to ``seed +- search_buffer``; pixels
    masked by ``lmask`` come back invalid (ZERO_SEARCH_AREA). Returns (disp
    (H, W, 2) float32, absolute in the level frame; valid (H, W) bool).
    Its steps are the spans ``sgm.census`` (quantization and codes),
    ``sgm.volume`` (cost volume, seed bounds, mask), ``sgm.scans`` and
    ``sgm.wta`` (winner and subpixel)."""
    nty, ntx = int(offsets.shape[0]), int(offsets.shape[1])
    out_h, out_w = nty * tile, ntx * tile
    cw2 = window // 2
    bad = _bad_val(p2)
    dev = lbase.device
    with span("sgm.census"):
        # one shared monotone quantization, in the JAX package's op order
        lo = torch.minimum(lbase.min(), mbase.min())
        hi = torch.maximum(lbase.max(), mbase.max())
        extent = torch.clamp(hi - lo, min=1e-9)
        scale = torch.full_like(extent, 255.0) / extent      # the IEEE quotient
        lq = torch.clamp((lbase - lo) * scale, 0, 255).to(torch.int32)
        mq = torch.clamp((mbase - lo) * scale, 0, 255).to(torch.int32)
        lc = _census(lq, window, ternary, thresh)[cw2:cw2 + out_h, cw2:cw2 + out_w]
        rc = _census(mq, window, ternary, thresh)
        img = lq[cw2:cw2 + out_h, cw2:cw2 + out_w].to(torch.float32)

    with span("sgm.volume"):
        # Per-tile match windows, starts clamped into the code frame.
        wh, ww = tile + ry - 1, tile + rx - 1
        off = offsets.long()
        ty0 = torch.arange(nty, device=dev) * tile
        tx0 = torch.arange(ntx, device=dev) * tile
        y0 = (ty0[:, None] + cw2 + off[..., 1]).clamp(0, rc.shape[0] - wh)
        x0 = (tx0[None, :] + cw2 + off[..., 0]).clamp(0, rc.shape[1] - ww)
        win = rc[y0[..., None, None] + torch.arange(wh, device=dev)[:, None],
                 x0[..., None, None] + torch.arange(ww, device=dev)[None, :]]
        lt = lc.reshape(nty, tile, ntx, tile, -1).transpose(1, 2)   # (nty, ntx, t, t, nw)
        cost = torch.stack([
            torch.stack([hamming_distance(lt, win[:, :, j:j + tile, i:i + tile])
                         .to(torch.float32) for i in range(rx)], -1)
            for j in range(ry)], -2)                                # (nty, ntx, t, t, ry, rx)
        cost = cost.transpose(1, 2).reshape(out_h, out_w, ry, rx)
        base = (offsets.to(torch.int32).repeat_interleave(tile, 0)
                .repeat_interleave(tile, 1))                        # (H, W, 2)

        if seed_disp is not None:
            cost = _apply_pixel_bounds(cost, base, seed_disp, seed_valid,
                                       search_buffer, range_x, range_y, bad)
        cost = _mask_cost_volume(cost, lmask, bad)
    with span("sgm.scans"):
        acc = _aggregate(cost, img, p1, p2, bad, use_mgm)
    with span("sgm.wta"):
        rel = volume_argmin_subpixel(acc, subpixel, bad)
        valid = (torch.ones((out_h, out_w), dtype=torch.bool, device=dev)
                 if lmask is None else lmask.bool())
        disp = rel + base.to(torch.float32)
        return torch.where(valid[..., None], disp, torch.zeros_like(disp)), valid


def default_penalties(cost_type: str, window: int, p1=None, p2=None):
    """(P1, P2): the given penalties, or the reference's defaults for the
    cost and census window (ref SGM.cc:104-160)."""
    key = (cost_type, int(window))
    return (float(p1 if p1 is not None else _P1_TABLE.get(key, 3)),
            float(p2 if p2 is not None else _P2_TABLE.get(key, 70)))


def calc_disparity_sgm(left, right, search_volume, kernel_size: int = 5,
                       cost_type: str = "census", use_mgm: bool = False,
                       subpixel: str = "parabola",
                       p1: Optional[float] = None, p2: Optional[float] = None,
                       ternary_census_threshold: int = 2,
                       left_mask=None, right_mask=None,
                       memory_limit_mb: int = 6000,
                       band_overlap: int = 32,
                       prev_disparity: Optional[DisparityMap] = None,
                       search_buffer: int = 2,
                       device=None) -> DisparityMap:
    """SGM/MGM disparity (ref ``calc_disparity_sgm``, SGM.cc:167-229), with
    the JAX package's signature plus ``device`` (``None`` = the card).

    ``left``: (H, W) f32 in [0, 1]; ``right``: (H+sy-1, W+sx-1). Returns
    float disparities in [0, sx) x [0, sy), left-image frame.
    ``prev_disparity``: optional half-resolution seed (a port
    :class:`DisparityMap`) bounding each pixel's search to ``2 * prev +-
    search_buffer``; pixels whose ``left_mask`` is 0 come back invalid.
    ``memory_limit_mb`` bands the frame like the reference's
    ``m_memory_limit_mb`` (SGM.h:167), each band with ``band_overlap`` rows
    of context. ``right_mask`` is accepted for the JAX signature and unused,
    as there."""
    sx, sy = int(search_volume[0]), int(search_volume[1])
    if sx < 1 or sy < 1:
        raise ArgumentErr("calc_disparity_sgm: search volume must be >= 1")
    if subpixel not in SUBPIXEL_MODES:
        raise ArgumentErr(f"unknown SGM subpixel mode {subpixel!r}")
    if cost_type not in ("census", "ternary_census"):
        raise ArgumentErr("SGM supports census / ternary_census costs")
    ternary = cost_type == "ternary_census"
    p1v, p2v = default_penalties(cost_type, kernel_size, p1, p2)
    dev = resolve_device(device)
    left = as_tensor(left, torch.float32, dev)
    right = as_tensor(right, torch.float32, dev)
    h, w = left.shape
    if tuple(right.shape) != (h + sy - 1, w + sx - 1):
        raise ArgumentErr(f"calc_disparity_sgm: right must be "
                          f"{(h + sy - 1, w + sx - 1)}, got {tuple(right.shape)}")
    lq = torch.clamp(left * 255.0, 0, 255).to(torch.int32)
    rq = torch.clamp(right * 255.0, 0, 255).to(torch.int32)

    seed_disp = seed_valid = None
    if prev_disparity is not None:
        from visionworkbench_torch.stereo.disparity import disparity_upsample
        up = disparity_upsample(DisparityMap(
            prev_disparity.disparity.to(device=dev, dtype=torch.float32),
            prev_disparity.valid.to(device=dev, dtype=torch.bool)))
        ch, cw = min(h, up.valid.shape[0]), min(w, up.valid.shape[1])
        seed_disp = torch.zeros((h, w, 2), dtype=torch.float32, device=dev)
        seed_valid = torch.zeros((h, w), dtype=torch.bool, device=dev)
        seed_disp[:ch, :cw] = up.disparity[:ch, :cw]
        seed_valid[:ch, :cw] = up.valid[:ch, :cw]

    # working-set estimate: ~4x the (H, W, sy, sx) f32 volume (MGM ~8x)
    vol_mb = h * w * sy * sx * 4 * (8 if use_mgm else 4) / 1e6
    n_bands = max(1, -(-int(vol_mb) // max(int(memory_limit_mb), 1)))
    lmask = None if left_mask is None else as_tensor(left_mask, torch.bool, dev)
    core = (sx, sy, int(kernel_size), ternary, int(ternary_census_threshold),
            p1v, p2v, bool(use_mgm), subpixel)
    if n_bands == 1:
        disp, valid = _sgm_core(lq, rq, *core, seed_disp, seed_valid,
                                   int(search_buffer), lmask)
    else:
        ov = int(band_overlap)
        bh = -(-h // n_bands)
        # uniform band shapes: edge-extend rows so every band reads
        # bh + 2*ov left rows and the matching right extent
        pad_bot = n_bands * bh - h
        lq_e = crop_extended(lq, 0, -ov, w, h + pad_bot + 2 * ov)
        rq_e = crop_extended(rq, 0, -ov, rq.shape[1],
                             rq.shape[0] + pad_bot + 2 * ov)

        def band_pad(a, fill):
            out = torch.full((h + pad_bot + 2 * ov,) + tuple(a.shape[1:]), fill,
                             dtype=a.dtype, device=dev)
            out[ov:ov + h] = a
            return out

        sd_e = None if seed_disp is None else band_pad(seed_disp, 0.0)
        sv_e = None if seed_valid is None else band_pad(seed_valid, False)
        lm_e = None if lmask is None else band_pad(lmask, True)
        parts, vparts = [], []
        for b in range(n_bands):
            rows = slice(b * bh, b * bh + bh + 2 * ov)

            def bslice(a):
                return None if a is None else a[rows]

            d, v = _sgm_core(lq_e[rows], rq_e[b * bh:b * bh + bh + 2 * ov + sy - 1],
                                *core, bslice(sd_e), bslice(sv_e),
                                int(search_buffer), bslice(lm_e))
            parts.append(d[ov:ov + bh])
            vparts.append(v[ov:ov + bh])
        disp = torch.cat(parts, 0)[:h]
        valid = torch.cat(vparts, 0)[:h]
    return DisparityMap(torch.where(valid[..., None], disp, torch.zeros_like(disp)),
                        valid)


def sgm_reference_region(left_u8, right_u8, search_volume, kernel_size: int = 5,
                         cost_type: str = "census", use_mgm: bool = False,
                         subpixel: str = "lc_blend",
                         p1: Optional[float] = None,
                         p2: Optional[float] = None,
                         ternary_census_threshold: int = 5,
                         allowed=None, device=None):
    """Reference-domain SGM/MGM entry (ref ``semi_global_matching_func``,
    SGM.cc:2387-2448): census over the full u8 frames, cost volume and
    aggregation over exactly the kernel+search-supported region ``[hk,
    H-1-hk] x [hk, ...]`` whose paths start at the region border.
    ``search_volume`` is max-exclusive; ``allowed`` an optional per-pixel
    candidate mask (rows, cols, sy, sx). Returns (DisparityMap over the
    region, (min_row, min_col) region offset into the left frame)."""
    sx, sy = int(search_volume[0]), int(search_volume[1])
    window = int(kernel_size)
    ternary = cost_type == "ternary_census"
    p1v, p2v = default_penalties(cost_type, window, p1, p2)
    dev = resolve_device(device)
    hk = window // 2
    lq = as_tensor(left_u8, torch.int32, dev)
    rq = as_tensor(right_u8, torch.int32, dev)
    h, w = lq.shape
    min_row = min_col = hk
    max_row = min(h - 1 - hk, rq.shape[0] - 1 - hk - (sy - 1))
    max_col = min(w - 1 - hk, rq.shape[1] - 1 - hk - (sx - 1))
    bad = _bad_val(p2v)
    vol = _census_cost_volume(lq, rq, sx, sy, window, ternary,
                              int(ternary_census_threshold))
    vol = vol[min_row:max_row + 1, min_col:max_col + 1]
    if allowed is not None:
        allowed = as_tensor(allowed, torch.bool, dev)
        vol = torch.where(allowed, vol, torch.full_like(vol, bad))
    img = lq[min_row:max_row + 1, min_col:max_col + 1].to(torch.float32)
    acc = _aggregate(vol, img, p1v, p2v, bad, use_mgm)
    fdisp = volume_argmin_subpixel(acc, subpixel, bad)
    if allowed is not None:
        valid = allowed.reshape(fdisp.shape[0], fdisp.shape[1], -1).any(-1)
    else:
        valid = torch.ones(fdisp.shape[:2], dtype=torch.bool, device=dev)
    fdisp = torch.where(valid[..., None], fdisp, torch.zeros_like(fdisp))
    return DisparityMap(fdisp, valid), (min_row, min_col)
