"""Fully sharded hierarchical correlator, row bands at every pyramid level
(port of ``visionworkbench_tpu/parallel/hierarchical.py``) on
``torch.distributed``.

``tile_sharding.sharded_pyramid_correlate`` gives each rank a collar the
size of the correlator's whole receptive field (O(2^levels) rows) and
recomputes the whole pyramid in it, the reference's per-tile prerasterize
(``CorrelationView.cc:100-230``). Here the pyramid itself is sharded: every
level lives as row bands over the ranks, and each step that needs vertical
context (the 5-tap downsample, the half-kernel correlation support, the
vertical search reach, the speckle filters, the prefilters) exchanges just
the rows it needs (``halo_exchange_rows``) at that level's resolution. No
work is replicated.

Level and tile frames are those of ``stereo/pyramid_correlation.py`` (the
monolithic engine), so interior results agree with it; global image edges
replicate edge rows as its ``crop_extended`` padding does. Every band sweep
calls ``ops/sweep.py:sweep`` (the CUDA kernel on the card, its plain version
on the CPU), every speckle pass ``ops/speckle.py``, every SGM/MGM
aggregation the scans of ``ops/sgm_scan.py``.

Feature parity with the monolithic engine: every BM cost, user masks (the
mean fill by a cross-band sum, banded 2-of-4 mask pyramids, the disparity
mask with exchanged target rows), the prefilters, the L<->R consistency
check (a banded reverse search and an exchange of the R->L rows), per-level
speckle cleanup, small-blob removal (exact: a blob below the area threshold
fits within that many rows of any of its pixels, so an area-sized halo
classifies the band's rows exactly), parabola subpixel (on the sweep's cost
patches, or by re-evaluation for NCC), and SGM/MGM with a tile-row collar.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from visionworkbench_torch.core.device import as_tensor
from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.image.edge import crop_extended
from visionworkbench_torch.image.morphology import remove_small_blobs
from visionworkbench_torch.math.bbox import BBox2i
from visionworkbench_torch.ops.sweep import sweep
from visionworkbench_torch.parallel.mesh import TILE_AXIS, axis_group, mesh_device
from visionworkbench_torch.parallel.tile_sharding import (
    all_gather_rows, halo_exchange_rows,
)
from visionworkbench_torch.stereo.correlation import (
    ABSOLUTE_DIFFERENCE, CROSS_CORRELATION, DisparityMap, check_cost_type,
)
from visionworkbench_torch.stereo.disparity import (
    cross_corr_consistency_check, disparity_cleanup_using_thresh,
    disparity_upsample, rm_outliers_using_thresh,
)
from visionworkbench_torch.stereo.prefilter import (
    PREFILTER_NONE, check_prefilter_mode, prefilter_image,
)
from visionworkbench_torch.stereo.pyramid_correlation import (
    _blur_downsample, _cdiv, _mask_downsample, _pad_to, _tile_offsets,
    _tile_offsets_centered, max_pyramid_levels_for,
)
from visionworkbench_torch.stereo.sgm import (
    SUBPIXEL_MODES, default_penalties, sgm_relative_search,
)
from visionworkbench_torch.stereo.subpixel import (
    MAX_SUBPIXEL_SHIFT, _fit_parabola, parabola_subpixel,
)


def _where_valid(disp, valid):
    return torch.where(valid[..., None], disp, torch.zeros_like(disp))


def _halo_cleanup(dm: DisparityMap, fhk: int, on_last: bool, mesh) -> DisparityMap:
    """Per-level speckle filter with ``fhk`` rows of exchanged context, so
    band-interior pixels see the monolithic filter's window."""
    pdm = DisparityMap(halo_exchange_rows(dm.disparity, fhk, fhk, mesh),
                       halo_exchange_rows(dm.valid, fhk, fhk, mesh))
    filt = rm_outliers_using_thresh if on_last else disparity_cleanup_using_thresh
    pdm = filt(pdm, fhk, fhk, 3.0, 0.5, integer_disparities=True)
    rows = slice(fhk, pdm.valid.shape[0] - fhk)
    return DisparityMap(pdm.disparity[rows], pdm.valid[rows])


def _band_mean_fill(img, mask, group):
    """Fill masked pixels with the frame's mean over its valid pixels (ref
    ``CorrelationView.cc:129-150``): each band's masked sum and count in
    float64, summed over the bands, divided once, so every world size and
    device gives the same fill."""
    part = torch.stack([torch.where(mask, img.double(), 0.0).sum(),
                        mask.sum().double()])
    dist.all_reduce(part, group=group)
    mean = (part[0] / part[1].clamp(min=1.0)).to(img.dtype)
    return torch.where(mask, img, mean)


def hierarchical_sharded_correlate(left, right, search_region: BBox2i,
                                   mesh,
                                   left_mask=None, right_mask=None,
                                   kernel_size: Tuple[int, int] = (21, 21),
                                   cost_type: str = ABSOLUTE_DIFFERENCE,
                                   consistency_threshold: float = -1.0,
                                   blob_filter_area: int = 0,
                                   prefilter_mode: str = PREFILTER_NONE,
                                   prefilter_width: float = 1.4,
                                   max_pyramid_levels: int = 5,
                                   filter_half_kernel: int = 5,
                                   tile_size: int = 64,
                                   refine_window: int = 11,
                                   census_window: int = 5,
                                   subpixel: str = "none",
                                   stereo_algorithm: str = "bm",
                                   sgm_search_buffer: int = 2) -> DisparityMap:
    """Distributed coarse-to-fine correlator with per-level halo exchange.

    ``left``/``right`` (and the masks) are whole (H, W) frames, the same on
    every rank (numpy arrays or tensors); each rank correlates its row band
    of the mesh's ``tile`` axis on the mesh's device. Same output contract
    as ``pyramid_correlate`` (absolute disparities, ``search_region.min``
    folded in). Returns the whole :class:`DisparityMap` on every rank,
    gathered once at the end (the JAX package returns a global array
    sharded by rows); a caller who wants only its band slices it with
    ``row_sharding(mesh)``. ``H`` must divide over the ranks; the pyramid
    depth is clamped to the band's power-of-two divisibility.

    ``stereo_algorithm``: ``"bm"`` (block matching with any cost) or
    ``"sgm"``/``"mgm"`` (census of ``census_window``, ternary with
    ``cost_type="ternary_census"``; any SGM subpixel mode). In SGM/MGM mode
    each band runs census and 8-path aggregation over its rows plus
    ``tile_size`` rows of exchanged context a side, then crops: the
    reference's per-tile semantics (``SGM.cc:2462-2531``; paths truncate at
    the collar edge), so rows whose winners depend on path context deeper
    than ``tile_size`` rows may differ from the monolithic result. The
    L<->R check is not offered in SGM mode (the monolithic engine has it).
    """
    if stereo_algorithm not in ("bm", "sgm", "mgm"):
        raise ArgumentErr(f"unknown stereo_algorithm {stereo_algorithm!r}")
    sgm_mode = stereo_algorithm != "bm"
    if sgm_mode and consistency_threshold >= 0:
        raise ArgumentErr("hierarchical SGM/MGM does not offer the L<->R "
                          "consistency check; use the monolithic engine")
    if sgm_mode:
        if subpixel not in SUBPIXEL_MODES:
            raise ArgumentErr(f"unknown SGM subpixel mode {subpixel!r}")
    else:
        check_cost_type(cost_type, census_window)
        if subpixel not in ("none", "parabola"):
            raise ArgumentErr(f"unknown subpixel mode {subpixel!r}")
    check_prefilter_mode(prefilter_mode)
    dev = mesh_device(mesh)
    group, n, idx = axis_group(mesh, TILE_AXIS)
    left = as_tensor(left, torch.float32, dev)
    right = as_tensor(right, torch.float32, dev)
    h, w = left.shape
    if tuple(right.shape) != (h, w):
        raise ArgumentErr("hierarchical_sharded_correlate: left/right must "
                          "share a shape (fold extra right columns into "
                          "search_region)")
    has_masks = left_mask is not None or right_mask is not None
    lmask_in = (torch.ones((h, w), dtype=torch.bool, device=dev) if left_mask is None
                else as_tensor(left_mask, torch.bool, dev))
    rmask_in = (torch.ones((h, w), dtype=torch.bool, device=dev) if right_mask is None
                else as_tensor(right_mask, torch.bool, dev))
    if h % n != 0:
        raise ArgumentErr(f"rows {h} must divide over {n} devices")
    hb = h // n

    kw, kh = int(kernel_size[0]), int(kernel_size[1])
    if sgm_mode:
        # the census support drives the padding, as in the monolithic engine
        kw = kh = int(census_window)
        sgm_cost = "ternary_census" if cost_type == "ternary_census" else "census"
        sgm_p1, sgm_p2 = default_penalties(sgm_cost, census_window)
    if kw % 2 != 1 or kh % 2 != 1:
        raise ArgumentErr("kernel dimensions must be odd")
    half_kw, half_kh = kw // 2, kh // 2
    s_w, s_h = int(search_region.width), int(search_region.height)
    smin_x, smin_y = int(search_region.min_x), int(search_region.min_y)
    if s_w <= 0 or s_h <= 0:
        raise ArgumentErr("search region must be non-empty")

    levels = max_pyramid_levels_for(w, h, (kw, kh), search_region, max_pyramid_levels)
    # Subsample grids stay band-aligned: clamp the depth to the band's
    # power-of-two divisibility instead of failing.
    while levels > 0 and hb % (1 << levels) != 0:
        levels -= 1
    up = 1 << levels
    off_x = half_kw * up
    t = int(tile_size)
    # Stored-frame widths (column 0 = global column -off_x), as the
    # monolithic engine's left / right base frames.
    base_w = w + 2 * off_x
    base_w += (-base_w) % up + up
    rbase_w = base_w + s_w
    rbase_w += (-rbase_w) % up
    pf_halo = (int(7 * prefilter_width) // 2 + 2
               if prefilter_mode != PREFILTER_NONE else 0)
    # NCC has no patch mode: its parabola re-evaluates absolute costs
    use_patches = (subpixel == "parabola" and not sgm_mode
                   and cost_type != CROSS_CORRELATION)

    def halo(x, top, bottom):
        return halo_exchange_rows(x, top, bottom, mesh)

    def band_search(lbase_, mbase_, offsets_, sxe, sye, patches=False):
        return sweep(lbase_, mbase_, offsets_, t, sxe, sye, kw, kh, cost_type,
                     want_patches=patches, census_window=int(census_window))

    r0 = idx * hb
    lblock, rblock = left[r0:r0 + hb], right[r0:r0 + hb]
    # Full-resolution bands in the stored frames. The right band is the
    # search-origin-shifted frame: its row r is right row r + smin_y, its
    # column c right column c + smin_x - off_x.
    lband = crop_extended(lblock, -off_x, 0, base_w, hb, mode="constant")
    top, bot = max(-smin_y, 0), max(smin_y, 0)
    rrows = halo(rblock, top, bot)[top + smin_y:top + smin_y + hb]
    rband = crop_extended(rrows, smin_x - off_x, 0, rbase_w, hb, mode="constant")

    # Output-frame masks (ref CorrelationView.cc:195-199): the left over the
    # (h, w) band, the right zero-extended over the shifted (w + s_w) frame.
    lmask0 = lmask_in[r0:r0 + hb]
    rm_pad = halo(rmask_in[r0:r0 + hb], top, bot)
    rows_g = r0 - top + torch.arange(rm_pad.shape[0], device=dev)
    rm_pad = rm_pad & ((rows_g >= 0) & (rows_g < h))[:, None]
    rmask0 = crop_extended(rm_pad[top + smin_y:top + smin_y + hb], smin_x, 0,
                           w + s_w, hb, mode="zero")
    if has_masks:
        # the fill value is the GLOBAL valid mean, summed over the bands
        lband = _band_mean_fill(lband, crop_extended(lmask0, -off_x, 0, base_w, hb,
                                                mode="zero"), group)
        rband = _band_mean_fill(rband, crop_extended(rmask0, -off_x, 0, rbase_w, hb,
                                                mode="zero"), group)

    def level_filter(img):
        if prefilter_mode == PREFILTER_NONE:
            return img
        p = prefilter_image(halo(img, pf_halo, pf_halo), prefilter_mode, prefilter_width)
        return p[pf_halo:p.shape[0] - pf_halo]

    def down(x):
        # the 5-tap filter's 2-row support exchanged; band starts divide by
        # 2^level, so the global subsample grid is the monolithic one
        return _blur_downsample(halo(x, 2, 2))[1:1 + x.shape[0] // 2]

    lpyr, rpyr = [lband], [rband]
    lmask_pyr, rmask_pyr = [lmask0], [rmask0]
    for _ in range(levels):
        lpyr.append(down(lpyr[-1]))
        rpyr.append(down(rpyr[-1]))
        # 2x2 blocks never cross band edges: no exchange
        lmask_pyr.append(_mask_downsample(lmask_pyr[-1]))
        rmask_pyr.append(_mask_downsample(rmask_pyr[-1]))
    lpyr = [level_filter(im) for im in lpyr]
    rpyr = [level_filter(im) for im in rpyr]

    dm: Optional[DisparityMap] = None
    patches = None
    for level in range(levels, -1, -1):
        scaling = 1 << level
        on_last = level == 0
        s_w_l, s_h_l = max(s_w // scaling, 1), max(s_h // scaling, 1)
        band_l = hb // scaling
        out_w = _cdiv(w, scaling)
        region_off_x = off_x // scaling
        nty, ntx = _cdiv(band_l, t), _cdiv(out_w, t)
        row_pad = nty * t - band_l

        if sgm_mode:
            # Band + one tile row of exchanged context a side: interior
            # tiles see the monolithic tile grid's content; the aggregation
            # paths truncate at the collar edge (the reference's per-tile
            # semantics).
            ov = t if (band_l % t == 0 and band_l >= t) else 0
            nty_e = _cdiv(band_l + 2 * ov, t)
            pad_rows = nty_e * t - band_l - 2 * ov
            cw2 = kw // 2
            if level == levels:
                offsets = torch.zeros((nty_e, ntx, 2), dtype=torch.int32, device=dev)
                s_x_eff, s_y_eff = s_w_l, s_h_l
                seeds = (None, None)
            else:
                prior = disparity_upsample(dm)
                pr_d = halo(prior.disparity[:band_l, :out_w], ov, ov + pad_rows)
                pr_v = halo(prior.valid[:band_l, :out_w], ov, ov + pad_rows)
                pr_d = _pad_to(pr_d, pr_d.shape[0], ntx * t)
                pr_v = _pad_to(pr_v, pr_v.shape[0], ntx * t)
                rw_ = 2 * int(sgm_search_buffer) + 1
                s_x_eff, s_y_eff = min(rw_, s_w_l), min(rw_, s_h_l)
                offsets = _tile_offsets_centered(
                    pr_d, pr_v, t, int(sgm_search_buffer), s_w_l - s_x_eff,
                    s_h_l - s_y_eff, value_bounds=(s_w_l, s_h_l))
                seeds = (pr_d.to(torch.float32), pr_v)
            lbase = halo(lpyr[level], ov + cw2, ov + cw2 + pad_rows)
            mbase = halo(rpyr[level], ov + cw2, ov + cw2 + pad_rows + s_h_l - 1)
            lx0 = region_off_x - cw2
            lbw = ntx * t + kw - 1
            lbase = crop_extended(lbase, lx0, 0, lbw, lbase.shape[0], mode="constant")
            mbase = crop_extended(mbase, lx0, 0, lbw + s_w_l - 1, mbase.shape[0],
                                  mode="constant")
            lm_lvl = halo(lmask_pyr[level][:band_l, :out_w], ov, ov + pad_rows)
            lm_lvl = _pad_to(lm_lvl, lm_lvl.shape[0], ntx * t)
            disp, valid = sgm_relative_search(
                lbase, mbase, offsets, t, s_x_eff, s_y_eff, kw,
                sgm_cost == "ternary_census", 2, sgm_p1, sgm_p2,
                stereo_algorithm == "mgm", subpixel if on_last else "none",
                seed_disp=seeds[0], seed_valid=seeds[1],
                search_buffer=int(sgm_search_buffer), range_x=s_w_l,
                range_y=s_h_l, lmask=lm_lvl)
            dm = DisparityMap(disp[ov:ov + band_l, :out_w], valid[ov:ov + band_l, :out_w])
        else:
            if level == levels:
                offsets = torch.zeros((nty, ntx, 2), dtype=torch.int32, device=dev)
                s_x_eff, s_y_eff = s_w_l, s_h_l
            else:
                prior = disparity_upsample(dm)
                pr_d = _pad_to(prior.disparity[:band_l, :out_w], nty * t, ntx * t)
                pr_v = _pad_to(prior.valid[:band_l, :out_w], nty * t, ntx * t)
                s_x_eff = min(int(refine_window), s_w_l)
                s_y_eff = min(int(refine_window), s_h_l)
                offsets = _tile_offsets(pr_d, pr_v, t, 2, s_w_l - s_x_eff,
                                        s_h_l - s_y_eff)
            # vertical context exchanged, horizontal from the stored pad
            lx0 = region_off_x - half_kw
            lbw = ntx * t + kw - 1
            lbase = halo(lpyr[level], half_kh, half_kh + row_pad)
            lbase = crop_extended(lbase, lx0, 0, lbw, lbase.shape[0], mode="constant")
            if on_last and use_patches:
                # match origin shifted (-1, -1), +2 per axis: the ±1 ring
                mrows = halo(rpyr[level], half_kh + 1, half_kh + row_pad + s_h_l)
                mbase = crop_extended(mrows, lx0 - 1, 0, lbw + s_w_l + 1,
                                      mrows.shape[0], mode="constant")
                disp, valid, pat = band_search(lbase, mbase, offsets, s_x_eff,
                                               s_y_eff, patches=True)
                patches = tuple(pat[:, :band_l, :out_w].unbind(0))
            else:
                mrows = halo(rpyr[level], half_kh, half_kh + row_pad + s_h_l - 1)
                mbase = crop_extended(mrows, lx0, 0, lbw + s_w_l - 1, mrows.shape[0],
                                      mode="constant")
                disp, valid, _ = band_search(lbase, mbase, offsets, s_x_eff, s_y_eff)
            dm = DisparityMap(disp[:band_l, :out_w], valid[:band_l, :out_w])

        if on_last and consistency_threshold >= 0:
            # Banded L<->R check (ref CorrelationView.cc:653-695): the
            # reverse search with the right band as base, margins folded
            # into the offsets so every window start stays non-negative,
            # then the R->L rows the forward disparities reach exchanged.
            rl_out_w = out_w + s_w_l
            rntx = _cdiv(rl_out_w, t)
            eff = torch.tensor([s_x_eff - 1, s_y_eff - 1], dtype=torch.int32, device=dev)
            margin_x = s_x_eff - 1 + (s_w_l - s_x_eff)
            margin_y = s_y_eff - 1 + (s_h_l - s_y_eff)
            rl_origin = torch.tensor([margin_x, margin_y], dtype=torch.int32, device=dev)
            rl_offsets = (rl_origin - (_pad_to(offsets, nty, rntx) + eff)).contiguous()
            rbw = rntx * t + kw - 1
            rl_base = halo(rpyr[level], half_kh, half_kh + row_pad)
            rl_base = crop_extended(rl_base, lx0, 0, rbw, rl_base.shape[0], mode="constant")
            rl_match = halo(lpyr[level], margin_y + half_kh, half_kh + row_pad + s_y_eff - 1)
            rl_match = crop_extended(rl_match, lx0 - margin_x, 0,
                                     rbw + s_x_eff - 1 + margin_x, rl_match.shape[0],
                                     mode="constant")
            rl_disp, rl_valid, _ = band_search(rl_base, rl_match, rl_offsets,
                                               s_x_eff, s_y_eff)
            rl_disp = (rl_disp - rl_origin)[:band_l, :rl_out_w]
            rl_dm = DisparityMap(halo(rl_disp, 0, s_h_l),
                                 halo(rl_valid[:band_l, :rl_out_w], 0, s_h_l))
            dm = cross_corr_consistency_check(dm, rl_dm, consistency_threshold)

        if filter_half_kernel > 0:
            dm = _halo_cleanup(dm, int(filter_half_kernel), on_last, mesh)
            # The right-extent mask (the monolithic engine's disparity mask
            # against its zero-extended right mask pyramid): with no user
            # masks the level's mask is the 2-of-4 downsampled rectangle of
            # the true right image in the shifted frame, whose edges iterate
            # to floor / ceil of / 2^level, evaluated in global coordinates.
            r_lo, r_hi = max(-smin_y, 0) // scaling, -(-(h - smin_y) // scaling)
            c_lo, c_hi = max(-smin_x, 0) // scaling, -(-(w - smin_x) // scaling)
            g0 = idx * band_l
            rows_l = (torch.arange(band_l, device=dev)[:, None]
                      + dm.disparity[..., 1].to(torch.int32))
            cols_g = (torch.arange(out_w, device=dev)[None, :]
                      + dm.disparity[..., 0].to(torch.int32))
            rows_g = rows_l + g0
            valid2 = (dm.valid & (rows_g >= r_lo) & (rows_g < r_hi)
                      & (cols_g >= c_lo) & (cols_g < c_hi))
            if has_masks:
                # the user masks: the target row p + dy can land in the
                # next band's rows
                rm_ext = halo(rmask_pyr[level], 0, s_h_l)
                ry = rows_l.clamp(0, rm_ext.shape[0] - 1).long()
                rx = cols_g.clamp(0, rm_ext.shape[1] - 1).long()
                valid2 = valid2 & lmask_pyr[level][:band_l, :out_w] & rm_ext[ry, rx]
            dm = DisparityMap(_where_valid(dm.disparity, valid2), valid2)

        area = int(blob_filter_area) // scaling
        if blob_filter_area > 0 and area >= 1:
            # exact banded small-blob removal (module docstring)
            keep = remove_small_blobs(halo(dm.valid, area, area), area)[area:area + band_l]
            dm = DisparityMap(_where_valid(dm.disparity, keep), keep)

    smin = torch.tensor([smin_x, smin_y], dtype=dm.disparity.dtype, device=dev)
    final = DisparityMap(_where_valid(dm.disparity + smin, dm.valid), dm.valid)
    if use_patches:
        final = DisparityMap(_fit_parabola(patches, final.disparity, final.valid),
                             final.valid)
    elif subpixel == "parabola" and not sgm_mode:
        # The fit samples right at dy in [smin_y - 1, smin_y + s_h +
        # MAX_SUBPIXEL_SHIFT): both images extended by the same rows keep
        # the frames aligned; the halo rows carry the neighbours' real
        # solution, which the fit's shifted box sums read.
        m_top = max(-smin_y, 0) + half_kh + int(MAX_SUBPIXEL_SHIFT) + 1
        m_bot = max(smin_y + s_h, 0) + half_kh + int(MAX_SUBPIXEL_SHIFT) + 1
        ext = DisparityMap(halo(final.disparity, m_top, m_bot),
                           halo(final.valid, m_top, m_bot))
        ref = parabola_subpixel(ext, halo(lblock, m_top, m_bot),
                                halo(rblock, m_top, m_bot), (kw, kh),
                                prefilter_mode, prefilter_width)
        valid = ref.valid[m_top:m_top + hb]
        final = DisparityMap(_where_valid(ref.disparity[m_top:m_top + hb], valid), valid)
    return DisparityMap(all_gather_rows(final.disparity.contiguous(), group, n),
                        all_gather_rows(final.valid.contiguous(), group, n))
