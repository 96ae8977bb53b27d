"""Hierarchical (pyramid) correlator — port of the BM and SGM/MGM branches
of ``visionworkbench_tpu/stereo/pyramid_correlation.py`` (ref
``src/vw/Stereo/CorrelationView.cc:66-886``).

Flow, as in the JAX package: pad the left region by ``half_kernel * 2^L``;
crop the right image at ``search_region.min`` so in-pyramid disparities are
>= 0; mean-fill masked pixels; build 5-tap [1,4,6,4,1]/16 blur + subsample
pyramids with 2-of-4 mask downsampling; then correlate coarse-to-fine on a
fixed tile grid with per-tile search offsets taken from the upsampled
previous level, speckle-filter every level, and at level 0 optionally run
the L<->R consistency check and the parabola fit: on the sweep's 3x3 cost
patches for the abs, sq and census costs, through ``parabola_subpixel``'s
re-evaluation for NCC, which has no patch mode; or, with subpixel
``affine`` / ``em``, refine the final map with the dense affine / Bayes-EM
refiner of ``stereo/subpixel_refine.py`` (plain tensor work).

With ``stereo_algorithm="sgm"``/``"mgm"`` each level runs semi-global
matching (``stereo/sgm.py:sgm_relative_search``) over census costs of
``census_window`` instead of the sweep: the padding follows the census
window, tile offsets are centered on the previous level's tile medians,
per-pixel seeds bound each pixel's search to ``seed +- sgm_search_buffer``,
and the SGM subpixel mode is applied inside the last level.

Options, as in the JAX package: every level of both pyramids is
prefiltered (``none``, ``meansub`` or ``log``) after the blur-downsample;
``corr_timeout`` shrinks each level's search up front until its predicted
time fits the remaining budget (``stereo/cost_model.py``);
``blob_filter_area`` drops valid blobs smaller than the area (divided by
the level's scale) after each level's speckle pass; ``keep_levels``
returns every level's disparity map too.

On the card every BM sweep runs the CUDA kernel of ``ops/sweep.py``, every
SGM/MGM aggregation scan a CUDA kernel of ``ops/sgm_scan.py`` and every
speckle pass the CUDA kernel of ``ops/speckle.py``; the rest is plain tensor
work. With ``device="cpu"`` the same code runs the kernels' plain versions.

Each call's steps are named by ``core/profiling.span`` (free when nothing
records): ``pyramid_correlate`` around the call, ``crop`` (base crops, mean
fill, masks), ``pyramid``, ``prefilter``, per level ``L<n>`` holding
``L<n>.offsets``, ``L<n>.sweep`` or ``L<n>.sgm`` (``sgm_relative_search``'s
own ``sgm.*`` steps inside), at level 0 with the L<->R check ``L0.rl`` and
``L0.lr_check``, and ``L<n>.speckle`` (speckle pass, mask, blob filter); then
``subpixel`` (the absolute offset and the subpixel step; the affine and
Bayes-EM refiner's ``em.*`` steps inside).
"""

from __future__ import annotations

import math
import numbers
from typing import List, NamedTuple, Optional, Tuple

import torch

from visionworkbench_torch.core.device import as_tensor, resolve_device
from visionworkbench_torch.core.profiling import span
from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.image.edge import crop_extended
from visionworkbench_torch.image.filters import generate_pyramid_smoothing_kernel
from visionworkbench_torch.image.morphology import remove_small_blobs
from visionworkbench_torch.math.bbox import BBox2i
from visionworkbench_torch.ops.sweep import sweep
from visionworkbench_torch.stereo import cost_model
from visionworkbench_torch.stereo.correlation import (
    ABSOLUTE_DIFFERENCE, CROSS_CORRELATION, DisparityMap, check_cost_type,
)
from visionworkbench_torch.stereo.disparity import (
    cross_corr_consistency_check, disparity_cleanup_using_thresh,
    disparity_mask, disparity_upsample, rm_outliers_using_thresh,
)
from visionworkbench_torch.stereo.prefilter import (
    PREFILTER_NONE, check_prefilter_mode, prefilter_image,
)
from visionworkbench_torch.stereo.sgm import (
    SUBPIXEL_MODES, default_penalties, sgm_relative_search,
)
from visionworkbench_torch.stereo.subpixel import _fit_parabola, parabola_subpixel
from visionworkbench_torch.stereo.subpixel_refine import bayes_em_subpixel


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class _LevelSpans(NamedTuple):
    """The span names of one pyramid level and its steps."""
    level: str
    offsets: str
    sweep: str
    sgm: str
    rl: str
    lr_check: str
    speckle: str


_LEVEL_SPANS = {}


def _level_names(level: int) -> _LevelSpans:
    """``L<level>`` and its steps' span names, made once a level, so that a
    call with spans off allocates none."""
    names = _LEVEL_SPANS.get(level)
    if names is None:
        names = _LEVEL_SPANS[level] = _LevelSpans(*(
            f"L{level}{step}" for step in
            ("", ".offsets", ".sweep", ".sgm", ".rl", ".lr_check", ".speckle")))
    return names


def max_pyramid_levels_for(width: int, height: int, kernel_size,
                           search_region: BBox2i, requested: int) -> int:
    """Level-count heuristic (ref ``CorrelationView.cc:300-308`` and the
    search-based cap ``CorrelationView.h:99-105``)."""
    smallest_bbox = min(width, height)
    largest_kernel = max(int(kernel_size[0]), int(kernel_size[1]))
    by_size = int(math.floor(math.log2(max(smallest_bbox, 1)) -
                             math.log2(max(largest_kernel, 1))))
    largest_search = max(search_region.width, search_region.height, 1)
    by_search = int(math.floor(math.log2(largest_search))) - 1
    levels = min(by_size, max(by_search, 0), int(requested))
    return max(levels, 0)


def _blur_downsample(img: torch.Tensor) -> torch.Tensor:
    """5-tap pyramid smooth + subsample by 2 (ref ``CorrelationView.cc:210-216``),
    as explicit separable arithmetic: rows first, then columns, each output
    summing its five taps in order over the replicate-extended image (output
    o reads padded samples 2o .. 2o+4). The taps are binary fractions, so
    this agrees with the JAX package's banded matmuls up to fp32 summation
    order."""
    k = [float(v) for v in generate_pyramid_smoothing_kernel()]
    h, w = img.shape
    h2, w2 = (h + 1) // 2, (w + 1) // 2
    p = crop_extended(img, -2, -2, w + 4, h + 4, mode="constant")
    rows = k[0] * p[0:2 * h2 - 1:2]
    for t in range(1, 5):
        rows = rows + k[t] * p[t:t + 2 * h2 - 1:2]
    out = k[0] * rows[:, 0:2 * w2 - 1:2]
    for t in range(1, 5):
        out = out + k[t] * rows[:, t:t + 2 * w2 - 1:2]
    return out


def _mask_downsample(mask: torch.Tensor) -> torch.Tensor:
    """2-of-4 2x2 mask reduction (ref ``SubsampleMaskByTwoFunc``,
    CorrelationView.cc:36-63) on bool (H, W); output ceil sizes, odd edges
    padded with False."""
    h, w = mask.shape
    m = mask.new_zeros((h + h % 2, w + w % 2))
    m[:h, :w] = mask
    cnt = m.to(torch.int32).reshape(m.shape[0] // 2, 2, m.shape[1] // 2, 2).sum((1, 3))
    return cnt >= 2


def _tile_offsets(prior_disp, prior_valid, tile: int, expand: int,
                  max_off_x: int, max_off_y: int) -> torch.Tensor:
    """Per-tile search offsets from the previous level's disparity: tile-min
    over valid pixels, minus ``expand``, clamped to [0, max_off]; tiles with
    no valid pixel take the global valid minimum (0 if none)."""
    h, w = prior_valid.shape
    nty, ntx = h // tile, w // tile
    big = 1e30
    disp = prior_disp.to(torch.float32)
    masked = torch.where(prior_valid[..., None], disp,
                         torch.full((), big, device=disp.device))
    tmin = masked.reshape(nty, tile, ntx, tile, 2).amin(dim=(1, 3))
    has_valid = prior_valid.reshape(nty, tile, ntx, tile).any(3).any(1)
    global_min = masked.reshape(-1, 2).amin(0)
    global_min = torch.where(global_min >= big, torch.zeros_like(global_min),
                             global_min)
    tmin = torch.where(has_valid[..., None], tmin, global_min[None, None, :])
    off = torch.floor(tmin).to(torch.int32) - expand
    return torch.stack([off[..., 0].clamp(0, max_off_x),
                        off[..., 1].clamp(0, max_off_y)], -1).contiguous()


def _hist_median(counts: torch.Tensor) -> torch.Tensor:
    """Exact median of non-negative-int samples from per-value counts
    (..., nvals): the mean of the two middle order statistics, like
    ``nanmedian``. Zero-count rows give 0."""
    n = counts.sum(-1, keepdim=True)
    cum = counts.cumsum(-1)
    k1 = torch.floor((n - 1) / 2)              # lower middle (0-based)
    k2 = torch.floor(n / 2)                    # upper middle
    nvals = counts.shape[-1]
    vals = torch.arange(nvals, dtype=torch.float32, device=counts.device)
    big = torch.full_like(vals, float(nvals))
    v1 = torch.where(cum > k1, vals, big).amin(-1)
    v2 = torch.where(cum > k2, vals, big).amin(-1)
    return torch.where(n[..., 0] > 0, 0.5 * (v1 + v2), torch.zeros_like(v1))


def _tile_offsets_centered(prior_disp, prior_valid, tile: int, buffer: int,
                           max_off_x: int, max_off_y: int,
                           value_bounds: Tuple[int, int]) -> torch.Tensor:
    """Per-tile search offsets centered on the tile median of the previous
    level's disparity (the stand-in for the reference SGM's per-pixel
    ``prev_disparity +- search_buffer`` bounds, SGM.cc:405-420), minus
    ``buffer``, clamped to [0, max_off]. Valid disparities are integers in
    [0, n_x) x [0, n_y) (``value_bounds``), so the medians come exactly from
    per-value counts; tiles with no valid pixel take the global median."""
    h, w = prior_valid.shape
    nty, ntx = h // tile, w // tile
    has_valid = prior_valid.reshape(nty, tile, ntx, tile).any(3).any(1)
    r = torch.round(prior_disp).to(torch.int32)
    di = torch.stack([r[..., 0].clamp(0, value_bounds[0] - 1),
                      r[..., 1].clamp(0, value_bounds[1] - 1)], -1)
    t4 = (di.reshape(nty, tile, ntx, tile, 2).transpose(1, 2)
          .reshape(nty, ntx, tile * tile, 2))
    v4 = (prior_valid.reshape(nty, tile, ntx, tile).transpose(1, 2)
          .reshape(nty, ntx, tile * tile).to(torch.float32))
    meds = []
    for c, nvals in ((0, int(value_bounds[0])), (1, int(value_bounds[1]))):
        counts = torch.zeros((nty, ntx, nvals), dtype=torch.float32,
                             device=prior_disp.device)
        counts.scatter_add_(-1, t4[..., c].long(), v4)
        med = _hist_median(counts)
        meds.append(torch.where(has_valid, med, _hist_median(counts.sum((0, 1)))))
    off = torch.round(torch.stack(meds, -1)).to(torch.int32) - buffer
    return torch.stack([off[..., 0].clamp(0, max_off_x),
                        off[..., 1].clamp(0, max_off_y)], -1).contiguous()


def _pad_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Zero-pad the first two axes of ``x`` at the bottom/right to (h, w)."""
    out = x.new_zeros((h, w) + tuple(x.shape[2:]))
    hh, ww = min(h, x.shape[0]), min(w, x.shape[1])
    out[:hh, :ww] = x[:hh, :ww]
    return out


def _mean_fill(img, mask, frame_h: int, frame_w: int):
    """Mean-fill masked pixels (CorrelationView.cc:129-150): the fill value
    is the mean over the EVEN-index valid pixels of the reference frame,
    which excludes the power-of-two alignment padding."""
    iy = torch.arange(img.shape[0], device=img.device)[:, None]
    ix = torch.arange(img.shape[1], device=img.device)[None, :]
    sel = (mask & (iy % 2 == 0) & (ix % 2 == 0)
           & (iy < frame_h) & (ix < frame_w))
    cnt = torch.clamp(sel.sum().to(torch.float32), min=1.0)
    mean = torch.where(sel, img, torch.zeros_like(img)).sum() / cnt
    return torch.where(mask, img, mean)


def _check_options(cost_type, census_window, prefilter_mode,
                   stereo_algorithm, subpixel, engine):
    """Raise on an unknown option. In SGM/MGM mode the cost is census
    (``cost_type`` only selects ternary census), so the BM cost check does
    not apply, and every SGM subpixel mode is accepted."""
    if stereo_algorithm not in ("bm", "sgm", "mgm"):
        raise ArgumentErr(f"unknown stereo_algorithm {stereo_algorithm!r}")
    if stereo_algorithm != "bm":
        if subpixel not in SUBPIXEL_MODES:
            raise ArgumentErr(f"unknown SGM subpixel mode {subpixel!r}")
    else:
        check_cost_type(cost_type, census_window)
        if subpixel not in ("none", "parabola", "affine", "em"):
            raise ArgumentErr(f"unknown subpixel mode {subpixel!r}")
    check_prefilter_mode(prefilter_mode)
    if engine != "auto":
        raise ArgumentErr(f"engine {engine!r}: the port has one engine (the "
                          "CUDA kernels on the card, their plain versions "
                          "on the CPU); pass engine='auto'")


def _check_subpixel_kernel(subpixel_kernel) -> Optional[Tuple[int, int]]:
    """``subpixel_kernel`` as a (width, height) pair of ints; raise unless
    it is None or two odd positive sizes."""
    if subpixel_kernel is None:
        return None
    sizes = tuple(subpixel_kernel) if isinstance(subpixel_kernel, (tuple, list)) else ()
    if len(sizes) != 2 or not all(isinstance(k, numbers.Integral) and k > 0 and k % 2
                                  for k in sizes):
        raise ArgumentErr(f"pyramid_correlate: subpixel_kernel {subpixel_kernel!r} "
                          "must be two odd positive sizes (width, height)")
    return int(sizes[0]), int(sizes[1])


class PyramidCorrResult(NamedTuple):
    """``pyramid_correlate(..., keep_levels=True)``: the final map and each
    level's map (coarsest first; relative disparities, before the search
    minimum is added)."""
    disparity: DisparityMap
    level_disparities: List[DisparityMap]


def level_searches(h: int, w: int, levels: int, search_size: Tuple[int, int],
                   refine_window: int, sgm_search_buffer: Optional[int] = None,
                   corr_timeout: float = 0.0, sec_per_op: Optional[float] = None,
                   consistency: bool = False, device=None):
    """Each level's search, coarsest first, as ``pyramid_correlate`` runs
    it: ``(level, s_w_l, s_h_l, s_x_eff, s_y_eff)`` — the level's search
    size (CorrelationView.cc:391-395) and the window searched (the whole
    size at the coarsest level, then the refine window, or for SGM/MGM
    ``2 * sgm_search_buffer + 1``). With ``corr_timeout > 0`` each level's
    window is capped by ``cost_model.budget_search_volume`` on what remains
    of the budget after the earlier levels' predicted times (the R->L pass
    at level 0 charged too when ``consistency``), as the JAX package does
    (ref m_corr_timeout, CorrelationView.cc:621-637)."""
    s_w, s_h = int(search_size[0]), int(search_size[1])
    spo = None
    if corr_timeout > 0:
        spo = (float(sec_per_op) if sec_per_op is not None
               else cost_model.seconds_per_op(device))
    spent = 0.0
    plan = []
    for level in range(levels, -1, -1):
        scaling = 1 << level
        s_w_l, s_h_l = max(s_w // scaling, 1), max(s_h // scaling, 1)
        pixels = (-(-h // scaling)) * (-(-w // scaling))
        cap_x, cap_y = s_w_l, s_h_l
        if corr_timeout > 0:
            rem = corr_timeout - spent
            cap_x, cap_y = ((1, 1) if rem <= 0 else
                            cost_model.budget_search_volume(pixels, (s_w_l, s_h_l),
                                                            rem, spo))
        if level == levels:
            window = (s_w_l, s_h_l)
        elif sgm_search_buffer is not None:
            window = (2 * int(sgm_search_buffer) + 1,) * 2
        else:
            window = (int(refine_window),) * 2
        s_x_eff = min(window[0], s_w_l, cap_x)
        s_y_eff = min(window[1], s_h_l, cap_y)
        if corr_timeout > 0:
            passes = 2 if level == 0 and consistency else 1
            spent += passes * cost_model.estimate_search_time(
                pixels, (s_x_eff, s_y_eff), spo)
        plan.append((level, s_w_l, s_h_l, s_x_eff, s_y_eff))
    return plan


def pyramid_correlate(left, right, search_region: BBox2i,
                      kernel_size: Tuple[int, int] = (21, 21),
                      left_mask=None, right_mask=None,
                      cost_type: str = ABSOLUTE_DIFFERENCE,
                      prefilter_mode: str = PREFILTER_NONE,
                      prefilter_width: float = 1.4,
                      consistency_threshold: float = -1.0,
                      max_pyramid_levels: int = 5,
                      filter_half_kernel: int = 5,
                      tile_size: int = 64,
                      refine_window: int = 11,
                      census_window: int = 5,
                      subpixel: str = "none",
                      blob_filter_area: int = 0,
                      engine: str = "auto",
                      stereo_algorithm: str = "bm",
                      sgm_search_buffer: int = 2,
                      corr_timeout: float = 0.0,
                      seconds_per_op: Optional[float] = None,
                      keep_levels: bool = False,
                      device=None,
                      subpixel_kernel: Optional[Tuple[int, int]] = None):
    """Full coarse-to-fine correlator (ref ``PyramidCorrelationView``,
    CorrelationView.cc:273-886), with the JAX package's signature plus
    ``device`` (``None`` = the card; raises when there is none).
    ``left``/``right`` and the masks may be numpy arrays or tensors.

    Returns a :class:`DisparityMap` of torch tensors the size of ``left``,
    whose (dx, dy) are absolute right-image offsets (``search_region.min``
    added), or with ``keep_levels`` a :class:`PyramidCorrResult` that also
    holds each level's map. In BM mode ``subpixel='parabola'`` refines them
    with the 9-point quadratic fit on the level-0 sweep's cost patches, or
    for NCC on the absolute costs ``parabola_subpixel`` re-evaluates (on
    the prefiltered full-resolution images).

    ``stereo_algorithm``: ``'bm'`` with any of the five costs (``abs``,
    ``sq``, ``ncc``, ``census`` and ``ternary_census`` of ``census_window``)
    and subpixel ``none``, ``parabola``, ``affine`` (the weighted affine
    Gauss-Newton refiner) or ``em`` (the Bayes-EM refiner, the reference's
    quality mode; both ``stereo/subpixel_refine.py`` at full resolution, 3
    outer iterations, over a ``subpixel_kernel`` window, ASP's
    ``subpixel-kernel``: ``None`` for ``kernel_size``; odd and positive;
    the other modes ignore it), or ``'sgm'``/``'mgm'`` (ref
    ``CorrelationAlgorithm``, CorrelationView.h:45) with census costs of
    ``census_window`` (``cost_type='ternary_census'`` for ternary), any SGM
    subpixel mode applied inside the last level, and
    ``sgm_search_buffer``. ``prefilter_mode`` ``none``/``meansub``/``log``
    of ``prefilter_width`` conditions every pyramid level. ``corr_timeout``
    (seconds, 0 disables) degrades each level's search up front to fit the
    budget, at ``seconds_per_op`` or the s/op measured on the device
    (``stereo/cost_model.py``). ``blob_filter_area`` > 0 drops valid blobs
    smaller than it (scaled per level).
    """
    with span("pyramid_correlate"):
        _check_options(cost_type, census_window, prefilter_mode,
                       stereo_algorithm, subpixel, engine)
        subpixel_kernel = _check_subpixel_kernel(subpixel_kernel)
        dev = resolve_device(device)
        left = as_tensor(left, torch.float32, dev)
        right = as_tensor(right, torch.float32, dev)
        h, w = left.shape
        kw, kh = int(kernel_size[0]), int(kernel_size[1])
        sgm_mode = stereo_algorithm != "bm"
        if sgm_mode:
            # the census support drives the pyramid padding in SGM mode
            kw = kh = int(census_window)
            sgm_cost = "ternary_census" if cost_type == "ternary_census" else "census"
            sgm_p1, sgm_p2 = default_penalties(sgm_cost, census_window)

            def sgm_search(lbase_, mbase_, offsets_, sx_, sy_, last_, seeds=None,
                           lmask_=None, ranges=(0, 0)):
                sd, sv = (None, None) if seeds is None else seeds
                return sgm_relative_search(
                    lbase_, mbase_, offsets_, int(tile_size), sx_, sy_,
                    int(census_window),
                    sgm_cost == "ternary_census", 2, sgm_p1, sgm_p2,
                    stereo_algorithm == "mgm", subpixel if last_ else "none",
                    seed_disp=sd, seed_valid=sv,
                    search_buffer=int(sgm_search_buffer), range_x=int(ranges[0]),
                    range_y=int(ranges[1]), lmask=lmask_)
        if kw % 2 != 1 or kh % 2 != 1:
            raise ArgumentErr("pyramid_correlate: kernel dimensions must be odd")
        if search_region.width <= 0 or search_region.height <= 0:
            raise ArgumentErr("pyramid_correlate: search region must be non-empty")
        half_kw, half_kh = kw // 2, kh // 2
        # NCC has no patch mode: its parabola re-evaluates absolute costs
        use_patches = (subpixel == "parabola" and not sgm_mode
                       and cost_type != CROSS_CORRELATION)

        s_w, s_h = int(search_region.width), int(search_region.height)
        smin_x, smin_y = int(search_region.min_x), int(search_region.min_y)

        levels = max_pyramid_levels_for(w, h, (kw, kh), search_region,
                                        max_pyramid_levels)
        up = 1 << levels
        off_x, off_y = half_kw * up, half_kh * up   # region_offset (CorrelationView.cc:89)

        with span("crop"):
            user_masks = left_mask is not None or right_mask is not None
            left_mask = (torch.ones((h, w), dtype=torch.bool, device=dev)
                         if left_mask is None else as_tensor(left_mask, torch.bool, dev))
            right_mask = (torch.ones(right.shape, dtype=torch.bool, device=dev)
                          if right_mask is None else as_tensor(right_mask, torch.bool, dev))

            # ---- base-level regions (CorrelationView.cc:84-120) ----------------
            # Padded so every pyramid level halves exactly; extra `up` margin keeps
            # coarsest-level slices in bounds.
            base_w = w + 2 * off_x
            base_h = h + 2 * off_y
            base_w += (-base_w) % up + up
            base_h += (-base_h) % up + up
            left_base = crop_extended(left, -off_x, -off_y, base_w, base_h)
            rbase_w = base_w + s_w
            rbase_h = base_h + s_h
            right_base = crop_extended(right, -off_x + smin_x, -off_y + smin_y,
                                       rbase_w, rbase_h)
            # Round the right base up to a multiple of `up` too, replicating the
            # crop's own edge (not the image beyond it), as the JAX package does.
            rbase_w += (-rbase_w) % up
            rbase_h += (-rbase_h) % up
            right_base = crop_extended(right_base, 0, 0, rbase_w, rbase_h)

            if user_masks:
                # Masks over the padded frames, replicate-extended like the
                # reference (CorrelationView.cc:110-117), then the mean fill. The
                # right frame is one short of rbase (max-exclusive search sizing).
                left_base_mask = crop_extended(left_mask, -off_x, -off_y, base_w, base_h)
                right_base_mask = crop_extended(right_mask, -off_x + smin_x,
                                                -off_y + smin_y, rbase_w, rbase_h)
                left_base = _mean_fill(left_base, left_base_mask,
                                       h + 2 * off_y, w + 2 * off_x)
                right_base = _mean_fill(right_base, right_base_mask,
                                        h + 2 * off_y + s_h - 1, w + 2 * off_x + s_w - 1)

            # Output-frame masks (zero-extended, unpadded; CorrelationView.cc:195-199).
            lmask0 = left_mask
            rmask0 = crop_extended(right_mask, smin_x, smin_y, w + s_w, h + s_h,
                                   mode="zero")

        with span("pyramid"):
            # ---- build pyramids ------------------------------------------------
            left_pyr, right_pyr = [left_base], [right_base]
            lmask_pyr, rmask_pyr = [lmask0], [rmask0]
            for _ in range(levels):
                left_pyr.append(_blur_downsample(left_pyr[-1]))
                right_pyr.append(_blur_downsample(right_pyr[-1]))
                lmask_pyr.append(_mask_downsample(lmask_pyr[-1]))
                rmask_pyr.append(_mask_downsample(rmask_pyr[-1]))

        with span("prefilter"):
            # every level of both pyramids, after the blur-downsample and the mean
            # fill (JAX pyramid_correlation.py:530-531)
            left_pyr = [prefilter_image(im, prefilter_mode, prefilter_width)
                        for im in left_pyr]
            right_pyr = [prefilter_image(im, prefilter_mode, prefilter_width)
                         for im in right_pyr]

        # Each level's search (max-exclusive: d_abs in [min, min+size)), capped
        # up front by the time budget.
        plan = level_searches(h, w, levels, (s_w, s_h), refine_window,
                              int(sgm_search_buffer) if sgm_mode else None,
                              corr_timeout, seconds_per_op,
                              consistency_threshold >= 0, dev)
        level_results = [] if keep_levels else None
        dm: Optional[DisparityMap] = None
        patches = None
        t = int(tile_size)
        for level, s_w_l, s_h_l, s_x_eff, s_y_eff in plan:
            names = _level_names(level)
            with span(names.level):
                scaling = 1 << level
                on_last = level == 0
                out_h = -(-h // scaling)
                out_w = -(-w // scaling)
                region_off_x = off_x // scaling
                region_off_y = off_y // scaling
                nty, ntx = _cdiv(out_h, t), _cdiv(out_w, t)

                with span(names.offsets):
                    if level == levels:
                        offsets = torch.zeros((nty, ntx, 2), dtype=torch.int32, device=dev)
                    else:
                        prior = disparity_upsample(dm)
                        pr_d = _pad_to(prior.disparity[:out_h, :out_w], nty * t, ntx * t)
                        pr_v = _pad_to(prior.valid[:out_h, :out_w], nty * t, ntx * t)
                        if sgm_mode:
                            # SGM refines +-sgm_search_buffer around the seed (ref
                            # SGM.h:113); BM uses the wider refine window
                            offsets = _tile_offsets_centered(
                                pr_d, pr_v, t, int(sgm_search_buffer), s_w_l - s_x_eff,
                                s_h_l - s_y_eff, value_bounds=(s_w_l, s_h_l))
                        else:
                            offsets = _tile_offsets(pr_d, pr_v, t, 2,
                                                    s_w_l - s_x_eff, s_h_l - s_y_eff)

                with span(names.sgm if sgm_mode else names.sweep):
                    # Base (left) frame for tile extraction, origin at the unpadded
                    # region minus half the kernel; match frame: right pyramid, same origin.
                    ly0 = region_off_y - half_kh
                    lx0 = region_off_x - half_kw
                    lbh = nty * t + kh - 1
                    lbw = ntx * t + kw - 1
                    lbase = crop_extended(left_pyr[level], lx0, ly0, lbw, lbh)
                    mh = lbh + s_h_l - 1
                    mw = lbw + s_w_l - 1

                    if on_last and use_patches:
                        # Match origin shifted (-1, -1), +2 per axis: every tile window
                        # also covers the ±1 disparity ring for the 3x3 patches.
                        mbase_p = crop_extended(right_pyr[level], lx0 - 1, ly0 - 1,
                                                mw + 2, mh + 2)
                        disp, valid, patches = sweep(lbase, mbase_p, offsets, t, s_x_eff,
                                                     s_y_eff, kw, kh, cost_type,
                                                     want_patches=True,
                                                     census_window=census_window)
                        patches = tuple(patches[:, :out_h, :out_w].unbind(0))
                    else:
                        mbase = crop_extended(right_pyr[level], lx0, ly0, mw, mh)
                        if sgm_mode:
                            # per-pixel seeds from the (filtered, upsampled) previous
                            # level and the level's left mask: SGM invalidates internally
                            # (ref m_disp_bound_image / ZERO_SEARCH_AREA, SGM.h:180-198)
                            lm_lvl = _pad_to(lmask_pyr[level][:out_h, :out_w], nty * t, ntx * t)
                            seeds = None if level == levels else (pr_d.to(torch.float32), pr_v)
                            disp, valid = sgm_search(lbase, mbase, offsets, s_x_eff, s_y_eff,
                                                     on_last, seeds, lm_lvl, (s_w_l, s_h_l))
                        else:
                            disp, valid, _ = sweep(lbase, mbase, offsets, t, s_x_eff,
                                                   s_y_eff, kw, kh, cost_type,
                                                   want_patches=False,
                                                   census_window=census_window)
                    dm = DisparityMap(disp[:out_h, :out_w], valid[:out_h, :out_w])

                # L<->R consistency check at level 0 (CorrelationView.cc:653-695).
                if on_last and consistency_threshold >= 0:
                    with span(names.rl):
                        # RL search: base = right frame, match = left; RL offsets cover
                        # the negation of each tile's LR window.
                        rl_out_h = min(out_h + s_h, rmask_pyr[level].shape[0])
                        rl_out_w = min(out_w + s_w, rmask_pyr[level].shape[1])
                        rnty, rntx = _cdiv(rl_out_h, t), _cdiv(rl_out_w, t)
                        # Reuse LR tile offsets where available; edge tiles take 0.
                        off_rl_src = _pad_to(offsets, rnty, rntx)
                        eff = torch.tensor([s_x_eff - 1, s_y_eff - 1], dtype=torch.int32,
                                           device=dev)
                        rbh = rnty * t + kh - 1
                        rbw = rntx * t + kw - 1
                        rl_base = crop_extended(right_pyr[level], lx0, ly0, rbw, rbh)
                        # Match = left frame; a (S-1 + max_off) margin on top/left keeps
                        # every shifted offset non-negative.
                        margin_x = s_x_eff - 1 + (s_w_l - s_x_eff)
                        margin_y = s_y_eff - 1 + (s_h_l - s_y_eff)
                        lm_h = rbh + s_y_eff - 1 + margin_y
                        lm_w = rbw + s_x_eff - 1 + margin_x
                        rl_match = crop_extended(left_pyr[level], lx0 - margin_x,
                                                 ly0 - margin_y, lm_w, lm_h)
                        rl_origin = torch.tensor([margin_x, margin_y], dtype=torch.int32,
                                                 device=dev)
                        rl_offsets = (rl_origin - (off_rl_src + eff)).contiguous()
                        if sgm_mode:
                            rl_disp, rl_valid = sgm_search(rl_base, rl_match, rl_offsets,
                                                           s_x_eff, s_y_eff, on_last)
                        else:
                            rl_disp, rl_valid, _ = sweep(rl_base, rl_match, rl_offsets, t,
                                                         s_x_eff, s_y_eff, kw, kh,
                                                         cost_type, want_patches=False,
                                                         census_window=census_window)
                        rl_dm = DisparityMap((rl_disp - rl_origin)[:rl_out_h, :rl_out_w],
                                             rl_valid[:rl_out_h, :rl_out_w])
                    with span(names.lr_check):
                        dm = cross_corr_consistency_check(dm, rl_dm, consistency_threshold)

                with span(names.speckle):
                    # Per-level speckle filtering (CorrelationView.cc:707-745), on the
                    # integer disparities of this level.
                    if filter_half_kernel > 0:
                        if not on_last:
                            dm = disparity_cleanup_using_thresh(dm, filter_half_kernel,
                                                                filter_half_kernel, 3.0, 0.5,
                                                                integer_disparities=True)
                        else:
                            dm = rm_outliers_using_thresh(dm, filter_half_kernel,
                                                          filter_half_kernel, 3.0, 0.5,
                                                          integer_disparities=True)
                        if on_last and not user_masks:
                            # No user masks at level 0: rmask0 is exactly the rectangle
                            # where the (smin-shifted, zero-extended) right crop covers
                            # real pixels, so the mask lookup is bounds arithmetic.
                            rh_o, rw_o = right.shape
                            ra, rb = max(0, -smin_y), min(h + s_h, rh_o - smin_y)
                            ca, cb = max(0, -smin_x), min(w + s_w, rw_o - smin_x)
                            iy = torch.arange(out_h, dtype=torch.int32, device=dev)[:, None]
                            ix = torch.arange(out_w, dtype=torch.int32, device=dev)[None, :]
                            ty = iy + dm.disparity[..., 1].to(torch.int32)
                            tx = ix + dm.disparity[..., 0].to(torch.int32)
                            ok = (ty >= ra) & (ty < rb) & (tx >= ca) & (tx < cb)
                            valid = dm.valid & ok
                            dm = DisparityMap(torch.where(valid[..., None], dm.disparity,
                                                          torch.zeros_like(dm.disparity)),
                                              valid)
                        else:
                            dm = disparity_mask(dm, lmask_pyr[level][:out_h, :out_w],
                                                rmask_pyr[level])

                    # Isolated-blob removal, the area scaled by the level (ref
                    # disparity_blob_filter, CorrelationView.cc:241-280).
                    if blob_filter_area > 0 and blob_filter_area // scaling >= 1:
                        keep = remove_small_blobs(dm.valid, blob_filter_area // scaling)
                        dm = DisparityMap(torch.where(keep[..., None], dm.disparity,
                                                      torch.zeros_like(dm.disparity)), keep)
                if keep_levels:
                    level_results.append(dm)

        with span("subpixel"):
            # Absolute disparities (CorrelationView.cc: final offset add).
            smin = torch.tensor([smin_x, smin_y], dtype=dm.disparity.dtype, device=dev)
            final = DisparityMap(torch.where(dm.valid[..., None], dm.disparity + smin,
                                             torch.zeros_like(dm.disparity)),
                                 dm.valid)
            # (SGM applied its subpixel mode inside the last level)
            if use_patches:
                final = DisparityMap(_fit_parabola(patches, final.disparity, final.valid),
                                     final.valid)
            elif subpixel == "parabola" and not sgm_mode:
                final = parabola_subpixel(final, left, right, (kw, kh), prefilter_mode,
                                          prefilter_width)
            elif subpixel in ("affine", "em"):   # BM only (not an SGM mode)
                # The JAX package's production setting (its
                # pyramid_correlation.py:771-790): the integer correlator seeds every
                # pixel within ~0.5 px, so 3 outer iterations at full resolution,
                # no refiner pyramid.
                final = bayes_em_subpixel(final, left, right, subpixel_kernel or (kw, kh),
                                          em_iters=2 if subpixel == "em" else 0,
                                          prefilter_mode=prefilter_mode,
                                          prefilter_width=prefilter_width,
                                          max_pyramid_levels=0, outer_iters=3)
        if keep_levels:
            return PyramidCorrResult(final, level_results)
        return final
