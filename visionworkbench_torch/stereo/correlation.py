"""Integer block-matching search, plain PyTorch (port of
``visionworkbench_tpu/stereo/correlation.py``; ref
``src/vw/Stereo/Correlation.cc:30-137``, ``CostFunctions.h:143-236``).

Costs per pixel and candidate: ``|l - r|``, ``(l - r)^2``, the NCC
numerator ``l * r``, or the hamming distance between census codes (binary
or ternary, windows 3/5/7/9) of the images quantized as
``clip(x * 255, 0, 255)`` truncated to int, as fp32. Codes are computed
over the image given, edges replicated at its border: per tile crop in the
pyramid's sweep, over the whole frames in ``best_of_search_convolution``.

Semantics kept from the JAX package's XLA engines:

* min metrics (abs, sq, census): first-best-wins argmin in dy-major, then
  dx order (strict improvement only), running worst = max (the
  reference's ``elif`` worst update gives the same value);
* NCC, a max metric: the window sum is scaled by ``sqrt(lprec * rprec)``
  with ``lprec = 1 / boxsum(l*l)`` and ``rprec = 1 / boxsum(r*r)`` at the
  candidate (IEEE quotients); first-best-wins argmax, running worst = min;
  a NaN metric (a zero-energy window gives ``0 * inf``) counts as greater
  than any number, so the first NaN candidate wins and the pixel stays
  valid (NaN != NaN), as the JAX package's one-chunk ``jnp.max`` /
  ``jnp.argmax`` reduction gives (``correlation.py:318-331``);
* flat-region invalidation where best == worst, with the in-window argbest
  zeroed there.

Window sums are exact fp32 sliding sums in a fixed order
(``ops/box_filter.py``); the CUDA sweep kernel (``ops/sweep.py``) adds in
the same order, so the two agree bit for bit on any input. On inputs
quantized to the 1/256 grid every window sum is exact and any order agrees
with the JAX package too (census costs are small integers, exact always).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from visionworkbench_torch.core.device import as_tensor, resolve_device, sqrt_rn
from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.image.census import (
    census_positions, census_transform, hamming_distance,
    ternary_census_transform,
)
from visionworkbench_torch.ops.box_filter import box_sum_valid

# Cost function types (ref CostFunctionType enum, CostFunctions.h:143-150)
ABSOLUTE_DIFFERENCE = "abs"
SQUARED_DIFFERENCE = "sq"
CROSS_CORRELATION = "ncc"
CENSUS_TRANSFORM = "census"
TERNARY_CENSUS_TRANSFORM = "ternary_census"

COST_TYPES = (ABSOLUTE_DIFFERENCE, SQUARED_DIFFERENCE, CROSS_CORRELATION,
              CENSUS_TRANSFORM, TERNARY_CENSUS_TRANSFORM)
CENSUS_COSTS = (CENSUS_TRANSFORM, TERNARY_CENSUS_TRANSFORM)


class DisparityMap(NamedTuple):
    """Integer or float disparity + validity (the reference's
    ``ImageView<PixelMask<Vector2i>>`` / ``Vector2f``)."""
    disparity: torch.Tensor  # (H, W, 2) — channels (dx, dy)
    valid: torch.Tensor      # (H, W) bool

    def to_numpy(self):
        """``(disparity, valid)`` as numpy arrays on the host."""
        return (self.disparity.detach().cpu().numpy(),
                self.valid.detach().cpu().numpy())

    @classmethod
    def from_numpy(cls, disparity, valid, device=None) -> "DisparityMap":
        """Build from numpy arrays; ``device=None`` means the card."""
        dev = resolve_device(device)
        disparity = np.asarray(disparity)
        return cls(torch.as_tensor(disparity, device=dev),
                   torch.as_tensor(np.asarray(valid, bool), device=dev))


def check_cost_type(cost_type: str, census_window: int = 5) -> None:
    """Raise on an unknown cost, or a census window with no variant."""
    if cost_type not in COST_TYPES:
        raise ArgumentErr(f"unknown cost_type {cost_type!r}")
    if cost_type in CENSUS_COSTS:
        census_positions(int(census_window), cost_type == TERNARY_CENSUS_TRANSFORM)


def census_codes(img: torch.Tensor, cost_type: str, census_window: int):
    """Census codes (..., H, W, n_words) int32 of a float image (..., H, W),
    quantized to 8-bit levels like the reference's census path."""
    q = torch.clamp(img * 255.0, 0, 255).to(torch.int32)
    if cost_type == TERNARY_CENSUS_TRANSFORM:
        return ternary_census_transform(q, census_window)
    return census_transform(q, census_window)


def _reciprocal(x: torch.Tensor) -> torch.Tensor:
    """IEEE ``1 / x`` (PyTorch's ``scalar / tensor`` is a reciprocal times
    the scalar, not the quotient)."""
    return torch.ones_like(x) / x


def _cost(left: torch.Tensor, right: torch.Tensor, cost_type: str):
    if cost_type in CENSUS_COSTS:
        return hamming_distance(left, right).to(torch.float32)
    if cost_type == CROSS_CORRELATION:
        return left * right
    d = left - right
    if cost_type == ABSOLUTE_DIFFERENCE:
        return d.abs()
    return d * d


def _sweep(left, right, sx: int, sy: int, kw: int, kh: int, cost_type: str,
           ring: int, census_window: int = 5):
    """Search over the window [0, sx) x [0, sy), with ``ring`` extra
    candidates on every side kept for the 3x3 patches. ``left``/``right``
    are float images (..., h, w), or for the census costs int32 code planes
    (..., h, w, n_words) computed beforehand; leading batch axes are
    carried through."""
    check_cost_type(cost_type, census_window)
    is_max = cost_type == CROSS_CORRELATION
    if is_max and ring:
        raise ArgumentErr("NCC has no patch mode (the JAX package's "
                          "_search_with_patches is SAD/SSD/census only)")
    census = cost_type in CENSUS_COSTS
    if census and left.dtype != torch.int32:
        left = census_codes(left, cost_type, census_window)
        right = census_codes(right, cost_type, census_window)
    ax_h = -3 if census else -2          # the image axes of the inputs
    h, w = left.shape[ax_h], left.shape[ax_h + 1]
    sx_e, sy_e = sx + 2 * ring, sy + 2 * ring
    if right.shape[ax_h] != h + sy_e - 1 or right.shape[ax_h + 1] != w + sx_e - 1:
        raise ArgumentErr(
            f"search: right {tuple(right.shape[ax_h:ax_h + 2])} must be "
            f"({h + sy_e - 1}, {w + sx_e - 1}) for left {(h, w)}, window "
            f"{sx}x{sy}, ring {ring}")
    oh, ow = h - kh + 1, w - kw + 1
    lead = left.shape[:ax_h]
    if is_max:
        lprec = _reciprocal(box_sum_valid(left * left, kw, kh))
        rprec = _reciprocal(box_sum_valid(right * right, kw, kh))
    inf = torch.full((), float("inf"), device=left.device)
    best = (-inf if is_max else inf).expand(lead + (oh, ow))
    worst = (inf if is_max else -inf).expand(lead + (oh, ow))
    arg = torch.zeros(lead + (oh, ow), dtype=torch.int32, device=left.device)
    vol = []
    for ey in range(sy_e):
        for ex in range(sx_e):
            interior = ring <= ey < ring + sy and ring <= ex < ring + sx
            if not (interior or ring):
                continue
            r = (right[..., ey:ey + h, ex:ex + w, :] if census
                 else right[..., ey:ey + h, ex:ex + w])
            s = box_sum_valid(_cost(left, r, cost_type), kw, kh)
            if is_max:
                s = s * sqrt_rn(lprec * rprec[..., ey:ey + oh, ex:ex + ow])
            if ring:
                vol.append(s)
            if interior:
                if is_max:     # NaN counts as greater than any number
                    better = (s > best) | (s.isnan() & ~best.isnan())
                    worst = torch.where(s.isnan() | (s < worst), s, worst)
                else:
                    better = s < best
                    worst = torch.maximum(worst, s)
                best = torch.where(better, s, best)
                arg = torch.where(better, (ey - ring) * sx + (ex - ring), arg)
    valid = best != worst        # flat-region invalidation (Correlation.cc:121-133)
    ax, ay = arg % sx, arg // sx
    disp = torch.where(valid[..., None], torch.stack([ax, ay], -1),
                       torch.zeros_like(arg)[..., None])
    patch = None
    if ring:
        # the nine costs at the winner's (dy, dx) in (-1, 0, 1)^2, dx fastest
        vol = torch.stack(vol, -1)                       # (..., oh, ow, n_ext)
        ey_w, ex_w = ay + ring, ax + ring
        idx = torch.stack([(ey_w + dy) * sx_e + (ex_w + dx)
                           for dy in (-1, 0, 1) for dx in (-1, 0, 1)], -1)
        patch = torch.gather(vol, -1, idx.long())
    return disp, valid, best, patch


def _best_of_search(left, right, sx: int, sy: int, kw: int, kh: int,
                    cost_type: str, census_window: int = 5):
    """Disparity sweep over ``right`` sized (H + sy - 1, W + sx - 1). Returns
    ``(disp (..., oh, ow, 2) int32 (dx, dy), valid, best)``."""
    disp, valid, best, _ = _sweep(left, right, sx, sy, kw, kh, cost_type, 0,
                                  census_window)
    return disp, valid, best


def _search_with_patches(left, right, sx: int, sy: int, kw: int, kh: int,
                         cost_type: str, census_window: int = 5):
    """Sweep over an extended ±1 ring: ``right`` is sized
    (H + sy + 1, W + sx + 1). disp/valid/best are those of
    :func:`_best_of_search` over the interior window; ``patch``
    (..., oh, ow, 9) holds the costs at ``d + (dy, dx)``, dx fastest.
    Census codes of ``right`` are those of the ring-extended crop, so they
    may differ from the plain sweep's within the census half-window of its
    border, as in the JAX package (``correlation.py:473-475``)."""
    return _sweep(left, right, sx, sy, kw, kh, cost_type, 1, census_window)


def _check_args(search_volume, kernel_size):
    sx, sy = int(search_volume[0]), int(search_volume[1])
    kw, kh = int(kernel_size[0]), int(kernel_size[1])
    if kw % 2 != 1 or kh % 2 != 1:
        raise ArgumentErr("calc_disparity: Kernel input not sized with odd values.")
    if sx <= 0 or sy <= 0:
        raise ArgumentErr("calc_disparity: Search volume must be greater than 0.")
    return sx, sy, kw, kh


def best_of_search_convolution(left, right, search_volume, kernel_size,
                               cost_type: str = ABSOLUTE_DIFFERENCE,
                               census_window: int = 5,
                               return_cost: bool = False, device=None):
    """Low-level search (ref ``best_of_search_convolution``,
    Correlation.cc:33-137), any of the five costs.

    ``left``: (H, W); ``right``: (H+sy-1, W+sx-1), numpy arrays or tensors.
    Returns a :class:`DisparityMap` of shape (H-kh+1, W-kw+1) whose dx/dy
    are offsets in [0, sx) x [0, sy) (callers add the search-region
    minimum); with ``return_cost`` also the best metric. Census codes are
    computed over the whole frames. On the card the search runs the CUDA
    sweep (``ops/sweep.py:search_frame``); ``device=None`` = the card."""
    from visionworkbench_torch.ops.sweep import search_frame  # imports this module
    sx, sy, kw, kh = _check_args(search_volume, kernel_size)
    dev = resolve_device(device)
    left = as_tensor(left, torch.float32, dev)
    right = as_tensor(right, torch.float32, dev)
    h, w = left.shape
    if tuple(right.shape) != (h + sy - 1, w + sx - 1):
        raise ArgumentErr(
            f"best_of_search_convolution: right must be (H+sy-1, W+sx-1) = "
            f"{(h + sy - 1, w + sx - 1)}, got {tuple(right.shape)}")
    if cost_type not in COST_TYPES:
        raise ArgumentErr(f"Unknown cost type {cost_type!r}")
    disp, valid, best = search_frame(left, right, sx, sy, kw, kh, cost_type,
                                     int(census_window), want_best=return_cost)
    if return_cost:
        return DisparityMap(disp, valid), best
    return DisparityMap(disp, valid)


def calc_disparity(cost_type: str, left_in, right_in, left_region,
                   search_volume, kernel_size, census_window: int = 5,
                   device=None) -> DisparityMap:
    """Region-level wrapper (ref ``calc_disparity``, Correlation.cc:330-375):
    crops left to ``left_region`` (a ``BBox2i``) and right to
    ``left_region + search_volume - 1``, then searches. Output size is
    ``left_region.size - kernel_size + 1``."""
    dev = resolve_device(device)
    left_in = as_tensor(left_in, torch.float32, dev)
    right_in = as_tensor(right_in, torch.float32, dev)
    sx, sy, kw, kh = _check_args(search_volume, kernel_size)
    if kw > left_region.width or kh > left_region.height:
        raise ArgumentErr("calc_disparity: Kernel size too large for active region.")
    y0, x0 = left_region.min_y, left_region.min_x
    left = left_in[y0:left_region.max_y, x0:left_region.max_x]
    right = right_in[y0:left_region.max_y + sy - 1, x0:left_region.max_x + sx - 1]
    return best_of_search_convolution(left, right, (sx, sy), (kw, kh),
                                      cost_type, census_window, device=dev)
