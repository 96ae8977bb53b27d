"""Integer block-matching search, plain PyTorch (port of
``visionworkbench_tpu/stereo/correlation.py``; ref
``src/vw/Stereo/Correlation.cc:30-137``, ``CostFunctions.h:143-236``).

Semantics kept from the JAX package:

* first-best-wins argmin in dy-major, then dx order (strict improvement only)
* running worst = max over the searched window (the reference's ``elif``
  worst update gives the same value)
* flat-region invalidation where best == worst, with the in-window argbest
  zeroed there

Window sums are exact fp32 sliding sums in a fixed order: column sums over
``kh`` rows first (row 0 first), then row sums of those over ``kw`` columns.
The CUDA sweep kernel (``ops/sweep.py``) adds in the same order, so the two
agree bit for bit on any input; on inputs quantized to the 1/256 grid every
window sum is exact and any order agrees with the JAX package too.

Only the absolute- and squared-difference costs are ported; census and NCC
raise :class:`ArgumentErr` until the census/NCC slice.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from visionworkbench_torch.core.device import resolve_device
from visionworkbench_torch.core.exceptions import ArgumentErr

# Cost function types (ref CostFunctionType enum, CostFunctions.h:143-150)
ABSOLUTE_DIFFERENCE = "abs"
SQUARED_DIFFERENCE = "sq"
CROSS_CORRELATION = "ncc"
CENSUS_TRANSFORM = "census"
TERNARY_CENSUS_TRANSFORM = "ternary_census"

COST_TYPES = (ABSOLUTE_DIFFERENCE, SQUARED_DIFFERENCE, CROSS_CORRELATION,
              CENSUS_TRANSFORM, TERNARY_CENSUS_TRANSFORM)
PORTED_COST_TYPES = (ABSOLUTE_DIFFERENCE, SQUARED_DIFFERENCE)


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


def check_cost_type(cost_type: str) -> None:
    if cost_type in PORTED_COST_TYPES:
        return
    if cost_type in COST_TYPES:
        raise ArgumentErr(
            f"cost_type {cost_type!r} is not ported yet (census and NCC "
            "come with the census/NCC slice of the port)")
    raise ArgumentErr(f"unknown cost_type {cost_type!r}")


def _cost(left: torch.Tensor, right: torch.Tensor, cost_type: str):
    d = left - right
    if cost_type == ABSOLUTE_DIFFERENCE:
        return d.abs()
    return d * d


def _box_sum(c: torch.Tensor, kw: int, kh: int) -> torch.Tensor:
    """'valid' box sum over the last two axes in the kernel's order:
    column sums (rows added top to bottom), then row sums (left to right)."""
    oh, ow = c.shape[-2] - kh + 1, c.shape[-1] - kw + 1
    col = c[..., 0:oh, :]
    for i in range(1, kh):
        col = col + c[..., i:i + oh, :]
    out = col[..., :, 0:ow]
    for j in range(1, kw):
        out = out + col[..., :, j:j + ow]
    return out


def _sweep(left, right, sx: int, sy: int, kw: int, kh: int, cost_type: str,
           ring: int):
    """Search over the window [0, sx) x [0, sy), with ``ring`` extra
    candidates on every side kept for the 3x3 patches. Leading batch axes
    of ``left``/``right`` are carried through."""
    check_cost_type(cost_type)
    h, w = left.shape[-2], left.shape[-1]
    sx_e, sy_e = sx + 2 * ring, sy + 2 * ring
    if right.shape[-2] != h + sy_e - 1 or right.shape[-1] != w + sx_e - 1:
        raise ArgumentErr(
            f"search: right {tuple(right.shape[-2:])} must be "
            f"({h + sy_e - 1}, {w + sx_e - 1}) for left {(h, w)}, window "
            f"{sx}x{sy}, ring {ring}")
    oh, ow = h - kh + 1, w - kw + 1
    lead = left.shape[:-2]
    best = left.new_full(lead + (oh, ow), float("inf"))
    worst = left.new_full(lead + (oh, ow), float("-inf"))
    arg = torch.zeros(lead + (oh, ow), dtype=torch.int32, device=left.device)
    vol = []
    for ey in range(sy_e):
        for ex in range(sx_e):
            interior = ring <= ey < ring + sy and ring <= ex < ring + sx
            if not (interior or ring):
                continue
            s = _box_sum(_cost(left, right[..., ey:ey + h, ex:ex + w],
                               cost_type), kw, kh)
            if ring:
                vol.append(s)
            if interior:
                better = s < best
                best = torch.where(better, s, best)
                arg = torch.where(better, (ey - ring) * sx + (ex - ring), arg)
                worst = torch.maximum(worst, s)
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
                    cost_type: str):
    """Disparity sweep over ``right`` sized (H + sy - 1, W + sx - 1). Returns
    ``(disp (..., oh, ow, 2) int32 (dx, dy), valid, best)``."""
    disp, valid, best, _ = _sweep(left, right, sx, sy, kw, kh, cost_type, 0)
    return disp, valid, best


def _search_with_patches(left, right, sx: int, sy: int, kw: int, kh: int,
                         cost_type: str):
    """Sweep over an extended ±1 ring: ``right`` is sized
    (H + sy + 1, W + sx + 1). disp/valid/best are those of
    :func:`_best_of_search` over the interior window; ``patch``
    (..., oh, ow, 9) holds the costs at ``d + (dy, dx)``, dx fastest."""
    return _sweep(left, right, sx, sy, kw, kh, cost_type, 1)
