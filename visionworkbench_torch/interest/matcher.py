"""Descriptor matching (port of ``visionworkbench_tpu/interest/matcher.py``;
ref ``src/vw/InterestPoint/Matcher.h:56-260``).

The reference uses a FLANN kd-tree 2-NN + Lowe ratio test; here, as in
the JAX package, brute force: all pairwise distances are one matmul
(|a|^2 + |b|^2 - 2 a.b), exact (FLANN is approximate). The Hamming metric
for byte descriptors (``HammingMetric``, Matcher.h:63-68 +
``FLANNTree.h:32-111``) unpacks the bits, so hamming(a, b) =
|a|_1 + |b|_1 - 2 a.b is a 0/1 matmul, exact in fp32. The two nearest are
the row minimum at its first index and the minimum of the rest — the
order of ``lax.top_k`` (the lower index first among equal distances). The
reference's match constraints (``Matcher.h:113-149``) apply to each
point's nearest neighbor like ``check_constraint`` (Matcher.h:262-277):
post-hoc on the top match, both directions when bidirectional.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.interest.types import InterestPoints

DEFAULT_RATIO = 0.6  # ref InterestPointMatcher threshold


class Matches(NamedTuple):
    index1: torch.Tensor   # (K,) int32 into set 1
    index2: torch.Tensor   # (K,) int32 into set 2
    distance: torch.Tensor
    valid: torch.Tensor    # (K,) bool


@dataclass(frozen=True)
class ScaleOrientationConstraint:
    """Allowed scale ratio / orientation delta between a point and its
    match (ref ``ScaleOrientationConstraint``, Matcher.h:113-130; defaults
    Matcher.cc:119-133 — orientation delta wrapped into [-pi, pi])."""
    scale_ratio_min: float = 0.9
    scale_ratio_max: float = 1.1
    ori_diff_min: float = -0.1
    ori_diff_max: float = 0.1

    def mask(self, base: InterestPoints, bi, test: InterestPoints, ti):
        """(test vs baseline) acceptance, vectorized over index tensors —
        baseline is the matched point, test the query, like the reference's
        ``check_constraint(nearest, ip)`` call order."""
        sr = test.scale[ti] / base.scale[bi]
        od = test.orientation[ti] - base.orientation[bi]
        od = torch.where(od < -math.pi, od + 2 * math.pi, od)
        od = torch.where(od > math.pi, od - 2 * math.pi, od)
        return ((sr >= self.scale_ratio_min) & (sr <= self.scale_ratio_max)
                & (od >= self.ori_diff_min) & (od <= self.ori_diff_max))


@dataclass(frozen=True)
class PositionConstraint:
    """Allowed (test - baseline) position window (ref
    ``PositionConstraint``, Matcher.h:132-149; Matcher.cc:136-147)."""
    min_x: float = -10.0
    max_x: float = 10.0
    min_y: float = -10.0
    max_y: float = 10.0

    def mask(self, base: InterestPoints, bi, test: InterestPoints, ti):
        dx = test.x[ti] - base.x[bi]
        dy = test.y[ti] - base.y[bi]
        return ((dx >= self.min_x) & (dx <= self.max_x)
                & (dy >= self.min_y) & (dy <= self.max_y))


Constraint = Union[ScaleOrientationConstraint, PositionConstraint]


def _pairwise_sq_dists(d1, d2):
    n1 = (d1 * d1).sum(dim=1)[:, None]
    n2 = (d2 * d2).sum(dim=1)[None, :]
    return torch.clamp_min(n1 + n2 - 2 * (d1 @ d2.T), 0.0)


def _pairwise_hamming(d1, d2):
    """Pairwise hamming distances between byte-valued descriptors (each
    element an integer in [0, 256)): bit-unpack to (N, 8*D) 0/1 planes,
    then hamming = |a|_1 + |b|_1 - 2 a.b, exact in fp32 (counts are small
    integers). Ref ``HammingMetric``, Matcher.cc:47-103 (XOR + popcount)."""
    shifts = torch.arange(8, device=d1.device)

    def bits(d):
        planes = (d.to(torch.int32)[..., None] >> shifts) & 1      # (N, D, 8)
        return planes.reshape(d.shape[0], -1).to(torch.float32)
    b1, b2 = bits(d1), bits(d2)
    n1 = b1.sum(dim=1)[:, None]
    n2 = b2.sum(dim=1)[None, :]
    return n1 + n2 - 2.0 * (b1 @ b2.T)


def _match(d1, d2, v1, v2, ratio: float, bidirectional: bool, metric: str = "l2"):
    big = 1e30
    dist = _pairwise_hamming(d1, d2) if metric == "hamming" else _pairwise_sq_dists(d1, d2)
    dist = torch.where(v1[:, None] & v2[None, :], dist, big)
    nn = torch.argmin(dist, dim=1)             # the first minimum
    best = dist.gather(1, nn[:, None])[:, 0]
    rest = dist.scatter(1, nn[:, None], float("inf"))
    second = rest.amin(dim=1) if rest.shape[1] > 1 else torch.full_like(best, float("inf"))
    # Lowe ratio on squared L2: ||a|| < r * ||b||  <=>  a2 < r^2 * b2.
    # (Hamming is linear, so the ratio applies to the distance directly —
    # the reference compares whatever the metric returns, Matcher.h:374.)
    r = torch.tensor(ratio, dtype=torch.float32, device=d1.device)
    r2 = r if metric == "hamming" else r * r
    ok = (best < r2 * second) & v1 & (best < big)
    if bidirectional:
        rev_nn = torch.argmin(dist, dim=0)
        ok = ok & (rev_nn[nn] == torch.arange(d1.shape[0], device=d1.device))
    return nn, torch.sqrt(best) if metric == "l2" else best, ok


def match_points(p1: InterestPoints, p2: InterestPoints,
                 ratio: float = DEFAULT_RATIO,
                 bidirectional: bool = False,
                 metric: str = "l2",
                 constraint: Optional[Constraint] = None) -> Matches:
    """2-NN ratio-test matching (ref ``InterestPointMatcher::operator()``,
    Matcher.h:157-260; 'bimatch' = bidirectional consistency), on the
    points' device.

    ``metric``: 'l2' (default) or 'hamming' (binary/byte descriptors).
    ``constraint``: optional :class:`ScaleOrientationConstraint` /
    :class:`PositionConstraint`, applied to each query's nearest neighbor
    exactly like the reference's ``check_constraint`` (baseline = the
    matched p2 point, test = the p1 query; both directions when
    ``bidirectional``)."""
    if p1.descriptor is None or p2.descriptor is None:
        raise ArgumentErr("match_points: both point sets need descriptors")
    if metric not in ("l2", "hamming"):
        raise ArgumentErr(f"match_points: unknown metric {metric!r}")
    nn, d, ok = _match(p1.descriptor, p2.descriptor, p1.valid, p2.valid,
                       ratio, bidirectional, metric)
    idx1 = torch.arange(p1.capacity, dtype=torch.int64, device=nn.device)
    if constraint is not None:
        cm = constraint.mask(p2, nn, p1, idx1)
        if bidirectional:
            cm = cm & constraint.mask(p1, idx1, p2, nn)
        ok = ok & cm
    return Matches(idx1.to(torch.int32), nn.to(torch.int32), d, ok)


def remove_duplicates(pts1: np.ndarray, pts2: np.ndarray):
    """Prune matches so no coordinate appears twice on EITHER side,
    keeping the LAST occurrence of each repeated coordinate (ref
    ``remove_duplicates``, Matcher.cc — reverse scan with (x, y) sets,
    order restored). Host-side on (N, 2) matched coordinate arrays (the
    form :func:`matched_coordinates` returns); returns filtered copies."""
    pts1 = np.asarray(pts1)
    pts2 = np.asarray(pts2)
    if pts1.shape != pts2.shape:
        raise ArgumentErr("remove_duplicates: input arrays differ in shape")
    seen1, seen2 = set(), set()
    keep = []
    for j in range(len(pts1) - 1, -1, -1):
        k1 = (float(pts1[j, 0]), float(pts1[j, 1]))
        k2 = (float(pts2[j, 0]), float(pts2[j, 1]))
        if k1 in seen1 or k2 in seen2:
            continue
        seen1.add(k1)
        seen2.add(k2)
        keep.append(j)
    keep.reverse()
    return pts1[keep], pts2[keep]


def matched_coordinates(p1: InterestPoints, p2: InterestPoints,
                        m: Matches) -> Tuple[np.ndarray, np.ndarray]:
    """Host (N, 2) matched coordinate arrays (for RANSAC / transforms): one
    read-back of each point set and of the matches."""
    ok = m.valid.cpu().numpy()
    i1 = m.index1.cpu().numpy()[ok]
    i2 = m.index2.cpu().numpy()[ok]
    xy1 = torch.stack([p1.x, p1.y], dim=-1).cpu().numpy()
    xy2 = torch.stack([p2.x, p2.y], dim=-1).cpu().numpy()
    return xy1[i1], xy2[i2]
