"""Small math utilities (port of ``visionworkbench_tpu/math/misc.py``; ref
``src/vw/Math/``: ``BresenhamLine.h``, ``DisjointSet.h``,
``MinimumSpanningTree.cc``, ``MatrixSparseSkyline.h``, ``PoseEstimation.h``,
Catmull-Rom splines, position/pose interpolation).

The host functions are the JAX package's NumPy code, copied.
:func:`catmull_rom` runs on tensors (fp32, on the input's device) and
:func:`interpolate_pose` on the port's fp32 ``slerp``, as the JAX package
runs them on its own.
"""

from __future__ import annotations

from typing import Dict, Hashable, List, Sequence, Tuple

import numpy as np
import torch

from visionworkbench_torch.core.device import on_device
from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.math.quaternion import slerp


def bresenham_line(x0: int, y0: int, x1: int, y1: int) -> np.ndarray:
    """Integer line pixels (ref ``BresenhamLine.h``); returns (N, 2) int array
    including both endpoints."""
    x0, y0, x1, y1 = int(x0), int(y0), int(x1), int(y1)
    dx, dy = abs(x1 - x0), -abs(y1 - y0)
    sx = 1 if x0 < x1 else -1
    sy = 1 if y0 < y1 else -1
    err = dx + dy
    pts = []
    x, y = x0, y0
    while True:
        pts.append((x, y))
        if x == x1 and y == y1:
            break
        e2 = 2 * err
        if e2 >= dy:
            err += dy
            x += sx
        if e2 <= dx:
            err += dx
            y += sy
    return np.asarray(pts, np.int64)


class DisjointSet:
    """Union-find (ref ``DisjointSet.h``)."""

    def __init__(self):
        self._parent: Dict[Hashable, Hashable] = {}
        self._rank: Dict[Hashable, int] = {}

    def insert(self, x: Hashable) -> Hashable:
        self._parent.setdefault(x, x)
        self._rank.setdefault(x, 0)
        return x

    def find(self, x: Hashable) -> Hashable:
        root = x
        while self._parent[root] != root:
            root = self._parent[root]
        while self._parent[x] != root:
            self._parent[x], x = root, self._parent[x]
        return root

    def union(self, a: Hashable, b: Hashable) -> Hashable:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return ra
        if self._rank[ra] < self._rank[rb]:
            ra, rb = rb, ra
        self._parent[rb] = ra
        if self._rank[ra] == self._rank[rb]:
            self._rank[ra] += 1
        return ra


def minimum_spanning_tree(num_nodes: int,
                          edges: Sequence[Tuple[float, int, int]]
                          ) -> List[Tuple[int, int]]:
    """Kruskal MST (ref ``MinimumSpanningTree.cc``); edges are
    (weight, node_a, node_b); returns kept (a, b) pairs."""
    ds = DisjointSet()
    for i in range(num_nodes):
        ds.insert(i)
    kept = []
    for w, a, b in sorted(edges):
        if ds.find(a) != ds.find(b):
            ds.union(a, b)
            kept.append((a, b))
    return kept


def solve_sparse_skyline(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Symmetric positive-definite banded/skyline solve (ref
    ``MatrixSparseSkyline.h`` — the BA normal-equation solver). Dense
    Cholesky here: the reference's skyline layout is a memory optimization
    that scipy/numpy's LAPACK path already handles well at these sizes."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    try:
        from scipy.linalg import cho_factor, cho_solve
        return cho_solve(cho_factor(a), b)
    except Exception:
        return np.linalg.solve(a, b)


def relative_orientation(v1, v2):
    """Quaternion rotating vector set v1 onto v2 in least squares
    (ref ``PoseEstimation.h``): Horn's closed-form via the Davenport q-matrix."""
    v1 = np.asarray(v1, np.float64)
    v2 = np.asarray(v2, np.float64)
    m = v2.T @ v1
    sxx, sxy, sxz = m[0]
    syx, syy, syz = m[1]
    szx, szy, szz = m[2]
    k = np.array([
        [sxx + syy + szz, szy - syz, sxz - szx, syx - sxy],
        [szy - syz, sxx - syy - szz, sxy + syx, szx + sxz],
        [sxz - szx, sxy + syx, -sxx + syy - szz, syz + szy],
        [syx - sxy, szx + sxz, syz + szy, -sxx - syy + szz]])
    w, v = np.linalg.eigh(k)
    q = v[:, -1]
    if q[0] < 0:
        q = -q
    return q / np.linalg.norm(q)


def catmull_rom(points, t, device=None):
    """Catmull-Rom spline through control points; ``t`` in [0, n-1]
    (ref spline support in ``src/vw/Math``). Vectorized over t, fp32. A
    tensor keeps its device (the other input follows it); arrays go to
    ``device`` (``None`` = the card)."""
    like = next((a for a in (t, points) if isinstance(a, torch.Tensor)), None)
    dev = like.device if like is not None else device
    pts = on_device(points, dev, torch.float32).to(dev)
    n = pts.shape[0]
    if n < 2:
        raise ArgumentErr("catmull_rom needs >= 2 control points")
    t = on_device(t, dev, torch.float32).to(pts.device)
    seg = torch.clamp(torch.floor(t).to(torch.int64), 0, n - 2)
    u = t - seg.to(torch.float32)
    i0 = torch.clamp(seg - 1, 0, n - 1)
    i1 = seg
    i2 = torch.clamp(seg + 1, 0, n - 1)
    i3 = torch.clamp(seg + 2, 0, n - 1)
    p0, p1, p2, p3 = pts[i0], pts[i1], pts[i2], pts[i3]
    u = u[..., None] if pts.ndim > 1 else u
    return 0.5 * ((2 * p1) + (-p0 + p2) * u +
                  (2 * p0 - 5 * p1 + 4 * p2 - p3) * u ** 2 +
                  (-p0 + 3 * p1 - 3 * p2 + p3) * u ** 3)


def interpolate_position(times, positions, t):
    """Piecewise-linear position interpolation (ref ``PositionInterp.cc``)."""
    times = np.asarray(times, np.float64)
    positions = np.asarray(positions, np.float64)
    t = np.asarray(t, np.float64)
    out = np.stack([np.interp(t, times, positions[:, k])
                    for k in range(positions.shape[1])], axis=-1)
    return out


def interpolate_pose(times, quats, t):
    """SLERP pose interpolation between bracketing samples
    (ref ``QuatInterp.cc`` / ``TimeInterp.cc``); fp32, on the host."""
    times = np.asarray(times, np.float64)
    quats = np.asarray(quats, np.float64)
    t = float(t)
    i = int(np.clip(np.searchsorted(times, t) - 1, 0, len(times) - 2))
    t0, t1 = times[i], times[i + 1]
    alpha = 0.0 if t1 == t0 else (t - t0) / (t1 - t0)
    return slerp(float(np.clip(alpha, 0, 1)),
                 torch.as_tensor(quats[i], dtype=torch.float32),
                 torch.as_tensor(quats[i + 1], dtype=torch.float32)).numpy()
