"""Point-cloud spatial chipping (port of
``visionworkbench_tpu/cartography/chipper.py``, its NumPy code copied; ref
``Chipper.cc``, ``src/vw/Cartography/Chipper.cc``, LASlib-derived):
partition a 2D point set into compact chips of bounded size for blockwise
processing. Host NumPy."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from visionworkbench_torch.core.exceptions import ArgumentErr


def chip_points(points: np.ndarray, capacity: int = 1024
                ) -> List[np.ndarray]:
    """Recursively split points (N, >=2) on the wider axis at the median
    until every chip holds <= capacity points (the reference's alternating
    x/y median splits). Returns index arrays per chip, preserving locality."""
    points = np.asarray(points)
    if points.ndim != 2 or points.shape[1] < 2:
        raise ArgumentErr("chip_points expects (N, >=2) points")
    if capacity < 1:
        raise ArgumentErr("capacity must be >= 1")
    chips: List[np.ndarray] = []

    def split(idx: np.ndarray):
        if len(idx) <= capacity:
            if len(idx):
                chips.append(idx)
            return
        pts = points[idx]
        spans = pts[:, :2].max(axis=0) - pts[:, :2].min(axis=0)
        axis = int(np.argmax(spans))
        order = np.argsort(pts[:, axis], kind="stable")
        half = len(idx) // 2
        split(idx[order[:half]])
        split(idx[order[half:]])

    split(np.arange(len(points)))
    return chips


def chip_bounds(points: np.ndarray, chips: List[np.ndarray]
                ) -> List[Tuple[float, float, float, float]]:
    """(min_x, min_y, max_x, max_y) per chip."""
    out = []
    for idx in chips:
        p = np.asarray(points)[idx]
        out.append((float(p[:, 0].min()), float(p[:, 1].min()),
                    float(p[:, 0].max()), float(p[:, 1].max())))
    return out
