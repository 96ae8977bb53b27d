"""Sparse patch overlay (a copy of ``visionworkbench_tpu/image/sparse.py``,
NumPy only, on the port's own ``BBox2i``; ref ``SparseView``,
``src/vw/Image/SparseView.h``): a base value plus a dictionary of
positioned patches, materializable over any region — used for sparse
annotations/corrections over huge images."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from visionworkbench_torch.math.bbox import BBox2i


class SparseView:
    def __init__(self, rows: int, cols: int, background: float = 0.0,
                 dtype=np.float32):
        self.rows, self.cols = int(rows), int(cols)
        self.background = background
        self.dtype = np.dtype(dtype)
        self._patches: Dict[Tuple[int, int], np.ndarray] = {}

    def insert(self, patch: np.ndarray, x: int, y: int) -> None:
        self._patches[(int(x), int(y))] = np.asarray(patch, self.dtype)

    def __call__(self, x: int, y: int):
        for (px, py), patch in self._patches.items():
            if py <= y < py + patch.shape[0] and px <= x < px + patch.shape[1]:
                return patch[y - py, x - px]
        return self.dtype.type(self.background)

    def rasterize(self, bbox: Optional[BBox2i] = None) -> np.ndarray:
        if bbox is None:
            bbox = BBox2i(0, 0, self.cols, self.rows)
        out = np.full((int(bbox.height), int(bbox.width)), self.background,
                      self.dtype)
        for (px, py), patch in self._patches.items():
            sy0 = max(bbox.min_y, py)
            sy1 = min(bbox.max_y, py + patch.shape[0])
            sx0 = max(bbox.min_x, px)
            sx1 = min(bbox.max_x, px + patch.shape[1])
            if sy1 <= sy0 or sx1 <= sx0:
                continue
            out[sy0 - bbox.min_y:sy1 - bbox.min_y,
                sx0 - bbox.min_x:sx1 - bbox.min_x] = \
                patch[sy0 - py:sy1 - py, sx0 - px:sx1 - px]
        return out
