"""Nearest-neighbor search (port of ``visionworkbench_tpu/math/nearest.py``;
ref ``FLANNTree``, ``src/vw/Math/FLANNTree.h:32-111``).

The reference wraps FLANN's approximate kd-tree; here, as in the JAX
package, the search is exact brute force: all pairwise distances (one
matmul for l2, xor + popcount for Hamming) and the k nearest by a stable
ascending sort (the lower index first among equal distances, as
``lax.top_k`` orders them).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from visionworkbench_torch.core.device import as_tensor, resolve_device
from visionworkbench_torch.core.exceptions import ArgumentErr


def _knn_l2(data, queries, k: int):
    d2 = ((queries * queries).sum(-1)[:, None] + (data * data).sum(-1)[None, :]
          - 2.0 * queries @ data.T)
    vals, idx = torch.sort(d2, dim=1, stable=True)
    return idx[:, :k], torch.sqrt(torch.clamp_min(vals[:, :k], 0.0))


def _popcount32(x):
    """Set bits of each int64 element holding a 32-bit value (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _knn_hamming(data, queries, k: int):
    dist = _popcount32(queries[:, None, :] ^ data[None, :, :]).sum(-1)
    vals, idx = torch.sort(dist, dim=1, stable=True)
    return idx[:, :k], vals[:, :k].to(torch.int32)


class NearestNeighbors:
    """knn_search over a fixed dataset (ref ``FLANNTree::knn_search``), on
    ``device`` (``None`` = the card). Hamming data are 32-bit unsigned
    words."""

    def __init__(self, data, metric: str = "l2", device=None):
        if metric not in ("l2", "hamming"):
            raise ArgumentErr(f"unknown metric {metric!r}")
        self.metric = metric
        self.device = resolve_device(device)
        self.data = self._as(data)
        if self.data.ndim != 2:
            raise ArgumentErr("NearestNeighbors expects (N, D) data")

    def _as(self, x) -> torch.Tensor:
        if self.metric == "l2":
            return as_tensor(x, torch.float32, self.device)
        words = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
        return torch.as_tensor(words.astype(np.uint32).astype(np.int64),
                               device=self.device)

    def knn_search(self, queries, k: int = 1) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (indices (Q, k), distances (Q, k))."""
        q = self._as(queries)
        if q.ndim == 1:
            q = q[None]
        k = min(k, self.data.shape[0])
        search = _knn_l2 if self.metric == "l2" else _knn_hamming
        idx, dist = search(self.data, q, k)
        return idx.cpu().numpy().astype(np.int32), dist.cpu().numpy()

    @property
    def size(self) -> int:
        return int(self.data.shape[0])
