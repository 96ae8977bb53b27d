"""Statistics accumulators (port of ``visionworkbench_tpu/math/statistics.py``;
ref ``src/vw/Math/CDFAccumulator.cc``, ``GaussianClustering.h``,
``RandomSet.cc``). Host NumPy, as in the JAX package: the code is its code,
copied (``gaussian_clustering`` is EM over a 1D sample on the host)."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from visionworkbench_torch.core.exceptions import ArgumentErr


class CDFAccumulator:
    """Streaming quantile estimator (the role of the reference's P2-style
    ``CDFAccumulator``): accumulates batches, serves quantiles from a merged
    reservoir — bounded memory, deterministic."""

    def __init__(self, buffer_size: int = 4096, seed: int = 0):
        self.buffer_size = int(buffer_size)
        self._samples = np.zeros(0, np.float64)
        self._count = 0
        self._rng = np.random.default_rng(seed)

    def update(self, values) -> None:
        v = np.asarray(values, np.float64).ravel()
        v = v[np.isfinite(v)]
        self._count += v.size
        merged = np.concatenate([self._samples, v])
        if merged.size > self.buffer_size:
            idx = self._rng.choice(merged.size, self.buffer_size, replace=False)
            merged = merged[np.sort(idx)]
        self._samples = merged

    def quantile(self, q: float) -> float:
        if self._samples.size == 0:
            raise ArgumentErr("CDFAccumulator: no samples")
        return float(np.quantile(self._samples, q))

    def median(self) -> float:
        return self.quantile(0.5)

    def approximate_mean(self) -> float:
        return float(self._samples.mean())

    def approximate_stddev(self) -> float:
        return float(self._samples.std())

    @property
    def count(self) -> int:
        return self._count


def gaussian_clustering(values, num_clusters: int = 2, iterations: int = 20,
                        seed: int = 0) -> List[Tuple[float, float, float]]:
    """1D Gaussian mixture EM (ref ``GaussianClustering.h`` — used by the
    water-detection tools to split histograms). Returns
    [(weight, mean, variance)] sorted by mean."""
    v = np.asarray(values, np.float64).ravel()
    v = v[np.isfinite(v)]
    if v.size < num_clusters:
        raise ArgumentErr("gaussian_clustering: too few samples")
    rng = np.random.default_rng(seed)
    qs = np.linspace(0.1, 0.9, num_clusters)
    means = np.quantile(v, qs)
    variances = np.full(num_clusters, v.var() / num_clusters + 1e-12)
    weights = np.full(num_clusters, 1.0 / num_clusters)
    for _ in range(iterations):
        # E step
        resp = np.stack([
            w / np.sqrt(2 * np.pi * var) *
            np.exp(-0.5 * (v - m) ** 2 / var)
            for w, m, var in zip(weights, means, variances)])
        resp = resp / np.maximum(resp.sum(axis=0, keepdims=True), 1e-300)
        # M step
        nk = resp.sum(axis=1)
        weights = nk / v.size
        means = (resp @ v) / np.maximum(nk, 1e-300)
        variances = np.maximum(
            (resp * (v[None] - means[:, None]) ** 2).sum(axis=1) /
            np.maximum(nk, 1e-300), 1e-12)
    order = np.argsort(means)
    return [(float(weights[i]), float(means[i]), float(variances[i]))
            for i in order]


def random_set(total: int, count: int, seed: int = 0) -> np.ndarray:
    """Random subset of [0, total) without replacement (ref ``RandomSet.cc``)."""
    if count >= total:
        return np.arange(total)
    return np.sort(np.random.default_rng(seed).choice(total, count,
                                                      replace=False))
