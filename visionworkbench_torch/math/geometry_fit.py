"""2D transform fitting from point correspondences (port of
``visionworkbench_tpu/math/geometry_fit.py``; ref
``src/vw/Math/Geometry.h:50-423``: HomographyFittingFunctor,
AffineFittingFunctor, SimilarityFittingFunctor,
TranslationRotationFittingFunctor, TranslationFittingFunctor).

Each fitter maps two (N, 2) point arrays (p1 -> p2) to a 3x3 matrix. The
host fitters are the JAX package's float64 NumPy code, copied: they serve
one-shot fits and RANSAC's final refit. The batched fitters take (B, k, 2)
float32 tensors of minimal sets (a leading hypothesis axis) and return
(B, 3, 3) matrices on the same device, for RANSAC's hypotheses; they use
``torch.linalg`` (SVD, solve, det) as the JAX package uses ``jnp.linalg``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from visionworkbench_torch.core.exceptions import ArgumentErr, MathErr


def _normalize_points(pts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Hartley normalization: translate to centroid, scale to mean dist sqrt(2)."""
    centroid = pts.mean(axis=0)
    d = np.sqrt(((pts - centroid) ** 2).sum(axis=1)).mean()
    s = np.sqrt(2.0) / max(d, 1e-12)
    t = np.array([[s, 0, -s * centroid[0]],
                  [0, s, -s * centroid[1]],
                  [0, 0, 1]], np.float64)
    homo = np.hstack([pts, np.ones((len(pts), 1))])
    return (t @ homo.T).T, t


def fit_homography(p1, p2) -> np.ndarray:
    """Normalized DLT homography (ref ``HomographyFittingFunctor``,
    Geometry.h:50-196; min 4 correspondences)."""
    p1 = np.asarray(p1, np.float64)
    p2 = np.asarray(p2, np.float64)
    n = len(p1)
    if n < 4:
        raise ArgumentErr("fit_homography: need >= 4 correspondences")
    q1, t1 = _normalize_points(p1)
    q2, t2 = _normalize_points(p2)
    a = np.zeros((2 * n, 9), np.float64)
    for i in range(n):
        x, y, _ = q1[i]
        u, v, _ = q2[i]
        a[2 * i] = [-x, -y, -1, 0, 0, 0, u * x, u * y, u]
        a[2 * i + 1] = [0, 0, 0, -x, -y, -1, v * x, v * y, v]
    _, _, vt = np.linalg.svd(a)
    h = vt[-1].reshape(3, 3)
    h = np.linalg.inv(t2) @ h @ t1
    if abs(h[2, 2]) < 1e-15:
        raise MathErr("fit_homography: degenerate configuration")
    return h / h[2, 2]


def fit_affine(p1, p2) -> np.ndarray:
    """Least-squares affine (ref ``AffineFittingFunctor``, Geometry.h:198;
    min 3 correspondences)."""
    p1 = np.asarray(p1, np.float64)
    p2 = np.asarray(p2, np.float64)
    if len(p1) < 3:
        raise ArgumentErr("fit_affine: need >= 3 correspondences")
    a = np.hstack([p1, np.ones((len(p1), 1))])
    coef, *_ = np.linalg.lstsq(a, p2, rcond=None)   # (3, 2)
    m = np.eye(3)
    m[:2, :2] = coef[:2].T
    m[:2, 2] = coef[2]
    return m


def fit_similarity(p1, p2) -> np.ndarray:
    """Umeyama similarity fit (ref ``SimilarityFittingFunctor``,
    Geometry.h:283; min 2 correspondences)."""
    p1 = np.asarray(p1, np.float64)
    p2 = np.asarray(p2, np.float64)
    if len(p1) < 2:
        raise ArgumentErr("fit_similarity: need >= 2 correspondences")
    mu1, mu2 = p1.mean(axis=0), p2.mean(axis=0)
    q1, q2 = p1 - mu1, p2 - mu2
    cov = q2.T @ q1 / len(p1)
    u, d, vt = np.linalg.svd(cov)
    s = np.eye(2)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s[1, 1] = -1
    r = u @ s @ vt
    var1 = (q1 ** 2).sum() / len(p1)
    scale = np.trace(np.diag(d) @ s) / max(var1, 1e-300)
    m = np.eye(3)
    m[:2, :2] = scale * r
    m[:2, 2] = mu2 - scale * r @ mu1
    return m


def fit_translation_rotation(p1, p2) -> np.ndarray:
    """Rigid (rotation + translation) fit (ref
    ``TranslationRotationFittingFunctor``, Geometry.h:423)."""
    p1 = np.asarray(p1, np.float64)
    p2 = np.asarray(p2, np.float64)
    if len(p1) < 2:
        raise ArgumentErr("fit_translation_rotation: need >= 2 correspondences")
    mu1, mu2 = p1.mean(axis=0), p2.mean(axis=0)
    q1, q2 = p1 - mu1, p2 - mu2
    cov = q2.T @ q1
    u, _, vt = np.linalg.svd(cov)
    s = np.eye(2)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s[1, 1] = -1
    r = u @ s @ vt
    m = np.eye(3)
    m[:2, :2] = r
    m[:2, 2] = mu2 - r @ mu1
    return m


def fit_translation(p1, p2) -> np.ndarray:
    """Mean-offset translation (ref ``TranslationFittingFunctor``)."""
    p1 = np.asarray(p1, np.float64)
    p2 = np.asarray(p2, np.float64)
    m = np.eye(3)
    m[:2, 2] = (p2 - p1).mean(axis=0)
    return m


# ---------------------------------------------------------------------------
# Batched fitters for RANSAC hypothesis generation: (B, k, 2) minimal sets
# -> (B, 3, 3) matrices, float32, on the sets' device.
# ---------------------------------------------------------------------------

def _eyes(b: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).repeat(b, 1, 1)


def batched_fit_homography(p1, p2):
    """Unnormalized DLT on raw coordinates: the null vector of each (2k, 9)
    system, scaled so h[2, 2] = 1."""
    b, n, _ = p1.shape
    ones = torch.ones((b, n, 1), dtype=p1.dtype, device=p1.device)
    x, y = p1[..., 0:1], p1[..., 1:2]
    u, v = p2[..., 0:1], p2[..., 1:2]
    z = torch.zeros_like(x)
    row1 = torch.cat([-x, -y, -ones, z, z, z, u * x, u * y, u], dim=-1)
    row2 = torch.cat([z, z, z, -x, -y, -ones, v * x, v * y, v], dim=-1)
    a = torch.cat([row1, row2], dim=1)                 # (B, 2n, 9)
    _, _, vt = torch.linalg.svd(a, full_matrices=True)
    h = vt[:, -1, :].reshape(b, 3, 3)
    return h / h[:, 2:3, 2:3]


def batched_fit_affine(p1, p2):
    """Normal equations of each set; a singular system gives a non-finite
    matrix (no inliers), as LU does in the JAX package."""
    b, n, _ = p1.shape
    a = torch.cat([p1, torch.ones((b, n, 1), dtype=p1.dtype, device=p1.device)], dim=-1)
    ata = torch.einsum("bni,bnj->bij", a, a)
    atb = torch.einsum("bni,bnk->bik", a, p2)
    coef, _ = torch.linalg.solve_ex(ata, atb)           # (B, 3, 2)
    m = _eyes(b, p1)
    m[:, :2, :2] = coef[:, :2, :].transpose(1, 2)
    m[:, :2, 2] = coef[:, 2, :]
    return m


def batched_fit_similarity(p1, p2):
    mu1 = p1.mean(dim=1, keepdim=True)
    mu2 = p2.mean(dim=1, keepdim=True)
    q1, q2 = p1 - mu1, p2 - mu2
    cov = torch.einsum("bni,bnj->bij", q2, q1) / p1.shape[1]
    u, d, vt = torch.linalg.svd(cov)
    det = torch.linalg.det(u) * torch.linalg.det(vt)
    s_diag = torch.stack([torch.ones_like(det), torch.sign(det)], dim=-1)
    r = torch.einsum("bij,bj,bjk->bik", u, s_diag, vt)
    var1 = (q1 ** 2).sum(dim=(1, 2)) / p1.shape[1]
    scale = (d * s_diag).sum(dim=-1) / torch.clamp_min(var1, 1e-30)
    m = _eyes(p1.shape[0], p1)
    m[:, :2, :2] = scale[:, None, None] * r
    m[:, :2, 2] = mu2[:, 0] - torch.einsum("b,bij,bj->bi", scale, r, mu1[:, 0])
    return m


def batched_fit_translation(p1, p2):
    m = _eyes(p1.shape[0], p1)
    m[:, :2, 2] = (p2 - p1).mean(dim=1)
    return m


BATCHED_FITTERS = {
    "homography": (batched_fit_homography, 4),
    "affine": (batched_fit_affine, 3),
    "similarity": (batched_fit_similarity, 2),
    "translation": (batched_fit_translation, 1),
}

HOST_FITTERS = {
    "homography": (fit_homography, 4),
    "affine": (fit_affine, 3),
    "similarity": (fit_similarity, 2),
    "translation_rotation": (fit_translation_rotation, 2),
    "translation": (fit_translation, 1),
}
