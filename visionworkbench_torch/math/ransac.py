"""RANSAC robust estimation (port of ``visionworkbench_tpu/math/ransac.py``;
ref ``src/vw/Math/RANSAC.h:109-332``).

All hypotheses are drawn at once on the host with NumPy's
``default_rng(seed)`` (so both packages draw the same minimal sets), fitted
together on the device in float32 by the batched fitters, and scored as
one (B, N) error matrix; the first hypothesis with the most inliers wins.
The final refit on its inliers runs on the host in float64, and the
inliers are re-evaluated under the refined model on the device. Error
metric: the reference's ``InterestPointErrorMetric``, ||T(p1) - p2||.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from visionworkbench_torch.core.device import resolve_device
from visionworkbench_torch.core.exceptions import ArgumentErr, MathErr
from visionworkbench_torch.math.geometry_fit import BATCHED_FITTERS, HOST_FITTERS
from visionworkbench_torch.math.transform2d import Transform2D


def _apply_batched(h, pts):
    """(B, 3, 3) x (N, 2) -> (B, N, 2): each homogeneous row summed in the
    order x, y, 1, then divided by w."""
    x, y = pts[:, 0], pts[:, 1]
    out = [h[:, i, 0:1] * x + h[:, i, 1:2] * y + h[:, i, 2:3] for i in range(3)]
    return torch.stack([out[0] / out[2], out[1] / out[2]], dim=-1)


def ransac(p1, p2, model: str = "homography", inlier_threshold: float = 10.0,
           num_iterations: int = 100, min_num_output_inliers: Optional[int] = None,
           seed: int = 0, reduce_min_num_output: bool = True, device=None
           ) -> Tuple[Transform2D, np.ndarray]:
    """Fit a 2D transform robustly; returns (transform, inlier_indices)
    (ref ``RandomSampleConsensus::operator()``, RANSAC.h:187-332; defaults
    mirror ``ipmatch``: 100 iterations, 10 px threshold). The hypotheses
    are fitted and scored on ``device`` (``None`` = the card).

    ``min_num_output_inliers`` defaults to half the correspondences as in the
    reference; with ``reduce_min_num_output`` the requirement relaxes (halves)
    rather than erroring when unmet, like the reference's retry loop.
    """
    p1 = np.asarray(p1, np.float64)
    p2 = np.asarray(p2, np.float64)
    if p1.shape != p2.shape or p1.ndim != 2 or p1.shape[1] != 2:
        raise ArgumentErr("ransac: p1/p2 must be matching (N, 2) arrays")
    n = len(p1)
    if model not in BATCHED_FITTERS:
        raise ArgumentErr(f"ransac: unknown model {model!r}")
    batched_fit, k = BATCHED_FITTERS[model]
    if n < k:
        raise MathErr(f"ransac: need at least {k} correspondences, got {n}")
    if min_num_output_inliers is None:
        min_num_output_inliers = n // 2
    dev = resolve_device(device)

    rng = np.random.default_rng(seed)
    idx = np.stack([rng.choice(n, size=k, replace=False)
                    for _ in range(num_iterations)])      # (B, k)

    d1 = torch.as_tensor(p1, dtype=torch.float32, device=dev)
    d2 = torch.as_tensor(p2, dtype=torch.float32, device=dev)
    sets = torch.as_tensor(idx, device=dev)
    h = batched_fit(d1[sets], d2[sets])                  # (B, 3, 3)
    proj = _apply_batched(h, d1)                         # (B, N, 2)
    err = torch.sqrt(((proj - d2[None]) ** 2).sum(-1))   # (B, N)
    inlier_mask = err < inlier_threshold
    best = int(torch.argmax(inlier_mask.sum(dim=1)))     # the first maximum
    best_mask = inlier_mask[best].cpu().numpy()
    best_count = int(best_mask.sum())

    min_required = int(min_num_output_inliers)
    while best_count < min_required:
        if not reduce_min_num_output or min_required <= k:
            raise MathErr(
                f"ransac: best model has {best_count} inliers; "
                f"needed {min_required}")
        min_required //= 2

    inliers = np.nonzero(best_mask)[0]
    # Final host refit on all inliers (ref RANSAC.h refinement step).
    host_fit, _ = HOST_FITTERS[model if model in HOST_FITTERS else "affine"]
    try:
        refined = host_fit(p1[inliers], p2[inliers])
    except (ArgumentErr, MathErr, np.linalg.LinAlgError):
        refined = h[best].double().cpu().numpy()
    t = Transform2D(refined)
    # Re-evaluate inliers under the refined model.
    hr = torch.as_tensor(refined, dtype=torch.float32, device=dev)[None]
    proj1 = _apply_batched(hr, d1)[0].cpu().numpy()
    err1 = np.sqrt(((proj1 - p2) ** 2).sum(-1))
    inliers = np.nonzero(err1 < inlier_threshold)[0]
    return t, inliers
