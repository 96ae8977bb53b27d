"""The port's fitters and RANSAC (``visionworkbench_torch/math/{geometry_fit,
ransac, nearest}.py``) and the matcher (``interest/matcher.py``) against
the JAX package on the CPU, on seeded NumPy inputs.

Tolerances: the host fitters (the same float64 NumPy code), RANSAC's
draws, inlier indices and refit, ``remove_duplicates``, Hamming
distances and their matches are exact. The batched float32 fitters map
their minimal sets' points within ``REPROJECTION`` px of the JAX
package's matrices: the unnormalized DLT's SVD null vector of raw pixel
coordinates differs in its low bits between LAPACK builds, the normal
equations' solve and the 2x2 SVD less so (measured: homography 0.023,
affine 3.9e-4, similarity 1.1e-5, translation 0). l2 squared
distances within 1e-6 of |a|^2 + |b|^2 (a matmul summed in another
order), their matches equal.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import _torch_threads, cuda  # noqa: F401
import visionworkbench_tpu.interest.matcher as jmat
import visionworkbench_tpu.interest.types as jtypes
import visionworkbench_tpu.math.geometry_fit as jfit
import visionworkbench_tpu.math.nearest as jnear
from visionworkbench_tpu.math.ransac import ransac as jransac
import visionworkbench_torch.interest.matcher as tmat
import visionworkbench_torch.interest.types as ttypes
import visionworkbench_torch.math.geometry_fit as tfit
import visionworkbench_torch.math.nearest as tnear
from visionworkbench_torch.core.exceptions import ArgumentErr, MathErr

# the package exports the function under the module's name, as the JAX package
tran = importlib.import_module("visionworkbench_torch.math.ransac")

TRUE = {
    "homography": np.array([[1.02, 0.01, 5.0], [-0.02, 0.98, -3.0], [1e-5, -2e-5, 1.0]]),
    "affine": np.array([[1.03, 0.02, 4.0], [-0.05, 0.97, -6.0], [0, 0, 1.0]]),
    "similarity": np.array([[0.98 * np.cos(0.1), -0.98 * np.sin(0.1), 7.0],
                            [0.98 * np.sin(0.1), 0.98 * np.cos(0.1), -2.0], [0, 0, 1.0]]),
    "translation_rotation": np.array([[np.cos(0.2), -np.sin(0.2), -3.0],
                                      [np.sin(0.2), np.cos(0.2), 9.0], [0, 0, 1.0]]),
    "translation": np.array([[1.0, 0, -7.0], [0, 1.0, -3.0], [0, 0, 1.0]]),
}


REPROJECTION = {"homography": 0.1, "affine": 2e-3, "similarity": 1e-4, "translation": 0.0}


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _correspondences(model, n=60, outliers=10, noise=0.2, seed=3):
    """``n`` points mapped by the model's true matrix with Gaussian noise,
    the first ``outliers`` moved 20-70 px off."""
    rng = np.random.default_rng(seed)
    p1 = rng.random((n, 2)) * 100
    proj = np.hstack([p1, np.ones((n, 1))]) @ TRUE[model].T
    p2 = proj[:, :2] / proj[:, 2:] + rng.normal(0, noise, (n, 2))
    p2[:outliers] += rng.random((outliers, 2)) * 50 + 20
    return p1, p2


@pytest.mark.parametrize("model", sorted(TRUE))
def test_host_fitters_equal(model):
    p1, p2 = _correspondences(model, outliers=0)
    fit_t, k_t = tfit.HOST_FITTERS[model]
    fit_j, k_j = jfit.HOST_FITTERS[model]
    assert k_t == k_j
    got, ref = fit_t(p1, p2), fit_j(p1, p2)
    np.testing.assert_array_equal(got, ref)
    proj = np.hstack([p1, np.ones((len(p1), 1))]) @ got.T
    assert np.abs(proj[:, :2] / proj[:, 2:] - p2).max() < 1.0
    if k_t > 1:
        with pytest.raises(ArgumentErr):
            fit_t(p1[:k_t - 1], p2[:k_t - 1])


@pytest.mark.parametrize("model", sorted(tfit.BATCHED_FITTERS))
def test_batched_fitters_match_jax(model):
    p1, p2 = _correspondences(model, outliers=0, noise=0.5)
    fit_t, k = tfit.BATCHED_FITTERS[model]
    fit_j, _ = jfit.BATCHED_FITTERS[model]
    sets = np.random.default_rng(9).integers(0, len(p1), (32, k))
    sets = sets[[len(set(s)) == k for s in sets]]
    s1, s2 = p1[sets].astype(np.float32), p2[sets].astype(np.float32)
    ref = np.asarray(fit_j(jnp.asarray(s1), jnp.asarray(s2)))
    got = _np(fit_t(torch.as_tensor(s1), torch.as_tensor(s2)))
    assert got.shape == ref.shape == (len(sets), 3, 3) and got.dtype == np.float32
    homo = np.concatenate([s1, np.ones_like(s1[..., :1])], -1)
    pg, pr = (np.einsum("bij,bnj->bni", m.astype(np.float64), homo) for m in (got, ref))
    moved = np.abs(pg[..., :2] / pg[..., 2:] - pr[..., :2] / pr[..., 2:]).max()
    assert moved <= REPROJECTION[model], moved


@pytest.mark.parametrize("model", ["homography", "affine", "similarity", "translation"])
def test_ransac_matches_jax(model):
    """Same draws, so the same best hypothesis, inliers and float64 refit."""
    p1, p2 = _correspondences(model)
    t_t, in_t = tran.ransac(p1, p2, model, 2.0, 60, seed=5, device="cpu")
    t_j, in_j = jransac(p1, p2, model, 2.0, 60, seed=5)
    np.testing.assert_array_equal(in_t, in_j)
    np.testing.assert_array_equal(t_t.matrix, t_j.matrix)
    assert len(in_t) >= 45 and not set(in_t) & set(range(10))


def test_ransac_errors_match_jax():
    p1, p2 = _correspondences("translation", n=20, outliers=16, noise=0.0)
    for kw in (dict(min_num_output_inliers=15, reduce_min_num_output=False),):
        with pytest.raises(MathErr):
            tran.ransac(p1, p2, "translation", 1.0, 20, device="cpu", **kw)
        with pytest.raises(Exception):
            jransac(p1, p2, "translation", 1.0, 20, **kw)
    # the relaxed requirement: the same inliers
    _, a = tran.ransac(p1, p2, "translation", 1.0, 20, device="cpu")
    _, b = jransac(p1, p2, "translation", 1.0, 20)
    np.testing.assert_array_equal(a, b)
    with pytest.raises(ArgumentErr):
        tran.ransac(p1, p2[:, :1], device="cpu")
    with pytest.raises(ArgumentErr):
        tran.ransac(p1, p2, "projective", device="cpu")
    with pytest.raises(MathErr):
        tran.ransac(p1[:3], p2[:3], "homography", device="cpu")


@pytest.mark.parametrize("metric", ["l2", "hamming"])
def test_nearest_matches_jax(metric):
    rng = np.random.default_rng(11)
    if metric == "l2":
        data, queries = rng.random((200, 16)), rng.random((40, 16))
    else:
        data = rng.integers(0, 2**32, (200, 4), dtype=np.uint64).astype(np.uint32)
        queries = data[rng.integers(0, 200, 40)] ^ (rng.random((40, 4)) < 0.1).astype(np.uint32)
    t = tnear.NearestNeighbors(data, metric, device="cpu")
    j = jnear.NearestNeighbors(data, metric)
    assert t.size == j.size == 200
    for k in (1, 5, 400):
        it, dt = t.knn_search(queries, k)
        ij, dj = j.knn_search(queries, k)
        assert it.shape == ij.shape and dt.dtype == dj.dtype
        if metric == "hamming":
            np.testing.assert_array_equal(dt, dj)
            np.testing.assert_array_equal(it, ij)
        else:
            np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=1e-6)
            np.testing.assert_array_equal(it[:, :5], ij[:, :5])
    it, _ = t.knn_search(queries[0], 3)
    assert it.shape == (1, 3)
    with pytest.raises(ArgumentErr):
        tnear.NearestNeighbors(data, "cosine", device="cpu")


def _descriptor_sets(metric, seed=2):
    """Two sets of 48 points whose descriptors are noisy copies of one
    another (a third unrelated), 6 invalid slots in each."""
    rng = np.random.default_rng(seed)
    n = 48
    if metric == "hamming":
        d1 = rng.integers(0, 256, (n, 8)).astype(np.float32)
        flips = (rng.random((n, 8, 8)) < 0.05) * (1 << np.arange(8))
        d2 = (d1.astype(np.int32) ^ flips.sum(-1).astype(np.int32)).astype(np.float32)
    else:
        d1 = rng.random((n, 32)).astype(np.float32)
        d2 = (d1 + rng.normal(0, 0.08, d1.shape)).astype(np.float32)
    perm = rng.permutation(n)
    d2 = d2[perm]
    d2[: n // 3] = rng.permutation(d2[: n // 3].ravel()).reshape(d2[: n // 3].shape)
    sets = []
    for d in (d1, d2):
        valid = np.ones(n, bool)
        valid[rng.choice(n, 6, replace=False)] = False
        sets.append({"x": rng.random(n).astype(np.float32) * 50,
                     "y": rng.random(n).astype(np.float32) * 50,
                     "scale": (0.9 + 0.3 * rng.random(n)).astype(np.float32),
                     "orientation": (rng.random(n) * 6.2 - 3.1).astype(np.float32),
                     "interest": rng.random(n).astype(np.float32),
                     "descriptor": d, "valid": valid})
    return sets


def _both(rec):
    n = len(rec["x"])
    jp = jtypes.from_numpy(rec)._replace(valid=jnp.asarray(rec["valid"]))
    tp = ttypes.from_numpy(rec, device="cpu")._replace(valid=torch.as_tensor(rec["valid"]))
    assert jp.capacity == tp.capacity == n
    return jp, tp


@pytest.mark.parametrize("metric", ["l2", "hamming"])
@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("constraint", [None, "scale_orientation", "position"])
def test_match_points_matches_jax(metric, bidirectional, constraint):
    """On shared descriptors: nearest indices and validity equal; distances
    equal (Hamming) or, squared, within 1e-6 of the largest |a|^2 + |b|^2
    (l2: the cross term's matmul sums in another order, and the squared
    distance is a difference of norms; measured 5.6e-7 of it)."""
    r1, r2 = _descriptor_sets(metric)
    (j1, t1), (j2, t2) = _both(r1), _both(r2)
    cons = {None: (None, None),
            "scale_orientation": (jmat.ScaleOrientationConstraint(0.8, 1.25, -2.0, 2.0),
                                  tmat.ScaleOrientationConstraint(0.8, 1.25, -2.0, 2.0)),
            "position": (jmat.PositionConstraint(-30, 30, -25, 25),
                         tmat.PositionConstraint(-30, 30, -25, 25))}[constraint]
    ratio = 0.8
    ref = jmat.match_points(j1, j2, ratio, bidirectional, metric, cons[0])
    got = tmat.match_points(t1, t2, ratio, bidirectional, metric, cons[1])
    for a, b in zip((got.index1, got.index2), (ref.index1, ref.index2)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    np.testing.assert_array_equal(_np(got.valid), np.asarray(ref.valid))
    assert 5 <= int(np.asarray(ref.valid).sum()) < 42
    dist = np.where(np.asarray(ref.valid), np.asarray(ref.distance), 0)
    gdist = np.where(np.asarray(ref.valid), _np(got.distance), 0)
    if metric == "hamming":
        np.testing.assert_array_equal(gdist, dist)
    else:
        norms = (r1["descriptor"] ** 2).sum(1).max() + (r2["descriptor"] ** 2).sum(1).max()
        np.testing.assert_allclose(gdist ** 2, dist ** 2, rtol=0, atol=1e-6 * norms)
    c_t = tmat.matched_coordinates(t1, t2, got)
    c_j = jmat.matched_coordinates(j1, j2, ref)
    for a, b in zip(c_t, c_j):
        np.testing.assert_array_equal(a, b)


def test_pairwise_distances_match_jax():
    r1, r2 = _descriptor_sets("l2")
    ref = np.asarray(jmat._pairwise_sq_dists(jnp.asarray(r1["descriptor"]),
                                             jnp.asarray(r2["descriptor"])))
    got = _np(tmat._pairwise_sq_dists(torch.as_tensor(r1["descriptor"]),
                                      torch.as_tensor(r2["descriptor"])))
    norms = (r1["descriptor"] ** 2).sum(1)[:, None] + (r2["descriptor"] ** 2).sum(1)[None]
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * norms.max())
    h1, h2 = _descriptor_sets("hamming")
    ref = np.asarray(jmat._pairwise_hamming(jnp.asarray(h1["descriptor"]),
                                            jnp.asarray(h2["descriptor"])))
    got = _np(tmat._pairwise_hamming(torch.as_tensor(h1["descriptor"]),
                                     torch.as_tensor(h2["descriptor"])))
    np.testing.assert_array_equal(got, ref)


def test_remove_duplicates_equal():
    rng = np.random.default_rng(8)
    a = rng.integers(0, 6, (40, 2)).astype(np.float32)
    b = rng.integers(0, 9, (40, 2)).astype(np.float32)
    for x, y in zip(tmat.remove_duplicates(a, b), jmat.remove_duplicates(a, b)):
        np.testing.assert_array_equal(x, y)
    assert 0 < len(tmat.remove_duplicates(a, b)[0]) < 40
    with pytest.raises(ArgumentErr):
        tmat.remove_duplicates(a, b[:3])
    with pytest.raises(ArgumentErr):
        tmat.match_points(*(ttypes.from_numpy({"x": [1.0], "y": [1.0]}, "cpu"),) * 2)


@pytest.mark.cuda
def test_card_matches_cpu(cuda):
    """The matcher, RANSAC and ``_peaks_to_points`` on the card against the
    plain CPU path: matches and inliers equal, squared l2 distances as
    against the JAX package, the peak selection on one response map
    exact."""
    from visionworkbench_torch.interest import detector, harris_interest
    r1, r2 = _descriptor_sets("l2")
    p = [ttypes.from_numpy(r, device=d)._replace(valid=torch.as_tensor(r["valid"], device=d))
         for d in ("cpu", cuda) for r in (r1, r2)]
    mc, mg = tmat.match_points(p[0], p[1], 0.8), tmat.match_points(p[2], p[3], 0.8)
    assert torch.equal(mc.index2, mg.index2.cpu()) and torch.equal(mc.valid, mg.valid.cpu())
    norms = (r1["descriptor"] ** 2).sum(1).max() + (r2["descriptor"] ** 2).sum(1).max()
    np.testing.assert_allclose(_np(mg.distance) ** 2, _np(mc.distance) ** 2, rtol=0,
                               atol=1e-6 * norms)
    p1, p2 = _correspondences("homography")
    (tc, ic), (tg, ig) = (tran.ransac(p1, p2, "homography", 2.0, 60, device=d)
                          for d in ("cpu", cuda))
    np.testing.assert_array_equal(ic, ig)
    np.testing.assert_array_equal(tc.matrix, tg.matrix)
    img = np.random.default_rng(1).random((97, 130)).astype(np.float32)
    resp = harris_interest(img, device="cpu")
    for k in (64, 3185):
        a = detector._peaks_to_points(resp, 1e-8, k)
        b = detector._peaks_to_points(resp.to(cuda), 1e-8, k)
        for x, y in zip(a, b):
            assert torch.equal(x, y.cpu())
