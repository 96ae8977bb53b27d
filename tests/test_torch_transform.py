"""Port's boxes, 2D transforms and warps (``visionworkbench_torch/math/
{bbox, transform2d}.py``, ``image/transform.py``) against the JAX package
on the CPU, on the same seeded numpy inputs.

Tolerances: boxes, transform application (fp32, one operation a step, as
the eager JAX package) and host grids are exact. Warped values within
2e-5 (images in [0, 1]): the JAX package samples through banded matmuls
and shifted-slice stencils, the port gathers the same taps, so weights
and sums round differently (measured <= 8.5e-6). Nearest-pixel warps are
exact, except where a coordinate lies within an ulp-sized 1e-5 of a
half-integer (the two packages round the coordinate differently).
"""

import jax
import numpy as np
import pytest
import torch

from torch_parity import _torch_threads, cuda  # noqa: F401
import visionworkbench_tpu.image.transform as jt
import visionworkbench_tpu.math.bbox as jb
import visionworkbench_tpu.math.transform2d as j2
import visionworkbench_torch.image.transform as tt
import visionworkbench_torch.math.bbox as tb
import visionworkbench_torch.math.transform2d as t2

ATOL = 2e-5
INTERPS = ("nearest", "bilinear", "bicubic")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bounds(b):
    return (b.min_x, b.min_y, b.max_x, b.max_y)


def _box_results(m):
    """What ``m``'s boxes compute on one set of inputs."""
    a = m.BBox2(1.5, -2.0, 10.25, 7.0)
    boxes = [a.copy().grow((20.0, 3.0)), a.copy().grow(m.BBox2(-3, 0, 2, 2)),
             a.copy().expand(1.5), a.copy().contract((1, 2)),
             a.intersection(m.BBox2(4, 0, 20, 3)), a.union(m.BBox2(40, 40, 1, 1)),
             a.copy().shift((2, -1)), a.copy().scale(0.5), m.BBox2.empty(),
             m.BBox2(0, 0, 3, 3).crop(m.BBox2(5, 5, 1, 1)), a.rounded(),
             m.grow_bbox_to_int(a), m.bounding_box(np.zeros((7, 11)))]
    queries = [a.contains((2.0, 0.0)), a.contains(m.BBox2(2, -1, 1, 1)),
               a.intersects(m.BBox2(12, 5, 3, 3)), a.area(), a.center(), a.size(),
               a.is_empty(), m.BBox2.empty().area(), m.BBox2i(2, 3, 4, 5).slices()]
    tiles = [m.subdivide_bbox(m.BBox2i(3, 1, 70, 45), 16, 32, partial)
             for partial in (True, False)]
    return ([_bounds(b) for b in boxes], queries,
            [[_bounds(b) for b in t] for t in tiles])


def test_bbox_matches_jax():
    assert _box_results(tb) == _box_results(jb)
    assert isinstance(tb.grow_bbox_to_int(tb.BBox2(0.5, 0, 1, 1)), tb.BBox2i)


def _transforms(m):
    return {
        "identity": m.identity_transform(),
        "translate": m.TranslateTransform(2.25, -3.5),
        "resample": m.ResampleTransform(0.7, 1.3),
        "rotate": m.RotateTransform(0.3, (20.0, 17.0)),
        "linear": m.LinearTransform([[1.1, 0.2], [-0.1, 0.9]]),
        "affine": m.AffineTransform([[0.9, -0.15], [0.12, 1.05]], (3.0, -1.0)),
        "similarity": m.SimilarityTransform(1.2, -0.4, 5.0, 2.0),
        "homography": m.HomographyTransform([[1.0, 0.05, 2.0], [0.02, 0.97, -1.0],
                                             [1e-3, -5e-4, 1.0]]),
        "compose": m.compose(m.TranslateTransform(1, 0), m.RotateTransform(0.2),
                             m.ResampleTransform(2.0)),
    }


@pytest.mark.parametrize("name", sorted(_transforms(t2)))
def test_transform2d_matches_jax(name):
    """forward / reverse exact (the eager JAX package rounds each step as
    the port does), composition, inverse and the boxes."""
    jx, tx = _transforms(j2)[name], _transforms(t2)[name]
    rng = np.random.default_rng(1)
    x = rng.uniform(-50, 80, 300).astype(np.float32)
    y = rng.uniform(-40, 60, 300).astype(np.float32)
    for fj, ft in ((jx.forward, tx.forward), (jx.reverse, tx.reverse),
                   (jx.inverse().forward, tx.inverse().forward),
                   (jx.compose(jx).forward, tx.compose(tx).forward)):
        for a, b in zip(fj(x, y), ft(x, y)):
            np.testing.assert_array_equal(_np(b), _np(a))
    np.testing.assert_array_equal(tx.matrix, jx.matrix)
    box = jb.BBox2(-3, 2, 40, 30)
    assert _bounds(tx.forward_bbox(tb.BBox2(-3, 2, 40, 30))) == _bounds(jx.forward_bbox(box))
    assert _bounds(tx.reverse_bbox(tb.BBox2(-3, 2, 40, 30))) == _bounds(jx.reverse_bbox(box))
    assert tx.is_affine() == jx.is_affine()
    assert _bounds(tt.compute_transformed_bbox((30, 40), tx)) == \
        _bounds(jt.compute_transformed_bbox((30, 40), jx))


def _nearest_ties_only(got, ref, sx, sy):
    """Nearest-pixel samples agree except where a coordinate sits within
    1e-5 of a half-integer, and there on < 1 % of pixels."""
    bad = got != ref
    if bad.ndim == 3:
        bad = bad.any(-1)
    tie = np.minimum(np.abs(np.mod(sx, 1) - 0.5), np.abs(np.mod(sy, 1) - 0.5)) < 1e-5
    assert not (bad & ~tie).any()
    assert bad.mean() < 0.01


@pytest.mark.parametrize("interp", INTERPS)
@pytest.mark.parametrize("edge", ["zero", "constant", "value"])
def test_transform_rotation_matches_jax(interp, edge):
    """``transform`` with a rotation about an off-centre point into a
    larger, odd-shaped output, on one and three channels."""
    rng = np.random.default_rng(2)
    for img in (rng.random((37, 45)).astype(np.float32),
                rng.random((37, 45, 3)).astype(np.float32)):
        ref = np.asarray(jt.transform(img, j2.RotateTransform(0.3, (20, 17)), (41, 39),
                                      interp, edge, 0.7))
        got = tt.transform(img, t2.RotateTransform(0.3, (20, 17)), (41, 39), interp, edge,
                           0.7, device="cpu")
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=0 if interp == "nearest" else ATOL)


def test_resample_translate_rotate_match_jax():
    rng = np.random.default_rng(3)
    img = rng.random((33, 27)).astype(np.float32)
    for fj, ft in ((lambda a: jt.resample(a, 0.5), lambda a: tt.resample(a, 0.5, device="cpu")),
                   (lambda a: jt.resample(a, 1.7, 0.6, "bicubic"),
                    lambda a: tt.resample(a, 1.7, 0.6, "bicubic", device="cpu")),
                   (lambda a: jt.translate(a, 2.5, -1.25),
                    lambda a: tt.translate(a, 2.5, -1.25, device="cpu")),
                   (lambda a: jt.rotate(a, 1.1, "bicubic", "constant"),
                    lambda a: tt.rotate(a, 1.1, "bicubic", "constant", device="cpu"))):
        ref = np.asarray(fj(img))
        got = ft(img).numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def _scale_map(x, y):
    """Axis-separable: the 1-D route."""
    return 0.93 * x + 3.2, 1.07 * y - 2.1


def _skew_map(x, y):
    """Not separable (mixed terms): the 2-D route."""
    return 0.98 * x + 0.05 * y + 1.0 + 1e-4 * x * y, -0.04 * x + 1.01 * y - 0.5


def _jax_route(monkeypatch, fn):
    """Run ``fn`` and report which coordinates JAX's ``warp_from_grid``
    took: 1-D (``_grid_axis_1d``) or 2-D (``interp_map_grid``)."""
    seen = []
    for name, route in (("_grid_axis_1d", "separable"), ("interp_map_grid", "grid")):
        orig = getattr(jt, name)
        monkeypatch.setattr(jt, name, lambda *a, _o=orig, _r=route, **k:
                            (seen.append(_r), _o(*a, **k))[1])
    out = fn()
    monkeypatch.undo()
    assert len(set(seen)) == 1
    return out, seen[0]


@pytest.mark.parametrize("interp", INTERPS)
@pytest.mark.parametrize("route, reverse, n", [("separable", _scale_map, 80),
                                               ("grid", _skew_map, 50)])
def test_warp_from_grid_both_routes_match_jax(monkeypatch, interp, route, reverse, n):
    """Both coordinate routes, asserting the one JAX's predicate took; the
    grids, their upsampled coordinates and the warps with ``zero``,
    ``constant`` and ``value`` edges (and ``sample`` with a fill value)."""
    out_shape = (n, n + 7)
    jg = jt.reverse_map_grid(reverse, out_shape, 16)
    sx_g, sy_g, step = tt.reverse_map_grid(reverse, out_shape, 16)
    np.testing.assert_array_equal(sx_g, jg[0])
    np.testing.assert_array_equal(sy_g, jg[1])
    assert step == jg[2] == 16
    assert tt.warp_route(sx_g, sy_g, step, interp) == route
    src = np.random.default_rng(4).random((n + 5, n + 9)).astype(np.float32)
    ref, jroute = _jax_route(monkeypatch, lambda: np.asarray(jax.jit(
        lambda a: jt.warp_from_grid(a, sx_g, sy_g, step, out_shape, interp))(src)))
    assert jroute == route
    got = tt.warp_from_grid(src, sx_g, sy_g, step, out_shape, interp, device="cpu").numpy()
    sx, sy = (v.numpy() for v in tt.interp_map_grid(sx_g, sy_g, step, out_shape, "cpu"))
    jsx, jsy = (np.asarray(v) for v in jt.interp_map_grid(sx_g, sy_g, step, out_shape))
    np.testing.assert_allclose(sx, jsx, rtol=0, atol=1e-4)
    np.testing.assert_allclose(sy, jsy, rtol=0, atol=1e-4)
    for g, i, m in ((sx_g[0], 1, out_shape[1]), (sy_g[:, 0], 0, out_shape[0])):
        np.testing.assert_allclose(tt._grid_axis_1d(g, step, m, "cpu").numpy(),
                                   np.asarray(jt._grid_axis_1d(g, step, m)), rtol=0, atol=1e-4)
    if interp == "nearest":
        _nearest_ties_only(got, ref, sx, sy)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    for edge in ("constant", "value"):
        ref = np.asarray(jax.jit(lambda a: jt.warp_from_grid(
            a, sx_g, sy_g, step, out_shape, interp, edge))(src))
        got = tt.warp_from_grid(src, sx_g, sy_g, step, out_shape, interp, edge,
                                device="cpu").numpy()
        if interp == "nearest":
            _nearest_ties_only(got, ref, sx, sy)
        else:
            np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    if route == "grid":
        ref = np.asarray(jt.sample(src, jsx, jsy, interp, "value", 0.25))
        got = tt.sample(src, sx, sy, interp, "value", 0.25, device="cpu").numpy()
        if interp == "nearest":
            _nearest_ties_only(got, ref, sx, sy)
        else:
            np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_transform_grid_refines_like_jax():
    """``transform_grid``'s error bound halves the grid step on a curved
    map exactly as the JAX package's, and the warps agree."""
    def curved(x, y):
        return x + 4e-3 * (y - 30) ** 2, y + 2e-3 * (x - 20) ** 2

    src = np.random.default_rng(5).random((61, 47)).astype(np.float32)
    jg = jt.reverse_map_grid(curved, (57, 43), 32, 0.05)
    tg = tt.reverse_map_grid(curved, (57, 43), 32, 0.05)
    assert tg[2] == jg[2] < 32
    np.testing.assert_array_equal(tg[0], jg[0])
    ref = np.asarray(jt.transform_grid(src, curved, (57, 43), 32, "bilinear", "zero", 0.05))
    got = tt.transform_grid(src, curved, (57, 43), 32, "bilinear", "zero", 0.05,
                            device="cpu").numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.cuda
def test_warps_card_match_cpu(cuda):
    """Card = CPU within 1e-5 (a coordinate quotient may round differently
    on the card)."""
    rng = np.random.default_rng(6)
    img = rng.random((64, 72)).astype(np.float32)
    for f in (lambda d: tt.transform(img, t2.RotateTransform(0.3, (30, 20)), None,
                                     "bicubic", device=d),
              lambda d: tt.transform_grid(img, _scale_map, (80, 87), device=d),
              lambda d: tt.transform_grid(img, _skew_map, (50, 57), device=d)):
        np.testing.assert_allclose(f(cuda).cpu().numpy(), f("cpu").numpy(), rtol=0, atol=1e-5)
