"""Port's ``math/{misc, statistics, optimization}`` against the JAX package
on the CPU, on the same seeded NumPy inputs.

Tolerances:

* the host NumPy code (Bresenham, union-find, MST, the skyline solve,
  relative orientation, position interpolation, ``CDFAccumulator``,
  ``gaussian_clustering``, ``random_set``, Nelder-Mead, particle swarm) is
  the JAX package's, copied: equal.
* ``catmull_rom`` (fp32; XLA contracts its multiply-adds into FMAs) within
  2e-6 of the control points' scale; ``interpolate_pose`` (fp32 ``slerp``)
  within 2e-6.
* ``levenberg_marquardt`` in fp32 with ``torch.func.jacfwd``: on
  ``convert_pinhole_model``'s TSAI model k1, p1 and p2 within 1e-4 of the
  JAX package's and of the truth, the fitted mappings within 1e-7 of each
  other and of the samples (3.3e-9 and 1.5e-8 measured; k2 and k3 act on
  r^4 and r^6 and stay loose in fp32), both residuals below 1e-8; on a singular
  system (a parameter with no effect) the same iterate, iteration count
  and convergence flag. Conjugate gradient and Newton (``torch.func.grad``
  at fp32 points) within 1e-4 of the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import _torch_threads  # noqa: F401
import visionworkbench_tpu.math.misc as jmisc
import visionworkbench_tpu.math.optimization as jopt
import visionworkbench_tpu.math.statistics as jstat
import visionworkbench_torch.math.misc as tmisc
import visionworkbench_torch.math.optimization as topt
import visionworkbench_torch.math.statistics as tstat

FP32 = 2e-6
LM = 1e-4
MAP = 1e-7


def _rng(seed=0):
    return np.random.default_rng(seed)


def _mst_edges():
    rng = _rng(3)
    return [(float(rng.random()), int(a), int(b))
            for a, b in rng.integers(0, 12, (30, 2)) if a != b]


def _spd():
    m = _rng(4).standard_normal((6, 6))
    return m @ m.T + 6 * np.eye(6), _rng(5).standard_normal(6)


def _vectors():
    v1 = _rng(6).standard_normal((10, 3))
    v1 /= np.linalg.norm(v1, axis=1, keepdims=True)
    r = np.asarray(jmisc.quat_normalize(jnp.asarray([0.9, 0.1, -0.3, 0.2])))
    from scipy.spatial.transform import Rotation
    return v1, v1 @ Rotation.from_quat(np.roll(r, -1)).as_matrix().T


HOST = {
    "bresenham": lambda m: [m.bresenham_line(*p) for p in [(0, 0, 5, 2), (7, -3, -4, 9),
                                                            (2, 2, 2, 2), (0, 5, 0, -5)]],
    "mst": lambda m: m.minimum_spanning_tree(12, _mst_edges()),
    "skyline": lambda m: m.solve_sparse_skyline(*_spd()),
    "relative_orientation": lambda m: m.relative_orientation(*_vectors()),
    "interpolate_position": lambda m: m.interpolate_position(
        [0.0, 1.0, 2.5], _rng(7).standard_normal((3, 3)), [0.25, 1.0, 2.0, 3.0, -1.0]),
}


@pytest.mark.parametrize("name", sorted(HOST))
def test_misc_host_functions_equal_jax(name):
    want, got = HOST[name](jmisc), HOST[name](tmisc)
    if isinstance(want, list) and want and isinstance(want[0], np.ndarray):
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    else:
        assert np.array_equal(np.asarray(got), np.asarray(want))


def test_disjoint_set_matches_jax():
    pairs = _rng(8).integers(0, 20, (25, 2))
    sets = []
    for mod in (jmisc, tmisc):
        ds = mod.DisjointSet()
        for x in range(20):
            ds.insert(x)
        roots = [ds.union(int(a), int(b)) for a, b in pairs]
        sets.append((roots, [ds.find(x) for x in range(20)]))
    assert sets[0] == sets[1]


@pytest.mark.parametrize("ndim", [1, 2])
def test_catmull_rom_matches_jax(ndim):
    pts = _rng(9).standard_normal((6, 3) if ndim == 2 else 6) * 10
    t = np.linspace(-0.5, 5.5, 41).astype(np.float32)
    want = np.asarray(jmisc.catmull_rom(pts, jnp.asarray(t)))
    got = tmisc.catmull_rom(pts, torch.as_tensor(t))
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= FP32 * np.abs(pts).max()
    np.testing.assert_allclose(tmisc.catmull_rom(pts, np.arange(6.0), device="cpu").numpy(),
                               pts.astype(np.float32), atol=1e-5)


def test_interpolate_pose_matches_jax():
    quats = np.array([[1, 0, 0, 0], [np.cos(np.pi / 4), 0, 0, np.sin(np.pi / 4)],
                      [0.5, 0.5, 0.5, 0.5]])
    for t in (0.0, 0.5, 1.25, 2.0, 3.0):
        want = jmisc.interpolate_pose([0.0, 1.0, 2.0], quats, t)
        got = tmisc.interpolate_pose([0.0, 1.0, 2.0], quats, t)
        assert isinstance(got, np.ndarray) and np.abs(got - want).max() <= FP32


def test_statistics_equal_jax():
    rng = _rng(10)
    accs = [mod.CDFAccumulator(buffer_size=512, seed=3) for mod in (jstat, tstat)]
    for _ in range(5):
        batch = rng.normal(10.0, 2.0, 700)
        for acc in accs:
            acc.update(batch)
    for q in (0.1, 0.5, 0.975):
        assert accs[0].quantile(q) == accs[1].quantile(q)
    assert accs[0].count == accs[1].count == 3500
    assert accs[0].approximate_stddev() == accs[1].approximate_stddev()
    v = np.concatenate([rng.normal(0, 0.5, 2000), rng.normal(5, 0.7, 1500)])
    assert jstat.gaussian_clustering(v, 2) == tstat.gaussian_clustering(v, 2)
    assert jstat.gaussian_clustering(v, 3, 30) == tstat.gaussian_clustering(v, 3, 30)
    assert np.array_equal(jstat.random_set(100, 10, 4), tstat.random_set(100, 10, 4))


def _tsai_problem():
    """``convert_pinhole_model``'s sampled TSAI mapping (k1 -0.15, p1 1e-3,
    k2 0.02) and its forward model, for either package."""
    gx, gy = np.meshgrid(np.arange(0, 80, 10, dtype=np.float32),
                         np.arange(0, 64, 10, dtype=np.float32))
    x = (gx.ravel() - np.float32(40.0)) / np.float32(300.0)
    y = (gy.ravel() - np.float32(32.0)) / np.float32(300.0)
    k1, k2, p1, p2, k3 = -0.15, 0.02, 1e-3, 0.0, 0.0

    def fwd(params, x, y, stack):
        k1, k2, p1, p2, k3 = (params[i] for i in range(5))
        r2 = x * x + y * y
        rdist = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
        xo = x * rdist + (2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x))
        yo = y * rdist + (p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y)
        return stack([xo, yo], -1).reshape(-1)

    target = fwd(np.array([k1, k2, p1, p2, k3], np.float32), x, y, np.stack)
    return x, y, fwd, target, np.array([k1, k2, p1, p2, k3])


def test_levenberg_marquardt_tsai_matches_jax():
    x, y, fwd, target, truth = _tsai_problem()
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    want = jopt.levenberg_marquardt(lambda p: fwd(p, jx, jy, jnp.stack), np.zeros(5), target,
                                    max_iterations=50)
    got = topt.levenberg_marquardt(lambda p: fwd(p, tx, ty, torch.stack), np.zeros(5), target,
                                   max_iterations=50, device="cpu")
    assert isinstance(got.x, np.ndarray) and got.x.dtype == np.float64
    # k2 and k3 act on r^4 and r^6 (r <= 0.17): fp32 leaves them loose, so
    # the fitted mappings are held, and k1, p1, p2
    first = [0, 2, 3]
    assert np.abs(got.x[first] - want.x[first]).max() <= LM
    assert np.abs(got.x[first] - truth[first]).max() <= LM
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    mapped = [fwd(r.x, x64, y64, np.stack) for r in (got, want)]
    assert np.abs(mapped[0] - mapped[1]).max() <= MAP
    assert np.abs(mapped[0] - target).max() <= MAP
    assert got.final_error < 1e-8 and want.final_error < 1e-8
    assert got.converged and want.converged


def test_levenberg_marquardt_singular_matches_jax():
    """p[1] has no effect: every damped normal matrix is singular, each
    solve gives inf / NaN and the lambda search rejects it, in both."""
    target = np.array([1.0, 2.0, 3.0], np.float32)

    def model(p, stack):
        return stack([2.0 * p[0], p[0] * p[0], 3.0 * p[0] + 0.0 * p[1]])

    want = jopt.levenberg_marquardt(lambda p: model(p, jnp.stack), [0.5, 0.5], target)
    got = topt.levenberg_marquardt(lambda p: model(p, torch.stack), [0.5, 0.5], target,
                                   device="cpu")
    assert (got.iterations, got.converged) == (want.iterations, want.converged)
    assert np.array_equal(got.x, want.x)
    assert got.final_error == pytest.approx(want.final_error, rel=1e-6)


def test_conjugate_gradient_and_newton_match_jax():
    def f(p):
        return (p[0] - 1.0) ** 2 + 10.0 * (p[1] + 2.0) ** 2

    want = jopt.conjugate_gradient(f, [3.0, 3.0])
    got = topt.conjugate_gradient(f, [3.0, 3.0], device="cpu")
    assert np.abs(got - want).max() <= LM

    def g(x):
        return x ** 3 - 2.0 * x - 5.0

    want, got = jopt.newton_raphson(g, 3.0), topt.newton_raphson(g, 3.0, device="cpu")
    assert abs(got - want) <= LM and abs(got - 2.0945514815) <= LM


def test_nelder_mead_and_particle_swarm_equal_jax():
    def f(p):
        return (p[0] - 1) ** 2 + (p[1] + 2) ** 2 + 0.5 * np.sin(3 * p[0])

    assert np.array_equal(jopt.nelder_mead(f, [0.0, 0.0]), topt.nelder_mead(f, [0.0, 0.0]))
    want = jopt.particle_swarm(f, [-5, -5], [5, 5], iterations=30, seed=2)
    got = topt.particle_swarm(f, [-5, -5], [5, 5], iterations=30, seed=2)
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]
