"""Nonlinear optimization (port of ``visionworkbench_tpu/math/optimization.py``;
ref ``src/vw/Math/LevenbergMarquardt.h:88``, ``NelderMead.h``,
``ConjugateGradient.h``).

Levenberg-Marquardt is the workhorse (camera solves, transform inversion,
subpixel fits). The reference differentiates numerically; here the Jacobian
is ``torch.func.jacfwd`` of the residual -- exact forward-mode derivatives of
the same operations, as the JAX package's ``jax.jacfwd``. The iterate is
fp32, as the JAX package's with x64 off. Conjugate gradient and Newton take
``torch.func.grad`` at fp32 points; Nelder-Mead and particle swarm are the
JAX package's host code, copied.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from visionworkbench_torch.core.device import on_device, resolve_device


class LMResult(NamedTuple):
    x: np.ndarray
    converged: bool
    iterations: int
    final_error: float


def _as_result(out, like: torch.Tensor) -> torch.Tensor:
    if isinstance(out, torch.Tensor):
        return out.to(like.dtype)
    return torch.as_tensor(np.asarray(out), dtype=like.dtype, device=like.device)


def levenberg_marquardt(model_fn: Callable, x0, target,
                        max_iterations: int = 100,
                        rel_tolerance: float = 1e-16,
                        abs_tolerance: float = 1e-16,
                        initial_lambda: float = 0.1, device=None) -> LMResult:
    """Minimize ||model_fn(x) - target||^2 (ref ``levenberg_marquardt``,
    LevenbergMarquardt.h:88-214: lambda scaled x10 on failure, /10 on
    success). ``model_fn`` maps an fp32 parameter tensor to a tensor. A
    tensor ``x0`` keeps its device; an array goes to ``device`` (``None`` =
    the card). A singular step gives NaN or inf (``torch.linalg.solve_ex``),
    which the inner lambda search rejects, as ``jnp.linalg.solve``'s."""
    x = on_device(x0, device, torch.float32)
    target = on_device(target, x.device, torch.float32).to(x.device).reshape(-1)

    def residual(p):
        return _as_result(model_fn(p), p).reshape(-1) - target

    jac_fn = torch.func.jacfwd(residual)
    lam = initial_lambda
    err = residual(x)
    norm = float(err @ err)
    converged = False
    it = 0
    for it in range(1, max_iterations + 1):
        j = jac_fn(x).to(x.dtype)   # a 0-dim product's tangent may promote
        jtj = j.T @ j
        jte = j.T @ err
        improved = False
        for _ in range(20):  # inner lambda search
            a = jtj + lam * torch.diag(torch.diag(jtj))
            delta = torch.linalg.solve_ex(a, jte)[0]
            x_try = x - delta
            err_try = residual(x_try)
            norm_try = float(err_try @ err_try)
            if norm_try < norm:
                x, err = x_try, err_try
                improvement = abs(norm - norm_try) / max(norm, 1e-300)
                norm = norm_try
                lam = max(lam / 10.0, 1e-15)
                improved = True
                if improvement < rel_tolerance or norm < abs_tolerance:
                    converged = True
                break
            lam *= 10.0
        if not improved or converged:
            converged = converged or not improved
            break
    return LMResult(x.cpu().numpy().astype(np.float64), converged, it, norm)


def nelder_mead(f: Callable, x0, max_iterations: int = 1000,
                tolerance: float = 1e-8) -> np.ndarray:
    """Downhill simplex (ref ``NelderMead.h``); SciPy host implementation."""
    from scipy.optimize import minimize
    res = minimize(lambda p: float(f(np.asarray(p))), np.asarray(x0, np.float64),
                   method="Nelder-Mead",
                   options={"maxiter": max_iterations, "xatol": tolerance,
                            "fatol": tolerance})
    return res.x


def conjugate_gradient(f: Callable, x0, max_iterations: int = 500,
                       tolerance: float = 1e-8, device=None) -> np.ndarray:
    """Nonlinear CG (SciPy on the host) with ``torch.func.grad`` gradients
    at fp32 points on ``device`` (``None`` = the card) (ref
    ``ConjugateGradient.h``)."""
    from scipy.optimize import minimize
    dev = resolve_device(device)
    grad = torch.func.grad(lambda p: f(p).sum())

    def f32(p):
        return torch.as_tensor(p, dtype=torch.float32, device=dev)

    res = minimize(lambda p: float(f(f32(p))), np.asarray(x0, np.float64),
                   jac=lambda p: grad(f32(p)).cpu().numpy().astype(np.float64),
                   method="CG", options={"maxiter": max_iterations, "gtol": tolerance})
    return res.x


def newton_raphson(f: Callable, x0, max_iterations: int = 50,
                   tolerance: float = 1e-12, device=None) -> float:
    """Scalar Newton's method with autodiff (ref ``Functions.h`` newton
    usage): ``f`` of a Python float for the value, ``torch.func.grad`` of
    ``f`` at an fp32 point on ``device`` (``None`` = the card) for the
    slope."""
    dev = resolve_device(device)
    df = torch.func.grad(lambda v: torch.as_tensor(f(v)).sum())
    x = float(x0)
    for _ in range(max_iterations):
        fx = float(f(x))
        if abs(fx) < tolerance:
            break
        d = float(df(torch.tensor(x, dtype=torch.float32, device=dev)))
        if d == 0:
            break
        x -= fx / d
    return x


def particle_swarm(f: Callable, lower, upper, num_particles: int = 40,
                   iterations: int = 100, seed: int = 0,
                   inertia: float = 0.7, c1: float = 1.5, c2: float = 1.5):
    """Particle swarm minimization over a box (ref ``ParticleSwarm.h``)."""
    rng = np.random.default_rng(seed)
    lower = np.asarray(lower, np.float64)
    upper = np.asarray(upper, np.float64)
    dim = lower.shape[0]
    pos = rng.uniform(lower, upper, (num_particles, dim))
    vel = rng.uniform(-(upper - lower), upper - lower, (num_particles, dim)) * 0.1
    pbest = pos.copy()
    pbest_val = np.array([float(f(p)) for p in pos])
    g = pbest[np.argmin(pbest_val)].copy()
    gval = pbest_val.min()
    for _ in range(iterations):
        r1 = rng.random((num_particles, dim))
        r2 = rng.random((num_particles, dim))
        vel = inertia * vel + c1 * r1 * (pbest - pos) + c2 * r2 * (g - pos)
        pos = np.clip(pos + vel, lower, upper)
        vals = np.array([float(f(p)) for p in pos])
        improved = vals < pbest_val
        pbest[improved] = pos[improved]
        pbest_val[improved] = vals[improved]
        if pbest_val.min() < gval:
            gval = pbest_val.min()
            g = pbest[np.argmin(pbest_val)].copy()
    return g, float(gval)
