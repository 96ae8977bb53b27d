"""Device policy of the port's entry points: ``device=None`` means the card,
and no entry point moves to the CPU on its own."""

from __future__ import annotations

import numpy as np
import torch


def as_tensor(x, dtype, device) -> torch.Tensor:
    """``x`` (a tensor, numpy array or array-like) as a ``dtype`` tensor on
    ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def on_device(x, device=None, dtype=None) -> torch.Tensor:
    """``x`` as a tensor (of ``dtype`` when given): a tensor keeps its
    device, anything else goes to ``device`` (``None`` = the card)."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    return as_tensor(x, dtype, resolve_device(device))


def common_dtype(args, device=None):
    """``args`` as tensors of one dtype on one device: float64 if any tensor
    among them is float64, else fp32; arrays go to the first tensor's
    device, or to ``device`` (``None`` = the card) when there is none."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    dev = tensors[0].device if tensors else resolve_device(device)
    dtype = (torch.float64 if any(t.dtype == torch.float64 for t in tensors)
             else torch.float32)
    return [on_device(a, dev, dtype).to(dev) for a in args]


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises when a CUDA device is asked for and no
    card is present. ``"cpu"`` runs the plain PyTorch versions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "visionworkbench_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch path")
    return dev


def as_f32(x, like=None, dtype=torch.float32) -> torch.Tensor:
    """``x`` as a ``dtype`` (fp32 unless given) tensor for the coordinate
    math of transforms, projections, georeferences and cameras: a tensor
    keeps its device; anything else (NumPy arrays, numbers) goes to
    ``like``'s device, or to the CPU, where the warps' reverse-map grids are
    planned. The copy to ``like``'s device is issued without a stream sync:
    a pageable source is staged at once, so the host does not wait for the
    card."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    t = torch.as_tensor(np.asarray(x), dtype=dtype)
    return t.to(like.device, non_blocking=True) if isinstance(like, torch.Tensor) else t


def scalar(c: float, like: torch.Tensor) -> torch.Tensor:
    """``c`` as a 0-dim tensor of ``like``'s dtype on its device, made by a
    fill (no host-to-device copy, so the host does not wait for the card)."""
    return torch.full((), c, dtype=like.dtype, device=like.device)


def rdiv(c: float, t: torch.Tensor) -> torch.Tensor:
    """The IEEE quotient ``c / t`` (PyTorch computes ``float / tensor`` as a
    reciprocal times ``c``: two roundings)."""
    return scalar(c, t) / t


def qdiv(t: torch.Tensor, c: float) -> torch.Tensor:
    """The IEEE quotient ``t / c`` (on CUDA PyTorch computes ``tensor /
    float`` as a multiply by the reciprocal of ``c``: two roundings)."""
    return t / scalar(c, t)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of an fp32 tensor, as XLA's: a
    float64 root rounded to fp32 (PyTorch's CPU fp32 ``sqrt`` differs in
    ~0.6 % of values)."""
    return torch.sqrt(x.double()).to(x.dtype)


def dot(v: torch.Tensor, w) -> torch.Tensor:
    """``v . w`` over the last axis, each product and each sum an operation
    of its own in index order, so the card and the CPU round alike (a fused
    kernel may contract them into FMAs); ``w`` a tensor, or a vector of
    numbers rounded to ``v``'s dtype."""
    if isinstance(w, torch.Tensor):
        terms = [v[..., i] * w[..., i] for i in range(w.shape[-1])]
    else:
        w = np.asarray(w, np.float32 if v.dtype == torch.float32 else np.float64).tolist()
        terms = [v[..., i] * c for i, c in enumerate(w)]
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


def matmul(v: torch.Tensor, m) -> torch.Tensor:
    """``v @ m`` for (..., k) ``v`` and a (k, j) matrix of numbers, a
    :func:`dot` a column."""
    m = np.asarray(m)
    return torch.stack([dot(v, m[:, j]) for j in range(m.shape[1])], -1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a x b`` over the last axis, each product and difference an
    operation of its own (as :func:`dot`)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], -1)


def norm_rn(v: torch.Tensor) -> torch.Tensor:
    """``sqrt(v . v)`` over the last axis with :func:`dot` and
    :func:`sqrt_rn` (``jnp.linalg.norm``)."""
    return sqrt_rn(dot(v, v))
