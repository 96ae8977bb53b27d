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


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises when a CUDA device is asked for and no
    card is present. ``"cpu"`` runs the plain PyTorch versions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "visionworkbench_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch path")
    return dev


def as_f32(x, like=None) -> torch.Tensor:
    """``x`` as a float32 tensor for the coordinate math of transforms,
    projections and georeferences: a tensor keeps its device; anything else
    (NumPy arrays, scalars) goes to ``like``'s device, or to the CPU, where
    the warps' reverse-map grids are planned."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    dev = like.device if isinstance(like, torch.Tensor) else "cpu"
    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)


def rdiv(c: float, t: torch.Tensor) -> torch.Tensor:
    """The IEEE quotient ``c / t`` (PyTorch computes ``float / tensor`` as a
    reciprocal times ``c``: two roundings)."""
    return torch.tensor(c, dtype=t.dtype, device=t.device) / t
