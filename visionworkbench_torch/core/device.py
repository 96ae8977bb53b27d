"""Device policy of the port's entry points: ``device=None`` means the card,
and no entry point moves to the CPU on its own."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises when a CUDA device is asked for and no
    card is present. ``"cpu"`` runs the plain PyTorch versions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "visionworkbench_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch path")
    return dev
