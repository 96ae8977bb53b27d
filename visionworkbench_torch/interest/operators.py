"""Interest response operators (port of
``visionworkbench_tpu/interest/operators.py``; ref
``src/vw/InterestPoint/InterestOperator.h:40-160``).

Each step is one tensor operation in the JAX package's order on the
port's filters, so the responses equal the JAX package's eager ones; under
``jit`` XLA contracts ``ix2 * iy2 - ixy * ixy`` into a multiply-add, which
the port rounds as two products.
"""

from __future__ import annotations

import torch

from visionworkbench_torch.core.device import on_device
from visionworkbench_torch.image.filters import (
    derivative_filter, gaussian_filter, laplacian_filter,
)


def image_gradients(img):
    """(Ix, Iy) central-difference gradients (ref ``ImageInterestData``
    gradient_x/y via derivative_filter)."""
    ix = derivative_filter(img, 1, 0)
    iy = derivative_filter(img, 0, 1)
    return ix, iy


def harris_interest(img, scale: float = 1.0, k: float = -1.0, device=None):
    """Harris cornerness (ref ``HarrisInterestOperator``,
    InterestOperator.h:45-100): Gaussian-smoothed gradient products; Noble
    measure ``det / (trace + 1e-6)`` when k < 0, else ``det - k * trace^2``."""
    img = on_device(img, device, torch.float32)
    ix, iy = image_gradients(img)
    ix2 = gaussian_filter(ix * ix, scale)
    iy2 = gaussian_filter(iy * iy, scale)
    ixy = gaussian_filter(ix * iy, scale)
    trace = ix2 + iy2
    det = ix2 * iy2 - ixy * ixy
    if k < 0:
        return det / (trace + 0.000001)
    return det - k * trace * trace


def log_interest(img, scale: float = 1.0, device=None):
    """Laplacian-of-Gaussian response (ref ``LogInterestOperator``,
    InterestOperator.h:119-160): 3x3 Laplacian of the Gaussian blur."""
    return laplacian_filter(gaussian_filter(on_device(img, device, torch.float32), scale))


HARRIS_DEFAULT_THRESHOLD = 1e-5   # ref InterestOperator.h:53
LOG_DEFAULT_THRESHOLD = 0.03      # ref InterestOperator.h:127
