"""Filter kernels of the port (from ``visionworkbench_tpu/image/filters.py``;
only the pyramid kernel is on the correlator's path so far)."""

from __future__ import annotations

import numpy as np


def generate_pyramid_smoothing_kernel() -> np.ndarray:
    """Fixed 5-tap [1,4,6,4,1]/16 (ref ``Filter.h:89-99``)."""
    return np.array([1, 4, 6, 4, 1], np.float64) / 16.0
