"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``):
the quantized-input protocol, the thread cap and the card fixture.

Protocol (as ``tests/test_oracle_parity.py``): inputs are quantized to the
1/256 grid, which makes every absolute- and squared-difference window sum
exact in fp32 whatever the summation order, so the port's integer
disparities and validity must equal the JAX package's bit for bit.
"""

import numpy as np
import pytest
import torch


def quantized(rng, shape):
    """fp32 image on the 1/256 grid."""
    return (rng.integers(0, 256, shape) / 256.0).astype(np.float32)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """The tier-1 run uses 6 xdist workers: keep PyTorch to 2 threads each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def cuda():
    """The card, for tests of the CUDA kernels; skips when there is none
    (decided at run time, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (kernel runs only on the card)")
    return torch.device("cuda")
