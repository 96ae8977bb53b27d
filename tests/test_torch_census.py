"""Port's census transforms (``visionworkbench_torch/image/census.py``)
against the JAX package on the CPU, on the same seeded uint8 images.

Tolerance: exact. The port's int32 words must hold the JAX package's
uint32 bit patterns (bit 31 included, used by the 7x7 and 9x9 words), and
hamming distances are integers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import _torch_threads  # noqa: F401
from visionworkbench_tpu.image import census as jcensus
from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.image import census as tcensus


def _img(seed, shape=(23, 31)):
    """uint8-valued image with flat patches, so ties (val == center) occur."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, shape)
    img[5:9, 4:12] = 100
    return img.astype(np.int32)


def _as_u32(words):
    return np.asarray(words).astype(np.int64) & 0xFFFFFFFF


@pytest.mark.parametrize("ternary", [False, True])
@pytest.mark.parametrize("window", [3, 5, 7, 9])
def test_census_and_hamming_match_jax(window, ternary):
    a, b = _img(70 + window), _img(80 + window)
    if ternary:
        tf = lambda im: tcensus.ternary_census_transform(torch.as_tensor(im), window, 4)  # noqa: E731
        jf = lambda im: jcensus.ternary_census_transform(jnp.asarray(im), window, 4)  # noqa: E731
    else:
        tf = lambda im: tcensus.census_transform(torch.as_tensor(im), window)  # noqa: E731
        jf = lambda im: jcensus.census_transform(jnp.asarray(im), window)  # noqa: E731
    ta, tb, ja, jb = tf(a), tf(b), jf(a), jf(b)
    assert ta.dtype == torch.int32 and ta.shape == ja.shape
    np.testing.assert_array_equal(_as_u32(ta.numpy()), _as_u32(ja))
    np.testing.assert_array_equal(_as_u32(tb.numpy()), _as_u32(jb))
    got = tcensus.hamming_distance(ta, tb)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jcensus.hamming_distance(ja, jb)))


def test_popcount_covers_the_sign_bit():
    words = torch.tensor([0, -1, -2 ** 31, 2 ** 31 - 1, 0x0F0F0F0F, -0x0F0F0F10],
                         dtype=torch.int32)
    expect = [bin(int(w) & 0xFFFFFFFF).count("1") for w in words]
    assert tcensus._popcount32(words).tolist() == expect


def test_bad_window_raises_and_radius():
    img = torch.zeros((8, 8), dtype=torch.int32)
    for fn in (tcensus.census_transform, tcensus.ternary_census_transform):
        with pytest.raises(ArgumentErr):
            fn(img, 4)
    assert [tcensus.census_radius(w) for w in (3, 5, 7, 9)] == \
        [jcensus.census_radius(w) for w in (3, 5, 7, 9)]
