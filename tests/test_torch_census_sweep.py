"""Port's sweep with the census, ternary-census and NCC costs
(``visionworkbench_torch/ops/sweep.py``, plain search of
``stereo/correlation.py``) against the JAX package's XLA engines on the
CPU: ``_tiled_search`` and ``_tiled_search_patches``.

Tolerance: exact for disp, valid and the 3x3 patches. Census costs are
small integers (exact in any order) on codes of 8-bit levels; NCC inputs
are on the 1/256 grid, so every window sum and energy is exact in fp32 and
the IEEE quotients and square roots agree bit for bit. Black blocks make
zero-energy NCC windows, whose NaN metrics the first-NaN-wins rule decides.
The CUDA kernel is held against the plain version on the card (skipped
without one).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import _torch_threads, cuda, quantized  # noqa: F401
from visionworkbench_tpu.stereo.pyramid_correlation import (
    _tiled_search, _tiled_search_patches,
)
from visionworkbench_torch.ops import sweep as tsweep
from visionworkbench_torch.stereo import correlation as tcorr

TILE, KW, KH, SX, SY, NTY, NTX = 8, 5, 3, 4, 3, 2, 3
# Every census variant (1- and 2-word codes) and NCC; the patch mode
# alternates so both contracts see one- and two-word codes.
VARIANTS = [("census", 3, True), ("census", 5, False), ("census", 7, True),
            ("census", 9, False), ("ternary_census", 3, False),
            ("ternary_census", 5, True), ("ternary_census", 7, False),
            ("ternary_census", 9, True), ("ncc", 5, False)]


def _inputs(seed, ring, black=False):
    """Frames sized like the pyramid's (offsets up to 3), the base embedded
    in the match frame so the search has true winners; ``black`` zeroes a
    block in each frame."""
    rng = np.random.default_rng(seed)
    lh, lw = NTY * TILE + KH - 1, NTX * TILE + KW - 1
    mh, mw = lh + SY - 1 + 2 * ring + 3, lw + SX - 1 + 2 * ring + 3
    base = quantized(rng, (lh, lw))
    match = quantized(rng, (mh, mw))
    match[2:2 + lh, 1:1 + lw] = base[:mh - 2, :mw - 1]
    if black:
        base[3:9, 4:12] = 0.0
        match[5:12, 2:10] = 0.0
    offsets = rng.integers(0, 4, (NTY, NTX, 2)).astype(np.int32)
    return base, match, offsets


def _port(fn, base, match, offsets, cost, window, want_patches, device="cpu"):
    t = [torch.as_tensor(a, device=device) for a in (base, match, offsets)]
    d, v, p = fn(*t, TILE, SX, SY, KW, KH, cost, want_patches, window)
    return d.cpu().numpy(), v.cpu().numpy(), None if p is None else p.cpu().numpy()


@pytest.mark.parametrize("cost,window,want_patches", VARIANTS)
def test_sweep_census_ncc_matches_jax_tiled_search(cost, window, want_patches):
    ring = int(want_patches)
    base, match, offsets = _inputs(21, ring, black=cost == "ncc")
    d, v, p = _port(tsweep.sweep, base, match, offsets, cost, window, want_patches)
    jb, jm, jo = jnp.asarray(base), jnp.asarray(match), jnp.asarray(offsets)
    if want_patches:
        jd, jv, jp = _tiled_search_patches(jb, jm, jo, TILE, SX, SY, KW, KH, cost,
                                           census_window=window)
        np.testing.assert_array_equal(p, np.moveaxis(np.asarray(jp), -1, 0))
    else:
        jd, jv = _tiled_search(jb, jm, jo, TILE, SX, SY, KW, KH, cost, window)
    np.testing.assert_array_equal(v, np.asarray(jv))
    np.testing.assert_array_equal(d, np.asarray(jd))
    assert v.mean() > 0.5


def test_ncc_nan_rule():
    """A zero-energy left window makes every candidate NaN: the pixel is
    valid with disparity 0 (the tile offset); next to a zero-energy right
    window the first NaN candidate wins over any number."""
    base, match, offsets = _inputs(22, 0, black=True)
    offsets[:] = 0
    t = [torch.as_tensor(a) for a in (base, match, offsets)]
    best = torch.empty(NTY * TILE, NTX * TILE)
    d, v, _ = tsweep.sweep(*t, TILE, SX, SY, KW, KH, "ncc", False, best_out=best)
    nan = best.isnan()
    assert nan.any() and v[nan].all()
    # pixel (4, 5): its left window lies in the black block
    assert bool(nan[4, 5]) and d[4, 5].tolist() == [0, 0]


def test_census_codes_are_per_crop():
    """Codes are computed over the crop given, edges replicated at its
    border: a pixel next to the crop edge sees the replicated edge, not the
    frame beyond it."""
    rng = np.random.default_rng(23)
    img = torch.as_tensor(quantized(rng, (12, 12)))
    whole = tcorr.census_codes(img, "census", 5)
    crop = tcorr.census_codes(img[2:10, 2:10], "census", 5)
    assert torch.equal(crop[2:-2, 2:-2], whole[4:-4, 4:-4])
    assert not torch.equal(crop[0], whole[2, 2:10])
    batched = tcorr.census_codes(torch.stack([img, img.flip(0)]), "ternary_census", 7)
    assert torch.equal(batched[1], tcorr.census_codes(img.flip(0), "ternary_census", 7))
    assert batched.shape == (2, 12, 12, 2) and batched.dtype == torch.int32


@pytest.mark.cuda
@pytest.mark.parametrize("cost,window,want_patches", VARIANTS)
def test_sweep_census_ncc_kernel_matches_plain(cuda, cost, window, want_patches):
    """Each census variant in both patch modes and NCC (black blocks, off
    the 1/256 grid): the kernel equals the plain version exactly."""
    for patches in {want_patches, False}:
        base, match, offsets = _inputs(25, int(patches), black=cost == "ncc")
        noise = np.float32(1e-3) * np.random.default_rng(2).random(base.shape, np.float32)
        base = np.where(base != 0, base + noise, base)     # black blocks stay black
        before = tsweep.launches
        got = _port(tsweep.sweep, base, match, offsets, cost, window, patches, cuda)
        assert tsweep.launches == before + 1
        ref = _port(tsweep.sweep_plain, base, match, offsets, cost, window, patches, cuda)
        for a, b in zip(got, ref):
            if b is not None:
                np.testing.assert_array_equal(a, b)
