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
from visionworkbench_torch.image.census import census_positions, census_words
from visionworkbench_torch.ops import _build
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


# ---- band_census_kernel (census and ternary census on the card) -------------

def _staged_codes(crop, y0, rows, radius, cost, window):
    """Codes of crop rows y0 .. y0 + rows - 1 (those inside the crop) made as
    csrc/sweep.cu's band_census_kernel makes them: it stages the quantized
    crop with ``radius`` more rows and columns on each side, staged row b
    holding crop row clamp(y0 - radius + b) and staged column j crop column
    clamp(j - radius), clamped to the crop and not to the band
    (``stage_crop``); each code then reads its neighbours unclamped.
    Returns (codes, crop rows)."""
    h, w = crop.shape
    q = torch.clamp(crop * 255.0, 0, 255).to(torch.int32)
    b = (torch.arange(rows + 2 * radius) + y0 - radius).clamp(0, h - 1)
    j = (torch.arange(w + 2 * radius) - radius).clamp(0, w - 1)
    staged = q[b[:, None], j[None, :]]
    r = torch.arange(min(rows, h - y0))            # band rows inside the crop
    c = torch.arange(w)
    center = staged[(r + radius)[:, None], (c + radius)[None, :]]
    ternary = cost == "ternary_census"
    words = [torch.zeros_like(center) for _ in range(census_words(window, ternary))]
    for i, (dc, dr) in enumerate(census_positions(window, ternary)):
        v = staged[(r + radius + dr)[:, None], (c + radius + dc)[None, :]]
        bits = [(2 * i, v >= center - 2), (2 * i + 1, v > center + 2)] if ternary else [
            (i, v > center)]
        for bit, on in bits:
            words[bit // 32] |= on.to(torch.int32) << (bit % 32)
    return torch.stack(words, -1), y0 + r


@pytest.mark.parametrize("cost", ["census", "ternary_census"])
@pytest.mark.parametrize("window", [3, 5, 7, 9])
@pytest.mark.parametrize("tile", [8, 64, 128])
def test_band_code_rows_equal_the_tile_crops_codes(tile, window, cost):
    """For every band of a tile, the codes a band makes from its staged rows
    equal census_codes of the whole tile crop (left block and right window):
    an interior band stages radius rows beyond its own on each side, and
    only bands at the crop's top or bottom see replicated rows. The staged
    bytes are those _census_band_geometry sizes."""
    rows_a_band = _build.SWEEP_BAND_ROWS
    kw, kh, sx, sy = 7, 15, 6, 4
    lh, lw = tile + kh - 1, tile + kw - 1
    rh, rw = lh + sy - 1, lw + sx - 1
    radius = window // 2
    assert radius == max(abs(dr) for _, dr in census_positions(window, cost != "census"))
    rng = np.random.default_rng(tile + window)
    ys, xs = np.mgrid[0:rh, 0:rw].astype(np.float32)
    # smooth structure across band boundaries plus noise, on the 1/256 grid
    img = 0.5 + 0.3 * np.sin(xs * 0.3 + ys * 0.45) + 0.1 * rng.random((rh, rw))
    img = torch.as_tensor(np.round(img * 256) / 256, dtype=torch.float32)
    lrows = rows_a_band + kh - 1
    rrows = lrows + sy - 1
    n_words = census_words(window, cost != "census")
    n_pos = len(census_positions(window, cost != "census"))
    bands, _, smem = tsweep._census_band_geometry(tile, sx, sy, kw, kh, 0, n_words,
                                                  radius, n_pos, False)
    pixels = ((lrows + 2 * radius) * (lw + 2 * radius)
              + (rrows + 2 * radius) * (rw + 2 * radius))
    offsets = 2 * 4 * n_pos          # the positions' offsets, 4-byte aligned
    sums = 4 * (2 * rows_a_band * (lw | 1) + 1)
    assert smem == (4 * n_words * (lrows * lw + rrows * rw)
                    + max(-(-pixels // 4) * 4 + offsets, sums))
    for crop, rows in ((img[:lh, :lw], lrows), (img, rrows)):
        whole = tcorr.census_codes(crop, cost, window)
        for band in range(bands):
            codes, r = _staged_codes(crop, band * rows_a_band, rows, radius, cost, window)
            assert torch.equal(codes, whole[r])


def _band_census_inputs(seed, tile, kw, kh, sx, sy, nty, ntx, ring, source):
    """Frames for the band tests: quantized noise (``noise``), or a smooth
    texture with structure across band boundaries (``texture``, also off the
    1/256 grid); the base embedded in the match frame."""
    rng = np.random.default_rng(seed)
    lh, lw = nty * tile + kh - 1, ntx * tile + kw - 1
    mh, mw = lh + sy - 1 + 2 * ring + 3, lw + sx - 1 + 2 * ring + 3
    if source == "noise":
        match = quantized(rng, (mh, mw))
    else:
        ys, xs = np.mgrid[0:mh, 0:mw].astype(np.float32)
        match = (0.5 + 0.3 * np.sin(xs * 0.21) * np.cos(ys * 0.17)
                 + 0.1 * np.sin(xs * 0.047 + ys * 0.031)
                 + 0.05 * rng.random((mh, mw))).astype(np.float32)
    base = match[2:2 + lh, 1:1 + lw].copy()
    offsets = rng.integers(0, 4, (nty, ntx, 2)).astype(np.int32)
    return base, match, offsets


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["noise", "texture", "codes"])
@pytest.mark.parametrize("patches", [False, True])
@pytest.mark.parametrize("cost,window", [v[:2] for v in VARIANTS if v[0] != "ncc"])
def test_band_census_kernel_matches_plain_and_sweep_kernel(cuda, cost, window, patches,
                                                           source):
    """band_census_kernel equals the plain version and sweep_kernel<3, NW>
    bit for bit (disp, valid, patches, best) for every census variant, with
    and without patches, on codes made from the float crops (noise, and a
    texture whose structure crosses the band boundaries of 2 x 2 tiles of
    32 with a 7x5 kernel) and on code planes made beforehand."""
    tile, kw, kh, sx, sy, nty, ntx = 32, 7, 5, 6, 3, 2, 2
    ring = int(patches)
    base, match, offsets = _band_census_inputs(26, tile, kw, kh, sx, sy, nty, ntx, ring,
                                               "noise" if source == "noise" else "texture")
    t = [torch.as_tensor(a, device=cuda) for a in (base, match, offsets)]
    if source == "codes":
        t[:2] = [tcorr.census_codes(a, cost, window).contiguous() for a in t[:2]]
    args = (*t, tile, sx, sy, kw, kh, cost, patches, window)
    assert tsweep._sweep_variant(cost, tile, sx, sy, kw, kh, ring, window,
                                 source == "codes") == 16
    best = [torch.empty(nty * tile, ntx * tile, device=cuda) for _ in range(3)]
    before = (tsweep.launches, tsweep.census_band_launches)
    got = (*tsweep.sweep(*args, best_out=best[0]), best[0])
    assert (tsweep.launches, tsweep.census_band_launches) == (before[0] + 1, before[1] + 1)
    refs = [(*tsweep.sweep_plain(*args, best_out=best[1]), best[1]),
            (*tsweep._sweep_cuda(*args, best[2], None), best[2])]
    assert tsweep.census_band_launches == before[1] + 1      # it ran sweep_kernel
    for ref in refs:
        for a, b in zip(got, ref):
            if b is not None:
                np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


def test_census_ablation_variants_edit_the_kernel_source(tmp_path):
    """Each variant of ``tools/sweep_census_ablation.py`` is a text edit of
    band_census_kernel's body that still matches the source exactly once."""
    from visionworkbench_torch.tools import sweep_census_ablation as ablation
    paths = ablation._variant_sources(tmp_path)
    assert set(paths) == set(ablation.ABLATIONS)
    as_is = paths["as_is"].read_text()
    assert as_is == (_build.CSRC / "sweep.cu").read_text()
    for name, path in paths.items():
        assert (path.read_text() != as_is) == bool(ablation.ABLATIONS[name])
