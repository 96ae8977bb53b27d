"""Port's block-matching sweep (``visionworkbench_torch/ops/sweep.py`` and the
plain search of ``stereo/correlation.py``) against the JAX package's XLA
engines on the CPU: ``_tiled_search``, ``_tiled_search_patches``,
``_best_of_search`` and ``_search_with_patches``.

Tolerance: exact for disp, valid and the 3x3 patches — inputs are on the
1/256 grid, so every window sum is exact in fp32 in any order.
The CUDA kernel is held against the plain version on the card (skipped
without one).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import _torch_threads, cuda, quantized  # noqa: F401
from visionworkbench_tpu.stereo import correlation as jcorr
from visionworkbench_tpu.stereo.pyramid_correlation import (
    _tiled_search, _tiled_search_patches,
)
from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.ops import sweep as tsweep
from visionworkbench_torch.stereo import correlation as tcorr

# (cost, tile, kw, kh, s_x, s_y, nty, ntx): non-square windows and kernels,
# tile grids of at least 2x2
CASES = [
    ("abs", 8, 5, 3, 6, 4, 2, 3),
    ("sq", 8, 3, 5, 4, 6, 3, 2),
    ("abs", 16, 7, 7, 11, 2, 2, 2),
]


def _inputs(seed, case, ring, max_off=4, overrun=0):
    """base/match frames sized like the pyramid's, with the base embedded
    in the match frame so the search has true winners."""
    _, tile, kw, kh, sx, sy, nty, ntx = case
    rng = np.random.default_rng(seed)
    lh, lw = nty * tile + kh - 1, ntx * tile + kw - 1
    mh = lh + sy - 1 + 2 * ring + max_off
    mw = lw + sx - 1 + 2 * ring + max_off
    base = quantized(rng, (lh, lw))
    match = quantized(rng, (mh, mw))
    match[2:2 + lh, 3:3 + lw] = base[:mh - 2, :mw - 3]
    offsets = rng.integers(0, max_off + 1 + overrun, (nty, ntx, 2)).astype(np.int32)
    return base, match, offsets


def _port(fn, base, match, offsets, case, want_patches, device="cpu"):
    cost, tile, kw, kh, sx, sy, _, _ = case
    t = [torch.as_tensor(a, device=device) for a in (base, match, offsets)]
    d, v, p = fn(*t, tile, sx, sy, kw, kh, cost, want_patches)
    return d.cpu().numpy(), v.cpu().numpy(), None if p is None else p.cpu().numpy()


@pytest.mark.parametrize("want_patches", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_sweep_matches_jax_tiled_search(case, want_patches):
    cost, tile, kw, kh, sx, sy, _, _ = case
    ring = int(want_patches)
    base, match, offsets = _inputs(11, case, ring)
    d, v, p = _port(tsweep.sweep, base, match, offsets, case, want_patches)
    jb, jm, jo = jnp.asarray(base), jnp.asarray(match), jnp.asarray(offsets)
    if want_patches:
        jd, jv, jp = _tiled_search_patches(jb, jm, jo, tile, sx, sy, kw, kh, cost)
        # JAX stacks the patch as (H, W, 9); the port returns (9, H, W) planes
        np.testing.assert_array_equal(p, np.moveaxis(np.asarray(jp), -1, 0))
    else:
        jd, jv = _tiled_search(jb, jm, jo, tile, sx, sy, kw, kh, cost, 5)
        assert p is None
    np.testing.assert_array_equal(v, np.asarray(jv))
    np.testing.assert_array_equal(d, np.asarray(jd))
    assert d.dtype == np.int32 and v.dtype == bool
    assert 0.5 < v.mean() <= 1.0


def test_sweep_clamps_window_start_like_dynamic_slice():
    """Offsets that would run a window past the frame clamp its start into
    the frame, as lax.dynamic_slice does, while disp carries the offset."""
    case = CASES[0]
    cost, tile, kw, kh, sx, sy, _, _ = case
    base, match, offsets = _inputs(12, case, 0, max_off=2, overrun=6)
    d, v, _ = _port(tsweep.sweep, base, match, offsets, case, False)
    jd, jv = _tiled_search(jnp.asarray(base), jnp.asarray(match),
                           jnp.asarray(offsets), tile, sx, sy, kw, kh, cost, 5)
    np.testing.assert_array_equal(v, np.asarray(jv))
    np.testing.assert_array_equal(d, np.asarray(jd))


@pytest.mark.parametrize("cost", ["abs", "sq"])
def test_search_matches_jax_correlation(cost):
    rng = np.random.default_rng(13)
    h, w, sx, sy, kw, kh = 20, 24, 5, 3, 5, 3
    left = quantized(rng, (h, w))
    right = quantized(rng, (h + sy + 1, w + sx + 1))
    right[2:2 + h, 1:1 + w] = left
    inner = right[1:1 + h + sy - 1, 1:1 + w + sx - 1]
    td, tv, tb = tcorr._best_of_search(torch.as_tensor(left),
                                       torch.as_tensor(inner), sx, sy, kw, kh, cost)
    jd, jv, jb = jcorr._best_of_search(jnp.asarray(left), jnp.asarray(inner),
                                       sx, sy, kw, kh, cost)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    pd, pv, pb, pp = tcorr._search_with_patches(
        torch.as_tensor(left), torch.as_tensor(right), sx, sy, kw, kh, cost)
    qd, qv, qb, qp = jcorr._search_with_patches(
        jnp.asarray(left), jnp.asarray(right), sx, sy, kw, kh, cost,
        chunk=(sx + 2) * (sy + 2))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(qv))
    np.testing.assert_array_equal(pd.numpy(), np.asarray(qd))
    np.testing.assert_array_equal(pp.numpy(), np.asarray(qp))
    # the patched sweep keeps the plain sweep's winners
    np.testing.assert_array_equal(pd.numpy(), td.numpy())


@pytest.mark.parametrize("cost", ["census", "ternary_census", "ncc", "nope"])
def test_sweep_rejects_costs_not_ported(cost):
    """Every cost is ported now; what the sweep still rejects is a census
    window with no variant, NCC in patch mode and an unknown cost."""
    base, match, offsets = _inputs(14, CASES[0], 1)
    _, tile, kw, kh, sx, sy, _, _ = CASES[0]
    t = [torch.as_tensor(a) for a in (base, match, offsets)]
    window = {"census": 4, "ternary_census": 11}.get(cost, 5)
    with pytest.raises(ArgumentErr):
        tsweep.sweep(*t, tile, sx, sy, kw, kh, cost, cost == "ncc", window)


def test_sweep_rejects_match_frame_smaller_than_a_window():
    _, tile, kw, kh, sx, sy, _, _ = CASES[0]
    base, match, offsets = _inputs(15, CASES[0], 0)
    with pytest.raises(ArgumentErr):
        _port(tsweep.sweep, base, match[:tile + kh + sy - 3], offsets, CASES[0], False)


@pytest.mark.cuda
@pytest.mark.parametrize("want_patches", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_sweep_kernel_matches_plain(cuda, case, want_patches):
    """The CUDA kernel adds in the plain version's order: exact on any
    input, here on unquantized noise too."""
    base, match, offsets = _inputs(16, case, int(want_patches))
    base = base + np.float32(1e-3) * np.random.default_rng(1).random(base.shape, np.float32)
    before = tsweep.launches
    got = _port(tsweep.sweep, base, match, offsets, case, want_patches, cuda)
    assert tsweep.launches == before + 1
    ref = _port(tsweep.sweep_plain, base, match, offsets, case, want_patches, cuda)
    for a, b in zip(got, ref):
        if b is not None:
            np.testing.assert_array_equal(a, b)


def _fake_nvcc(tmp_path, fail):
    """A stand-in nvcc under CUDA_HOME that logs each call and either
    writes its -o file or fails like a compile error."""
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f'echo call >> "{tmp_path}/calls.log"\n'
        'while [ $# -gt 0 ]; do [ "$1" = "-o" ] && out="$2"; shift; done\n'
        + ('echo "error: bad source"; exit 2\n' if fail else ': > "$out"\n'))
    nvcc.chmod(0o755)
    return tmp_path / "calls.log"


@pytest.mark.parametrize("fail", [False, True])
def test_kernel_build_runs_once_or_raises(monkeypatch, tmp_path, fail):
    """The loader runs nvcc once per source and reuses the library; a failed
    build raises and leaves no library behind (no fallback)."""
    from visionworkbench_torch.ops import _build
    calls = _fake_nvcc(tmp_path, fail)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    if fail:
        with pytest.raises(RuntimeError, match="bad source"):
            _build.build()
        assert not list((tmp_path / "build").glob("*.so"))
        return
    libs = _build.build()
    assert set(libs) == set(_build.SOURCES) == {"sweep", "speckle", "sgm_scan",
                                                  "mgm_scan"}
    assert all(p.exists() for p in libs.values())
    assert _build.build() == libs
    assert len(calls.read_text().splitlines()) == 4     # one nvcc per source


def test_launch_error_code_raises():
    from visionworkbench_torch.ops import _build
    _build.check(0, "sweep")
    with pytest.raises(RuntimeError, match="cudaError_t 1"):
        _build.check(1, "sweep")
