"""The SGM/MGM winner-take-all and subpixel step (``visionworkbench_torch/
ops/sgm_wta.py``): the CUDA kernel ``csrc/sgm_wta.cu`` against its plain
version on the card, and the plain parabola fit against its former
formulation on the CPU.

Tolerances, each with its reason:

* kernel against plain version on the card: bit for bit (the float32 words
  of both offsets and winners) — the cascade is integer-valued fp32, and
  the kernel repeats each subpixel operation in the plain version's order,
  built with ``--fmad=false``;
* the plain parabola against its former formulation (a float64 matrix
  product, the erf's scalings as divisions) on the CPU: 1e-12 px — the
  fit's sums are exact for integer-valued costs in any order, and a product
  with the reciprocal moves the erf's argument by at most one float64 ulp.
"""

import math

import numpy as np
import pytest
import torch

from torch_parity import _torch_threads, cuda  # noqa: F401
from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.ops import sgm_wta

MODES = ["none", "parabola", "linear", "poly4", "cosine", "lc_blend"]
BAD = 255.0 + 1500.0                  # asp-mgm's absent candidate, P2 = 1500
ABSENT = sgm_wta.N_PATHS * BAD
# (sy, sx): one cell, the coarse levels' rows and columns, the MGM cell's
# level 0 (3 x 5), a square grid, 6 and 27 cells (the 8- and 32-cell
# register instances), calc_disparity_sgm's 64 x 8 (wide variant) and a
# grid past the wide variant's shared memory (its global scratch).
SHAPES = [(1, 1), (1, 2), (2, 1), (1, 5), (5, 1), (3, 5), (5, 3), (4, 4), (2, 3),
          (3, 9), (8, 64), (40, 200)]


def _volume(seed, h, w, sy, sx):
    """An (H, W, sy, sx) accumulated volume rich in ties: integer costs
    from a few levels (most pixels' minima repeat, some through all six
    cascade iterations), absent candidates at random and along the grid's
    edges, one pixel all absent and one whose only allowed cell is a
    corner."""
    rng = np.random.default_rng(seed)
    levels = rng.integers(0, 3, (h, w, 1, 1))            # 0: many ties
    vol = 300.0 + 40.0 * rng.integers(0, 2 + levels, (h, w, sy, sx))
    wide = rng.random((h, w)) < 0.2
    vol[wide] = rng.integers(100, 9000, (int(wide.sum()), sy, sx))
    vol[rng.random((h, w, sy, sx)) < 0.08] = ABSENT
    edge = rng.random((h, w)) < 0.1
    vol[edge, :, 0] = ABSENT
    vol[edge, -1, :] = ABSENT
    vol[0, 0] = ABSENT
    vol[h - 1, w - 1] = ABSENT
    vol[h - 1, w - 1, -1, -1] = 500.0
    return torch.as_tensor(vol.astype(np.float32))


def _cascade_iterations(acc, bad):
    """Per pixel, the cascade iteration whose winner the plain version keeps
    (0: unique at once; 6: never unique)."""
    allowed = acc < sgm_wta.N_PATHS * bad - 0.5
    af = allowed.to(acc.dtype)
    _, cnt, _ = sgm_wta._wta_stats(acc, allowed)
    inv = {ax: 1.0 / torch.clamp(af + sgm_wta._sh3(af, 1, ax) + sgm_wta._sh3(af, -1, ax),
                                 min=1.0) for ax in (2, 3)}
    done = cnt <= 1
    kept = torch.full(cnt.shape, 6, dtype=torch.int32)
    kept[done] = 0
    v = acc
    for k in range(1, 7):
        v = sgm_wta._masked_mean3(v, af, inv[3 if k <= 5 else 2], 3 if k <= 5 else 2)
        _, cnt, _ = sgm_wta._wta_stats(v, allowed)
        now = ~done & (cnt <= 1)
        kept[now] = k
        done = done | now
    return kept


# The card's cascade-depth test: its frame, seed and grids.
DEPTH_FRAME = (29, 37, 41)
DEPTH_SHAPES = [(3, 5), (3, 9), (8, 64)]


@pytest.mark.parametrize("shape", DEPTH_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_volume_exercises_every_cascade_depth(shape):
    """The card's cascade-depth volumes reach every depth 0-6 (1, 5 and 6
    among them), with all-absent pixels."""
    acc = _volume(*DEPTH_FRAME, *shape)
    kept = set(_cascade_iterations(acc, BAD).unique().tolist())
    assert kept == set(range(7)), kept
    assert bool((acc >= ABSENT).all(-1).all(-1).any())


def _parabola_2d_matmul(z):
    """The plain parabola fit as first written: a float64 matrix product
    and the erf's scalings as divisions."""
    pinv = torch.as_tensor(sgm_wta.PINV_A).to(torch.float64)
    v = z.to(torch.float64) @ pinv.T
    a, b, c, d, e = v.unbind(-1)[:5]
    denom = 4.0 * a * b - c * c
    ok = denom.abs() >= 0.01
    safe = torch.where(ok, denom, torch.ones_like(denom))
    ox = ((c * e - 2.0 * b * d) / safe).to(torch.float32).to(torch.float64)
    oy = ((c * d - 2.0 * a * e) / safe).to(torch.float32).to(torch.float64)
    ox = torch.erf(ox / (0.34574 * math.sqrt(2.0))) / 2.0
    oy = torch.erf(oy / (0.38944 * math.sqrt(2.0))) / 2.0
    norm = torch.hypot(ox, oy)
    scale = torch.where(norm >= 0.5, norm / 0.5, torch.ones_like(norm))
    zero = torch.zeros_like(ox)
    return (torch.where(ok, ox / scale, zero).to(torch.float32),
            torch.where(ok, oy / scale, zero).to(torch.float32))


def test_parabola_matches_former_formulation():
    """On a 32x32 frame of winners' neighbourhoods (integer costs, a flat
    and a degenerate one among them), the fit in explicit order equals the
    matrix product within 1e-12 px."""
    rng = np.random.default_rng(5)
    z = 1000.0 + rng.integers(0, 400, (32, 32, 9)).astype(np.float64)
    z[..., 4] = 900.0 + rng.integers(0, 100, (32, 32))
    z[0, 0] = 700.0                                     # flat: denom 0
    z[0, 1] = [9, 1, 9, 9, 1, 9, 9, 1, 9]               # a valley along y
    zt = torch.as_tensor(z.astype(np.float32))
    new = sgm_wta._parabola_2d(zt)
    old = _parabola_2d_matmul(zt)
    for n, o in zip(new, old):
        assert float((n.double() - o.double()).abs().max()) <= 1e-12
    assert float(new[0].abs().max()) > 0.1            # the fits move


def test_wrapper_rejects_bad_arguments():
    acc = torch.zeros((2, 2, 1, 3))
    with pytest.raises(ArgumentErr, match="subpixel mode"):
        sgm_wta.volume_argmin_subpixel(acc, "spline", BAD)
    with pytest.raises(ArgumentErr, match="non-empty"):
        sgm_wta.volume_argmin_subpixel(torch.zeros((2, 2, 3)), "none", BAD)
    with pytest.raises(ArgumentErr, match="non-empty"):
        sgm_wta.volume_argmin_subpixel(torch.zeros((0, 2, 1, 3)), "none", BAD)


@pytest.mark.parametrize("mode", MODES)
def test_cpu_wrapper_runs_plain_version(mode):
    """CPU tensors take the plain version and launch nothing."""
    acc = _volume(3, 9, 11, 3, 5)
    before = sgm_wta.launches
    out = sgm_wta.volume_argmin_subpixel(acc, mode, BAD)
    assert sgm_wta.launches == before
    assert torch.equal(out, sgm_wta.volume_argmin_subpixel_plain(acc, mode, BAD))
    assert out.shape == (9, 11, 2) and out.dtype == torch.float32


def test_block_matcher_parabola_reads_the_one_matrix():
    """The block matcher's parabola (stereo/subpixel.py) and this step read
    one pseudoinverse, the reference's float32 values."""
    from visionworkbench_torch.stereo import subpixel
    assert subpixel._PINV_A is sgm_wta.PINV_A
    assert sgm_wta.PINV_A.dtype == np.float32 and sgm_wta.PINV_A.shape == (6, 9)


def test_scan_load_builds_wta_beside_it(monkeypatch, tmp_path):
    """The first load of a scan's library builds csrc/sgm_wta.cu in the same
    round of nvcc calls; the step's own load then builds nothing; a source
    without companions builds alone."""
    from test_torch_sweep import _fake_nvcc
    from visionworkbench_torch.ops import _build
    calls = _fake_nvcc(tmp_path, False)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: path)
    for scan in ("sgm_scan", "mgm_scan", "sgm_path_scan", "mgm_cluster_scan"):
        assert _build.COMPANIONS[scan] == ("sgm_wta",)
    assert _build.load("mgm_scan") == str(_build.library_path("mgm_scan"))
    assert len(calls.read_text().splitlines()) == 2
    assert _build.library_path("sgm_wta").exists()
    assert _build.load("sgm_wta") == str(_build.library_path("sgm_wta"))
    assert len(calls.read_text().splitlines()) == 2
    _build.load("sgm_path_scan")
    _build.load("speckle")
    assert len(calls.read_text().splitlines()) == 4
    assert not (tmp_path / "build" / _build.library_path("sweep").name).exists()


def _bits(t):
    return t.contiguous().view(torch.int32).cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", MODES)
def test_kernel_matches_plain(cuda, shape, mode):
    """Kernel against plain version on the card, bit for bit: winners and
    both offsets, on a frame of 7 x 19 = 133 pixels (not a multiple of the
    register variant's 128-pixel block), with ties at every cascade depth,
    absent candidates and all-absent pixels; one launch a call."""
    sy, sx = shape
    h, w = (7, 19) if sy * sx <= 512 else (3, 5)
    acc = _volume(11 + sy * sx, h, w, sy, sx).to(cuda)
    before = sgm_wta.launches
    out = sgm_wta.volume_argmin_subpixel(acc, mode, BAD)
    assert sgm_wta.launches == before + 1
    ref = sgm_wta.volume_argmin_subpixel_plain(acc, mode, BAD)
    torch.cuda.synchronize()
    assert torch.equal(_bits(out), _bits(ref))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", DEPTH_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_kernel_matches_plain_at_every_cascade_depth(cuda, shape):
    """A larger frame (37 x 41), whose pixels' winners come from every
    cascade depth 0-6: per depth, winners and every mode's offsets bit for
    bit, and every offset inside (-1, 1)."""
    acc = _volume(*DEPTH_FRAME, *shape)
    kept = _cascade_iterations(acc, BAD)
    assert set(kept.unique().tolist()) == set(range(7))
    acc = acc.to(cuda)
    winners = sgm_wta.volume_argmin_subpixel(acc, "none", BAD)
    assert torch.equal(_bits(winners), _bits(sgm_wta.volume_argmin_subpixel_plain(acc, "none", BAD)))
    for mode in MODES[1:]:
        out = sgm_wta.volume_argmin_subpixel(acc, mode, BAD)
        ref = sgm_wta.volume_argmin_subpixel_plain(acc, mode, BAD)
        for k in kept.unique().tolist():
            sel = (kept == k).to(cuda)
            assert torch.equal(_bits(out[sel]), _bits(ref[sel])), (mode, k)
        off = out - winners
        assert bool(((off > -1) & (off < 1)).all())


@pytest.mark.cuda
def test_kernel_takes_any_layout(cuda):
    """A permuted (non-contiguous) volume, as the SGM aggregation's sum
    gives, reads as its values: equal to the contiguous one's result."""
    acc = _volume(41, 13, 17, 3, 5).to(cuda)
    perm = acc.permute(1, 2, 3, 0).contiguous().permute(3, 0, 1, 2)
    assert not perm.is_contiguous()
    out = sgm_wta.volume_argmin_subpixel(perm, "parabola", BAD)
    assert torch.equal(_bits(out), _bits(sgm_wta.volume_argmin_subpixel(acc, "parabola", BAD)))
