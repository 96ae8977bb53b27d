"""Port's SGM/MGM aggregation scans (``visionworkbench_torch/ops/sgm_scan.py``)
against the JAX package on the CPU: each plain version against the JAX
``lax.scan`` engine of ``stereo/sgm.py`` and against the Pallas kernel in
interpret mode, as ``tests/test_sgm.py`` runs them (N <= 24, L = 128), on
the same seeded integer-valued inputs.

Tolerance: exact. Every value is an integer-valued fp32 below 2^24, so the
recurrences are exact in any order. The CUDA kernels are held against the
plain versions on the card (skipped without one), also exactly, with the
carry in shared memory and, for wide search windows, in global scratch.
Pixel differences are drawn from [0, 256), the range of |dI| on 8-bit
images, so the P2' = max(floor(P2 / |dI|), P1) clamp and every IEEE
quotient of the penalty are reached.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import _torch_threads, cuda  # noqa: F401
from visionworkbench_tpu.ops import sgm_scan as jscan
from visionworkbench_tpu.stereo import sgm as jsgm
from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.ops import sgm_scan as tscan

P1, P2 = 15.0, 750.0
BAD = 255.0 + P2


PD_HI = 256       # |dI| of 8-bit images


def _ints(rng, shape, hi, bad_frac=0.0):
    """Integer-valued float32 in [0, hi), with a share of absent (bad)
    candidates."""
    a = np.floor(rng.random(shape) * hi).astype(np.float32)
    if bad_frac:
        a[rng.random(shape) < bad_frac] = BAD
    return a


def _scan_inputs(seed, n, sy, sx, nl, b):
    rng = np.random.default_rng(seed)
    return (_ints(rng, (n, sy, sx, nl), 30, 0.05), _ints(rng, (n, b, nl), PD_HI),
            _ints(rng, (n, b, nl), PD_HI))


def _mgm_inputs(seed, n, sy, sx, nl):
    rng = np.random.default_rng(seed)
    return (_ints(rng, (n, sy, sx, nl), 30, 0.05), _ints(rng, (n, nl), PD_HI),
            _ints(rng, (n, nl), PD_HI), rng.random((n, nl)) > 0.2,
            rng.random((n, nl)) > 0.2)


def _fwd_inputs(seed, n, b, sy, sx, nl):
    rng = np.random.default_rng(seed)
    return (_ints(rng, (n, b, sy, sx, nl), 30, 0.05), _ints(rng, (n, b, nl), PD_HI),
            rng.random((n, b, nl)) > 0.2)


def _t(arrays, device="cpu"):
    return [torch.as_tensor(a, device=device) for a in arrays]


@pytest.mark.parametrize("shifts", [(0,), (0, 1, -1), (1, -1)])
@pytest.mark.parametrize("grid", [(2, 5), (1, 4)])
def test_scan_bidir_matches_jax(shifts, grid):
    sy, sx = grid
    cost, pf, pr = _scan_inputs(20, 24, sy, sx, 128, len(shifts))
    got = tscan.scan_bidir(*_t((cost, pf, pr)), shifts, P1, P2, BAD).numpy()
    j = [jnp.asarray(a) for a in (cost, pf, pr)]
    np.testing.assert_array_equal(got, np.asarray(jsgm._scan_bidir(*j, shifts, P1, P2, BAD)))
    np.testing.assert_array_equal(
        got, np.asarray(jscan.pallas_scan_bidir(*j, shifts, P1, P2, BAD, interpret=True)))


@pytest.mark.parametrize("grid", [(2, 5), (3, 3)])
def test_mgm_bidir_matches_jax(grid):
    sy, sx = grid
    arrays = _mgm_inputs(21, 16, sy, sx, 128)
    got = tscan.mgm_bidir(*_t(arrays), (1, -1), P1, P2, BAD).numpy()
    j = [jnp.asarray(a) for a in arrays]
    old = jsgm._SGM_PALLAS
    try:
        jsgm._SGM_PALLAS = False          # the JAX package's lax.scan engine
        ref = jsgm._mgm_plain_scan(*j, P1, P2, BAD)
    finally:
        jsgm._SGM_PALLAS = old
    np.testing.assert_array_equal(got, np.asarray(ref))
    np.testing.assert_array_equal(
        got, np.asarray(jscan.pallas_mgm_bidir(*j, (1, -1), P1, P2, BAD, interpret=True)))


def test_mgm_fwd_matches_jax():
    cost, pd, g = _fwd_inputs(22, 16, 4, 2, 5, 128)
    got = tscan.mgm_fwd(*_t((cost, pd, g)), (0, 1), P1, P2, BAD).numpy()
    j = [jnp.asarray(a) for a in (cost, pd, g)]

    def step(carry, inp):                 # the scan body of _mgm_sheared_scan
        cx, px, gx = inp
        a = jsgm._path_update(carry, cx, px, P1, P2, BAD)
        bb = jsgm._path_update(jsgm._shift_lane(carry, 1, BAD), cx, px, P1, P2, BAD)
        o = jnp.floor((a + bb) * 0.5)
        o = jnp.where(gx[:, None, None, :], o, cx)
        o = jsgm._force_bad(o, cx, BAD)
        return o, o

    _, ref = jax.lax.scan(step, jnp.full(cost.shape[1:], BAD, jnp.float32), tuple(j))
    np.testing.assert_array_equal(got, np.asarray(ref))
    np.testing.assert_array_equal(
        got, np.asarray(jscan.pallas_mgm_fwd(*j, (0, 1), P1, P2, BAD, interpret=True)))


def test_path_update_quotient_is_ieee():
    """floor(P2 / |dI|) must be the floor of the IEEE quotient: PyTorch's
    ``scalar / tensor`` (reciprocal times scalar) misses exact quotients."""
    pd = torch.arange(1, 2000, dtype=torch.float32)[:, None]
    prior = torch.zeros((pd.shape[0], 1, 1, 1))
    got = tscan._path_update(prior, torch.zeros_like(prior), pd, 0.0, 750.0, BAD)
    ref = jsgm._path_update(jnp.asarray(prior.numpy()), jnp.zeros(prior.shape),
                            jnp.asarray(pd.numpy()), 0.0, 750.0, BAD)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_wrappers_reject_bad_arguments():
    cost, pf, pr = _t(_scan_inputs(23, 4, 1, 2, 8, 1))
    with pytest.raises(ArgumentErr):
        tscan.scan_bidir(cost, pf, pr, (0, 1), P1, P2, BAD)     # B mismatch
    with pytest.raises(ArgumentErr):
        tscan.scan_bidir(cost, pf, pr, (2,), P1, P2, BAD)       # shift > 1
    with pytest.raises(ArgumentErr):
        tscan.mgm_bidir(cost, pf[:, 0], pr[:, 0], pf[:, 0] > 0, pr[:, 0] > 0,
                        (1,), P1, P2, BAD)
    with pytest.raises(ArgumentErr):
        tscan.mgm_fwd(cost, pf, pf > 0, (0, 1), P1, P2, BAD)     # not 5D


# ---- the CUDA kernels against the plain versions (on the card) --------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", [(24, 2, 5, 128, (0, 1, -1)), (40, 1, 4, 1100, (0,)),
                                  (7, 3, 3, 33, (1, -1)),
                                  # a 64x8 search: the carry is in global scratch
                                  (24, 8, 64, 256, (0, 1, -1))])
def test_scan_bidir_kernel_matches_plain(cuda, case):
    n, sy, sx, nl, shifts = case
    args = _t(_scan_inputs(24, n, sy, sx, nl, len(shifts)), cuda)
    before = tscan.launches["scan_bidir"]
    got = tscan.scan_bidir(*args, shifts, P1, P2, BAD)
    assert tscan.launches["scan_bidir"] == before + 1
    ref = tscan.scan_bidir_plain(*args, shifts, P1, P2, BAD)
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(16, 2, 5, 128), (9, 1, 1, 1030),
                                  (9, 8, 16, 256)])      # global scratch
def test_mgm_kernels_match_plain(cuda, case):
    n, sy, sx, nl = case
    args = _t(_mgm_inputs(25, n, sy, sx, nl), cuda)
    before = dict(tscan.launches)
    got = tscan.mgm_bidir(*args, (1, -1), P1, P2, BAD)
    ref = tscan.mgm_bidir_plain(*args, (1, -1), P1, P2, BAD)
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())
    fargs = _t(_fwd_inputs(26, n, 4, sy, sx, nl), cuda)
    got = tscan.mgm_fwd(*fargs, (0, 1), P1, P2, BAD)
    ref = tscan.mgm_fwd_plain(*fargs, (0, 1), P1, P2, BAD)
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())
    assert tscan.launches["mgm_bidir"] == before["mgm_bidir"] + 1
    assert tscan.launches["mgm_fwd"] == before["mgm_fwd"] + 1
