"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``):
the quantized-input protocol, the thread cap, the card fixture, and for
the subpixel refiners the oracle run, two test scenes and a map
comparison.

Protocol (as ``tests/test_oracle_parity.py``): inputs are quantized to the
1/256 grid, which makes every absolute- and squared-difference window sum
exact in fp32 whatever the summation order, so the port's integer
disparities and validity must equal the JAX package's bit for bit.
"""

import numpy as np
import pytest
import torch

from visionworkbench_torch.stereo.correlation import DisparityMap
from visionworkbench_torch.stereo.subpixel_refine import bayes_em_subpixel


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


def oracle_scene(h=40, w=40, dx=0.3, dy=-0.2):
    """The JAX package's oracle scene (``tests/test_em_oracle_parity.py``):
    left(p) = right(p + d) for a constant subpixel d, a smooth texture
    normalized to [0, 1]."""
    def tex(yy, xx):
        raw = (np.sin(xx * 0.35) * np.cos(yy * 0.3)
               + 0.5 * np.sin(xx * 0.11 + yy * 0.17)
               + 0.2 * np.cos(xx * 0.05 - yy * 0.07))
        return ((raw + 1.7) / 3.4).astype(np.float32)

    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    return tex(ys, xs), tex(ys - dy, xs - dx)


def run_vs_oracle(monkeypatch, em_iters, outer_iters, h=40, w=40, kw=9, kh=9):
    """Oracle and port (re-warp mode) from a zero seed; the interior
    (``kh`` px margin: the oracle zero-extends, the port replicates)."""
    from oracle import vw_oracle_em as ora
    left, right = oracle_scene(h, w)
    disp0 = np.zeros((h, w, 2), np.float32)
    valid0 = np.ones((h, w), bool)
    if em_iters > 0:
        od, ov = ora.subpixel_optimized_affine_2d_em(
            disp0.copy(), valid0.copy(), left, right, kw, kh,
            em_inner_iters=em_iters, outer_iters=outer_iters)
    else:
        od, ov = ora.subpixel_optimized_affine_2d(
            disp0.copy(), valid0.copy(), left, right, kw, kh,
            outer_iters=outer_iters)
    monkeypatch.setenv("VWTPU_EM_REWARP", "1")
    out = bayes_em_subpixel(
        DisparityMap(torch.as_tensor(disp0), torch.as_tensor(valid0)), left, right,
        (kw, kh), em_iters=em_iters, outer_iters=outer_iters, max_pyramid_levels=0)
    td, tv = out.to_numpy()
    core = np.s_[kh:h - kh, kw:w - kw]
    return od[core], ov[core], td[core], tv[core]


def sine_scene(h, w, true):
    """A continuous texture sampled at a known fractional shift, in [0, 1]
    (the JAX package's ``tests/test_subpixel_refine.py`` pattern):
    left(p) = right(p + true)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)

    def tex(x, y):
        v = (np.sin(0.55 * x) * np.cos(0.43 * y)
             + 0.5 * np.sin(0.21 * x + 0.33 * y)
             + 0.3 * np.sin(1.3 * x) * np.sin(1.1 * y))
        return ((v + 1.8) / 3.6).astype(np.float32)
    return tex(xx, yy), tex(xx - true[0], yy - true[1])


def agreement(jd, jv, td, tv):
    """(share of pixels whose validity agrees, |dd| on pixels valid in
    both) of two disparity maps."""
    both = jv & tv
    return (jv == tv).mean(), np.abs(jd - td).max(-1)[both]


def port_camera(jax_model):
    """The port's camera built from a JAX package camera's float64
    attributes (``C``, ``R``, ``fu``..., ``A``, ``H``, ``V``, ``O``, ``Rd``,
    ``E``, the linearity, the distortion's ``params``, an adjusted model's
    translation, rotation and centre, an optical bar's image size, centre
    offset, pitch, f, scan time and rate, direction, position, rotation,
    velocity, motion-compensation flag and factor)."""
    import visionworkbench_torch.camera as tcam
    name = type(jax_model).__name__
    if name == "AdjustedCameraModel":
        return tcam.AdjustedCameraModel(
            port_camera(jax_model.unadjusted), np.asarray(jax_model.translation),
            np.asarray(jax_model.rotation), np.asarray(jax_model.rotation_center))
    if name == "PinholeModel":
        d = jax_model.distortion
        if type(d).__name__ == "RPCLensDistortion":
            dist = tcam.RPCLensDistortion(d.num_x, d.den_x, d.num_y, d.den_y)
        else:
            dist = tcam.DISTORTION_TYPES[d.name](*d.params)
        return tcam.PinholeModel(jax_model.C, jax_model.R, (jax_model.fu, jax_model.fv),
                                 (jax_model.cu, jax_model.cv), dist, jax_model.pixel_pitch)
    m = jax_model
    if name == "OpticalBarModel":
        return tcam.OpticalBarModel(m.image_size, m.c0, m.pitch, m.f, m.scan_time, m.scan_rate,
                                    m.left_to_right, m.position, m.rotation, m.velocity,
                                    m.use_mc, m.mcf)
    if name == "CAHVModel":
        return tcam.CAHVModel(m.C, m.A, m.H, m.V)
    if name == "CAHVORModel":
        return tcam.CAHVORModel(m.C, m.A, m.H, m.V, m.O, m.Rd)
    if name == "CAHVOREModel":
        return tcam.CAHVOREModel(m.C, m.A, m.H, m.V, m.O, m.Rd, m.E, m.linearity)
    raise TypeError(f"port_camera: no port of {name}")


def jax_georef(g):
    """The JAX package's georeference of a port's (same datum, transform
    and pixel interpretation)."""
    import visionworkbench_tpu.cartography as jcart
    d = g.datum
    jd = jcart.Datum(d.name, d.spheroid_name, d.meridian_name, d.a, d.b, d.meridian_offset)
    return jcart.GeoReference(jd, jcart.Projection(jd), g.transform, g.pixel_interpretation)
