"""Port's image substrate on the prefilter path (``visionworkbench_torch/
image/{edge,convolution,filters}.py``, ``stereo/prefilter.py``) against the
JAX package on the CPU, on the same numpy inputs.

Tolerances, each with its reason:

* every edge mode (``crop_extended``/``edge_extend``), on even and odd
  sizes and pads wider than the image: exact (index gathers, copies, and
  ``linear``'s extrapolation in the JAX package's order);
* the kernel generators: exact (the same float64 NumPy code);
* the stencil convolutions (<= 49 taps), the Gaussian, Laplacian and
  derivative filters and both prefilters: exact — the taps are rounded to
  fp32 and summed as the JAX package sums them, on quantized and on
  off-grid inputs;
* convolutions of more than 49 taps: allclose at rtol 1e-5 / atol 1e-4
  (``F.conv2d`` and ``conv_general_dilated`` sum in their own orders;
  each output sums 51-81 terms of up to ~30, so an ulp of the terms is
  ~2e-6 and the sums' rounding reaches ~1e-5 where they cancel).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import _torch_threads, cuda, quantized  # noqa: F401
from visionworkbench_tpu.image import convolution as jconv
from visionworkbench_tpu.image import edge as jedge
from visionworkbench_tpu.image import filters as jfilt
from visionworkbench_tpu.stereo import prefilter as jpre
from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.image import convolution as tconv
from visionworkbench_torch.image import edge as tedge
from visionworkbench_torch.image import filters as tfilt
from visionworkbench_torch.stereo import prefilter as tpre

MODES = ("zero", "constant", "value", "periodic", "cylindrical", "reflect", "linear")


def _img(seed, shape, q=False):
    rng = np.random.default_rng(seed)
    if q:
        return quantized(rng, shape)
    return (rng.random(shape) * 10 - 3).astype(np.float32)


def _eq(got, ref):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_edge_modes_list_matches_jax():
    assert tedge.EDGE_MODES == jedge.EDGE_MODES == MODES


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", [(7, 9), (6, 8), (7, 9, 2), (1, 5), (2, 1)])
def test_edge_extend_matches_jax(mode, shape):
    """Pads narrower and wider than the image, one-sided, and none."""
    img = _img(80, shape)
    t = torch.as_tensor(img)
    for x_pad, y_pad in [((2, 3), 1), ((20, 13), (11, 0)), (0, (3, 3)),
                         ((0, 1), (17, 18)), (0, 0)]:
        _eq(tedge.edge_extend(t, x_pad, y_pad, mode, value=3.5).numpy(),
            jedge.edge_extend(jnp.asarray(img), x_pad, y_pad, mode, value=3.5))


@pytest.mark.parametrize("mode", MODES)
def test_crop_extended_matches_jax(mode):
    for shape in [(7, 9), (8, 6)]:
        img = _img(81, shape)
        for x0, y0, w, h in [(-3, -2, 15, 12), (4, 5, 8, 6), (-20, 3, 40, 2),
                             (2, -9, 3, 25), (1, 1, 3, 3)]:
            _eq(tedge.crop_extended(torch.as_tensor(img), x0, y0, w, h, mode,
                                    value=-1.25).numpy(),
                jedge.crop_extended(jnp.asarray(img), x0, y0, w, h, mode, value=-1.25))


def test_unknown_edge_mode_raises():
    with pytest.raises(ArgumentErr):
        tedge.edge_extend(torch.zeros(3, 3), 1, 1, "mirror")


def test_kernel_generators_match_jax():
    for sigma in (0.0, 0.5, 1.4, 2.3, 3.0):
        assert tfilt.compute_kernel_size(sigma) == jfilt.compute_kernel_size(sigma)
        for size in (0, 4, 7):
            np.testing.assert_array_equal(tfilt.generate_gaussian_kernel(sigma, size),
                                          jfilt.generate_gaussian_kernel(sigma, size))
    for deriv, size in [(0, 0), (1, 0), (2, 0), (1, 5), (2, 7), (3, 0), (4, 9)]:
        np.testing.assert_array_equal(tfilt.generate_derivative_kernel(deriv, size),
                                      jfilt.generate_derivative_kernel(deriv, size))
    for args in [(1.0, 0, 2.0, 0, 0.3, 7), (1.5, 1, 1.0, 2, 1.1, 9),
                 (2.0, 2, 2.0, 1, 0.0, 5)]:
        np.testing.assert_array_equal(tfilt.generate_gaussian_derivative_kernel(*args),
                                      jfilt.generate_gaussian_derivative_kernel(*args))
    for sigma, size in [(1.4, 9), (2.0, 7), (0.8, 5)]:
        np.testing.assert_array_equal(
            tfilt.generate_laplacian_of_gaussian_kernel(sigma, size),
            jfilt.generate_laplacian_of_gaussian_kernel(sigma, size))
    np.testing.assert_array_equal(tfilt.generate_pyramid_smoothing_kernel(),
                                  jfilt.generate_pyramid_smoothing_kernel())
    for bad in [(2, 1), (2, 4)]:
        with pytest.raises(ArgumentErr):
            tfilt.generate_derivative_kernel(*bad)


@pytest.mark.parametrize("edge", ["constant", "zero", "reflect", "value"])
@pytest.mark.parametrize("shape", [(23, 31), (16, 12, 2)])
def test_convolution_filter_matches_jax(edge, shape):
    """Asymmetric kernels (so the flip shows), default and explicit
    origins, up to 49 taps on the stencil."""
    img = _img(82, shape)
    rng = np.random.default_rng(83)
    for kshape, origin in [((3, 3), (None, None)), ((5, 7), (None, None)),
                           ((4, 6), (1, 3)), ((7, 7), (0, 6)), ((1, 5), (None, None))]:
        k = rng.standard_normal(kshape)
        _eq(tconv.convolution_filter(torch.as_tensor(img), k, *origin, edge=edge,
                                     edge_value=0.75).numpy(),
            jconv.convolution_filter(jnp.asarray(img), k, *origin, edge=edge,
                                     edge_value=0.75))
    k = rng.standard_normal((4, 5))
    _eq(tconv.correlate_2d(torch.as_tensor(img), k, edge=edge, edge_value=0.75).numpy(),
        jconv.correlate_2d(jnp.asarray(img), k, edge=edge, edge_value=0.75))


@pytest.mark.parametrize("edge", ["constant", "linear", "periodic"])
def test_separable_convolution_matches_jax(edge):
    img = _img(84, (29, 34))
    rng = np.random.default_rng(85)
    for xk, yk, origin in [(rng.standard_normal(5), rng.standard_normal(3), (None, None)),
                           (rng.standard_normal(9), None, (2, None)),
                           ([], rng.standard_normal(6), (None, 4)),
                           (rng.standard_normal(4), rng.standard_normal(7), (0, 6))]:
        _eq(tconv.separable_convolution_filter(torch.as_tensor(img), xk, yk, *origin,
                                               edge=edge).numpy(),
            jconv.separable_convolution_filter(jnp.asarray(img), xk, yk, *origin,
                                               edge=edge))


@pytest.mark.parametrize("kshape", [(9, 9), (7, 8), (1, 51)])
def test_convolution_past_stencil_allclose(kshape):
    """More than 49 taps: ``F.conv2d`` in fp32 against
    ``conv_general_dilated``."""
    img = _img(86, (40, 70, 2))
    k = np.random.default_rng(87).standard_normal(kshape)
    got = tconv.convolution_filter(torch.as_tensor(img), k).numpy()
    ref = np.asarray(jconv.convolution_filter(jnp.asarray(img), k))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("q", [True, False])
def test_gaussian_laplacian_derivative_filters_match_jax(q):
    img = _img(88, (37, 45), q)
    t, j = torch.as_tensor(img), jnp.asarray(img)
    for args in [(1.4,), (0.7, 2.1), (1.0, 0.0), (2.0, None, 5, 3)]:
        _eq(tfilt.gaussian_filter(t, *args).numpy(), jfilt.gaussian_filter(j, *args))
    _eq(tfilt.laplacian_filter(t).numpy(), jfilt.laplacian_filter(j))
    _eq(tfilt.laplacian_filter(t, edge="zero").numpy(), jfilt.laplacian_filter(j, edge="zero"))
    for args in [(1, 0), (0, 1), (2, 1), (1, 1, 5, 3)]:
        _eq(tfilt.derivative_filter(t, *args).numpy(), jfilt.derivative_filter(j, *args))


@pytest.mark.parametrize("mode", ["log", "meansub", "none"])
@pytest.mark.parametrize("shape", [(96, 80), (33, 47)])
def test_prefilter_matches_jax(mode, shape):
    """Quantized and off-grid images, the CLI's width 1.4 (a 9-tap
    Gaussian) and two others."""
    for q in (True, False):
        img = _img(89, shape, q)
        for width in (1.4, 0.5, 2.3):
            _eq(tpre.prefilter_image(torch.as_tensor(img), mode, width).numpy(),
                jpre.prefilter_image(jnp.asarray(img), mode, width))


def test_unknown_prefilter_raises():
    assert tpre.PREFILTER_MODES == jpre.PREFILTER_MODES
    with pytest.raises(ArgumentErr):
        tpre.prefilter_image(torch.zeros(4, 4), "xx")
    with pytest.raises(ArgumentErr):
        tpre.check_prefilter_mode("laplacian")
    for mode in tpre.PREFILTER_MODES:
        tpre.check_prefilter_mode(mode)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["log", "meansub"])
def test_prefilter_card_matches_cpu(cuda, mode):
    """On the card every tap is a multiply and an add of its own, as on the
    CPU: the prefiltered images are equal bit for bit (off-grid input, and
    the 1024^2 frame's size)."""
    for shape in [(96, 80), (1024, 1024)]:
        img = torch.as_tensor(_img(90, shape))
        got = tpre.prefilter_image(img.to(cuda), mode, 1.4).cpu().numpy()
        np.testing.assert_array_equal(got, tpre.prefilter_image(img, mode, 1.4).numpy())
