"""Filter kernel generation and the standard filters (port of
``visionworkbench_tpu/image/filters.py``; ref ``src/vw/Image/Filter.h`` /
``Filter.tcc`` / ``Filter.cc``).

The kernel generators are the JAX package's float64 NumPy code, copied:

* Gaussian taps are erf-integrated over pixel extents and normalized
  (``Filter.tcc:37-80``); the default size is ``7*sigma`` floored to odd,
  at least 3 (``Filter.cc:32-38``);
* derivative kernels invert the Taylor-expansion matrix
  ``T(i,j) = (half-j)^i / i!`` (``Filter.tcc:85-140``);
* Gaussian-derivative and Laplacian-of-Gaussian 2D kernels follow
  ``Filter.tcc:143-180``, mean subtraction included;
* the pyramid smoothing kernel is the fixed 5-tap [1,4,6,4,1]/16
  (``Filter.h:89-99``).

The filters run on tensors through :mod:`visionworkbench_torch.image.
convolution`, whose stencil rounds the taps to fp32 and sums in the JAX
package's order.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.image.convolution import (
    convolution_filter, separable_convolution_filter,
)


def compute_kernel_size(sigma: float) -> int:
    """Default Gaussian kernel size (ref ``Filter.cc:32-38``)."""
    size = int(7 * sigma)
    if size < 3:
        size = 3
    elif size % 2 == 0:
        size -= 1
    return size


def generate_gaussian_kernel(sigma: float, size: int = 0) -> np.ndarray:
    """Erf-integrated Gaussian taps (ref ``Filter.tcc:37-80``)."""
    if sigma == 0:
        return np.zeros((0,), np.float64)
    if size == 0:
        size = compute_kernel_size(sigma)
    kernel = np.zeros((size,), np.float64)
    center = size // 2
    z = 1.0 / (math.sqrt(2.0) * sigma)
    total = 0.0
    if size % 2 == 0:
        for i in range(center):
            tap = math.erf((i + 1.0) * z) - math.erf(i * z)
            total += tap
            kernel[center + i] = kernel[center - i - 1] = tap
        total *= 2.0
    else:
        for i in range(1, center + 1):
            tap = math.erf((i + 0.5) * z) - math.erf((i - 0.5) * z)
            total += tap
            kernel[center + i] = kernel[center - i] = tap
        total *= 2.0
        tap = math.erf(0.5 * z) - math.erf(-0.5 * z)
        total += tap
        kernel[center] = tap
    return kernel / total


def generate_derivative_kernel(deriv: int, size: int = 0) -> np.ndarray:
    """Taylor-matrix differentiation kernel (ref ``Filter.tcc:85-140``)."""
    if deriv == 0:
        return np.zeros((0,), np.float64)
    minsize = deriv + (deriv % 2) + 1
    if size == 0:
        size = minsize
    elif size < minsize:
        raise ArgumentErr("Derivative kernel too small for requested "
                          "differentiation operator!")
    elif size % 2 == 0:
        raise ArgumentErr("Kernel must have odd dimensions!")
    if deriv == 1 and size == 3:
        return np.array([0.5, 0.0, -0.5], np.float64)
    if deriv == 2 and size == 3:
        return np.array([1.0, -2.0, 1.0], np.float64)
    half = size // 2
    pmat = np.zeros((size, size), np.float64)
    for j in range(size):
        x = half - j
        term = 1.0
        for i in range(size):
            pmat[i, j] = term
            term *= x
            term /= i + 1
    dsel = np.zeros((size,), np.float64)
    dsel[deriv] = 1.0
    return np.linalg.inv(pmat) @ dsel


def generate_gaussian_derivative_kernel(sigma1: float, deriv1: int,
                                        sigma2: float, deriv2: int,
                                        angle: float, size: int) -> np.ndarray:
    """Oriented Gaussian-derivative 2D kernel (ref ``Filter.tcc:143-162``),
    indexed [row, col]: the transpose of the reference's (i = column, j)
    fill, which matches its on-image orientation."""
    kernel = np.zeros((size, size), np.float64)
    ca, sa = math.cos(angle), math.sin(angle)
    half = size // 2
    scalar = (2 * math.pi * sigma1 * sigma2 *
              (-sigma1 * sigma1) ** deriv1 * (-sigma2 * sigma2) ** deriv2)
    for i in range(size):       # i = x (col)
        for j in range(size):   # j = y (row)
            x = ca * (i - half) + sa * (j - half)
            y = -sa * (i - half) + ca * (j - half)
            v = math.exp(-x * x / (2 * sigma1 * sigma1)) * \
                math.exp(-y * y / (2 * sigma2 * sigma2)) / scalar
            if deriv1 == 1:
                v *= x
            elif deriv1 == 2:
                v *= (x * x - sigma1 * sigma1)
            if deriv2 == 1:
                v *= y
            elif deriv2 == 2:
                v *= (y * y - sigma2 * sigma2)
            kernel[j, i] = v
    s = kernel.sum()
    if deriv1 == 0 and deriv2 == 0:
        kernel /= s
    else:
        kernel -= s / (size * size)
    return kernel


def generate_laplacian_of_gaussian_kernel(sigma: float, size: int) -> np.ndarray:
    """LoG 2D kernel (ref ``Filter.tcc:167-180``)."""
    kernel = np.zeros((size, size), np.float64)
    half = size // 2
    scalar = 2 * math.pi * sigma ** 6
    for i in range(size):
        for j in range(size):
            x, y = i - half, j - half
            kernel[j, i] = (math.exp(-(x * x + y * y) / (2 * sigma * sigma)) *
                            (x * x + y * y - 2 * sigma * sigma) / scalar)
    kernel -= kernel.sum() / (size * size)
    return kernel


def generate_pyramid_smoothing_kernel() -> np.ndarray:
    """Fixed 5-tap [1,4,6,4,1]/16 (ref ``Filter.h:89-99``)."""
    return np.array([1, 4, 6, 4, 1], np.float64) / 16.0


def gaussian_filter(src, x_sigma: float, y_sigma: Optional[float] = None,
                    x_dim: int = 0, y_dim: int = 0, edge: str = "constant"):
    """Separable Gaussian blur (ref ``gaussian_filter``, Filter.h:205-246)."""
    if y_sigma is None:
        y_sigma = x_sigma
    return separable_convolution_filter(src, generate_gaussian_kernel(x_sigma, x_dim),
                                        generate_gaussian_kernel(y_sigma, y_dim),
                                        edge=edge)


def derivative_filter(src, x_deriv: int, y_deriv: int, x_size: int = 0,
                      y_size: int = 0, edge: str = "constant"):
    """Separable derivative filter (ref ``derivative_filter``,
    Filter.h:252-290); a positive x derivative points toward increasing
    column index."""
    return separable_convolution_filter(src, generate_derivative_kernel(x_deriv, x_size),
                                        generate_derivative_kernel(y_deriv, y_size),
                                        edge=edge)


def laplacian_filter(src, edge: str = "constant"):
    """3x3 discrete Laplacian (ref ``laplacian_filter``, Filter.h:320-335);
    all nine taps, the zeros too, are multiplied and added, as in the JAX
    package."""
    kernel = np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]], np.float64)
    return convolution_filter(src, kernel, 1, 1, edge=edge)


def sobel_filter(src, do_x_deriv: bool, edge: str = "constant"):
    """3x3 Sobel derivative (ref ``sobel_filter``, Filter.h:338-360)."""
    if do_x_deriv:
        kernel = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float64)
    else:
        kernel = np.array([[-1, -2, -1], [0, 0, 0], [1, 2, 1]], np.float64)
    return convolution_filter(src, kernel, 1, 1, edge=edge)


def gaussian_derivative_filter(src, sigma1: float, deriv1: int, sigma2: float,
                               deriv2: int, angle: float, size: int,
                               edge: str = "constant"):
    """Oriented Gaussian-derivative filter: true 2D convolution with the
    kernel of :func:`generate_gaussian_derivative_kernel`."""
    kernel = generate_gaussian_derivative_kernel(sigma1, deriv1, sigma2, deriv2, angle, size)
    return convolution_filter(src, kernel, edge=edge)


def laplacian_of_gaussian_filter(src, sigma: float, size: int = 0, edge: str = "constant"):
    """Laplacian-of-Gaussian filter: true 2D convolution with the kernel of
    :func:`generate_laplacian_of_gaussian_kernel`; ``size`` 0 takes the
    Gaussian's default size."""
    if size == 0:
        size = compute_kernel_size(sigma)
    kernel = generate_laplacian_of_gaussian_kernel(sigma, size)
    return convolution_filter(src, kernel, edge=edge)
