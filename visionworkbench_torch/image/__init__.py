"""The image substrate of the port (``visionworkbench_tpu/image/``; ref
``src/vw/Image/``): plain functions over tensors, each working on its
input tensor's device, with the JAX package's exports."""

from visionworkbench_torch.image.types import (  # noqa: F401
    MaskedImage, all_valid, as_float32, create_mask,
)
from visionworkbench_torch.image.edge import (  # noqa: F401
    EDGE_MODES, crop_to_interior, edge_extend,
)
from visionworkbench_torch.image.interpolation import (  # noqa: F401
    interpolate, interpolate_image, pixel_buffer,
)
from visionworkbench_torch.image.convolution import (  # noqa: F401
    convolution_filter, correlate_2d, separable_convolution_filter,
)
from visionworkbench_torch.image.filters import (  # noqa: F401
    compute_kernel_size, derivative_filter, gaussian_derivative_filter,
    gaussian_filter, generate_derivative_kernel, generate_gaussian_kernel,
    generate_gaussian_derivative_kernel, generate_laplacian_of_gaussian_kernel,
    generate_pyramid_smoothing_kernel, laplacian_filter,
    laplacian_of_gaussian_filter, sobel_filter,
)
from visionworkbench_torch.image.manipulation import (  # noqa: F401
    channels_to_planes, crop, flip_horizontal, flip_vertical, planes_to_channels,
    rotate_90_ccw, rotate_90_cw, rotate_180, select_channel, select_plane,
    subsample, transpose, upsample,
)
from visionworkbench_torch.image.algorithms import (  # noqa: F401
    clamp, fill, is_opaque, is_transparent, nonzero_data_bounding_box,
    normalize, threshold,
)
from visionworkbench_torch.image.statistics import (  # noqa: F401
    cdf_quantile, histogram, masked_max, masked_mean, masked_min, masked_stddev,
    max_pixel_value, mean_pixel_value, min_max_pixel_values, min_pixel_value,
    stddev_pixel_value, sum_of_pixel_values,
)
from visionworkbench_torch.image.masks import (  # noqa: F401
    apply_mask, copy_mask, edge_mask, intersect_masks, invert_mask,
    masked_binary, masked_unary, union_masks,
)

