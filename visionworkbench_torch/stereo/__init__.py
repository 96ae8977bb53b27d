"""Stereo correlation of the port: the pyramid correlator (block matching
with the five costs, and SGM/MGM), the single-level search
(``best_of_search_convolution``, ``calc_disparity``), ``parabola_subpixel``,
the iterative refiners (``lk_subpixel``, ``affine_subpixel``,
``bayes_em_subpixel``, ``phase_subpixel``), ``corr_eval``,
``calc_disparity_sgm``, the prefilters, the disparity-map tools and
triangulation: the names of ``visionworkbench_tpu/stereo/__init__.py``."""

from visionworkbench_torch.stereo.prefilter import (  # noqa: F401
    PREFILTER_LOG, PREFILTER_MEANSUB, PREFILTER_MODES, PREFILTER_NONE,
    prefilter_image,
)

from visionworkbench_torch.stereo.correlation import (  # noqa: F401
    ABSOLUTE_DIFFERENCE, CENSUS_TRANSFORM, COST_TYPES, CROSS_CORRELATION,
    DisparityMap, SQUARED_DIFFERENCE, TERNARY_CENSUS_TRANSFORM,
    best_of_search_convolution, calc_disparity,
)
from visionworkbench_torch.stereo.correval import corr_eval  # noqa: F401
from visionworkbench_torch.stereo.sgm import calc_disparity_sgm  # noqa: F401
from visionworkbench_torch.stereo.subpixel import parabola_subpixel  # noqa: F401
from visionworkbench_torch.stereo.subpixel_refine import (  # noqa: F401
    affine_subpixel, bayes_em_subpixel, lk_subpixel, phase_subpixel,
)
from visionworkbench_torch.stereo.disparity import (  # noqa: F401
    cross_corr_consistency_check, disparity_cleanup_using_thresh, disparity_mask,
    disparity_subsample, disparity_upsample, get_disparity_range,
    rm_outliers_using_thresh, std_dev_image, transform_disparities,
)
from visionworkbench_torch.stereo.stereo_model import (  # noqa: F401
    StereoModel, triangulate_pair, triangulate_point_multiview,
)

_LAZY = ("max_pyramid_levels_for", "pyramid_correlate")


def __getattr__(name):
    """``pyramid_correlate`` and ``max_pyramid_levels_for``, imported at
    first use: ``pyramid_correlation`` imports ``ops.sweep``, which imports
    this package's ``correlation``."""
    if name in _LAZY:
        from visionworkbench_torch.stereo import pyramid_correlation
        return getattr(pyramid_correlation, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
