"""Stereo correlation of the port: the pyramid correlator (block matching
with the five costs, and SGM/MGM), the single-level search
(``best_of_search_convolution``, ``calc_disparity``), ``parabola_subpixel``,
the iterative refiners (``lk_subpixel``, ``affine_subpixel``,
``bayes_em_subpixel``, ``phase_subpixel``), ``corr_eval`` and
``calc_disparity_sgm``."""

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
