"""Numerics of the port (``src/vw/Math/``): boxes, 2D transforms and their
fits, RANSAC, nonlinear optimization and quaternions, with the names of
``visionworkbench_tpu/math/__init__.py``. ``misc``, ``statistics`` and
``nearest`` are imported by module."""

from visionworkbench_torch.math.bbox import (  # noqa: F401
    BBox2, BBox2i, bounding_box, grow_bbox_to_int, subdivide_bbox,
)
from visionworkbench_torch.math.transform2d import (  # noqa: F401
    AffineTransform, HomographyTransform, LinearTransform, ResampleTransform,
    RotateTransform, SimilarityTransform, Transform2D, TranslateTransform,
    compose, identity_transform,
)
from visionworkbench_torch.math.geometry_fit import (  # noqa: F401
    fit_affine, fit_homography, fit_similarity, fit_translation,
    fit_translation_rotation,
)
from visionworkbench_torch.math.ransac import ransac  # noqa: F401
from visionworkbench_torch.math.optimization import (  # noqa: F401
    LMResult, conjugate_gradient, levenberg_marquardt, nelder_mead, newton_raphson,
)
from visionworkbench_torch.math.quaternion import (  # noqa: F401
    axis_angle_to_quat, euler_to_quat, euler_to_rotation_matrix, matrix_to_quat,
    quat_conj, quat_mul, quat_normalize, quat_rotate, quat_to_axis_angle,
    quat_to_matrix, slerp,
)
