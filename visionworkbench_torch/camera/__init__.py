"""Camera models of the port (``src/vw/Camera/``): the pinhole with its
lens distortions and TSAI files, the CAHV family, the adjusted model,
epipolar rectification, camera matrix fitting, the camera-to-camera warps,
the optical-bar (panoramic) model, the generic iterative solve, linescan
utilities, Bayer demosaicing and the EXIF reader. The names of
``visionworkbench_tpu/camera/__init__.py``, and ``RPCLensDistortion``."""

from visionworkbench_torch.camera.model import AdjustedCameraModel, CameraModel  # noqa: F401
from visionworkbench_torch.camera.distortion import (  # noqa: F401
    BrownConradyDistortion, DISTORTION_TYPES, FisheyeDistortion, FovDistortion,
    NullLensDistortion, PhotometrixDistortion, RPCLensDistortion,
    TsaiLensDistortion,
)
from visionworkbench_torch.camera.pinhole import (  # noqa: F401
    PinholeModel, read_pinhole_model, write_pinhole_model,
)
from visionworkbench_torch.camera.cahv import (  # noqa: F401
    CAHVModel, CAHVOREModel, CAHVORModel, linearize_camera, pinhole_to_cahv,
    read_cahv_model, write_cahv_model,
)
from visionworkbench_torch.camera.transform import (  # noqa: F401
    camera_transform, camera_transform_map, undistort_image, undistorted_camera,
)
from visionworkbench_torch.camera.epipolar import epipolar_rectify  # noqa: F401
from visionworkbench_torch.camera.geometry import (  # noqa: F401
    camera_from_points, decompose_camera_matrix, fit_camera_matrix,
)
from visionworkbench_torch.camera.exif import ExifView  # noqa: F401
from visionworkbench_torch.camera.bayer import bayer_demosaic  # noqa: F401
from visionworkbench_torch.camera.optical_bar import OpticalBarModel  # noqa: F401
from visionworkbench_torch.camera.solve import solve_point_to_pixel  # noqa: F401
from visionworkbench_torch.camera.linescan import (  # noqa: F401
    LinearTimeInterpolation, LinescanErr, TLCTimeInterpolation,
    apply_atmospheric_refraction_correction,
    apply_velocity_aberration_correction, linescan_point_to_pixel,
    saastamoinen_atmosphere_correction, transform_to_vector,
    vector_to_transform,
)
