"""Camera models of the port (``src/vw/Camera/``): the pinhole with its
lens distortions and TSAI files, the CAHV family, the adjusted model,
epipolar rectification, camera matrix fitting and the camera-to-camera
warps. ``exif``, ``bayer``, ``optical_bar``, ``linescan`` and ``solve`` of
the JAX package are not ported yet (``ROADMAP.md`` queue 1 item 6)."""

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
