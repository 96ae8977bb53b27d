"""Interest points of the port (``visionworkbench_tpu/interest/``; ref
``src/vw/InterestPoint/``): single-scale and scaled Harris/LoG detection,
orientations, patch/sgrad/PCA descriptors, ratio-test matching and the
``.vwip`` / ``.match`` files, and the SIFT-class path (DoG and OBALoG
detection, scale-aware orientations, oriented descriptors)."""

from visionworkbench_torch.interest.types import (  # noqa: F401
    ImageOctaveHistory, InterestPoints, from_numpy,
)
from visionworkbench_torch.interest.operators import (  # noqa: F401
    harris_interest, image_gradients, log_interest,
)
from visionworkbench_torch.interest.detector import (  # noqa: F401
    assign_orientations, assign_orientations_scaled, concatenate_points,
    detect_points, detect_points_dog, detect_points_obalog, detect_points_scaled,
    detect_sift_like,
)
from visionworkbench_torch.interest.descriptor import (  # noqa: F401
    PCABasis, describe, fit_pca_basis, patch_descriptor, pca_descriptor,
    sgrad_descriptor,
)
from visionworkbench_torch.interest.matcher import (  # noqa: F401
    Matches, match_points, matched_coordinates,
)
from visionworkbench_torch.interest.io import (  # noqa: F401
    match_filename, read_binary_ip_file, read_binary_match_file,
    read_text_match_file, write_binary_ip_file, write_binary_match_file,
    write_text_match_file,
)
