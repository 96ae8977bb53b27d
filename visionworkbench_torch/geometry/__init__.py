"""Geometry of the port (``src/vw/Geometry/``): polygons, spatial trees and
frame trees, host NumPy copies of the JAX package's modules, with the names
of ``visionworkbench_tpu/geometry/__init__.py``."""

from visionworkbench_torch.geometry.polygon import (  # noqa: F401
    Polygon, read_poly_file, write_poly_file,
)
from visionworkbench_torch.geometry.spatial_tree import SpatialTree  # noqa: F401
from visionworkbench_torch.geometry.frame_tree import (  # noqa: F401
    ATrans, FrameStore, FrameTreeNode,
)
