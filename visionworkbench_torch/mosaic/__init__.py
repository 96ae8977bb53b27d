"""Mosaicking of the port (``src/vw/Mosaic/``): compositing, the
cartographic reprojection mosaic, quadtree tiles and on-disk pyramids."""

from visionworkbench_torch.mosaic.composite import (  # noqa: F401
    ImageComposite, blend_levels_for, collapse_pyramid, feather_blend,
    gaussian_pyramid, laplacian_pyramid, multiband_blend,
)
from visionworkbench_torch.mosaic.quadtree import (  # noqa: F401
    QuadTreeGenerator, default_image_path, write_kml_superoverlay,
)
from visionworkbench_torch.mosaic.geomosaic import (  # noqa: F401
    ReprojectPlan, plan_reproject_grids, reproject_mosaic,
)
from visionworkbench_torch.mosaic.pyramid import DiskImagePyramid  # noqa: F401
