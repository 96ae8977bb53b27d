"""Storage of the port: the in-tree TIFF/GeoTIFF and OpenEXR codecs and the
PIL-backed whole-image read/write (copies of the JAX package's NumPy
modules)."""

from visionworkbench_torch.fileio.exr import read_exr, write_exr  # noqa: F401
from visionworkbench_torch.fileio.image_io import (  # noqa: F401
    image_size, read_image, write_image,
)
from visionworkbench_torch.fileio.tiff import (  # noqa: F401
    TiffInfo, TiffTileWriter, read_tiff, read_tiff_region, write_tiff,
)
