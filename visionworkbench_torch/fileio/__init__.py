"""Storage of the port (``src/vw/FileIO/``): the in-tree TIFF/GeoTIFF and
OpenEXR codecs, PIL-backed formats, raw and PDS files (copies of the JAX
package's NumPy modules), the lazy tile-cached readers and the
multi-threaded ordered tile writer. The same names as
``visionworkbench_tpu/fileio/__init__.py``."""

from visionworkbench_torch.fileio.exr import read_exr, write_exr  # noqa: F401
from visionworkbench_torch.fileio.image_io import (  # noqa: F401
    image_size, read_image, write_image,
)
from visionworkbench_torch.fileio.tiff import (  # noqa: F401
    TiffInfo, TiffTileWriter, read_tiff, read_tiff_region, write_tiff,
)
from visionworkbench_torch.fileio.disk_image import (  # noqa: F401
    DiskCacheImageView, DiskImageView,
)
from visionworkbench_torch.fileio.tiled_writer import block_write_image  # noqa: F401
from visionworkbench_torch.fileio.memory import (  # noqa: F401
    decode_image, encode_image, parse_pds_label, read_pds, write_pds,
)
from visionworkbench_torch.fileio.raw import (  # noqa: F401
    RawFormat, RawImageResource, open_spot5, read_raw, write_raw,
)
