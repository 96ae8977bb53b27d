"""Distributed execution on ``torch.distributed``: device meshes, tile
sharding with halo exchange, disparity-axis cost-volume sharding and the
fully sharded hierarchical correlator, one process (rank) per card: the
replacement for the reference's thread-pool tile engine
(``src/vw/Image/BlockProcessor.h``, SURVEY.md section 2.14). The caller
initializes the process group (``mesh.py``)."""

from visionworkbench_torch.parallel.mesh import (  # noqa: F401
    DISP_AXIS, TILE_AXIS, make_disp_mesh, make_tile_disp_mesh, make_tile_mesh,
    row_sharding,
)
from visionworkbench_torch.parallel.tile_sharding import (  # noqa: F401
    halo_exchange_rows, map_overlap, sharded_pyramid_correlate,
)
from visionworkbench_torch.parallel.disparity_sharding import (  # noqa: F401
    disparity_sharded_search,
)
from visionworkbench_torch.parallel.hierarchical import (  # noqa: F401
    hierarchical_sharded_correlate,
)
