"""Cartography of the port (``src/vw/Cartography/``; PROJ/GDAL replaced by
in-tree torch projections and the GeoTIFF codec): the modules the
reprojection mosaic needs. The JAX package's hillshade, colormap, camera
and point-image modules are not ported yet."""

from visionworkbench_torch.cartography.datum import Datum, well_known_datum  # noqa: F401
from visionworkbench_torch.cartography.projection import (  # noqa: F401
    EquirectangularProjection, GnomonicProjection,
    LambertAzimuthalProjection, LambertConformalProjection, MercatorProjection,
    OrthographicProjection, PROJECTIONS, Projection, SinusoidalProjection,
    StereographicProjection, TransverseMercatorProjection, UTMProjection,
)
from visionworkbench_torch.cartography.georeference import (  # noqa: F401
    GeoReference, PIXEL_AS_AREA, PIXEL_AS_POINT, georeference_from_pds_label,
    georeference_from_tiff_info, make_geographic_georef,
)
from visionworkbench_torch.cartography.geotransform import (  # noqa: F401
    GeoTransform, reproject_image,
)
