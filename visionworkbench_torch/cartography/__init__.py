"""Cartography of the port (``src/vw/Cartography/``; PROJ/GDAL replaced by
in-tree torch projections and the GeoTIFF codec): datums, projections,
georeferences and reprojection; hillshade and colormap; camera footprints,
ray/DEM intersection, map <-> camera transforms and orthoprojection; point
images and DEMs; bathymetric (refracted) triangulation and camera fits to
ground points; shapefile IO and point chipping (host). The names of
``visionworkbench_tpu/cartography/__init__.py``."""

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
from visionworkbench_torch.cartography.hillshade import hillshade  # noqa: F401
from visionworkbench_torch.cartography.colormap import colormap  # noqa: F401
from visionworkbench_torch.cartography.camera_bbox import (  # noqa: F401
    camera_bbox, camera_pixel_to_datum_lonlat, camera_pixel_to_dem_xyz,
    intersect_datum,
)
from visionworkbench_torch.cartography.point_image import (  # noqa: F401
    cartesian_to_geodetic, dem_to_geodetic, dem_to_point_image,
    geodetic_to_cartesian, point_image_to_dem,
)
from visionworkbench_torch.cartography.map2cam import (  # noqa: F401
    Datum2CamTrans, Map2CamTrans, orthoproject,
)
from visionworkbench_torch.cartography.bathymetry import (  # noqa: F401
    BathyStereoModel, snell_refraction,
)
from visionworkbench_torch.cartography.shapefile import (  # noqa: F401
    read_shapefile, write_shapefile,
)
from visionworkbench_torch.cartography.camera_fit import (  # noqa: F401
    fit_camera_to_datum, fit_optical_bar, fit_pinhole,
)
