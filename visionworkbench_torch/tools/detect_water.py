"""Water detection CLI (port of ``visionworkbench_tpu/tools/detect_water.py``;
ref ``src/vw/tools/detect_water.cc``). The per-pixel work runs on the card:

    python -m visionworkbench_torch.tools.detect_water scene_B2.TIF ... scene_MTL.txt --mode landsat
    python -m visionworkbench_torch.tools.detect_water grd.tif --mode sentinel1 -o water.tif

Modes (detect_water.cc:100-116; ``spot`` is a hidden mode there too):

* ``landsat`` -- with an MTL ``.txt`` metadata file among the inputs and
  per-band ``_B<n>.TIF`` files, runs the full TOA + cloud + water-score
  pipeline (``landsat.h``); with a single multiband image, falls back to
  NDWI thresholding.
* ``worldview`` -- with a ``.IMD`` metadata file, runs the TOA +
  NDVI/NDWI2 rule (``multispectral.h``); falls back to NDWI thresholding.
* ``spot`` -- ad-hoc SPOT 6/7 NDVI/NDWI rule on raw DNs.
* ``sentinel1`` -- full Martinis SAR algorithm (``radar.h``): tile
  statistics, Kittler-Illingworth global threshold, fuzzy refinement
  (optionally DEM-aided), hysteresis fill. ``--threshold`` bypasses the
  automatic threshold.
* ``modis`` -- MODIS product classifiers (``modis_water_detection.h``),
  selected with ``--modis-method``.

Output: uint8 GeoTIFF with water=255, land=1, nodata=0 (flood_common.h).
Same arguments, printed lines and output files as the JAX package's CLI.
The NDWI fallback computes in float64, as the JAX package's NumPy does.

The Martinis mode runs at 10 m a pixel, whatever the georeference says:
the JAX package asks ``georef.meters_per_pixel()`` inside a ``try`` that
swallows the ``AttributeError`` (neither package's ``GeoReference`` has the
method), so its minimum and maximum blob sizes always follow from 10 m. The
port follows it (``ROADMAP.md`` section 3); Sentinel-1 GRD is on a 10 m
grid.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from visionworkbench_torch.core.device import on_device
from visionworkbench_torch.image.window_ops import median_filter
from visionworkbench_torch.math.statistics import gaussian_clustering
from .flood.common import FLOOD_DETECT_WATER, as_image, as_plane, water_classes

# Default band indices (0-based) for the NDWI fallback paths.
LANDSAT8 = {"green": 2, "nir": 4}
WORLDVIEW = {"green": 2, "nir": 6}

# Ground sampling of the Martinis mode (see the module docstring).
SAR_METERS_PER_PIXEL = 10.0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="vw-detect-water",
                                description="Classify water pixels")
    p.add_argument("inputs", nargs="+",
                   help="Input image(s); for landsat mode pass the per-band "
                        "_B<n>.TIF files plus the MTL .txt metadata file, "
                        "for worldview the image plus the .IMD file")
    p.add_argument("-o", "--output", default=None)
    p.add_argument("--mode", "-m",
                   choices=["landsat", "worldview", "spot", "sentinel1",
                            "modis"],
                   default="landsat")
    p.add_argument("--sensitivity", type=float, default=1.0,
                   help="Water detection sensitivity multiplier "
                        "(detect_water.cc:55)")
    p.add_argument("--dem-path", "-d", default=None,
                   help="DEM file used by sentinel1 mode "
                        "(detect_water.cc:50)")
    p.add_argument("--tile-size", type=int, default=512,
                   help="Tile size for sentinel1 threshold statistics "
                        "(detect_water.cc:53)")
    p.add_argument("--threshold", type=float, default=None,
                   help="NDWI threshold (spectral fallback; default 0.0), "
                        "backscatter threshold override (sentinel1), or "
                        "MODIS method threshold")
    p.add_argument("--modis-method", default="evi",
                   choices=["evi", "xiao", "diff", "dartmouth", "mod_ndwi",
                            "fai"])
    p.add_argument("--green-band", type=int, default=None)
    p.add_argument("--nir-band", type=int, default=None)
    p.add_argument("--min-blob-area", type=int, default=8,
                   help="Small-blob cleanup for the fallback paths")
    p.add_argument("--nodata-value", type=float, default=None)
    p.add_argument("--debug", action="store_true")
    return p


def detect_water_spectral(image, green: int, nir: int, threshold: float = 0.0,
                          device=None):
    """NDWI = (G - NIR) / (G + NIR) > threshold (simple fallback), in
    float64 on the image's device (an array goes to ``device``, ``None`` =
    the card). Returns (water, ndwi)."""
    x = as_plane(image, device)
    g = x[..., green].double()
    n = x[..., nir].double()
    ndwi = (g - n) / torch.clamp(g + n, min=1e-9)
    return ndwi > threshold, ndwi


def detect_water_sar(backscatter, threshold=None, device=None):
    """Low-backscatter classification with an automatic bimodal split
    (simple fallback when a fixed --threshold is given). The median runs on
    the device; the bimodal split (only when ``threshold`` is None) is host
    NumPy on the smoothed plane, and the plane is then compared in float64
    with the split, as NumPy compares fp32 with a float64 number."""
    smooth = median_filter(on_device(backscatter, device, torch.float32), 3)
    if threshold is not None:
        return smooth < threshold, float(threshold)
    host = smooth.cpu().numpy()
    clusters = gaussian_clustering(host[np.isfinite(host)], 2)
    (w0, m0, v0), (w1, m1, v1) = clusters
    s0, s1 = np.sqrt(v0), np.sqrt(v1)
    threshold = (m0 * s1 + m1 * s0) / (s0 + s1)
    return smooth.double() < threshold, float(threshold)


def main(argv=None, device=None) -> int:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` when None); ``device``:
    ``None`` = the card, ``"cpu"`` the plain PyTorch path."""
    args = build_parser().parse_args(argv)
    from visionworkbench_torch.cartography import georeference_from_tiff_info
    from visionworkbench_torch.cartography.geotransform import reproject_image
    from visionworkbench_torch.fileio import read_tiff, write_tiff
    from visionworkbench_torch.image.morphology import remove_small_blobs
    from .flood import landsat as fl_landsat
    from .flood import modis as fl_modis
    from .flood import multispectral as fl_ms
    from .flood import radar as fl_radar

    inputs = args.inputs
    classes = None
    info = None

    if args.mode == "landsat" and any(f.endswith(".txt") for f in inputs):
        # Full Landsat pipeline (landsat.h).
        stack, valid, info = fl_landsat.load_landsat_image(inputs)
        metadata = fl_landsat.load_landsat_metadata(inputs)
        thresh = fl_landsat.compute_water_threshold(
            metadata.sun_elevation_degrees)
        print(f"water threshold = {thresh * args.sensitivity}")
        classes = fl_landsat.detect_water(stack, metadata, valid, args.sensitivity,
                                          device=device)
    elif args.mode == "worldview" and any(".IMD" in f for f in inputs):
        image_path = next(f for f in inputs
                          if f.endswith((".tif", ".TIF", ".tiff")))
        arr, info = read_tiff(image_path)
        metadata = fl_ms.load_worldview23_metadata(inputs)
        x = as_plane(arr, device)
        classes = fl_ms.detect_water_worldview23(x, metadata, (x != 0).any(-1),
                                                 args.sensitivity)
    elif args.mode == "spot":
        arr, info = read_tiff(inputs[0])
        x = as_plane(arr, device)
        classes = fl_ms.detect_water_spot67(x, (x != 0).any(-1), args.sensitivity)
    elif args.mode == "modis":
        arr, info = read_tiff(inputs[0])
        if arr.ndim != 3 or arr.shape[2] < fl_modis.NUM_MODIS_BANDS:
            print("error: modis mode needs a 7-band image", file=sys.stderr)
            return 1
        x = as_plane(arr, device)
        water = fl_modis.detect_water(x, args.modis_method, args.threshold)
        classes = water_classes(water, (x != 0).any(-1))
    elif args.mode == "sentinel1" and args.threshold is None:
        # Full Martinis pipeline (radar.h).
        arr, info = read_tiff(inputs[0])
        band = arr if np.asarray(arr).ndim == 2 else np.asarray(arr)[..., 0]
        nodata = (args.nodata_value if args.nodata_value is not None
                  else info.nodata)
        x = as_plane(band, device)
        valid = x > 0 if nodata is None else (x != nodata) & (x > 0)
        dem = None
        if args.dem_path:
            dem_arr, dem_info = read_tiff(args.dem_path)
            dem = (np.asarray(dem_arr)[..., 0]
                   if np.asarray(dem_arr).ndim == 3 else np.asarray(dem_arr))
            dem = as_image(dem, x.device)
            if dem.shape != band.shape:
                dem = reproject_image(
                    dem, georeference_from_tiff_info(dem_info),
                    georeference_from_tiff_info(info), (band.shape[0], band.shape[1]))
        result = fl_radar.sar_martinis(x, valid, meters_per_pixel=SAR_METERS_PER_PIXEL,
                                       dem=dem, tile_size=args.tile_size,
                                       sensitivity=args.sensitivity,
                                       debug=args.debug)
        print(f"sentinel1 global threshold: {result.threshold:.4f} "
              f"(preprocessed units)")
        classes = result.classes
    else:
        # Fallback simple paths (single multiband NDWI / fixed SAR
        # threshold), kept for small inputs without metadata files.
        arr, info = read_tiff(inputs[0])
        nodata = (args.nodata_value if args.nodata_value is not None
                  else info.nodata)
        if args.mode in ("landsat", "worldview"):
            bands = LANDSAT8 if args.mode == "landsat" else WORLDVIEW
            green = (args.green_band if args.green_band is not None
                     else bands["green"])
            nir = args.nir_band if args.nir_band is not None else bands["nir"]
            if arr.ndim != 3 or arr.shape[2] <= max(green, nir):
                print(f"error: {args.mode} mode needs a multiband image with "
                      f"bands {green} and {nir}", file=sys.stderr)
                return 1
            x = as_plane(arr, device)
            thr = 0.0 if args.threshold is None else args.threshold
            water, _ = detect_water_spectral(x, green, nir, thr)
            valid = None
            if nodata is not None:
                valid = x[..., green] != nodata
                water &= valid
        else:
            x = as_plane(arr if np.asarray(arr).ndim == 2 else np.asarray(arr)[..., 0],
                         device)
            water, thr = detect_water_sar(x, args.threshold)
            print(f"sentinel1 backscatter threshold: {thr:.4f}")
            valid = None
            if nodata is not None:
                valid = x != nodata
                water &= valid
        if args.min_blob_area > 1:
            water = remove_small_blobs(water, args.min_blob_area)
        classes = water_classes(water, valid)

    georef = georeference_from_tiff_info(info) if info is not None else None
    out_path = args.output or (inputs[0].rsplit(".", 1)[0] + "_water.tif")
    write_tiff(out_path, classes.cpu().numpy(), georef=georef)
    frac = int((classes == FLOOD_DETECT_WATER).sum()) / classes.numel()
    print(f"Wrote {out_path}: {100.0 * frac:.2f}% water")
    return 0


if __name__ == "__main__":
    sys.exit(main())
