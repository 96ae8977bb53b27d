"""End-to-end Sentinel-1 flood detection driver (port of
``visionworkbench_tpu/tools/sentinel1_flood_detect.py``; ref
``src/vw/tools/sentinel1_flood_detect.py``).

The reference is a Python-2 script that shells out to ``clean_sentinel1_borders``,
``listgeo``/``geotifcp``, ``gdalwarp`` and ``detect_water``. Here the whole
chain runs in-process, its image work on the card:

    python -m visionworkbench_torch.tools.sentinel1_flood_detect grd.tif out/flood.tif

1. border junk removal (``clean_sentinel1_borders`` logic);
2. optional warp onto a north-up grid of the same extent (the reference's
   ``gdalwarp`` step reprojects ground-range imagery; pass ``--skip-warp``
   when the input is already orthorectified), bicubic on the card;
3. the full Martinis water detection (``detect_water --mode sentinel1``).

Intermediates are written next to the output like the reference
(``<out>_clean.tif``, ``<out>_WARP.tif``) and reused when present. Same
arguments, printed lines and output files as the JAX package's CLI.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vw-sentinel1-flood-detect",
        description="Clean, warp, and run water detection on a Sentinel-1 "
                    "GRD image")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--sensitivity", type=float, default=1.0,
                   help="Decrease to detect more water, increase to detect "
                        "less (sentinel1_flood_detect.py:41)")
    p.add_argument("--dem-path", default=None,
                   help="Process with this DEM file "
                        "(sentinel1_flood_detect.py:49)")
    p.add_argument("--tile-size", type=int, default=512)
    p.add_argument("--border-threshold", type=float, default=0.02)
    p.add_argument("--skip-warp", action="store_true",
                   help="Input is already north-up/orthorectified")
    p.add_argument("--debug", action="store_true")
    return p


def warp_north_up(clean_path: str, ortho_path: str, device=None) -> str:
    """Warp ``clean_path`` onto a north-up grid of the same extent and
    resolution (bicubic, on ``device``; ``None`` = the card) and write it to
    ``ortho_path``. Returns the path detection should read: ``ortho_path``,
    or ``clean_path`` when the image has no georeference or is north up
    already."""
    import copy
    from visionworkbench_torch.cartography import georeference_from_tiff_info
    from visionworkbench_torch.cartography.geotransform import reproject_image
    from visionworkbench_torch.fileio import read_tiff, write_tiff
    from visionworkbench_torch.tools.flood.common import as_image
    arr, info = read_tiff(clean_path)
    georef = georeference_from_tiff_info(info)
    if georef is None:
        print("No georeference; skipping warp step")
        return clean_path
    t = georef.transform
    if t[0, 1] == 0.0 and t[1, 0] == 0.0:
        # Already north-up: the warp is a no-op (gdalwarp would
        # resample onto an identical grid).
        return clean_path
    band = arr if np.asarray(arr).ndim == 2 else np.asarray(arr)[..., 0]
    h, w = band.shape
    # Axis-aligned point-space bbox of the rotated footprint (fp32 corners,
    # as the JAX package's).
    cx = np.array([0.0, w, 0.0, w])
    cy = np.array([0.0, 0.0, h, h])
    px, py = (v.numpy() for v in georef.pixel_to_point(cx, cy))
    res = float(np.hypot(t[0, 0], t[1, 0]))
    ow = max(int(np.ceil((px.max() - px.min()) / np.float32(res))), 1)
    oh = max(int(np.ceil((py.max() - py.min()) / np.float32(res))), 1)
    north_up = copy.deepcopy(georef)
    north_up.set_transform(np.array(
        [[res, 0.0, float(px.min())],
         [0.0, -res, float(py.max())],
         [0.0, 0.0, 1.0]]))
    warped = reproject_image(as_image(band, device), georef, north_up, (oh, ow),
                             interp="bicubic")
    write_tiff(ortho_path, warped.cpu().numpy(), georef=north_up, nodata=info.nodata)
    return ortho_path


def main(argv=None, device=None) -> int:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` when None); ``device``:
    ``None`` = the card, ``"cpu"`` the plain PyTorch path."""
    args = build_parser().parse_args(argv)
    from visionworkbench_torch.tools import clean_sentinel1_borders, detect_water

    output_folder = os.path.dirname(args.output) or "."
    if not os.path.exists(output_folder):
        print(f"Creating output folder: {output_folder}")
        os.makedirs(output_folder)

    clean_path = args.output + "_clean.tif"
    ortho_path = args.output + "_WARP.tif"

    # Border cleanup (reused if present, like the reference's ortho skip).
    if not os.path.exists(clean_path):
        rc = clean_sentinel1_borders.main(
            [args.input, "-o", clean_path,
             "--border-threshold", str(args.border_threshold)], device=device)
        if rc != 0 or not os.path.exists(clean_path):
            print("Failed to clean image borders!", file=sys.stderr)
            return 1

    # Warp to a north-up grid (ref gdalwarp -r cubic). The clean step
    # preserves the georeference, so no listgeo/geotifcp dance is needed.
    src_path = clean_path
    if not args.skip_warp:
        if not os.path.exists(ortho_path):
            ortho_path = warp_north_up(clean_path, ortho_path, device)
        src_path = ortho_path

    # Water detection.
    dw_args = [src_path, "-o", args.output, "--mode", "sentinel1",
               "--sensitivity", str(args.sensitivity),
               "--tile-size", str(args.tile_size)]
    if args.dem_path:
        dw_args += ["--dem-path", args.dem_path]
    if args.debug:
        dw_args.append("--debug")
    rc = detect_water.main(dw_args, device=device)
    if rc != 0 or not os.path.exists(args.output):
        print("Failed during water detection step!", file=sys.stderr)
        return 1
    print(f"Finished generating output file: {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
