"""DEM hillshade CLI (port of ``visionworkbench_tpu/tools/hillshade.py``;
ref ``src/vw/tools/hillshade.cc``). The blur and the shading run on the
card:

    python -m visionworkbench_torch.tools.hillshade dem.tif -o shade.tif

Same arguments and printed lines as the JAX package's CLI.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="vw-hillshade",
                                description="Shaded relief from a DEM")
    p.add_argument("input")
    p.add_argument("-o", "--output", default=None)
    p.add_argument("-a", "--azimuth", type=float, default=300.0)
    p.add_argument("-e", "--elevation", type=float, default=20.0)
    p.add_argument("-s", "--scale", type=float, default=0.0,
                   help="ground units per pixel (0 = infer from georef)")
    p.add_argument("--nodata-value", type=float, default=None)
    p.add_argument("--blur", type=float, default=None,
                   help="pre-blur the DEM with this Gaussian sigma "
                        "(ref hillshade.cc --blur)")
    p.add_argument("--align-to-georef", action="store_true",
                   help="azimuth relative to East (georef axes) instead of "
                        "+x in the image (ref hillshade.cc)")
    return p


def main(argv=None, device=None) -> int:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` when None); ``device``:
    ``None`` = the card, ``"cpu"`` the plain PyTorch path."""
    args = build_parser().parse_args(argv)
    import torch
    from visionworkbench_torch.cartography import (
        georeference_from_tiff_info, hillshade,
    )
    from visionworkbench_torch.core.device import resolve_device
    from visionworkbench_torch.fileio import read_tiff, write_image
    from visionworkbench_torch.image.types import MaskedImage

    dem, info = read_tiff(args.input)
    nodata = args.nodata_value if args.nodata_value is not None else info.nodata
    scale = args.scale
    georef = georeference_from_tiff_info(info)
    if scale <= 0:
        if georef is not None:
            # degrees -> meters approximation at the equatorial radius
            sx = abs(georef.transform[0, 0])
            scale = sx * (111320.0 if type(georef.projection).__name__ ==
                          "Projection" else 1.0)
        else:
            scale = 1.0
    dem = torch.as_tensor(np.asarray(dem, np.float32), device=resolve_device(device))
    if args.blur and args.blur > 0:
        from visionworkbench_torch.image.filters import gaussian_filter
        dem = gaussian_filter(dem, args.blur)
    azimuth = args.azimuth
    if args.align_to_georef and georef is not None:
        # image +x vs East: a north-up georef has x = East already; a
        # rotated transform needs the rotation folded into the azimuth.
        import math as _m
        t = georef.transform
        azimuth = azimuth - _m.degrees(_m.atan2(-t[1, 0], t[0, 0]))
    out = hillshade(dem, azimuth, args.elevation, scale, nodata)
    if isinstance(out, MaskedImage):
        out = out.filled(0.0)
    data = out.cpu().numpy()
    out_path = args.output or (args.input.rsplit(".", 1)[0] + "_HILLSHADE.tif")
    if out_path.lower().endswith((".tif", ".tiff")):
        from visionworkbench_torch.fileio import write_tiff
        write_tiff(out_path, data.astype(np.float32), georef=georef)
    else:
        write_image(out_path, data)
    print(f"Wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
