"""DEM colorization CLI (port of ``visionworkbench_tpu/tools/colormap.py``;
ref ``src/vw/tools/colormap.cc``). The lookup and the optional hillshade
run on the card:

    python -m visionworkbench_torch.tools.colormap dem.tif --hillshade

Same arguments and printed lines as the JAX package's CLI.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="vw-colormap",
                                description="Color relief from a DEM")
    p.add_argument("input")
    p.add_argument("-o", "--output", default=None)
    p.add_argument("--min", dest="lo", type=float, default=None)
    p.add_argument("--max", dest="hi", type=float, default=None)
    p.add_argument("--colormap-style", default="binary-red-blue",
                   help="binary-red-blue / jet / black-body / viridis / "
                        "kindlmann / cubehelix / plasma / inferno / rainbow "
                        "/ turbo, or a colormap text file (intensity r g b "
                        "per line) — the reference's full set "
                        "(tools/colormap.cc:206-210)")
    p.add_argument("--nodata-value", type=float, default=None)
    p.add_argument("--shaded-relief-file", "-s", default=None)
    p.add_argument("--moon", action="store_true",
                   help="set min/max to [-8499, 10208] m (lunar elevations)")
    p.add_argument("--mars", action="store_true",
                   help="set min/max to [-8208, 21249] m (Mars elevations)")
    p.add_argument("--hillshade", action="store_true",
                   help="hillshade the DEM first and modulate the colors "
                        "(equivalent to --shaded-relief-file with a "
                        "freshly computed shade)")
    p.add_argument("-a", "--azimuth", type=float, default=300.0,
                   help="light azimuth for --hillshade (degrees)")
    p.add_argument("-e", "--elevation", type=float, default=20.0,
                   help="light elevation for --hillshade (degrees)")
    p.add_argument("--legend", action="store_true",
                   help="also write the colormap legend as legend.png")
    return p


def main(argv=None, device=None) -> int:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` when None); ``device``:
    ``None`` = the card, ``"cpu"`` the plain PyTorch path."""
    args = build_parser().parse_args(argv)
    import torch
    from visionworkbench_torch.cartography import colormap
    from visionworkbench_torch.core.device import resolve_device
    from visionworkbench_torch.fileio import read_image, read_tiff, write_image

    dev = resolve_device(device)
    dem, info = read_tiff(args.input) if args.input.lower().endswith(
        (".tif", ".tiff")) else (read_image(args.input, np.float32), None)
    nodata = args.nodata_value
    if nodata is None and info is not None:
        nodata = info.nodata
    lo, hi = args.lo, args.hi
    if args.moon:
        lo, hi = -8499.0, 10208.0     # tools/colormap.cc --moon
    if args.mars:
        lo, hi = -8208.0, 21249.0     # tools/colormap.cc --mars
    dem = torch.as_tensor(np.asarray(dem, np.float32), device=dev)
    shade = None
    if args.shaded_relief_file:
        shade = read_image(args.shaded_relief_file, np.float32)
        if shade.ndim == 3:
            shade = shade.mean(axis=2)
        shade = torch.as_tensor(shade, device=dev)
    elif args.hillshade:
        from visionworkbench_torch.cartography import hillshade as _hs
        shade = _hs(dem, args.azimuth, args.elevation)
    rgb = colormap(dem, lo, hi, args.colormap_style, nodata, shade)
    out_path = args.output or (args.input.rsplit(".", 1)[0] + "_CMAP.png")
    write_image(out_path, rgb.cpu().numpy())
    print(f"Wrote {out_path}")
    if args.legend:
        # vertical ramp rendered through the same LUT (colormap.cc:187-198)
        ramp = np.linspace(1.0, 0.0, 256, dtype=np.float32)[:, None]
        ramp = np.repeat(ramp, 32, axis=1)
        leg = colormap(ramp, 0.0, 1.0, args.colormap_style, device=dev)
        write_image("legend.png", leg.cpu().numpy())
        print("Wrote legend.png")
    return 0


if __name__ == "__main__":
    sys.exit(main())
