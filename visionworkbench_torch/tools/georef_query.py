"""Georeference queries on an image file (port of
``visionworkbench_tpu/tools/georef_query.py``; ref
``src/vw/tools/georef_query.cc``).

Reference surface: ``--print-bounds``, pixel queries (``--row --col``),
geodetic queries (``--lat --lon``), and ``--output-format`` 0=lat/lon,
1=projected, 2=pixels (georef_query.cc:44-200). With no query flags the
tool prints a full georeference info dump (a superset of the reference,
which errors out in that case). Same arguments and printed lines as the
JAX package's CLI:

    python -m visionworkbench_torch.tools.georef_query image.tif --row 0 --col 0

Every query is a few points of georeference math, which the port plans on
the host (``core/device.as_f32``); nothing of it runs on the card.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

OUTPUT_LAT_LON = 0
OUTPUT_PROJECTED = 1
OUTPUT_PIXELS = 2


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="vw-georef-query",
                                description="Georeference queries / info")
    p.add_argument("images", nargs="+")
    p.add_argument("--print-bounds", action="store_true",
                   help="print the image bounds in the output format")
    p.add_argument("--row", type=float, help="pixel row to query")
    p.add_argument("--col", type=float, help="pixel column to query")
    p.add_argument("--lat", type=float, help="latitude to query")
    p.add_argument("--lon", type=float, help="longitude to query")
    p.add_argument("--output-format", type=int, default=OUTPUT_LAT_LON,
                   choices=(0, 1, 2),
                   help="0 = lat/lon, 1 = projected, 2 = pixels")
    return p


def _to_output(g, px, py, fmt):
    """(pixel col, pixel row) -> output coords (x-like, y-like)."""
    if fmt == OUTPUT_PIXELS:
        return float(px), float(py)
    if fmt == OUTPUT_PROJECTED:
        x, y = g.pixel_to_point(px, py)
        return float(np.asarray(x)), float(np.asarray(y))
    lon, lat = g.pixel_to_lonlat(px, py)
    return float(np.asarray(lon)), float(np.asarray(lat))


def _labels(fmt):
    return {OUTPUT_LAT_LON: ("longitude", "latitude "),
            OUTPUT_PROJECTED: ("x", "y"),
            OUTPUT_PIXELS: ("col", "row")}[fmt]


def main(argv=None, device=None) -> int:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` when None). ``device`` is
    the tools' common argument; the queries are host math whatever it is."""
    args = build_parser().parse_args(argv)
    from visionworkbench_torch.cartography import georeference_from_tiff_info
    from visionworkbench_torch.fileio import TiffInfo
    from visionworkbench_torch.math.bbox import BBox2i

    fmt = args.output_format
    have_pixel_q = args.row is not None and args.col is not None
    have_geo_q = args.lat is not None and args.lon is not None
    any_query = args.print_bounds or have_pixel_q or have_geo_q

    for path in args.images:
        info = TiffInfo(path)
        g = georeference_from_tiff_info(info)
        if g is None:
            print(f"{path}: failed to read georeference")
            continue
        if any_query:
            xs, ys = _labels(fmt)
            if args.print_bounds:
                # boundary-sampled box in the requested output coordinates
                n = 32
                bx = np.concatenate([np.linspace(0, info.width, n)] * 2
                                    + [np.zeros(n), np.full(n, info.width)])
                by = np.concatenate([np.zeros(n), np.full(n, info.height)]
                                    + [np.linspace(0, info.height, n)] * 2)
                pts = [_to_output(g, x, y, fmt) for x, y in zip(bx, by)]
                axs = [p[0] for p in pts]
                ays = [p[1] for p in pts]
                print(f"Min {xs}: {min(axs)}")
                print(f"Max {xs}: {max(axs)}")
                print(f"Min {ys.strip()}: {min(ays)}")
                print(f"Max {ys.strip()}: {max(ays)}")
            if have_pixel_q:
                x, y = _to_output(g, args.col, args.row, fmt)
                print(f"{xs} = {x}")
                print(f"{ys.strip()} = {y}")
            if have_geo_q:
                px, py = g.lonlat_to_pixel(args.lon, args.lat)
                x, y = _to_output(g, float(np.asarray(px)),
                                  float(np.asarray(py)), fmt)
                print(f"{xs} = {x}")
                print(f"{ys.strip()} = {y}")
            continue
        # no query flags: info dump (superset of the reference)
        print(f"{path}: {info.width}x{info.height}, {info.bands} band(s), "
              f"{info.dtype}")
        if info.nodata is not None:
            print(f"  nodata: {info.nodata}")
        print(f"  projection: {g.projection.name}")
        print(f"  datum: {g.datum.name} (a={g.datum.a}, b={g.datum.b})")
        print(f"  transform: {g.transform[0].tolist()} {g.transform[1].tolist()}")
        print(f"  proj4: {g.proj4_str()}")
        box = g.pixel_to_lonlat_bbox(BBox2i(0, 0, info.width, info.height))
        print(f"  lonlat bbox: ({box.min_x:.6f}, {box.min_y:.6f}) -> "
              f"({box.max_x:.6f}, {box.max_y:.6f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
