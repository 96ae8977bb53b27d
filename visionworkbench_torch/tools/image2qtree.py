"""Georeferenced image(s) -> quadtree of tiles + KML (a port of
``visionworkbench_tpu/tools/image2qtree.py``; ref
``src/vw/tools/image2qtree.cc:367-718``; call stack SURVEY.md section 3.4):
reproject all inputs to a common geographic frame, composite (multiband or
draft), then render the quadtree with a KML super-overlay. The warps, the
blend and the tiles' downsampling run on the card:

    python -m visionworkbench_torch.tools.image2qtree a.tif b.tif -o out

Same arguments and printed lines as the JAX package's CLI.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vw-image2qtree",
        description="Build a KML/web quadtree from georeferenced images")
    p.add_argument("images", nargs="+")
    p.add_argument("-o", "--output-name", default=None)
    p.add_argument("-m", "--output-metadata", choices=["kml", "none"],
                   default="kml")
    p.add_argument("--tile-size", type=int, default=256)
    p.add_argument("--blend", choices=["multiband", "draft", "simple"],
                   default="draft")
    p.add_argument("--resolution", type=int, default=0,
                   help="output pixels across the union bbox (0 = native)")
    return p


def main(argv=None, device=None) -> int:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` when None); ``device``:
    ``None`` = the card, ``"cpu"`` the plain PyTorch path."""
    args = build_parser().parse_args(argv)
    import torch
    from visionworkbench_torch.cartography import (
        georeference_from_tiff_info, make_geographic_georef, reproject_image,
    )
    from visionworkbench_torch.core.device import resolve_device
    from visionworkbench_torch.fileio import read_tiff
    from visionworkbench_torch.math.bbox import BBox2, BBox2i
    from visionworkbench_torch.mosaic import (
        ImageComposite, QuadTreeGenerator, write_kml_superoverlay,
    )

    dev = resolve_device(device)
    sources = []
    union = BBox2.empty()
    for path in args.images:
        arr, info = read_tiff(path)
        georef = georeference_from_tiff_info(info)
        if georef is None:
            print(f"error: {path} has no georeference", file=sys.stderr)
            return 1
        ll = georef.pixel_to_lonlat_bbox(BBox2i(0, 0, arr.shape[1], arr.shape[0]))
        union.grow(ll)
        sources.append((arr, georef, ll))

    # Common geographic frame over the union bbox.
    if args.resolution > 0:
        deg_pp = union.width / args.resolution
    else:
        deg_pp = min(abs(s[1].transform[0, 0]) for s in sources)
    common = make_geographic_georef(union.min_x, union.max_y, deg_pp)

    comp = ImageComposite(args.blend, device=dev)
    for arr, georef, ll in sources:
        px_box = common.lonlat_to_pixel_bbox(ll).rounded()
        w = max(int(px_box.width), 1)
        h = max(int(px_box.height), 1)
        sub_georef = make_geographic_georef(
            union.min_x + px_box.min_x * deg_pp,
            union.max_y - px_box.min_y * deg_pp, deg_pp)
        src = torch.as_tensor(np.asarray(arr, np.float32), device=dev)
        warped = reproject_image(src, georef, sub_georef, (h, w)).cpu().numpy()
        mask = np.isfinite(warped)
        if warped.ndim == 3:
            mask = mask.all(axis=-1)
        mask &= (np.abs(warped if warped.ndim == 2 else
                        warped.mean(axis=-1)) > 0)
        comp.insert(warped, int(px_box.min_x), int(px_box.min_y), mask)

    data, valid = comp.generate()
    name = args.output_name or os.path.splitext(args.images[0])[0] + ".qtree"
    gen = QuadTreeGenerator(data, name, tile_size=args.tile_size, device=dev)
    tiles = gen.generate()
    print(f"Wrote {len(tiles)} tiles under {name}/")
    if args.output_metadata == "kml":
        kml = write_kml_superoverlay(name, union, tiles, args.tile_size)
        print(f"Wrote {kml}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
