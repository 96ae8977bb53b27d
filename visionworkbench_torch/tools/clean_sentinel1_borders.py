"""Trim noisy SAR swath borders (port of
``visionworkbench_tpu/tools/clean_sentinel1_borders.py``; ref
``src/vw/tools/clean_sentinel1_borders.cc``): invalidate border-connected
low-backscatter pixels and write the cleaned image with a nodata value.
The mask and the cleaned plane are made on the card:

    python -m visionworkbench_torch.tools.clean_sentinel1_borders grd.tif -o clean.tif

Same arguments, printed line and output file as the JAX package's CLI.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="vw-clean-sentinel1-borders",
                                description="Remove noisy Sentinel-1 borders")
    p.add_argument("input")
    p.add_argument("-o", "--output", default=None)
    p.add_argument("--border-threshold", type=float, default=0.02,
                   help="pixels below this are border noise candidates")
    p.add_argument("--nodata-value", type=float, default=0.0)
    return p


def main(argv=None, device=None) -> int:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` when None); ``device``:
    ``None`` = the card, ``"cpu"`` the plain PyTorch path."""
    args = build_parser().parse_args(argv)
    import torch
    from visionworkbench_torch.cartography import georeference_from_tiff_info
    from visionworkbench_torch.fileio import read_tiff, write_tiff
    from visionworkbench_torch.image.masks import edge_mask
    from visionworkbench_torch.tools.flood.common import as_plane

    arr, info = read_tiff(args.input)
    band = arr if arr.ndim == 2 else arr[..., 0]
    wide = as_plane(band, device)
    img = wide.float()
    # Border-connected low-value region: binarize "signal" pixels, then keep
    # only the region reachable from the interior (edge_mask semantics).
    signal = (img > args.border_threshold).float() * img
    valid = edge_mask(signal, 0.0).valid
    cleaned = torch.where(valid, wide, args.nodata_value).cpu().numpy()
    out_path = args.output or (args.input.rsplit(".", 1)[0] + "_clean.tif")
    write_tiff(out_path, cleaned.astype(band.dtype),
               georef=georeference_from_tiff_info(info),
               nodata=args.nodata_value)
    kept = int(valid.sum()) / valid.numel()
    print(f"Wrote {out_path}: kept {100.0 * kept:.1f}% of pixels")
    return 0


if __name__ == "__main__":
    sys.exit(main())
