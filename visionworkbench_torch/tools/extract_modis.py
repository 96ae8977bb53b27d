"""Assemble MODIS band images for water detection (port of
``visionworkbench_tpu/tools/extract_modis.py``; ref
``src/vw/tools/extract_modis_images.py``).

The reference script shells out to ``gdalinfo``/``gdal_translate`` to pull
the seven ``sur_refl_b0N_1`` subdatasets (plus QC bands) out of MOD09 HDF
containers into per-band GeoTIFFs. HDF4 is a gated format here (as OpenEXR
is in the reference build), so this tool starts from per-band GeoTIFFs --
the exact files the reference script produces -- and performs the remaining
steps in-process:

* channel selection by the same ``DESIRED_CHANNELS`` name list,
* duplicate pruning keeping the highest-resolution copy
  (``prune_datasets``, extract_modis_images.py:80-111),
* stacking into the (H, W, 7) surface-reflectance image that
  ``detect_water --mode modis`` consumes (lower-resolution bands are
  upsampled to the b01 grid on the card):

    python -m visionworkbench_torch.tools.extract_modis MOD09_sur_refl_b0*_1.tif --prefix out/

Same arguments, printed lines and output file as the JAX package's CLI.
"""

from __future__ import annotations

import argparse
import os
import re
import sys

import numpy as np

from .flood.modis import MODIS_CHANNEL_NAMES, NUM_MODIS_BANDS


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vw-extract-modis",
        description="Stack per-band MODIS GeoTIFFs into a 7-band image")
    p.add_argument("inputs", nargs="+",
                   help="Per-band GeoTIFFs named after their MODIS "
                        "subdataset (e.g. MOD09_sur_refl_b01_1.tif)")
    p.add_argument("--prefix", default="",
                   help="Output prefix (extract_modis_images.py:134)")
    p.add_argument("--overwrite", action="store_true",
                   help="Overwrite an existing output file")
    return p


def _channel_of(path: str):
    """Working-channel index for a filename, or None."""
    for i, name in enumerate(MODIS_CHANNEL_NAMES):
        if name in os.path.basename(path):
            return i
    # Tolerate names without the trailing dataset suffix (sur_refl_b01.tif).
    m = re.search(r"sur_refl_b0(\d)", os.path.basename(path))
    if m:
        idx = int(m.group(1)) - 1
        if 0 <= idx < NUM_MODIS_BANDS:
            return idx
    return None


def main(argv=None, device=None) -> int:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` when None); ``device``:
    ``None`` = the card, ``"cpu"`` the plain PyTorch path."""
    args = build_parser().parse_args(argv)
    import torch
    from visionworkbench_torch.cartography import georeference_from_tiff_info
    from visionworkbench_torch.core.device import resolve_device
    from visionworkbench_torch.fileio import read_tiff, write_tiff
    from visionworkbench_torch.image.transform import resample
    from visionworkbench_torch.tools.flood.common import as_image

    for path in args.inputs:
        if path.lower().endswith((".hdf", ".he4", ".h4")):
            print(f"error: {path}: HDF4 containers are not supported; "
                  "extract the subdatasets to GeoTIFF first "
                  "(gdal_translate)", file=sys.stderr)
            return 1

    # Channel selection + duplicate pruning (keep the largest copy).
    best = {}
    for path in args.inputs:
        chan = _channel_of(path)
        if chan is None:
            continue
        arr, info = read_tiff(path)
        band = np.asarray(arr)[..., 0] if np.asarray(arr).ndim == 3 \
            else np.asarray(arr)
        if chan not in best or band.shape[0] > best[chan][0].shape[0]:
            best[chan] = (band, info)

    missing = [MODIS_CHANNEL_NAMES[i] for i in range(NUM_MODIS_BANDS)
               if i not in best]
    if missing:
        print(f"error: missing MODIS channels: {', '.join(missing)}",
              file=sys.stderr)
        return 1

    # Upsample everything onto the band-1 (highest-resolution kept) grid.
    ref_band, ref_info = best[0]
    h, w = ref_band.shape
    stack = torch.empty((h, w, NUM_MODIS_BANDS), dtype=torch.float32,
                        device=resolve_device(device))
    for chan in range(NUM_MODIS_BANDS):
        band = as_image(best[chan][0], stack.device)
        if band.shape != (h, w):
            band = resample(band, w / band.shape[1], h / band.shape[0],
                            interp="bilinear")[:h, :w]
        stack[..., chan] = band

    out_path = args.prefix + "modis_stack.tif"
    out_dir = os.path.dirname(out_path)
    if out_dir and not os.path.exists(out_dir):
        os.makedirs(out_dir)
    if os.path.exists(out_path) and not args.overwrite:
        print(f"{out_path} exists; pass --overwrite to replace it")
        return 0
    write_tiff(out_path, stack.cpu().numpy(),
               georef=georeference_from_tiff_info(ref_info))
    print(f"Wrote {out_path} ({h}x{w}x{NUM_MODIS_BANDS})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
