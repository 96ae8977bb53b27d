"""Lens undistortion CLI (port of
``visionworkbench_tpu/tools/undistort_image.py``; ref
``src/vw/tools/undistort_image.cc``). The warp runs on the card:

    python -m visionworkbench_torch.tools.undistort_image image.tif camera.tsai

Same arguments and printed lines as the JAX package's CLI.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="vw-undistort-image",
                                description="Remove lens distortion")
    p.add_argument("image")
    p.add_argument("camera", help=".tsai pinhole model")
    p.add_argument("-o", "--output", default=None)
    p.add_argument("--interpolation-method", choices=["bilinear", "bicubic"],
                   default="bilinear")
    p.add_argument("--output-nodata-value", type=float, default=None,
                   help="nodata value recorded in the output TIFF "
                        "(ref undistort_image.cc)")
    return p


def main(argv=None, device=None) -> int:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` when None); ``device``:
    ``None`` = the card, ``"cpu"`` the plain PyTorch path."""
    args = build_parser().parse_args(argv)
    from visionworkbench_torch.camera import read_pinhole_model, undistort_image
    from visionworkbench_torch.fileio import read_image, write_image, write_tiff

    cam = read_pinhole_model(args.camera)
    img = read_image(args.image, np.float32)
    out = undistort_image(img, cam, interp=args.interpolation_method,
                          device=device).cpu().numpy()
    out_path = args.output or (args.image.rsplit(".", 1)[0] + "_undist.tif")
    if out_path.lower().endswith((".tif", ".tiff")):
        write_tiff(out_path, out.astype(np.float32),
                   nodata=args.output_nodata_value)
    else:
        write_image(out_path, out)
    print(f"Wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
