"""Pinhole model conversion CLI (port of
``visionworkbench_tpu/tools/convert_pinhole_model.py``; ref
``src/vw/tools/convert_pinhole_model.cc``): refit a camera's distortion to a
different model type by sampling the pixel mapping and least-squares
fitting the target parameters with ``levenberg_marquardt`` on the card:

    python -m visionworkbench_torch.tools.convert_pinhole_model image.tif camera.tsai

Same arguments and printed lines as the JAX package's CLI.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vw-convert-pinhole-model",
        description="Convert between pinhole distortion model types")
    p.add_argument("image", help="image (for the sampling grid size)")
    p.add_argument("camera", help="input .tsai")
    p.add_argument("-o", "--output-file", default="output.tsai")
    p.add_argument("--output-type",
                   choices=["TsaiLensDistortion", "NullLensDistortion"],
                   default="TsaiLensDistortion")
    p.add_argument("--sample-spacing", type=int, default=50)
    return p


def main(argv=None, device=None) -> int:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` when None); ``device``:
    ``None`` = the card, ``"cpu"`` the plain PyTorch path."""
    args = build_parser().parse_args(argv)
    import torch
    from visionworkbench_torch.camera import (
        NullLensDistortion, PinholeModel, TsaiLensDistortion,
        read_pinhole_model, write_pinhole_model,
    )
    from visionworkbench_torch.core.device import on_device
    from visionworkbench_torch.fileio import image_size
    from visionworkbench_torch.math.optimization import levenberg_marquardt

    cam = read_pinhole_model(args.camera)
    h, w = image_size(args.image)

    if args.output_type == "NullLensDistortion":
        out_cam = PinholeModel(cam.C, cam.R, (cam.fu, cam.fv), (cam.cu, cam.cv),
                               NullLensDistortion(), cam.pixel_pitch)
        write_pinhole_model(args.output_file, out_cam)
        print(f"Wrote {args.output_file}")
        return 0

    # Sample normalized focal-plane coordinates over the image grid.
    xs = np.arange(0, w, args.sample_spacing, dtype=np.float32)
    ys = np.arange(0, h, args.sample_spacing, dtype=np.float32)
    gx, gy = np.meshgrid(xs, ys)
    nx = (gx.ravel() * cam.pixel_pitch - cam.cu) / cam.fu
    ny = (gy.ravel() * cam.pixel_pitch - cam.cv) / cam.fv
    pts = on_device(np.stack([nx, ny], -1), device, torch.float32)
    target = cam.distortion.distort(pts)

    x, y = pts[..., 0], pts[..., 1]

    def model(params):
        # The Tsai forward model (same math as TsaiLensDistortion).
        k1, k2, p1, p2, k3 = (params[0], params[1], params[2], params[3],
                              params[4])
        r2 = x * x + y * y
        rdist = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
        xo = x * rdist + (2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x))
        yo = y * rdist + (p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y)
        return torch.stack([xo, yo], -1).reshape(-1)

    res = levenberg_marquardt(model, torch.zeros(5, device=pts.device), target.reshape(-1),
                              max_iterations=50)
    k1, k2, p1, p2, k3 = res.x
    out_cam = PinholeModel(cam.C, cam.R, (cam.fu, cam.fv), (cam.cu, cam.cv),
                           TsaiLensDistortion(k1, k2, p1, p2, k3),
                           cam.pixel_pitch)
    write_pinhole_model(args.output_file, out_cam)
    print(f"Wrote {args.output_file} (residual {res.final_error:.3e}, "
          f"{res.iterations} LM iterations)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
