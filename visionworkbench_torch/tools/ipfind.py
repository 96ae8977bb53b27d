"""Interest point detection CLI of the port (port of
``visionworkbench_tpu/tools/ipfind.py``; ref ``src/vw/tools/ipfind.cc:61-229``).

Detects points (``sift``/``dog``: the DoG scale space, the default;
``obalog``; ``harris`` or ``log``, single-scale or scaled), assigns
orientations and describes them on the card, and writes ``<image>.vwip``:

    python -m visionworkbench_torch.tools.ipfind a.tif b.tif

Same arguments and defaults as the JAX package's CLI.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vw-ipfind",
        description="Detect and describe interest points; writes <image>.vwip")
    p.add_argument("images", nargs="+")
    p.add_argument("--interest-operator",
                   choices=["sift", "dog", "harris", "log", "obalog"],
                   default="sift",
                   help="sift/dog = DoG scale-space + oriented descriptors "
                        "(the reference ipfind's default capability)")
    p.add_argument("--descriptor-generator",
                   choices=["patch", "sgrad", "sgrad2"], default="sgrad")
    p.add_argument("--max-points", type=int, default=1000)
    p.add_argument("--ip-per-image", type=int, default=0,
                   help="max interest points for the whole image (0 = use "
                        "--max-points; ref ipfind.cc --ip-per-image)")
    p.add_argument("-g", "--gain", type=float, default=1.0,
                   help="detection gain: thresholds divide by this "
                        "(ref ipfind.cc --gain)")
    p.add_argument("--threshold", type=float, default=None)
    p.add_argument("--single-scale", action="store_true",
                   help="disable scale-space detection")
    p.add_argument("--no-orientation", action="store_true",
                   help="turn off rotational invariance (ref ipfind.cc)")
    p.add_argument("--normalize", action="store_true",
                   help="obsolete; normalization is always performed "
                        "(kept for reference flag compatibility)")
    p.add_argument("--print-ip", type=int, default=0,
                   help="print the first N interest points found")
    p.add_argument("-d", "--debug-image", type=int, default=0,
                   help="write <image>_debug.png with points drawn "
                        "(any nonzero value; ref ipfind.cc levels 1/2)")
    p.add_argument("--output-dir", default=None)
    return p


def main(argv=None, device=None) -> int:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` when None); ``device``:
    ``None`` = the card, ``"cpu"`` the plain PyTorch path."""
    args = build_parser().parse_args(argv)
    import torch
    from visionworkbench_torch.core.device import resolve_device
    from visionworkbench_torch.fileio import read_image, write_image
    from visionworkbench_torch.image.algorithms import normalize
    from visionworkbench_torch.interest import (
        assign_orientations, assign_orientations_scaled, describe, detect_points,
        detect_points_dog, detect_points_obalog, detect_points_scaled,
        write_binary_ip_file,
    )

    dev = resolve_device(device)
    if args.normalize:
        print("The --normalize option is obsolete. Normalization is always "
              "performed.")
    if args.ip_per_image > 0:
        args.max_points = args.ip_per_image
    thr = None if args.threshold is None else args.threshold / args.gain
    for path in args.images:
        img = read_image(path, np.float32)
        if img.ndim == 3:
            img = img.mean(axis=2)
        im = normalize(torch.as_tensor(img, device=dev))
        op = args.interest_operator
        if op in ("sift", "dog"):
            # DoG scale space + scale-aware orientations + oriented
            # scale-normalized descriptors (ref ipfind's OpenCV SIFT
            # default, ipfind.cc:61-229)
            pts = detect_points_dog(im, (args.threshold or 0.015) / args.gain,
                                    max_points=args.max_points)
        elif op == "obalog":
            pts = detect_points_obalog(im, (args.threshold or 1e-4) / args.gain,
                                       max_points=args.max_points)
        elif args.single_scale:
            pts = detect_points(im, op, thr, max_points=args.max_points)
        else:
            pts = detect_points_scaled(im, op, thr, max_points=args.max_points)
        if not args.no_orientation:
            orient = assign_orientations_scaled if op in ("sift", "dog") else assign_orientations
            pts = orient(im, pts)
        pts = describe(im, pts, args.descriptor_generator)
        out_dir = args.output_dir or os.path.dirname(path) or "."
        stem = os.path.splitext(os.path.basename(path))[0]
        out = os.path.join(out_dir, stem + ".vwip")
        d = pts.to_numpy()
        write_binary_ip_file(out, d)
        print(f"{path}: {len(d['x'])} interest points -> {out}")
        for i in range(min(args.print_ip, len(d["x"]))):
            print(f"  ip {i}: x={d['x'][i]:.2f} y={d['y'][i]:.2f} "
                  f"scale={d['scale'][i]:.3f} "
                  f"orientation={d['orientation'][i]:.3f}")
        if args.debug_image:
            dbg = np.repeat(np.clip(im.cpu().numpy(), 0, 1)[..., None], 3, -1)
            for x, y in zip(d["x"], d["y"]):
                yi, xi = int(round(float(y))), int(round(float(x)))
                if 0 <= yi < dbg.shape[0] and 0 <= xi < dbg.shape[1]:
                    dbg[max(yi - 1, 0):yi + 2, max(xi - 1, 0):xi + 2] = \
                        (1.0, 0.0, 0.0)
            dbg_path = os.path.join(out_dir, stem + "_debug.png")
            write_image(dbg_path, dbg)
            print(f"  debug image -> {dbg_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
