"""Stereo correlation CLI of the port (port of
``visionworkbench_tpu/tools/correlate.py``; ref
``src/vw/tools/correlate.cc:56-290``).

Reads a rectified pair (TIFF nodata becomes validity masks), runs the
port's pyramid correlator on the card (SAD/SSD/NCC/census, BM or SGM/MGM,
the L<->R check and the parabola / affine / Bayes-EM subpixel modes) and
writes a tiled TIFF of three float32 bands: dx, dy and validity.

    python -m visionworkbench_torch.tools.correlate left.tif right.tif --subpixel em

Same arguments and defaults as the JAX package's CLI. ``--match-file``
pre-aligns the right image as the JAX package does: a RANSAC homography
(100 hypotheses, 10 px) fitted from the file's right points to its left
points, the right image warped by its inverse on the run's device.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vw-correlate",
        description="Dense stereo correlation on a rectified image pair")
    p.add_argument("left")
    p.add_argument("right")
    p.add_argument("-o", "--output-prefix", default="disparity")
    p.add_argument("--xoffset", type=int, default=0,
                   help="horizontal search offset (search region min x)")
    p.add_argument("--yoffset", type=int, default=0)
    p.add_argument("--xrange", type=int, default=64,
                   help="horizontal search size")
    p.add_argument("--yrange", type=int, default=8)
    p.add_argument("--kernel", type=int, nargs=2, default=(21, 21),
                   metavar=("W", "H"))
    p.add_argument("--cost-mode", choices=["abs", "sq", "ncc", "census",
                                           "ternary_census"], default="abs")
    p.add_argument("--prefilter", choices=["none", "meansub", "log"],
                   default="log")
    p.add_argument("--prefilter-width", type=float, default=1.4)
    p.add_argument("--max-pyramid-levels", type=int, default=5)
    p.add_argument("--consistency-threshold", type=float, default=-1.0,
                   help=">= 0 enables the left<->right check")
    p.add_argument("--subpixel",
                   choices=["none", "parabola", "affine", "em"],
                   default="none",
                   help="subpixel mode: parabola (9-point quadratic), "
                        "affine (weighted affine GN), em (Bayes-EM affine "
                        "mixture — the reference's quality mode)")
    p.add_argument("--blob-filter-area", type=int, default=0)
    p.add_argument("--match-file", default=None,
                   help="pre-align right image with a RANSAC homography fit "
                        "to this .match file")
    p.add_argument("--tile-size", type=int, default=64,
                   help="refinement tile size (search offsets granularity)")
    p.add_argument("--corr-timeout", type=float, default=0.0,
                   help="time budget in seconds (ref corr-timeout): degrades "
                        "the per-level search volume instead of failing; "
                        "0 disables")
    p.add_argument("--use-sgm", action="store_true",
                   help="semi-global matching instead of block matching")
    p.add_argument("--use-mgm", action="store_true",
                   help="MGM smooth variant (implies census costs)")
    return p


def _nodata_mask(path: str, img: np.ndarray):
    """The validity mask of a TIFF with a nodata value, else None."""
    from visionworkbench_torch.fileio import TiffInfo
    if not path.lower().endswith((".tif", ".tiff")):
        return None
    nd = TiffInfo(path).nodata
    return None if nd is None else img != nd


def _prealign(match_file: str, right: np.ndarray, shape, dev):
    """``right`` warped on ``dev`` by the inverse of the RANSAC homography
    (``ransac(p2, p1, "homography", 10.0, 100)``) of ``match_file``, to
    ``shape``'s height and width."""
    import torch
    from visionworkbench_torch.image.transform import transform
    from visionworkbench_torch.interest.io import read_binary_match_file
    from visionworkbench_torch.math.ransac import ransac
    from visionworkbench_torch.math.transform2d import HomographyTransform
    d1, d2 = read_binary_match_file(match_file)
    p1 = np.stack([d1["x"], d1["y"]], -1)
    p2 = np.stack([d2["x"], d2["y"]], -1)
    t, inliers = ransac(p2, p1, "homography", 10.0, 100, device=dev)
    print(f"Pre-alignment homography from {len(inliers)} inliers")
    return transform(torch.as_tensor(right, device=dev),
                     HomographyTransform(t.matrix).inverse(), (shape[0], shape[1]))


def main(argv=None, device=None) -> int:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` when None); ``device``:
    ``None`` = the card, ``"cpu"`` the plain PyTorch path."""
    args = build_parser().parse_args(argv)
    from visionworkbench_torch.core.device import resolve_device
    from visionworkbench_torch.core.stopwatch import Timer
    from visionworkbench_torch.fileio import read_image, write_tiff
    from visionworkbench_torch.math.bbox import BBox2i
    from visionworkbench_torch.stereo.pyramid_correlation import pyramid_correlate

    dev = resolve_device(device)
    left = read_image(args.left, np.float32)
    right = read_image(args.right, np.float32)
    if left.ndim == 3:
        left = left.mean(axis=2)
    if right.ndim == 3:
        right = right.mean(axis=2)
    # nodata -> validity masks (ref correlate.cc mask handling)
    left_mask = _nodata_mask(args.left, left)
    right_mask = _nodata_mask(args.right, right)
    if args.match_file:
        right = _prealign(args.match_file, right, left.shape, dev)

    search = BBox2i(args.xoffset, args.yoffset, args.xrange, args.yrange)
    algo = "mgm" if args.use_mgm else ("sgm" if args.use_sgm else "bm")
    with Timer("correlation time"):
        dm = pyramid_correlate(
            left, right, search,
            kernel_size=tuple(args.kernel), cost_type=args.cost_mode,
            left_mask=left_mask, right_mask=right_mask,
            prefilter_mode=args.prefilter, prefilter_width=args.prefilter_width,
            consistency_threshold=args.consistency_threshold,
            max_pyramid_levels=args.max_pyramid_levels,
            tile_size=args.tile_size, subpixel=args.subpixel,
            blob_filter_area=args.blob_filter_area,
            stereo_algorithm=algo, corr_timeout=args.corr_timeout,
            device=dev)
        disp, valid = dm.to_numpy()

    out = np.concatenate([disp.astype(np.float32),
                          valid[..., None].astype(np.float32)], axis=-1)
    out_path = args.output_prefix + ".tif"
    write_tiff(out_path, out, tile_size=256)
    n_valid = int(valid.sum())
    print(f"Wrote {out_path}: {disp.shape[1]}x{disp.shape[0]}, "
          f"{n_valid} valid px ({100.0 * n_valid / valid.size:.1f}%)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
