"""Interest point matching CLI of the port (port of
``visionworkbench_tpu/tools/ipmatch.py``; ref ``src/vw/tools/ipmatch.cc``):
exact ratio-test matching of two ``.vwip`` files and RANSAC geometric
filtering on the card, then a ``.match`` file (or text), optionally a
debug image:

    python -m visionworkbench_torch.tools.ipmatch a.tif b.tif --ransac-constraint similarity

Also the file modes: ``--binary-to-txt``, ``--txt-to-binary`` and
``--merge-match-files``. Same arguments and defaults as the JAX package's
CLI.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vw-ipmatch",
        description="Match .vwip files between image pairs; writes .match")
    p.add_argument("images", nargs=2, help="two images (with <image>.vwip present)")
    p.add_argument("--output-prefix", default="")
    p.add_argument("--matcher-threshold", type=float, default=0.6,
                   help="Lowe ratio")
    p.add_argument("--ransac-constraint",
                   choices=["similarity", "homography", "fundamental", "none"],
                   default="similarity")
    p.add_argument("--inlier-threshold", type=float, default=10.0)
    p.add_argument("--ransac-iterations", type=int, default=100)
    p.add_argument("-m", "--distance-metric", choices=["l2", "hamming"],
                   default="l2",
                   help="descriptor distance (ref ipmatch.cc "
                        "--distance-metric; hamming for binary descriptors)")
    p.add_argument("--matches-as-txt", action="store_true",
                   help="write the match file as plain text (.txt)")
    p.add_argument("--binary-to-txt", action="store_true",
                   help="convert: read binary <in.match>, write text "
                        "<out.txt> (pass the two files as positionals)")
    p.add_argument("--txt-to-binary", action="store_true",
                   help="convert: read text <in.txt>, write binary "
                        "<out.match>")
    p.add_argument("--merge-match-files", action="store_true",
                   help="merge several match files for one image pair; "
                        "inputs then output as positionals "
                        "(ref ipmatch.cc --merge-match-files)")
    p.add_argument("--debug-image", action="store_true")
    return p


def _file_modes(argv, known) -> int:
    """The conversions and the merge, which take free-form positionals."""
    from visionworkbench_torch.interest.io import (
        read_binary_match_file, read_text_match_file, write_binary_match_file,
        write_text_match_file,
    )
    files = [a for a in (argv if argv is not None else sys.argv[1:])
             if not a.startswith("-")]
    if known.binary_to_txt:
        src, dst = files
        write_text_match_file(dst, *read_binary_match_file(src))
        print(f"Wrote {dst}")
        return 0
    if known.txt_to_binary:
        src, dst = files
        write_binary_match_file(dst, *read_text_match_file(src))
        print(f"Wrote {dst}")
        return 0
    # merge: inputs... output (last); duplicates removed keep-first
    *srcs, dst = files
    reader = read_text_match_file if known.matches_as_txt else read_binary_match_file
    writer = write_text_match_file if known.matches_as_txt else write_binary_match_file
    xs1, ys1, xs2, ys2, seen = [], [], [], [], set()
    for f in srcs:
        a, b = reader(f)
        for i in range(len(a["x"])):
            key = (float(a["x"][i]), float(a["y"][i]),
                   float(b["x"][i]), float(b["y"][i]))
            if key in seen:
                continue
            seen.add(key)
            xs1.append(a["x"][i])
            ys1.append(a["y"][i])
            xs2.append(b["x"][i])
            ys2.append(b["y"][i])
    writer(dst, {"x": np.asarray(xs1), "y": np.asarray(ys1)},
           {"x": np.asarray(xs2), "y": np.asarray(ys2)})
    print(f"Merged {len(srcs)} files -> {dst} ({len(xs1)} matches)")
    return 0


def _debug_image(im1, im2, c1, c2, out):
    """Both images side by side with a red line per match."""
    from visionworkbench_torch.fileio import read_image, write_image
    a = read_image(im1, np.float32)
    b = read_image(im2, np.float32)
    if a.ndim == 3:
        a = a.mean(axis=2)
    if b.ndim == 3:
        b = b.mean(axis=2)
    h = max(a.shape[0], b.shape[0])
    canvas = np.zeros((h, a.shape[1] + b.shape[1], 3), np.float32)
    for k in range(3):
        canvas[:a.shape[0], :a.shape[1], k] = a
        canvas[:b.shape[0], a.shape[1]:, k] = b
    for (x1, y1), (x2, y2) in zip(c1, c2):
        n = 50
        xs = np.linspace(x1, x2 + a.shape[1], n).astype(int)
        ys = np.linspace(y1, y2, n).astype(int)
        ok = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < canvas.shape[1])
        canvas[ys[ok], xs[ok]] = [1.0, 0.0, 0.0]
    debug_path = out.replace(".match", "_debug.png")
    write_image(debug_path, canvas)
    print(f"Wrote {debug_path}")


def main(argv=None, device=None) -> int:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` when None); ``device``:
    ``None`` = the card, ``"cpu"`` the plain PyTorch path."""
    pre = argparse.ArgumentParser(add_help=False)
    for flag in ("--binary-to-txt", "--txt-to-binary", "--merge-match-files",
                 "--matches-as-txt"):
        pre.add_argument(flag, action="store_true")
    known, _ = pre.parse_known_args(argv)
    if known.binary_to_txt or known.txt_to_binary or known.merge_match_files:
        return _file_modes(argv, known)

    args = build_parser().parse_args(argv)
    from visionworkbench_torch.core.device import resolve_device
    from visionworkbench_torch.core.exceptions import VWError
    from visionworkbench_torch.interest import (
        from_numpy, match_filename, match_points, matched_coordinates,
        read_binary_ip_file, write_binary_match_file, write_text_match_file,
    )
    from visionworkbench_torch.interest.matcher import remove_duplicates
    from visionworkbench_torch.math.ransac import ransac

    dev = resolve_device(device)
    im1, im2 = args.images
    p1 = from_numpy(read_binary_ip_file(os.path.splitext(im1)[0] + ".vwip"), dev)
    p2 = from_numpy(read_binary_ip_file(os.path.splitext(im2)[0] + ".vwip"), dev)
    m = match_points(p1, p2, ratio=args.matcher_threshold,
                     metric=args.distance_metric)
    # many-to-one matches pruned keep-last, like the reference
    # (ipmatch.cc:380 -> remove_duplicates)
    c1, c2 = remove_duplicates(*matched_coordinates(p1, p2, m))
    print(f"Found {len(c1)} putative matches")
    if args.ransac_constraint != "none" and len(c1) >= 4:
        model = ("similarity" if args.ransac_constraint in ("similarity",
                                                            "fundamental")
                 else args.ransac_constraint)
        try:
            _, inliers = ransac(c1, c2, model, args.inlier_threshold,
                                args.ransac_iterations, device=dev)
            c1, c2 = c1[inliers], c2[inliers]
            print(f"RANSAC kept {len(c1)} matches")
        except VWError as e:
            print(f"RANSAC failed ({e}); keeping raw matches")
    out = match_filename(args.output_prefix, im1, im2)
    a = {"x": c1[:, 0], "y": c1[:, 1]}
    b = {"x": c2[:, 0], "y": c2[:, 1]}
    if args.matches_as_txt:
        out = out[:-len(".match")] + ".txt"
        write_text_match_file(out, a, b)
    else:
        write_binary_match_file(out, a, b)
    print(f"Wrote {out}")
    if args.debug_image:
        _debug_image(im1, im2, c1, c2, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
