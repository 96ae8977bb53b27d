"""EXIF dump CLI (port of ``visionworkbench_tpu/tools/print_exif.py``; ref
``src/vw/tools/print_exif.cc``), on the port's in-tree parser:

    python -m visionworkbench_torch.tools.print_exif photo.jpg

Same arguments and printed lines as the JAX package's CLI.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="vw-print-exif",
                                description="Print EXIF metadata")
    p.add_argument("images", nargs="+")
    return p


def main(argv=None, device=None) -> int:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` when None). The parser runs
    on the host; ``device`` is accepted as by the port's other tools."""
    args = build_parser().parse_args(argv)
    from visionworkbench_torch.camera import ExifView

    for path in args.images:
        print(f"== {path}")
        try:
            exif = ExifView(path)
        except Exception as e:
            print(f"  error: {e}")
            continue
        if not exif.tags:
            print("  (no EXIF data)")
            continue
        for name, value in sorted(exif.items(), key=lambda kv: str(kv[0])):
            print(f"  {name}: {value}")
        lum = exif.get_average_luminance()
        if lum is not None:
            print(f"  [derived] average luminance: {lum:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
