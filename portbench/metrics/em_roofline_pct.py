"""em_roofline_pct: the affine / Bayes-EM subpixel refiner's share of its
roofline, in %: the least time of the traced items' refinement (the larger
of operations over 67 TFLOP/s and bytes over 3.35 TB/s, counted from the
settings and the frame's shape by ``portbench/roofline_em.py``) over the
device time of the refiner's ``em.*`` steps (``em_device_ms``). None where
the program names no such step. Subpixel refiner layer."""

from portbench import roofline_em, spans


def read(ctx):
    return roofline_em.traced_share(ctx, spans.of(ctx))
