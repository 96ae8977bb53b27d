"""sweep_roofline_pct: the block-matching sweeps' share of their roofline,
in %: the least time of every sweep of the traced items (the larger of
operations over 67 TFLOP/s and bytes over 3.35 TB/s, counted from the
configuration and the pyramid's shapes by ``portbench/roofline.py``) over
the device time of the sweep kernels of ``csrc/sweep.cu``. Kernels
layer."""

from portbench import roofline


def read(ctx):
    return roofline.traced_share(ctx, "sweep")
