"""scan_roofline_pct: the SGM/MGM aggregation scans' share of their
roofline, in %: the least time of the eight path directions at every
level of the traced items (the larger of operations over 67 TFLOP/s and
bytes over 3.35 TB/s, counted from the configuration and the pyramid's
shapes by ``portbench/roofline.py``) over the device time of the scan
kernels of ``csrc/{mgm_scan, mgm_cluster_scan, sgm_path_scan,
sgm_scan}.cu``. Kernels layer."""

from portbench import roofline


def read(ctx):
    return roofline.traced_share(ctx, "scan")
