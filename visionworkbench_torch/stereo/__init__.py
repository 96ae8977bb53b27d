"""Stereo correlation of the port: the pyramid correlator (block matching
and SGM/MGM) and ``calc_disparity_sgm``."""

from visionworkbench_torch.stereo.sgm import calc_disparity_sgm  # noqa: F401
