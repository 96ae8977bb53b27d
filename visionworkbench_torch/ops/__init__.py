"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: ``sweep`` (block-matching sweep, every cost), ``speckle`` (speckle
stencil), ``sgm_scan`` (the SGM/MGM aggregation scans) and ``sgm_wta``
(the SGM/MGM winner-take-all and subpixel step); ``cost_volume``
puts the JAX package's first-generation searches onto the sweep, and
``box_filter`` holds the plain window sums (exported, as the JAX package's
``ops``). ``_build`` compiles ``csrc/*.cu`` with nvcc at first use."""

from visionworkbench_torch.ops.box_filter import (  # noqa: F401
    box_filter_same, box_sum_same, box_sum_valid, box_sum_valid_int,
)
