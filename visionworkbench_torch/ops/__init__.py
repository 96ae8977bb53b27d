"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: ``sweep`` (block-matching sweep, every cost), ``speckle`` (speckle
stencil) and ``sgm_scan`` (the SGM/MGM aggregation scans); ``cost_volume``
puts the JAX package's first-generation searches onto the sweep, and
``box_filter`` holds the plain window sums. ``_build`` compiles
``csrc/*.cu`` with nvcc at first use."""
