"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: ``sweep`` (block-matching sweep), ``speckle`` (speckle stencil)
and ``sgm_scan`` (the SGM/MGM aggregation scans). ``_build`` compiles
``csrc/*.cu`` with nvcc at first use."""
