"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: ``sweep`` (block-matching sweep) and ``speckle`` (speckle
stencil). ``_build`` compiles ``csrc/*.cu`` with nvcc at first use."""
