"""The benchmark of the PyTorch and CUDA port (``visionworkbench_torch``):
see ``portbench/harness.py``."""
