"""Tools of the port: the correlate CLI (``python -m
visionworkbench_torch.tools.correlate``), and measurement tools run on a
CUDA card from the repository root (``frame_times`` and the kernel
ablations)."""
