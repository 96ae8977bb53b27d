"""Bundle adjustment support of the port (``src/vw/BundleAdjustment/``; the
solver itself lives downstream in the reference too -- Ames Stereo
Pipeline): control networks, with the names of
``visionworkbench_tpu/ba/__init__.py``."""

from visionworkbench_torch.ba.control_network import (  # noqa: F401
    ControlMeasure, ControlNetwork, ControlPoint, build_control_network,
)
