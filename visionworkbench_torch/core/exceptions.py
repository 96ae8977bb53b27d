"""Exception types the ported path raises (copied from
``visionworkbench_tpu/core/exceptions.py``; ref ``src/vw/Core/Exception.h``)."""

from __future__ import annotations


class VWError(Exception):
    """Root of the framework exception hierarchy (ref ``Exception.h:124``)."""


class ArgumentErr(VWError, ValueError):
    """Invalid arguments (ref ``Exception.h`` ArgumentErr)."""
