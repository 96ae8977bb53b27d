"""Exception hierarchy of the port (a copy of
``visionworkbench_tpu/core/exceptions.py``; ref
``src/vw/Core/Exception.h:124-253``), with plain Python exceptions.
``vw_throw(Exc, msg)`` exists for call-site parity.
"""

from __future__ import annotations


class VWError(Exception):
    """Root of the framework exception hierarchy (ref ``Exception.h:124``)."""


class ArgumentErr(VWError, ValueError):
    """Invalid arguments (ref ``Exception.h`` ArgumentErr)."""


class LogicErr(VWError):
    """Internal consistency failure."""


class InputErr(VWError):
    """Malformed input data."""


class IOErr(VWError, IOError):
    """File / resource IO failure."""


class MathErr(VWError, ArithmeticError):
    """Numerical failure (singular system, no convergence, ...)."""


class NullPtrErr(VWError):
    """Missing required object."""


class TypeErr(VWError, TypeError):
    """Dynamic type mismatch (e.g. wrong pixel format)."""


class NotFoundErr(VWError, KeyError):
    """Lookup failure."""


class NoImplErr(VWError, NotImplementedError):
    """Unimplemented functionality."""


class AbortedErr(VWError):
    """Operation cancelled (progress-callback abort, ref ``ProgressCallback.h``)."""


class UnsupportedCRSErr(ArgumentErr):
    """A CRS (proj4 / WKT / EPSG) names a projection, datum, or unit outside
    the in-tree set (the reference delegates arbitrary CRSs to PROJ/OGR,
    ``src/vw/Cartography/GeoReference.h:251-254``; this framework carries its
    own projection families and raises this typed error beyond them)."""


def vw_throw(exc_type: type, *message) -> None:
    """Raise ``exc_type`` with the concatenation of ``message`` parts.

    Parity shim for the reference's ``vw_throw(ArgumentErr() << "...")`` idiom.
    """
    raise exc_type("".join(str(m) for m in message))
