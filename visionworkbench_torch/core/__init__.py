"""Runtime substrate of the port: settings, logging, exceptions, timers,
progress, the host cache, work queues, command helpers, profiling and the
device policy (``core/device.py``). The same ``__all__`` as
``visionworkbench_tpu/core/__init__.py``; ref ``src/vw/Core/``.
"""

from visionworkbench_torch.core.exceptions import (
    AbortedErr, ArgumentErr, InputErr, IOErr, LogicErr, MathErr, NoImplErr,
    NotFoundErr, NullPtrErr, TypeErr, VWError, vw_throw,
)
from visionworkbench_torch.core.settings import Settings, reload_config, vw_settings
from visionworkbench_torch.core.log import vw_out, vw_log_rules, set_console_level
from visionworkbench_torch.core.stopwatch import Stopwatch, StopwatchSet, Timer, stopwatch_set
from visionworkbench_torch.core.progress import (
    ProgressCallback, SubProgressCallback, TerminalProgressCallback, dummy_progress,
)
from visionworkbench_torch.core.cache import Cache, CacheHandle, vw_system_cache
from visionworkbench_torch.core.profiling import materialize, span, trace  # noqa: F401
from visionworkbench_torch.core.cmdutils import (  # noqa: F401
    exec_cmd, find_executable_in_path, program_path,
)

__all__ = [
    "AbortedErr", "ArgumentErr", "InputErr", "IOErr", "LogicErr", "MathErr",
    "NoImplErr", "NotFoundErr", "NullPtrErr", "TypeErr", "VWError", "vw_throw",
    "Settings", "reload_config", "vw_settings",
    "vw_out", "vw_log_rules", "set_console_level",
    "Stopwatch", "StopwatchSet", "Timer", "stopwatch_set",
    "ProgressCallback", "SubProgressCallback", "TerminalProgressCallback", "dummy_progress",
    "Cache", "CacheHandle", "vw_system_cache",
]
