"""Logging with per-(level, namespace) rules (a port of
``visionworkbench_tpu/core/log.py``; the same rules decide the same
(level, namespace) pairs).

Analogue of the reference's ``vw_out(level, namespace)`` streaming logger with
``LogRuleSet`` filtering (``src/vw/Core/Log.h:66-260``). Built on the stdlib
``logging`` module: each namespace maps to a child logger of ``"vwtorch"``,
the port's own root, and a rule set decides which (level, namespace) pairs
pass.
"""

from __future__ import annotations

import fnmatch
import logging
import sys
import threading
from typing import List, Tuple

# Levels mirror Log.h:66 (ErrorMessage=0 ... VerboseDebugMessage=40 in the
# reference; we keep names, map onto stdlib numeric levels).
ERROR = logging.ERROR
WARNING = logging.WARNING
INFO = logging.INFO
DEBUG = logging.DEBUG
VERBOSE_DEBUG = logging.DEBUG - 5

logging.addLevelName(VERBOSE_DEBUG, "VDEBUG")

ROOT = "vwtorch"
_root = logging.getLogger(ROOT)
if not _root.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter("%(name)s: %(message)s"))
    _root.addHandler(_h)
    _root.setLevel(INFO)
    _root.propagate = False


class LogRuleSet:
    """Glob rules "<level> <namespace-pattern>" (ref ``LogRuleSet``, Log.h:102)."""

    def __init__(self) -> None:
        self._rules: List[Tuple[int, str]] = []
        self._lock = threading.Lock()

    def add_rule(self, level: int, namespace_pattern: str) -> None:
        with self._lock:
            self._rules.append((level, namespace_pattern))

    def clear(self) -> None:
        with self._lock:
            self._rules.clear()

    def operator_matches(self, level: int, namespace: str) -> bool:
        with self._lock:
            if not self._rules:
                return level >= INFO
            for rule_level, pat in self._rules:
                if fnmatch.fnmatch(namespace, pat) and level >= rule_level:
                    return True
        return False


_rules = LogRuleSet()


def vw_log_rules() -> LogRuleSet:
    return _rules


def vw_out(level: int = INFO, namespace: str = "console") -> logging.Logger:
    """Return a logger for ``namespace`` if (level, namespace) passes the rule
    set, else a no-op logger. Usage: ``vw_out(INFO, "stereo").info(...)``."""
    logger = _root.getChild(namespace)
    if _rules.operator_matches(level, namespace):
        logger.setLevel(min(level, logger.getEffectiveLevel() or level))
        return logger
    silent = logging.getLogger(ROOT + "._silent")
    silent.disabled = True
    return silent


def set_console_level(level: int) -> None:
    _root.setLevel(level)
