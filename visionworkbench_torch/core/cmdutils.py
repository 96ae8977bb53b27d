"""System-command helpers (a copy of
``visionworkbench_tpu/core/cmdutils.py``, which imports no JAX; ref
``src/vw/Core/CmdUtils.h:17-38`` / ``CmdUtils.cc:20-90``): capture a command's output, resolve a sibling
program next to the current executable, fall back to the system PATH.

The reference shells out through ``popen``/``which``; here the same three
entry points use the stdlib (``subprocess`` with a shell for ``exec_cmd``
parity, ``shutil.which`` for PATH lookup) — no behavioral additions.
"""

from __future__ import annotations

import os
import shutil
import subprocess

from visionworkbench_torch.core.exceptions import NotFoundErr


def exec_cmd(cmd: str) -> str:
    """Execute a shell command and capture its stdout
    (ref ``exec_cmd``, CmdUtils.cc:28-47: popen + read-all)."""
    proc = subprocess.run(cmd, shell=True, stdout=subprocess.PIPE,
                          text=True)
    return proc.stdout


def find_executable_in_path(prog_name: str) -> str:
    """Full path of ``prog_name`` on the system PATH
    (ref ``find_executable_in_path``, CmdUtils.cc:71-88 — the reference
    shells out to ``which``; ``shutil.which`` is the exact stdlib
    equivalent). Raises :class:`NotFoundErr` when absent."""
    ans = shutil.which(prog_name)
    if not ans:
        raise NotFoundErr(f"Could not find path to {prog_name}")
    return ans


def program_path(prog_name: str, curr_exec_path: str) -> str:
    """Resolve ``prog_name`` next to the running executable (release
    layout), stripping a libtool ``.libs`` component, else fall back to
    the PATH (ref ``program_path``, CmdUtils.cc:51-68)."""
    search_dir = os.path.dirname(os.path.abspath(curr_exec_path))
    if os.path.basename(search_dir) == ".libs":
        search_dir = os.path.dirname(search_dir)
    full_path = os.path.join(search_dir, prog_name)
    if os.path.exists(full_path):
        return full_path
    return find_executable_in_path(prog_name)
