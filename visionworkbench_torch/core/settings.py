"""Global runtime settings (a copy of ``visionworkbench_tpu/core/settings.py``,
which imports no JAX).

Analogue of the reference's ``vw::Settings`` singleton
(``src/vw/Core/Settings.h:50-104``, defaults ``Settings.cc:179-187``). The
fields, their defaults and the rc file are the system's, shared with the
JAX package: the device-memory and shard knobs keep their names
(``hbm_budget_bytes``, ``shard_tile_size``). A ``~/.vwtpurc`` (or
``$VWTPU_RC``) key=value file is honoured, mirroring the reference's ``.vwrc``
(parsed by ``src/vw/Core/ConfigParser.cc``); unlike the reference we do not
re-poll it every 5 s — call :func:`reload_config` explicitly.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import threading
from typing import Optional


@dataclasses.dataclass
class Settings:
    # Tiling (ref default_tile_size, Settings.cc:183; the correlate tool uses
    # 1024 px output tiles, tools/correlate.cc:266).
    default_tile_size: int = 256

    # Host-side worker threads for IO / tile writing (ref default_num_threads=4,
    # src/CMakeLists.txt:27). Device parallelism comes from the card.
    default_num_threads: int = 4

    # Host LRU cache budget in bytes for regenerable tiles
    # (ref system_cache_size = 768 MB, Settings.cc:181).
    system_cache_size: int = 768 * 1024 * 1024

    # Bounded in-flight window for the ordered tile writer
    # (ref write_pool_size = 21 tiles, Settings.cc:182).
    write_pool_size: int = 21

    # Temporary-file directory (ref tmp_directory).
    tmp_directory: str = dataclasses.field(default_factory=tempfile.gettempdir)

    # --- device knobs (no reference analogue) ---
    # Device-memory budget per card for cost volumes; above this the
    # disparity axis is sharded across the mesh (analogue of SGM
    # m_memory_limit_mb, SGM.h:167).
    hbm_budget_bytes: int = 12 * 1024 * 1024 * 1024
    # Preferred shard tile edge for distributed image grids.
    shard_tile_size: int = 1024

    def set_default_num_threads(self, n: int) -> None:
        self.default_num_threads = int(n)

    def set_default_tile_size(self, s: int) -> None:
        self.default_tile_size = int(s)

    def set_system_cache_size(self, s: int) -> None:
        self.system_cache_size = int(s)


_settings: Optional[Settings] = None
_lock = threading.Lock()

_INT_KEYS = {
    "default_tile_size",
    "default_num_threads",
    "system_cache_size",
    "write_pool_size",
    "hbm_budget_bytes",
    "shard_tile_size",
}
_STR_KEYS = {"tmp_directory"}


def _rc_path() -> str:
    return os.environ.get("VWTPU_RC", os.path.join(os.path.expanduser("~"), ".vwtpurc"))


def _parse_rc(settings: Settings, path: str) -> None:
    """Parse a ``key = value`` config file (``#`` comments, ``[section]`` headers
    ignored) — the shape of the reference's ``.vwrc`` general section."""
    try:
        with open(path, "r") as f:
            lines = f.readlines()
    except OSError:
        return
    for line in lines:
        line = line.split("#", 1)[0].strip()
        if not line or line.startswith("["):
            continue
        if "=" not in line:
            continue
        key, _, value = line.partition("=")
        key, value = key.strip(), value.strip()
        if key in _INT_KEYS:
            try:
                setattr(settings, key, int(value))
            except ValueError:
                pass
        elif key in _STR_KEYS:
            setattr(settings, key, value)


def vw_settings() -> Settings:
    """Return the global settings singleton (ref ``vw_settings()``, System.cc:14-50)."""
    global _settings
    if _settings is None:
        with _lock:
            if _settings is None:
                s = Settings()
                _parse_rc(s, _rc_path())
                _settings = s
    return _settings


def reload_config(path: Optional[str] = None) -> None:
    """Re-read the rc file into the live settings object."""
    _parse_rc(vw_settings(), path or _rc_path())
