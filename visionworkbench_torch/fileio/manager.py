"""Bounded pool of open image views (a copy of
``visionworkbench_tpu/fileio/manager.py``; ref ``DiskImageManager``,
``src/vw/FileIO/DiskImageManager.h:44-208``): many-image mosaics keep at most
N views resident, evicting least-recently-used handles."""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional

from visionworkbench_torch.fileio.disk_image import DiskImageView


class DiskImageManager:
    def __init__(self, max_open: int = 128, tile_size: Optional[int] = None):
        self.max_open = int(max_open)
        self.tile_size = tile_size
        self._views: "OrderedDict[str, DiskImageView]" = OrderedDict()
        self._lock = threading.Lock()
        self.evictions = 0

    def get(self, path: str) -> DiskImageView:
        with self._lock:
            if path in self._views:
                self._views.move_to_end(path)
                return self._views[path]
        view = DiskImageView(path, tile_size=self.tile_size)
        with self._lock:
            self._views[path] = view
            self._views.move_to_end(path)
            while len(self._views) > self.max_open:
                self._views.popitem(last=False)
                self.evictions += 1
        return view

    def __len__(self) -> int:
        with self._lock:
            return len(self._views)
