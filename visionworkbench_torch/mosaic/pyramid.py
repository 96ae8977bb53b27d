"""On-disk image pyramids (a port of ``visionworkbench_tpu/mosaic/pyramid.py``;
ref ``DiskImagePyramid``, ``src/vw/Mosaic/DiskImagePyramid.h:245-380``):
persist subsampled levels of a huge image; ``get_image_clip(scale,
region)`` serves the best level.

The levels are built on ``device`` (``None`` = the card): the 5-tap
pyramid kernel along x and y with a zero edge, then every other row and
column, level after level on the device; each level is copied back and
written as a tiled TIFF, and read through a :class:`DiskImageView`.
"""

from __future__ import annotations

import math
import os
import tempfile
from typing import List, Optional, Tuple

import numpy as np
import torch

from visionworkbench_torch.core.device import resolve_device
from visionworkbench_torch.core.settings import vw_settings
from visionworkbench_torch.fileio.disk_image import DiskImageView
from visionworkbench_torch.fileio.tiff import write_tiff
from visionworkbench_torch.image.filters import generate_pyramid_smoothing_kernel
from visionworkbench_torch.image.convolution import separable_convolution_filter
from visionworkbench_torch.math.bbox import BBox2i


class DiskImagePyramid:
    def __init__(self, path: str, min_dimension: int = 64,
                 cache_dir: Optional[str] = None, tile_size: int = 256,
                 device=None):
        dev = resolve_device(device)
        self.base = DiskImageView(path, tile_size=tile_size)
        self.cache_dir = cache_dir or tempfile.mkdtemp(
            dir=vw_settings().tmp_directory, prefix="vwtorch_pyr_")
        os.makedirs(self.cache_dir, exist_ok=True)
        self.levels: List[DiskImageView] = [self.base]
        k = generate_pyramid_smoothing_kernel()
        img = torch.as_tensor(self.base.read(), device=dev)
        level = 0
        while min(img.shape[:2]) // 2 >= min_dimension:
            img = separable_convolution_filter(img, k, k, edge="constant")[::2, ::2]
            level += 1
            lvl_path = os.path.join(self.cache_dir, f"level_{level}.tif")
            write_tiff(lvl_path, img.cpu().numpy(), tile_size=max(tile_size, 16))
            self.levels.append(DiskImageView(lvl_path, tile_size=tile_size))

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    def level_for_scale(self, scale: float) -> int:
        """Coarsest level whose resolution still meets ``scale`` (display
        pixels per source pixel, <= 1)."""
        if scale >= 1.0:
            return 0
        level = int(math.floor(-math.log2(max(scale, 1e-9))))
        return min(level, self.num_levels - 1)

    def get_image_clip(self, scale: float, region: BBox2i
                       ) -> Tuple[np.ndarray, int]:
        """Read ``region`` (base-level pixel coords) at roughly ``scale``
        resolution (ref ``get_image_clip``). Returns (array, level)."""
        level = self.level_for_scale(scale)
        f = 1 << level
        view = self.levels[level]
        scaled = BBox2i(region.min_x // f, region.min_y // f,
                        max(region.width // f, 1), max(region.height // f, 1))
        scaled.crop(BBox2i(0, 0, view.cols, view.rows))
        return view.read_region(scaled), level
