"""Quadtree tile pyramid generation (port of
``visionworkbench_tpu/mosaic/quadtree.py``; ref ``QuadTreeGenerator``,
``src/vw/Mosaic/QuadTreeGenerator.h:72-260`` / ``QuadTreeGenerator.cc``;
KML super-overlays ``KMLQuadTreeConfig.cc``).

Renders a view as a directory tree of tiles: level 0 is the whole image in
one tile, each deeper level doubles resolution and subdivides 2x2. Naming,
tile IO, and per-tile metadata are pluggable like the reference's
``image_path_func`` / ``tile_resource_func`` / metadata functors.
"""

from __future__ import annotations

import math
import os
from typing import Callable, List, Optional, Tuple

import numpy as np

from visionworkbench_torch.fileio.image_io import write_image
from visionworkbench_torch.image.transform import resample
from visionworkbench_torch.math.bbox import BBox2


def default_image_path(name: str, level: int, x: int, y: int,
                       ext: str = ".png") -> str:
    """Slippy-map style {name}/{level}/{x}/{y}{ext}
    (the reference's default is a nested quadrant path; level/x/y is the
    modern equivalent and what its "web map" output mode produces)."""
    return os.path.join(name, str(level), str(x), f"{y}{ext}")


class QuadTreeGenerator:
    def __init__(self, image, name: str, tile_size: int = 256,
                 image_path_func: Callable = default_image_path,
                 file_type: str = ".png",
                 metadata_func: Optional[Callable] = None, device=None):
        self.image = np.asarray(image, np.float32)
        self.device = device
        self.name = name
        self.tile_size = int(tile_size)
        self.image_path_func = image_path_func
        self.file_type = file_type
        self.metadata_func = metadata_func
        h, w = self.image.shape[:2]
        self.tree_levels = max(int(math.ceil(math.log2(
            max(max(h, w) / self.tile_size, 1)))), 0) + 1

    def generate(self, progress=None) -> List[Tuple[int, int, int, str]]:
        """Write all tiles; returns [(level, x, y, path)]. Builds from the
        finest level down, downsampling 2x2 children into parents (the
        reference's ``Processor::generate`` recursion, bottom-up)."""
        ts = self.tile_size
        h, w = self.image.shape[:2]
        written = []
        finest = self.tree_levels - 1
        # Pad the finest level to a tile multiple.
        full = 1 << finest
        ph, pw = full * ts, full * ts
        canvas = np.zeros((ph, pw) + self.image.shape[2:], np.float32)
        canvas[:h, :w] = self.image
        level_img = canvas
        for level in range(finest, -1, -1):
            n = 1 << level
            for ty in range(n):
                for tx in range(n):
                    tile = level_img[ty * ts:(ty + 1) * ts, tx * ts:(tx + 1) * ts]
                    if not np.any(tile):
                        continue
                    path = self.image_path_func(self.name, level, tx, ty,
                                                self.file_type)
                    os.makedirs(os.path.dirname(path), exist_ok=True)
                    write_image(path, tile)
                    written.append((level, tx, ty, path))
                    if self.metadata_func is not None:
                        self.metadata_func(self, level, tx, ty, path)
            if level > 0:
                # the 2x downsample on ``device`` (None = the card), the
                # tiles written from the host
                level_img = resample(level_img, 0.5, 0.5,
                                     device=self.device).cpu().numpy()
        return written


def write_kml_superoverlay(name: str, lonlat_bbox: BBox2, tiles,
                           tile_size: int = 256,
                           max_lod_pixels: int = 512) -> str:
    """Master KML + per-tile region LODs
    (ref ``KMLQuadTreeConfig``, KMLQuadTreeConfig.cc). Returns the KML path."""
    west, south = lonlat_bbox.min_x, lonlat_bbox.min_y
    east, north = lonlat_bbox.max_x, lonlat_bbox.max_y

    def tile_box(level, tx, ty):
        n = 1 << level
        dw = (east - west) / n
        dh = (north - south) / n
        return (west + tx * dw, north - (ty + 1) * dh,
                west + (tx + 1) * dw, north - ty * dh)

    parts = ['<?xml version="1.0" encoding="UTF-8"?>',
             '<kml xmlns="http://www.opengis.net/kml/2.2">', "<Document>",
             f"<name>{os.path.basename(name)}</name>"]
    for level, tx, ty, path in tiles:
        w, s, e, n = tile_box(level, tx, ty)
        rel = os.path.relpath(path, os.path.dirname(name) or ".")
        parts.append(
            "<GroundOverlay>"
            f"<drawOrder>{level}</drawOrder>"
            "<Region><LatLonAltBox>"
            f"<north>{n}</north><south>{s}</south>"
            f"<east>{e}</east><west>{w}</west>"
            "</LatLonAltBox><Lod>"
            f"<minLodPixels>{tile_size // 4}</minLodPixels>"
            f"<maxLodPixels>{-1 if level == 0 else max_lod_pixels}</maxLodPixels>"
            "</Lod></Region>"
            f"<Icon><href>{rel}</href></Icon>"
            "<LatLonBox>"
            f"<north>{n}</north><south>{s}</south>"
            f"<east>{e}</east><west>{w}</west>"
            "</LatLonBox></GroundOverlay>")
    parts += ["</Document>", "</kml>"]
    kml_path = name + ".kml"
    os.makedirs(os.path.dirname(kml_path) or ".", exist_ok=True)
    with open(kml_path, "w") as f:
        f.write("\n".join(parts))
    return kml_path
