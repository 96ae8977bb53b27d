"""Multi-threaded ordered tile writer (a port of
``visionworkbench_tpu/fileio/tiled_writer.py``; ref ``ThreadedBlockWriter``,
``src/vw/Image/ImageIO.h:116-267``: N rasterize threads ->
OrderedWorkQueue(1) writer, ``CountingSemaphore`` capping in-flight tiles at
``write_pool_size``).

A thread pool evaluates tile functions (typically launching device work and
copying each tile back to the host), and the tiles are committed to disk in
raster order with a bounded window of tiles in flight. The route is chosen
by the arguments alone: without a georeference and a nodata value the
native C++ ordered writer (``visionworkbench_torch/native``) takes the
tiles; with either, a single Python writer thread commits them to a
:class:`~visionworkbench_torch.fileio.tiff.TiffTileWriter`, which writes the
geo tags. An exception in ``tile_fn`` stops the write and reaches the
caller on both routes.
"""

from __future__ import annotations

import heapq
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np

from visionworkbench_torch.core.settings import vw_settings
from visionworkbench_torch.core.progress import ProgressCallback, dummy_progress
from visionworkbench_torch.math.bbox import BBox2i, subdivide_bbox
from visionworkbench_torch.fileio.tiff import T_TILE_OFFSETS, TiffInfo, TiffTileWriter


def resume_completed_tiles(path: str, tile_size: int):
    """Tile indices already present in a partially-written tiled TIFF — the
    checkpoint/resume mechanism (SURVEY.md section 5: every output is a tiled
    file written incrementally; resume = skip tiles already on disk). Returns
    a set of (tx, ty) or an empty set if the file is absent/unreadable, or
    has no IFD yet (a write that failed before its close)."""
    if not os.path.exists(path):
        return set()
    with open(path, "rb") as f:
        head = f.read(8)
    order = "little" if head[:2] == b"II" else "big"
    if len(head) < 8 or not int.from_bytes(head[4:], order):
        return set()
    try:
        info = TiffInfo(path)
    except Exception:
        return set()
    if not info.tiled or info.tile_size[0] != tile_size:
        return set()
    offsets = info._get(T_TILE_OFFSETS, [])
    ntx = -(-info.width // tile_size)
    done = set()
    for i, off in enumerate(offsets):
        if off:
            done.add((i % ntx, i // ntx))
    return done


def block_write_image(path: str, height: int, width: int, bands: int, dtype,
                      tile_fn: Callable[[BBox2i], np.ndarray],
                      tile_size: Optional[int] = None,
                      num_threads: Optional[int] = None,
                      georef=None, nodata: Optional[float] = None,
                      progress: Optional[ProgressCallback] = None) -> None:
    """Rasterize ``tile_fn(bbox) -> (h, w[, C]) array`` over a tile grid with
    worker threads and write tiles in order with bounded memory (ref
    ``block_write_image``, ImageIO.h:150-267, and the GDAL variant
    ``block_write_gdal_image``, Cartography/GeoReferenceUtils.h:163)."""
    settings = vw_settings()
    ts = tile_size or settings.default_tile_size
    ts = max(16, (ts // 16) * 16)
    workers = num_threads or settings.default_num_threads
    window = max(settings.write_pool_size, 1)
    progress = progress or dummy_progress()

    tiles = subdivide_bbox(BBox2i(0, 0, width, height), ts, ts)
    if georef is None and nodata is None:
        _write_native(path, height, width, bands, dtype, tile_fn, tiles, ts,
                      workers, window, progress)
    else:
        _write_python(path, height, width, bands, dtype, tile_fn, tiles, ts,
                      workers, window, georef, nodata, progress)
    progress.report_finished()


def _write_native(path, height, width, bands, dtype, tile_fn, tiles, ts,
                  workers, window, progress) -> None:
    """The native C++ ordered writer: GIL-free IO and in-order commit with
    its own bounded window. The first error aborts the writer, so workers
    blocked on a full window return, and is raised."""
    from visionworkbench_torch.native import NativeTileWriter
    nwriter = NativeTileWriter(path, height, width, bands, dtype, ts, window)
    error: list = []

    def compute(i):
        if error:
            return
        bbox = tiles[i]
        try:
            tile = np.asarray(tile_fn(bbox)).astype(dtype, copy=False)
            nwriter.write_tile(bbox.min_x // ts, bbox.min_y // ts, tile)
            progress.report_progress((i + 1) / len(tiles))
        except BaseException as e:  # raised in the caller's thread below
            error.append(e)
            nwriter.abort()

    with ThreadPoolExecutor(max_workers=workers) as pool:
        for f in [pool.submit(compute, i) for i in range(len(tiles))]:
            f.result()
    if error:
        # Surface the tile function's error, not the writer's
        # incomplete-submission complaint.
        try:
            nwriter.close()
        except OSError:
            pass
        raise error[0]
    nwriter.close()


def _write_python(path, height, width, bands, dtype, tile_fn, tiles, ts,
                  workers, window, georef, nodata, progress) -> None:
    """One Python writer thread commits tiles in raster order to a
    ``TiffTileWriter`` (geo tags, nodata); a semaphore bounds the tiles in
    flight and is released on every path of a tile."""
    writer = TiffTileWriter(path, height, width, bands, dtype, tile_size=ts,
                            georef=georef, nodata=nodata)
    in_flight = threading.Semaphore(window)
    done_heap = []
    heap_lock = threading.Condition()
    next_to_write = [0]
    error: list = []

    def fail(e):
        with heap_lock:
            error.append(e)
            heap_lock.notify_all()
        in_flight.release()

    def write_loop():
        written = 0
        total = len(tiles)
        try:
            while written < total:
                with heap_lock:
                    while not done_heap or done_heap[0][0] != next_to_write[0]:
                        if error:
                            return
                        heap_lock.wait(timeout=0.5)
                    idx, tile = heapq.heappop(done_heap)
                bbox = tiles[idx]
                writer.write_tile(bbox.min_x // ts, bbox.min_y // ts, tile)
                in_flight.release()
                next_to_write[0] += 1
                written += 1
                progress.report_progress(written / total)
        except BaseException as e:  # raised in the caller's thread below
            fail(e)

    def compute(i):
        if error:
            in_flight.release()
            return
        try:
            tile = np.asarray(tile_fn(tiles[i]))
            with heap_lock:
                heapq.heappush(done_heap, (i, tile))
                heap_lock.notify_all()
        except BaseException as e:  # raised in the caller's thread below
            fail(e)

    writer_thread = threading.Thread(target=write_loop)
    writer_thread.start()
    try:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            for i in range(len(tiles)):
                in_flight.acquire()
                if error:
                    break
                pool.submit(compute, i)
    finally:
        writer_thread.join()
        writer.close()
    if error:
        raise error[0]
