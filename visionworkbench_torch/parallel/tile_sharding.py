"""Tile (row-band) sharding with halo exchange (port of
``visionworkbench_tpu/parallel/tile_sharding.py``) on ``torch.distributed``.

The reference recomputes each tile's collar independently
(``CorrelationView.cc:100-230`` pads every tile's pyramid by
``half_kernel * 2^levels``). Over several cards the halo is instead
exchanged (SURVEY.md section 2.14): each rank holds one row band; before an
operation with vertical reach ``halo`` it receives its neighbour bands'
edge rows, computes and crops.

:func:`halo_exchange_rows` sends single-hop neighbour rows with
``batch_isend_irecv`` on the axis's process group (peers mapped to global
ranks); a halo as deep as a band falls back to an all-gather of the bands.
Bool planes travel as ``uint8``. :func:`map_overlap` is the generic
combinator (the analogue of ``BlockRasterizeView`` plus collar);
:func:`sharded_pyramid_correlate` runs the whole coarse-to-fine correlator
on each band plus a collar the size of its receptive field.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from visionworkbench_torch.core.device import as_tensor
from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.math.bbox import BBox2i
from visionworkbench_torch.parallel.mesh import (
    TILE_AXIS, axis_group, mesh_device, row_sharding,
)
from visionworkbench_torch.stereo.correlation import DisparityMap


def _to_wire(x: torch.Tensor) -> torch.Tensor:
    return (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()


def _from_wire(x: torch.Tensor, dtype) -> torch.Tensor:
    return x.to(torch.bool) if dtype == torch.bool else x


def all_gather_rows(block: torch.Tensor, group, n: int) -> torch.Tensor:
    """The bands of all ``n`` ranks of ``group`` stacked by rows, in rank
    order (every band the same shape)."""
    if n == 1:
        return block
    wire = _to_wire(block)
    parts = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(parts, wire, group=group)
    return _from_wire(torch.cat(parts, 0), block.dtype)


def halo_exchange_rows(block: torch.Tensor, halo_top: int, halo_bottom: int,
                       mesh, axis_name: str = TILE_AXIS) -> torch.Tensor:
    """Extend this rank's row band with ``halo_top`` rows of the band above
    and ``halo_bottom`` of the band below along ``axis_name``. Global edges
    receive replicated edge rows, as the monolithic pipeline's
    ``ConstantEdgeExtension``.

    When the halo fits in one band, edge rows go to the neighbours in one
    ``batch_isend_irecv``; a deeper halo (pyramid collars spanning several
    bands) gathers the whole column of bands, which costs the whole frame
    on the wire. Every rank of the axis must call it with the same halos and
    band shape."""
    halo_top, halo_bottom = int(halo_top), int(halo_bottom)
    if halo_top == 0 and halo_bottom == 0:
        return block
    group, n, idx = axis_group(mesh, axis_name)
    hb = block.shape[0]
    wire = _to_wire(block)
    if halo_top < hb and halo_bottom < hb:
        ops, parts = [], []

        def peer(i):
            return dist.get_global_rank(group, i)

        def recv(rows, i):
            buf = wire.new_empty((rows,) + tuple(wire.shape[1:]))
            ops.append(dist.P2POp(dist.irecv, buf, peer(i), group))
            return buf

        if halo_top > 0:
            if idx + 1 < n:
                ops.append(dist.P2POp(dist.isend, wire[hb - halo_top:].contiguous(),
                                      peer(idx + 1), group))
            parts.append(recv(halo_top, idx - 1) if idx > 0
                         else wire[:1].expand((halo_top,) + tuple(wire.shape[1:])))
        parts.append(wire)
        if halo_bottom > 0:
            if idx > 0:
                ops.append(dist.P2POp(dist.isend, wire[:halo_bottom].contiguous(),
                                      peer(idx - 1), group))
            parts.append(recv(halo_bottom, idx + 1) if idx + 1 < n
                         else wire[-1:].expand((halo_bottom,) + tuple(wire.shape[1:])))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return _from_wire(torch.cat(parts, 0), block.dtype)

    # Deep halo: the whole column of bands, edge rows replicated past the
    # global edges, and this band's extended window.
    full = all_gather_rows(wire, group, n)
    rows = torch.arange(idx * hb - halo_top, (idx + 1) * hb + halo_bottom,
                        device=full.device).clamp(0, full.shape[0] - 1)
    return _from_wire(full.index_select(0, rows), block.dtype)


def map_overlap(fn: Callable, image, mesh, halo: int,
                out_channels: Optional[int] = None):
    """Apply ``fn`` to the row bands of ``image`` (the whole (H, W[, C])
    frame, the same on every rank) with ``halo`` rows of overlap exchanged
    over the mesh: ``fn`` maps an (h + 2 halo, W[, C]) band to an output of
    the same rows, whose halo is cropped. Returns the whole output on every
    rank. Equal to ``fn`` on the whole frame when ``fn``'s vertical reach is
    at most ``halo`` (the ``BlockRasterizeView`` tiled == whole guarantee
    that ``TestBlockRasterize.cxx`` checks). ``out_channels`` is accepted
    for the JAX package's signature."""
    dev = mesh_device(mesh)
    image = (image.to(dev) if isinstance(image, torch.Tensor)
             else as_tensor(image, torch.float32, dev))
    group, n, _ = axis_group(mesh, TILE_AXIS)
    if image.shape[0] % n:
        raise ArgumentErr(f"map_overlap: rows {image.shape[0]} must divide "
                          f"over {n} devices")
    band = row_sharding(mesh)(image)
    out = fn(halo_exchange_rows(band, halo, halo, mesh))
    return all_gather_rows(out[halo:out.shape[0] - halo], group, n)


def sharded_pyramid_correlate(left, right, search_region: BBox2i, mesh,
                              collar: Optional[int] = None,
                              **corr_kwargs) -> DisparityMap:
    """Distributed pyramid correlator: row bands over the ranks with collar
    halos. Each rank takes its band plus ``collar`` rows of context from its
    neighbours, runs the whole coarse-to-fine correlator
    (``pyramid_correlate``) on the padded band and keeps its interior rows:
    the distributed form of the reference's per-tile prerasterize with
    collar (``CorrelationView.h:124-133``). The right image is sharded the
    same way and exchanged with ``collar`` plus the vertical search reach,
    so the vertical search stays in the band.

    ``collar`` defaults to the correlator's receptive field: per level its
    half-kernel, cleanup filter and pyramid supports at 2^level spacing,
    plus the level-0 refine window (rounded to a tile multiple when levels
    > 1, so every band's tile grid aligns with the monolithic one).
    ``left``/``right`` are whole frames, the same on every rank; returns the
    whole :class:`DisparityMap` on every rank."""
    from visionworkbench_torch.stereo.pyramid_correlation import (
        max_pyramid_levels_for, pyramid_correlate,
    )
    dev = mesh_device(mesh)
    left = as_tensor(left, torch.float32, dev)
    right = as_tensor(right, torch.float32, dev)
    h, w = left.shape
    group, n, _ = axis_group(mesh, TILE_AXIS)
    if h % n != 0:
        raise ArgumentErr(f"rows {h} must divide over {n} devices")
    if right.shape[0] != h:
        raise ArgumentErr("sharded_pyramid_correlate: left/right must have "
                          "equal heights (fold the search margin into "
                          "search_region instead)")

    kernel_size = corr_kwargs.get("kernel_size", (21, 21))
    max_levels = corr_kwargs.get("max_pyramid_levels", 5)
    tile = int(corr_kwargs.get("tile_size", 32))
    levels = max_pyramid_levels_for(w, h // n, kernel_size, search_region, max_levels)
    corr_kwargs = dict(corr_kwargs, max_pyramid_levels=levels, device=dev)
    if collar is None:
        k_half = max(kernel_size) // 2 + 1
        fhk = int(corr_kwargs.get("filter_half_kernel", 5))
        per_level = k_half + fhk + 4
        collar = (((1 << levels) - 1) * per_level
                  + int(corr_kwargs.get("refine_window", 11)) + k_half)
    if levels > 1:
        collar = -(-collar // tile) * tile
    if (h // n) % tile != 0:
        raise ArgumentErr(f"band height {h // n} must be a multiple of "
                          f"tile_size {tile} for grid-aligned sharding")
    s_h, smin_y = int(search_region.height), int(search_region.min_y)
    extra_top = max(-smin_y, 0)
    extra_bot = max(smin_y + s_h, 0)
    # In a band the right frame starts extra_top rows above the left one,
    # so the local search window starts extra_top rows lower.
    local_sr = BBox2i(int(search_region.min_x), smin_y + extra_top,
                      int(search_region.width), s_h)

    band = row_sharding(mesh)
    lpad = halo_exchange_rows(band(left), collar, collar, mesh)
    rpad = halo_exchange_rows(band(right), collar + extra_top, collar + extra_bot, mesh)
    dm = pyramid_correlate(lpad, rpad, local_sr, **corr_kwargs)
    lo, hi = collar, lpad.shape[0] - collar
    valid = dm.valid[lo:hi]
    disp = dm.disparity[lo:hi] - torch.tensor([0, extra_top], dtype=dm.disparity.dtype,
                                               device=dev)
    disp = torch.where(valid[..., None], disp, torch.zeros_like(disp))
    return DisparityMap(all_gather_rows(disp, group, n), all_gather_rows(valid, group, n))
