"""Disparity-axis sharding of the correlation cost volume (port of
``visionworkbench_tpu/parallel/disparity_sharding.py``) on
``torch.distributed``.

When the (dx, dy) search volume is too large for one card, the range is
split over the mesh's ``disp`` axis: each rank scans its contiguous slab of
dy rows with the whole-frame sweep (on the card the CUDA sweep kernel of
``ops/sweep.py``, the engine of ``best_of_search_convolution``; on the CPU
its plain version), then the slabs are all-gathered and merged in slab
order (SURVEY.md section 2.14; the reference's sequential loop is
``Correlation.cc:62-119``).

The merge is exact: the reference's sequential rule (strict-improve best,
else update worst) reduces to best = min over the costs, worst = max and
arg = the first index achieving best, all associative under an ordered
merge. So the lowest slab wins ties, and a pixel is invalid (flat) only
where every slab is flat and every slab's best is equal. For NCC, a max
metric, a NaN best (a zero-energy window) counts as greater than any
number, as in the whole-frame sweep: the first NaN slab wins.
"""

from __future__ import annotations

import torch

from visionworkbench_torch.core.device import as_tensor
from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.parallel.mesh import DISP_AXIS, axis_group, mesh_device
from visionworkbench_torch.parallel.tile_sharding import all_gather_rows
from visionworkbench_torch.stereo.correlation import (
    ABSOLUTE_DIFFERENCE, CROSS_CORRELATION, DisparityMap,
)


def disparity_sharded_search(left, right, search_volume, kernel_size, mesh,
                             cost_type: str = ABSOLUTE_DIFFERENCE,
                             census_window: int = 5) -> DisparityMap:
    """Disparity-sharded ``best_of_search_convolution``.

    Shapes follow the single-device contract: ``left`` (H, W), ``right``
    (H+sy-1, W+sx-1), whole frames on every rank. The y range ``sy`` is
    split evenly over the mesh's ``disp`` axis (slabs of search rows keep
    each slab's right-image rows contiguous); sy must divide by the axis
    size. Census codes are computed over each slab's rows, as the JAX
    package's slabs compute them. Returns the whole map on every rank."""
    from visionworkbench_torch.ops.sweep import search_frame
    sx, sy = int(search_volume[0]), int(search_volume[1])
    kw, kh = int(kernel_size[0]), int(kernel_size[1])
    group, n, k = axis_group(mesh, DISP_AXIS)
    if sy % n != 0:
        raise ArgumentErr(f"disparity_sharded_search: sy={sy} must divide over "
                          f"{n} devices")
    sy_local = sy // n
    dev = mesh_device(mesh)
    left = as_tensor(left, torch.float32, dev)
    right = as_tensor(right, torch.float32, dev)
    h, w = left.shape
    if tuple(right.shape) != (h + sy - 1, w + sx - 1):
        raise ArgumentErr("right must be (H+sy-1, W+sx-1)")
    dy0 = k * sy_local
    r_local = right[dy0:dy0 + h + sy_local - 1]
    disp, valid, best = search_frame(left, r_local, sx, sy_local, kw, kh,
                                     cost_type, int(census_window), want_best=True)

    def gather(x):
        return all_gather_rows(x.contiguous()[None], group, n)   # (n, h', w'[, 2])

    all_best, all_disp, all_valid = gather(best), gather(disp), gather(valid)
    if cost_type == CROSS_CORRELATION:
        nan = all_best.isnan()
        gbest = torch.where(nan, -torch.inf, all_best).amax(0)
        win = torch.where(nan.any(0), nan, all_best == gbest)
    else:
        win = all_best == all_best.amin(0)
    # the first slab (lowest dy) achieving the global best wins ties
    slab = torch.argmax(win.to(torch.uint8), 0)
    sel = torch.gather(all_disp, 0, slab[None, ..., None].expand(1, *slab.shape, 2)
                       .long())[0]
    sel = sel + torch.stack([torch.zeros_like(slab), slab * sy_local], -1).to(sel.dtype)
    # flat only where every slab is flat and every slab's best is equal
    gvalid = ~((~all_valid).all(0) & (all_best == all_best[:1]).all(0))
    sel = torch.where(gvalid[..., None], sel, torch.zeros_like(sel))
    return DisparityMap(sel, gvalid)
