"""Multi-image cartographic reprojection + mosaic compositing (port of
``visionworkbench_tpu/mosaic/geomosaic.py``; ref the
``image2qtree``/``geoblend`` pipeline: per-source ``transform(src,
GeoTransform(src_georef, out_georef))`` warps composited by
``ImageComposite`` multiband blending — ``src/vw/tools/geoblend.cc:62-180``,
``src/vw/Mosaic/ImageComposite.h:53-592``; the repo's config 5).

The reverse maps are evaluated on coarse host grids with the
``ApproximateTransform`` error bound (``Transform.h:142-238``), in fp32
torch on the CPU in the JAX package's order of operations (so the grids
equal the JAX package's). Everything a plan implies for a source shape —
the warp coordinates on the device, the validity mask and its grassfire
alpha (host NumPy, as the JAX package computes them at trace time) — is
made once and kept on the plan; each frame then warps and blends on the
card. With a ``mesh`` (``parallel/mesh.py``: one rank a card) the canvas
rows are sharded as the JAX package's GSPMD row sharding: each rank warps
its own band of every source, the bands are all-gathered and every rank
blends the whole canvas, equal bit for bit to ``mesh=None``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from visionworkbench_torch.cartography.georeference import GeoReference
from visionworkbench_torch.cartography.geotransform import GeoTransform
from visionworkbench_torch.core.device import as_tensor, resolve_device
from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.image.morphology import grassfire_np
from visionworkbench_torch.image.transform import (
    grid_coords, reverse_map_grid, warp_with,
)
from visionworkbench_torch.mosaic.composite import multiband_blend


def _host_interp_grid(sx_g, sy_g, step: int, out_shape):
    """NumPy twin of ``interp_map_grid`` for mask planning (a copy of the
    JAX package's): bilinear upsample of the coarse reverse-map grids to
    per-pixel coordinates, in float64, rounded to fp32."""
    oh, ow = int(out_shape[0]), int(out_shape[1])

    def up(g):
        g = np.asarray(g, np.float64)
        fy = np.arange(oh) / step
        fx = np.arange(ow) / step
        ky = np.clip(np.floor(fy).astype(int), 0, g.shape[0] - 2)
        kx = np.clip(np.floor(fx).astype(int), 0, g.shape[1] - 2)
        ty = (fy - ky)[:, None]
        tx = (fx - kx)[None, :]
        return ((1 - ty) * (1 - tx) * g[np.ix_(ky, kx)]
                + (1 - ty) * tx * g[np.ix_(ky, kx + 1)]
                + ty * (1 - tx) * g[np.ix_(ky + 1, kx)]
                + ty * tx * g[np.ix_(ky + 1, kx + 1)]).astype(np.float32)

    return up(sx_g), up(sy_g)


class ReprojectPlan(tuple):
    """One source's reverse-map grid dst pixel -> src pixel: unpacks as
    ``(sx_g, sy_g, step)``. :meth:`prepare` makes what a frame needs from
    it once per (source shape, output shape, interp, device)."""

    def __new__(cls, sx_g, sy_g, step):
        plan = super().__new__(cls, (np.asarray(sx_g), np.asarray(sy_g), int(step)))
        plan._prepared = {}
        return plan

    def prepare(self, src_shape, out_shape, interp: str, device):
        """``(coords, mask, alpha)`` on ``device``: :func:`grid_coords`' warp
        coordinates, the source's validity mask on the output grid (host
        float64 coordinates inside ``[0, size - 1]``) and its grassfire
        alpha (fp32)."""
        h, w = int(src_shape[0]), int(src_shape[1])
        oh, ow = int(out_shape[0]), int(out_shape[1])
        dev = torch.device(device)
        key = (h, w, oh, ow, interp, str(dev))
        if key not in self._prepared:
            sx_g, sy_g, step = self
            sx, sy = _host_interp_grid(sx_g, sy_g, step, (oh, ow))
            mask = (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)
            alpha = grassfire_np(mask).astype(np.float32)
            self._prepared[key] = (
                grid_coords(sx_g, sy_g, step, (oh, ow), interp, dev),
                as_tensor(mask, torch.bool, dev), as_tensor(alpha, torch.float32, dev))
        return self._prepared[key]


def plan_reproject_grids(src_georefs: List[GeoReference],
                         dst_georef: GeoReference,
                         out_shape: Tuple[int, int],
                         grid_step: int = 16, tolerance: float = 0.5):
    """Host phase: per-source reverse-map grids dst pixel -> src pixel
    (``GeoTransform.reverse`` through the ``ApproximateTransform`` error
    bound, fp32 on the CPU). Returns a list of :class:`ReprojectPlan`
    (each unpacks as ``(sx_g, sy_g, step)``)."""
    plans = []
    for g in src_georefs:
        tx = GeoTransform(g, dst_georef)

        def rev(x, y, _tx=tx):
            sx, sy = _tx.reverse(np.asarray(x, np.float64),
                                 np.asarray(y, np.float64))
            return np.asarray(sx, np.float64), np.asarray(sy, np.float64)

        plans.append(ReprojectPlan(*reverse_map_grid(rev, out_shape, grid_step,
                                                     tolerance)))
    return plans


def reproject_mosaic(srcs, src_georefs: List[GeoReference],
                     dst_georef: GeoReference, out_shape: Tuple[int, int],
                     levels: Optional[int] = None, interp: str = "bilinear",
                     grid_step: int = 16, tolerance: float = 0.5,
                     mesh=None, plans=None, device=None):
    """Reproject every source into ``dst_georef``'s grid and multiband-blend
    (the repo's config 5: multi-image warp + mosaic compositing with
    cartographic reprojection). ``plans`` from :func:`plan_reproject_grids`
    (or ``(sx_g, sy_g, step)`` tuples) are made here when not given; pass
    the same plans to every frame so their per-source work is done once.
    Sources that are tensors keep their device; arrays go to ``device``
    (``None`` = the card). With a ``mesh`` (a ``parallel.make_tile_mesh``
    over the process group; the sources the same on every rank) they go to
    the mesh's device, each rank warps its own band of canvas rows (bands of
    ``ceil(H / ranks)`` rows, the last one short), the warped bands are
    all-gathered, and every rank blends the whole canvas: the same mosaic,
    bit for bit, as ``mesh=None``. The masks and alphas are the plans', made
    on every rank from the host grids. Returns ``(mosaic (H, W), valid (H,
    W))`` (on every rank).
    """
    if len(srcs) != len(src_georefs) or not srcs:
        raise ArgumentErr("reproject_mosaic: need equal non-empty src lists")
    oh, ow = int(out_shape[0]), int(out_shape[1])
    if plans is None:
        plans = plan_reproject_grids(src_georefs, dst_georef, (oh, ow),
                                     grid_step, tolerance)
    plans = [p if isinstance(p, ReprojectPlan) else ReprojectPlan(*p) for p in plans]
    if mesh is not None:
        from visionworkbench_torch.parallel.mesh import TILE_AXIS, axis_group, mesh_device
        from visionworkbench_torch.parallel.tile_sharding import all_gather_rows
        dev = mesh_device(mesh)
        group, n, idx = axis_group(mesh, TILE_AXIS)
    else:
        dev = srcs[0].device if isinstance(srcs[0], torch.Tensor) else resolve_device(device)
        n, idx = 1, 0
    hb = -(-oh // n)
    r0, r1 = min(idx * hb, oh), min((idx + 1) * hb, oh)
    warped, masks, alphas = [], [], []
    for src, plan in zip(srcs, plans):
        src = as_tensor(src, torch.float32, dev)
        coords, mask, alpha = plan.prepare(src.shape, (oh, ow), interp, dev)
        if mesh is None:
            warped.append(warp_with(src, coords, interp=interp, edge="zero"))
        else:
            band = warp_with(src, _band_coords(coords, r0, r1), interp=interp, edge="zero")
            band = torch.cat([band, band.new_zeros((hb - (r1 - r0),) + band.shape[1:])])
            warped.append(all_gather_rows(band, group, n)[:oh])
        masks.append(mask)
        alphas.append(alpha)
    return multiband_blend(warped, masks, levels=levels, alphas=alphas)


def _band_coords(coords, r0: int, r1: int):
    """:func:`grid_coords`' coordinates of canvas rows ``r0 .. r1 - 1``:
    the per-row ones on the 1-D route, the per-pixel rows on the 2-D one."""
    route, sx, sy = coords
    if route == "separable":
        return route, sx, sy[r0:r1]
    return route, sx[r0:r1], sy[r0:r1]
