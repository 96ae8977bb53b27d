"""Device meshes for tile and disparity sharding (port of
``visionworkbench_tpu/parallel/mesh.py``) on ``torch.distributed``.

The reference's only parallelism is a thread pool pulling image tiles off a
shared cursor (``src/vw/Image/BlockProcessor.h:52-176``). Here, as in the
JAX package, it is a mesh: the ``"tile"`` axis distributes image row bands
(data parallelism over the scene), the ``"disp"`` axis the disparity search
range of a cost volume (SURVEY.md section 2.14). The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with one process (rank) per
card.

The caller initializes the default process group first, as the JAX
package's caller calls ``jax.distributed.initialize``: on cards
``torch.distributed.init_process_group("cpu:gloo,cuda:nccl", ...)`` (or a
``torchrun`` launch), on the CPU ``"gloo"``. These helpers lay a mesh over
that whole world and raise when there is none. ``device=None`` means the
card (``cuda``, the rank's current device); ``device="cpu"`` a CPU mesh.

Inputs of the sharded entry points are whole frames, the same on every
rank; each rank works on its own row band (:func:`row_sharding`) and every
rank gets the whole result back (the JAX package returns a global array
sharded by rows).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from visionworkbench_torch.core.device import resolve_device
from visionworkbench_torch.core.exceptions import ArgumentErr

TILE_AXIS = "tile"
DISP_AXIS = "disp"


def _world(n_devices: Optional[int], what: str) -> int:
    """The default group's world size; raises without a process group, or
    when ``n_devices`` asks for another size (a mesh spans the world)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise ArgumentErr(f"{what}: no process group is initialized; call "
                          "torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ArgumentErr(f"{what}: n_devices={n_devices}, but a mesh spans "
                          f"the whole world of {world} ranks")
    return world


def _mesh(shape, names, device):
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(names))


def make_tile_mesh(n_devices: Optional[int] = None, device=None):
    """1-D mesh over the ``tile`` axis (image row bands)."""
    world = _world(n_devices, "make_tile_mesh")
    return _mesh((world,), (TILE_AXIS,), device)


def make_disp_mesh(n_devices: Optional[int] = None, device=None):
    """1-D mesh over the ``disp`` axis (disparity-range shards)."""
    world = _world(n_devices, "make_disp_mesh")
    return _mesh((world,), (DISP_AXIS,), device)


def make_tile_disp_mesh(tile: int, disp: int, device=None):
    """2-D mesh: row bands x disparity shards (row-major over the ranks:
    rank r has tile index r // disp and disp index r % disp)."""
    world = _world(None, "make_tile_disp_mesh")
    if int(tile) * int(disp) != world:
        raise ArgumentErr(f"make_tile_disp_mesh: {tile} x {disp} ranks, but "
                          f"the world has {world}")
    return _mesh((int(tile), int(disp)), (TILE_AXIS, DISP_AXIS), device)


def mesh_device(mesh) -> torch.device:
    """The device this rank computes on: its current card for a ``cuda``
    mesh, else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_group(mesh, axis: str):
    """``(group, size, index)``: the process group along ``axis`` that
    holds this rank, its size and this rank's index in it."""
    if axis not in (mesh.mesh_dim_names or ()):
        raise ArgumentErr(f"mesh has no {axis!r} axis (axes "
                          f"{mesh.mesh_dim_names})")
    group = mesh.get_group(axis)
    return group, dist.get_world_size(group), mesh.get_local_rank(axis)


class RowSharding(NamedTuple):
    """This rank's row band along the tile axis: ``index`` of ``size``
    bands. Call it on an (H, W[, C]) frame for the band's rows."""
    index: int
    size: int

    def bounds(self, h: int):
        """``(start, stop)`` rows of this rank's band of ``h`` rows; raises
        unless ``h`` divides over the bands."""
        if h % self.size:
            raise ArgumentErr(f"rows {h} must divide over {self.size} bands")
        hb = h // self.size
        return self.index * hb, (self.index + 1) * hb

    def __call__(self, frame):
        start, stop = self.bounds(frame.shape[0])
        return frame[start:stop]


def row_sharding(mesh, axis: str = TILE_AXIS) -> RowSharding:
    """Shard an (H, W[, C]) frame by rows over the tile axis: the JAX
    package's ``NamedSharding(mesh, P("tile"))`` as this rank's band."""
    _, n, idx = axis_group(mesh, axis)
    return RowSharding(idx, n)
