"""Geometric transform views — reverse-mapping warps (port of
``visionworkbench_tpu/image/transform.py``; ref
``src/vw/Image/Transform.h:336-570``, ``ImageTransform.h``).

``transform()`` evaluates the destination grid, maps it through the
transform's ``reverse`` and samples the source with
:func:`~visionworkbench_torch.image.interpolation.interpolate` on an
edge-extended copy: one gather per tap. ``transform_grid`` is the
reference's ``ApproximateTransform`` (``Transform.h:142-238``): the reverse
map is evaluated on a coarse host grid (:func:`reverse_map_grid`) and
interpolated to every pixel on the device.

The JAX package reaches the same taps through TPU formulations (banded
matmuls, a shifted-slice band sampler) that avoid gathers on that chip. The
port computes the taps directly. What stays is the choice of coordinates
in :func:`warp_from_grid`: a map whose host grid is axis-separable takes
1-D coordinates from the grid's first row and column and samples as a
gather of rows, then of columns; any other map bilinearly upsamples the
2-D grid. The two differ by up to ~1e-4 px where a map is only nearly
separable, so the port keeps the JAX package's host predicate
(:func:`warp_route`).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from visionworkbench_torch.core.device import as_f32, as_tensor, on_device, resolve_device
from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.image.edge import edge_extend
from visionworkbench_torch.image.interpolation import interpolate, pixel_buffer
from visionworkbench_torch.math.bbox import BBox2, BBox2i
from visionworkbench_torch.math.transform2d import (
    ResampleTransform, RotateTransform, Transform2D, TranslateTransform,
)

# Taps of each interpolation kernel relative to the base index floor(s)
# (floor(s + 0.5) for nearest).
_TAPS = {
    "nearest": (0, 0),
    "bilinear": (0, 1),
    "bicubic": (-1, 2),
}
# A grid whose band of displacements covers more shifts than this is tested
# for separability (below it the JAX package's banded sampler, which uses
# the 2-D coordinates, always wins).
_SEP_MIN_AREA = 64


def _dest_grid(h: int, w: int, device):
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(h, w)
    return xs, ys


def _inside(sx, sy, h: int, w: int, buf: int):
    return (sx > -buf) & (sx < w - 1 + buf) & (sy > -buf) & (sy < h - 1 + buf)


def transform(src, tx, out_shape: Optional[Tuple[int, int]] = None,
              interp: str = "bilinear", edge: str = "zero",
              edge_value: float = 0.0, device=None):
    """Warp ``src`` (H, W[, C]) by ``tx`` (a :class:`Transform2D` or a
    callable ``reverse(x, y) -> (sx, sy)`` on tensors) via reverse mapping
    (ref ``transform()``, Transform.h:485-540).

    Output pixel (x, y) samples the source at ``tx.reverse(x, y)``.
    ``out_shape`` defaults to the source shape. Runs on ``src``'s device
    when it is a tensor, else on ``device`` (``None`` = the card).
    """
    src = on_device(src, device)
    if out_shape is None:
        out_shape = (src.shape[0], src.shape[1])
    oh, ow = int(out_shape[0]), int(out_shape[1])
    reverse = tx.reverse if isinstance(tx, Transform2D) else tx
    xs, ys = _dest_grid(oh, ow, src.device)
    sx, sy = reverse(xs, ys)
    return sample(src, sx, sy, interp=interp, edge=edge, edge_value=edge_value)


def sample(src, sx, sy, interp: str = "bilinear", edge: str = "zero",
           edge_value: float = 0.0, device=None):
    """Sample ``src`` at float source coordinates with edge policy: the
    composition ``interpolate(edge_extend(src))`` from the reference."""
    src = on_device(src, device)
    sx = as_f32(sx).to(src.device)
    sy = as_f32(sy).to(src.device)
    buf = pixel_buffer(interp) + 1
    padded = edge_extend(src, x_pad=buf, y_pad=buf, mode=edge, value=edge_value)
    out = interpolate(padded, sx + buf, sy + buf, interp)
    if edge in ("zero", "value"):
        # Beyond-buffer coordinates must keep returning the fill value, not a
        # clamped border sample.
        inside = _inside(sx, sy, src.shape[0], src.shape[1], buf)
        if out.ndim == 3:
            inside = inside[..., None]
        out = torch.where(inside, out, 0.0 if edge == "zero" else edge_value)
    return out


def _axis_taps(s, n: int, interp: str, buf: int):
    """``(base, [(tap, weight)])`` of an axis: the clamped base index of
    each output position and the kernel's taps and weights (the bicubic
    weights carry their global 1/4 as 1/2 per axis)."""
    if interp == "nearest":
        b = torch.floor(s + 0.5)
        taps = [(0, None)]
    else:
        b = torch.floor(s)
        f = s - b
        if interp == "bilinear":
            taps = [(0, 1.0 - f), (1, f)]
        else:  # Catmull-Rom (Interpolation.h:155-158)
            s0 = ((2 - f) * f - 1) * f
            s1 = (3 * f - 5) * f * f + 2
            s2 = ((4 - 3 * f) * f + 1) * f
            s3 = (f - 1) * f * f
            taps = [(-1, s0 * 0.5), (0, s1 * 0.5), (1, s2 * 0.5), (2, s3 * 0.5)]
    base = torch.clamp(b, -buf, n - 1 + buf).to(torch.int64)
    return base, taps


def _gather_axis(x, axis: int, taps):
    """``sum_t w_t * x[index_t]`` along ``axis`` (0 or 1) over ``taps``
    ``[(index_t, w_t)]`` in order, each a multiply and an add of its own;
    ``w_t`` a weight per output position, one float for all, or None (the
    sample itself)."""
    out = None
    for idx, w in taps:
        term = x.index_select(axis, idx)
        if isinstance(w, float):
            term = w * term
        elif w is not None:
            shape = [1] * x.ndim
            shape[axis] = -1
            term = w.reshape(shape) * term
        out = term if out is None else out + term
    return out


def _sample_separable(src, sx1, sy1, interp: str = "bilinear", edge: str = "zero"):
    """Axis-separable warp: ``sx1`` (ow,) source x per output column, ``sy1``
    (oh,) source y per output row; a gather of rows, then of columns, with
    the taps and weights of :func:`sample` (exact separable kernels).
    ``src`` is (H, W, ...): trailing axes are carried along. ``zero`` and
    ``value`` edges fill with 0 (the warps that reach it take no fill
    value)."""
    if interp not in _TAPS:
        raise ArgumentErr(f"_sample_separable: unknown interp {interp!r}")
    h, w = src.shape[0], src.shape[1]
    buf = pixel_buffer(interp) + 1
    by, ty = _axis_taps(sy1, h, interp, buf)
    bx, tx = _axis_taps(sx1, w, interp, buf)
    if edge == "constant":
        # replicate: clamping the index reads the edge-extended image
        padded = src
        rows = [(torch.clamp(by + t, 0, h - 1), wt) for t, wt in ty]
        cols = [(torch.clamp(bx + t, 0, w - 1), wt) for t, wt in tx]
    else:
        pad = buf + 2
        padded = edge_extend(src, x_pad=pad, y_pad=pad, mode=edge, value=0.0)
        rows = [(by + (t + pad), wt) for t, wt in ty]
        cols = [(bx + (t + pad), wt) for t, wt in tx]
    out = _gather_axis(_gather_axis(padded, 0, rows), 1, cols)
    if edge in ("zero", "value"):
        inside = (((sx1 > -buf) & (sx1 < w - 1 + buf))[None, :]
                  & ((sy1 > -buf) & (sy1 < h - 1 + buf))[:, None])
        inside = inside.reshape(inside.shape + (1,) * (out.ndim - 2))
        out = torch.where(inside, out, 0.0)
    return out


def resample(src, xfactor: float, yfactor: Optional[float] = None,
             interp: str = "bilinear", edge: str = "constant", device=None):
    """Scale by a (possibly fractional) factor (ref ``resample``,
    Transform.h:545): output size = ceil(size * factor)."""
    if yfactor is None:
        yfactor = xfactor
    h, w = src.shape[0], src.shape[1]
    out_shape = (int(np.ceil(h * yfactor)), int(np.ceil(w * xfactor)))
    return transform(src, ResampleTransform(xfactor, yfactor), out_shape,
                     interp, edge, device=device)


def translate(src, dx: float, dy: float, interp: str = "bilinear",
              edge: str = "zero", device=None):
    """(ref ``translate``, Transform.h:550)"""
    return transform(src, TranslateTransform(dx, dy), None, interp, edge,
                     device=device)


def rotate(src, theta: float, interp: str = "bilinear", edge: str = "zero",
           device=None):
    """Rotate about the image center (ref ``rotate``, Transform.h:556)."""
    h, w = src.shape[0], src.shape[1]
    center = ((w - 1) / 2.0, (h - 1) / 2.0)
    return transform(src, RotateTransform(theta, center), None, interp, edge,
                     device=device)


def compute_transformed_bbox(src_shape, tx: Transform2D) -> BBox2i:
    """Forward image of the source box (ref ``compute_transformed_bbox``,
    Transform.h:260)."""
    h, w = src_shape[0], src_shape[1]
    return tx.forward_bbox(BBox2(0, 0, w, h)).rounded()


def transform_grid(src, reverse_fn: Callable, out_shape: Tuple[int, int],
                   grid_step: int = 16, interp: str = "bilinear",
                   edge: str = "zero", tolerance: float = 0.5,
                   min_grid_step: int = 2, device=None):
    """Grid-approximated warp for expensive reverse maps (ref
    ``ApproximateTransform``, Transform.h:142-238): the reverse map is
    evaluated on a coarse host grid and interpolated bilinearly to full
    resolution, then sampled on the device.

    ``reverse_fn`` is a host function mapping NumPy (x, y) arrays to source
    coordinates — e.g. a cartographic reprojection. ``tolerance``: see
    :func:`reverse_map_grid`.
    """
    sx_g, sy_g, grid_step = reverse_map_grid(reverse_fn, out_shape, grid_step,
                                             tolerance, min_grid_step)
    return warp_from_grid(src, sx_g, sy_g, grid_step, out_shape,
                          interp=interp, edge=edge, device=device)


def reverse_map_grid(reverse_fn: Callable, out_shape: Tuple[int, int],
                     grid_step: int = 16, tolerance: float = 0.5,
                     min_grid_step: int = 2):
    """Host half of :func:`transform_grid` (a copy of the JAX package's
    NumPy code): evaluate ``reverse_fn`` on a coarse grid, refining
    ``grid_step`` until the mid-cell bilinear approximation error fits
    ``tolerance`` source pixels (the worst case of a bilinear fit sits near
    mid-cell; <= 0 disables the check). Returns ``(sx_g, sy_g, grid_step)``
    NumPy grids."""
    oh, ow = int(out_shape[0]), int(out_shape[1])
    while True:
        gx = np.arange(0, ow + grid_step, grid_step, dtype=np.float64)
        gy = np.arange(0, oh + grid_step, grid_step, dtype=np.float64)
        gxx, gyy = np.meshgrid(gx, gy)
        sx_g, sy_g = reverse_fn(gxx, gyy)
        if tolerance <= 0 or grid_step <= min_grid_step:
            break
        mx = 0.5 * (gx[:-1] + gx[1:])
        my = 0.5 * (gy[:-1] + gy[1:])
        mxx, myy = np.meshgrid(mx, my)
        ex, ey = reverse_fn(mxx, myy)
        ex, ey = np.asarray(ex), np.asarray(ey)
        ax = 0.25 * (sx_g[:-1, :-1] + sx_g[:-1, 1:]
                     + sx_g[1:, :-1] + sx_g[1:, 1:])
        ay = 0.25 * (sy_g[:-1, :-1] + sy_g[:-1, 1:]
                     + sy_g[1:, :-1] + sy_g[1:, 1:])
        with np.errstate(invalid="ignore"):
            err = np.nanmax(np.maximum(np.abs(ex - ax), np.abs(ey - ay))) \
                if ex.size else 0.0
        if not np.isfinite(err) or err <= tolerance:
            break
        grid_step = max(grid_step // 2, min_grid_step)
    return np.asarray(sx_g), np.asarray(sy_g), grid_step


def _steps(n: int, grid_step: int, device):
    """``arange(n) / grid_step`` in fp32 (IEEE quotients)."""
    return (torch.arange(n, dtype=torch.float32, device=device)
            / torch.tensor(float(grid_step), dtype=torch.float32, device=device))


def interp_map_grid(sx_g, sy_g, grid_step: int, out_shape: Tuple[int, int],
                    device=None):
    """Device half, part 1: bilinearly upsample host coordinate grids to
    full-resolution per-pixel source coordinates ``(sx, sy)`` (a gather of
    grid rows, then of columns, replicating the grid's edge)."""
    oh, ow = int(out_shape[0]), int(out_shape[1])
    dev = resolve_device(device)
    sxg = as_tensor(sx_g, torch.float32, dev)
    syg = as_tensor(sy_g, torch.float32, dev)
    fx = _steps(ow, grid_step, dev)
    fy = _steps(oh, grid_step, dev)
    return (_sample_separable(sxg, fx, fy, interp="bilinear", edge="constant"),
            _sample_separable(syg, fx, fy, interp="bilinear", edge="constant"))


def _grid_axis_1d(g_row, grid_step: int, n: int, device=None):
    """Linear interpolation of a 1D host grid row/column to n output
    positions (the per-axis half of :func:`interp_map_grid`)."""
    dev = resolve_device(device)
    g = as_tensor(g_row, torch.float32, dev)
    f = _steps(n, grid_step, dev)
    k = torch.clamp(torch.floor(f).to(torch.int64), 0, g.shape[0] - 2)
    t = f - k.to(torch.float32)
    return g[k] * (1.0 - t) + g[k + 1] * t


def warp_route(sx_g, sy_g, grid_step: int, interp: str = "bilinear") -> str:
    """``"separable"`` when :func:`warp_from_grid` takes 1-D coordinates
    from the host grid's first row and column, else ``"grid"`` (2-D
    coordinates upsampled from the whole grid): the JAX package's host
    predicate — finite grids, a known ``interp``, a displacement band of
    more than 64 shifts, and every grid row of ``sx`` and every grid column
    of ``sy`` equal within 1e-4 px."""
    sx_g = np.asarray(sx_g)
    sy_g = np.asarray(sy_g)
    if not (interp in _TAPS and np.all(np.isfinite(sx_g))
            and np.all(np.isfinite(sy_g))):
        return "grid"
    gxx, gyy = np.meshgrid(
        np.arange(sx_g.shape[1], dtype=np.float64) * grid_step,
        np.arange(sx_g.shape[0], dtype=np.float64) * grid_step)
    # The full-res coordinates are bilinear blends of the host grid
    # values, so displacement bounds follow from the grid (+1 margin).
    half = 0.5 if interp == "nearest" else 0.0
    dxg = sx_g - gxx + half
    dyg = sy_g - gyy + half
    dy_b = (int(np.floor(dyg.min())) - 1, int(np.floor(dyg.max())) + 1)
    dx_b = (int(np.floor(dxg.min())) - 1, int(np.floor(dxg.max())) + 1)
    t_lo, t_hi = _TAPS[interp]
    area = ((dy_b[1] - dy_b[0]) + (t_hi - t_lo) + 1) * \
        ((dx_b[1] - dx_b[0]) + (t_hi - t_lo) + 1)
    separable = (area > _SEP_MIN_AREA
                 and np.ptp(sx_g, axis=0).max() <= 1e-4
                 and np.ptp(sy_g, axis=1).max() <= 1e-4)
    return "separable" if separable else "grid"


def grid_coords(sx_g, sy_g, grid_step: int, out_shape: Tuple[int, int],
                interp: str = "bilinear", device=None):
    """``(route, sx, sy)`` of :func:`warp_from_grid` on ``device``: the 1-D
    per-column / per-row coordinates of a separable map, or the 2-D
    per-pixel ones. They depend on the grid alone, so a caller warping
    many frames through one grid makes them once."""
    oh, ow = int(out_shape[0]), int(out_shape[1])
    route = warp_route(sx_g, sy_g, grid_step, interp)
    if route == "separable":
        sx_g, sy_g = np.asarray(sx_g), np.asarray(sy_g)
        return (route, _grid_axis_1d(sx_g[0], grid_step, ow, device),
                _grid_axis_1d(sy_g[:, 0], grid_step, oh, device))
    return (route, *interp_map_grid(sx_g, sy_g, grid_step, out_shape, device))


def warp_with(src, coords, interp: str = "bilinear", edge: str = "zero"):
    """Sample ``src`` (a tensor) at :func:`grid_coords`' coordinates."""
    route, sx, sy = coords
    if route == "separable":
        return _sample_separable(src, sx, sy, interp=interp, edge=edge)
    return sample(src, sx, sy, interp=interp, edge=edge)


def warp_from_grid(src, sx_g, sy_g, grid_step: int,
                   out_shape: Tuple[int, int], interp: str = "bilinear",
                   edge: str = "zero", device=None):
    """Device half of :func:`transform_grid`: interpolate the host grids to
    per-pixel coordinates and sample — separable maps as a gather of rows,
    then of columns, on 1-D coordinates; any other map through
    :func:`sample` on 2-D ones (:func:`warp_route`). Runs on ``src``'s
    device when it is a tensor, else on ``device`` (``None`` = the card)."""
    src = on_device(src, device)
    coords = grid_coords(sx_g, sy_g, grid_step, out_shape, interp, src.device)
    return warp_with(src, coords, interp=interp, edge=edge)
