"""Morphology and distance ops (port of
``visionworkbench_tpu/image/morphology.py``; ref ``src/vw/Image/Grassfire.cc``,
``BlobIndex.cc``, ``ErodeView.h``, ``FillHoles.h``, ``DistanceFunction.cc``).

* ``grassfire`` — the Manhattan distance transform is separable into
  per-axis min-plus scans ``c_i = min_j (seed_j + |i - j|)``, each two
  running minima of ``seed - i`` (``torch.cummin``), forward and reversed.
  The values are integers (and the 1e9 "infinity" rounds the same way in
  both packages), so the scans equal the JAX package's associative scans.
* ``blob_index`` — connected components by iterative min-label propagation
  with pointer jumping, as in the JAX package: each pass takes the minimum
  over the pixel and its 4 (or 8) neighbours inside the mask, then jumps
  every label to its label's label. Labels only fall, and every label is
  the flat index of a pixel of the same component, so the fixpoint is
  unique: the minimum flat index of each component. The JAX package tests
  for a change after every pass; on the card each test is a host sync, so
  the port tests after every ``_CHECK_EVERY`` passes (extra passes at the
  fixpoint change nothing, and no change over several passes means none
  in each of them).
* ``remove_small_blobs`` — the correlator's blob filter (ref
  ``disparity_blob_filter``, ``CorrelationView.cc:241-280``).
* erode / dilate — window min / max with a zero frame.
"""

from __future__ import annotations

import numpy as np
import torch

from visionworkbench_torch.core.device import as_tensor, resolve_device

_INF = 1e9            # exact in fp32

# Passes between two tests for the fixpoint (one host sync each).
_CHECK_EVERY = 4

# Propagation passes run by :func:`_blob_labels`, summed over its calls
# (a measurement counter, as the kernels' launch counters; set it to 0
# before the work to count).
label_passes = 0


def _neighbours_min(lbl: torch.Tensor, mask: torch.Tensor, big: int,
                    connectivity: int) -> torch.Tensor:
    h, w = lbl.shape
    p = lbl.new_full((h + 2, w + 2), big)
    p[1:h + 1, 1:w + 1] = lbl
    shifts = [(0, 1), (2, 1), (1, 0), (1, 2)]
    if connectivity == 8:
        shifts += [(0, 0), (0, 2), (2, 0), (2, 2)]
    out = lbl
    for dy, dx in shifts:
        out = torch.minimum(out, p[dy:dy + h, dx:dx + w])
    return torch.where(mask, out, big)


def _blob_labels(mask: torch.Tensor, connectivity: int = 4):
    """``(labels, passes)``: :func:`blob_index`'s labels and the number of
    propagation passes run."""
    if mask.dtype != torch.bool:
        mask = mask != 0
    h, w = mask.shape
    big = h * w
    flat_idx = torch.arange(big, dtype=torch.int32, device=mask.device).reshape(h, w)
    lbl = torch.where(mask, flat_idx, big)
    passes = 0
    while True:
        before = lbl
        for _ in range(_CHECK_EVERY):
            new = _neighbours_min(lbl, mask, big, connectivity).reshape(-1)
            # pointer jumping: follow each label's label to shortcut chains
            hop = new[torch.clamp(new, max=big - 1).long()]
            lbl = torch.where(new < big, torch.minimum(new, hop), new).reshape(h, w)
            passes += 1
        if torch.equal(lbl, before):
            break
    global label_passes
    label_passes += passes
    return torch.where(mask, lbl, -1), passes


def blob_index(mask: torch.Tensor, connectivity: int = 4) -> torch.Tensor:
    """Label the connected components of ``mask`` (H, W) (ref
    ``BlobIndexThreaded``, BlobIndex.cc): int32 labels, -1 outside the
    mask, else the minimum flat index of the component."""
    return _blob_labels(mask, connectivity)[0]


def blob_areas(labels: torch.Tensor) -> torch.Tensor:
    """Per-pixel area (int32) of the blob each pixel belongs to; 0 outside."""
    h, w = labels.shape
    flat = labels.reshape(-1)
    inside = flat >= 0
    safe = torch.where(inside, flat, 0).long()
    counts = torch.bincount(safe[inside], minlength=h * w).to(torch.int32)
    return torch.where(inside, counts[safe], 0).reshape(h, w)


def remove_small_blobs(mask: torch.Tensor, min_area: int,
                       connectivity: int = 4) -> torch.Tensor:
    """Keep only the components of area >= ``min_area`` (ref
    ``applyErodeView`` + ``BlobIndexThreaded`` in ``disparity_blob_filter``,
    CorrelationView.cc:241-280)."""
    area = blob_areas(blob_index(mask, connectivity))
    return (mask != 0) & (area >= min_area)


def _mask(valid, device) -> torch.Tensor:
    """``valid`` as a bool tensor: a tensor keeps its device, an array goes
    to ``device`` (``None`` = the card)."""
    if not isinstance(valid, torch.Tensor):
        valid = as_tensor(valid, None, resolve_device(device))
    return valid if valid.dtype == torch.bool else valid != 0


def _minplus_scan(seed: torch.Tensor, axis: int) -> torch.Tensor:
    """c_i = min_j (seed_j + |i - j|) along ``axis``: two running minima of
    (seed - i), forward and on the reversed axis."""
    n = seed.shape[axis]
    shape = [1] * seed.ndim
    shape[axis] = n
    idx = torch.arange(n, dtype=seed.dtype, device=seed.device).reshape(shape)
    fwd = torch.cummin(seed - idx, axis).values + idx
    rev = torch.flip(seed, (axis,))
    bwd = torch.flip(torch.cummin(rev - idx, axis).values + idx, (axis,))
    return torch.minimum(fwd, bwd)


def grassfire(valid, device=None) -> torch.Tensor:
    """Manhattan (4-connected) distance to the nearest invalid pixel or image
    border (ref ``grassfire``, Grassfire.cc: zero pixels have distance 0,
    border-adjacent valid pixels distance 1). ``valid``: bool or nonzero
    (H, W); returns int32 distances."""
    valid = _mask(valid, device)
    h, w = valid.shape
    # Virtual zero border: one pixel of 0 on each side, cropped at the end.
    seed = torch.zeros((h + 2, w + 2), dtype=torch.float32, device=valid.device)
    seed[1:h + 1, 1:w + 1] = torch.where(valid, _INF, 0.0)
    d = _minplus_scan(_minplus_scan(seed, 0), 1)
    return d[1:h + 1, 1:w + 1].to(torch.int32)


def grassfire_np(valid):
    """Host NumPy twin of :func:`grassfire` for STATIC masks (a copy of the
    JAX package's): the mosaic planner computes each source's alpha once
    from its plan, like the reference's cached per-source grassfire
    generators (``ImageComposite.h:184``)."""
    v = np.asarray(valid)
    if v.dtype != np.bool_:
        v = v != 0
    seed = np.where(v, 1e9, 0.0)
    seed = np.pad(seed, 1, constant_values=0.0)
    for axis in (0, 1):
        n = seed.shape[axis]
        shape = [1, 1]
        shape[axis] = n
        idx = np.arange(n, dtype=seed.dtype).reshape(shape)
        fwd = np.minimum.accumulate(seed - idx, axis=axis) + idx
        rev = np.flip(seed, axis)
        bwd = np.flip(np.minimum.accumulate(rev - idx, axis=axis) + idx,
                      axis)
        seed = np.minimum(fwd, bwd)
    return seed[1:-1, 1:-1].astype(np.int32)


def euclidean_distance_sq(valid, device=None) -> torch.Tensor:
    """Exact squared-Euclidean distance (fp32) to the nearest invalid pixel
    (the role of ``DistanceFunction.cc``): a 1-D Manhattan pass along x
    (exact within a row), then a row-offset sweep
    ``min_k (dx2[y +- k] + k^2)``. Rows past the frame count as 1e9, so
    each offset only updates the rows it reaches (rounding is monotone:
    ``min(a, b) + c`` is ``min(a + c, b + c)``)."""
    valid = _mask(valid, device)
    seed = torch.where(valid, _INF, 0.0)
    dx = _minplus_scan(seed, 1)
    best = torch.clamp(dx * dx, max=_INF)
    dx2 = best.clone()
    h = valid.shape[0]
    for k in range(1, h):
        k2 = float(k * k)
        best[:h - k] = torch.minimum(best[:h - k], dx2[k:] + k2)
        best[k:] = torch.minimum(best[k:], dx2[:h - k] + k2)
    return best


def blob_sizes(mask, size_limit: int, connectivity: int = 4) -> torch.Tensor:
    """Per-pixel size of the containing blob, capped at ``size_limit``
    (uint32; ref ``get_blob_sizes``, BlobIndex.h:613; the reference
    approximates per tile with an expand collar — labeling the whole image
    here is exact). Pixels outside the mask get 0 (BLOBS_NODATA)."""
    area = blob_areas(blob_index(mask, connectivity))
    return torch.clamp(area, max=size_limit).to(torch.uint32)


def two_threshold_fill(image, low_threshold: float, high_threshold: float,
                       output_false: int = 0, output_true: int = 1,
                       device=None) -> torch.Tensor:
    """Hysteresis fill (uint8): seed at pixels > high_threshold, grow
    through 8-connected pixels > low_threshold (ref ``two_threshold_fill``,
    ImageSurface.h:324; blob labeling computes the closure exactly)."""
    if not isinstance(image, torch.Tensor):
        image = as_tensor(image, torch.float32, resolve_device(device))
    img = image.to(torch.float32)
    labels = blob_index(img > low_threshold, connectivity=8).reshape(-1)
    inside = labels >= 0
    safe = torch.where(inside, labels, 0).long()
    has_seed = torch.zeros(labels.numel(), dtype=torch.bool, device=img.device)
    has_seed[safe[(img > high_threshold).reshape(-1) & inside]] = True
    filled = (has_seed[safe] & inside).reshape(img.shape)
    return torch.where(filled, output_true, output_false).to(torch.uint8)


def _window_minmax(image, size: int, is_max: bool) -> torch.Tensor:
    """size x size window max (or min) over a zero frame: ``size // 2``
    before, the rest after."""
    pad = size // 2
    x = image.to(torch.float32)[None, None]
    x = torch.nn.functional.pad(x, (pad, size - 1 - pad, pad, size - 1 - pad))
    if not is_max:
        x = -x
    out = torch.nn.functional.max_pool2d(x, size, stride=1)[0, 0]
    return out if is_max else -out


def erode(mask, size: int = 3, device=None) -> torch.Tensor:
    """Binary erosion (ref ``ErodeView.h``)."""
    return _window_minmax(_mask(mask, device), size, False) > 0.5


def dilate(mask, size: int = 3, device=None) -> torch.Tensor:
    return _window_minmax(_mask(mask, device), size, True) > 0.5


def _box3(x: torch.Tensor) -> torch.Tensor:
    """3x3 window sum over a zero frame (the taps row by row)."""
    h, w = x.shape
    p = torch.nn.functional.pad(x, (1, 1, 1, 1))
    out = None
    for dy in range(3):
        for dx in range(3):
            tap = p[dy:dy + h, dx:dx + w]
            out = tap if out is None else out + tap
    return out


def fill_holes(data, valid, max_dist: int = 16, device=None):
    """Fill invalid pixels from nearby valid data by iterative dilation
    averaging (ref ``FillHoles.h`` / ``InpaintView.cc`` grassfire
    inpainting). Returns ``(filled fp32, now-valid bool)``."""
    if not isinstance(data, torch.Tensor):
        data = as_tensor(data, torch.float32, resolve_device(device))
    d = data.to(torch.float32)
    v = _mask(valid, d.device).to(torch.float32)
    d = d * v
    for _ in range(max_dist):
        num = _box3(d * v)
        den = _box3(v)
        filled = num / torch.clamp(den, min=1e-6)
        new_v = torch.clamp(v + (den > 0).to(torch.float32), max=1.0)
        d = torch.where(v > 0, d, filled)
        v = new_v
    return d, v > 0
