"""Mosaic compositing with multi-band (Laplacian-pyramid) blending (port of
``visionworkbench_tpu/mosaic/composite.py``; ref ``ImageComposite``,
``src/vw/Mosaic/ImageComposite.h:53-592``).

Pipeline per the reference: grassfire distance of each source's valid mask
becomes its alpha (``:184, 333-371``); sources are decomposed into Laplacian
pyramids with ``levels = floor(log2(min_dim/2)) - 1`` (``:441``); each level
is merged with weights from the Gaussian pyramid of the normalized alphas
(``blend_patch``, ``:237``); the merged pyramid collapses to the mosaic.
Draft mode skips the pyramids (feathered weighted average).

The pyramid steps are stencils on the card: the 5-tap ``[1,4,6,4,1]/16``
smoothing with replicated edges (decimated by 2 on the way down) is a gather
of five rows, then of five columns; the 2x bilinear upsample is two taps an
axis (:func:`~visionworkbench_torch.image.transform._sample_separable`).
The sources and their weights go through the pyramids together, stacked on
a trailing axis: the images as (H, W, N, C), the weights as (H, W, N, 1).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from visionworkbench_torch.core.device import as_tensor, on_device, resolve_device
from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.image.filters import generate_pyramid_smoothing_kernel
from visionworkbench_torch.image.morphology import grassfire
from visionworkbench_torch.image.transform import _gather_axis, _sample_separable
from visionworkbench_torch.math.bbox import BBox2i


def _smooth(img, stride: int = 1):
    """Separable [1,4,6,4,1]/16 smoothing of ``img`` (H, W, ...) with the
    border taps clamped (VW ConstantEdgeExtension), rows then columns; with
    ``stride`` 2, output i centres on input 2i (sizes halve with ceiling)."""
    k = [float(np.float32(v)) for v in generate_pyramid_smoothing_kernel()]
    half = len(k) // 2
    for axis in (0, 1):
        n = img.shape[axis]
        base = torch.arange(0, n, stride, device=img.device)
        taps = [(torch.clamp(base + (t - half), 0, n - 1), kv)
                for t, kv in enumerate(k)]
        img = _gather_axis(img, axis, taps)
    return img


def _downsample(img):
    return _smooth(img, stride=2)


def _upsample_to(img, shape):
    """Bilinear 2x upsample to an exact target shape (sample at x / 2,
    edges replicated)."""
    oh, ow = shape[0], shape[1]
    two = torch.tensor(2.0, device=img.device)
    ys = torch.arange(oh, dtype=torch.float32, device=img.device) / two
    xs = torch.arange(ow, dtype=torch.float32, device=img.device) / two
    return _sample_separable(img, xs, ys, interp="bilinear", edge="constant")


def gaussian_pyramid(img, levels: int, device=None) -> List[torch.Tensor]:
    pyr = [on_device(img, device, torch.float32)]
    for _ in range(levels):
        pyr.append(_downsample(pyr[-1]))
    return pyr


def laplacian_pyramid(img, levels: int, device=None) -> List[torch.Tensor]:
    """(ref the composite's per-source Laplacian decomposition)"""
    gp = gaussian_pyramid(img, levels, device)
    lp = []
    for i in range(levels):
        lp.append(gp[i] - _upsample_to(gp[i + 1], gp[i].shape))
    lp.append(gp[-1])
    return lp


def collapse_pyramid(lp: List):
    out = lp[-1]
    for lvl in reversed(lp[:-1]):
        out = lvl + _upsample_to(out, lvl.shape)
    return out


def blend_levels_for(height: int, width: int) -> int:
    """(ref ImageComposite.h:441: levels = floor(log2(mindim/2)) - 1)"""
    mindim = max(min(height, width), 4)
    return max(int(math.floor(math.log2(mindim / 2))) - 1, 1)


def _alphas(masks, alphas, device):
    if alphas is None:
        return [grassfire(m, device).to(torch.float32) for m in masks]
    return [on_device(a, device, torch.float32) for a in alphas]


def _sum(xs):
    total = xs[0]
    for x in xs[1:]:
        total = total + x
    return total


def multiband_blend(images, masks, levels: Optional[int] = None,
                    alphas=None, device=None):
    """Blend aligned canvas-size sources (lists of (H, W) or (H, W, C)
    images and bool masks). Returns ``(blended, valid (H, W))``.
    Multi-channel inputs blend per channel with the same weights.
    ``alphas`` optionally supplies precomputed grassfire weights (e.g.
    :func:`~visionworkbench_torch.image.morphology.grassfire_np` of static
    plan masks — the reference caches per-source alphas the same way,
    ImageComposite.h:184). Tensors keep their device; arrays go to
    ``device`` (``None`` = the card)."""
    if len(images) != len(masks) or not images:
        raise ArgumentErr("multiband_blend: need equal non-empty image/mask lists")
    images = [on_device(im, device, torch.float32) for im in images]
    dev = images[0].device
    masks = [m.to(dev) if isinstance(m, torch.Tensor)
             else as_tensor(np.asarray(m, bool), torch.bool, dev) for m in masks]
    h, w = images[0].shape[:2]
    if levels is None:
        levels = blend_levels_for(h, w)
    alphas = _alphas(masks, alphas, dev)
    total = _sum(alphas)
    valid = total > 0
    weights = [a / torch.clamp(total, min=1.0) for a in alphas]

    # Feather-fill masked pixels so pyramid blurs don't bleed zeros; sources
    # on a trailing axis: (H, W, N, C) images, (H, W, N, 1) weights.
    chans = images[0].shape[2:]
    stack = torch.stack([torch.where(m.reshape(m.shape + (1,) * len(chans)), im, 0.0)
                         for im, m in zip(images, masks)], 2)
    if not chans:
        stack = stack[..., None]
    ip = laplacian_pyramid(stack, levels)
    wp = gaussian_pyramid(torch.stack(weights, 2)[..., None], levels)
    merged = []
    for wl, il in zip(wp, ip):
        n = len(images)
        num = _sum([wl[:, :, i] * il[:, :, i] for i in range(n)])
        den = _sum([wl[:, :, i] for i in range(n)])
        merged.append(num / torch.clamp(den, min=1e-8))
    out = collapse_pyramid(merged)
    if not chans:
        out = out[..., 0]
    vexp = valid.reshape(valid.shape + (1,) * (out.ndim - 2))
    return torch.where(vexp, out, 0.0), valid


def feather_blend(images, masks, device=None):
    """Draft-mode blend: grassfire-weighted average, no pyramids
    (ref draft mode, ImageComposite.h)."""
    images = [on_device(im, device, torch.float32) for im in images]
    alphas = _alphas(masks, None, images[0].device)
    total = _sum(alphas)
    valid = total > 0
    num = None
    for img, a in zip(images, alphas):
        ai = a if img.ndim == 2 else a[..., None]
        term = img * ai
        num = term if num is None else num + term
    tot = total if images[0].ndim == 2 else total[..., None]
    out = num / torch.clamp(tot, min=1.0)
    vexp = valid if out.ndim == 2 else valid[..., None]
    return torch.where(vexp, out, 0.0), valid


class ImageComposite:
    """Positioned-source mosaic (ref ``ImageComposite``): ``insert`` sources
    at pixel offsets, then ``generate`` the blended canvas on ``device``
    (``None`` = the card)."""

    def __init__(self, blend_mode: str = "multiband", device=None):
        if blend_mode not in ("multiband", "draft", "simple"):
            raise ArgumentErr(f"unknown blend mode {blend_mode!r}")
        self.blend_mode = blend_mode
        self.device = device
        self._sources: List[Tuple[np.ndarray, Optional[np.ndarray], int, int]] = []

    def insert(self, image, x: int, y: int, mask=None) -> None:
        img = np.asarray(image, np.float32)
        m = None if mask is None else np.asarray(mask, bool)
        self._sources.append((img, m, int(x), int(y)))

    def bbox(self) -> BBox2i:
        box = BBox2i.from_bounds(*(10 ** 9,) * 2, *(-10 ** 9,) * 2)
        for img, _, x, y in self._sources:
            box.grow(BBox2i(x, y, img.shape[1], img.shape[0]))
        return box

    def generate(self):
        """Composite all sources. Returns (data, valid) numpy arrays sized to
        the union bbox; origin at ``bbox().min``."""
        if not self._sources:
            raise ArgumentErr("ImageComposite: no sources")
        dev = resolve_device(self.device)
        box = self.bbox()
        h, w = int(box.height), int(box.width)
        bands = self._sources[0][0].shape[2:] or ()
        canvases, masks = [], []
        for img, m, x, y in self._sources:
            canvas = np.zeros((h, w) + bands, np.float32)
            cmask = np.zeros((h, w), bool)
            ys, xs = y - box.min_y, x - box.min_x
            canvas[ys:ys + img.shape[0], xs:xs + img.shape[1]] = img
            src_mask = np.ones(img.shape[:2], bool) if m is None else m
            cmask[ys:ys + img.shape[0], xs:xs + img.shape[1]] = src_mask
            canvases.append(torch.as_tensor(canvas, device=dev))
            masks.append(torch.as_tensor(cmask, device=dev))
        if self.blend_mode == "simple":
            out = canvases[0]
            valid = masks[0]
            for c, m in zip(canvases[1:], masks[1:]):
                me = m if out.ndim == 2 else m[..., None]
                out = torch.where(me, c, out)
                valid = valid | m
        elif self.blend_mode == "draft":
            out, valid = feather_blend(canvases, masks)
        else:
            out, valid = multiband_blend(canvases, masks)
        return out.cpu().numpy(), valid.cpu().numpy()
