"""Stereo pairs made on the device from a seed: the benchmark's traffic.

One general generator, driven by a traffic mix's parameters (a workload
file's ``traffic``). Each pair is built in four steps:

1. A band-limited texture: octaves of seeded noise, each a coarse grid of
   normal samples upsampled bicubically to one cell size (``octaves_px``),
   weighted by ``cell ** weight_exponent``. No octave has a dominant
   period, so no pyramid level locks onto an alias. A share of the area
   (``low_texture_share``) is low-texture patches: the texture's contrast
   there is cut to ``low_texture_contrast`` of its own about a smooth copy.
2. A smooth terrain-like disparity field on the left image: Gaussian bumps
   (``bumps`` of them, each ``bump_size`` of the frame's shorter side,
   amplitudes in [-1, 1]) plus a plane, scaled into ``x_range`` for dx and
   into ``[-y_residual_px, y_residual_px]`` for dy (an independent field).
3. The right image: ``right(p + d(p)) = left(p)``, sampled bicubically at
   the fixed point ``p = q - d(p)`` of each right pixel ``q``.
4. Sensor noise of ``noise_sigma`` on both images, then both quantized to
   the 1/256 grid.

Every random draw comes from one ``torch.Generator`` on the device seeded
with the run's seed and the pair's index, in a few large calls; a seed
gives the same pairs on the same device.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch
import torch.nn.functional as tnf


class Pair(NamedTuple):
    left: torch.Tensor     # (H, W) float32 on the 1/256 grid
    right: torch.Tensor    # (H, W)
    truth: torch.Tensor    # (H, W, 2) float32: right(p + truth(p)) = left(p)


def _generator(device, seed: int, index: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + int(index)) % (2 ** 63))
    return g


def _upsampled_noise(g, h: int, w: int, cell: int, device) -> torch.Tensor:
    """Normal noise on a grid of ``cell`` px, bicubic over (h, w), random
    phase (a crop of a grid one cell larger on each side)."""
    gh, gw = h // cell + 4, w // cell + 4
    grid = torch.randn((1, 1, gh, gw), generator=g, device=device)
    up = tnf.interpolate(grid, scale_factor=cell, mode="bicubic", align_corners=False)
    oy, ox = (int(v) for v in torch.randint(0, cell, (2,), generator=g, device=device))
    return up[0, 0, cell + oy:cell + oy + h, cell + ox:cell + ox + w]


def _texture(g, h: int, w: int, p: dict, device) -> torch.Tensor:
    tex = torch.zeros((h, w), device=device)
    for cell in p["octaves_px"]:
        tex += float(cell) ** float(p["weight_exponent"]) * _upsampled_noise(g, h, w, int(cell), device)
    tex = (tex - tex.mean()) / tex.std()
    smooth = _upsampled_noise(g, h, w, int(p["low_texture_px"]), device)
    cut = torch.quantile(smooth[::4, ::4].reshape(-1), 1.0 - float(p["low_texture_share"]))
    # a soft edge over ~1/10 of the field's spread
    inside = torch.sigmoid((smooth - cut) / (0.1 * smooth.std()))
    base = tnf.avg_pool2d(tex[None, None], 31, 1, 15, count_include_pad=False)[0, 0]
    contrast = 1.0 - (1.0 - float(p["low_texture_contrast"])) * inside
    tex = base + (tex - base) * contrast
    return (0.5 + 0.12 * tex).clamp(0.02, 0.98)


def _field(g, h: int, w: int, bumps: int, size, device) -> torch.Tensor:
    """A smooth field scaled to [0, 1]: a plane plus Gaussian bumps."""
    side = min(h, w)
    n = int(bumps)
    r = torch.rand((n, 4), generator=g, device=device)
    cy, cx = r[:, 0] * h, r[:, 1] * w
    sig = (float(size[0]) + (float(size[1]) - float(size[0])) * r[:, 2]) * side
    amp = 2.0 * r[:, 3] - 1.0
    tilt = torch.rand((2,), generator=g, device=device) * 2.0 - 1.0
    ys = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    f = 0.5 * (tilt[0] * ys / h + tilt[1] * xs / w)
    for k in range(n):
        f = f + amp[k] * torch.exp(-((ys - cy[k]) ** 2 + (xs - cx[k]) ** 2) / (2 * sig[k] ** 2))
    lo, hi = f.amin(), f.amax()
    return (f - lo) / torch.clamp(hi - lo, min=1e-6)


def _sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bicubic samples of ``img`` at pixel coordinates (x, y), edges
    replicated."""
    h, w = img.shape
    grid = torch.stack([2.0 * x / (w - 1) - 1.0, 2.0 * y / (h - 1) - 1.0], -1)[None]
    return tnf.grid_sample(img[None, None], grid, mode="bicubic",
                           padding_mode="border", align_corners=True)[0, 0]


def make_pair(traffic: dict, seed: int, index: int, device) -> Pair:
    """Pair ``index`` of the run with ``seed`` under ``traffic``."""
    h, w = int(traffic["height"]), int(traffic["width"])
    tp, dp = traffic["texture"], traffic["disparity"]
    g = _generator(device, seed, index)
    left = _texture(g, h, w, tp, device)
    x_lo, x_hi = (float(v) for v in dp["x_range"])
    dx = x_lo + (x_hi - x_lo) * _field(g, h, w, dp["bumps"], dp["bump_size"], device)
    yr = float(dp["y_residual_px"])
    dy = yr * (2.0 * _field(g, h, w, dp["bumps"], dp["bump_size"], device) - 1.0)
    # right(q) = left(p) where q = p + d(p): the fixed point p = q - d(p)
    qy = torch.arange(h, device=device, dtype=torch.float32)[:, None].expand(h, w)
    qx = torch.arange(w, device=device, dtype=torch.float32)[None, :].expand(h, w)
    px, py = qx - dx, qy - dy
    for _ in range(int(dp.get("fixed_point_steps", 8))):
        px = qx - _sample(dx, px, py)
        py = qy - _sample(dy, px, py)
    right = _sample(left, px, py)
    sigma = float(tp["noise_sigma"])
    noise = torch.randn((2, h, w), generator=g, device=device) * sigma
    q = lambda im: torch.clamp(torch.round(im * 256.0), 0.0, 255.0) / 256.0  # noqa: E731
    return Pair(q(left + noise[0]), q(right + noise[1]), torch.stack([dx, dy], -1))


def make_pairs(traffic: dict, seed: int, device) -> List[Pair]:
    """The run's distinct pairs (``traffic["pairs"]``), cycled by the
    closed loop."""
    return [make_pair(traffic, seed, i, device) for i in range(int(traffic["pairs"]))]


def truth_in_search(pair: Pair, search) -> bool:
    """True where every true disparity lies inside the search box
    (x, y, w, h; max-exclusive)."""
    x0, y0, sw, sh = (float(v) for v in search)
    d = pair.truth
    return bool((d[..., 0] >= x0).all() and (d[..., 0] <= x0 + sw - 1).all()
                and (d[..., 1] >= y0).all() and (d[..., 1] <= y0 + sh - 1).all())

