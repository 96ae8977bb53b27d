"""Pixel/color-space conversions (port of
``visionworkbench_tpu/image/pixel_types.py``; ref
``src/vw/Image/PixelTypes.h:101-``: PixelGray[A]/RGB[A]/HSV/XYZ/Luv/Lab
casts).

Channels-last tensors; every conversion elementwise, RGB in [0, 1]. Each
function works on a tensor's device; an array goes to ``device`` (``None``
= the card).
"""

from __future__ import annotations

import torch

from visionworkbench_torch.core.device import on_device

# sRGB <-> CIE XYZ (D65), the matrices the reference's PixelXYZ uses.
_RGB2XYZ = ((0.4124564, 0.3575761, 0.1804375),
            (0.2126729, 0.7151522, 0.0721750),
            (0.0193339, 0.1191920, 0.9503041))
_XYZ2RGB = ((3.2404542, -1.5371385, -0.4985314),
            (-0.9692660, 1.8760108, 0.0415560),
            (0.0556434, -0.2040259, 1.0572252))
_D65 = (0.95047, 1.0, 1.08883)


def _f32(x, device):
    return on_device(x, device, torch.float32)


def _const(values, like):
    return torch.tensor(values, dtype=torch.float32, device=like.device)


def rgb_to_gray(rgb, device=None):
    """Mean of channels (the reference's PixelGray cast averages channels)."""
    return _f32(rgb, device).mean(dim=-1)


def gray_to_rgb(gray, device=None):
    g = _f32(gray, device)
    return torch.stack([g, g, g], -1)


def rgb_to_hsv(rgb, device=None):
    rgb = _f32(rgb, device)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.amax(-1)
    minc = rgb.amin(-1)
    v = maxc
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / torch.clamp_min(maxc, 1e-12), 0.0)
    safe = torch.clamp_min(delta, 1e-12)
    h = torch.where(maxc == r, torch.remainder((g - b) / safe, 6.0),
                    torch.where(maxc == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0))
    h = torch.where(delta > 0, h / _const(6.0, h), 0.0)
    return torch.stack([h, s, v], -1)


def hsv_to_rgb(hsv, device=None):
    hsv = _f32(hsv, device)
    h, s, v = hsv[..., 0] * 6.0, hsv[..., 1], hsv[..., 2]
    i = torch.floor(h)
    f = h - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def select(*vals):
        out = vals[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out
    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], -1)


def rgb_to_xyz(rgb, device=None):
    rgb = _f32(rgb, device)
    return rgb @ _const(_RGB2XYZ, rgb).T


def xyz_to_rgb(xyz, device=None):
    xyz = _f32(xyz, device)
    return xyz @ _const(_XYZ2RGB, xyz).T


def _lab_f(t):
    d = 6.0 / 29.0
    return torch.where(t > d ** 3, torch.pow(t, 1.0 / 3.0), t / (3 * d * d) + 4.0 / 29.0)


def _lab_finv(t):
    d = 6.0 / 29.0
    return torch.where(t > d, t ** 3, 3 * d * d * (t - 4.0 / 29.0))


def xyz_to_lab(xyz, device=None):
    xyz = _f32(xyz, device)
    xyz = xyz / _const(_D65, xyz)
    fx, fy, fz = _lab_f(xyz[..., 0]), _lab_f(xyz[..., 1]), _lab_f(xyz[..., 2])
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy), 200.0 * (fy - fz)], -1)


def lab_to_xyz(lab, device=None):
    lab = _f32(lab, device)
    fy = (lab[..., 0] + 16.0) / _const(116.0, lab)
    fx = fy + lab[..., 1] / _const(500.0, lab)
    fz = fy - lab[..., 2] / _const(200.0, lab)
    out = torch.stack([_lab_finv(fx), _lab_finv(fy), _lab_finv(fz)], -1)
    return out * _const(_D65, lab)


def rgb_to_lab(rgb, device=None):
    return xyz_to_lab(rgb_to_xyz(rgb, device))


def lab_to_rgb(lab, device=None):
    return xyz_to_rgb(lab_to_xyz(lab, device))


def xyz_to_luv(xyz, device=None):
    xyz = _f32(xyz, device)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    denom = torch.clamp_min(x + 15 * y + 3 * z, 1e-12)
    up = 4 * x / denom
    vp = 9 * y / denom
    xn, yn, zn = (float(torch.tensor(v, dtype=torch.float32)) for v in _D65)
    dn = xn + 15 * yn + 3 * zn
    un, vn = 4 * xn / dn, 9 * yn / dn
    yr = y / _const(yn, y)
    lum = torch.where(yr > (6 / 29) ** 3, 116.0 * torch.pow(yr, 1.0 / 3.0) - 16.0,
                      (29 / 3) ** 3 * yr)
    u = 13 * lum * (up - un)
    v = 13 * lum * (vp - vn)
    return torch.stack([lum, u, v], -1)


def rgb_to_luv(rgb, device=None):
    return xyz_to_luv(rgb_to_xyz(rgb, device))


def weighted_rgb_to_gray(rgb, rw=0.30, gw=0.59, bw=0.11, device=None):
    """Luma-weighted gray (ref ``weighted_rgb_to_gray``)."""
    rgb = _f32(rgb, device)
    return rw * rgb[..., 0] + gw * rgb[..., 1] + bw * rgb[..., 2]
