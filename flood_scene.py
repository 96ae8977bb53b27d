"""Synthetic flood scenes: the inputs of ``chip_smoke.py``'s phase 10 and of
``tests/test_torch_flood.py``.

Every scene is drawn in the pixel frame of its image (``u`` the column,
``v`` the row, pixel centres at integers) from one water model: a meandering
river 30-150 px wide plus elliptical lakes, added until they cover
``WATER_SHARE`` of the frame. :func:`shore_distance` is the signed distance
to the nearest shore (negative on water), exact enough to hold a class map
against its truth away from the shores. The model's shapes are drawn with a
NumPy ``default_rng(seed)``; the dense noise (speckle, spectra) comes from a
``torch.Generator`` on the device the scene is made on, seeded with the
same seed. Scenes are written as the files a user hands the tools:

* :func:`sentinel1` -- Sentinel-1 IW GRD: uint16 DN at 10 m in UTM 15N with
  the affine rotated by 12 degrees as a descending pass is; land about
  -8 dB and water about -20 dB (sigma0), 4-look gamma speckle; 0-DN
  no-data wedges along the left and top edges. :func:`s1_dem` is a 30 m
  DEM on a north-up grid over its footprint (water flat at 40 m, land
  rising away from the shores, hills).
* :func:`landsat8` -- Landsat 8 at 30 m: the seven band files B2-B7, B10
  (uint16 DN) and an MTL text as ``tests/test_flood.py`` writes it; land,
  water and cloud spectra.
* :func:`worldview3` -- an 8-band WorldView-3 DN image and its IMD text.
* :func:`spot6` -- a 4-band SPOT-6 DN image.
* :func:`modis` -- one MOD09 tile: bands 1-2 at ``n``² (250 m) and bands 3-7 at
  (n/2)² (500 m), int16 reflectance x 1e4.
"""

from __future__ import annotations

import copy
import math
import os

import numpy as np

WATER_SHARE = 0.15           # river + lakes, of the frame
RIVER_PX = (30.0, 150.0)     # the river's width range, px
SHORE_PX = 3.0               # gates count pixels farther than this from a shore

S1_PIXEL_M = 10.0
S1_ROTATION_DEG = 12.0
S1_EPSG = 32615              # UTM 15N
S1_ORIGIN = (600000.0, 3400000.0)
S1_SIGMA0_DB = (-8.0, -20.0)   # land, water
S1_LOOKS = 4
S1_DN_SCALE = 4000.0           # DN per unit of linear sigma0
S1_DEM_M = 30.0

# Landsat 8 TOA spectra, working channels BLUE, GREEN, RED, NIR, SWIR1,
# TEMP (kelvin), SWIR2
LANDSAT_SPECTRA = {"land": (0.08, 0.10, 0.12, 0.30, 0.25, 295.0, 0.20),
                   "water": (0.06, 0.09, 0.05, 0.02, 0.01, 290.0, 0.01),
                   "cloud": (0.50, 0.50, 0.50, 0.50, 0.40, 265.0, 0.30)}
LANDSAT_BAND_NUMBERS = (2, 3, 4, 5, 6, 10, 7)   # files of the working channels
LANDSAT_SUN_EL = 45.0
LANDSAT_K = (774.8853, 1321.0789, 480.8883, 1201.1442)   # K1/K2 of bands 10, 11
LANDSAT_RAD10 = (3.342e-4, 0.1)
LANDSAT_REFL = (2.0e-5, -0.1)
CLOUD_SHARE = 0.05
# WorldView-3 DNs, bands C, B, G, Y, R, RE, N1, N2
WORLDVIEW_DN = {"land": (500, 500, 500, 500, 500, 800, 2500, 3000),
                "water": (2000, 1500, 1200, 800, 2000, 400, 100, 100)}
# SPOT-6 DNs, bands B, G, R, N
SPOT_DN = {"land": (100, 120, 150, 400), "water": (500, 300, 100, 50)}
# MOD09 reflectance x 1e4, bands 1-7
MODIS_REFL = {"land": (500, 4000, 300, 1000, 1000, 1000, 1000),
              "water": (500, 300, 300, 1000, 1000, 100, 100)}
SPECTRAL_NOISE = 0.05        # relative, per pixel and band


def water_model(n: int, seed: int, river_px=RIVER_PX) -> dict:
    """The river (``river_px`` wide), the lakes, the clouds and three smooth
    fields of an n x n frame."""
    rng = np.random.default_rng(seed)
    m = {"n": n, "river_px": river_px,
         "river": dict(u0=n * rng.uniform(0.4, 0.6), a1=n * rng.uniform(0.08, 0.15),
                       k1=2 * math.pi / (n * rng.uniform(0.6, 0.9)), p1=rng.uniform(0, 6.3),
                       a2=n * rng.uniform(0.02, 0.05),
                       k2=2 * math.pi / (n * rng.uniform(0.15, 0.3)), p2=rng.uniform(0, 6.3),
                       k3=2 * math.pi / (n * rng.uniform(0.3, 0.5)), p3=rng.uniform(0, 6.3)),
         "lakes": [],
         "fields": {k: [(rng.uniform(-1, 1) * 2 * math.pi / (n * rng.uniform(0.1, 0.5)),
                         rng.uniform(-1, 1) * 2 * math.pi / (n * rng.uniform(0.1, 0.5)),
                         rng.uniform(0, 6.3), rng.uniform(0.5, 1.0)) for _ in range(4)]
                    for k in ("sigma0", "hills", "spectra")}}
    import torch
    g = (torch.arange(128, dtype=torch.float64) + 0.5) * (n / 128)
    v, u = torch.meshgrid(g, g, indexing="ij")
    while float((shore_distance(m, u, v) < 0).double().mean()) < WATER_SHARE:
        m["lakes"].append(dict(cu=n * rng.uniform(0.1, 0.9), cv=n * rng.uniform(0.1, 0.9),
                               ru=n * rng.uniform(0.03, 0.08), rv=n * rng.uniform(0.03, 0.08),
                               theta=rng.uniform(0, math.pi)))
    m["clouds"] = []
    while True:
        share = float(_cloud(m, u, v).double().mean())
        if share >= CLOUD_SHARE:
            break
        m["clouds"].append(dict(cu=n * rng.uniform(0, 1), cv=n * rng.uniform(0, 1),
                                ru=n * rng.uniform(0.02, 0.06), rv=n * rng.uniform(0.02, 0.06),
                                theta=rng.uniform(0, math.pi)))
    return m


def _ellipse(e, u, v):
    """Signed distance (px, approximate) to an ellipse's rim."""
    import torch
    c, s = math.cos(e["theta"]), math.sin(e["theta"])
    du, dv = u - e["cu"], v - e["cv"]
    a = (du * c + dv * s) / e["ru"]
    b = (dv * c - du * s) / e["rv"]
    return (torch.sqrt(a * a + b * b) - 1.0) * min(e["ru"], e["rv"])


def shore_distance(m: dict, u, v):
    """Signed distance (px) from the frame points (u, v) to the nearest
    shore: negative on water."""
    import torch
    r = m["river"]
    uc = (r["u0"] + r["a1"] * torch.sin(v * r["k1"] + r["p1"])
          + r["a2"] * torch.sin(v * r["k2"] + r["p2"]))
    lo, hi = m["river_px"]
    half = 0.5 * (lo + (hi - lo) * (0.5 + 0.5 * torch.sin(v * r["k3"] + r["p3"])))
    d = (u - uc).abs() - half
    for lake in m["lakes"]:
        d = torch.minimum(d, _ellipse(lake, u, v))
    return d


def _cloud(m, u, v):
    import torch
    out = torch.zeros(u.shape, dtype=torch.bool, device=u.device)
    for c in m["clouds"]:
        out |= _ellipse(c, u, v) < 0
    return out


def field(m: dict, key: str, u, v):
    """A smooth field in [-1, 1] (four plane waves)."""
    out = 0.0
    total = 0.0
    for ku, kv, p, a in m["fields"][key]:
        out = out + a * (u * ku + v * kv + p).sin()
        total += a
    return out / total


def frame(h: int, w: int, dev, dtype=None):
    """(u, v) of every pixel centre of an h x w frame on ``dev``."""
    import torch
    dtype = dtype or torch.float32
    v, u = torch.meshgrid(torch.arange(h, dtype=dtype, device=dev),
                          torch.arange(w, dtype=dtype, device=dev), indexing="ij")
    return u, v


def _generator(dev, seed):
    import torch
    return torch.Generator(device=dev).manual_seed(seed)


def _uint(x, dtype=np.uint16):
    """``x`` rounded and clamped to ``dtype``'s range, as a host array."""
    import torch
    info = np.iinfo(dtype)
    return torch.clamp(torch.round(x), info.min, info.max).cpu().numpy().astype(dtype)


# ---- Sentinel-1 -----------------------------------------------------------------

def s1_georef(n: int, rotation_deg: float = S1_ROTATION_DEG):
    """The scene's GeoReference: UTM 15N, 10 m pixels, the affine rotated by
    ``rotation_deg``."""
    from visionworkbench_torch.cartography import GeoReference
    a = math.radians(rotation_deg)
    c, s = S1_PIXEL_M * math.cos(a), S1_PIXEL_M * math.sin(a)
    t = np.array([[c, s, S1_ORIGIN[0]], [s, -c, S1_ORIGIN[1] + n * S1_PIXEL_M], [0, 0, 1]])
    return GeoReference.from_epsg(S1_EPSG, transform=t)


def sentinel1(n: int, seed: int, dev, folder: str, river_px=RIVER_PX,
              rotation_deg: float = S1_ROTATION_DEG) -> dict:
    """An n x n Sentinel-1 GRD scene written to ``folder``/s1_grd.tif:
    ``path``, ``georef``, ``model``, ``dn`` (uint16) and the no-data share."""
    import torch
    from visionworkbench_torch.fileio import write_tiff
    m = water_model(n, seed, river_px)
    u, v = frame(n, n, dev)
    water = shore_distance(m, u, v) < 0
    db = torch.where(water, S1_SIGMA0_DB[1] + 1.0 * field(m, "sigma0", u, v),
                     S1_SIGMA0_DB[0] + 1.5 * field(m, "sigma0", u, v))
    gen = _generator(dev, seed)
    looks = -torch.log(torch.rand((S1_LOOKS, n, n), generator=gen, device=dev)
                       .clamp_(min=1e-12)).mean(0)
    dn = S1_DN_SCALE * torch.pow(10.0, db / 10.0) * looks
    # no-data wedges along the left and the top edges
    nodata = (u < 0.06 * n * (1.0 - v / n)) | (v < 0.04 * n * (u / n))
    dn = torch.where(nodata, 0.0, torch.clamp(dn, min=1.0))
    dn = _uint(dn)
    path = os.path.join(folder, "s1_grd.tif")
    georef = s1_georef(n, rotation_deg)
    write_tiff(path, dn, georef=georef, nodata=0.0)
    return {"path": path, "georef": georef, "model": m, "dn": dn,
            "nodata_share": float(nodata.double().mean())}


def north_up(georef, n: int):
    """The north-up grid ``sentinel1_flood_detect`` warps an n x n frame of
    ``georef`` onto: (georef, (h, w)) -- the tool's own arithmetic."""
    t = georef.transform
    px, py = (x.numpy() for x in georef.pixel_to_point(np.array([0.0, n, 0.0, n]),
                                                      np.array([0.0, 0.0, n, n])))
    res = float(np.hypot(t[0, 0], t[1, 0]))
    ow = max(int(np.ceil((px.max() - px.min()) / np.float32(res))), 1)
    oh = max(int(np.ceil((py.max() - py.min()) / np.float32(res))), 1)
    out = copy.deepcopy(georef)
    out.set_transform(np.array([[res, 0.0, float(px.min())], [0.0, -res, float(py.max())],
                                [0.0, 0.0, 1.0]]))
    return out, (oh, ow)


def _source_frame(georef, dst_georef, h, w, dev):
    """The source-frame (u, v) of every pixel centre of an h x w grid of
    ``dst_georef`` (same projection; float64 affine algebra)."""
    import torch
    m = np.linalg.inv(georef.transform) @ dst_georef.transform
    uu, vv = frame(h, w, dev, torch.float64)
    # pixel-as-area centres on both grids: +0.5 in, -0.5 out
    su = m[0, 0] * (uu + 0.5) + m[0, 1] * (vv + 0.5) + m[0, 2] - 0.5
    sv = m[1, 0] * (uu + 0.5) + m[1, 1] * (vv + 0.5) + m[1, 2] - 0.5
    return su, sv


def s1_truth(scene: dict, dst_georef, shape, dev):
    """The signed shore distance (px) of every pixel of a grid of
    ``dst_georef`` (the scene's frame is 10 m, as the warped grid)."""
    su, sv = _source_frame(scene["georef"], dst_georef, shape[0], shape[1], dev)
    return shore_distance(scene["model"], su, sv)


def s1_dem(scene: dict, n: int, dev, folder: str) -> str:
    """A 30 m DEM on a north-up grid over the scene's footprint, written to
    ``folder``/s1_dem.tif: water flat at 40 m, land 40-46 m over its first
    40 px from the shore, hills of up to 60 m beyond."""
    import torch
    from visionworkbench_torch.fileio import write_tiff
    up, (oh, ow) = north_up(scene["georef"], n)
    k = S1_DEM_M / S1_PIXEL_M
    dem_georef = copy.deepcopy(up)
    t = up.transform.copy()
    t[0, 0], t[1, 1] = S1_DEM_M, -S1_DEM_M
    dem_georef.set_transform(t)
    h, w = int(math.ceil(oh / k)), int(math.ceil(ow / k))
    su, sv = _source_frame(scene["georef"], dem_georef, h, w, dev)
    d = shore_distance(scene["model"], su, sv).float()
    hills = 0.5 + 0.5 * field(scene["model"], "hills", su, sv).float()
    dem = (40.0 + 6.0 * torch.clamp(d / 40.0, 0.0, 1.0)
           + 60.0 * hills * torch.clamp((d - 40.0) / 200.0, 0.0, 1.0))
    path = os.path.join(folder, "s1_dem.tif")
    write_tiff(path, dem.cpu().numpy().astype(np.float32), georef=dem_georef)
    return path


# ---- optical scenes -------------------------------------------------------------

def _classes(m, u, v, clouds=False):
    """0 land, 1 water, 2 cloud; and the signed shore distance."""
    import torch
    d = shore_distance(m, u, v)
    cls = (d < 0).to(torch.uint8)
    if clouds:
        cls = torch.where(_cloud(m, u, v), 2, cls).to(torch.uint8)
    return cls, d


def _spectra(table, cls, m, u, v, gen, kelvin=None):
    """(H, W, B) float planes of the class spectra with SPECTRAL_NOISE
    relative noise a pixel and band; land varies by 20 % over the frame. The
    band ``kelvin`` (a temperature) gets 1 K of noise instead."""
    import torch
    names = ("land", "water", "cloud")
    rows = torch.tensor([table[k] for k in names if k in table], dtype=torch.float32,
                        device=cls.device)
    rel = torch.full((rows.shape[1],), SPECTRAL_NOISE, device=cls.device)
    vary = torch.full((rows.shape[1],), 0.2, device=cls.device)
    add = torch.zeros(rows.shape[1], device=cls.device)
    if kelvin is not None:
        rel[kelvin], vary[kelvin], add[kelvin] = 0.0, 0.0, 1.0
    x = rows[cls.long()]
    land = (cls == 0)[..., None]
    x = torch.where(land, x * (1.0 + vary * field(m, "spectra", u, v)[..., None]), x)
    noise = torch.randn(x.shape, generator=gen, device=cls.device)
    return x * (1.0 + rel * noise) + add * noise


def landsat_mtl() -> str:
    """An MTL text in the format of ``tests/test_flood.py``'s."""
    k1_10, k2_10, k1_11, k2_11 = LANDSAT_K
    lines = ["GROUP = L1_METADATA_FILE",
             f"  SUN_ELEVATION = {LANDSAT_SUN_EL}",
             f"  RADIANCE_MULT_BAND_10 = {LANDSAT_RAD10[0]:.3e}",
             f"  RADIANCE_ADD_BAND_10 = {LANDSAT_RAD10[1]:.5f}",
             f"  K1_CONSTANT_BAND_10 = {k1_10}",
             f"  K2_CONSTANT_BAND_10 = {k2_10}",
             f"  K1_CONSTANT_BAND_11 = {k1_11}",
             f"  K2_CONSTANT_BAND_11 = {k2_11}"]
    for i in range(1, 12):
        lines.append(f"  REFLECTANCE_MULT_BAND_{i} = {LANDSAT_REFL[0]:.1e}")
        lines.append(f"  REFLECTANCE_ADD_BAND_{i} = {LANDSAT_REFL[1]}")
    return "\n".join(lines) + "\n"


def landsat8(n: int, seed: int, dev, folder: str) -> dict:
    """An n x n Landsat 8 scene (30 m, UTM 15N) in ``folder``: ``paths``
    (seven band files and the MTL text), ``classes`` (0 land, 1 water, 2
    cloud) and ``shore`` (signed px)."""
    import torch
    from visionworkbench_torch.cartography import GeoReference
    from visionworkbench_torch.fileio import write_tiff
    m = water_model(n, seed)
    u, v = frame(n, n, dev)
    cls, d = _classes(m, u, v, clouds=True)
    gen = _generator(dev, seed)
    toa = _spectra(LANDSAT_SPECTRA, cls, m, u, v, gen, kelvin=5)
    sin_el = math.sin(math.radians(LANDSAT_SUN_EL))
    dn = (toa - LANDSAT_REFL[1] / sin_el) / (LANDSAT_REFL[0] / sin_el)
    k1, k2 = LANDSAT_K[0], LANDSAT_K[1]
    rad = k1 / (torch.exp(k2 / toa[..., 5]) - 1.0)
    dn[..., 5] = (rad - LANDSAT_RAD10[1]) / LANDSAT_RAD10[0]
    georef = GeoReference.from_epsg(S1_EPSG, transform=np.array(
        [[30.0, 0, S1_ORIGIN[0]], [0, -30.0, S1_ORIGIN[1]], [0, 0, 1]]))
    paths = []
    for chan, num in enumerate(LANDSAT_BAND_NUMBERS):
        paths.append(os.path.join(folder, f"LC08_L1TP_024039_B{num}.TIF"))
        write_tiff(paths[-1], _uint(dn[..., chan]), georef=georef)
    mtl = os.path.join(folder, "LC08_L1TP_024039_MTL.txt")
    with open(mtl, "w") as f:
        f.write(landsat_mtl())
    return {"paths": paths + [mtl], "classes": cls, "shore": d}


def worldview_imd() -> str:
    """An IMD text in the format of ``tests/test_flood.py``'s."""
    return "\n".join(
        [f"BEGIN_GROUP = BAND_{g}\n"
         f"  absCalFactor = {0.01 + 0.001 * i};\n"
         f"  effectiveBandwidth = {0.05 + 0.001 * i};\n"
         "END_GROUP = BAND_X"
         for i, g in enumerate(["C", "B", "G", "Y", "R", "RE", "N", "N2"])]
        + ["  meanSunEl = 35.0;",
           "  firstLineTime = 2016-10-23T17:46:54.796950Z;"]) + "\n"


def _multiband(name, table, n, seed, dev, folder):
    from visionworkbench_torch.fileio import write_tiff
    m = water_model(n, seed)
    u, v = frame(n, n, dev)
    cls, d = _classes(m, u, v)
    dn = _spectra(table, cls, m, u, v, _generator(dev, seed))
    path = os.path.join(folder, name)
    write_tiff(path, _uint(dn))
    return {"paths": [path], "classes": cls, "shore": d}


def worldview3(n: int, seed: int, dev, folder: str) -> dict:
    """An n x n 8-band WorldView-3 DN image and its IMD text."""
    out = _multiband("wv3_multispectral.tif", WORLDVIEW_DN, n, seed, dev, folder)
    imd = os.path.join(folder, "wv3_multispectral.IMD")
    with open(imd, "w") as f:
        f.write(worldview_imd())
    out["paths"].append(imd)
    return out


def spot6(n: int, seed: int, dev, folder: str) -> dict:
    """An n x n 4-band SPOT-6 DN image."""
    return _multiband("spot6_ms.tif", SPOT_DN, n, seed, dev, folder)


def modis(n: int, seed: int, dev, folder: str) -> dict:
    """A MOD09 tile: bands 1-2 at n x n, bands 3-7 at n/2 (their pixel
    centres at even band-1 pixels), int16 x 1e4, one file a band as
    ``extract_modis`` takes them; ``classes``/``shore`` on the n x n grid."""
    import torch
    from visionworkbench_torch.fileio import write_tiff
    m = water_model(n, seed)
    gen = _generator(dev, seed)
    paths = []
    out = {}
    for res, bands in ((1, (0, 1)), (2, (2, 3, 4, 5, 6))):
        u, v = frame(n // res, n // res, dev)
        u, v = u * res, v * res
        cls, d = _classes(m, u, v)
        if res == 1:
            out.update(classes=cls, shore=d)
        x = _spectra(MODIS_REFL, cls, m, u, v, gen)
        for b in bands:
            paths.append(os.path.join(folder, f"MOD09GQ.A2019150.h10v05_sur_refl_b0{b + 1}_1.tif"))
            write_tiff(paths[-1], _uint(x[..., b], np.int16))
    return {"paths": paths, **out}
