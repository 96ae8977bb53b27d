"""Sentinel-1 SAR water detection -- the Martinis algorithm (port of
``visionworkbench_tpu/tools/flood/radar.py``; ref ``src/vw/tools/radar.h``;
Martinis, Kersten, Twele, "A fully automated TerraSAR-X based flood
service", ISPRS 2015).

Stages (the image-sized ones fp32 tensor work on the input's device, the
tile statistics' selection and the histogram splits host NumPy, as in the
JAX package):

1. preprocess: DN -> dB, 3x3 median despeckle, rescale [0,35] dB -> [0,400]
2. tile statistics: per tile, mean + sample-stddev of the four sub-tile
   means (sub-tiles with <95% valid pixels are dropped)
3. tile selection: keep high-stddev (95th percentile), below-global-mean
   tiles; cap at 5 ranked by stddev, skipping tiles brighter than the
   initially-kept set's mean
4. per-tile Kittler-Illingworth histogram split -> global threshold =
   mean of tile thresholds (retry with half tiles if stddev > 10); only the
   kept tiles are copied to the host (the JAX package copies the image)
5. fuzzy refinement: Z(radar), S(blob size), optionally Z(DEM height) and
   Z(slope); defuzz = mean (0 if any member is 0)
6. hysteresis fill: seed at 0.6*sens, grow through 0.45*sens (the JAX
   package's seed/grow order; its module docstring explains why it differs
   from the reference's argument order).

The image-wide sums (the sub-tile sums, the raw water's mean, the DEM's
mean and variance) accumulate in float64 and round once to fp32, so the
card and the CPU agree whatever their reduction order; the tile statistics
stay in float64 from the sub-tile sums on and round once (the deviation of
four sub-tile means of ~100 that differ by ~0.1 cancels: from fp32 sums the
JAX package's deviations lie up to ~1e-3 relative off float64). The fuzzy members
keep the JAX package's fp32 arithmetic (IEEE quotients, ``x * x`` squares).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from visionworkbench_torch.core.device import on_device, qdiv, sqrt_rn
from visionworkbench_torch.image.morphology import blob_sizes, two_threshold_fill
from visionworkbench_torch.image.window_ops import median_filter
from .common import (FLOOD_DETECT_WATER, FLOOD_DETECT_LAND, FLOOD_DETECT_NODATA, as_image,
                     as_valid)

# Preprocessing range constants (radar.h:240-246).
GLOBAL_MIN_DB = 0.0
GLOBAL_MAX_DB = 35.0
PROC_MIN = 0.0
PROC_MAX = 400.0

MAX_NUM_TILES = 5                     # radar.h:560, from the paper
TILE_STDDEV_PERCENTILE_CUTOFF = 0.95  # radar.h:519
MIN_PERCENT_VALID = 0.95              # radar.h:351
MAX_THRESHOLD_STDDEV = 10.0           # radar.h:640
MIN_BLOB_SIZE_METERS = 1000.0         # radar.h:778
MAX_BLOB_SIZE_METERS = 5000.0         # radar.h:779

# ln 10 in fp32, as ``jnp.log10`` divides by it
_LN10 = float(np.float32(math.log(10.0)))


def fuzzy_membership_z(v, a: float, b: float, device=None):
    """Z-shaped fuzzy membership: 1 below a, 0 above b (radar.h:63-79)."""
    v = on_device(v, device, torch.float32)
    c = (a + b) / 2.0
    dba = max(b - a, 1e-12)
    lo = qdiv(v - a, dba)
    hi = qdiv(v - b, dba)
    mid_lo = 1.0 - 2.0 * (lo * lo)
    mid_hi = 2.0 * (hi * hi)
    return torch.where(v <= a, 1.0,
                       torch.where(v < c, mid_lo, torch.where(v < b, mid_hi, 0.0)))


def fuzzy_membership_s(v, a: float, b: float, device=None):
    """S-shaped fuzzy membership: 0 below a, 1 above b (radar.h:84-100)."""
    v = on_device(v, device, torch.float32)
    c = (a + b) / 2.0
    dba = max(b - a, 1e-12)
    lo = qdiv(v - a, dba)
    hi = qdiv(v - b, dba)
    mid_lo = 2.0 * (lo * lo)
    mid_hi = 1.0 - 2.0 * (hi * hi)
    return torch.where(v < a, 0.0,
                       torch.where(v < c, mid_lo, torch.where(v >= b, 1.0, mid_hi)))


def kittler_illingworth_jt(hist, min_val: float, max_val: float):
    """J(T) for every candidate split bin at once (radar.h:110-156). ``hist``
    is a normalized (num_bins,) histogram; returns (num_bins,) scores with
    the reference's FAIL_VAL where a class is empty/degenerate. Host-side
    NumPy float64 — a 255-bin histogram needs the precision, not the TPU."""
    hist = np.asarray(hist, np.float64)
    num_bins = hist.shape[0]
    fail = 999999.0
    bin_width = (max_val - min_val) / num_bins
    bin_values = min_val + bin_width * (np.arange(num_bins,
                                                  dtype=np.float64) + 0.5)
    w = hist * bin_values
    w2 = hist * bin_values * bin_values
    # Prefix sums give class-1 = bins [0, T) and class-2 = bins [T, n) for
    # every split T simultaneously.
    cp = np.cumsum(hist)
    cw = np.cumsum(w)
    cw2 = np.cumsum(w2)
    # The reference evaluates splits at bin = 1..n-1 (class 1 = bins < bin).
    p1 = cp[:-1]
    p2 = cp[-1] - p1
    m1 = cw[:-1] / np.where(p1 == 0, 1.0, p1)
    m2 = (cw[-1] - cw[:-1]) / np.where(p2 == 0, 1.0, p2)
    var1 = cw2[:-1] / np.where(p1 == 0, 1.0, p1) - m1 * m1
    var2 = ((cw2[-1] - cw2[:-1]) / np.where(p2 == 0, 1.0, p2)) - m2 * m2
    sigma1 = np.sqrt(np.maximum(var1, 0.0))
    sigma2 = np.sqrt(np.maximum(var2, 0.0))
    j = (1.0 + 2.0 * (p1 * np.log(np.where(sigma1 <= 0, 1.0, sigma1))
                      + p2 * np.log(np.where(sigma2 <= 0, 1.0, sigma2)))
         - 2.0 * (p1 * np.log(np.where(p1 == 0, 1.0, p1))
                  + p2 * np.log(np.where(p2 == 0, 1.0, p2))))
    bad = (p1 <= 0) | (p2 <= 0) | (sigma1 <= 0) | (sigma2 <= 0)
    return np.where(bad, fail, j)


def split_histogram_kittler_illingworth(hist, min_val: float,
                                        max_val: float) -> float:
    """Optimal threshold by the Kittler/Illingworth criterion
    (radar.h:159-199)."""
    hist = np.asarray(hist, np.float64)
    num_bins = hist.shape[0]
    total = hist.sum()
    if total <= 0:
        return min_val
    scores = np.asarray(kittler_illingworth_jt(hist / total, min_val,
                                               max_val))
    min_index = int(np.argmin(scores))  # score i ↔ reference bin i+1
    bin_width = (max_val - min_val) / num_bins
    # Reference: threshold below the winning bin value (bin - 0.5).
    return min_val + bin_width * (float(min_index + 1) - 0.5)


def sentinel1_dn_to_db(dn, valid=None, device=None):
    """DN -> decibels (radar.h:209-224): ``10 * ln(dn) / ln(10)`` as
    ``jnp.log10`` computes it. An array goes to ``device`` (``None`` = the
    card)."""
    dn = as_image(dn, device)
    valid = as_valid(valid, dn) & (dn > 0)
    db = 10.0 * qdiv(torch.log(torch.where(dn > 0, dn, 1.0)), _LN10)
    return db, valid


def preprocess_sentinel1(dn, valid, device=None):
    """Despeckle + rescale to [0, 400] (radar.h:227-270)."""
    db, valid = sentinel1_dn_to_db(dn, valid, device)
    smooth = median_filter(torch.where(valid, db, 0.0), 3)
    scale = (PROC_MAX - PROC_MIN) / (GLOBAL_MAX_DB - GLOBAL_MIN_DB)
    proc = (smooth - GLOBAL_MIN_DB) * scale + PROC_MIN
    return proc, valid


def generate_tile_means(image, valid, tile_size: int, device=None):
    """Per-tile mean and sample-stddev of the four sub-tile means
    (radar.h:273-404 ``ImageTileMeansView``). Returns (th, tw) tensors
    ``means``, ``stddevs``, ``tvalid`` on the image's device (an array goes
    to ``device``, ``None`` = the card)."""
    image = on_device(image, device, torch.float32)
    valid = as_valid(valid, image)
    h, w = image.shape
    th, tw = h // tile_size, w // tile_size
    hs = tile_size // 2
    val = valid[:th * tile_size, :tw * tile_size]
    img = torch.where(val, image[:th * tile_size, :tw * tile_size], 0.0)
    # Reshape to (th, 2, hs, tw, 2, hs): sub-tile grid of half-tiles; the
    # sums and the statistics of the (th, 2, tw, 2) sub-tile means in
    # float64, rounded once.
    sub_count = val.reshape(th, 2, hs, tw, 2, hs).sum(dim=(2, 5), dtype=torch.float64)
    sub_sum = img.reshape(th, 2, hs, tw, 2, hs).sum(dim=(2, 5), dtype=torch.float64)
    sub_mean = sub_sum / torch.clamp(sub_count, min=1.0)
    # the JAX package's fp32 test (the counts are exact in fp32)
    sub_used = qdiv(sub_count.float(), float(hs * hs)) >= MIN_PERCENT_VALID
    n = sub_used.sum(dim=(1, 3)).double()                          # (th, tw)
    used = sub_used.double()
    mean_of_means = (sub_mean * used).sum(dim=(1, 3)) / torch.clamp(n, min=1.0)
    diff = (sub_mean - mean_of_means[:, None, :, None]) * used
    ss = (diff * diff).sum(dim=(1, 3))
    stddev = torch.sqrt(ss / torch.clamp(n - 1.0, min=1.0))
    stddev = torch.where(n > 1, stddev, 0.0)
    tvalid = (n > 0) & (mean_of_means > 0)
    return mean_of_means.float(), stddev.float(), tvalid


def select_best_tiles(means, stddevs, tvalid, debug: bool = False):
    """Pick the ≤5 low-mean high-variance tiles used for thresholding
    (radar.h:496-605). Returns a list of (row, col) tile indices."""
    means = np.asarray(means, np.float64)
    stddevs = np.asarray(stddevs, np.float64)
    tvalid = np.asarray(tvalid)
    if not tvalid.any():
        return []
    global_mean = means[tvalid].mean()
    sd = stddevs[tvalid]
    sd_min, sd_max = float(sd.min()), float(sd.max())
    num_bins = 255
    hist, _ = np.histogram(sd, bins=num_bins, range=(sd_min, sd_max))
    # get_histogram_percentile: first bin where the CDF reaches the cutoff.
    cdf = np.cumsum(hist) / max(hist.sum(), 1)
    bin_idx = int(np.searchsorted(cdf, TILE_STDDEV_PERCENTILE_CUTOFF))
    bin_width = (sd_max - sd_min) / num_bins
    cutoff = sd_min + bin_width * bin_idx

    keep = tvalid & (stddevs > cutoff) & (means < global_mean)
    rows, cols = np.nonzero(keep)
    if len(rows) == 0:
        return []
    kept_means = means[rows, cols]
    kept_stds = stddevs[rows, cols]
    if len(rows) <= MAX_NUM_TILES:
        return list(zip(rows.tolist(), cols.tolist()))

    # Rank by stddev descending; skip tiles brighter than the initial kept
    # set's mean (radar.h:573-597).
    mean_of_selected = kept_means.mean()
    order = np.argsort(-kept_stds)
    out = []
    for idx in order:
        if kept_means[idx] > mean_of_selected:
            continue
        out.append((int(rows[idx]), int(cols[idx])))
        if len(out) >= MAX_NUM_TILES:
            break
    return out


def compute_global_threshold(image, valid, kept_tiles, tile_size: int,
                             debug: bool = False):
    """Mean of per-tile Kittler-Illingworth thresholds; None if the tile
    thresholds disagree too much (radar.h:609-658). Only the kept tiles go
    to the host, where ``np.histogram`` bins them as the JAX package does."""
    num_bins = 255
    thresholds = []
    for (tr, tc) in kept_tiles:
        sl = (slice(tr * tile_size, (tr + 1) * tile_size),
              slice(tc * tile_size, (tc + 1) * tile_size))
        tile = np.asarray(image[sl].cpu() if isinstance(image, torch.Tensor) else image[sl],
                          np.float32)
        keep = np.asarray(valid[sl].cpu() if isinstance(valid, torch.Tensor) else valid[sl])
        hist, _ = np.histogram(tile[keep], bins=num_bins,
                               range=(PROC_MIN, PROC_MAX))
        thresholds.append(split_histogram_kittler_illingworth(
            hist, PROC_MIN, PROC_MAX))
    thresholds = np.asarray(thresholds)
    mean_t = float(thresholds.mean())
    if len(thresholds) > 1:
        std_t = float(thresholds.std(ddof=1))
    else:
        std_t = 0.0
    if debug:
        print(f"Mean of tile thresholds: {mean_t}")
        print(f"STD  of tile thresholds: {std_t}")
    if std_t > MAX_THRESHOLD_STDDEV:
        return None
    return mean_t


@dataclasses.dataclass
class SarMartinisResult:
    classes: torch.Tensor        # uint8 FLOOD_DETECT_* codes
    threshold: float             # global threshold (preprocessed units)
    raw_water: torch.Tensor      # bool initial threshold result
    defuzzed: torch.Tensor       # fp32 fuzzy score


def _hypot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``jnp.hypot``'s formula: max * sqrt(1 + (min / max)^2)."""
    x, y = x.abs(), y.abs()
    inf = torch.isposinf(x) | torch.isposinf(y)
    hi, lo = torch.maximum(x, y), torch.minimum(x, y)
    r = lo / torch.where(hi == 0, 1.0, hi)
    out = torch.where(hi == 0, hi, hi * sqrt_rn(1.0 + r * r))
    return torch.where(inf, math.inf, out)


def _slope_deg(dem: torch.Tensor) -> torch.Tensor:
    """Slope in degrees from forward differences at unit spacing, the last
    row and column repeated (radar.h:925-929: acos of the surface normal's z
    component)."""
    dzdx = torch.cat([dem[:, 1:], dem[:, -1:]], 1) - dem
    dzdy = torch.cat([dem[1:], dem[-1:]], 0) - dem
    return torch.atan(_hypot(dzdx, dzdy)) * (180.0 / math.pi)


def _refine(proc, pvalid, threshold: float, meters_per_pixel: float, dem,
            sensitivity: float):
    """Stages 5-6 from the preprocessed image and the global threshold:
    (classes, raw_water, defuzzed)."""
    # Initial classification: dark pixels are water (radar.h:763-773).
    raw_water = (proc <= threshold) & pvalid

    # Fuzzy refinement inputs.
    min_blob = max(int(MIN_BLOB_SIZE_METERS / meters_per_pixel), 1)
    max_blob = max(int(MAX_BLOB_SIZE_METERS / meters_per_pixel), min_blob + 1)
    sizes = blob_sizes(raw_water, max_blob)

    count = max(int(raw_water.sum()), 1)
    mean_raw_water = float(np.float32(
        float(torch.where(raw_water, proc, 0.0).sum(dtype=torch.float64)) / count))

    radar_fuzz = fuzzy_membership_z(proc, mean_raw_water, threshold)
    blob_fuzz = fuzzy_membership_s(sizes.float(), float(min_blob), float(max_blob))

    if dem is None:
        # Defuzz two members: 0 if either is 0, else their mean
        # (radar.h:432-444, 860-868).
        any_zero = (radar_fuzz == 0) | (blob_fuzz == 0)
        defuzzed = torch.where(any_zero, 0.0, (radar_fuzz + blob_fuzz) / 2.0)
    else:
        dem = as_image(dem, proc.device)
        wsel = raw_water
        n = max(int(wsel.sum()), 1)
        mean_h = np.float32(float(torch.where(wsel, dem, 0.0).sum(dtype=torch.float64)) / n)
        d = dem - float(mean_h)
        var_h = np.float32(float(torch.where(wsel, d * d, 0.0).sum(dtype=torch.float64))
                           / max(n - 1, 1))
        std_h = np.sqrt(var_h)
        # The paper's odd-looking max height (radar.h:920); floor the band
        # at 1 m so a perfectly flat water-surface DEM doesn't degenerate.
        high_h = max(float(mean_h + std_h * (std_h + np.float32(3.5))),
                     float(mean_h) + 1.0)
        height_fuzz = fuzzy_membership_z(dem, float(mean_h), high_h)
        slope_fuzz = fuzzy_membership_z(_slope_deg(dem), 0.0, 15.0)
        any_zero = ((radar_fuzz == 0) | (blob_fuzz == 0)
                    | (height_fuzz == 0) | (slope_fuzz == 0))
        defuzzed = torch.where(
            any_zero, 0.0,
            (radar_fuzz + height_fuzz + slope_fuzz + blob_fuzz) / 4.0)

    # Hysteresis fill: seed 0.6*s, grow 0.45*s (radar.h:953-955; see module
    # docstring re: the reference's argument order).
    final = two_threshold_fill(defuzzed, 0.45 * sensitivity,
                               0.6 * sensitivity, FLOOD_DETECT_LAND,
                               FLOOD_DETECT_WATER)
    classes = torch.where(pvalid, final, FLOOD_DETECT_NODATA).to(torch.uint8)
    return classes, raw_water, defuzzed


def sar_martinis(dn, valid=None, meters_per_pixel: float = 10.0,
                 dem: Optional[np.ndarray] = None, tile_size: int = 512,
                 sensitivity: float = 1.0, debug: bool = False,
                 device=None) -> SarMartinisResult:
    """Full Martinis water detection on a Sentinel-1 DN image
    (radar.h:665-975 ``sar_martinis``). ``dem``, if given, must already be
    resampled onto the image grid (the reference geo-transforms it; use
    :func:`visionworkbench_torch.cartography.geotransform.reproject_image`
    for that step). Runs on ``dn``'s device when it is a tensor, else on
    ``device`` (``None`` = the card); the result's planes stay there."""
    dn = as_image(dn, device)
    valid = dn > 0 if valid is None else as_valid(valid, dn)
    proc, pvalid = preprocess_sentinel1(dn, valid)

    # Auto-threshold with one half-tile-size retry (radar.h:713-757).
    threshold = None
    ts = tile_size
    for _ in range(2):
        means, stddevs, tvalid = generate_tile_means(proc, pvalid, ts)
        kept = select_best_tiles(means.cpu().numpy(), stddevs.cpu().numpy(),
                                 tvalid.cpu().numpy(), debug)
        if kept:
            threshold = compute_global_threshold(proc, pvalid, kept, ts, debug)
        if threshold is not None:
            break
        ts //= 2
    if threshold is None:
        raise ValueError(
            "Unable to compute a good water threshold for this image")

    classes, raw_water, defuzzed = _refine(proc, pvalid, threshold, meters_per_pixel,
                                           dem, sensitivity)
    return SarMartinisResult(classes=classes, threshold=float(threshold),
                             raw_water=raw_water, defuzzed=defuzzed)
