"""The rest of the port's image substrate against the JAX package on the
CPU, on seeded NumPy inputs: ``image/{manipulation, types, masks,
statistics, window_ops, pixel_types, sparse}``, ``edge.crop_to_interior``,
``ops/box_filter.box_filter_same`` and the ``image`` package's exports.

Tolerances: exact for selections, masks, integer histograms and
quantiles, the median and the sparse view; 1e-6 relative for reductions
(another summation order); 1e-6 for the raised-cosine window and
1e-5 / 2e-5 (relative / absolute) for the colour conversions (XLA's
``linspace``, ``cbrt`` and fused multiply-adds against one operation a
step); box filters within the JAX package's prefix-sum rounding (it sums
planes of 64^2 and more as cumsum differences).
"""

import ast

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import _torch_threads  # noqa: F401
import visionworkbench_tpu.image as jimage
import visionworkbench_tpu.image.edge as jedge
import visionworkbench_tpu.image.manipulation as jman
import visionworkbench_tpu.image.masks as jmasks
import visionworkbench_tpu.image.pixel_types as jpix
import visionworkbench_tpu.image.sparse as jsparse
import visionworkbench_tpu.image.statistics as jstats
import visionworkbench_tpu.image.types as jtypes
import visionworkbench_tpu.image.window_ops as jwin
import visionworkbench_tpu.ops.box_filter as jbox
from visionworkbench_tpu.math.bbox import BBox2i as JBBox2i
import visionworkbench_torch.image as timage
import visionworkbench_torch.image.edge as tedge
import visionworkbench_torch.image.manipulation as tman
import visionworkbench_torch.image.masks as tmasks
import visionworkbench_torch.image.pixel_types as tpix
import visionworkbench_torch.image.sparse as tsparse
import visionworkbench_torch.image.statistics as tstats
import visionworkbench_torch.image.types as ttypes
import visionworkbench_torch.image.window_ops as twin
import visionworkbench_torch.ops.box_filter as tbox
from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.math.bbox import BBox2i

RNG = np.random.default_rng(61)
IMG = RNG.random((23, 31)).astype(np.float32)
RGB = RNG.random((9, 11, 3)).astype(np.float32)


def _eq(got, want):
    assert np.array_equal(np.asarray(got), np.asarray(want), equal_nan=True)


MANIP = [
    ("crop", (3, 2, 10, 7), {}),
    ("subsample", (3,), {}),
    ("subsample", (2, 3), {}),
    ("upsample", (2, 3), {}),
    ("flip_vertical", (), {}),
    ("flip_horizontal", (), {}),
    ("rotate_180", (), {}),
    ("rotate_90_cw", (), {}),
    ("rotate_90_ccw", (), {}),
    ("transpose", (), {}),
]


@pytest.mark.parametrize("name,args,kw", MANIP, ids=[m[0] + str(m[1]) for m in MANIP])
@pytest.mark.parametrize("shape", ["gray", "rgb"])
def test_manipulation_matches_jax(name, args, kw, shape):
    img = IMG if shape == "gray" else RGB
    got = getattr(tman, name)(torch.as_tensor(img), *args, **kw)
    _eq(got, getattr(jman, name)(jnp.asarray(img), *args, **kw))


def test_crop_bbox_channels_and_planes():
    t, j = torch.as_tensor(RGB), jnp.asarray(RGB)
    _eq(tman.crop(t, bbox=BBox2i(2, 1, 5, 4)), jman.crop(j, bbox=JBBox2i(2, 1, 5, 4)))
    for c in range(3):
        _eq(tman.select_channel(t, c), jman.select_channel(j, c))
        _eq(tman.select_plane(t, c), jman.select_plane(j, c))
    _eq(tman.select_channel(torch.as_tensor(IMG), 0), IMG)
    with pytest.raises(ArgumentErr):
        tman.select_channel(torch.as_tensor(IMG), 1)
    planes = tman.channels_to_planes(t)
    _eq(planes, jman.channels_to_planes(j))
    _eq(tman.planes_to_channels(planes), RGB)


@pytest.mark.parametrize("shape", [(23, 31), (24, 32), (1, 5), (96, 97)])
def test_subsample2_equals_subsample2_mxu(shape):
    img = RNG.standard_normal(shape).astype(np.float32) * 1e3
    got = tman.subsample2(torch.as_tensor(img))
    assert got.dtype == torch.float32 and got.is_contiguous()
    _eq(got, jman.subsample2_mxu(jnp.asarray(img)))


@pytest.mark.parametrize("shape,kw,kh", [((23, 31), 3, 3), ((23, 31), 5, 3),
                                         ((70, 66), 7, 7), ((70, 66), 9, 5)])
def test_box_filter_same_matches_jax(shape, kw, kh):
    img = RNG.random(shape).astype(np.float32)
    got = tbox.box_filter_same(torch.as_tensor(img), kw, kh).numpy()
    want = np.asarray(jbox.box_filter_same(jnp.asarray(img), kw, kh))
    # the JAX package's cumsum differences: a few ulps of the largest prefix
    tol = 4 * float(np.spacing(np.float32(img.sum()))) / (kw * kh) + 1e-6
    assert np.abs(got - want).max() <= tol
    pad = np.pad(img.astype(np.float64), ((kh // 2, kh - 1 - kh // 2), (kw // 2, kw - 1 - kw // 2)),
                 mode="edge")
    direct = np.lib.stride_tricks.sliding_window_view(pad, (kh, kw)).mean((-1, -2))
    np.testing.assert_allclose(got, direct, rtol=1e-6)


def test_crop_to_interior():
    t, j = torch.as_tensor(RGB), jnp.asarray(RGB)
    for xp, yp in ((0, 0), (2, 1), (0, 3), (4, 0)):
        _eq(tedge.crop_to_interior(t, xp, yp), jedge.crop_to_interior(j, xp, yp))
    e = tedge.edge_extend(torch.as_tensor(IMG), 3, 2)
    _eq(tedge.crop_to_interior(e, 3, 2), IMG)


def _masked_pair(seed, channels=False):
    rng = np.random.default_rng(seed)
    data = rng.random((12, 14, 3) if channels else (12, 14)).astype(np.float32)
    data[rng.random((12, 14)) < 0.2] = 0.25
    data[2, 3] = np.nan
    return data


@pytest.mark.parametrize("channels", [False, True])
def test_masked_image_types(channels):
    data = _masked_pair(1, channels)
    for nodata in (None, 0.25):
        tm = ttypes.create_mask(data, nodata, device="cpu")
        jm = jtypes.create_mask(data, nodata)
        _eq(tm.valid, jm.valid)
        assert tm.shape == data.shape and tm.dtype == torch.float32
        for fill in (0.0, -7.5):
            _eq(tm.filled(fill), jm.filled(fill))
    _eq(ttypes.all_valid(data, device="cpu").valid, jtypes.all_valid(data).valid)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.uint8, np.uint16, np.int16,
                                   np.uint32])
def test_as_float32(dtype):
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        arr = RNG.integers(max(info.min, -1000), info.max, (7, 9), endpoint=True).astype(dtype)
    else:
        arr = RNG.random((7, 9)).astype(dtype)
    got = ttypes.as_float32(arr, device="cpu")
    assert got.dtype == torch.float32
    _eq(got, jtypes.as_float32(arr))
    if dtype in (np.uint8, np.int16):
        _eq(ttypes.as_float32(torch.as_tensor(arr)), jtypes.as_float32(arr))


def test_masks_match_jax():
    a_data, b_data = _masked_pair(2), _masked_pair(3)
    ta, tb = (ttypes.create_mask(d, 0.25, device="cpu") for d in (a_data, b_data))
    ja, jb = (jtypes.create_mask(d, 0.25) for d in (a_data, b_data))
    for fill in (0.0, 3.0):
        _eq(tmasks.apply_mask(ta, fill), jmasks.apply_mask(ja, fill))
    _eq(tmasks.copy_mask(b_data, ta).data, b_data)
    _eq(tmasks.copy_mask(b_data, ta).valid, jmasks.copy_mask(b_data, ja).valid)
    for name in ("invert_mask", "validate_all", "invalidate_all"):
        _eq(getattr(tmasks, name)(ta).valid, getattr(jmasks, name)(ja).valid)
    _eq(tmasks.intersect_masks(ta, tb), jmasks.intersect_masks(ja, jb))
    _eq(tmasks.union_masks(ta, tb), jmasks.union_masks(ja, jb))
    u = tmasks.masked_unary(torch.sqrt, ta)
    _eq(u.valid, ta.valid)
    for other, jother in ((tb, jb), (2.0, 2.0)):
        got = tmasks.masked_binary(torch.add, ta, other)
        want = jmasks.masked_binary(jnp.add, ja, jother)
        _eq(got.data, want.data)
        _eq(got.valid, want.valid)


@pytest.mark.parametrize("channels", [False, True])
def test_edge_mask(channels):
    img = np.zeros((15, 17, 3) if channels else (15, 17), np.float32)
    img[3:11, 4:13] = RNG.random(img[3:11, 4:13].shape) + 0.1
    img[6, 0] = 0.5                            # an interior run reaches the edge
    img[3, 4] = 0.0                            # a hole inside stays valid
    got = tmasks.edge_mask(img, device="cpu")
    want = jmasks.edge_mask(img)
    _eq(got.valid, want.valid)
    _eq(got.data, img)


STATS = ["min_pixel_value", "max_pixel_value", "mean_pixel_value",
         "stddev_pixel_value", "sum_of_pixel_values"]


@pytest.mark.parametrize("name", STATS)
def test_statistics_match_jax(name):
    got = getattr(tstats, name)(torch.as_tensor(IMG))
    np.testing.assert_allclose(got.numpy(), np.asarray(getattr(jstats, name)(jnp.asarray(IMG))),
                               rtol=1e-6)
    lo, hi = tstats.min_max_pixel_values(torch.as_tensor(IMG))
    assert float(lo) == IMG.min() and float(hi) == IMG.max()


@pytest.mark.parametrize("channels", [False, True])
def test_masked_statistics_match_jax(channels):
    data = np.nan_to_num(_masked_pair(4, channels))
    tm, jm = ttypes.create_mask(data, 0.25, device="cpu"), jtypes.create_mask(data, 0.25)
    for name in ("masked_mean", "masked_min", "masked_max", "masked_stddev"):
        np.testing.assert_allclose(getattr(tstats, name)(tm).numpy(),
                                   np.asarray(getattr(jstats, name)(jm)), rtol=1e-6)


@pytest.mark.parametrize("bins,lo,hi,masked", [(16, None, None, False), (7, 0.2, 0.9, False),
                                               (64, None, None, True), (5, 0.5, 0.5, True)])
def test_histogram_and_quantile_match_jax(bins, lo, hi, masked):
    img = np.round(RNG.random((40, 37)) * 300).astype(np.float32) / 300
    valid = RNG.random(img.shape) < 0.7 if masked else None
    got = tstats.histogram(torch.as_tensor(img), bins, lo, hi,
                           None if valid is None else torch.as_tensor(valid))
    want = jstats.histogram(jnp.asarray(img), bins, lo, hi,
                            None if valid is None else jnp.asarray(valid))
    assert got.dtype == torch.float32
    _eq(got, want)
    for q in (0.0, 0.1, 0.5, 0.93, 1.0):
        g = tstats.cdf_quantile(torch.as_tensor(img), q, bins,
                                None if valid is None else torch.as_tensor(valid))
        w = jstats.cdf_quantile(jnp.asarray(img), q, bins,
                                None if valid is None else jnp.asarray(valid))
        _eq(g, w)


@pytest.mark.parametrize("size", [2, 3, 4, 5])
def test_median_filter_matches_jax(size):
    img = np.round(RNG.random((13, 16)) * 20).astype(np.float32)   # ties
    img[5, 7] = np.nan
    _eq(twin.median_filter(img, size, device="cpu"), jwin.median_filter(jnp.asarray(img), size))


@pytest.mark.parametrize("sigma,passes", [(1.0, 3), (2.5, 3), (1.5, 2)])
def test_gaussian_blur_approx_matches_jax(sigma, passes):
    img = RNG.random((70, 72)).astype(np.float32)
    got = twin.gaussian_blur_approx(img, sigma, passes, device="cpu").numpy()
    want = np.asarray(jwin.gaussian_blur_approx(jnp.asarray(img), sigma, passes))
    assert np.abs(got - want).max() <= 1e-5


def test_window_views_and_fourier():
    _eq(twin.constant_view(2.5, 3, 4, device="cpu"), jwin.constant_view(2.5, 3, 4))
    a = twin.uniform_noise_view(7, 33, 20, device="cpu")
    assert a.shape == (33, 20) and a.dtype == torch.float32
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0 and float(a.std()) > 0.2
    assert torch.equal(a, twin.uniform_noise_view(7, 33, 20, device="cpu"))
    assert not torch.equal(a, twin.uniform_noise_view(8, 33, 20, device="cpu"))
    for factor in (2, 3):
        _eq(twin.antialiased_downsample(IMG, factor, device="cpu"),
            jwin.antialiased_downsample(jnp.asarray(IMG), factor))
    spec = twin.fft2(IMG, device="cpu")
    np.testing.assert_allclose(spec.numpy(), np.asarray(jwin.fft2(jnp.asarray(IMG))),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(twin.ifft2(spec).real.numpy(), IMG, atol=1e-6)
    _eq(twin.fftshift(torch.as_tensor(IMG)), jwin.fftshift(jnp.asarray(IMG)))
    for beta in (0.35, 0.6):
        np.testing.assert_allclose(twin.raised_cosine_window(9, 14, beta, device="cpu").numpy(),
                                   np.asarray(jwin.raised_cosine_window(9, 14, beta)),
                                   rtol=0, atol=1e-6)


CONVERSIONS = ["rgb_to_gray", "gray_to_rgb", "rgb_to_hsv", "hsv_to_rgb", "rgb_to_xyz",
               "xyz_to_rgb", "xyz_to_lab", "lab_to_xyz", "rgb_to_lab", "lab_to_rgb",
               "xyz_to_luv", "rgb_to_luv", "weighted_rgb_to_gray"]


@pytest.mark.parametrize("name", CONVERSIONS)
def test_pixel_types_match_jax(name):
    rgb = RGB.copy()
    rgb[0, :3] = [[0.5, 0.5, 0.5], [0.0, 0.0, 0.0], [1.0, 0.2, 0.2]]   # grey, black, red
    x = {"gray_to_rgb": rgb[..., 0], "xyz_to_lab": rgb * 0.9, "lab_to_xyz":
         np.asarray(jpix.rgb_to_lab(jnp.asarray(rgb))), "lab_to_rgb":
         np.asarray(jpix.rgb_to_lab(jnp.asarray(rgb))), "hsv_to_rgb":
         np.asarray(jpix.rgb_to_hsv(jnp.asarray(rgb)))}.get(name, rgb)
    got = getattr(tpix, name)(x, device="cpu").numpy()
    want = np.asarray(getattr(jpix, name)(jnp.asarray(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)


def test_sparse_view_matches_jax():
    views = [cls(20, 30, background=-1.0) for cls in (tsparse.SparseView, jsparse.SparseView)]
    patches = [(RNG.random((4, 6)), 2, 3), (RNG.random((5, 5)), 25, 17), (np.ones((2, 2)), -1, -1)]
    for v in views:
        for p, x, y in patches:
            v.insert(p, x, y)
    t, j = views
    for x, y in ((2, 3), (7, 6), (0, 0), (29, 19), (26, 18), (10, 10)):
        assert t(x, y) == j(x, y)
    _eq(t.rasterize(), j.rasterize())
    _eq(t.rasterize(BBox2i(1, 2, 12, 9)), j.rasterize(JBBox2i(1, 2, 12, 9)))


def test_image_package_exports():
    """Every name the JAX package's ``image/__init__.py`` imports, the
    port's exports too."""
    tree = ast.parse(open(jimage.__file__).read())
    names = [a.name for node in tree.body if isinstance(node, ast.ImportFrom)
             for a in node.names]
    missing = [n for n in names if not hasattr(timage, n)]
    assert len(names) > 50 and not missing, missing
