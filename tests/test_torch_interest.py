"""The port's interest points (``visionworkbench_torch/interest/``: types,
operators, the detector, the descriptors and the ``.vwip`` / ``.match``
files), the rest of ``image/filters`` and ``image/algorithms`` against the
JAX package on the CPU, on seeded NumPy inputs. The JAX package runs once
per call shape, in module fixtures.

Tolerances, in layers:

* exact: the files (byte-equal both ways), ``_peaks_to_points`` on one
  response map (the whole tuple, invalid slots included), the eager
  filters and algorithms, ``to_numpy`` / ``from_numpy``, ``PCABasis``
  ``.npz`` files both ways;
* responses within 1e-6 of their largest magnitude (XLA contracts the
  Harris ``det`` into a multiply-add under ``jit``; the JAX package's eager
  responses here measured equal);
* the detector end to end: >= 99 % of the JAX package's valid points have
  a port point within 1e-3 px (measured 100 %);
* orientations within 1e-5 rad on >= 97 % of points (measured 4.8e-7 on
  every point: the bin centre's ``/ 36 * 2 * pi``, and a 9x9 histogram
  whose sum order differs from XLA's scatter-add);
* descriptors on shared points: every patch descriptor within 2e-6
  (measured 5.5e-7: XLA fuses the bilinear blend into multiply-adds);
  sgrad within 1e-5 on >= 95 % of the points upright and >= 85 % on
  rotated supports, and within 0.1 in L2 on all: a gradient angle within
  an ulp of a bin edge moves its weighted magnitude to the next bin, and
  the rotated supports' cos/sin and blends differ by ulps (measured:
  upright 63 of 64 within 1e-5, L2 <= 4.3e-4; rotated 57 of 64, L2 <=
  0.057).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter as ndi_gauss

from torch_parity import _torch_threads  # noqa: F401
import visionworkbench_tpu.image.algorithms as jalg
import visionworkbench_tpu.image.filters as jfilt
import visionworkbench_tpu.interest as jint
import visionworkbench_tpu.interest.descriptor as jdesc
import visionworkbench_tpu.interest.detector as jdet
import visionworkbench_tpu.interest.io as jio
import visionworkbench_tpu.interest.types as jtypes
import visionworkbench_torch.image.algorithms as talg
import visionworkbench_torch.image.filters as tfilt
import visionworkbench_torch.interest as tint
import visionworkbench_torch.interest.descriptor as tdesc
import visionworkbench_torch.interest.detector as tdet
import visionworkbench_torch.interest.io as tio
import visionworkbench_torch.interest.types as ttypes
from visionworkbench_torch.core.exceptions import ArgumentErr

H, W = 128, 120


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.fixture(scope="module")
def scene():
    """A smooth random texture (as the JAX package's interest tests) and a
    view of it shifted by (7, 3)."""
    rng = np.random.default_rng(21)
    base = ndi_gauss(rng.random((H + 20, W + 20)), 1.5).astype(np.float32)
    return base[:H, :W].copy(), base[3:3 + H, 7:7 + W].copy()


@pytest.fixture(scope="module")
def jax_points(scene):
    """The JAX package's detections on the first image: single-scale
    Harris / LoG and the scaled LoG, the Harris points with orientations."""
    img = jnp.asarray(scene[0])
    harris = jint.detect_points(img, "harris", max_points=64, threshold=1e-8)
    return {"harris": harris,
            "log": jint.detect_points(img, "log", max_points=64, threshold=1e-3),
            "scaled": jint.detect_points_scaled(img, "log", threshold=1e-4, max_points=64),
            "oriented": jint.assign_orientations(img, harris)}


def _shared(jp):
    """The JAX package's points as the port's (CPU tensors)."""
    return ttypes.InterestPoints(*(None if v is None else torch.as_tensor(np.array(v))
                                   for v in jp))


# ---- io -------------------------------------------------------------------

def _records(rng, n, dlen):
    d = {"x": (rng.random(n) * 100).astype(np.float32),
         "y": (rng.random(n) * 90).astype(np.float32),
         "scale": (1 + rng.random(n)).astype(np.float32),
         "orientation": (rng.random(n) * 6 - 3).astype(np.float32),
         "interest": rng.random(n).astype(np.float32)}
    if dlen:
        d["descriptor"] = rng.random((n, dlen)).astype(np.float32)
    return d


@pytest.mark.parametrize("dlen", [0, 128])
def test_io_files_byte_equal(tmp_path, dlen):
    """``.vwip``, binary ``.match`` and text match files: the same bytes
    from both packages, each read back by the other."""
    rng = np.random.default_rng(dlen)
    a, b = _records(rng, 9, dlen), _records(rng, 9, dlen)
    for name, write in (("p.vwip", lambda m, p: m.write_binary_ip_file(p, a)),
                        ("p.match", lambda m, p: m.write_binary_match_file(p, a, b)),
                        ("p.txt", lambda m, p: m.write_text_match_file(p, a, b))):
        paths = {}
        for tag, mod in (("jax", jio), ("torch", tio)):
            paths[tag] = str(tmp_path / f"{tag}_{name}")
            write(mod, paths[tag])
        with open(paths["jax"], "rb") as f, open(paths["torch"], "rb") as g:
            assert f.read() == g.read(), name
    got = tio.read_binary_ip_file(str(tmp_path / "jax_p.vwip"))
    ref = jio.read_binary_ip_file(str(tmp_path / "torch_p.vwip"))
    assert got.keys() == ref.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], ref[k])
    for fn, name in ((tio.read_binary_match_file, "jax_p.match"),
                     (tio.read_text_match_file, "jax_p.txt")):
        for side_t, side_j in zip(fn(str(tmp_path / name)),
                                  getattr(jio, fn.__name__)(str(tmp_path / name))):
            for k in side_j:
                np.testing.assert_array_equal(side_t[k], side_j[k])
    assert tio.match_filename("o/", "/a/l.tif", "/b/r.tif") == \
        jio.match_filename("o/", "/a/l.tif", "/b/r.tif") == "o/l__r.match"
    with pytest.raises(tio.IOErr):
        tio.write_text_match_file(str(tmp_path / "x.match"), a, b)


# ---- filters and algorithms -------------------------------------------------

@pytest.mark.parametrize("case", [
    ("sobel_filter", (True,)), ("sobel_filter", (False,)),
    ("gaussian_derivative_filter", (1.5, 1, 1.0, 0, 0.3, 7)),
    ("gaussian_derivative_filter", (1.2, 2, 1.2, 1, 0.0, 9)),
    ("laplacian_of_gaussian_filter", (1.0,)), ("laplacian_of_gaussian_filter", (0.8, 5))])
def test_filters_match_jax(scene, case):
    """Equal where the kernel has <= 49 taps (the shifted-slice stencil);
    within 1e-5 of the output's largest magnitude past it (the two
    convolutions sum 81 taps in other orders; measured 1.1e-6)."""
    name, args = case
    img = scene[0]
    ref = np.asarray(getattr(jfilt, name)(jnp.asarray(img), *args))
    got = _np(getattr(tfilt, name)(torch.as_tensor(img), *args))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    if name == "sobel_filter" or args[-1] == 5:
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("case", ["clamp", "normalize", "normalize_valid", "normalize_range",
                                  "normalize_flat", "threshold", "fill", "opacity", "bbox"])
def test_algorithms_match_jax(case):
    rng = np.random.default_rng(5)
    img = (rng.random((17, 23)) * 3 - 1).astype(np.float32)
    rgba = rng.random((9, 11, 4)).astype(np.float32)
    valid = rng.random((17, 23)) > 0.3
    t = torch.as_tensor(img)
    if case == "opacity":
        opaque = rgba.copy()
        opaque[..., 3] = 1.0
        for x, v in ((rgba, None), (opaque, None), (img, None), (img, valid),
                     (img, np.zeros_like(valid)), (img, np.ones_like(valid))):
            for q in ("is_opaque", "is_transparent"):
                assert getattr(talg, q)(torch.as_tensor(x), v) == \
                    getattr(jalg, q)(jnp.asarray(x), v)
        return
    if case == "bbox":
        z = np.zeros((20, 30), np.float32)
        z[4:9, 7:19] = 1.0
        for x in (z, np.zeros_like(z), np.stack([z, z], -1)):
            a, b = talg.nonzero_data_bounding_box(torch.as_tensor(x)), \
                jalg.nonzero_data_bounding_box(x)
            assert (a.min_x, a.min_y, a.max_x, a.max_y) == (b.min_x, b.min_y, b.max_x, b.max_y)
        return
    calls = {
        "clamp": lambda m, x: m.clamp(x, -0.2, 0.7),
        "normalize": lambda m, x: m.normalize(x),
        "normalize_valid": lambda m, x: m.normalize(x, -1.0, 3.0, valid=valid),
        "normalize_range": lambda m, x: m.normalize(x, 0.0, 255.0, -1.0, 2.0),
        "normalize_flat": lambda m, x: m.normalize(x * 0 + 2.0, 0.5, 1.0),
        "threshold": lambda m, x: m.threshold(x, 0.4, -1.0, 2.0),
        "fill": lambda m, x: m.fill(x, 3.5),
    }
    ref = np.asarray(calls[case](jalg, jnp.asarray(img)))
    got = _np(calls[case](talg, t))
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(_np(talg.fill((3, 4), 2.0, device="cpu")),
                                  np.asarray(jalg.fill((3, 4), 2.0)))


# ---- operators and the detector ---------------------------------------------

@pytest.mark.parametrize("op", ["harris", "harris_k", "log", "gradients"])
def test_operators_match_jax(scene, op):
    img = scene[0]
    calls = {"harris": lambda m, x: [m.harris_interest(x, 1.0)],
             "harris_k": lambda m, x: [m.harris_interest(x, 1.5, 0.04)],
             "log": lambda m, x: [m.log_interest(x, 1.3)],
             "gradients": lambda m, x: list(m.image_gradients(x))}
    for ref, got in zip(calls[op](jint, jnp.asarray(img)), calls[op](tint, torch.as_tensor(img))):
        ref, got = np.asarray(ref), _np(got)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("k", [16, 64, 3840])
@pytest.mark.parametrize("masked", [False, True])
def test_peaks_to_points_exact(scene, k, masked):
    """On one response map (odd-sized too) the whole tuple equals the JAX
    package's, the invalid slots included (k = 3840: every 2x2 block of
    the 128x120 map, most of them -inf)."""
    resp = np.abs(np.asarray(jint.log_interest(jnp.asarray(scene[0]), 1.0)))
    mask = np.random.default_rng(k).random(resp.shape) > 0.2 if masked else None
    for r, m in ((resp, mask), (resp[:-1, :-3], None if mask is None else mask[:-1, :-3])):
        kk = min(k, ((r.shape[0] + 1) // 2) * ((r.shape[1] + 1) // 2))
        ref = jdet._peaks_to_points(jnp.asarray(r), jnp.float32(1e-3), kk,
                                    None if m is None else jnp.asarray(m))
        got = tdet._peaks_to_points(torch.as_tensor(r), 1e-3, kk,
                                    None if m is None else torch.as_tensor(m))
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(_np(a), np.asarray(b))
        assert 0 < int(np.asarray(ref[3]).sum()) < kk or k < 3840


def _share_within(ref_pts, got_pts, tol):
    """Share of ``ref_pts``' valid points with a ``got_pts`` point within
    ``tol`` px."""
    r, g = ref_pts.to_numpy(), got_pts.to_numpy()
    a = np.stack([r["x"], r["y"]], -1)
    b = np.stack([g["x"], g["y"]], -1)
    d = np.sqrt(((a[:, None] - b[None]) ** 2).sum(-1)).min(1)
    return (d <= tol).mean(), len(a)


@pytest.mark.parametrize("which", ["harris", "log", "scaled"])
def test_detector_matches_jax(scene, jax_points, which):
    img = scene[0]
    got = {"harris": lambda: tint.detect_points(img, "harris", max_points=64, threshold=1e-8,
                                                device="cpu"),
           "log": lambda: tint.detect_points(img, "log", max_points=64, threshold=1e-3,
                                             device="cpu"),
           "scaled": lambda: tint.detect_points_scaled(img, "log", threshold=1e-4,
                                                       max_points=64, device="cpu")}[which]()
    ref = jax_points[which]
    share, n = _share_within(ref, got, 1e-3)
    assert n >= 20 and share >= 0.99
    np.testing.assert_array_equal(_np(got.valid), np.asarray(ref.valid))
    np.testing.assert_allclose(_np(got.scale), np.asarray(ref.scale))


def test_assign_orientations_matches_jax(scene, jax_points):
    ref = jax_points["oriented"]
    got = tint.assign_orientations(scene[0], _shared(jax_points["harris"]))
    d = np.abs(_np(got.orientation) - np.asarray(ref.orientation))
    d = np.minimum(d, 2 * np.pi - d)
    assert (d <= 1e-5).mean() >= 0.97
    assert np.all(_np(got.orientation)[~np.asarray(ref.valid)] == 0)


@pytest.mark.parametrize("kind", ["patch", "sgrad", "pca"])
@pytest.mark.parametrize("upright", [True, False])
def test_descriptors_match_jax(scene, jax_points, kind, upright, tmp_path):
    """On shared points: the Harris points, upright or with the JAX
    package's orientations (rotated supports through ``interpolate``)."""
    img = scene[0]
    jp = jax_points["harris" if upright else "oriented"]
    basis = None
    if kind == "pca":
        train = np.random.default_rng(3).random((64, 17, 17)).astype(np.float32)
        basis = jdesc.fit_pca_basis(train, 12)
    ref = np.asarray(jint.describe(jnp.asarray(img), jp, kind, pca_basis=basis,
                                   upright=upright).descriptor)
    got = _np(tint.describe(img, _shared(jp), kind, upright=upright,
                            pca_basis=None if basis is None else
                            tdesc.PCABasis(basis.basis, basis.avg)).descriptor)
    assert got.shape == ref.shape
    if kind == "sgrad":
        assert (np.abs(got - ref).max(1) <= 1e-5).mean() >= (0.95 if upright else 0.85)
        assert np.linalg.norm(got - ref, axis=1).max() <= 0.1
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)


def test_pca_basis_files_cross_package(tmp_path):
    """``fit_pca_basis`` is the same NumPy code; a basis saved by either
    package loads in the other with the same arrays."""
    train = np.random.default_rng(4).random((40, 9, 9)).astype(np.float32)
    jb, tb = jdesc.fit_pca_basis(train, 6), tdesc.fit_pca_basis(train, 6)
    np.testing.assert_array_equal(tb.basis, jb.basis)
    np.testing.assert_array_equal(tb.avg, jb.avg)
    jb.save(str(tmp_path / "j.npz"))
    tb.save(str(tmp_path / "t.npz"))
    for a, b in ((tdesc.PCABasis.load(str(tmp_path / "j.npz")), jb),
                 (jdesc.PCABasis.load(str(tmp_path / "t.npz")), tb)):
        np.testing.assert_array_equal(a.basis, b.basis)
        np.testing.assert_array_equal(a.avg, b.avg)
        assert a.size == b.size == 9
    with pytest.raises(ArgumentErr):
        tdesc.PCABasis(np.zeros((4, 2)), np.zeros(5))
    with pytest.raises(ArgumentErr):
        tint.describe(np.zeros((8, 8), np.float32),
                      ttypes.from_numpy({"x": [3.0], "y": [3.0]}, "cpu"), "pca")


# ---- types ------------------------------------------------------------------

def test_to_numpy_from_numpy_match_jax(jax_points):
    """``to_numpy`` (valid points, the stable interest sort: equal
    responses keep their slot order) and ``from_numpy`` round trips."""
    jp = jax_points["harris"]
    interest = np.asarray(jp.interest).copy()
    interest[5:9] = interest[5]          # ties for the stable sort
    valid = np.asarray(jp.valid).copy()
    valid[[2, 7]] = False
    desc = np.random.default_rng(1).random((jp.capacity, 8)).astype(np.float32)
    jp = jp._replace(interest=jnp.asarray(interest), valid=jnp.asarray(valid),
                     descriptor=jnp.asarray(desc))
    ref = jp.to_numpy()
    got = _shared(jp).to_numpy()
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    back = ttypes.from_numpy(ref, device="cpu")
    jback = jtypes.from_numpy(ref)
    for a, b in zip(back, jback):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    assert back.count() == jback.count() == len(ref["x"])
    part = ttypes.from_numpy({"x": [1.0, 2.0], "y": [3.0, 4.0]}, device="cpu")
    assert part.descriptor is None and part.scale.tolist() == [1.0, 1.0]


def test_octave_history_and_plane_index():
    for args in ((1, 3, 1.0), (2, 3, 2.9), (4, 5, 7.5), (1, 2, 1.41)):
        assert ttypes.scale_to_plane_index(*args) == jtypes.scale_to_plane_index(*args)
    th, jh = ttypes.ImageOctaveHistory(), jtypes.ImageOctaveHistory()
    for o in range(2):
        planes = [f"{o}:{p}" for p in range(5)]
        th.add_octave(planes)
        jh.add_octave(planes)
    assert th.octaves() == 2 and th.scales() == 3
    for s in (1.0, 1.3, 2.0, 2.6, 3.9):
        assert th.image_at_scale(s) == jh.image_at_scale(s)
    with pytest.raises(ArgumentErr):
        th.image_at_scale(0.3)


def test_concatenate_and_not_ported(scene):
    img = torch.as_tensor(scene[0])
    a = tint.detect_points(img, "harris", max_points=8, threshold=1e-8)
    b = tint.describe(img, a, "patch")
    c = tint.concatenate_points([a, a])
    assert c.capacity == 16 and c.descriptor is None
    assert tint.concatenate_points([b, b]).descriptor.shape == (16, 289)
    with pytest.raises(ArgumentErr):
        tint.detect_points(img, "sobel")
    with pytest.raises(ArgumentErr):
        tint.describe(img, a, "brief")
