"""The port's SIFT-class interest points (configuration 8:
``detect_points_dog``, ``assign_orientations_scaled``,
``sift_orient_describe``, ``detect_sift_like`` on both routes,
``detect_points_obalog``) and ``image/integral`` against the JAX package on
the CPU, on seeded NumPy inputs: a smooth random texture (160^2) and a
Gaussian blob (96^2: three octaves, then the ``< 16`` break). The JAX
package runs once per frame, in module fixtures.

Tolerances:

* DoG detection: ``(x, y, interest, valid)`` and the octave blocks equal
  bit for bit (the same stencils, comparisons and peak ranking); ``scale``
  within 1e-6 relative (``2 ** t``).
* Orientations within 1e-4 rad on >= 0.9 of the valid points, descriptors
  within 1e-5 on the points whose orientations agree (>= 0.9 of them on the
  rotated-support route), every descriptor of an agreeing point within 0.1
  in L2. The JAX package's describers are jitted, so XLA folds each
  division by a constant into a multiply (the port's ``angle_bins`` does
  the same) and fuses the bilinear blends and the resampling products into
  multiply-adds. Where samples clamp outside the frame, a gradient
  component is then exactly 0 in one package and an ulp off it in the
  other, its angle sits exactly on a bin edge, and a near-tie of two
  histogram peaks can flip. Measured over five frames (96-192^2): 0.947-1.0
  of the points agree, descriptors within 1e-6 on the default route.
* ``image/integral``: the port's tables are float64 (exact prefixes); the
  JAX package's fp32 prefixes carry ~1-2 ulps of the largest prefix (4.9e-4
  at 96^2, 3.9e-3 at 256^2, measured). Tables within 4 ulps of the
  largest prefix, box sums within 16 (four prefixes), Haar within 32;
  OBALoG detection: >= 0.99 of the JAX package's points within 0.01 px of a
  port point (measured 100 %, at most 0.006 px at 160^2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter as ndi_gauss

from torch_parity import _torch_threads, cuda  # noqa: F401
import visionworkbench_tpu.image.integral as jintegral
import visionworkbench_tpu.interest.descriptor as jdesc
import visionworkbench_tpu.interest.detector as jdet
import visionworkbench_torch.image.integral as tintegral
import visionworkbench_torch.interest.descriptor as tdesc
import visionworkbench_torch.interest.detector as tdet
from visionworkbench_torch.core.exceptions import ArgumentErr
from visionworkbench_torch.interest.types import from_numpy

N_TEX = 160
POINTS = 200
FIELDS = ("x", "y", "scale", "orientation", "interest")


def _texture(n, seed):
    rng = np.random.default_rng(seed)
    return ndi_gauss(rng.random((n + 20, n + 20)), 1.5).astype(np.float32)[:n, :n].copy()


def _blob(n=96, sig=3.0, seed=5):
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32)
    img = np.exp(-((xx - n / 2) ** 2 + (yy - n / 2) ** 2) / (2 * sig * sig))
    rng = np.random.default_rng(seed)
    return (img + 0.01 * rng.random((n, n))).astype(np.float32)


FRAMES = {"texture160": (lambda: _texture(N_TEX, 0), {"max_points": POINTS}),
          "blob96": (_blob, {"threshold": 0.005, "max_points": 50})}


def _port_points(jp):
    """The JAX package's point set, every slot, through ``from_numpy``
    (which marks all valid) with its own validity."""
    d = {f: np.asarray(getattr(jp, f)) for f in FIELDS}
    return from_numpy(d, device="cpu")._replace(
        valid=torch.as_tensor(np.asarray(jp.valid)))


def _angle_diff(a, b):
    d = np.abs(np.asarray(a) - np.asarray(b))
    return np.minimum(d, 2 * np.pi - d)


@pytest.fixture(scope="module")
def dog_ref():
    """Each frame and the JAX package's DoG detection with its blocks."""
    out = {}
    for name, (make, kw) in FRAMES.items():
        img = make()
        out[name] = (img, kw, *jdet.detect_points_dog(jnp.asarray(img), return_blocks=True, **kw))
    return out


@pytest.fixture(scope="module")
def sift_ref(dog_ref):
    """The JAX package on the texture: scale-aware orientations, the
    octave describer on its own points, and ``detect_sift_like`` on both
    routes (``VWTPU_SIFT_GATHER`` 0 and 1)."""
    img, kw, jp, jb = dog_ref["texture160"]
    ref = {"oriented": jdet.assign_orientations_scaled(jnp.asarray(img), jp),
           "described": jdesc.sift_orient_describe(jp, jb)}
    with pytest.MonkeyPatch.context() as mp:
        for route in ("0", "1"):
            mp.setenv("VWTPU_SIFT_GATHER", route)
            ref[route] = jdet.detect_sift_like(jnp.asarray(img), **kw)
    return img, kw, jp, jb, ref


@pytest.mark.parametrize("frame", list(FRAMES))
def test_detect_points_dog_matches_jax(dog_ref, frame):
    img, kw, jp, jb = dog_ref[frame]
    pts, blocks = tdet.detect_points_dog(img, return_blocks=True, device="cpu", **kw)
    for f in ("x", "y", "interest", "valid"):
        assert np.array_equal(getattr(pts, f).numpy(), np.asarray(getattr(jp, f))), f
    np.testing.assert_allclose(pts.scale.numpy(), np.asarray(jp.scale), rtol=1e-6, atol=0)
    assert [b[1:] for b in blocks] == [tuple(b[1:]) for b in jb]
    for (base, *_), (jbase, *_) in zip(blocks, jb):
        assert np.array_equal(base.numpy(), np.asarray(jbase))
    assert pts.valid.sum() >= (1 if frame == "blob96" else 10)
    if frame == "blob96":       # three octaves, then the < 16 break
        assert len(blocks) == 3 and pts.capacity == 3 * 6 * (50 // 12)
        v = pts.valid.numpy()
        d = np.hypot(pts.x.numpy()[v] - 48, pts.y.numpy()[v] - 48)
        assert d.min() < 2.0


def _held(ori, ref_ori, valid, desc=None, ref_desc=None, desc_share=1.0):
    """Orientations within 1e-4 rad on >= 0.9 of the valid points; the
    agreeing points' descriptors within 1e-5 (on ``desc_share`` of them)
    and 0.1 in L2."""
    v = np.asarray(valid)
    agree = _angle_diff(ori, ref_ori)[v] <= 1e-4
    assert v.sum() >= 10 and agree.mean() >= 0.9, agree.mean()
    if desc is not None:
        diff = (np.asarray(desc) - np.asarray(ref_desc))[v][agree]
        assert (np.abs(diff).max(1) <= 1e-5).mean() >= desc_share
        assert np.linalg.norm(diff, axis=1).max() <= 0.1


def test_assign_orientations_scaled_matches_jax(sift_ref):
    img, _, jp, _, ref = sift_ref
    got = tdet.assign_orientations_scaled(img, _port_points(jp))
    _held(got.orientation.numpy(), ref["oriented"].orientation, jp.valid)
    assert (got.orientation.numpy()[~np.asarray(jp.valid)] == 0).all()


def test_sift_orient_describe_on_jax_points_and_blocks(sift_ref):
    """The describer apart from detection: the JAX package's points and
    octave bases in, orientations and descriptors held."""
    _, _, jp, jb, ref = sift_ref
    blocks = [(torch.as_tensor(np.asarray(b)), s, s0, s1) for b, s, s0, s1 in jb]
    got = tdesc.sift_orient_describe(_port_points(jp), blocks)
    want = ref["described"]
    assert got.descriptor.shape == (jp.x.shape[0], 128)
    _held(got.orientation.numpy(), want.orientation, jp.valid,
          got.descriptor.numpy(), want.descriptor)
    norms = np.linalg.norm(got.descriptor.numpy()[np.asarray(jp.valid)], axis=1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-5)


@pytest.mark.parametrize("route", ["0", "1"])
def test_detect_sift_like_matches_jax(sift_ref, route, monkeypatch):
    img, kw, jp, _, ref = sift_ref
    monkeypatch.setenv("VWTPU_SIFT_GATHER", route)
    got = tdet.detect_sift_like(img, device="cpu", **kw)
    want = ref[route]
    for f in ("x", "y", "interest", "valid"):
        assert np.array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f))), f
    _held(got.orientation.numpy(), want.orientation, want.valid, got.descriptor.numpy(),
          want.descriptor, desc_share=1.0 if route == "0" else 0.9)


def test_integral_image_and_box_filters_match_jax():
    img = _texture(96, 3)[:90]          # 90 x 96
    ii = tintegral.integral_image(img, device="cpu")
    jii = np.asarray(jintegral.integral_image(jnp.asarray(img)))
    assert ii.dtype == torch.float64 and ii.shape == (91, 97)
    assert (ii[0] == 0).all() and (ii[:, 0] == 0).all()
    ulp = float(np.spacing(np.float32(jii.max())))
    assert np.abs(ii.numpy() - jii).max() <= 4 * ulp
    exact = np.cumsum(np.cumsum(img.astype(np.float64), 0), 1)
    assert np.abs(ii[1:, 1:].numpy() - exact).max() <= 1e-9
    # vectorized box queries
    x0, y0 = torch.tensor([0, 5, 17]), torch.tensor([0, 9, 40])
    box = tintegral.integral_box_sum(ii, x0, y0, x0 + 7, y0 + 11).numpy()
    want = [img[b:b + 11, a:a + 7].astype(np.float64).sum() for a, b in zip([0, 5, 17], [0, 9, 40])]
    np.testing.assert_allclose(box, want, rtol=1e-12)
    for size in (3, 9, 27):
        got = tintegral.box_filter_same(img, size, device="cpu").numpy()
        ref = np.asarray(jintegral.box_filter_same(jnp.asarray(img), size))
        r = size // 2
        pad = np.pad(img.astype(np.float64), r + 1, mode="edge")
        total = float(np.spacing(np.float32(np.abs(pad).sum())))
        assert got.dtype == np.float32 and np.abs(got - ref).max() <= 16 * total
        windows = np.lib.stride_tricks.sliding_window_view(pad[1:-1, 1:-1], (size, size))
        direct = windows.sum((-1, -2))
        np.testing.assert_allclose(got, direct, rtol=1e-6)
    for fn in ("haar_x", "haar_y"):
        got = getattr(tintegral, fn)(img, 8, device="cpu").numpy()
        ref = np.asarray(getattr(jintegral, fn)(jnp.asarray(img), 8))
        total = float(np.spacing(np.float32(np.abs(np.pad(img, 8, mode="edge")).sum())))
        assert np.abs(got - ref).max() <= 32 * total
    with pytest.raises(ArgumentErr):
        tintegral.haar_x(img, 7, device="cpu")


def test_obalog_matches_jax(dog_ref):
    img = dog_ref["texture160"][0]
    for level in (0, 1, 2):
        got = tintegral.obalog_interest(img, level, device="cpu").numpy()
        ref = np.asarray(jintegral.obalog_interest(jnp.asarray(img), level))
        inner = 3 * (1 << level) | 1
        outer = 3 * (3 * (1 << level)) | 1
        spacing = float(np.spacing(np.float32(np.abs(np.pad(img, outer, mode="edge")).sum())))
        assert np.abs(got - ref).max() <= 16 * spacing * (1 / inner ** 2 + 1 / outer ** 2) + 1e-6
    jp = jdet.detect_points_obalog(jnp.asarray(img), max_points=POINTS)
    pts = tdet.detect_points_obalog(img, max_points=POINTS, device="cpu")
    assert pts.capacity == jp.x.shape[0] == 3 * (POINTS // 3)
    assert sorted(set(pts.scale.tolist())) == [1.0, 2.0, 4.0]
    jv, v = np.asarray(jp.valid), pts.valid.numpy()
    a = np.stack([np.asarray(jp.x)[jv], np.asarray(jp.y)[jv]], -1)
    b = np.stack([pts.x.numpy()[v], pts.y.numpy()[v]], -1)
    near = np.sqrt(((a[:, None] - b[None]) ** 2).sum(-1)).min(1)
    assert len(a) >= 50 and abs(len(a) - len(b)) <= 0.01 * len(a)
    assert (near <= 0.01).mean() >= 0.99


def test_sift_gather_switch_read_on_every_call(monkeypatch):
    """``VWTPU_SIFT_GATHER`` is read on each call: the two routes give the
    same points and different describers (the octave describer's
    descriptors are not the rotated supports')."""
    img = _texture(64, 9)
    runs = {}
    for route in ("1", "0"):
        monkeypatch.setenv("VWTPU_SIFT_GATHER", route)
        runs[route] = tdet.detect_sift_like(img, max_points=48, device="cpu")
    assert torch.equal(runs["0"].x, runs["1"].x) and torch.equal(runs["0"].valid, runs["1"].valid)
    v = runs["0"].valid
    assert v.any() and not torch.equal(runs["0"].descriptor[v], runs["1"].descriptor[v])


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["0", "1"])
def test_detect_sift_like_card_matches_cpu(cuda, route, monkeypatch):
    """Card against CPU at 256^2: the points equal, orientations within
    1e-4 rad on >= 0.99 of the valid points, the descriptors of >= 0.99 of
    those within 1e-4 and all within 0.1 in L2 (a gradient angle within an
    ulp of a bin edge may land in the other bin; ``chip_smoke.py``'s
    ``_sift_vs_cpu``)."""
    monkeypatch.setenv("VWTPU_SIFT_GATHER", route)
    img = _texture(256, 13)
    card = tdet.detect_sift_like(torch.as_tensor(img, device=cuda), max_points=512)
    cpu = tdet.detect_sift_like(img, max_points=512, device="cpu")
    for f in ("x", "y", "interest", "valid"):
        assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f)), f
    v = cpu.valid.numpy()
    agree = _angle_diff(card.orientation.cpu(), cpu.orientation)[v] <= 1e-4
    assert v.sum() >= 20 and agree.mean() >= 0.99
    diff = (card.descriptor.cpu() - cpu.descriptor).numpy()[v][agree]
    assert (np.abs(diff).max(1) <= 1e-4).mean() >= 0.99
    assert np.linalg.norm(diff, axis=1).max() <= 0.1
