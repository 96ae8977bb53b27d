"""Port's morphology (``visionworkbench_torch/image/morphology.py``)
against the JAX package on the CPU, on the same numpy masks: blob labels
(int32, the minimum flat index of each component, -1 outside), areas,
``remove_small_blobs`` and ``blob_sizes`` exact, with 4- and
8-connectivity; ``grassfire`` (also against ``grassfire_np``),
``euclidean_distance_sq``, ``two_threshold_fill``, erode and dilate exact
(integer-valued or boolean results); ``fill_holes`` within 1e-6 (its 3x3
sums run in another order; measured 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import _torch_threads, cuda  # noqa: F401
from visionworkbench_tpu.image import morphology as jmorph
from visionworkbench_torch.image import morphology as tmorph


def _masks():
    """Random masks of several densities, a one-pixel-wide snake (a long
    chain for the propagation), diagonal-only neighbours (joined by
    8-connectivity alone), an empty and a full mask."""
    rng = np.random.default_rng(90)
    out = [rng.random((37, 53)) < p for p in (0.3, 0.55, 0.75)]
    snake = np.zeros((21, 30), bool)
    for r in range(0, 21, 2):
        snake[r, :] = True
        snake[r + 1 if r + 1 < 21 else r, 29 if r % 4 == 0 else 0] = True
    diag = np.zeros((12, 12), bool)
    diag[np.arange(12), np.arange(12)] = True
    diag[0, 11] = True
    return out + [snake, diag, np.zeros((5, 7), bool), np.ones((6, 4), bool)]


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("case", range(7))
def test_blob_index_matches_jax(connectivity, case):
    mask = _masks()[case]
    got = tmorph.blob_index(torch.as_tensor(mask), connectivity)
    ref = np.asarray(jmorph.blob_index(jnp.asarray(mask), connectivity))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("connectivity", [4, 8])
def test_blob_areas_and_remove_small_blobs_match_jax(connectivity):
    for mask in _masks():
        labels = tmorph.blob_index(torch.as_tensor(mask), connectivity)
        jlabels = jmorph.blob_index(jnp.asarray(mask), connectivity)
        areas = tmorph.blob_areas(labels)
        assert areas.dtype == torch.int32
        np.testing.assert_array_equal(areas.numpy(), np.asarray(jmorph.blob_areas(jlabels)))
        for min_area in (1, 3, 12, 10_000):
            keep = tmorph.remove_small_blobs(torch.as_tensor(mask), min_area, connectivity)
            np.testing.assert_array_equal(
                keep.numpy(),
                np.asarray(jmorph.remove_small_blobs(jnp.asarray(mask), min_area,
                                                     connectivity)))
            assert not (keep.numpy() & ~mask).any()


def test_labels_do_not_depend_on_the_check_interval(monkeypatch):
    """The fixpoint is the same whether it is tested after every pass (as
    the JAX package does) or after several: the snake needs many passes."""
    mask = torch.as_tensor(_masks()[3])
    every = tmorph._CHECK_EVERY
    labels, passes = tmorph._blob_labels(mask)
    monkeypatch.setattr(tmorph, "_CHECK_EVERY", 1)
    labels1, passes1 = tmorph._blob_labels(mask)
    np.testing.assert_array_equal(labels.numpy(), labels1.numpy())
    assert passes1 > every
    assert passes % every == 0 and passes >= passes1
    assert (labels1.numpy()[mask.numpy()] == 0).all()      # one component


@pytest.mark.cuda
@pytest.mark.parametrize("connectivity", [4, 8])
def test_blobs_card_match_cpu(cuda, connectivity):
    for mask in _masks():
        m = torch.as_tensor(mask)
        np.testing.assert_array_equal(
            tmorph.blob_index(m.to(cuda), connectivity).cpu().numpy(),
            tmorph.blob_index(m, connectivity).numpy())
        np.testing.assert_array_equal(
            tmorph.remove_small_blobs(m.to(cuda), 12, connectivity).cpu().numpy(),
            tmorph.remove_small_blobs(m, 12, connectivity).numpy())


@pytest.mark.parametrize("case", range(7))
def test_grassfire_and_distance_match_jax(case):
    mask = _masks()[case]
    got = tmorph.grassfire(mask, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jmorph.grassfire(jnp.asarray(mask))))
    np.testing.assert_array_equal(got.numpy(), tmorph.grassfire_np(mask))
    np.testing.assert_array_equal(tmorph.grassfire_np(mask), jmorph.grassfire_np(mask))
    np.testing.assert_array_equal(
        tmorph.euclidean_distance_sq(mask, device="cpu").numpy(),
        np.asarray(jmorph.euclidean_distance_sq(jnp.asarray(mask))))


@pytest.mark.parametrize("size", [2, 3, 5])
def test_erode_dilate_blob_sizes_match_jax(size):
    for mask in _masks():
        for tf, jf in ((tmorph.erode, jmorph.erode), (tmorph.dilate, jmorph.dilate)):
            np.testing.assert_array_equal(tf(mask, size, device="cpu").numpy(),
                                          np.asarray(jf(jnp.asarray(mask), size)))
        got = tmorph.blob_sizes(torch.as_tensor(mask), size * 4, connectivity=8)
        assert got.dtype == torch.uint32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jmorph.blob_sizes(jnp.asarray(mask), size * 4, 8)))


def test_two_threshold_fill_and_fill_holes_match_jax():
    rng = np.random.default_rng(91)
    img = rng.random((41, 33)).astype(np.float32)
    for lo, hi, f, t in ((0.4, 0.95, 0, 1), (0.2, 0.99, 3, 200)):
        got = tmorph.two_threshold_fill(img, lo, hi, f, t, device="cpu")
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jmorph.two_threshold_fill(jnp.asarray(img), lo, hi, f, t)))
    for p, dist in ((0.6, 5), (0.15, 16)):
        valid = rng.random(img.shape) < p
        jd, jv = jmorph.fill_holes(jnp.asarray(img), jnp.asarray(valid), dist)
        td, tv = tmorph.fill_holes(img, valid, dist, device="cpu")
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.cuda
def test_grassfire_and_fills_card_match_cpu(cuda):
    rng = np.random.default_rng(92)
    img = rng.random((41, 33)).astype(np.float32)
    for mask in _masks():
        np.testing.assert_array_equal(tmorph.grassfire(mask, device=cuda).cpu().numpy(),
                                      tmorph.grassfire_np(mask))
        np.testing.assert_array_equal(
            tmorph.euclidean_distance_sq(mask, device=cuda).cpu().numpy(),
            tmorph.euclidean_distance_sq(mask, device="cpu").numpy())
        np.testing.assert_array_equal(tmorph.erode(mask, 3, device=cuda).cpu().numpy(),
                                      tmorph.erode(mask, 3, device="cpu").numpy())
        m = torch.as_tensor(mask)
        np.testing.assert_array_equal(tmorph.blob_sizes(m.to(cuda), 12).cpu().numpy(),
                                      tmorph.blob_sizes(m, 12).numpy())
    np.testing.assert_array_equal(
        tmorph.two_threshold_fill(img, 0.4, 0.95, device=cuda).cpu().numpy(),
        tmorph.two_threshold_fill(img, 0.4, 0.95, device="cpu").numpy())
    valid = rng.random(img.shape) < 0.6
    td, tv = tmorph.fill_holes(img, valid, 5, device=cuda)
    cd, cv = tmorph.fill_holes(img, valid, 5, device="cpu")
    np.testing.assert_allclose(td.cpu().numpy(), cd.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tv.cpu().numpy(), cv.numpy())
