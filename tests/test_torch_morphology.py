"""Port's blob labels and the blob filter (``visionworkbench_torch/image/
morphology.py``) against the JAX package on the CPU, on the same numpy
masks: labels (int32, the minimum flat index of each component, -1
outside), areas and ``remove_small_blobs`` exact, with 4- and
8-connectivity."""

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
