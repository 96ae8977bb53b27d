"""The scene generator: a seed gives the same pairs; the true disparity
lies inside each cell's search box."""

import copy

import pytest
import torch

from portbench import harness, scenes

CELLS = ["asp-bm.job2048-epi", "asp-mgm.tile1536-epi", "asp-bm.job2048-mapproj"]


def _small(name, n=160):
    wl = copy.deepcopy(harness.load_cell(name)["workload"])
    wl["traffic"].update(height=n, width=n + 32, pairs=2)
    return wl


@pytest.mark.parametrize("name", CELLS)
def test_pairs_are_deterministic_per_seed(name):
    wl = _small(name)
    a = scenes.make_pairs(wl["traffic"], 2 ** 31 + 11, "cpu")
    b = scenes.make_pairs(wl["traffic"], 2 ** 31 + 11, "cpu")
    c = scenes.make_pairs(wl["traffic"], 2 ** 31 + 12, "cpu")
    for p, q in zip(a, b):
        assert torch.equal(p.left, q.left) and torch.equal(p.right, q.right)
        assert torch.equal(p.truth, q.truth)
    assert not torch.equal(a[0].left, c[0].left)
    assert not torch.equal(a[0].left, a[1].left)


@pytest.mark.parametrize("name", CELLS)
def test_truth_inside_the_search_box_and_images_on_the_grid(name):
    wl = _small(name)
    for seed in (1, 2 ** 33 + 5):
        for p in scenes.make_pairs(wl["traffic"], seed, "cpu"):
            assert scenes.truth_in_search(p, wl["search"])
            for im in (p.left, p.right):
                assert torch.equal(im * 256, torch.round(im * 256))
                assert float(im.min()) >= 0.0 and float(im.max()) < 1.0
            x_lo, x_hi = wl["traffic"]["disparity"]["x_range"]
            assert abs(float(p.truth[..., 0].min()) - x_lo) < 1e-3
            assert abs(float(p.truth[..., 0].max()) - x_hi) < 1e-3


def test_right_image_is_the_left_warped_by_the_truth():
    wl = _small("asp-bm.job2048-epi", 192)
    p = scenes.make_pair(wl["traffic"], 7, 0, "cpu")
    h, w = p.left.shape
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32), indexing="ij")
    back = scenes._sample(p.right, xs + p.truth[..., 0], ys + p.truth[..., 1])
    inner = (slice(8, h - 8), slice(8, w - 64))
    err = (back - p.left)[inner].abs().mean()
    step = p.left.diff(dim=1).abs().mean()
    assert float(err) < 0.5 * float(step)
