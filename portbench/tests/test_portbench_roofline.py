"""The roofline counts on small shapes, worked by hand."""

import pytest

from portbench import roofline

NCC = {"cost_type": "ncc", "kernel_size": [3, 3], "max_pyramid_levels": 0,
       "tile_size": 8, "consistency_threshold": -1}


def test_one_level_ncc_sweep():
    # 16x16 frame, tiles of 8 (2x2), 3x3 kernel, search (0, 0, 4, 2):
    # base 18x18, match 19x21, 256 output pixels, 8 candidates
    nbytes, ops = roofline.sweep_work(NCC, 16, 16, (0, 0, 4, 2))
    assert nbytes == 4 * (324 + 399) + 8 * 4 + 256 * 9
    assert ops == 256 * 10 * 8 + 6 * (256 + 399)


def test_the_r_to_l_pass_is_counted_with_the_check():
    one, _ = roofline.sweep_work(NCC, 16, 16, (0, 0, 4, 2))
    nbytes, ops = roofline.sweep_work({**NCC, "consistency_threshold": 2}, 16, 16,
                                      (0, 0, 4, 2))
    # R->L: 3x3 tiles (576 px), base 26x26, match 28x32 (the margin 3, 1)
    assert nbytes - one == 4 * (676 + 896) + 8 * 9 + 576 * 9
    assert ops - (256 * 10 * 8 + 6 * (256 + 399)) == 576 * 10 * 8 + 6 * (576 + 896)


def test_abs_sweep_and_mgm_scan():
    _, ops = roofline.sweep_work({**NCC, "cost_type": "abs"}, 16, 16, (0, 0, 4, 2))
    assert ops == 256 * 8 * 8
    mgm = {"stereo_algorithm": "mgm", "cost_type": "ternary_census", "census_window": 5,
           "max_pyramid_levels": 0, "tile_size": 8}
    nbytes, ops = roofline.scan_work(mgm, 16, 16, (0, 0, 4, 2))
    assert nbytes == 4 * 256 * (2 * 8 + 1)
    assert ops == 26 * 8 * 256 * 8
    assert roofline.sweep_work(mgm, 16, 16, (0, 0, 4, 2)) == (0.0, 0.0)


def test_the_mgm_r_to_l_pass_is_counted_with_the_check():
    mgm = {"stereo_algorithm": "mgm", "cost_type": "ternary_census", "census_window": 5,
           "max_pyramid_levels": 0, "tile_size": 8, "consistency_threshold": 2}
    nbytes, ops = roofline.scan_work(mgm, 16, 16, (0, 0, 4, 2))
    # R->L over 20x18 -> 3x3 tiles of 8 (576 px), the same 8 cells
    assert nbytes == 4 * (256 + 576) * (2 * 8 + 1)
    assert ops == 26 * 8 * (256 + 576) * 8


def test_least_time_is_the_larger_bound():
    assert roofline.least_seconds(3.35e12, 1.0) == pytest.approx(1.0)
    assert roofline.least_seconds(1.0, 67e12) == pytest.approx(1.0)


def test_the_benchmark_shapes_count_positive_work():
    bm = {"cost_type": "ncc", "kernel_size": [21, 21], "max_pyramid_levels": 5,
          "tile_size": 64, "consistency_threshold": 2, "refine_window": 11}
    epi = roofline.sweep_work(bm, 2048, 2048, (0, -2, 64, 4))
    mapproj = roofline.sweep_work(bm, 2048, 2048, (0, -8, 64, 16))
    assert 0 < epi[1] < mapproj[1]
