"""Oracle self-consistency: the numpy spec against independent references
(brute-force medians, cv2.absdiff, full HSL)."""

import cv2
import numpy as np
import pytest

from dips.ops import oracle
from dips.properties import (ChromaFilter, DiPsFilter, DiPsMethod,
                             DiPsProperties, OutputMode)


@pytest.mark.parametrize("window", [1, 3, 5, 7])
def test_spatial_median_vs_bruteforce(window, rng):
    plane = rng.random((17, 23)).astype(np.float32)
    got = oracle.spatial_median(plane, window)
    h, w = plane.shape
    p = window // 2
    padded = np.zeros((h + 2 * p, w + 2 * p), np.float32)
    padded[p:p + h, p:p + w] = plane
    expected = np.empty_like(plane)
    for y in range(h):
        for x in range(w):
            taps = padded[y:y + window, x:x + window].ravel()
            expected[y, x] = np.sort(taps)[(window * window) // 2]
    np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize("t", [1, 2, 3, 4, 8])
def test_temporal_median(t, rng):
    planes = rng.random((t, 9, 11)).astype(np.float32)
    got = oracle.temporal_median(planes)
    np.testing.assert_array_equal(got, np.sort(planes, axis=0)[t // 2])


def test_absdiff_matches_cv2(rng):
    a = rng.integers(0, 256, (32, 48, 3), np.uint8)
    b = rng.integers(0, 256, (32, 48, 3), np.uint8)
    np.testing.assert_array_equal(oracle.absdiff_u8(a, b), cv2.absdiff(a, b))


def test_diff_to_color_matches_hsl(rng):
    d = (rng.random((16, 16)).astype(np.float32) - 0.5) * 1.6
    closed = oracle.diff_to_color(d)
    h = np.where(d < 0, np.float32(0.0), np.float32(120.0))
    full = oracle.hsl_to_rgb(h, np.abs(d), np.full_like(d, 0.5))
    np.testing.assert_allclose(closed, full, atol=1e-6)


def test_intensity_luminance():
    f = np.array([[[10, 200, 60]]], np.uint8)
    got = oracle.intensity(f, ChromaFilter.ALL)
    np.testing.assert_allclose(got, [[(200 / 255 + 10 / 255) / 2]], rtol=1e-6)
    np.testing.assert_allclose(
        oracle.intensity(f, ChromaFilter.GREEN), [[200 / 255]], rtol=1e-6)


def test_overall_constant_video_is_neutral(clip):
    """A static video diffs to zero: colorized output is mid-gray except the
    capture frame, stats are all zero."""
    frames = np.repeat(clip[:1], 6, axis=0)
    o = oracle.DiPsOracle(DiPsProperties(window_size=3))
    outs, stats = o.run(frames)
    np.testing.assert_array_equal(stats, 0)
    assert np.all(outs[1:] == 128)  # sigmoid(0)=0 -> (0.5,0.5,0.5) -> 128


def test_per_frame_detects_motion(clip):
    o = oracle.DiPsOracle(DiPsProperties(
        method=DiPsMethod.PER_FRAME, window_size=1, temporal_size=1,
        filter=DiPsFilter.UNFILTERED))
    outs, stats = o.run(clip[:6])
    assert stats[0, 1] == 0          # first frame diffs against itself
    assert np.all(stats[1:, 1] > 0)  # moving square produces change


def test_refresh_marker_recaptures():
    frames = np.zeros((6, 8, 8, 3), np.uint8)
    frames[3:] = 200  # scene change at frame 3
    p = DiPsProperties(window_size=1, temporal_size=1,
                       refresh_markers=(3,), filter=DiPsFilter.UNFILTERED)
    o = oracle.DiPsOracle(p)
    outs, stats = o.run(frames)
    assert stats[2, 1] == 0      # before the change: no diff
    assert stats[3, 1] == 0      # marker frame: fresh capture, zero diff
    assert stats[4, 1] == 0      # after re-capture: new baseline matches
    o2 = oracle.DiPsOracle(DiPsProperties(
        window_size=1, temporal_size=1, filter=DiPsFilter.UNFILTERED))
    _, stats2 = o2.run(frames)
    assert stats2[3, 1] > 0      # without the marker the change is seen


def test_threshold_mode_matches_cv2_pipeline(rng):
    a = rng.integers(0, 256, (16, 16, 3), np.uint8)
    b = rng.integers(0, 256, (16, 16, 3), np.uint8)
    thr = 30
    got = oracle.threshold_mask_u8(a, b, thr)
    d = cv2.absdiff(a, b).max(axis=-1)
    expected = np.where(d >= thr, 255, 0).astype(np.uint8)
    np.testing.assert_array_equal(got, expected)


def test_inv_sigmoid_inverts_sigmoid():
    d = np.linspace(-0.45, 0.45, 11).astype(np.float32)
    k = 5.0
    s = oracle.emphasize(2 * d, DiPsFilter.SIGMOID, k, 1.0)
    back = -np.log(1.0 / (s + 0.5) - 1.0) / k
    np.testing.assert_allclose(back, d, atol=1e-5)
