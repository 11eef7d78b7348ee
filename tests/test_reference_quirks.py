"""Documents the reference's WGSL quirks, the rebuild's clean semantics,
and the bit-faithful ``quirk_compat`` mode.

SURVEY.md §7 ("Hard parts") chose *intended* math over bug-for-bug
compatibility as the DEFAULT.  These tests replicate the reference shader
behaviour in numpy to make the divergence explicit and reviewable:

* dips_shader.wgsl:132-133 iterates ``i in [-w/2, w/2)`` — an off-center
  (w-1)x(w-1) window for odd w;
* the unfilled tail of the ``median_array`` stays zero (WGSL ``var``
  arrays are zero-initialised) AND the bubble sort's ``j + 1`` read at
  ``j = w*w - 1`` touches slot ``w*w`` — in bounds of the 121-slot array
  (``MAX_WIN_SIZE_SQUARE``, dips_shader.wgsl:27-129), so one MORE
  structural zero joins the sorted prefix: 2w zeros in total;
* dips_shader.wgsl:168 picks index ``(n/2)+1``, one past the median.

Net effect: with non-negative intensities the 2w zeros occupy the low
ranks, so the reference's "median filter" is rank ``(w*w)//2 + 1 - 2w``
of the (w-1)x(w-1) taps — and at w=3 that rank is negative: the filter
is CONSTANT ZERO (the diff map degenerates to the baseline itself).

The rebuild implements the true centered odd-window median by default
(ops/oracle.py), pinned by these tests — and offers the reference's exact
behaviour behind ``DiPsProperties.quirk_compat``, pinned bit-for-bit
against the WGSL replica here (oracle and the XLA step).
"""

import numpy as np
import pytest

from dips.models import DiPsEngine
from dips.ops import oracle
from dips.ops.oracle import DiPsOracle
from dips.properties import DiPsFilter, DiPsMethod, DiPsProperties


def wgsl_replica_spatial_filter(plane: np.ndarray, window: int) -> np.ndarray:
    """Bug-for-bug numpy replica of spatial_median_filter
    (dips/src/gpu/shaders/dips_shader.wgsl:122-170), including the sorted
    prefix's in-bounds extra zero at slot ``w*w`` (the array is 121 slots,
    zero-initialised; only the temporal sort's ``array<f32, 4>`` read at
    index 4 is true OOB — there we assume robustness-clamp semantics,
    under which that sort is simply correct)."""
    h, w = plane.shape
    half = window // 2
    n2 = window * window
    out = np.empty_like(plane)
    for y in range(h):
        for x in range(w):
            arr = np.zeros(n2 + 1, np.float32)  # WGSL zero-init + slot n2
            for i in range(-half, half):    # note: excludes +half
                for j in range(-half, half):
                    yy, xx = y + j, x + i
                    v = plane[yy, xx] if (0 <= yy < h and 0 <= xx < w) else 0.0
                    arr[(i + half) + window * (j + half)] = v
            arr.sort()                      # the bubble sort covers 0..n2
            out[y, x] = arr[n2 // 2 + 1]    # ref picks (n/2)+1
    return out


def test_reference_w3_filter_is_constant_zero():
    """For w=3 the replica sorts 4 taps + 6 structural zeros and picks
    index 5 — always a zero for non-negative intensities.  The clean
    median keeps the actual values."""
    plane = np.full((6, 6), 0.8, np.float32)
    ref = wgsl_replica_spatial_filter(plane, 3)
    ours = oracle.spatial_median(plane, 3)
    assert np.all(ours[1:-1, 1:-1] == np.float32(0.8))
    assert np.all(ref == 0.0)
    # even one dark tap changes nothing: zeros still cover index 5
    plane[2, 2] = 0.1
    assert np.all(wgsl_replica_spatial_filter(plane, 3) == 0.0)
    assert oracle.spatial_median(plane, 3)[3, 3] == np.float32(0.8)


def test_reference_median_pick_is_biased():
    """The (n/2)+1 pick is one past the true median even on full arrays."""
    vals = np.arange(9, dtype=np.float32)
    true_median = np.sort(vals)[9 // 2]        # 4
    ref_pick = np.sort(vals)[9 // 2 + 1]       # 5
    assert true_median == 4 and ref_pick == 5


def test_clean_median_matches_numpy():
    r = np.random.default_rng(0)
    plane = r.random((12, 15)).astype(np.float32)
    ours = oracle.spatial_median(plane, 3)
    # interior pixels: true median of the 3x3 neighbourhood
    for y in range(1, 11):
        for x in range(1, 14):
            assert ours[y, x] == np.median(plane[y - 1:y + 2, x - 1:x + 2])


# -- quirk_compat: the reference behaviour as a first-class mode ----------

@pytest.mark.parametrize("window", [3, 5, 7])
def test_quirk_spatial_matches_wgsl_replica(window):
    r = np.random.default_rng(window)
    plane = (r.integers(0, 511, (10, 13)) & ~1).astype(np.float32)
    got = oracle.spatial_median(plane, window, quirk=True)
    exp = wgsl_replica_spatial_filter(plane, window)
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("window", [5, 7])
def test_quirk_networks_select_matches_oracle(window):
    """The selection-network implementation (shared by the XLA and Pallas
    paths) agrees with the oracle's independent partition-based one."""
    import jax.numpy as jnp
    from dips.ops import reference
    r = np.random.default_rng(window + 10)
    plane = r.integers(0, 511, (9, 12)).astype(np.float32)
    got = np.asarray(reference.spatial_median(
        jnp.asarray(plane), window, quirk=True))
    exp = oracle.spatial_median(plane, window, quirk=True)
    np.testing.assert_array_equal(got, exp)


def test_quirk_w3_diff_map_is_the_baseline():
    """End-to-end consequence at w=3: the filtered planes are all zero, so
    every ring median is zero and OVERALL diffs are baseline - 0 = 0
    against a zero baseline — the unfiltered-diff degenerate the shader
    actually computes."""
    r = np.random.default_rng(0)
    clip = r.integers(0, 256, (6, 8, 16, 3), np.uint8)
    props = DiPsProperties(window_size=3, temporal_size=4, quirk_compat=True,
                           filter=DiPsFilter.UNFILTERED)
    o = DiPsOracle(props)
    outs, stats = o.run(clip)
    # zero diff everywhere: colorized output is the constant 0.5 gray
    assert np.all(stats[:, 2] == 0.0)  # max |diff| is 0 on every frame
    assert np.all(outs[1:] == 128)


@pytest.mark.parametrize("window,method", [
    (3, DiPsMethod.PER_FRAME), (5, DiPsMethod.PER_FRAME),
    (7, DiPsMethod.PER_FRAME), (5, DiPsMethod.OVERALL),
    (7, DiPsMethod.OVERALL)])
def test_quirk_engine_matches_oracle(window, method):
    from tests.test_engine_vs_oracle import assert_close
    r = np.random.default_rng(window)
    clip = r.integers(0, 256, (7, 16, 24, 3), np.uint8)
    props = DiPsProperties(window_size=window, temporal_size=2,
                           quirk_compat=True, method=method,
                           filter=DiPsFilter.UNFILTERED)
    o = DiPsOracle(props)
    exp_out, exp_stats = o.run(clip)
    eng = DiPsEngine(props, clip.shape[1], clip.shape[2], batch=3)
    got_out, got_stats = eng.process_frames(list(clip))
    assert_close(exp_out, exp_stats, got_out, got_stats, True,
                 clip.shape[1] * clip.shape[2])


def test_quirk_rejects_approx_median():
    with pytest.raises(ValueError):
        DiPsProperties(quirk_compat=True, approx_median=True)
