"""The step protocol (a T-frame raw tail plus B new frames per dispatch)
on the XLA engine, against the streaming oracle: batch sizes, uneven
splits whose padding replicas must not reach the carried state,
checkpoint resume across batch sizes, refresh markers on batch edges and
temporal rings longer than a batch."""

import numpy as np
import pytest

from dips.models import DiPsEngine
from dips.ops.oracle import DiPsOracle
from dips.properties import (ChromaFilter, DiPsFilter, DiPsMethod,
                             DiPsProperties, OutputMode)
from tests.conftest import make_clip
from tests.test_engine_vs_oracle import assert_close

H, W, N = 12, 140, 13

CASES = {
    "overall-w3-t2": DiPsProperties(
        method=DiPsMethod.OVERALL, output=OutputMode.COLORIZE,
        filter=DiPsFilter.UNFILTERED, window_size=3, temporal_size=2),
    "per_frame-gray-sigmoid-w5-t3-red": DiPsProperties(
        method=DiPsMethod.PER_FRAME, output=OutputMode.GRAYSCALE,
        filter=DiPsFilter.SIGMOID, window_size=5, temporal_size=3,
        chroma=ChromaFilter.RED),
    "overall-w1-t4-marker": DiPsProperties(
        method=DiPsMethod.OVERALL, output=OutputMode.COLORIZE,
        filter=DiPsFilter.UNFILTERED, window_size=1, temporal_size=4,
        refresh_markers=(5,)),
    "overall-absdiff-t2-marker": DiPsProperties(
        method=DiPsMethod.OVERALL, output=OutputMode.ABSDIFF,
        temporal_size=2, refresh_markers=(6,)),
    "per_frame-absdiff-t4": DiPsProperties(
        method=DiPsMethod.PER_FRAME, output=OutputMode.ABSDIFF,
        temporal_size=4),
    "per_frame-threshold-t3": DiPsProperties(
        method=DiPsMethod.PER_FRAME, output=OutputMode.THRESHOLD,
        temporal_size=3, change_threshold=20),
}
_RAW = (OutputMode.ABSDIFF, OutputMode.THRESHOLD)


@pytest.fixture(scope="module")
def clip13():
    return make_clip(n=N, h=H, w=W)


def _expected(props, frames):
    o = DiPsOracle(props)
    out, stats = o.run(frames)
    if out.ndim == 3:
        out = out[..., None]
    return out, stats, o.heatmap


def _check(props, got, expected):
    out, stats, heat = got
    exp_out, exp_stats, exp_heat = expected
    if props.output in _RAW:
        np.testing.assert_array_equal(out, exp_out)
        np.testing.assert_allclose(stats, exp_stats, atol=1e-5, rtol=1e-4)
    else:
        exact = props.filter == DiPsFilter.UNFILTERED
        assert_close(exp_out, exp_stats, out, stats, exact, H * W)
    np.testing.assert_allclose(heat, exp_heat, atol=1e-4)


def _feed(eng, frames, splits):
    outs, stats = [], []
    i = 0
    for n in splits:
        o, s = eng.process_batch(list(frames[i:i + n]))
        outs.append(o)
        stats.append(s)
        i += n
    assert i == len(frames)
    return np.concatenate(outs), np.concatenate(stats)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("batch", [1, 4, 13])
def test_batch_size_invariant(name, batch, clip13):
    props = CASES[name]
    eng = DiPsEngine(props, H, W, batch=batch)
    out, stats = eng.process_frames(list(clip13))
    _check(props, (out, stats, eng.heatmap()), _expected(props, clip13))


@pytest.mark.parametrize("name", list(CASES))
def test_uneven_splits_do_not_pollute_state(name, clip13):
    """Partial batches pad with replicas of their last frame every
    dispatch; those must reach neither the tail, the baseline nor the
    heatmap."""
    props = CASES[name]
    eng = DiPsEngine(props, H, W, batch=4)
    out, stats = _feed(eng, clip13, [3, 1, 4, 2, 3])
    _check(props, (out, stats, eng.heatmap()), _expected(props, clip13))


@pytest.mark.parametrize("name", ["overall-w3-t2",
                                  "per_frame-gray-sigmoid-w5-t3-red",
                                  "overall-absdiff-t2-marker"])
@pytest.mark.parametrize("cut,resume_batch", [(4, 4), (5, 3), (8, 13)])
def test_checkpoint_resume_across_batch_sizes(name, cut, resume_batch,
                                              clip13):
    """A checkpoint holds the raw tail, cursor, baseline and heatmap: an
    engine with another batch size resumes the stream exactly."""
    props = CASES[name]
    first = DiPsEngine(props, H, W, batch=4)
    o1, s1 = first.process_frames(list(clip13[:cut]))
    second = DiPsEngine(props, H, W, batch=resume_batch)
    second.load_state_dict(first.state_dict())
    o2, s2 = second.process_frames(list(clip13[cut:]))
    _check(props, (np.concatenate([o1, o2]), np.concatenate([s1, s2]),
                   second.heatmap()), _expected(props, clip13))


@pytest.mark.parametrize("markers", [(1,), (4,), (4, 5), (3, 7, 11)])
def test_refresh_markers_on_batch_edges(markers, clip13):
    """Markers on the first and last frame of a batch, adjacent markers
    straddling a batch edge, and several per stream."""
    props = DiPsProperties(window_size=3, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED,
                           refresh_markers=markers)
    eng = DiPsEngine(props, H, W, batch=4)
    out, stats = eng.process_frames(list(clip13))
    _check(props, (out, stats, eng.heatmap()), _expected(props, clip13))
    for m in markers:
        assert stats[m, 1] == 0.0  # a capture frame diffs to zero


@pytest.mark.parametrize("temporal,batch", [(9, 8), (16, 8), (2, 1)])
def test_temporal_ring_longer_than_batch(temporal, batch, clip13):
    """The tail carries T raw frames whatever B is, including T > B."""
    props = DiPsProperties(window_size=1, temporal_size=temporal,
                           filter=DiPsFilter.UNFILTERED,
                           method=DiPsMethod.PER_FRAME)
    eng = DiPsEngine(props, H, W, batch=batch)
    out, stats = eng.process_frames(list(clip13))
    _check(props, (out, stats, eng.heatmap()), _expected(props, clip13))
