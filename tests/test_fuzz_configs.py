"""Seeded configuration fuzz: random property/geometry combinations must
hold the parity contract on the XLA step, through every input layout."""

import numpy as np
import pytest

from dips.models import DiPsEngine
from dips.ops.oracle import DiPsOracle
from dips.properties import (ChromaFilter, DiPsFilter, DiPsMethod,
                             DiPsProperties, OutputMode)
from tests.conftest import make_clip
from tests.test_engine_vs_oracle import assert_close


def _random_props(r: np.random.Generator, h: int = 0,
                  w: int = 0) -> DiPsProperties:
    roi = None
    if h and w and r.random() < 0.4:  # sometimes: an analysis region
        y0 = int(r.integers(0, h - 1))
        x0 = int(r.integers(0, w - 1))
        roi = (y0, x0, int(r.integers(y0 + 1, h + 1)),
               int(r.integers(x0 + 1, w + 1)))
    return DiPsProperties(
        roi=roi,
        method=r.choice([DiPsMethod.OVERALL, DiPsMethod.PER_FRAME]),
        output=r.choice([OutputMode.COLORIZE, OutputMode.GRAYSCALE,
                         OutputMode.ABSDIFF, OutputMode.THRESHOLD]),
        filter=r.choice([DiPsFilter.SIGMOID, DiPsFilter.INVERSE_SIGMOID,
                         DiPsFilter.UNFILTERED]),
        chroma=r.choice(list(ChromaFilter)),
        window_size=int(r.integers(1, 8)),          # clamped to odd
        temporal_size=int(r.integers(1, 17)),       # full TEMPORAL_MAX range
        sensitivity=float(r.uniform(0.5, 8.0)),
        sigmoid_horizontal_scalar=float(r.uniform(0.0, 12.0)),  # clamped
        refresh_markers=tuple(int(m) for m in
                              r.choice(20, size=r.integers(0, 3),
                                       replace=False)),
        change_threshold=int(r.integers(1, 60)),
        quirk_compat=bool(r.integers(0, 4) == 0),  # the bug-for-bug mode
        emit_maps=bool(r.integers(0, 4) != 0),     # sometimes: no-map run
    )


@pytest.mark.parametrize("seed", range(8))
def test_fuzzed_config_parity(seed):
    r = np.random.default_rng(1000 + seed)
    h = int(r.integers(9, 30))
    w = int(r.integers(20, 150))
    props = _random_props(r, h, w)
    n = int(r.integers(4, 12))
    batch = int(r.integers(1, 7))
    if seed % 2:  # exercise batch = multiple of temporal (frames-per-step > 1)
        batch = props.temporal_size * int(r.integers(1, 3))
    frames = make_clip(n=n, h=h, w=w, seed=seed)

    o = DiPsOracle(props)
    exp_out, exp_stats = o.run(frames)
    if exp_out.ndim == 3:
        exp_out = exp_out[..., None]

    raw = props.output in (OutputMode.ABSDIFF, OutputMode.THRESHOLD)
    exact = raw or props.filter == DiPsFilter.UNFILTERED
    for layout in ("planar", "hwc", "hwc_bgr"):
        eng = DiPsEngine(props, h, w, batch=batch, input_layout=layout)
        feed = ([f[:, :, ::-1] for f in frames] if layout == "hwc_bgr"
                else list(frames))
        got_out, got_stats = eng.process_frames(feed)
        if raw:
            np.testing.assert_array_equal(got_out, exp_out, err_msg=str(props))
            np.testing.assert_allclose(got_stats, exp_stats, atol=1e-4,
                                       rtol=1e-4, err_msg=str(props))
        else:
            assert_close(exp_out, exp_stats, got_out, got_stats, exact,
                         props.analysis_pixels(h, w))
        np.testing.assert_allclose(eng.heatmap(), o.heatmap, atol=1e-3,
                                   err_msg=str(props))


@pytest.mark.parametrize("t,b", [(9, 9), (11, 11), (13, 13), (15, 15),
                                 (9, 18), (12, 12), (16, 16)])
def test_frames_per_step_divides(t, b):
    """Deep temporal rings at batch sizes that are multiples of T (and
    equal to it): the tail protocol carries T raw frames across every
    chunk boundary, and the step matches the oracle."""
    props = DiPsProperties(window_size=1, temporal_size=t,
                           filter=DiPsFilter.UNFILTERED,
                           refresh_markers=(b + 1,))
    frames = make_clip(n=b + 3, h=8, w=24, seed=t)
    o = DiPsOracle(props)
    exp_out, exp_stats = o.run(frames)
    got_out, got_stats = DiPsEngine(props, 8, 24, batch=b).process_frames(
        list(frames))
    assert np.abs(got_out.astype(int) - exp_out.astype(int)).max() <= 1
    np.testing.assert_allclose(got_stats, exp_stats, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("output", [OutputMode.COLORIZE, OutputMode.ABSDIFF])
def test_large_temporal_batch_multiple_parity(output):
    """temporal_size > 8 with batch % t == 0 matches the oracle in the
    median and the raw step."""
    props = DiPsProperties(window_size=3, temporal_size=9, output=output,
                           filter=DiPsFilter.UNFILTERED)
    frames = make_clip(n=11, h=10, w=40, seed=3)
    o = DiPsOracle(props)
    exp_out, exp_stats = o.run(frames)
    if exp_out.ndim == 3:
        exp_out = exp_out[..., None]
    eng = DiPsEngine(props, 10, 40, batch=9)
    got_out, got_stats = eng.process_frames(list(frames))
    raw = output == OutputMode.ABSDIFF
    d = np.abs(got_out.astype(int) - exp_out.astype(int))
    assert d.max() <= (0 if raw else 1)
    np.testing.assert_allclose(got_stats, exp_stats, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("fill", [0, 255])
def test_saturated_frames(fill):
    """All-black / all-white frames: clip boundaries and zero diffs."""
    frames = np.full((5, 16, 40, 3), fill, np.uint8)
    props = DiPsProperties(window_size=3, temporal_size=2)
    o = DiPsOracle(props)
    exp_out, exp_stats = o.run(frames)
    np.testing.assert_array_equal(exp_stats, 0)
    eng = DiPsEngine(props, 16, 40, batch=3)
    got_out, got_stats = eng.process_frames(list(frames))
    np.testing.assert_array_equal(got_stats, 0)
    d = np.abs(got_out.astype(int) - exp_out.astype(int))
    assert d.max() <= 1


def test_full_scale_step_change():
    """0 -> 255 scene change: diff saturates, colorize clips cleanly."""
    frames = np.zeros((6, 16, 40, 3), np.uint8)
    frames[3:] = 255
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED, sensitivity=5.0)
    o = DiPsOracle(props)
    exp_out, exp_stats = o.run(frames)
    assert exp_stats[3, 2] == 1.0  # max |diff| saturates at full scale
    eng = DiPsEngine(props, 16, 40, batch=3)
    got_out, got_stats = eng.process_frames(list(frames))
    np.testing.assert_array_equal(got_out, exp_out)
    np.testing.assert_allclose(got_stats, exp_stats, atol=1e-6)


def test_tiny_geometry_one_row():
    """Degenerate 1-row frames: padding, stencils and masks still agree."""
    r = np.random.default_rng(7)
    frames = r.integers(0, 256, (5, 1, 5, 3), np.uint8)
    props = DiPsProperties(window_size=3, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED)
    o = DiPsOracle(props)
    exp_out, exp_stats = o.run(frames)
    eng = DiPsEngine(props, 1, 5, batch=2)
    got_out, got_stats = eng.process_frames(list(frames))
    d = np.abs(got_out.astype(int) - exp_out.astype(int))
    assert d.max() <= 1
    np.testing.assert_allclose(got_stats, exp_stats, atol=1e-5)


@pytest.mark.parametrize("seed", range(6))
def test_fuzzed_grid_matrix(seed):
    """One joint fuzz over the orthogonal config axes on the 2-D grid
    engines — emit_maps x quirk_compat x approx_median x method x window
    x output (incl. the raw fleet modes) x chroma x roi — so composition
    regressions can't hide between dedicated test files.  Every draw must
    reproduce per-stream single-device engines exactly."""
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device test mesh")
    from dips.parallel.grid2d import grid_mesh
    from dips.parallel.multistream import MultiStreamEngine

    r = np.random.default_rng(7100 + seed)
    h = 32                        # 4 row shards
    w = int(r.integers(20, 60))
    output = r.choice([OutputMode.COLORIZE, OutputMode.GRAYSCALE,
                       OutputMode.ABSDIFF, OutputMode.THRESHOLD,
                       OutputMode.STATS_ONLY])
    raw = output in (OutputMode.ABSDIFF, OutputMode.THRESHOLD,
                     OutputMode.STATS_ONLY)
    quirk = bool(r.integers(0, 3) == 0)
    props = DiPsProperties(
        method=r.choice([DiPsMethod.OVERALL, DiPsMethod.PER_FRAME]),
        output=output,
        filter=r.choice([DiPsFilter.SIGMOID, DiPsFilter.UNFILTERED]),
        chroma=r.choice(list(ChromaFilter)),
        window_size=int(r.integers(1, 8)),
        temporal_size=int(r.integers(1, 4)),
        emit_maps=bool(r.integers(0, 3) != 0),
        quirk_compat=quirk,
        approx_median=(not quirk) and bool(r.integers(0, 3) == 0),
        change_threshold=int(r.integers(1, 60)),
        refresh_markers=(int(r.integers(1, 6)),),
        roi=((4, 2, 30, 18) if r.random() < 0.3 else None))
    batch = int(r.integers(2, 5))
    n = 2 * batch
    clips = [make_clip(n=n, h=h, w=w, seed=7200 + 8 * seed + k)
             for k in range(2)]
    ms = MultiStreamEngine(
        props, h, w, n_streams=2, batch=batch, mesh=grid_mesh(2, 4))
    outs, stats = [], []
    for i in range(0, n, batch):
        o, st, g = ms.process_batch([list(c[i:i + batch]) for c in clips])
        assert np.isfinite(g), props
        outs.append(o)
        stats.append(st)
    out = np.concatenate(outs, axis=1)
    stat = np.concatenate(stats, axis=1)
    for k, c in enumerate(clips):
        eng = DiPsEngine(props, h, w, batch=batch)
        exp_out, exp_stats = eng.process_frames(list(c))
        np.testing.assert_array_equal(out[k], exp_out, err_msg=str(props))
        np.testing.assert_allclose(stat[k], exp_stats, atol=1e-5,
                                   err_msg=str(props))
        np.testing.assert_allclose(ms.heatmaps()[k], eng.heatmap(),
                                   atol=1e-4, err_msg=str(props))
