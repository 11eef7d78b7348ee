"""Analysis region (props.roi): statistics, changed-pixel counts, the
heatmap and motion events reduce over a configured rectangle; output maps
stay full-frame.  Verified against the oracle on the single-stream step,
several streams on one device, and the row-sharded mesh."""

import numpy as np
import pytest

from dips.models import DiPsEngine
from dips.ops.oracle import DiPsOracle
from dips.properties import (DiPsFilter, DiPsMethod, DiPsProperties,
                             OutputMode)
from tests.conftest import make_clip
from tests.test_engine_vs_oracle import assert_close

ROI = (3, 16, 9, 100)  # (y0, x0, y1, x1) inside the 12 x 140 test clip


def test_roi_validation():
    with pytest.raises(ValueError):
        DiPsProperties(roi=(3, 3))                 # wrong arity
    with pytest.raises(ValueError):
        DiPsProperties(roi=(5, 0, 5, 10))          # empty rows
    with pytest.raises(ValueError):
        DiPsProperties(roi=(-1, 0, 5, 10))         # negative
    p = DiPsProperties().with_roi((1, 2, 6, 9))
    assert p.roi == (1, 2, 6, 9)
    assert p.roi_bounds(12, 140) == (1, 2, 6, 9)
    assert p.analysis_pixels(12, 140) == 5 * 7
    assert p.with_roi(None).roi is None
    assert DiPsProperties().analysis_pixels(12, 140) == 12 * 140
    with pytest.raises(ValueError):                # exceeds the frame
        p.with_roi((0, 0, 13, 10)).roi_bounds(12, 140)
    with pytest.raises(ValueError):                # engine checks at build
        DiPsEngine(p.with_roi((0, 0, 13, 10)), 12, 140)


def test_oracle_roi_semantics(clip):
    """ROI stats == full-pipeline stats recomputed over the slice; the
    heatmap is untouched inside the roi and zero outside it."""
    base = DiPsProperties(filter=DiPsFilter.UNFILTERED)
    o_full = DiPsOracle(base)
    o_roi = DiPsOracle(base.with_roi(ROI))
    out_f, _ = o_full.run(clip)
    out_r, stats_r = o_roi.run(clip)
    # outputs stay full-frame and identical: roi only affects reductions
    np.testing.assert_array_equal(out_f, out_r)
    y0, x0, y1, x1 = ROI
    hm_f, hm_r = o_full.heatmap, o_roi.heatmap
    np.testing.assert_array_equal(hm_r[y0:y1, x0:x1], hm_f[y0:y1, x0:x1])
    outside = hm_r.copy()
    outside[y0:y1, x0:x1] = 0.0
    assert outside.max() == 0.0
    assert hm_f.max() > 0.0  # the clip genuinely moves
    # counts are bounded by the roi area
    assert stats_r[:, 3].max() <= (y1 - y0) * (x1 - x0)


@pytest.mark.parametrize("batch", [3, 5])
@pytest.mark.parametrize("method,output,filt,exact", [
    (DiPsMethod.OVERALL, OutputMode.COLORIZE, DiPsFilter.UNFILTERED, True),
    (DiPsMethod.PER_FRAME, OutputMode.GRAYSCALE, DiPsFilter.SIGMOID, False),
    (DiPsMethod.OVERALL, OutputMode.ABSDIFF, DiPsFilter.UNFILTERED, True),
    (DiPsMethod.OVERALL, OutputMode.THRESHOLD, DiPsFilter.UNFILTERED, True),
    (DiPsMethod.PER_FRAME, OutputMode.ABSDIFF, DiPsFilter.UNFILTERED, True),
])
def test_engine_roi_matches_oracle(batch, method, output, filt, exact,
                                   clip):
    props = DiPsProperties(method=method, output=output, filter=filt,
                           window_size=3, temporal_size=2, roi=ROI,
                           refresh_markers=(7,))
    o = DiPsOracle(props)
    exp_out, exp_stats = o.run(clip)
    if exp_out.ndim == 3:
        exp_out = exp_out[..., None]
    eng = DiPsEngine(props, clip.shape[1], clip.shape[2], batch=batch)
    got_out, got_stats = eng.process_frames(list(clip))
    y0, x0, y1, x1 = ROI
    assert_close(exp_out, exp_stats, got_out, got_stats, exact,
                 (y1 - y0) * (x1 - x0))
    # heatmap parity incl. the zeroed exterior
    np.testing.assert_allclose(eng.heatmap(), o.heatmap, atol=2e-3)
    outside = eng.heatmap().copy()
    outside[y0:y1, x0:x1] = 0.0
    assert outside.max() == 0.0


def test_roi_stats_differ_from_full_frame(clip):
    """The region actually matters: a roi that excludes the moving square
    reports (near-)zero change while full-frame stats see it."""
    quiet = (0, 0, 2, 140)  # the moving square of make_clip never enters
    props = DiPsProperties(filter=DiPsFilter.UNFILTERED)
    full = DiPsEngine(props, clip.shape[1], clip.shape[2], batch=4)
    roi = DiPsEngine(props.with_roi(quiet), clip.shape[1], clip.shape[2],
                     batch=4)
    _, s_full = full.process_frames(list(clip))
    _, s_roi = roi.process_frames(list(clip))
    assert s_full[1:, 3].max() > 0
    assert s_roi[1:, 3].max() <= s_full[1:, 3].max() / 4


def test_stacked_streams_roi():
    """Several streams on one device (MultiStreamEngine's per-shard body):
    per-stream roi stats match per-stream runs (stream-local roi rows must
    not leak across streams)."""
    from dips.parallel import MultiStreamEngine, stream_mesh
    s, h, w = 3, 16, 24
    props = DiPsProperties(window_size=3, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED,
                           roi=(2, 4, 10, 20))
    clips = [make_clip(n=4, h=h, w=w, seed=70 + k) for k in range(s)]
    ms = MultiStreamEngine(props, h, w, n_streams=s, batch=4,
                           mesh=stream_mesh(1))
    out_s, stats_s, _ = ms.process_batch([list(c) for c in clips])
    for si, c in enumerate(clips):
        one = DiPsEngine(props, h, w, batch=4)
        out_1, stats_1 = one.process_frames(list(c))
        np.testing.assert_array_equal(out_s[si], out_1)
        np.testing.assert_allclose(stats_s[si], stats_1, rtol=1e-6)
        np.testing.assert_allclose(ms.heatmaps()[si], one.heatmap(),
                                   rtol=1e-6)


def test_rowsharded_roi_matches_single_device():
    """ROI bounds are global row coordinates: slabs on different devices
    must agree with the unsharded engine."""
    import jax
    import jax.numpy as jnp
    from dips.parallel import stream_mesh
    from dips.parallel.rowsharded import make_rowsharded_step
    from dips.ops import reference
    from dips.ops.reference import pad_geometry
    h, w, t, b = 64, 24, 2, 4
    hp, wp = pad_geometry(h, w)
    props = DiPsProperties(window_size=3, temporal_size=t,
                           filter=DiPsFilter.UNFILTERED,
                           roi=(10, 2, 50, 20))
    mesh = stream_mesh(min(4, jax.device_count()))
    mesh = jax.sharding.Mesh(mesh.devices, ("rows",))
    rng = np.random.default_rng(3)
    raw = jnp.asarray(rng.integers(0, 256, (t + b, 3, hp, wp), np.uint8))
    flags = jnp.asarray(np.array([True, False, False, False]))
    valid = jnp.ones((b,), bool)
    step = make_rowsharded_step(props, h, w, mesh)
    out_s, stats_s, _, heat_s = step(raw, jnp.zeros((hp, wp), jnp.float32),
                                     flags,
                                     jnp.zeros((hp, wp), jnp.float32),
                                     valid)
    out_1, stats_1, _, heat_1 = reference.batch_step(
        props, h, w, raw, jnp.zeros((hp, wp), jnp.float32), flags,
        jnp.zeros((hp, wp), jnp.float32), valid)
    np.testing.assert_array_equal(np.asarray(out_s), np.asarray(out_1))
    np.testing.assert_allclose(np.asarray(stats_s), np.asarray(stats_1),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(heat_s), np.asarray(heat_1),
                               rtol=1e-5, atol=1e-6)


def test_cli_roi(tmp_path, capsys):
    from dips.cli import main as cli_main
    from dips.io import moving_square_clip, write_clip
    import json
    path = str(tmp_path / "in.avi")
    write_clip(moving_square_clip(n=10, height=32, width=48), path)
    sj = str(tmp_path / "s.json")
    rc = cli_main(["--input", path, "--output", str(tmp_path / "o.avi"),
                   "--temporal=2", "--batch=4", "--roi", "0,0,8,48",
                   "--stats-json", sj])
    assert rc == 0
    rows = json.load(open(sj))
    assert max(r["changed_count"] for r in rows) <= 8 * 48
    # malformed / inverted / oversized rectangles are user errors
    rc = cli_main(["--input", path, "--output", str(tmp_path / "o.avi"),
                   "--roi", "1,2,3"])
    assert rc == 2 and "--roi" in capsys.readouterr().err
    rc = cli_main(["--input", path, "--output", str(tmp_path / "o.avi"),
                   "--roi", "8,0,4,48"])
    assert rc == 2 and "roi" in capsys.readouterr().err
    rc = cli_main(["--input", path, "--output", str(tmp_path / "o.avi"),
                   "--roi", "0,0,33,48"])
    assert rc == 1 and "roi" in capsys.readouterr().err


def test_roi_events_use_roi_pixels(tmp_path, capsys):
    """changed_frac events normalize by the ROI area, not the frame."""
    import json
    from dips.cli import main as cli_main
    from dips.io import moving_square_clip, write_clip
    path = str(tmp_path / "in.avi")
    write_clip(moving_square_clip(n=12, height=32, width=48), path)
    ej = str(tmp_path / "e.json")
    rc = cli_main(["--input", path, "--output", str(tmp_path / "o.avi"),
                   "--temporal=2", "--batch=4", "--roi", "0,0,32,24",
                   "--events-json", ej, "--event-on", "0.005"])
    assert rc == 0
    json.load(open(ej))  # well-formed; thresholds applied over roi pixels


def test_cli_dat_mode_roi_error_is_friendly(tmp_path, capsys):
    """--dat-dir with an roi outside the dat geometry: rc 1 + message."""
    import numpy as np
    from dips.cli import main as cli_main
    d = tmp_path / "dumps"
    d.mkdir()
    w, h = 16, 24
    rng = np.random.default_rng(0)
    for i in range(3):
        raw = rng.integers(0, 256, (h, w, 4), np.uint8)
        (d / f"Dat_{i}.d").write_bytes(b"\x00" * 4 + raw.tobytes())
    rc = cli_main(["--dat-dir", str(d), "--output",
                   str(tmp_path / "o.avi"), "--dat-geometry", f"{w}x{h}",
                   "--temporal=2", "--roi", "0,0,99,99"])
    assert rc == 1 and "roi" in capsys.readouterr().err
    # and a fitting roi works
    rc = cli_main(["--dat-dir", str(d), "--output",
                   str(tmp_path / "o2.avi"), "--dat-geometry", f"{w}x{h}",
                   "--temporal=2", "--roi", "0,0,8,8"])
    assert rc == 0


def test_stacked_absdiff_roi_matches_per_stream_and_oracle():
    """The raw step's roi mask uses stream-local rows: several absdiff
    streams on one device match per-stream runs AND the oracle (stats and
    the full-frame output: the roi must not leak into maps)."""
    from dips.parallel import MultiStreamEngine, stream_mesh
    s, h, w = 3, 12, 40
    props = DiPsProperties(output=OutputMode.ABSDIFF, temporal_size=2,
                           roi=(2, 4, 10, 30))
    clips = [make_clip(n=4, h=h, w=w, seed=80 + k) for k in range(s)]
    ms = MultiStreamEngine(props, h, w, n_streams=s, batch=4,
                           mesh=stream_mesh(1))
    out_s, stats_s, _ = ms.process_batch([list(c) for c in clips])
    for si, c in enumerate(clips):
        one = DiPsEngine(props, h, w, batch=4)
        out1, stats1 = one.process_frames(list(c))
        np.testing.assert_array_equal(out_s[si], out1, err_msg=f"{si}")
        np.testing.assert_allclose(stats_s[si], stats1, atol=1e-6)
        np.testing.assert_allclose(ms.heatmaps()[si], one.heatmap(),
                                   atol=1e-6)
        exp_out, exp_stats = DiPsOracle(props).run(c)
        np.testing.assert_allclose(stats1, exp_stats, atol=1e-5)
        np.testing.assert_array_equal(out1, exp_out)
