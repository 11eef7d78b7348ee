"""emit_maps=False: map suppression orthogonal to the pipeline.

``DiPsProperties.emit_maps=False`` keeps the FULL configured pipeline —
spatial/temporal medians, emphasis domain, COLORIZE/GRAYSCALE stats
semantics — but emits no diff maps at all (out_channels == 0, kernels drop
their map output, ~128 B/frame D2H).  This is how a fleet gets
median-filtered, emphasis-domain statistics/events (the robust-to-noise
signal of the reference's median stages, dips_shader.wgsl:172-240) without
paying map egress.  ``OutputMode.STATS_ONLY`` remains the raw-domain
shorthand (== ABSDIFF + emit_maps=False).
"""

import threading

import numpy as np
import pytest

from dips.models import DiPsEngine
from dips.ops.oracle import DiPsOracle, NUM_STATS
from dips.properties import (DiPsFilter, DiPsMethod, DiPsProperties,
                             OutputMode)
from tests.conftest import make_clip

# the full median pipeline (w3 spatial, t4 temporal, sigmoid emphasis)
MED = DiPsProperties(output=OutputMode.COLORIZE, window_size=3,
                     temporal_size=4, filter=DiPsFilter.SIGMOID)
MED_NM = MED.with_emit_maps(False)


# ---------------------------------------------------------- properties --

def test_out_channels_zero_every_mode():
    for mode in OutputMode:
        p = DiPsProperties(output=mode, emit_maps=False)
        assert p.out_channels == 0, mode
    assert MED.out_channels == 3
    assert MED.with_output("grayscale").out_channels == 1


def test_with_emit_maps_roundtrip():
    assert MED_NM.emit_maps is False
    assert MED_NM.with_emit_maps(True) == MED
    # STATS_ONLY is the raw shorthand: same channel count as
    # ABSDIFF + emit_maps=False
    so = DiPsProperties(output=OutputMode.STATS_ONLY)
    ad_nm = DiPsProperties(output=OutputMode.ABSDIFF, emit_maps=False)
    assert so.out_channels == ad_nm.out_channels == 0


# -------------------------------------------------------------- oracle --

def test_oracle_median_stats_match_mapped_run():
    """emit_maps=False is a pure egress change: stats and heatmap are
    bit-identical to the map-emitting run of the SAME pipeline."""
    clip = make_clip(n=10, h=12, w=140, seed=3)
    o_nm, o_m = DiPsOracle(MED_NM), DiPsOracle(MED)
    out_nm, st_nm = o_nm.run(clip)
    out_m, st_m = o_m.run(clip)
    assert out_nm.shape == (10, 12, 140, 0)
    assert out_m.shape == (10, 12, 140, 3)
    np.testing.assert_array_equal(st_nm, st_m)
    np.testing.assert_array_equal(o_nm.heatmap, o_m.heatmap)


def test_oracle_median_nm_differs_from_raw_stats_only():
    """The point of the feature: median-pipeline no-map stats are the
    FILTERED signal, not STATS_ONLY's raw absdiff stats."""
    clip = make_clip(n=8, h=12, w=140, seed=9)
    _, st_med = DiPsOracle(MED_NM).run(clip)
    _, st_raw = DiPsOracle(
        DiPsProperties(output=OutputMode.STATS_ONLY)).run(clip)
    # the w3/t4 medians suppress the single-pixel noise the raw diff sees
    assert not np.allclose(st_med, st_raw)


# ------------------------------------------------------------- engines --

@pytest.mark.parametrize("batch", [2, 4, 9])
def test_engine_median_no_maps_vs_oracle(batch):
    """Any batch split (chunk boundaries before, on and after the marker):
    stats/heatmap match the oracle, zero-channel maps, refresh markers
    honored."""
    props = MED_NM.with_refresh_markers((5,))
    clip = make_clip(n=9, h=12, w=140, seed=4)
    o = DiPsOracle(props)
    _, exp_stats = o.run(clip)
    eng = DiPsEngine(props, 12, 140, batch=batch)
    got_out, got_stats = eng.process_frames(list(clip))
    assert got_out.shape == (9, 12, 140, 0)
    np.testing.assert_allclose(got_stats, exp_stats, atol=1e-5)
    np.testing.assert_allclose(eng.heatmap(), o.heatmap, atol=1e-4)


@pytest.mark.parametrize("batch", [3, 7])
def test_engine_median_no_maps_per_frame(batch):
    props = DiPsProperties(output=OutputMode.GRAYSCALE, window_size=3,
                           temporal_size=3, method=DiPsMethod.PER_FRAME,
                           emit_maps=False)
    clip = make_clip(n=7, h=12, w=140, seed=5)
    _, exp_stats = DiPsOracle(props).run(clip)
    eng = DiPsEngine(props, 12, 140, batch=batch)
    got_out, got_stats = eng.process_frames(list(clip))
    assert got_out.shape[-1] == 0
    np.testing.assert_allclose(got_stats, exp_stats, atol=1e-5)


def test_engine_stats_equal_mapped_engine():
    """Engine-level twin of the oracle identity: the no-maps engine's
    stats/heatmap equal the mapped engine's bit for bit (same kernels,
    same order of operations — only the map output disappears)."""
    clip = make_clip(n=8, h=12, w=140, seed=6)
    e_nm = DiPsEngine(MED_NM, 12, 140, batch=4)
    e_m = DiPsEngine(MED, 12, 140, batch=4)
    _, st_nm = e_nm.process_frames(list(clip))
    _, st_m = e_m.process_frames(list(clip))
    np.testing.assert_array_equal(st_nm, st_m)
    np.testing.assert_array_equal(e_nm.heatmap(), e_m.heatmap())


def test_raw_no_maps_matches_stats_only():
    """ABSDIFF + emit_maps=False runs the raw step exactly like
    STATS_ONLY (same stats, same empty maps)."""
    clip = make_clip(n=6, h=12, w=140, seed=7)
    ad_nm = DiPsProperties(output=OutputMode.ABSDIFF, emit_maps=False)
    so = DiPsProperties(output=OutputMode.STATS_ONLY)
    e1 = DiPsEngine(ad_nm, 12, 140, batch=3)
    e2 = DiPsEngine(so, 12, 140, batch=3)
    o1, s1 = e1.process_frames(list(clip))
    o2, s2 = e2.process_frames(list(clip))
    assert o1.shape == o2.shape == (6, 12, 140, 0)
    np.testing.assert_array_equal(s1, s2)


def test_threshold_no_maps_rejects_packed_wire():
    with pytest.raises(ValueError):
        DiPsEngine(DiPsProperties(output=OutputMode.THRESHOLD,
                                  emit_maps=False),
                   12, 140, packed_wire=True)


def test_engine_no_maps_checkpoint_roundtrip(tmp_path):
    clip = make_clip(n=8, h=12, w=140, seed=8)
    eng = DiPsEngine(MED_NM, 12, 140, batch=4)
    eng.process_frames(list(clip[:4]))
    p = str(tmp_path / "nm.npz")
    eng.save(p)
    eng2 = DiPsEngine(MED_NM, 12, 140, batch=4)
    eng2.load(p)
    _, s1 = eng.process_frames(list(clip[4:]))
    _, s2 = eng2.process_frames(list(clip[4:]))
    np.testing.assert_array_equal(s1, s2)


# ------------------------------------------------------------- sharded --

@pytest.mark.parametrize("n_devices", [1, 2])
def test_multistream_median_no_maps(n_devices):
    from dips.parallel import MultiStreamEngine, stream_mesh
    clips = [make_clip(n=6, h=12, w=140, seed=s) for s in (1, 2)]
    eng = MultiStreamEngine(MED_NM, 12, 140, n_streams=2, batch=3,
                            mesh=stream_mesh(n_devices=n_devices))
    outs, stats, _ = eng.process_batch([list(c[:3]) for c in clips])
    assert outs.shape == (2, 3, 12, 140, 0)
    for si, c in enumerate(clips):
        _, exp = DiPsOracle(MED_NM).run(c[:3])
        np.testing.assert_allclose(stats[si], exp, atol=1e-5)


def test_rowsharded_median_no_maps():
    import jax
    from jax.sharding import Mesh
    from dips.parallel.rowsharded import make_rowsharded_step
    from dips.ops.reference import pad_geometry
    h, w, t, b = 16, 140, 2, 4
    hp, wp = pad_geometry(h, w)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("rows",))
    props = MED_NM.with_temporal_size(t)
    step = make_rowsharded_step(props, h, w, mesh)
    clip = make_clip(n=b, h=h, w=w, seed=11)
    raw = np.zeros((t + b, 3, hp, wp), np.uint8)
    for i in range(b):
        raw[t + i, :, :h, :w] = clip[i].transpose(2, 0, 1)
    raw[:t] = raw[t]
    flags = np.zeros((b,), bool)
    flags[0] = True
    out, stats, nb, nh = step(raw, np.zeros((hp, wp), np.float32),
                              flags, np.zeros((hp, wp), np.float32),
                              np.ones((b,), bool))
    assert out.shape == (b, 0, hp, wp)
    _, exp = DiPsOracle(props).run(clip)
    np.testing.assert_allclose(np.asarray(stats), exp, atol=1e-5)


# ----------------------------------------------------------- app / cli --

def _write_clip(path, frames, fps=20.0):
    import cv2
    h, w = frames[0].shape[:2]
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), fps,
                         (w, h))
    for f in frames:
        wr.write(f[:, :, ::-1])
    wr.release()


def test_perform_dips_no_maps(tmp_path):
    from dips.app import DiPsJob, perform_dips
    clip = make_clip(n=10, h=32, w=48, seed=7)
    vp = tmp_path / "in.avi"
    _write_clip(vp, clip)
    job = DiPsJob(properties=MED_NM, video_path=str(vp), batch=4)
    stats = perform_dips(job)
    assert stats.shape == (10, NUM_STATS)
    assert not list(tmp_path.glob("*.dips.avi"))


def test_cli_no_maps_run(tmp_path, capsys):
    from dips.cli import main as cli_main
    vp = tmp_path / "in.avi"
    _write_clip(vp, make_clip(n=8, h=32, w=48, seed=8))
    sj = tmp_path / "stats.json"
    rc = cli_main(["--input", str(vp), "--no-maps", "--win_size", "3",
                   "--stats-json", str(sj), "--batch", "4"])
    assert rc == 0
    assert "stats only" in capsys.readouterr().out
    import json
    rows = json.loads(sj.read_text())
    assert len(rows) == 8 and "mean_abs_diff" in rows[0]


def test_cli_no_maps_rejections(tmp_path, capsys):
    from dips.cli import main as cli_main
    rc = cli_main(["--input", "x.avi", "--output", "y.avi", "--no-maps"])
    assert rc == 2
    assert "--no-maps" in capsys.readouterr().err
    for extra in (["--record-events", str(tmp_path)],
                  ["--denoise", "5"], ["--packed-wire"], ["--live"]):
        rc = cli_main(["--input", "x.avi", "--no-maps", *extra])
        assert rc == 2, extra


# -------------------------------------------------------------- serve --

def test_serve_median_no_maps():
    from dips.serve import DiPsClient, DiPsServer
    props = MED_NM.with_temporal_size(2)
    srv = DiPsServer(props, 24, 40, port=0, batch=2)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        clip = make_clip(n=4, h=24, w=40, seed=2)
        cli = DiPsClient(srv.port)
        maps, stats = cli.process_many(clip)
        assert maps.shape == (4, 24, 40, 0)
        _, exp = DiPsOracle(props).run(clip)
        np.testing.assert_allclose(stats, exp, atol=1e-5)
        cli.close()
    finally:
        srv.shutdown()
