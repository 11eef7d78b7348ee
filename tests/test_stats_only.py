"""STATS_ONLY output mode: the no-map fleet path.

The raw integer absdiff pipeline with the diff-map output suppressed end to
end — same statistics, heatmap, baseline capture/refresh semantics as
ABSDIFF, zero output channels everywhere (engines return (n, H, W, 0)).
"""

import threading

import numpy as np
import pytest

from dips.models import DiPsEngine
from dips.ops.oracle import DiPsOracle, NUM_STATS
from dips.properties import (DiPsMethod, DiPsProperties, OutputMode)
from tests.conftest import make_clip

SO = DiPsProperties(output=OutputMode.STATS_ONLY, temporal_size=2)
AD = DiPsProperties(output=OutputMode.ABSDIFF, temporal_size=2)


def test_out_channels_zero():
    assert SO.out_channels == 0
    assert SO.with_output("stats_only") == SO  # name round-trip


def test_oracle_stats_match_absdiff():
    """The mode's stats/heatmap ARE absdiff's; only the map disappears."""
    clip = make_clip(n=8, h=12, w=140)
    o_so, o_ad = DiPsOracle(SO), DiPsOracle(AD)
    out_so, st_so = o_so.run(clip)
    out_ad, st_ad = o_ad.run(clip)
    assert out_so.shape == (8, 12, 140, 0)
    np.testing.assert_array_equal(st_so, st_ad)
    np.testing.assert_array_equal(o_so.heatmap, o_ad.heatmap)


@pytest.mark.parametrize("batch", [2, 4, 9])
def test_engine_stats_only_vs_oracle(batch):
    """Any batch split (chunk boundaries before, on and after the marker):
    exact stats vs the oracle, empty maps, refresh markers honored."""
    props = SO.with_refresh_markers((5,))
    clip = make_clip(n=9, h=12, w=140, seed=4)
    o = DiPsOracle(props)
    exp_out, exp_stats = o.run(clip)
    eng = DiPsEngine(props, 12, 140, batch=batch)
    got_out, got_stats = eng.process_frames(list(clip))
    assert got_out.shape == (9, 12, 140, 0)
    np.testing.assert_allclose(got_stats, exp_stats, atol=1e-5)
    np.testing.assert_allclose(eng.heatmap(), o.heatmap, atol=1e-4)


def test_engine_stats_only_per_frame():
    props = DiPsProperties(output=OutputMode.STATS_ONLY, temporal_size=2,
                           method=DiPsMethod.PER_FRAME)
    clip = make_clip(n=7, h=12, w=140, seed=5)
    o = DiPsOracle(props)
    _, exp_stats = o.run(clip)
    for batch in (3, 7):
        eng = DiPsEngine(props, 12, 140, batch=batch)
        got_out, got_stats = eng.process_frames(list(clip))
        assert got_out.shape[-1] == 0
        np.testing.assert_allclose(got_stats, exp_stats, atol=1e-5)


def test_engine_stats_only_checkpoint_roundtrip(tmp_path):
    """Checkpoints carry the raw baseline/tail exactly like ABSDIFF."""
    clip = make_clip(n=8, h=12, w=140, seed=6)
    eng = DiPsEngine(SO, 12, 140, batch=4)
    eng.process_frames(list(clip[:4]))
    p = str(tmp_path / "so.npz")
    eng.save(p)
    eng2 = DiPsEngine(SO, 12, 140, batch=4)
    eng2.load(p)
    _, s1 = eng.process_frames(list(clip[4:]))
    _, s2 = eng2.process_frames(list(clip[4:]))
    np.testing.assert_array_equal(s1, s2)


def test_multistream_stats_only():
    from dips.parallel import MultiStreamEngine, stream_mesh
    clips = [make_clip(n=6, h=12, w=140, seed=s) for s in (1, 2)]
    eng = MultiStreamEngine(SO, 12, 140, n_streams=2, batch=3,
                            mesh=stream_mesh(n_devices=2))
    outs, stats, _ = eng.process_batch([list(c[:3]) for c in clips])
    assert outs.shape == (2, 3, 12, 140, 0)
    for si, c in enumerate(clips):
        o = DiPsOracle(SO)
        _, exp = o.run(c[:3])
        np.testing.assert_allclose(stats[si], exp, atol=1e-5)


# ---------------------------------------------------------------- app --

def _write_clip(path, frames, fps=20.0):
    import cv2
    h, w = frames[0].shape[:2]
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), fps,
                         (w, h))
    for f in frames:
        wr.write(f[:, :, ::-1])
    wr.release()


def test_perform_dips_stats_only(tmp_path):
    """No output video: perform_dips runs writer-less and returns stats."""
    from dips.app import DiPsJob, perform_dips
    clip = make_clip(n=10, h=32, w=48, seed=7)
    vp = tmp_path / "in.avi"
    _write_clip(vp, clip)
    job = DiPsJob(properties=SO, video_path=str(vp), batch=4)
    stats = perform_dips(job)
    assert stats.shape == (10, NUM_STATS)
    assert job.engine.heatmap().shape == (32, 48)
    assert not list(tmp_path.glob("*.dips.avi"))


def test_perform_dips_stats_only_rejects_map_consumers(tmp_path):
    from dips.app import DiPsJob, perform_dips
    from dips.errors import DiPsError
    vp = tmp_path / "in.avi"
    _write_clip(vp, make_clip(n=4, h=32, w=48))
    with pytest.raises(DiPsError):
        perform_dips(DiPsJob(properties=SO, video_path=str(vp),
                             output_path=str(tmp_path / "out.avi")))
    with pytest.raises(ValueError):
        perform_dips(DiPsJob(properties=SO, video_path=str(vp),
                             record_events=dict(dir=str(tmp_path))))
    with pytest.raises(ValueError):
        perform_dips(DiPsJob(properties=SO, video_path=str(vp),
                             denoise_radius=5))


def test_run_dips_on_files_stats_only(tmp_path):
    """Fleet batch mode: no writers, no output dir contents, stats flow."""
    from dips.app import run_dips_on_files
    paths = []
    for k in (0, 1):
        p = tmp_path / f"s{k}.avi"
        _write_clip(p, make_clip(n=6, h=32, w=48, seed=k))
        paths.append(str(p))
    odir = tmp_path / "out"
    counts, per_stats = run_dips_on_files(
        paths, str(odir), properties=SO, batch=3, collect_stats=True)
    assert list(counts) == [6, 6]
    assert not odir.exists()  # never even created
    assert per_stats[0].shape == (6, NUM_STATS)


# ---------------------------------------------------------------- cli --

def test_cli_stats_only_run(tmp_path, capsys):
    from dips.cli import main as cli_main
    vp = tmp_path / "in.avi"
    _write_clip(vp, make_clip(n=8, h=32, w=48, seed=8))
    sj = tmp_path / "stats.json"
    rc = cli_main(["--input", str(vp), "--output-mode", "stats_only",
                   "--stats-json", str(sj), "--batch", "4"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "stats only" in out
    import json
    rows = json.loads(sj.read_text())
    assert len(rows) == 8 and "mean_abs_diff" in rows[0]


def test_cli_stats_only_rejections(tmp_path, capsys):
    from dips.cli import main as cli_main
    # --output contradicts the mode
    rc = cli_main(["--input", "x.avi", "--output", "y.avi",
                   "--output-mode", "stats_only"])
    assert rc == 2
    assert "stats_only" in capsys.readouterr().err
    # map-consuming flags are rejected at the flag level
    for extra in (["--record-events", str(tmp_path)],
                  ["--denoise", "5"], ["--packed-wire"], ["--live"]):
        rc = cli_main(["--input", "x.avi", "--output-mode", "stats_only",
                       *extra])
        assert rc == 2, extra


def test_cli_stats_only_inputs_fleet(tmp_path, capsys):
    """--inputs without --output-dir is legal in stats-only mode."""
    from dips.cli import main as cli_main
    paths = []
    for k in (0, 1):
        p = tmp_path / f"f{k}.avi"
        _write_clip(p, make_clip(n=6, h=32, w=48, seed=k))
        paths.append(str(p))
    sj = tmp_path / "fleet.json"
    rc = cli_main(["--inputs", *paths, "--output-mode", "stats_only",
                   "--stats-json", str(sj), "--batch", "3"])
    assert rc == 0
    assert "stats only" in capsys.readouterr().out
    import json
    doc = json.loads(sj.read_text())
    assert set(doc) == set(paths) and len(doc[paths[0]]) == 6


# -------------------------------------------------------------- serve --

def test_serve_stats_only():
    """The daemon serves the mode: ~zero-byte map payloads, full stats."""
    from dips.serve import DiPsClient, DiPsServer
    srv = DiPsServer(SO, 24, 40, port=0, batch=2)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        clip = make_clip(n=4, h=24, w=40, seed=2)
        cli = DiPsClient(srv.port)
        maps, stats = cli.process_many(clip)
        assert maps.shape == (4, 24, 40, 0)
        assert stats.shape == (4, NUM_STATS)
        o = DiPsOracle(SO)
        _, exp = o.run(clip)
        np.testing.assert_allclose(stats, exp, atol=1e-5)
        hm = cli.heatmap()
        assert hm.shape == (24, 40)
        cli.close()
    finally:
        srv.shutdown()
