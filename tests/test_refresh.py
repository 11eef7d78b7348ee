"""Adaptive baseline refresh (ops/refresh.BaselineRefreshPolicy) — the
automated SnapShot button for unattended scene changes.

The reference only re-captures on static refresh markers
(dips_alt/src/lib.rs:668-670) or a human click (lib.rs:296-298); the
policy here watches the per-frame stats the engine already downloads and
re-pins the OVERALL baseline when the scene changes wholesale."""

import numpy as np
import pytest

from dips import DiPsJob, DiPsProperties, perform_dips
from dips.cli import main as cli_main
from dips.io.synthetic import write_clip
from dips.ops.refresh import BaselineRefreshPolicy
from dips.properties import DiPsMethod


def row(changed, mean_abs=0.1):
    """Stats row (mean, mean|.|, max|.|, changed_count)."""
    return np.array([0.0, mean_abs, 0.5, changed], np.float32)


# ---------------------------------------------------------------- unit --

def test_fires_after_persist_consecutive_hot_frames():
    p = BaselineRefreshPolicy(threshold=0.5, persist=3, cooldown=10,
                              pixels=100)
    assert not p.feed(0, row(60))
    assert not p.feed(1, row(60))
    assert p.feed(2, row(60))            # 3rd consecutive hot frame
    assert p.refreshes == [2]


def test_low_frame_resets_the_persist_counter():
    p = BaselineRefreshPolicy(threshold=0.5, persist=3, cooldown=10,
                              pixels=100)
    assert not p.feed(0, row(60))
    assert not p.feed(1, row(60))
    assert not p.feed(2, row(10))        # dip: restart the count
    assert not p.feed(3, row(60))
    assert not p.feed(4, row(60))
    assert p.feed(5, row(60))
    assert p.refreshes == [5]


def test_cooldown_suppresses_and_does_not_accumulate():
    p = BaselineRefreshPolicy(threshold=0.5, persist=2, cooldown=5,
                              pixels=100)
    assert not p.feed(0, row(60))
    assert p.feed(1, row(60))
    # frames 2..6 are inside the cooldown window: inert AND they must not
    # pre-charge the persist counter for frame 7
    for i in range(2, 7):
        assert not p.feed(i, row(60))
    assert not p.feed(7, row(60))        # first counted frame after cooldown
    assert p.feed(8, row(60))            # persistently hot -> re-fires
    assert p.refreshes == [1, 8]


def test_changed_frac_normalisation_and_other_metrics():
    p = BaselineRefreshPolicy(threshold=0.5, persist=1, pixels=1000)
    assert not p.feed(0, row(400))       # 0.4 < 0.5
    assert p.feed(1, row(500))           # 0.5 >= 0.5 (inclusive)
    m = BaselineRefreshPolicy(threshold=0.2, persist=1,
                              metric="mean_abs_diff")
    assert not m.feed(0, row(0, mean_abs=0.1))
    assert m.feed(1, row(0, mean_abs=0.3))


def test_validation_errors():
    with pytest.raises(ValueError):
        BaselineRefreshPolicy(metric="changed_frac")     # needs pixels
    with pytest.raises(ValueError):
        BaselineRefreshPolicy(metric="bogus", pixels=10)
    with pytest.raises(ValueError):
        BaselineRefreshPolicy(threshold=0.0, pixels=10)
    with pytest.raises(ValueError):
        BaselineRefreshPolicy(threshold=1.5, pixels=10)  # frac > 1
    with pytest.raises(ValueError):
        BaselineRefreshPolicy(persist=0, pixels=10, threshold=0.5)
    with pytest.raises(ValueError):
        BaselineRefreshPolicy(cooldown=-1, pixels=10, threshold=0.5)


# ---------------------------------------------------- end-to-end --------

def scene_cut_clip(tmp_path, n_a=8, n_b=24, h=64, w=96):
    """Solid scene A then a hard cut to solid scene B (MJPG-clean)."""
    frames = np.empty((n_a + n_b, h, w, 3), np.uint8)
    frames[:n_a] = 30
    frames[n_a:] = 220
    return write_clip(frames, str(tmp_path / "cut.avi")), n_a, n_b


def test_perform_dips_recovers_from_a_scene_cut(tmp_path):
    path, n_a, n_b = scene_cut_clip(tmp_path)
    props = DiPsProperties(window_size=1, temporal_size=1)
    pixels = 64 * 96

    # without auto-refresh the post-cut frames diff hot forever
    base = DiPsJob(properties=props, video_path=path,
                   output_path=str(tmp_path / "plain.avi"), batch=4)
    stats = perform_dips(base)
    assert stats[-1, 3] / pixels > 0.9
    assert base.baseline_refreshes is None  # artifact only when enabled

    job = DiPsJob(properties=props, video_path=path,
                  output_path=str(tmp_path / "auto.avi"), batch=4,
                  auto_refresh=dict(threshold=0.5, persist=2))
    stats = perform_dips(job)
    assert stats.shape[0] == n_a + n_b
    # fired shortly after the cut (persist=2 -> second hot frame)
    assert job.baseline_refreshes == [n_a + 1]
    # the snapshot lands on a following batch; the tail of the clip diffs
    # against the NEW baseline and goes quiet
    assert stats[-1, 3] / pixels < 0.05
    assert stats[-4:, 3].max() / pixels < 0.05


def test_per_frame_method_is_rejected(tmp_path):
    path, _, _ = scene_cut_clip(tmp_path, n_a=4, n_b=4)
    job = DiPsJob(properties=DiPsProperties(method=DiPsMethod.PER_FRAME),
                  video_path=path,
                  output_path=str(tmp_path / "o.avi"),
                  auto_refresh=dict(threshold=0.5))
    with pytest.raises(ValueError, match="per_frame"):
        perform_dips(job)


def test_bad_config_rejects_unknown_kwargs(tmp_path):
    path, _, _ = scene_cut_clip(tmp_path, n_a=4, n_b=4)
    job = DiPsJob(properties=DiPsProperties(), video_path=path,
                  output_path=str(tmp_path / "o.avi"),
                  auto_refresh=dict(threshold=0.5, bogus=1))
    with pytest.raises(TypeError):
        perform_dips(job)


# ---------------------------------------------------------------- CLI --

def test_cli_auto_refresh(tmp_path, capsys):
    path, n_a, _ = scene_cut_clip(tmp_path)
    rc = cli_main(["--input", path, "--output", str(tmp_path / "o.avi"),
                   "--win_size", "1", "--temporal", "1", "--batch", "4",
                   "--auto-refresh", "0.5:2"])
    assert rc == 0
    out = capsys.readouterr().out
    assert f"auto-refresh fired at frame(s): {n_a + 1}" in out


def test_cli_auto_refresh_quiet_run(tmp_path, capsys):
    frames = np.full((8, 64, 96, 3), 30, np.uint8)
    path = write_clip(frames, str(tmp_path / "still.avi"))
    rc = cli_main(["--input", path, "--output", str(tmp_path / "o.avi"),
                   "--auto-refresh", "0.5"])
    assert rc == 0
    assert "no scene change detected" in capsys.readouterr().out


def test_cli_auto_refresh_bad_values(tmp_path, capsys):
    for bad in ("abc", "0.5:x", "0.5:2:3:4"):
        rc = cli_main(["--input", "i.avi", "--output", "o.avi",
                       "--auto-refresh", bad])
        assert rc == 2, bad
        assert "bad --auto-refresh" in capsys.readouterr().err


def test_cli_auto_refresh_needs_single_input_mode(tmp_path, capsys):
    # dat/thumbnail/subsample have no streaming baseline -> rejected
    rc = cli_main(["--dat-dir", str(tmp_path), "--output",
                   str(tmp_path / "o.avi"), "--auto-refresh", "0.5"])
    assert rc == 2
    assert "--auto-refresh" in capsys.readouterr().err


def test_cli_auto_refresh_live_arms_the_preview(monkeypatch):
    """--auto-refresh composes with --live since r3: it arms the preview's
    'a' toggle (ADVICE r2) — the parsed policy kwargs reach run_live."""
    seen = {}

    def fake_run_live(props, reader=None, auto_refresh=None):
        seen["auto_refresh"] = auto_refresh
        return 0

    import dips.live as live_mod
    monkeypatch.setattr(live_mod, "run_live", fake_run_live)
    rc = cli_main(["--live", "--auto-refresh", "0.5:2:8"])
    assert rc == 0
    assert seen["auto_refresh"] == {"threshold": 0.5, "persist": 2,
                                    "cooldown": 8}


# ------------------------------------------------- multi-video batch --

def test_run_dips_on_files_per_stream_refresh(tmp_path):
    """Scene cut on stream 0 only re-pins stream 0's baseline; the return
    gains one fired-index list per stream."""
    from dips.app import run_dips_on_files

    h, w = 32, 48
    cut = np.empty((16, h, w, 3), np.uint8)
    cut[:6] = 30
    cut[6:] = 220
    still = np.full((16, h, w, 3), 30, np.uint8)
    p0 = write_clip(cut, str(tmp_path / "cut.avi"))
    p1 = write_clip(still, str(tmp_path / "still.avi"))
    props = DiPsProperties(window_size=1, temporal_size=1)
    counts, stats, refreshes = run_dips_on_files(
        [p0, p1], str(tmp_path / "out"), properties=props, batch=4,
        collect_stats=True,
        auto_refresh=dict(threshold=0.5, persist=2))
    assert list(counts) == [16, 16]
    assert refreshes == [[7], []]  # cut at 6, persist 2; still never fires
    px = h * w
    assert stats[0][6, 3] / px > 0.9      # hot against the old baseline
    assert stats[0][-1, 3] / px < 0.05    # re-pinned: tail quiet
    assert stats[1][:, 3].max() == 0      # untouched stream stays zero


def test_run_dips_on_files_refresh_rejects_per_frame(tmp_path):
    from dips.app import run_dips_on_files

    clip = np.full((4, 32, 48, 3), 30, np.uint8)
    p = write_clip(clip, str(tmp_path / "c.avi"))
    with pytest.raises(ValueError, match="per_frame"):
        run_dips_on_files(
            [p], str(tmp_path / "out"),
            properties=DiPsProperties(method=DiPsMethod.PER_FRAME),
            auto_refresh=dict(threshold=0.5))


def test_cli_inputs_auto_refresh(tmp_path, capsys):
    h, w = 32, 48
    cut = np.empty((16, h, w, 3), np.uint8)
    cut[:6] = 30
    cut[6:] = 220
    p0 = write_clip(cut, str(tmp_path / "cut.avi"))
    rc = cli_main(["--inputs", p0, "--output-dir", str(tmp_path / "out"),
                   "--win_size", "1", "--temporal", "1", "--batch", "4",
                   "--auto-refresh", "0.5:2"])
    assert rc == 0
    out = capsys.readouterr().out
    assert f"auto-refresh fired on {p0} at frame(s): 7" in out


# ------------------------------------------------------------ serving --

def cut_frames(n_a, n_b, h=24, w=40):
    frames = np.empty((n_a + n_b, h, w, 3), np.uint8)
    frames[:n_a] = 30
    frames[n_a:] = 220
    return frames


def test_serve_auto_refresh_per_session(tmp_path):
    """Two fleet cameras on one daemon: a scene cut on cam-A re-pins ONLY
    cam-A's baseline, annotated on the fired reply."""
    import threading

    from dips.serve import DiPsClient, DiPsServer

    props = DiPsProperties(window_size=1, temporal_size=1)
    srv = DiPsServer(props, 24, 40, port=0, batch=1, max_sessions=2,
                     auto_refresh=dict(threshold=0.5, persist=2,
                                       cooldown=2))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        a = DiPsClient(srv.port, session="cam-A")
        b = DiPsClient(srv.port, session="cam-B")
        assert a.hello()["config"]["auto_refresh"] is True
        frames_a = cut_frames(4, 8)
        frames_b = np.full((12, 24, 40, 3), 30, np.uint8)  # still camera
        fired = []
        stats_a = []
        for i in range(12):
            _, s = a.process(frames_a[i])
            stats_a.append(s)
            if a.last_refresh is not None:
                fired.append((i, a.last_refresh))
            _, _ = b.process(frames_b[i])
            assert b.last_refresh is None  # the still camera never fires
        # cut at 4, persist 2 -> fires on frame 5's reply
        assert fired == [(5, 5)]
        px = 24 * 40
        assert stats_a[4][3] / px > 0.9      # hot against the old baseline
        assert stats_a[-1][3] / px < 0.05    # quiet against the new one
        assert srv.metrics()["auto_refreshes"] == 1
        a.close()
        b.close()
    finally:
        srv.shutdown()


def test_serve_auto_refresh_batched_and_coalesced():
    """process_batch carries the annotation; coalesced slots refresh
    independently too."""
    import threading

    from dips.serve import DiPsClient, DiPsServer

    props = DiPsProperties(window_size=1, temporal_size=1)
    srv = DiPsServer(props, 24, 40, port=0, batch=4, max_sessions=2,
                     coalesce=2,
                     auto_refresh=dict(threshold=0.5, persist=2,
                                       cooldown=6))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        cli = DiPsClient(srv.port, session="cam-A")
        frames = cut_frames(4, 12)
        _, stats = cli.process_many(frames[:8])
        assert cli.last_refresh == 5  # cut at 4, persist 2
        _, stats2 = cli.process_many(frames[8:])
        assert cli.last_refresh is None
        px = 24 * 40
        assert stats2[-1][3] / px < 0.05  # re-pinned: tail is quiet
        cli.close()
    finally:
        srv.shutdown()


def test_serve_auto_refresh_rejects_per_frame_and_bad_cfg():
    from dips.serve import DiPsServer, main as serve_main

    with pytest.raises(ValueError, match="per_frame"):
        DiPsServer(DiPsProperties(method=DiPsMethod.PER_FRAME), 24, 40,
                   port=0, auto_refresh=dict(threshold=0.5))
    with pytest.raises(ValueError):
        DiPsServer(DiPsProperties(), 24, 40, port=0,
                   auto_refresh=dict(threshold=0.0))
    assert serve_main(["--height", "24", "--width", "40",
                       "--auto-refresh", "nope"]) == 2


def test_suppress_until_extends_the_cool_window():
    """suppress_until re-bases the cooldown on when the snapshot actually
    lands (serve: a fire mid-request diffs the old baseline until the
    request ends) — no trigger before the given index, and it never
    SHRINKS an already-longer window."""
    p = BaselineRefreshPolicy(threshold=0.5, persist=2, cooldown=2,
                              pixels=100)
    assert not p.feed(0, row(60))
    assert p.feed(1, row(60))            # fires; cool until 1+1+2 = 4
    p.suppress_until(8)                  # request ended at 6, cooldown 2
    for i in range(2, 8):
        assert not p.feed(i, row(60))    # hot but suppressed
    assert not p.feed(8, row(60))        # persist restarts at 8
    assert p.feed(9, row(60))
    assert p.refreshes == [1, 9]
    p.suppress_until(5)                  # never shrinks
    assert not p.feed(10, row(60))
