"""Fleet flicker analysis: per-stream vibration maps on
the fleet surfaces — MultiStreamEngine-shaped feeds, --inputs batch mode and
coalesced serve slots — via ONE stacked scan dispatch per round
(ops/analysis.FleetFlickerAnalyzer), bit-matching per-stream
FlickerAnalyzers.
"""

import threading

import numpy as np
import pytest

from dips.ops.analysis import FleetFlickerAnalyzer, FlickerAnalyzer


def _flicker_clip(n, h=16, w=24, freq=5.0, fps=30.0, amp=40, seed=0,
                  spot=(4, 6)):
    """Static noise + one square oscillating at freq Hz."""
    r = np.random.default_rng(seed)
    base = r.integers(60, 180, (h, w, 3), np.int32)
    frames = np.empty((n, h, w, 3), np.uint8)
    y, x = spot
    for i in range(n):
        f = base.copy()
        osc = amp * np.cos(2 * np.pi * freq * i / fps)
        f[y:y + 3, x:x + 3] += int(round(osc))
        frames[i] = np.clip(f, 0, 255).astype(np.uint8)
    return frames


def test_fleet_bit_matches_single_stream():
    """Two streams, different content, same config: fleet maps ==
    per-stream analyzer maps bit for bit."""
    fps, freq = 30.0, 5.0
    clips = [_flicker_clip(64, seed=s, spot=(4 + 3 * s, 6)) for s in (0, 1)]
    fleet = FleetFlickerAnalyzer(2)
    fleet.configure_all(freq, fps)
    singles = [FlickerAnalyzer(freq, fps, batch=8) for _ in range(2)]
    for k in range(0, 64, 8):
        fleet.update([list(c[k:k + 8]) for c in clips])
        for si, c in enumerate(clips):
            singles[si].update(c[k:k + 8])
    for si in range(2):
        np.testing.assert_array_equal(fleet.amplitude(si),
                                      singles[si].amplitude())
    # the oscillating spot dominates each map
    for si in range(2):
        amp = fleet.amplitude(si)
        py, px = np.unravel_index(int(np.argmax(amp)), amp.shape)
        assert (4 + 3 * si <= py < 7 + 3 * si) and (6 <= px < 9)


def test_fleet_staggered_and_gated():
    """Ragged rounds (streams advance on independent cursors, one stalls)
    still bit-match independent analyzers."""
    fps, freq = 24.0, 4.0
    clips = [_flicker_clip(40, seed=s, freq=freq, fps=fps) for s in (2, 3)]
    fleet = FleetFlickerAnalyzer(2)
    fleet.configure(0, freq, fps)
    fleet.configure(1, freq, fps, tau_frames=20.0)
    singles = [FlickerAnalyzer(freq, fps, batch=4),
               FlickerAnalyzer(freq, fps, tau_frames=20.0, batch=4)]
    cursors = [0, 0]
    for counts in ((4, 2), (0, 4), (3, 0), (4, 4), (1, 3)):
        feeds = []
        for si, n in enumerate(counts):
            feeds.append(list(clips[si][cursors[si]:cursors[si] + n]))
            if n:
                singles[si].update(clips[si][cursors[si]:cursors[si] + n])
            cursors[si] += n
        fleet.update(feeds)
    for si in range(2):
        singles[si].flush()
        np.testing.assert_array_equal(fleet.amplitude(si),
                                      singles[si].amplitude())
        assert fleet.frames_seen[si] == singles[si].frames_seen


def test_fleet_per_stream_configs_and_reset():
    """Different (freq, fps) per stream coexist in one fleet; reset_stream
    restarts one window without touching siblings."""
    clips = [_flicker_clip(32, freq=5.0, fps=30.0, seed=4),
             _flicker_clip(32, freq=8.0, fps=60.0, seed=5)]
    fleet = FleetFlickerAnalyzer(2)
    fleet.configure(0, 5.0, 30.0)
    fleet.configure(1, 8.0, 60.0)
    fleet.update([list(clips[0][:16]), list(clips[1][:16])])
    before = fleet.amplitude(1).copy()
    fleet.reset_stream(0)
    assert fleet.frames_seen[0] == 0 and fleet.frames_seen[1] == 16
    np.testing.assert_array_equal(fleet.amplitude(1), before)
    # stream 0 restarts cleanly and matches a fresh single analyzer
    fleet.update([list(clips[0][16:]), []])
    ref = FlickerAnalyzer(5.0, 30.0, batch=16)
    ref.update(clips[0][16:])
    np.testing.assert_array_equal(fleet.amplitude(0), ref.amplitude())


def test_fleet_validation():
    fleet = FleetFlickerAnalyzer(2)
    with pytest.raises(ValueError, match="freq_hz"):
        fleet.configure(0, 20.0, 30.0)  # above Nyquist
    with pytest.raises(ValueError, match="fps"):
        fleet.configure(0, 5.0, 0.0)
    fleet.configure(0, 5.0, 30.0)
    with pytest.raises(RuntimeError, match="no flicker"):
        fleet.power(1)
    with pytest.raises(RuntimeError, match="no frames"):
        fleet.power(0)
    with pytest.raises(ValueError, match="expected 2 streams"):
        fleet.update([[]])


# ------------------------------------------------------------- app/cli --

def _write_clip(path, frames, fps):
    import cv2
    h, w = frames[0].shape[:2]
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), fps,
                         (w, h))
    for f in frames:
        wr.write(f[:, :, ::-1])
    wr.release()


def test_run_dips_on_files_flicker(tmp_path):
    from dips.app import run_dips_on_files
    from dips.properties import DiPsProperties, OutputMode
    fps = 20.0
    paths = []
    for k in (0, 1):
        p = tmp_path / f"s{k}.avi"
        _write_clip(p, _flicker_clip(24, freq=4.0, fps=fps,
                                     spot=(4 + 4 * k, 6), seed=k), fps)
        paths.append(str(p))
    counts, maps = run_dips_on_files(
        paths, str(tmp_path / "out"),
        properties=DiPsProperties(output=OutputMode.STATS_ONLY),
        batch=4, flicker=dict(freq_hz=4.0))
    assert list(counts) == [24, 24]
    assert maps.shape == (2, 16, 24)
    for k in range(2):
        py, px = np.unravel_index(int(np.argmax(maps[k])), maps[k].shape)
        assert 4 + 4 * k <= py < 7 + 4 * k, (k, py, px)


def test_run_dips_on_files_flicker_zero_frames(tmp_path, monkeypatch):
    """A flicker-armed batch run whose inputs decode ZERO frames returns
    zero amplitude maps at the input geometry instead of raising."""
    from dips import app
    from dips.io import gstreamer
    from dips.properties import DiPsProperties, OutputMode

    class _Empty:
        height, width, fps = 16, 24, 20.0

        def __init__(self, path):
            self.path = path

        def read(self):
            return None

        def close(self):
            pass

    monkeypatch.setattr(gstreamer, "open_video",
                        lambda p, backend="auto": _Empty(p))
    counts, maps = app.run_dips_on_files(
        ["a.avi", "b.avi"], str(tmp_path / "out"),
        properties=DiPsProperties(output=OutputMode.STATS_ONLY),
        batch=4, flicker=dict(freq_hz=4.0))
    assert list(counts) == [0, 0]
    assert maps.shape == (2, 16, 24) and not maps.any()


def test_cli_inputs_flicker(tmp_path, capsys):
    from dips.cli import main as cli_main
    fps = 20.0
    paths = []
    for k in (0, 1):
        p = tmp_path / f"f{k}.avi"
        _write_clip(p, _flicker_clip(16, freq=4.0, fps=fps, seed=k), fps)
        paths.append(str(p))
    png = tmp_path / "flick.png"
    rc = cli_main(["--inputs", *paths, "--output-mode", "stats_only",
                   "--flicker-hz", "4.0", "--flicker-png", str(png),
                   "--batch", "4"])
    assert rc == 0
    out = capsys.readouterr().out
    assert out.count("flicker @ 4 Hz") == 2
    assert (tmp_path / "flick.0.png").exists()
    assert (tmp_path / "flick.1.png").exists()


# -------------------------------------------------------------- serve --

def test_serve_coalesced_flicker():
    """Two coalesced sessions with flicker_hz: per-slot maps come from the
    coalescer's FLEET analyzer and match a single-stream analyzer fed the
    same frames."""
    from dips.serve import DiPsClient, DiPsServer
    from dips.properties import DiPsProperties, OutputMode
    fps, freq = 30.0, 5.0
    props = DiPsProperties(output=OutputMode.STATS_ONLY)
    srv = DiPsServer(props, 16, 24, port=0, batch=4, coalesce=2)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        clips = [_flicker_clip(32, freq=freq, fps=fps,
                               spot=(4 + 3 * s, 6), seed=s)
                 for s in (0, 1)]
        clients = [DiPsClient(srv.port, session=f"cam-{s}",
                              flicker_hz=freq, flicker_fps=fps)
                   for s in (0, 1)]
        for k in range(0, 32, 4):
            for s, cli in enumerate(clients):
                cli.process_many(clips[s][k:k + 4])
        assert srv._coalescer._fleet_flicker is not None
        for s, cli in enumerate(clients):
            amp, info = cli.flicker()
            assert info["frames"] == 32
            ref = FlickerAnalyzer(freq, fps, batch=4)
            ref.update(clips[s])
            np.testing.assert_array_equal(amp, ref.amplitude())
        for cli in clients:
            cli.close()
    finally:
        srv.shutdown()
