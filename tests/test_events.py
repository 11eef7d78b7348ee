"""Motion-event segmentation (ops/events.py): hysteresis, debounce,
cooldown, streaming batch boundaries, and the CLI surface."""

import json

import numpy as np
import pytest

from dips.ops.events import MotionDetector, detect_events
from dips.ops.oracle import NUM_STATS

from tests.conftest import make_clip


def _stats(mean_abs_series, changed=None):
    """Build (B, NUM_STATS) rows from a mean-|diff| series."""
    s = np.zeros((len(mean_abs_series), NUM_STATS), np.float32)
    s[:, 1] = mean_abs_series
    s[:, 2] = np.asarray(mean_abs_series) * 2  # max tracks mean here
    if changed is not None:
        s[:, 3] = changed
    return s


def test_basic_open_close_hysteresis():
    det = MotionDetector(on_threshold=10, off_threshold=4)
    # rises to 12 at frame 2, sags to 5 (above off: stays open),
    # drops to 1 at frame 6 -> closes with end at the last >=off frame
    evs = det.update(_stats([0, 0, 12, 20, 5, 8, 1, 0]))
    assert len(evs) == 1
    e = evs[0]
    assert (e.start_frame, e.end_frame) == (2, 5)
    assert e.frames == 4
    assert e.peak == 20 and e.peak_frame == 3
    assert e.mean == pytest.approx((12 + 20 + 5 + 8) / 4)
    assert det.flush() == []


def test_between_thresholds_does_not_open():
    det = MotionDetector(on_threshold=10, off_threshold=4)
    assert det.update(_stats([5, 9, 6, 5])) == []  # above off, below on
    assert det.flush() == []


def test_min_frames_debounce():
    det = MotionDetector(on_threshold=10, min_frames=3)
    assert det.update(_stats([0, 15, 0, 0])) == []  # 1-frame blip dropped
    evs = det.update(_stats([15, 15, 15, 0]), start_index=4)
    assert len(evs) == 1 and evs[0].frames == 3


def test_cooldown_bridges_dips():
    det = MotionDetector(on_threshold=10, off_threshold=4, cooldown=2)
    # two sub-off frames inside the event are tolerated; the third closes
    evs = det.update(_stats([12, 1, 1, 12, 1, 1, 1, 0, 0]))
    assert len(evs) == 1
    assert (evs[0].start_frame, evs[0].end_frame) == (0, 3)
    # the discarded sub-off tail is excluded from the mean
    assert evs[0].mean == pytest.approx((12 + 1 + 1 + 12) / 4)


def test_event_spans_batch_boundary_and_flush():
    det = MotionDetector(on_threshold=10)
    assert det.update(_stats([0, 12, 15])) == []   # still open at batch end
    assert det.update(_stats([15, 12])) == []      # continues
    evs = det.flush()                              # EOS closes it
    assert len(evs) == 1
    assert (evs[0].start_frame, evs[0].end_frame) == (1, 4)
    assert det.flush() == []                       # idempotent


def test_gap_inside_open_event_raises_closed_gap_allowed():
    det = MotionDetector(on_threshold=10)
    det.update(_stats([0, 12]))
    with pytest.raises(ValueError, match="gap"):
        det.update(_stats([12]), start_index=7)
    det2 = MotionDetector(on_threshold=10)
    det2.update(_stats([0, 0]))
    evs = det2.update(_stats([12, 0]), start_index=10)  # seek while closed
    assert evs[0].start_frame == 10


def test_changed_frac_normalizes_by_pixels():
    det = MotionDetector(on_threshold=0.5, metric="changed_frac",
                         pixels=100)
    evs = det.update(_stats([0, 0, 0], changed=[10, 60, 0]))
    assert len(evs) == 1 and evs[0].peak == pytest.approx(0.6)
    with pytest.raises(ValueError, match="pixels"):
        MotionDetector(on_threshold=0.5, metric="changed_frac")


def test_validation_errors():
    with pytest.raises(ValueError, match="metric"):
        MotionDetector(on_threshold=1, metric="bogus")
    with pytest.raises(ValueError, match="hysteresis"):
        MotionDetector(on_threshold=1, off_threshold=2)
    det = MotionDetector(on_threshold=1)
    with pytest.raises(ValueError, match="expected"):
        det.update(np.zeros((3,), np.float32))


def test_detect_events_one_shot_any_batching():
    series = [0, 12, 15, 0, 0, 20, 20, 0]
    whole = detect_events([_stats(series)], on_threshold=10)
    split = detect_events([_stats(series[:3]), _stats(series[3:])],
                          on_threshold=10)
    assert [e.to_dict() for e in whole] == [e.to_dict() for e in split]
    assert len(whole) == 2


def test_real_pipeline_stats_segment_motion(tmp_path):
    """End to end: a clip that is static, then moving, then static again
    produces one event covering the moving span."""
    from dips import DiPsEngine, DiPsProperties, OutputMode

    h, w = 16, 24
    static = make_clip(n=4, h=h, w=w, seed=3, moving=False)
    moving = make_clip(n=6, h=h, w=w, seed=3, moving=True)
    frames = list(static) + list(moving) + list(static)
    props = DiPsProperties(window_size=1, temporal_size=1,
                           output=OutputMode.ABSDIFF)
    eng = DiPsEngine(props, h, w, batch=len(frames))
    _, stats = eng.process_frames(frames)
    # mean_abs_diff is normalized intensity averaged over the FRAME, so a
    # small moving object reads ~0.02 here — thresholds are metric-scaled
    evs = detect_events([stats], on_threshold=0.01, min_frames=2)
    assert len(evs) == 1
    e = evs[0]
    # motion spans frames 4..9 (the static tail equals the baseline again)
    assert e.start_frame == 4
    assert 9 <= e.end_frame <= 10
    assert e.peak > 0.01
    # the resolution-independent metric sees the 4x4 square as ~4.2%
    evs2 = detect_events([stats], on_threshold=0.02, metric="changed_frac",
                         pixels=h * w, min_frames=2)
    assert len(evs2) == 1 and evs2[0].start_frame == 4


def test_cli_events_json(tmp_path):
    import cv2
    from dips.cli import main as cli_main

    h, w = 16, 24
    frames = (list(make_clip(n=4, h=h, w=w, seed=3, moving=False))
              + list(make_clip(n=6, h=h, w=w, seed=3, moving=True))
              + list(make_clip(n=4, h=h, w=w, seed=3, moving=False)))
    path = str(tmp_path / "in.avi")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, (w, h))
    for f in frames:
        vw.write(f[..., ::-1])
    vw.release()

    out = str(tmp_path / "out.avi")
    ev_json = str(tmp_path / "events.json")
    rc = cli_main(["--input", path, "--output", out,
                   "--output-mode", "absdiff", "--temporal", "1",
                   "--win_size", "1",
                   "--events-json", ev_json, "--event-on", "0.02",
                   "--event-min-frames", "2"])
    assert rc == 0
    events = json.load(open(ev_json))
    assert len(events) >= 1
    spans = [(e["start_frame"], e["end_frame"]) for e in events]
    # MJPG compression adds noise, but the moving span must be covered
    assert any(s <= 5 and e >= 8 for s, e in spans), spans
    assert all(set(e) >= {"start_frame", "end_frame", "frames", "peak",
                          "peak_frame", "mean"} for e in events)


def test_auto_threshold_learns_noise_floor():
    """Adaptive mode: a noisy-but-steady floor (lossy-codec reality) is
    learned from idle frames; a genuine burst above floor+k*MAD opens an
    event, and the floor estimate is frozen while it is open."""
    rng = np.random.default_rng(0)
    floor = 10 + rng.normal(0, 0.3, 64)           # noise floor ~10 +- 0.3
    burst = np.full(6, 25.0)                      # clear motion
    tail = 10 + rng.normal(0, 0.3, 16)
    det = MotionDetector("auto", metric="mean_abs_diff", min_frames=2,
                         auto_warmup=16)
    evs = det.update(_stats(np.concatenate([floor, burst, tail])))
    evs += det.flush()
    assert len(evs) == 1
    e = evs[0]
    assert e.start_frame == 64 and e.end_frame == 69
    assert e.peak == pytest.approx(25.0)
    on_t, off_t = det.thresholds()
    assert 10 < off_t < on_t < 25                 # learned, sane levels


def test_auto_threshold_warmup_blocks_events():
    det = MotionDetector("auto", auto_warmup=16)
    assert det.thresholds() == (float("inf"), float("inf"))
    # fewer idle frames than warmup: even huge values cannot open
    assert det.update(_stats([100.0] * 8)) == []
    assert det.flush() == []


def test_auto_threshold_never_fires_on_pure_noise():
    """The MJPG-on-noise pathology: motion is within the floor's spread,
    so auto mode stays silent instead of flagging the whole clip (what a
    fixed 1%% threshold does on such sources)."""
    rng = np.random.default_rng(1)
    series = 0.14 + rng.normal(0, 0.0004, 200)    # the measured drive floor
    det = MotionDetector("auto", min_frames=2)
    evs = det.update(_stats(series)) + det.flush()
    assert evs == []


def test_auto_validation():
    with pytest.raises(ValueError, match="auto"):
        MotionDetector("auto", auto_k=0)
    with pytest.raises(ValueError, match="auto"):
        MotionDetector("auto", auto_warmup=0)
    with pytest.raises(ValueError, match="auto"):
        MotionDetector("auto", auto_window=4, auto_warmup=8)


def test_auto_floor_tolerates_warmup_contamination():
    """Review regression: a stream that starts DURING motion feeds motion
    values into the warmup window (no threshold exists yet to exclude
    them); the low-quartile floor must still anchor at the idle level
    once idle frames dominate >=25% of the window, so later events fire."""
    rng = np.random.default_rng(2)
    motion_first = np.full(16, 25.0)              # contaminated warmup
    idle = 10 + rng.normal(0, 0.3, 112)           # then the true floor
    burst = np.full(6, 25.0)
    det = MotionDetector("auto", min_frames=2, auto_warmup=16)
    evs = det.update(_stats(np.concatenate([motion_first, idle, burst])))
    evs += det.flush()
    # the median-based floor would sit near 25 after this start and miss
    # the burst entirely; the quartile floor recovers
    assert len(evs) >= 1
    assert evs[-1].start_frame >= 128  # the burst, not warmup noise
    on_t, _ = det.thresholds()
    assert on_t < 25


def test_serve_events_config_validated_at_construction():
    """Review regression: a bad --events threshold combination must
    refuse to START the daemon, not error every process request after
    the engine state already advanced."""
    from dips.serve import DiPsServer
    from dips.properties import DiPsFilter as _F
    from dips import DiPsProperties as _P
    props = _P(window_size=1, temporal_size=2, filter=_F.UNFILTERED)
    with pytest.raises(ValueError, match="hysteresis"):
        DiPsServer(props, 16, 24, port=0,
                   events=dict(on_threshold=0.01, off_threshold=0.02))


def test_cli_events_json_dat_dir(tmp_path):
    """Review regression: --events-json in the --dat-dir path referenced
    an undefined job variable (NameError after all processing)."""
    import numpy as np
    from dips.cli import main as cli_main

    h, w = 8, 12
    rng = np.random.default_rng(0)
    for i in range(5):
        rgba = rng.integers(0, 256, (h, w, 4), np.uint8)
        np.concatenate([np.zeros(4, np.uint8), rgba.ravel()]).tofile(
            tmp_path / f"Dat_{i}.d")
    out = str(tmp_path / "out.avi")
    ev_json = str(tmp_path / "events.json")
    rc = cli_main(["--dat-dir", str(tmp_path), "--output", out,
                   "--dat-geometry", f"{w}x{h}", "--temporal", "1",
                   "--events-json", ev_json])
    assert rc == 0
    assert json.load(open(ev_json)) is not None  # file written, no crash


def test_cli_events_json_multi_input(tmp_path):
    """--inputs mode: per-stream segmentation, JSON keyed by input path —
    a moving clip gets events, its static sibling gets none."""
    import cv2
    from dips.cli import main as cli_main

    h, w = 16, 24
    moving = (list(make_clip(n=4, h=h, w=w, seed=3, moving=False))
              + list(make_clip(n=6, h=h, w=w, seed=3, moving=True))
              + list(make_clip(n=4, h=h, w=w, seed=3, moving=False)))
    static = list(make_clip(n=14, h=h, w=w, seed=3, moving=False))
    paths = []
    for name, frames in (("moving.avi", moving), ("static.avi", static)):
        p = str(tmp_path / name)
        # lossless codec: the static sibling must decode bit-identical
        # (MJPG noise on a noise background flips ~all pixels by a few
        # LSB, which is exactly what the auto threshold exists for)
        vw = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"HFYU"), 10, (w, h))
        for f in frames:
            vw.write(f[..., ::-1])
        vw.release()
        paths.append(p)

    out_dir = str(tmp_path / "out")
    ev_json = str(tmp_path / "events.json")
    rc = cli_main(["--inputs", *paths, "--output-dir", out_dir,
                   "--output-mode", "absdiff", "--temporal", "1",
                   "--win_size", "1", "--batch", "4",
                   "--events-json", ev_json, "--event-on", "0.02",
                   "--event-min-frames", "2"])
    assert rc == 0
    per_stream = json.load(open(ev_json))
    assert set(per_stream) == set(paths)
    assert len(per_stream[paths[0]]) >= 1          # the moving clip
    spans = [(e["start_frame"], e["end_frame"])
             for e in per_stream[paths[0]]]
    assert any(s <= 5 and e >= 8 for s, e in spans), spans
    assert per_stream[paths[1]] == []              # the static sibling


def test_fuzz_streaming_equals_oneshot_and_invariants():
    """Property fuzz: random series under RANDOM batch splits must match
    the one-shot segmentation exactly, and every event must satisfy the
    definitional invariants (opens at >= on, ends at >= off, peak/mean
    computed over [start..end], spans disjoint and ordered)."""
    rng = np.random.default_rng(7)
    for trial in range(200):
        n = int(rng.integers(1, 120))
        scale = float(rng.choice([1.0, 10.0, 100.0]))
        series = rng.random(n) * scale
        if rng.random() < 0.5:  # structured: idle floor + square bursts
            series = rng.random(n) * 0.2 * scale
            for _ in range(int(rng.integers(0, 4))):
                a = int(rng.integers(0, n))
                b = min(n, a + int(rng.integers(1, 12)))
                series[a:b] += scale
        on = float(rng.uniform(0.3, 0.9)) * scale
        off = float(rng.uniform(0.1, 1.0)) * on
        cfg = dict(on_threshold=on, off_threshold=off,
                   min_frames=int(rng.integers(1, 4)),
                   cooldown=int(rng.integers(0, 3)))

        whole = detect_events([_stats(series)], **cfg)

        det = MotionDetector(**cfg)
        streamed = []
        i = 0
        while i < n:
            k = int(rng.integers(1, 8))
            streamed += det.update(_stats(series[i:i + k]))
            i += k
        streamed += det.flush()

        assert ([e.to_dict() for e in streamed]
                == [e.to_dict() for e in whole]), (trial, cfg)

        prev_end = -1
        for e in whole:
            assert e.start_frame > prev_end          # disjoint, ordered
            prev_end = e.end_frame
            assert e.frames >= cfg["min_frames"]
            assert series[e.start_frame] >= on       # opens at on
            assert series[e.end_frame] >= off        # ends at last >= off
            span = series[e.start_frame:e.end_frame + 1]
            assert e.peak == pytest.approx(span.max())
            assert e.peak_frame >= e.start_frame
            assert series[e.peak_frame] == pytest.approx(e.peak)
            assert e.mean == pytest.approx(span.mean())


def test_cli_events_json_duplicate_inputs_keep_both_streams(tmp_path):
    """Review regression: duplicate --inputs paths collapsed to one JSON
    key, silently dropping a stream's events."""
    import cv2
    from dips.cli import main as cli_main

    h, w = 16, 24
    clip = (list(make_clip(n=4, h=h, w=w, seed=3, moving=False))
            + list(make_clip(n=6, h=h, w=w, seed=3, moving=True)))
    p = str(tmp_path / "cam.avi")
    vw = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"HFYU"), 10, (w, h))
    for f in clip:
        vw.write(f[..., ::-1])
    vw.release()

    ev_json = str(tmp_path / "events.json")
    rc = cli_main(["--inputs", p, p, "--output-dir",
                   str(tmp_path / "out"), "--output-mode", "absdiff",
                   "--temporal", "1", "--win_size", "1", "--batch", "4",
                   "--events-json", ev_json, "--event-on", "0.02",
                   "--event-min-frames", "2"])
    assert rc == 0
    per_stream = json.load(open(ev_json))
    assert set(per_stream) == {f"{p}#0", f"{p}#1"}
    assert all(len(v) == 1 for v in per_stream.values())


def test_cli_multi_input_stats_json(tmp_path):
    """--inputs mode honors --stats-json: per-stream stat rows keyed by
    input path (it used to be silently ignored in this mode)."""
    import cv2
    from dips.cli import main as cli_main
    from dips.ops.oracle import STAT_NAMES

    h, w = 16, 24
    paths = []
    for k, n in (("a", 5), ("b", 3)):  # different lengths
        p = str(tmp_path / f"{k}.avi")
        vw = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"HFYU"), 10,
                             (w, h))
        for f in make_clip(n=n, h=h, w=w, seed=7):
            vw.write(f[..., ::-1])
        vw.release()
        paths.append(p)

    sp = str(tmp_path / "stats.json")
    rc = cli_main(["--inputs", *paths, "--output-dir",
                   str(tmp_path / "out"), "--temporal", "1",
                   "--win_size", "1", "--batch", "2",
                   "--stats-json", sp])
    assert rc == 0
    per = json.load(open(sp))
    assert set(per) == set(paths)
    assert len(per[paths[0]]) == 5 and len(per[paths[1]]) == 3
    assert set(per[paths[0]][0]) == set(STAT_NAMES)
