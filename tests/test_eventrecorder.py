"""Event-triggered recording (io/eventrecorder.py) and its CLI surface."""

import json
import os

import numpy as np
import pytest

from dips.io.eventrecorder import EventRecorder
from dips.ops.events import MotionDetector
from dips.ops.oracle import NUM_STATS

from tests.conftest import make_clip


class FakeWriter:
    def __init__(self, idx, start):
        self.idx, self.start = idx, start
        self.frames = []
        self.closed = False
        self.path = f"seg{idx}"

    def write(self, f):
        assert not self.closed
        self.frames.append(int(f))

    def close(self):
        self.closed = True


def _run(series, on=10, pre=2, post=2, **det_kw):
    writers = []

    def open_writer(i, start):
        w = FakeWriter(i, start)
        writers.append(w)
        return w

    rec = EventRecorder(MotionDetector(on_threshold=on, **det_kw),
                        open_writer, pre_roll=pre, post_roll=post)
    for i, v in enumerate(series):
        row = np.zeros(NUM_STATS, np.float32)
        row[1] = v
        rec.feed(np.int64(i), row, i)  # "frame" = its own index
    segs = rec.finish()
    return writers, segs


def test_pre_roll_flush_and_post_roll_close():
    # idle 0..4, motion 5..7, idle 8..
    series = [0] * 5 + [20, 20, 20] + [0] * 6
    writers, segs = _run(series, pre=2, post=2)
    assert len(writers) == 1 and writers[0].closed
    # pre-roll frames 3,4 + motion 5..7 + close frame 8 + post 9,10
    assert writers[0].frames == [3, 4, 5, 6, 7, 8, 9, 10]
    assert segs[0]["start_frame"] == 3 and segs[0]["end_frame"] == 10
    assert segs[0]["frames"] == 8
    assert len(segs[0]["events"]) == 1
    assert segs[0]["events"][0]["start_frame"] == 5
    assert segs[0]["path"] == "seg0"


def test_burst_during_post_roll_merges():
    series = [0] * 3 + [20] + [0, 0] + [20] + [0] * 8
    writers, segs = _run(series, pre=1, post=3)
    assert len(writers) == 1  # ONE merged segment, not two clips
    assert len(segs) == 1 and len(segs[0]["events"]) == 2


def test_separate_events_get_separate_segments():
    series = [0] * 3 + [20] + [0] * 8 + [20] + [0] * 8
    writers, segs = _run(series, pre=1, post=2)
    assert len(writers) == 2
    assert all(w.closed for w in writers)
    assert [s["path"] for s in segs] == ["seg0", "seg1"]


def test_eos_closes_open_segment_and_flushes_event():
    series = [0] * 3 + [20, 20]  # still open at EOS
    writers, segs = _run(series, pre=1, post=5)
    assert len(segs) == 1 and writers[0].closed
    assert segs[0]["events"][0]["end_frame"] == 4  # flushed at EOS


def test_zero_pre_roll_and_first_frame_event():
    series = [20, 20] + [0] * 5
    writers, segs = _run(series, pre=0, post=1)
    assert writers[0].frames[0] == 0  # opens at the triggering frame
    assert segs[0]["start_frame"] == 0


def test_idle_run_records_nothing():
    writers, segs = _run([0] * 20)
    assert writers == [] and segs == []


def test_cli_record_events_writes_segments(tmp_path):
    import cv2
    from dips.cli import main as cli_main

    h, w = 16, 24
    frames = (list(make_clip(n=6, h=h, w=w, seed=3, moving=False))
              + list(make_clip(n=6, h=h, w=w, seed=3, moving=True))
              + list(make_clip(n=8, h=h, w=w, seed=3, moving=False)))
    path = str(tmp_path / "in.avi")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"HFYU"), 10, (w, h))
    for f in frames:
        vw.write(f[..., ::-1])
    vw.release()

    rdir = str(tmp_path / "rec")
    rc = cli_main(["--input", path, "--output", str(tmp_path / "o.avi"),
                   "--output-mode", "absdiff", "--temporal", "1",
                   "--win_size", "1", "--record-events", rdir,
                   "--event-on", "0.02", "--event-min-frames", "2",
                   "--pre-roll", "2", "--post-roll", "2"])
    assert rc == 0
    segs = json.load(open(os.path.join(rdir, "segments.json")))
    assert len(segs) == 1
    s = segs[0]
    assert s["start_frame"] == 4  # motion at 6, pre-roll 2
    assert s["path"] and os.path.exists(s["path"])
    cap = cv2.VideoCapture(s["path"])
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    assert n == s["frames"] and n >= 8  # pre + motion + close + post


def test_cli_record_events_rejected_outside_file_mode(tmp_path, capsys):
    from dips.cli import main as cli_main
    rc = cli_main(["--inputs", "a.avi", "b.avi",
                   "--output-dir", str(tmp_path),
                   "--record-events", str(tmp_path / "r")])
    assert rc == 2
    assert "--record-events" in capsys.readouterr().err


def test_mid_run_error_still_closes_open_segment(tmp_path):
    """Review regression: a decode error (or Ctrl-C) while a segment is
    open must close its writer — an unfinalized clip is unplayable."""
    import dataclasses
    from dips.app import DiPsJob, perform_dips, stream_dips
    import dips.app as app_mod

    import cv2
    h, w = 16, 24
    frames = (list(make_clip(n=3, h=h, w=w, seed=3, moving=False))
              + list(make_clip(n=6, h=h, w=w, seed=3, moving=True)))
    path = str(tmp_path / "in.avi")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"HFYU"), 10, (w, h))
    for f in frames:
        vw.write(f[..., ::-1])
    vw.release()

    from dips.properties import DiPsFilter, DiPsProperties, OutputMode
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED,
                           output=OutputMode.ABSDIFF)
    job = DiPsJob(properties=props, video_path=path,
                  output_path=str(tmp_path / "o.avi"), batch=3,
                  record_events=dict(
                      dir=str(tmp_path / "rec"), pre_roll=1, post_roll=50,
                      detector=dict(on_threshold=0.02,
                                    metric="changed_frac")))

    real_stream = app_mod.stream_dips
    def exploding_stream(j):
        for item in real_stream(j):
            yield item
            if item[0] >= 6:  # die while the segment is OPEN
                raise RuntimeError("synthetic decode failure")
    import unittest.mock as mock
    with mock.patch.object(app_mod, "stream_dips", exploding_stream):
        with pytest.raises(RuntimeError, match="synthetic"):
            perform_dips(job)
    assert job.event_segments is not None and len(job.event_segments) == 1
    seg = job.event_segments[0]
    cap = cv2.VideoCapture(seg["path"])
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    assert n == seg["frames"] >= 3  # closed + decodable despite the error


def test_bad_record_config_errors_cleanly_and_leaks_nothing(tmp_path,
                                                            capsys):
    """Review regression: a bad detector combination raised AFTER the
    reader/writer opened (leak) and surfaced as a raw traceback."""
    import cv2
    from dips.cli import main as cli_main
    h, w = 16, 24
    path = str(tmp_path / "in.avi")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, (w, h))
    for f in make_clip(n=3, h=h, w=w):
        vw.write(f[..., ::-1])
    vw.release()
    rc = cli_main(["--input", path, "--output", str(tmp_path / "o.avi"),
                   "--record-events", str(tmp_path / "rec"),
                   "--event-on", "0.01", "--event-off", "0.02"])
    assert rc == 1
    assert "hysteresis" in capsys.readouterr().err


def test_edge_recording_from_serve_annotations(tmp_path):
    """The NVR edge shape: a camera client streams frame-at-a-time to an
    --events daemon and records its ORIGINAL frames locally, driven purely
    by the reply annotations (event_open / last_events) — no second
    analysis pass over the pixels."""
    import threading
    from dips import DiPsProperties
    from dips.properties import DiPsFilter, OutputMode
    from dips.serve import DiPsClient, DiPsServer

    h, w = 16, 24
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED,
                           output=OutputMode.ABSDIFF)
    srv = DiPsServer(props, h, w, port=0, batch=1, max_sessions=2,
                     events=dict(on_threshold=0.02, metric="changed_frac",
                                 min_frames=2))
    threading.Thread(target=srv.serve_forever, daemon=True).start()

    frames = (list(make_clip(n=5, h=h, w=w, seed=3, moving=False))
              + list(make_clip(n=6, h=h, w=w, seed=3, moving=True))
              + list(make_clip(n=6, h=h, w=w, seed=3, moving=False)))
    writers = []

    def open_writer(i, start):
        wr = FakeWriter(i, start)
        writers.append(wr)
        return wr

    try:
        c = DiPsClient(srv.port, session="edge-cam")
        rec = EventRecorder(None, open_writer, pre_roll=2, post_roll=2)
        for i, f in enumerate(frames):
            c.process(f)
            rec.feed_annotated(np.int64(i), c.event_open,
                               c.last_events, i)
        segs = rec.finish()
        c.close()
    finally:
        srv.shutdown()
    assert len(segs) == 1
    s = segs[0]
    assert s["start_frame"] == 3          # pre-roll 2 before motion at 5
    assert writers[0].frames[0] == 3 and writers[0].closed
    assert len(s["events"]) == 1 and s["events"][0]["start_frame"] == 5


def test_edge_finish_final_events_and_feed_guard():
    """Review regressions: (a) edge shape can attribute a clip whose
    event was still open at EOS via finish(final_events=...); (b) feed()
    on a detector-less recorder names the right entry point."""
    writers = []

    def open_writer(i, start):
        w = FakeWriter(i, start)
        writers.append(w)
        return w

    rec = EventRecorder(None, open_writer, pre_roll=1, post_roll=5)
    rec.feed_annotated(np.int64(0), False, [], 0)
    rec.feed_annotated(np.int64(1), True, [], 1)   # opens mid-motion
    flushed = [{"start_frame": 1, "end_frame": 1, "frames": 1,
                "peak": 9.0, "peak_frame": 1, "mean": 9.0}]
    segs = rec.finish(final_events=flushed)        # source flushed at EOS
    assert len(segs) == 1 and segs[0]["events"] == flushed
    assert writers[0].closed

    rec2 = EventRecorder(None, open_writer)
    with pytest.raises(ValueError, match="feed_annotated"):
        rec2.feed(np.int64(0), np.zeros(NUM_STATS, np.float32), 0)


def test_edge_event_closed_within_one_batch_still_records():
    """Edge shape: an event that opens AND closes inside one batched
    request arrives as open_now=False + non-empty ``closed`` for every
    frame of the batch.  The recorder must open retroactively from the
    pre-roll ring — previously both the clip and the manifest entry were
    silently dropped."""
    writers = []

    def open_writer(i, start):
        w = FakeWriter(i, start)
        writers.append(w)
        return w

    rec = EventRecorder(None, open_writer, pre_roll=4, post_roll=1)
    ev = {"start_frame": 5, "end_frame": 6, "frames": 2,
          "peak": 9.0, "peak_frame": 5, "mean": 9.0}
    for i in range(4):                      # idle batch
        rec.feed_annotated(np.int64(i), False, [], i)
    # batch 4..7: event opened at 5 and closed at 6 inside the batch;
    # the daemon reply says open=False and lists the closed event once
    rec.feed_annotated(np.int64(4), False, [ev], 4)
    for i in (5, 6, 7):
        rec.feed_annotated(np.int64(i), False, [], i)
    segs = rec.finish()
    assert len(segs) == 1 and segs[0]["events"] == [ev]
    assert writers[0].closed
    # pre-roll 0..3 + trigger frame 4 + post-roll frames
    assert writers[0].frames[:5] == [0, 1, 2, 3, 4]
    assert segs[0]["start_frame"] == 0
    assert segs[0]["frames"] == len(writers[0].frames)


def test_eos_flushed_events_with_no_open_segment_record_the_ring():
    """finish(final_events=...) with no writer open (burst entirely in
    the final batch) must still produce a clip from the pre-roll ring."""
    writers = []

    def open_writer(i, start):
        w = FakeWriter(i, start)
        writers.append(w)
        return w

    rec = EventRecorder(None, open_writer, pre_roll=3, post_roll=2)
    for i in range(6):
        rec.feed_annotated(np.int64(i), False, [], i)
    ev = {"start_frame": 4, "end_frame": 5, "frames": 2,
          "peak": 9.0, "peak_frame": 4, "mean": 9.0}
    segs = rec.finish(final_events=[ev])
    assert len(segs) == 1 and segs[0]["events"] == [ev]
    assert writers[0].closed
    assert writers[0].frames == [3, 4, 5]   # the ring, nothing else
    assert segs[0]["start_frame"] == 3 and segs[0]["end_frame"] == 5
    assert segs[0]["frames"] == 3
    # an idle EOS (no flushed events) still records nothing
    rec2 = EventRecorder(None, open_writer, pre_roll=3, post_roll=2)
    for i in range(4):
        rec2.feed_annotated(np.int64(i), False, [], i)
    assert rec2.finish() == []


def test_fuzz_recorder_invariants():
    """Property fuzz: across random series/configs, clips must be
    disjoint and ordered, every DETECTED event span must lie inside some
    clip (pre/post-roll included), each clip's frame count must match
    its span, and frames written == sum of clip lengths."""
    from dips.ops.events import detect_events

    def _stats(series):
        a = np.zeros((len(series), NUM_STATS), np.float32)
        a[:, 1] = series
        return a

    rng = np.random.default_rng(11)
    for trial in range(120):
        n = int(rng.integers(4, 120))
        series = rng.random(n) * 0.2
        for _ in range(int(rng.integers(0, 4))):
            a = int(rng.integers(0, n))
            series[a:min(n, a + int(rng.integers(1, 10)))] += 1.0
        cfg = dict(on_threshold=0.5, min_frames=int(rng.integers(1, 3)),
                   cooldown=int(rng.integers(0, 3)))
        pre, post = int(rng.integers(0, 5)), int(rng.integers(0, 5))

        writers, segs = _run(series, on=cfg["on_threshold"], pre=pre,
                             post=post,
                             **{k: v for k, v in cfg.items()
                                if k != "on_threshold"})
        # recompute what the detector alone would say
        expected = detect_events([_stats(series)], **cfg)

        prev_end = -1
        for s, w in zip(segs, writers):
            assert s["start_frame"] > prev_end, trial   # disjoint, ordered
            prev_end = s["end_frame"]
            assert s["frames"] == len(w.frames)
            assert w.frames == list(range(s["start_frame"],
                                          s["end_frame"] + 1)), trial
            assert w.closed
        for e in expected:
            covering = [s for s in segs
                        if s["start_frame"] <= e.start_frame
                        and s["end_frame"] >= min(e.end_frame, n - 1)]
            assert covering, (trial, e, segs)  # every event is on disk
        assert len(writers) == len(segs)
