"""I/O, application API and CLI surface tests (real video files throughout)."""

import json
import os

import cv2
import numpy as np
import pytest

from dips import (DiPsJob, DiPsProperties, Encoding, VideoPathError,
                  perform_dips, run_dips_on_file)
from dips.app import custom_dips_on_files, stream_dips
from dips.cli import main as cli_main
from dips.io import (VideoReader, VideoWriter, extract_thumbnail,
                     moving_square_clip, subsample_video, write_clip)
from dips.io.datfiles import HEADER_BYTES, list_dat_files, read_dat_frame
from dips.properties import DiPsFilter


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    d = tmp_path_factory.mktemp("vids")
    frames = moving_square_clip(n=14, height=48, width=64, seed=1)
    path = str(d / "in.avi")
    write_clip(frames, path, fps=20)
    return path, frames


def test_reader_roundtrip(video):
    path, frames = video
    with VideoReader(path) as r:
        assert (r.width, r.height) == (64, 48)
        assert abs(r.fps - 20) < 0.5
        decoded = list(r)
    assert len(decoded) == len(frames)
    # MJPG is lossy (and noise compresses badly); check gross similarity
    assert np.mean(np.abs(decoded[0].astype(int) - frames[0].astype(int))) < 40


def test_reader_missing_file():
    with pytest.raises(VideoPathError):
        VideoReader("/nonexistent/nope.avi")


def test_writer_fallback(tmp_path):
    # H264 encode is unavailable in this image -> falls back, loudly
    with pytest.warns(RuntimeWarning, match="falling back"):
        w = VideoWriter(str(tmp_path / "o.avi"), 10, 64, 48, Encoding.H264)
    assert w.fallback_used == "MJPG"
    w.write(np.zeros((48, 64, 3), np.uint8))
    w.close()
    assert os.path.getsize(tmp_path / "o.avi") > 0


def test_perform_dips_end_to_end(video, tmp_path):
    path, frames = video
    out = str(tmp_path / "out.avi")
    job = (DiPsJob(properties=DiPsProperties(window_size=3, temporal_size=2))
           .with_video_path(path).with_output_path(out)
           .with_encoding("MJPG"))
    stats = perform_dips(job)
    assert stats.shape == (len(frames), 4)
    with VideoReader(out) as r:
        assert len(list(r)) == len(frames)


def test_frame_callback_hook(video, tmp_path):
    path, frames = video
    seen = []

    def cb(idx, inp, out, stats):
        seen.append(idx)
        if idx == 0:
            return np.full_like(out, 7)  # override frame 0
        return None

    job = (DiPsJob().with_video_path(path)
           .with_output_path(str(tmp_path / "o.avi"))
           .with_frame_callback(cb))
    outs = [o for _, _, o, _ in stream_dips(job)]
    assert seen == list(range(len(frames)))
    assert np.all(outs[0] == 7)


def test_yield_inputs_lazy_by_default(video):
    """The input element is None unless requested (a callback requests it
    implicitly) — the HWC rebuild is skipped on the hot encode path."""
    path, frames = video
    job = DiPsJob().with_video_path(path)
    assert all(inp is None for _, inp, _, _ in stream_dips(job))

    import dataclasses
    job_want = dataclasses.replace(job, yield_inputs=True)
    inps = [inp for _, inp, _, _ in stream_dips(job_want)]
    assert all(isinstance(i, np.ndarray) for i in inps)
    with VideoReader(path) as r:  # inputs = the decoded frames, exactly
        np.testing.assert_array_equal(np.stack(inps), np.stack(list(r)))

    def cb(idx, inp, out, stats):  # callback implies inputs
        assert isinstance(inp, np.ndarray)
        return None

    list(stream_dips(job.with_frame_callback(cb)))


def test_run_dips_on_file_with_markers(video, tmp_path):
    path, frames = video
    out = str(tmp_path / "o.avi")
    stats = run_dips_on_file(path, out, "MJPG",
                             DiPsProperties(temporal_size=1, window_size=1,
                                            filter=DiPsFilter.UNFILTERED),
                             refresh_markers=(5,))
    assert stats[5, 1] == 0  # marker frame re-captures -> zero diff


def test_thumbnail(video, tmp_path):
    path, _ = video
    out = str(tmp_path / "t.png")
    thumb = extract_thumbnail(path, out, height=24)
    assert thumb.shape == (24, 32, 3)
    assert os.path.exists(out)


def test_subsample(video, tmp_path):
    path, frames = video
    out = str(tmp_path / "s.avi")
    n = subsample_video(path, out, keep_every=3, target_seconds=2.0)
    assert n == len(frames) // 3 + (1 if len(frames) % 3 else 0)


def test_dat_files(tmp_path):
    w, h = 6, 4
    names = ["Dat_2.d", "Dat_10.d", "Dat_1.d", "skip.txt"]
    rng = np.random.default_rng(0)
    payloads = {}
    for n in names:
        if n.startswith("D"):
            rgba = rng.integers(0, 256, (h, w, 4), np.uint8)
            payloads[n] = rgba
            raw = np.concatenate(
                [np.zeros(HEADER_BYTES, np.uint8), rgba.ravel()])
            raw.tofile(tmp_path / n)
        else:
            (tmp_path / n).write_text("not a dat")
    ordered = [os.path.basename(p) for p in list_dat_files(str(tmp_path))]
    assert ordered == ["Dat_1.d", "Dat_2.d", "Dat_10.d"]  # numeric sort
    f = read_dat_frame(str(tmp_path / "Dat_1.d"), w, h)
    np.testing.assert_array_equal(f, payloads["Dat_1.d"][..., :3])


def test_custom_dips_on_files(tmp_path):
    w, h = 16, 8
    rng = np.random.default_rng(0)
    for i in range(5):
        rgba = rng.integers(0, 256, (h, w, 4), np.uint8)
        np.concatenate([np.zeros(4, np.uint8), rgba.ravel()]).tofile(
            tmp_path / f"Dat_{i}.d")
    out = str(tmp_path / "out.avi")
    stats = custom_dips_on_files(str(tmp_path), out, width=w, height=h,
                                 properties=DiPsProperties(temporal_size=1))
    assert stats.shape == (5, 4)
    assert os.path.getsize(out) > 0


def test_cli_run(video, tmp_path, capsys):
    path, frames = video
    out = str(tmp_path / "cli_out.avi")
    stats_json = str(tmp_path / "stats.json")
    rc = cli_main([
        "5", "--input", path, "--output", out, "--encoding=MJPG",
        "--filter=inv_sig", "--sig_scalar=3", "--chroma=g", "--win_size=5",
        "--colorize=false", "--temporal=2", "--batch=4",
        "--stats-json", stats_json,
    ])
    assert rc == 0
    assert f"processed {len(frames)} frames" in capsys.readouterr().out
    rows = json.load(open(stats_json))
    assert len(rows) == len(frames)
    assert set(rows[0]) == {"mean_diff", "mean_abs_diff", "max_abs_diff",
                            "changed_count"}


def test_cli_thumbnail_and_errors(video, tmp_path, capsys):
    path, _ = video
    rc = cli_main(["--thumbnail", str(tmp_path / "t.jpg"), "--input", path])
    assert rc == 0
    rc = cli_main(["--input", path])  # missing --output
    assert rc == 2
    rc = cli_main(["--input", path, "--output", "o.avi", "--encoding=BOGUS"])
    assert rc == 2


def test_gstreamer_backend_gated(video):
    """GStreamer is absent in this image: the backend must report so and
    fail with a typed error, while open_video falls back to OpenCV."""
    from dips.io import gstreamer
    from dips.errors import DecodeError
    path, _ = video
    if gstreamer.available():  # pragma: no cover - not in this image
        with gstreamer.GstVideoReader(path) as r:
            assert r.read() is not None
    else:
        with pytest.raises(DecodeError):
            gstreamer.GstVideoReader(path)
    r = gstreamer.open_video(path, backend="auto")
    assert r.read() is not None
    r.close()
    with pytest.raises(ValueError):
        gstreamer.open_video(path, backend="bogus")


def test_cli_live_headless_is_clean(capsys):
    """--live without camera/display fails with rc 1 and a message, not a
    traceback (GPU servers are headless)."""
    rc = cli_main(["--live"])
    assert rc == 1
    err = capsys.readouterr().err
    assert "camera" in err or "display" in err


def test_reference_name_aliases():
    """API-surface parity: reference builder/entry names resolve."""
    import dips
    from dips.properties import OutputMode
    dips.init_frame_extractor()       # no-op parity hooks
    dips.init_thumbnail_extractor()
    assert callable(dips.run_dips_app)
    assert callable(dips.run_dips_on_files)
    p = (DiPsProperties()
         .with_spatial_window_size(5)
         .with_filter_type("unfiltered")
         .with_chroma_filter("red")
         .with_colorize(False))
    assert p.window_size == 5
    assert p.output == OutputMode.GRAYSCALE
    assert p.chroma.name == "RED"


def test_parallel_decode_workers_match_single(video, tmp_path):
    """Chunked parallel decode must yield the identical frame sequence:
    bit-equal diff maps and stats vs the single-worker path."""
    path, frames = video
    props = DiPsProperties(window_size=1, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED)

    def run(nw):
        job = DiPsJob(properties=props, video_path=path, batch=4,
                      decode_workers=nw, video_backend="opencv")
        return list(stream_dips(job))

    ref = run(1)
    for nw in (2, 3, 5):
        got = run(nw)
        assert len(got) == len(ref) == 14
        for (i1, inp1, out1, st1), (i2, inp2, out2, st2) in zip(ref, got):
            assert i1 == i2
            np.testing.assert_array_equal(inp1, inp2)
            np.testing.assert_array_equal(out1, out2)
            np.testing.assert_array_equal(st1, st2)


def test_parallel_decode_cli_and_profile(video, tmp_path, capsys):
    path, _ = video
    out = str(tmp_path / "o.avi")
    rc = cli_main(["--input", path, "--output", out, "--decode-workers", "3",
                   "--temporal=2", "--profile"])
    assert rc == 0
    printed = capsys.readouterr().out
    assert "decode" in printed and "device" in printed  # stage shares shown
    with VideoReader(out) as r:
        assert len(list(r)) == 14


def test_dat_preview_headless_skips(tmp_path, caplog):
    """--live with --dat-dir requests the imshow progress preview (ref
    dips_alt/src/lib.rs:679-682); on a headless host it degrades to a
    warning, not a crash."""
    import logging
    w, h = 16, 8
    rng = np.random.default_rng(0)
    for i in range(3):
        rgba = rng.integers(0, 256, (h, w, 4), np.uint8)
        np.concatenate([np.zeros(4, np.uint8), rgba.ravel()]).tofile(
            tmp_path / f"Dat_{i}.d")
    out = str(tmp_path / "out.avi")
    with caplog.at_level(logging.WARNING, logger="dips"):
        stats = custom_dips_on_files(
            str(tmp_path), out, width=w, height=h,
            properties=DiPsProperties(temporal_size=1), show=True)
    assert stats.shape == (3, 4)
    if not os.environ.get("DISPLAY"):
        assert any("no display" in r.message for r in caplog.records)


def test_pipeline_depth_2_matches_depth_1(video):
    """Opt-in double-buffering must be result-identical to sequential."""
    path, frames = video
    props = DiPsProperties(window_size=1, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED)

    def run(depth):
        job = DiPsJob(properties=props, video_path=path, batch=4,
                      pipeline_depth=depth, video_backend="opencv")
        return list(stream_dips(job))

    r1, r2 = run(1), run(2)
    assert len(r1) == len(r2) == len(frames)
    for (i1, inp1, o1, s1), (i2, inp2, o2, s2) in zip(r1, r2):
        assert i1 == i2
        np.testing.assert_array_equal(inp1, inp2)
        np.testing.assert_array_equal(o1, o2)
        np.testing.assert_array_equal(s1, s2)


def test_streaming_soak_with_all_features(tmp_path):
    """Mini-soak: several hundred frames through the full streaming stack
    (pipelining, chunked decode, refresh markers) — counts, marker zeros
    and monotone indices all hold."""
    from dips.io import moving_square_clip, write_clip
    p = str(tmp_path / "soak.avi")
    write_clip(moving_square_clip(n=300, height=32, width=48, seed=0), p,
               fps=30)
    job = DiPsJob(properties=DiPsProperties(window_size=3, temporal_size=4,
                                            refresh_markers=(100, 200)),
                  video_path=p, batch=8, decode_workers=3,
                  pipeline_depth=2, video_backend="opencv")
    idxs, marker_counts = [], {}
    for idx, _inp, out, stats in stream_dips(job):
        idxs.append(idx)
        if idx in (100, 200):
            marker_counts[idx] = float(stats[3])
    assert idxs == list(range(300))
    # refresh-marker frames re-capture: zero changed pixels
    assert marker_counts == {100: 0.0, 200: 0.0}


def test_cli_packed_wire(video, tmp_path, capsys):
    """--packed-wire plumbs through the CLI to the engine; output video is
    identical to the plain run (wire format is transparent)."""
    path, frames = video
    outs = []
    for flag in ([], ["--packed-wire"]):
        out = str(tmp_path / f"pw_{bool(flag)}.avi")
        rc = cli_main(["--input", path, "--output", out,
                       "--output-mode=threshold", "--temporal=2",
                       "--batch=4"] + flag)
        assert rc == 0
        with VideoReader(out) as r:
            outs.append(np.stack(list(r)))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_stream_dips_hwc_layout_matches_planar(video):
    """input_layout='hwc' (raw decode bytes, device-side layout transform
    + BGR swap) yields bit-identical outputs, stats AND input views."""
    import dataclasses
    path, _ = video
    job = DiPsJob(properties=DiPsProperties(window_size=3, temporal_size=2),
                  video_path=path, batch=4, yield_inputs=True)
    ref = [(o.copy(), s.copy(), i.copy())
           for _, i, o, s in stream_dips(job)]
    job_h = dataclasses.replace(job, input_layout="hwc", decode_workers=2)
    got = [(o.copy(), s.copy(), i.copy())
           for _, i, o, s in stream_dips(job_h)]
    assert len(got) == len(ref)
    for (o1, s1, i1), (o2, s2, i2) in zip(ref, got):
        np.testing.assert_array_equal(o2, o1)
        np.testing.assert_allclose(s2, s1, atol=1e-6)
        np.testing.assert_array_equal(i2, i1)


def test_cli_input_layout_flag(video, tmp_path):
    path, frames = video
    from dips.cli import main as cli_main
    out = str(tmp_path / "o.avi")
    rc = cli_main(["--input", path, "--output", out, "--temporal=2",
                   "--filter=none", "--input-layout", "hwc"])
    assert rc == 0
    with VideoReader(out) as r:
        assert len(list(r)) == len(frames)


# ---------------------------------------------------------------------------
# self-review round 2: app-layer lifecycle hardening
# ---------------------------------------------------------------------------

def test_run_dips_on_files_disambiguates_duplicate_basenames(tmp_path):
    """camA/clip.avi + camB/clip.avi must not overwrite one output."""
    import os

    from dips.app import run_dips_on_files
    from dips.io import moving_square_clip, write_clip

    paths = []
    for d in ("camA", "camB"):
        os.makedirs(tmp_path / d)
        p = str(tmp_path / d / "clip.avi")
        write_clip(moving_square_clip(n=4, height=16, width=24), p, fps=20)
        paths.append(p)
    out = str(tmp_path / "out")
    counts = run_dips_on_files(
        paths, out,
        properties=DiPsProperties(window_size=1, temporal_size=1),
        batch=2)
    assert list(counts) == [4, 4]
    names = sorted(os.listdir(out))
    assert names == ["clip.0.dips.avi", "clip.1.dips.avi"]


def test_run_dips_on_files_closes_readers_on_setup_error(tmp_path, monkeypatch):
    """A bad second input must close the already-opened first reader."""
    from dips import app as app_mod
    from dips.app import run_dips_on_files
    from dips.errors import VideoPathError
    from dips.io import moving_square_clip, write_clip
    from dips.io import gstreamer as gst_mod

    good = str(tmp_path / "good.avi")
    write_clip(moving_square_clip(n=2, height=16, width=24), good, fps=20)

    closed = []
    real_open = gst_mod.open_video

    def tracking_open(path, backend="auto"):
        r = real_open(path, backend)
        orig_close = r.close
        r.close = lambda: (closed.append(path), orig_close())
        return r

    monkeypatch.setattr(gst_mod, "open_video", tracking_open)
    with pytest.raises(VideoPathError):
        run_dips_on_files([good, str(tmp_path / "missing.avi")],
                          str(tmp_path / "out"))
    assert closed == [good]

    # hwc_bgr is an engine-level layout for raw decoder bytes; the reader
    # frames here are RGB, so it must be rejected, not silently swapped
    with pytest.raises(ValueError, match="input_layout"):
        run_dips_on_files([good], str(tmp_path / "out2"),
                          input_layout="hwc_bgr")


class _TrickleReader:
    """Fake pre-opened reader: first frame immediately, second after a
    pause longer than the test's stall timeout."""

    fps, width, height = 10.0, 16, 16
    frame_count, native_rgb, last_pts = -1, False, None

    def __init__(self, pause_s):
        self.pause_s = pause_s
        self.closed = False

    def iter_bgr_timed(self):
        import time
        yield np.zeros((16, 16, 3), np.uint8), 0.0
        time.sleep(self.pause_s)
        yield np.full((16, 16, 3), 60, np.uint8), 0.1

    def close(self):
        self.closed = True


def test_decode_stall_timeout_configurable():
    """decode_stall_s bounds the ring wait; None waits out sparse live
    sources instead of aborting (and job.reader supplies a pre-opened
    reader, which stream_dips owns and closes)."""
    from dips.app import DiPsJob, stream_dips
    from dips.errors import DecodeError

    props = DiPsProperties(window_size=1, temporal_size=1)
    # impatient: a 0.2s stall cap trips on the 1.5s pause
    rd = _TrickleReader(pause_s=1.5)
    job = DiPsJob(properties=props, video_path="fake://", reader=rd,
                  batch=1, decode_stall_s=0.2)
    it = stream_dips(job)
    next(it)  # first frame arrives
    with pytest.raises(DecodeError, match="stalled"):
        for _ in it:
            pass
    assert rd.closed

    # patient: None waits through the same pause and gets both frames
    rd2 = _TrickleReader(pause_s=1.5)
    job2 = DiPsJob(properties=props, video_path="fake://", reader=rd2,
                   batch=1, decode_stall_s=None)
    got = [idx for idx, _i, _o, _s in stream_dips(job2)]
    assert got == [0, 1] and rd2.closed


def test_cli_subsample_zero_rejected(tmp_path, capsys):
    from dips.cli import main as cli_main

    rc = cli_main(["--input", "a.avi", "--output", "b.avi",
                   "--subsample", "0"])
    assert rc == 2
    assert "subsample" in capsys.readouterr().err


def test_cli_inputs_bad_encoding_friendly(tmp_path, capsys):
    from dips.cli import main as cli_main

    rc = cli_main(["--inputs", "a.avi", "b.avi",
                   "--output-dir", str(tmp_path), "--encoding", "vp9"])
    assert rc == 2
    assert "unknown --encoding" in capsys.readouterr().err


def test_cli_inputs_oversized_mesh_friendly(tmp_path, capsys):
    """A mesh wanting more devices than the host has must print an error,
    not a traceback."""
    from dips.cli import main as cli_main
    from dips.io import moving_square_clip, write_clip

    p = str(tmp_path / "a.avi")
    write_clip(moving_square_clip(n=2, height=16, width=24), p, fps=20)
    rc = cli_main(["--inputs", p, "--output-dir", str(tmp_path / "o"),
                   "--mesh", "8x8"])
    assert rc == 1
    assert "error:" in capsys.readouterr().err


def test_error_types_raise_where_documented(tmp_path, video):
    """Coverage audit: the exception types nothing asserted —
    OutputPathError (perform_dips without an output), FrameCallbackError
    (a raising callback, chained from the cause) — and the TypeError of
    the removed engine ``backend`` option."""
    from dips import (DiPsEngine, DiPsJob, DiPsProperties,
                      FrameCallbackError, OutputPathError,
                      perform_dips)

    path, _ = video
    with pytest.raises(OutputPathError, match="output path"):
        perform_dips(DiPsJob(video_path=path))

    def bad_callback(idx, inp, out, stats):
        raise KeyError("boom")

    job = DiPsJob(properties=DiPsProperties(temporal_size=1),
                  video_path=path,
                  output_path=str(tmp_path / "o.avi"),
                  frame_callback=bad_callback, batch=2)
    with pytest.raises(FrameCallbackError, match="boom") as ei:
        perform_dips(job)
    assert isinstance(ei.value.__cause__, KeyError)

    with pytest.raises(TypeError, match="backend"):
        DiPsEngine(DiPsProperties(), 16, 24, backend="cuda")


def test_perform_dips_reuses_caller_reader(tmp_path, monkeypatch):
    """A pre-opened DiPsJob.reader must be consumed, not re-opened — a
    single-session network source rejects a second overlapping connect
    (the CLI's --flicker-hz fps probe relies on this)."""
    from dips import io as io_pkg
    from dips.app import DiPsJob, perform_dips
    from dips.io import moving_square_clip, write_clip
    from dips.io.gstreamer import open_video
    import dips.io.gstreamer as gst_mod
    path = str(tmp_path / "in.avi")
    write_clip(moving_square_clip(n=6, height=24, width=32), path)
    rd = open_video(path, "opencv")
    opens = []
    real_open = gst_mod.open_video
    monkeypatch.setattr(gst_mod, "open_video",
                        lambda p, b="auto": opens.append(p) or
                        real_open(p, b))
    job = DiPsJob(video_path=path, output_path=str(tmp_path / "o.avi"),
                  batch=4, reader=rd)
    stats = perform_dips(job)
    assert stats.shape[0] == 6
    assert opens == [], f"re-opened the source: {opens}"
