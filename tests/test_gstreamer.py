"""GStreamer backend tests through a fake-Gst shim (the real stack is
often not installed): reader caps/fps/preroll probing, PTS exposure, the appsrc
egress writer with timestamp propagation, backend factories, and the full
app-layer plumbing of DiPsJob.video_backend."""

import types

import numpy as np
import pytest

from dips.errors import DecodeError
from dips.io import gstreamer
from dips.io.gstreamer import (GstVideoReader, GstVideoWriter, open_video,
                               open_writer)


# ---------------------------------------------------------------------------
# fake Gst
# ---------------------------------------------------------------------------

class FakeCapsStruct:
    def __init__(self, w, h, num=24, den=1):
        self.w, self.h, self.num, self.den = w, h, num, den

    def get_value(self, name):
        return {"width": self.w, "height": self.h}[name]

    def get_fraction(self, name):
        return (True, self.num, self.den)


class FakeCaps:
    def __init__(self, struct):
        self._s = struct

    def get_structure(self, i):
        return self._s


class FakeBuffer:
    def __init__(self, data, pts=None):
        self.data = bytes(data)
        self.pts = pts if pts is not None else 2**64 - 1  # CLOCK_TIME_NONE
        self.dts = None
        self.duration = None

    def map(self, flags):
        return True, types.SimpleNamespace(data=self.data)

    def unmap(self, info):
        pass


class FakeSink:
    def __init__(self, samples, stalled=False):
        self.samples = list(samples)
        self.props = {}
        self.stalled = stalled  # drained but NOT at EOS (live stall)

    def set_property(self, k, v):
        self.props[k] = v

    def get_property(self, k):
        if k == "eos":
            return not self.samples and not self.stalled
        return self.props.get(k)

    def emit(self, signal, *a):
        if signal in ("pull-preroll", "try-pull-preroll"):
            return self.samples[0] if self.samples else None
        if signal in ("pull-sample", "try-pull-sample"):
            return self.samples.pop(0) if self.samples else None
        raise AssertionError(signal)


class FakeElement:
    def __init__(self):
        self.props = {}

    def set_property(self, k, v):
        self.props[k] = v


class FakeSrc:
    def __init__(self, flow="OK"):
        self.pushed = []
        self.eos = False
        self.flow = flow

    def emit(self, signal, *a):
        if signal == "push-buffer":
            self.pushed.append(a[0])
            return getattr(FakeGst.FlowReturn, self.flow)
        elif signal == "end-of-stream":
            self.eos = True


class FakeError:
    def parse_error(self):
        return "decode exploded"


class FakeBus:
    def __init__(self, error=False, writer_error=False):
        self.error = error
        self.writer_error = writer_error

    def timed_pop_filtered(self, timeout_ns, mask):
        if timeout_ns == 0:  # reader error probe: None = no pending error
            return FakeError() if self.error else None
        if self.writer_error:  # writer close: ERROR instead of EOS
            msg = FakeError()
            msg.type = FakeGst.MessageType.ERROR
            return msg
        msg = types.SimpleNamespace(type=FakeGst.MessageType.EOS)
        return msg  # writer EOS wait: immediate


class FakePipeline:
    def __init__(self, elements, bus_error=False, writer_error=False):
        self.elements = dict(elements)
        self.elements.setdefault("src", FakeElement())
        self.elements.setdefault("out", FakeElement())
        self.states = []
        self._bus = FakeBus(bus_error, writer_error)

    def get_by_name(self, name):
        return self.elements.get(name)

    def set_state(self, s):
        self.states.append(s)

    def get_bus(self):
        return self._bus


def _sample(frame, w, h, pts=None, num=24):
    return types.SimpleNamespace(
        get_caps=lambda: FakeCaps(FakeCapsStruct(w, h, num=num)),
        get_buffer=lambda: FakeBuffer(frame.tobytes(), pts))


class FakeGst:
    State = types.SimpleNamespace(PLAYING="PLAYING", NULL="NULL")
    MapFlags = types.SimpleNamespace(READ=1)
    MessageType = types.SimpleNamespace(EOS=1, ERROR=2)
    FlowReturn = types.SimpleNamespace(OK="OK", ERROR="ERROR",
                                       FLUSHING="FLUSHING")

    class Buffer:
        @staticmethod
        def new_wrapped(data):
            return FakeBuffer(data, pts=None)

    def __init__(self, frames=(), w=0, h=0, pts_list=None, num=24,
                 row_pad=0, bus_error=False, stalled=False,
                 writer_error=False, src_flow="OK"):
        self._frames, self._w, self._h, self._num = frames, w, h, num
        self._pts = pts_list or [None] * len(frames)
        self._row_pad = row_pad
        self._bus_error = bus_error
        self._stalled = stalled
        self._writer_error = writer_error
        self._src_flow = src_flow
        self.sinks, self.srcs, self.launches = [], [], []

    def _payload(self, f):
        if not self._row_pad:
            return f.tobytes()
        # stride-padded rows, like real videoconvert RGB output
        h, w, _ = f.shape
        padded = np.zeros((h, w * 3 + self._row_pad), np.uint8)
        padded[:, :w * 3] = f.reshape(h, w * 3)
        return padded.tobytes()

    def parse_launch(self, desc):
        self.launches.append(desc)
        if "appsink" in desc:
            sink = FakeSink(
                [types.SimpleNamespace(
                    get_caps=lambda _f=f: FakeCaps(
                        FakeCapsStruct(self._w, self._h, num=self._num)),
                    get_buffer=lambda _f=f, _p=p: FakeBuffer(
                        self._payload(_f), _p))
                 for f, p in zip(self._frames, self._pts)],
                stalled=self._stalled)
            self.sinks.append(sink)
            return FakePipeline({"sink": sink}, bus_error=self._bus_error)
        src = FakeSrc(self._src_flow)
        self.srcs.append(src)
        return FakePipeline({"src": src}, writer_error=self._writer_error)


@pytest.fixture
def fake_gst():
    def install(frames=(), w=0, h=0, pts_list=None, num=24, **kw):
        g = FakeGst(frames, w, h, pts_list, num, **kw)
        gstreamer._set_gst_for_testing(g)
        return g
    yield install
    gstreamer._set_gst_for_testing(None)  # restore the unavailable gate


def _rgb_frames(n, h, w, seed=0):
    r = np.random.default_rng(seed)
    return [r.integers(0, 256, (h, w, 3), np.uint8) for _ in range(n)]


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

def test_reader_probes_geometry_before_first_read(fake_gst, tmp_path):
    frames = _rgb_frames(3, 10, 16)
    fake_gst(frames, 16, 10, num=24)
    p = tmp_path / "v.avi"
    p.write_bytes(b"x")
    r = GstVideoReader(str(p))
    assert (r.width, r.height) == (16, 10)   # from the preroll sample
    assert r.fps == 24.0                      # (ok, num, den) fraction parsed
    got = list(r)
    assert len(got) == 3
    for g, f in zip(got, frames):
        np.testing.assert_array_equal(g, f)
    r.close()


def test_reader_exposes_pts(fake_gst, tmp_path):
    frames = _rgb_frames(2, 4, 8)
    fake_gst(frames, 8, 4, pts_list=[int(0.5e9), int(1.25e9)])
    p = tmp_path / "v.avi"
    p.write_bytes(b"x")
    r = GstVideoReader(str(p))
    f, pts = r.read_timed()
    assert pts == 0.5
    f, pts = r.read_timed()
    assert pts == 1.25
    assert r.read_timed() is None


def test_reader_iter_bgr_swaps(fake_gst, tmp_path):
    f = np.zeros((4, 8, 3), np.uint8)
    f[..., 0] = 200  # red plane
    fake_gst([f], 8, 4)
    p = tmp_path / "v.avi"
    p.write_bytes(b"x")
    r = GstVideoReader(str(p))
    bgr = next(iter(r.iter_bgr()))
    assert bgr[0, 0, 2] == 200 and bgr[0, 0, 0] == 0


def test_reader_unavailable_gate(tmp_path):
    gstreamer._set_gst_for_testing(None)
    p = tmp_path / "v.avi"
    p.write_bytes(b"x")
    with pytest.raises(DecodeError, match="GStreamer unavailable"):
        GstVideoReader(str(p))


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

def test_writer_propagates_pts_and_duration(fake_gst, tmp_path):
    g = fake_gst()
    w = GstVideoWriter(str(tmp_path / "o.avi"), 10.0, 8, 4)
    frames = _rgb_frames(3, 4, 8)
    w.write(frames[0])                      # default pts: index/fps
    w.write(frames[1], pts=0.7, duration=0.3)
    w.write(frames[2])
    w.close()
    src = g.srcs[0]
    assert src.eos and len(src.pushed) == 3
    assert src.pushed[0].pts == 0
    assert src.pushed[0].duration == int(0.1 * 1e9)
    assert src.pushed[1].pts == int(0.7 * 1e9)
    assert src.pushed[1].duration == int(0.3 * 1e9)
    assert src.pushed[2].pts == int(0.2 * 1e9)
    np.testing.assert_array_equal(
        np.frombuffer(src.pushed[0].data, np.uint8).reshape(4, 8, 3),
        frames[0])
    assert "avimux" in g.launches[0]        # ref egress graph shape


def test_writer_broadcasts_single_plane(fake_gst, tmp_path):
    g = fake_gst()
    w = GstVideoWriter(str(tmp_path / "o.avi"), 10.0, 8, 4)
    w.write(np.full((4, 8, 1), 7, np.uint8))
    w.close()
    data = np.frombuffer(g.srcs[0].pushed[0].data, np.uint8)
    assert data.size == 4 * 8 * 3 and (data == 7).all()


# ---------------------------------------------------------------------------
# factories + app plumbing
# ---------------------------------------------------------------------------

def test_open_video_auto_prefers_gstreamer_when_available(fake_gst, tmp_path):
    fake_gst(_rgb_frames(1, 4, 8), 8, 4)
    p = tmp_path / "v.avi"
    p.write_bytes(b"x")
    assert isinstance(open_video(str(p), "gstreamer"), GstVideoReader)
    assert isinstance(open_video(str(p), "auto"), GstVideoReader)
    with pytest.raises(ValueError):
        open_video(str(p), "nope")


def test_open_writer_backends(fake_gst, tmp_path):
    from dips.io.video import VideoWriter
    from dips.properties import Encoding
    fake_gst()
    w = open_writer(str(tmp_path / "a.avi"), 10, 8, 4, Encoding.MJPG,
                    "gstreamer")
    assert isinstance(w, GstVideoWriter)
    w.close()
    w = open_writer(str(tmp_path / "b.avi"), 10, 8, 4, Encoding.MJPG, "auto")
    assert isinstance(w, VideoWriter)
    w.close()


def test_perform_dips_through_gstreamer_backend(fake_gst, tmp_path):
    """End-to-end: DiPsJob.video_backend='gstreamer' plumbs the fake reader
    AND writer through stream_dips/perform_dips."""
    from dips.app import DiPsJob, perform_dips
    from dips.properties import DiPsFilter, DiPsProperties

    h, w = 8, 16
    frames = _rgb_frames(5, h, w, seed=3)
    g = fake_gst(frames, w, h, num=20)
    src_path = tmp_path / "in.avi"
    src_path.write_bytes(b"x")
    job = DiPsJob(
        properties=DiPsProperties(window_size=1, temporal_size=1,
                                  filter=DiPsFilter.UNFILTERED),
        video_path=str(src_path), output_path=str(tmp_path / "out.avi"),
        batch=2, video_backend="gstreamer")
    stats = perform_dips(job)
    assert stats.shape[0] == 5
    src = g.srcs[0]
    assert len(src.pushed) == 5 and src.eos
    # constant-rate PTS at the probed input fps
    assert src.pushed[1].pts == int(1e9 / 20)
    # and the diff maps are real: frame 0 is the gray-rendered capture
    first = np.frombuffer(src.pushed[0].data, np.uint8).reshape(h, w, 3)
    assert first.std() > 0


def test_perform_dips_gstreamer_hwc_layout(fake_gst, tmp_path):
    """Native-RGB reader + input_layout='hwc': raw RGB decode bytes are
    staged and planarized ON DEVICE without a BGR swap (layout 'hwc', not
    'hwc_bgr' — app.py picks by reader.native_rgb).  Output must match the
    host-planarized path bit-for-bit; luminance weights R=0.299 vs B=0.114
    mean a spurious swap would change every diff map."""
    from dips.app import DiPsJob, perform_dips
    from dips.properties import DiPsProperties

    h, w = 8, 16
    frames = _rgb_frames(5, h, w, seed=7)
    pushed = {}
    for layout in ("planar", "hwc"):
        g = fake_gst(frames, w, h, num=20)
        src_path = tmp_path / f"in_{layout}.avi"
        src_path.write_bytes(b"x")
        job = DiPsJob(
            properties=DiPsProperties(window_size=1, temporal_size=1),
            video_path=str(src_path),
            output_path=str(tmp_path / f"out_{layout}.avi"),
            batch=2, video_backend="gstreamer", input_layout=layout)
        stats = perform_dips(job)
        assert stats.shape[0] == 5
        pushed[layout] = [bytes(b.data) for b in g.srcs[0].pushed]
    assert len(pushed["hwc"]) == 5
    for i, (a, b) in enumerate(zip(pushed["planar"], pushed["hwc"])):
        assert a == b, f"frame {i} differs between planar and hwc layouts"


def test_reader_handles_stride_padded_rows(fake_gst, tmp_path):
    """Code-review regression: videoconvert RGB rows are padded to 4-byte
    stride alignment — width not divisible by 4 must still decode."""
    frames = _rgb_frames(2, 6, 9)  # 9*3=27 bytes/row -> stride 28
    fake_gst(frames, 9, 6, row_pad=1)
    p = tmp_path / "v.avi"
    p.write_bytes(b"x")
    r = GstVideoReader(str(p))
    for got, exp in zip(iter(r), frames):
        np.testing.assert_array_equal(got, exp)


def test_reader_raises_on_pipeline_error(fake_gst, tmp_path):
    """An undecodable input posts ERROR on the bus: raise, don't hang."""
    fake_gst((), 0, 0, bus_error=True)
    p = tmp_path / "bad.avi"
    p.write_bytes(b"x")
    with pytest.raises(DecodeError, match="pipeline error|probe"):
        GstVideoReader(str(p))


def test_paths_set_as_properties_not_interpolated(fake_gst, tmp_path):
    """Quotes in filenames must not be able to rewrite the pipeline."""
    frames = _rgb_frames(1, 4, 8)
    g = fake_gst(frames, 8, 4)
    evil = tmp_path / 'clip " ! fakesink x=.avi'
    evil.write_bytes(b"x")
    r = GstVideoReader(str(evil))
    assert str(evil) not in g.launches[0]  # not in the launch string
    r.close()
    w = GstVideoWriter(str(tmp_path / 'out " pwn.avi'), 29.97, 8, 4)
    assert "pwn" not in g.launches[1]
    # NTSC-ish rates keep a faithful rational, not a rounded 30/1
    assert "framerate=30/1 " not in g.launches[1]
    assert "framerate=2997/100" in g.launches[1]
    w.close()


def test_reader_rgb_native_iterator(fake_gst, tmp_path):
    frames = _rgb_frames(2, 4, 8)
    fake_gst(frames, 8, 4, pts_list=[int(1e8), int(2e8)])
    p = tmp_path / "v.avi"
    p.write_bytes(b"x")
    r = GstVideoReader(str(p))
    assert r.native_rgb
    got = list(r.iter_rgb_timed())
    assert len(got) == 2
    np.testing.assert_array_equal(got[0][0], frames[0])
    assert got[0][1] == pytest.approx(0.1)


def test_uri_input_routes_through_uridecodebin(fake_gst, tmp_path):
    """Network-stream ingest: rtsp:// (and friends) build a uridecodebin
    graph with live-source frame dropping, set the uri as a PROPERTY (never
    interpolated), and skip the local-file existence check."""
    frames = _rgb_frames(2, 4, 8)
    g = fake_gst(frames, 8, 4)
    uri = 'rtsp://cam.local:8554/stream " ! fakesink'
    r = GstVideoReader(uri)
    assert "uridecodebin" in g.launches[0]
    assert "drop=true" in g.launches[0]
    assert uri not in g.launches[0]
    src = r._pipeline.get_by_name("src")
    assert src.props["uri"] == uri
    assert r.width == 8 and r.height == 4 and r.frame_count == -1
    np.testing.assert_array_equal(r.read(), frames[0])
    r.close()


def test_local_path_still_uses_filesrc(fake_gst, tmp_path):
    frames = _rgb_frames(1, 4, 8)
    g = fake_gst(frames, 8, 4)
    p = tmp_path / "v.avi"
    p.write_bytes(b"x")
    r = GstVideoReader(str(p))
    assert "filesrc" in g.launches[0] and "uridecodebin" not in g.launches[0]
    r.close()


def test_is_stream_uri():
    from dips.io.gstreamer import is_stream_uri

    for u in ("rtsp://h/s", "rtsps://h/s", "srt://h:1", "udp://0:5000",
              "rtp://h", "rtmp://h/live", "http://h/a.m3u8",
              "https://h/a.mp4", "file:///x.avi"):
        assert is_stream_uri(u), u
    for p in ("/data/x.avi", "x.avi", "C:/x.avi", "rtsp:/x", "httpx://h"):
        assert not is_stream_uri(p), p


def test_opencv_reader_accepts_uri_without_exists_check():
    """URIs bypass the local-file existence gate on the OpenCV backend too
    (cv2+FFmpeg handles network streams); a bogus URI surfaces as a decode
    failure, not a 'file not found'."""
    from dips.errors import DecodeError
    from dips.io.video import VideoReader

    with pytest.raises(DecodeError):
        VideoReader("file:///nonexistent/dir/clip.avi")


def test_run_dips_on_files_honors_video_backend(fake_gst, tmp_path):
    """The multi-video batch path routes readers AND writers through the
    selected backend (it used to hardcode OpenCV, ignoring
    --video-backend)."""
    from dips.app import run_dips_on_files
    from dips.properties import DiPsProperties

    h, w = 8, 16
    frames = _rgb_frames(4, h, w, seed=11)
    g = fake_gst(frames, w, h, num=20)
    paths = []
    for name in ("a.avi", "b.avi"):
        p = tmp_path / name
        p.write_bytes(b"x")
        paths.append(str(p))
    counts = run_dips_on_files(
        paths, str(tmp_path / "out"),
        properties=DiPsProperties(window_size=1, temporal_size=1),
        batch=2, video_backend="gstreamer")
    assert list(counts) == [4, 4]
    assert len(g.sinks) == 2 and len(g.srcs) == 2
    for src in g.srcs:
        assert len(src.pushed) == 4 and src.eos


# ---------------------------------------------------------------------------
# self-review round 2: media-layer hardening
# ---------------------------------------------------------------------------

def test_nonlive_uri_keeps_every_frame(fake_gst, tmp_path):
    """file:// (and http VOD) are NOT live: the appsink must block the
    decoder (drop=false), never silently discard frames of a file."""
    g = fake_gst(_rgb_frames(1, 4, 8), 8, 4)
    r = GstVideoReader("file:///data/clip.mp4")
    assert "drop=false" in g.launches[0]
    r.close()
    g2 = fake_gst(_rgb_frames(1, 4, 8), 8, 4)
    r = GstVideoReader("rtsp://cam/live")
    assert "drop=true" in g2.launches[0]  # live: drop stale, free the sender
    r.close()


def test_uri_schemes_case_insensitive():
    from dips.io.gstreamer import is_live_uri, is_stream_uri

    assert is_stream_uri("RTSP://cam/s") and is_live_uri("RTSP://cam/s")
    assert is_stream_uri("File:///x.avi") and not is_live_uri("File:///x.avi")


def test_stalled_live_source_raises_not_eos(fake_gst, tmp_path):
    """A pull timeout with the source alive must raise, not report a
    successful end-of-stream that silently truncates the run."""
    frames = _rgb_frames(1, 4, 8)
    fake_gst(frames, 8, 4, stalled=True)
    r = GstVideoReader("rtsp://cam/live")
    np.testing.assert_array_equal(r.read(), frames[0])
    with pytest.raises(DecodeError, match="stalled"):
        r.read()
    r.close()


def test_drained_file_still_reports_eos(fake_gst, tmp_path):
    frames = _rgb_frames(2, 4, 8)
    fake_gst(frames, 8, 4)
    p = tmp_path / "v.avi"
    p.write_bytes(b"x")
    r = GstVideoReader(str(p))
    assert r.read() is not None and r.read() is not None
    assert r.read() is None  # drained + sink at EOS -> clean end
    r.close()


def test_missing_pts_resets_last_pts(fake_gst, tmp_path):
    """A PTS-less buffer must yield last_pts=None, not the previous
    frame's timestamp (a stale duplicate makes the CFR retimer drop it)."""
    frames = _rgb_frames(2, 4, 8)
    fake_gst(frames, 8, 4, pts_list=[int(1e8), None])
    p = tmp_path / "v.avi"
    p.write_bytes(b"x")
    r = GstVideoReader(str(p))
    _, pts0 = r.read_timed()
    _, pts1 = r.read_timed()
    assert pts0 == pytest.approx(0.1) and pts1 is None
    r.close()


def test_writer_surfaces_encode_errors(fake_gst, tmp_path):
    """Push FlowReturn and close-time bus ERROR must raise EncodeError
    (the OpenCV writer raises for the same conditions)."""
    from dips.errors import EncodeError

    fake_gst(src_flow="FLUSHING")
    w = GstVideoWriter(str(tmp_path / "o.avi"), 10, 8, 4)
    with pytest.raises(EncodeError, match="push-buffer"):
        w.write(np.zeros((4, 8, 3), np.uint8))

    fake_gst(writer_error=True)
    w = GstVideoWriter(str(tmp_path / "o2.avi"), 10, 8, 4)
    w.write(np.zeros((4, 8, 3), np.uint8))
    with pytest.raises(EncodeError, match="encode failed"):
        w.close()


def test_native_layout_rejects_oversized_frames():
    """Mid-stream geometry growth must fail loudly, not write out of
    bounds through the native kernels or silently truncate ring slots."""
    from dips import native

    with pytest.raises(ValueError, match="exceeds padded"):
        native.planarize(np.zeros((16, 200, 3), np.uint8), 16, 128)
    with pytest.raises(ValueError, match="exceeds plane"):
        native.interleave(np.zeros((3, 8, 128), np.uint8), 16, 64)
    ring = native.FrameRing(slots=2, slot_bytes=64)
    with pytest.raises(ValueError, match="slot size"):
        ring.push(np.zeros(65, np.uint8))
    ring.close()


def test_thumbnail_through_gstreamer_and_uri(fake_gst, tmp_path):
    """extract_thumbnail goes through the backend-selecting reader: the
    GStreamer backend (and thus media URIs) can be thumbnailed."""
    from dips.io.thumbnail import extract_thumbnail

    frames = _rgb_frames(1, 40, 60, seed=3)
    fake_gst(frames, 60, 40)
    out = str(tmp_path / "t.png")
    thumb = extract_thumbnail("rtsp://cam.local/stream", out, height=20)
    assert thumb.shape == (20, 30, 3)
    import os
    assert os.path.exists(out)
