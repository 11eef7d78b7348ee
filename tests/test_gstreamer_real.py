"""REAL GStreamer execution.

The fake-shim suite (test_gstreamer.py) pins the backend's logic; this one
runs the same reader/writer classes against the ACTUAL C stack through the
in-tree ctypes binding (io/gstbind.py) — real caps negotiation, preroll
probing, decodebin pad hookup, PTS propagation, bus errors.  Skipped only
when the GStreamer C libraries are absent (they ship in this image;
PyGObject does not, which is exactly why gstbind exists).
"""

import os

import numpy as np
import pytest

try:
    from dips.io.gstbind import load_gst
    GST = load_gst()
except Exception:  # noqa: BLE001 - any load failure = no C stack
    GST = None

pytestmark = pytest.mark.skipif(
    GST is None, reason="GStreamer C libraries not loadable")


@pytest.fixture(autouse=True)
def real_gst():
    """Pin the module gate to the real ctypes backend for each test (other
    suites install fakes; ordering must not matter)."""
    from dips.io import gstreamer as g
    old = (g._gst, g._gst_err)
    g._gst, g._gst_err = GST, None
    yield
    g._gst, g._gst_err = old


def _frames(n=8, h=48, w=64):
    """Smooth gradient frames (theora-friendly) with per-frame motion."""
    out = []
    for i in range(n):
        y, x = np.mgrid[0:h, 0:w]
        out.append(np.stack([(x * 3 + i * 17) % 256, (y * 4) % 256,
                             np.full((h, w), 60 + i * 9)],
                            -1).astype(np.uint8))
    return out


def test_registry_probe():
    assert GST.element_available("appsink")
    assert GST.element_available("videotestsrc")
    assert not GST.element_available("definitely_not_an_element_xyz")
    assert GST.version.startswith("GStreamer 1.")


def test_writer_reader_round_trip(tmp_path):
    """appsrc encode -> file -> filesrc!decodebin decode, exact PTS,
    lossy-codec-tolerant pixel match."""
    from dips.io.gstreamer import GstVideoReader, GstVideoWriter
    path = str(tmp_path / "rt.ogv")
    frames = _frames(10)
    w = GstVideoWriter(path, fps=10.0, width=64, height=48)
    if not GST.element_available("avimux"):
        assert w.fallback_used == "theora+ogg"
    for i, f in enumerate(frames):
        w.write(f, pts=i / 10.0)
    w.close()
    assert w.frames_written == 10 and os.path.getsize(path) > 0

    rd = GstVideoReader(path)
    # geometry/fps probed from the REAL preroll caps before the first read
    assert (rd.width, rd.height) == (64, 48)
    assert rd.fps == pytest.approx(10.0)
    got = []
    while True:
        r = rd.read_timed()
        if r is None:
            break
        got.append(r)
    rd.close()
    assert len(got) == 10
    pts = [p for _, p in got]
    assert pts == pytest.approx([i / 10.0 for i in range(10)], abs=1e-6)
    err = np.abs(got[0][0].astype(int) - frames[0].astype(int)).mean()
    assert err < 12  # theora is lossy; gradients stay close


def test_reader_missing_and_corrupt_files(tmp_path):
    from dips.errors import DecodeError, VideoPathError
    from dips.io.gstreamer import GstVideoReader
    with pytest.raises(VideoPathError):
        GstVideoReader(str(tmp_path / "nope.ogv"))
    junk = tmp_path / "junk.ogv"
    junk.write_bytes(b"this is not a media file" * 64)
    with pytest.raises(DecodeError):
        GstVideoReader(str(junk))


def test_auto_stays_opencv_without_optin(tmp_path, monkeypatch):
    """The ctypes backend is explicit-only: auto keeps OpenCV unless
    DIPS_GST_CTYPES=1 (base-plugin images cannot demux .avi)."""
    import cv2
    from dips.io.gstreamer import available, open_video
    from dips.io.video import VideoReader
    monkeypatch.delenv("DIPS_GST_CTYPES", raising=False)
    assert not available()
    p = str(tmp_path / "a.avi")
    wr = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"MJPG"), 10, (32, 16))
    for f in _frames(3, 16, 32):
        wr.write(f[:, :, ::-1])
    wr.release()
    r = open_video(p, "auto")
    assert isinstance(r, VideoReader)
    r.close()
    monkeypatch.setenv("DIPS_GST_CTYPES", "1")
    assert available()


def test_perform_dips_on_real_gstreamer_backend(tmp_path):
    """End to end: real-Gst ingest -> diff pipeline -> real-Gst egress,
    and the produced diff video decodes back."""
    from dips.app import DiPsJob, perform_dips
    from dips.io.gstreamer import GstVideoReader, GstVideoWriter
    from dips.properties import DiPsProperties

    src = str(tmp_path / "in.ogv")
    w = GstVideoWriter(src, fps=10.0, width=64, height=48)
    for i, f in enumerate(_frames(8)):
        w.write(f, pts=i / 10.0)
    w.close()

    out = str(tmp_path / "out.ogv")
    job = DiPsJob(properties=DiPsProperties(temporal_size=2),
                  video_path=src, output_path=out, batch=4,
                  video_backend="gstreamer")
    stats = perform_dips(job)
    assert stats.shape[0] == 8
    rd = GstVideoReader(out)
    n = sum(1 for _ in rd)
    rd.close()
    assert n == 8
