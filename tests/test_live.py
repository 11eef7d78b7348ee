"""Headless tests for the live-preview controller (the egui-overlay parity
surface, ref dips_alt/src/lib.rs:237-478): key -> properties transitions,
engine rebuild with state carry-over, and display-path helpers."""

import numpy as np
import pytest

from dips.live import LiveController, _to_bgr, rebuild_engine, run_live
from dips.models import DiPsEngine
from dips.properties import (ChromaFilter, DiPsFilter, DiPsMethod,
                             DiPsProperties, OutputMode)
from tests.conftest import make_clip


def test_filter_and_chroma_cycles():
    ctl = LiveController(DiPsProperties())
    seen = [ctl.props.filter]
    for _ in range(3):
        assert ctl.handle_key("f") is True
        seen.append(ctl.props.filter)
    assert seen[:3] == [DiPsFilter.SIGMOID, DiPsFilter.INVERSE_SIGMOID,
                        DiPsFilter.UNFILTERED]
    assert seen[3] == DiPsFilter.SIGMOID  # full cycle
    for expected in (ChromaFilter.RED, ChromaFilter.GREEN, ChromaFilter.BLUE,
                     ChromaFilter.ALL):
        assert ctl.handle_key("c") is True
        assert ctl.props.chroma == expected


def test_toggles_and_sliders():
    ctl = LiveController(DiPsProperties())
    assert ctl.handle_key("o") and ctl.props.output == OutputMode.GRAYSCALE
    assert ctl.handle_key("o") and ctl.props.output == OutputMode.COLORIZE
    assert ctl.handle_key("m") and ctl.props.method == DiPsMethod.PER_FRAME
    assert ctl.handle_key("+") and ctl.props.sensitivity == 5.5
    assert ctl.handle_key("-") and ctl.props.sensitivity == 5.0
    assert ctl.handle_key("]") and ctl.props.sigmoid_horizontal_scalar == 6.0
    assert ctl.handle_key("T") and ctl.props.temporal_size == 5
    assert ctl.handle_key("t") and ctl.props.temporal_size == 4


def test_clamped_edges_report_no_rebuild():
    """At a clamp boundary the properties don't change, so no rebuild."""
    ctl = LiveController(DiPsProperties(window_size=7))
    assert ctl.handle_key("W") is False  # already at WINDOW_MAX
    assert ctl.props.window_size == 7
    ctl = LiveController(DiPsProperties(sigmoid_horizontal_scalar=10))
    assert ctl.handle_key("]") is False
    ctl = LiveController(DiPsProperties(temporal_size=1))
    assert ctl.handle_key("t") is False


def test_snapshot_and_quit_keys():
    ctl = LiveController(DiPsProperties())
    assert ctl.handle_key("s") is False and ctl.snapshot_requested
    assert not ctl.quit
    assert ctl.handle_key("q") is False and ctl.quit
    ctl2 = LiveController(DiPsProperties())
    ctl2.handle_key(27)  # ESC as an int keycode
    assert ctl2.quit
    assert ctl2.handle_key("z") is False  # unknown keys are ignored
    assert "overall" in ctl2.status_line()


def test_rebuild_preserves_streaming_state():
    """Parameter changes keep the pinned baseline / ring / cursor, like the
    reference's redip closure carries the GPU state forward."""
    frames = make_clip(n=6, h=10, w=24, seed=1)
    props = DiPsProperties(window_size=1, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED)
    eng = DiPsEngine(props, 10, 24, batch=3)
    eng.process_frames(list(frames[:3]))
    base_before = np.asarray(eng._baseline)

    new_props = props.with_sensitivity(2.0)
    eng2 = rebuild_engine(eng, new_props)
    assert eng2.frame_index == 3
    np.testing.assert_array_equal(np.asarray(eng2._baseline), base_before)
    # frame 3 is NOT index 0 in the rebuilt engine: no spurious re-capture
    out, stats = eng2.process_batch(list(frames[3:6]))
    assert stats[:, 3].max() > 0  # still diffing against the old baseline


def test_rebuild_temporal_grow_pads_tail():
    """Code-review regression: pressing 'T' (temporal_size up) used to
    restore a too-short tail and crash the next process_batch."""
    frames = make_clip(n=4, h=8, w=16, seed=3)
    eng = DiPsEngine(DiPsProperties(temporal_size=2), 8, 16, batch=4)
    eng.process_frames(list(frames))
    eng2 = rebuild_engine(eng, eng.props.with_temporal_size(5))
    assert len(eng2._tail) == 5
    # oldest frame replayed at the front, newest preserved at the back
    np.testing.assert_array_equal(
        np.stack(list(eng2._tail))[-2:], np.stack(list(eng._tail)))
    out, stats = eng2.process_batch([frames[0]])  # must not raise
    assert out.shape == (1, 8, 16, 3)


def test_rebuild_temporal_resize_truncates_tail():
    frames = make_clip(n=4, h=8, w=16, seed=2)
    eng = DiPsEngine(DiPsProperties(temporal_size=4), 8, 16, batch=4)
    eng.process_frames(list(frames))
    eng2 = rebuild_engine(eng, eng.props.with_temporal_size(2))
    assert len(eng2._tail) == 2
    # newest two frames survive
    np.testing.assert_array_equal(
        np.stack(list(eng2._tail)), np.stack(list(eng._tail))[-2:])


def test_rebuild_across_incompatible_modes_resets():
    eng = DiPsEngine(DiPsProperties(), 8, 16, batch=2)
    eng.process_batch([make_clip(n=1, h=8, w=16)[0]])
    eng2 = rebuild_engine(eng, DiPsProperties(output=OutputMode.ABSDIFF))
    assert eng2.frame_index == 0  # raw-mode baseline is u8: fresh start


def test_to_bgr_single_channel():
    """ADVICE regression: GRAYSCALE/THRESHOLD output is (H, W, 1) and must
    not crash the preview conversion."""
    gray = np.full((6, 8, 1), 77, np.uint8)
    bgr = _to_bgr(gray)
    assert bgr.shape == (6, 8, 3) and (bgr == 77).all()
    rgb = np.zeros((6, 8, 3), np.uint8)
    rgb[..., 0] = 200  # red in RGB -> blue-last in BGR
    assert _to_bgr(rgb)[0, 0, 2] == 200


class _FakeReader:
    def __init__(self):
        self.closed = False

    def read(self):
        return np.zeros((8, 8, 3), np.uint8)

    def close(self):
        self.closed = True


def test_run_live_headless_fails_gracefully():
    """No display: run_live must return 1 and release the reader."""
    r = _FakeReader()
    rc = run_live(DiPsProperties(), reader=r)
    if rc == 0:  # a display exists in this environment; nothing to assert
        pytest.skip("display available")
    assert rc == 1 and r.closed


def test_cli_live_with_input_uses_that_source(monkeypatch, tmp_path):
    """--live --input FILE previews the file (or a network URI), not the
    webcam: the CLI must open the given source and hand it to run_live."""
    from dips import cli as cli_mod
    from dips import live as live_mod
    from dips.io import moving_square_clip, write_clip

    p = str(tmp_path / "clip.avi")
    write_clip(moving_square_clip(n=2, height=16, width=24), p, fps=10)

    seen = {}

    def fake_run_live(props, reader=None, **kw):
        seen["reader"] = reader
        if reader is not None:
            reader.close()
        return 0

    monkeypatch.setattr(live_mod, "run_live", fake_run_live)
    rc = cli_mod.main(["--live", "--input", p])
    assert rc == 0
    assert seen["reader"] is not None and seen["reader"].path == p

    # missing input errors cleanly instead of falling back to the webcam
    rc = cli_mod.main(["--live", "--input", str(tmp_path / "nope.avi")])
    assert rc == 1


def test_controller_event_toggle():
    """'e' toggles motion-event detection without an engine rebuild and
    surfaces the mode in the HUD."""
    from dips.live import LiveController
    from dips.properties import DiPsProperties

    ctl = LiveController(DiPsProperties())
    assert not ctl.events_enabled
    assert "events" not in ctl.status_line()
    assert ctl.handle_key("e") is False  # no rebuild
    assert ctl.events_enabled
    assert "events=auto" in ctl.status_line()
    assert ctl.handle_key(ord("e")) is False
    assert not ctl.events_enabled


def test_run_live_event_loop_with_stubbed_display(monkeypatch, capsys):
    """Drive the real run_live loop headless: cv2's window calls are
    stubbed, a scripted key sequence enables events, and a moving span
    must print a closed motion event and flag MOTION in the title."""
    import cv2
    import numpy as np
    from dips import live as live_mod
    from dips.properties import (DiPsFilter, DiPsProperties,
                                 OutputMode)
    from tests.conftest import make_clip

    h, w = 16, 24
    # the auto floor needs its 16-frame idle warmup before motion starts
    frames = (list(make_clip(n=20, h=h, w=w, seed=3, moving=False))
              + list(make_clip(n=6, h=h, w=w, seed=3, moving=True))
              + list(make_clip(n=6, h=h, w=w, seed=3, moving=False)))

    class Reader:
        def __init__(self):
            self.i = 0

        def read(self):
            if self.i >= len(frames):
                return None
            f = frames[self.i]
            self.i += 1
            return f

        def close(self):
            pass

    titles = []
    keys = iter([ord("e")] + [0xFF] * (len(frames) - 1))
    monkeypatch.setenv("DISPLAY", ":0")
    monkeypatch.setattr(cv2, "namedWindow", lambda *a, **k: None)
    monkeypatch.setattr(cv2, "imshow", lambda *a, **k: None)
    monkeypatch.setattr(cv2, "setWindowTitle",
                        lambda _w, t: titles.append(t))
    monkeypatch.setattr(cv2, "waitKey", lambda _ms: next(keys, ord("q")))
    monkeypatch.setattr(cv2, "destroyAllWindows", lambda: None)

    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED,
                           output=OutputMode.ABSDIFF)
    rc = live_mod.run_live(props, reader=Reader())
    assert rc == 0
    assert any("[MOTION]" in t for t in titles)       # open flagged live
    assert any("events=auto" in t for t in titles)    # HUD shows the mode
    out = capsys.readouterr().out
    assert "motion event: frames" in out              # close printed


def test_run_live_roi_overlay_and_pixels(monkeypatch):
    """With props.roi: the preview draws the region outline and the
    detector normalizes by the roi area; an out-of-bounds roi is a
    friendly error, not a traceback."""
    import cv2
    import numpy as np
    from dips import live as live_mod
    from dips.properties import (DiPsFilter, DiPsProperties,
                                 OutputMode)
    from tests.conftest import make_clip

    h, w = 16, 24
    frames = list(make_clip(n=4, h=h, w=w, seed=1, moving=False))

    class Reader:
        def __init__(self, fs):
            self.fs = list(fs)

        def read(self):
            return self.fs.pop(0) if self.fs else None

        def close(self):
            pass

    shown = []
    monkeypatch.setenv("DISPLAY", ":0")
    monkeypatch.setattr(cv2, "namedWindow", lambda *a, **k: None)
    monkeypatch.setattr(cv2, "imshow", lambda _w, img: shown.append(img))
    monkeypatch.setattr(cv2, "setWindowTitle", lambda *a: None)
    monkeypatch.setattr(cv2, "waitKey", lambda _ms: 0xFF)
    monkeypatch.setattr(cv2, "destroyAllWindows", lambda: None)

    roi = (2, 3, 10, 20)
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED,
                           output=OutputMode.ABSDIFF, roi=roi)
    rc = live_mod.run_live(props, reader=Reader(frames))
    assert rc == 0 and shown
    y0, x0, y1, x1 = roi
    # the outline is drawn in a color the ABSDIFF map of a static clip
    # cannot produce (pure yellow)
    top = shown[-1][y0, x0:x1]
    assert (top == (0, 255, 255)).all(axis=-1).any()

    # roi exceeding the camera frame: graceful rc 1
    bad = props.with_roi((0, 0, h + 5, w))
    rc = live_mod.run_live(bad, reader=Reader(frames))
    assert rc == 1


def test_controller_auto_refresh_toggle():
    """'a' toggles adaptive baseline refresh without a rebuild; the HUD
    reflects it; --auto-refresh pre-arms it (ADVICE r2: the documented
    key must exist)."""
    ctl = LiveController(DiPsProperties())
    assert not ctl.auto_refresh_enabled
    assert ctl.handle_key("a") is False          # never rebuilds
    assert ctl.auto_refresh_enabled
    assert "refresh=auto" in ctl.status_line()
    assert ctl.handle_key("a") is False
    assert not ctl.auto_refresh_enabled
    assert "refresh=auto" not in ctl.status_line()
    armed = LiveController(DiPsProperties(),
                           auto_refresh={"threshold": 0.5, "persist": 2})
    assert armed.auto_refresh_enabled
    assert armed.auto_refresh_cfg == {"threshold": 0.5, "persist": 2}


def test_run_live_auto_refresh_repins_baseline(monkeypatch, capsys):
    """A wholesale scene cut during the stubbed-display preview fires the
    policy: the snapshot is re-pinned (printed) and the post-cut diff
    goes quiet against the new baseline."""
    import cv2
    from dips import live as live_mod

    h, w = 16, 24
    frames = ([np.full((h, w, 3), 30, np.uint8)] * 6
              + [np.full((h, w, 3), 220, np.uint8)] * 10)

    class Reader:
        def __init__(self, fs):
            self.fs = list(fs)

        def read(self):
            return self.fs.pop(0) if self.fs else None

        def close(self):
            pass

    shown = []
    monkeypatch.setenv("DISPLAY", ":0")
    monkeypatch.setattr(cv2, "namedWindow", lambda *a, **k: None)
    monkeypatch.setattr(cv2, "imshow", lambda _w, img: shown.append(img))
    monkeypatch.setattr(cv2, "setWindowTitle", lambda *a: None)
    monkeypatch.setattr(cv2, "waitKey", lambda _ms: 0xFF)
    monkeypatch.setattr(cv2, "destroyAllWindows", lambda: None)

    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED,
                           output=OutputMode.ABSDIFF)
    rc = live_mod.run_live(
        props, reader=Reader(frames),
        auto_refresh={"threshold": 0.5, "persist": 2, "cooldown": 2})
    assert rc == 0
    out = capsys.readouterr().out
    assert "auto-refresh: baseline re-pinned" in out
    # after the re-pin the 220-frames diff against a 220 baseline: quiet
    assert shown[-1].max() == 0
