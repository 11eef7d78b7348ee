"""dips-report: self-contained HTML from a run's JSON artifacts."""

import json

import numpy as np
import pytest

from dips.ops.oracle import STAT_NAMES
from dips.report import main as report_main, render_report


def _write_stats(path, n=20, motion=range(6, 12)):
    rows = []
    for i in range(n):
        on = i in motion
        rows.append({"mean_diff": 0.0, "mean_abs_diff": 0.02 if on else 0.0,
                     "max_abs_diff": 0.5 if on else 0.0,
                     "changed_count": 16.0 if on else 0.0})
    with open(path, "w") as f:
        json.dump(rows, f)


def _write_events(path, data):
    with open(path, "w") as f:
        json.dump(data, f)


_EV = {"start_frame": 6, "end_frame": 11, "frames": 6, "peak": 0.5,
       "peak_frame": 7, "mean": 0.4}


def test_report_renders_single_stream(tmp_path):
    sp, ep = str(tmp_path / "s.json"), str(tmp_path / "e.json")
    _write_stats(sp)
    _write_events(ep, [_EV])
    out = str(tmp_path / "r.html")
    rc = report_main(["--stats-json", sp, "--events-json", ep,
                      "--pixels", "384", "-o", out,
                      "--title", "cam <42>"])
    assert rc == 0
    doc = open(out).read()
    assert "cam &lt;42&gt;" in doc                 # titles are escaped
    assert doc.count("data:image/png;base64,") == 2  # both panels embedded
    assert ">1<" in doc and "motion events" in doc   # headline tile
    assert "<td>6</td><td>11</td>" in doc            # event table row
    for k in STAT_NAMES:
        assert k in doc                              # table view exists


def test_report_events_table_rejects_markup(tmp_path):
    """A corrupt events JSON must fail cleanly (same contract as the
    segments table), never smuggle markup into the page."""
    sp, ep = str(tmp_path / "s.json"), str(tmp_path / "e.json")
    _write_stats(sp)
    evil = dict(_EV, start_frame="<script>alert(1)</script>")
    _write_events(ep, [evil])
    with pytest.raises((ValueError, TypeError)):
        render_report(sp, events_path=ep)


def test_report_multi_stream_and_heatmap(tmp_path):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    sp, ep = str(tmp_path / "s.json"), str(tmp_path / "e.json")
    _write_stats(sp)
    _write_events(ep, {"a.avi": [_EV], "b.avi": []})
    hm = str(tmp_path / "hm.png")
    fig, ax = plt.subplots()
    ax.imshow(np.zeros((4, 4)))
    fig.savefig(hm)
    plt.close(fig)
    out = str(tmp_path / "r.html")
    rc = report_main(["--stats-json", sp, "--events-json", ep,
                      "--heatmap", hm, "-o", out])
    assert rc == 0
    doc = open(out).read()
    assert "a.avi" in doc and "b.avi" in doc         # one table per stream
    assert "No motion events" in doc                 # the empty stream
    assert doc.count("data:image/png;base64,") == 3  # 2 charts + heatmap


def test_report_without_events(tmp_path):
    sp = str(tmp_path / "s.json")
    _write_stats(sp, motion=())
    out = str(tmp_path / "r.html")
    assert report_main(["--stats-json", sp, "-o", out]) == 0
    doc = open(out).read()
    assert ">0<" in doc and "No motion events" in doc


def test_report_bad_input_errors_cleanly(tmp_path, capsys):
    bad = str(tmp_path / "bad.json")
    with open(bad, "w") as f:
        f.write("{not json")
    rc = report_main(["--stats-json", bad,
                      "-o", str(tmp_path / "r.html")])
    assert rc == 1
    assert "error:" in capsys.readouterr().err


def test_render_report_api(tmp_path):
    sp = str(tmp_path / "s.json")
    _write_stats(sp)
    doc = render_report(sp, pixels=384)
    assert doc.startswith("<!doctype html>")


def test_cli_heatmap_png_and_full_report_pipeline(tmp_path):
    """The full artifact journey: CLI run writes stats + events + heatmap
    PNG; dips-report stitches them into one page."""
    import cv2
    from dips.cli import main as cli_main
    from tests.conftest import make_clip

    h, w = 16, 24
    frames = (list(make_clip(n=4, h=h, w=w, seed=3, moving=False))
              + list(make_clip(n=6, h=h, w=w, seed=3, moving=True)))
    path = str(tmp_path / "in.avi")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"HFYU"), 10, (w, h))
    for f in frames:
        vw.write(f[..., ::-1])
    vw.release()

    sp = str(tmp_path / "s.json")
    ep = str(tmp_path / "e.json")
    hm = str(tmp_path / "hm.png")
    rc = cli_main(["--input", path, "--output", str(tmp_path / "o.avi"),
                   "--output-mode", "absdiff", "--temporal", "1",
                   "--win_size", "1", "--stats-json", sp,
                   "--events-json", ep, "--event-on", "0.02",
                   "--heatmap-png", hm])
    assert rc == 0
    assert cv2.imread(hm) is not None  # a real decodable PNG

    out = str(tmp_path / "r.html")
    assert report_main(["--stats-json", sp, "--events-json", ep,
                        "--heatmap", hm, "--pixels", str(h * w),
                        "-o", out]) == 0
    assert open(out).read().count("data:image/png;base64,") == 3


def test_cli_heatmap_png_rejected_outside_file_mode(tmp_path, capsys):
    import numpy as np
    from dips.cli import main as cli_main
    rng = np.random.default_rng(0)
    rgba = rng.integers(0, 256, (8, 12, 4), np.uint8)
    np.concatenate([np.zeros(4, np.uint8), rgba.ravel()]).tofile(
        tmp_path / "Dat_0.d")
    rc = cli_main(["--dat-dir", str(tmp_path),
                   "--output", str(tmp_path / "o.avi"),
                   "--dat-geometry", "12x8", "--temporal", "1",
                   "--heatmap-png", str(tmp_path / "hm.png")])
    assert rc == 2
    assert "--heatmap-png" in capsys.readouterr().err


def test_report_empty_stats_renders_cleanly(tmp_path):
    """Review regression: a zero-frame run writes [] to --stats-json; the
    report must render (no charts, a note) instead of IndexError."""
    sp = str(tmp_path / "s.json")
    with open(sp, "w") as f:
        f.write("[]")
    out = str(tmp_path / "r.html")
    assert report_main(["--stats-json", sp, "-o", out]) == 0
    doc = open(out).read()
    assert "No frames processed" in doc
    assert "data:image/png;base64," not in doc


def test_report_multistream_tiles_aggregate_all_streams(tmp_path):
    """Review regression: with a per-stream events dict the motion-frames
    tile aggregated nothing while the events tile counted everything."""
    sp, ep = str(tmp_path / "s.json"), str(tmp_path / "e.json")
    _write_stats(sp)
    _write_events(ep, {"a.avi": [_EV], "b.avi": [dict(_EV, frames=3)]})
    out = str(tmp_path / "r.html")
    assert report_main(["--stats-json", sp, "--events-json", ep,
                        "-o", out]) == 0
    doc = open(out).read()
    assert ">2<" in doc                      # events across streams
    assert ">9<" in doc                      # 6 + 3 motion frames
    assert "not shaded" in doc               # attribution disclaimer


def test_cli_heatmap_png_rejected_in_inputs_and_live_modes(tmp_path,
                                                           capsys):
    """Review regression: --inputs and --live silently ignored
    --heatmap-png instead of rejecting it."""
    from dips.cli import main as cli_main
    rc = cli_main(["--inputs", "a.avi", "b.avi", "--output-dir",
                   str(tmp_path), "--heatmap-png", str(tmp_path / "h.png")])
    assert rc == 2 and "--heatmap-png" in capsys.readouterr().err
    rc = cli_main(["--live", "--heatmap-png", str(tmp_path / "h.png")])
    assert rc == 2 and "--heatmap-png" in capsys.readouterr().err


def test_cli_json_artifacts_rejected_in_silent_modes(tmp_path, capsys):
    """--live/--thumbnail/--subsample return before the artifact tail:
    --stats-json/--events-json/--dft-json must be rejected there (and
    --dft-json under --inputs) instead of silently writing nothing."""
    from dips.cli import main as cli_main
    for flag in ("--stats-json", "--events-json", "--dft-json"):
        rc = cli_main(["--live", flag, str(tmp_path / "x.json")])
        assert rc == 2 and flag in capsys.readouterr().err
    rc = cli_main(["--input", "a.avi", "--thumbnail",
                   str(tmp_path / "t.png"), "--stats-json",
                   str(tmp_path / "s.json")])
    assert rc == 2 and "--stats-json" in capsys.readouterr().err
    rc = cli_main(["--inputs", "a.avi", "b.avi", "--output-dir",
                   str(tmp_path), "--dft-json", str(tmp_path / "d.json")])
    assert rc == 2 and "--dft-json" in capsys.readouterr().err


def test_report_segments_table(tmp_path):
    sp = str(tmp_path / "s.json")
    _write_stats(sp)
    segs = [{"path": "/rec/cam.event000_f4.avi", "start_frame": 4,
             "end_frame": 13, "frames": 10, "events": [_EV]}]
    gp = str(tmp_path / "segs.json")
    with open(gp, "w") as f:
        json.dump(segs, f)
    out = str(tmp_path / "r.html")
    assert report_main(["--stats-json", sp, "--segments-json", gp,
                        "-o", out]) == 0
    doc = open(out).read()
    assert "cam.event000_f4.avi" in doc
    assert "10 of 20 frames stored (50.0%)" in doc


def test_report_segments_bad_shape_errors_cleanly(tmp_path, capsys):
    """Review regression: a dict-shaped (or corrupt) segments JSON must
    produce the clean error contract, not an AttributeError traceback."""
    sp = str(tmp_path / "s.json")
    _write_stats(sp)
    gp = str(tmp_path / "segs.json")
    with open(gp, "w") as f:
        json.dump({"cam": []}, f)  # the --events-json dict shape
    rc = report_main(["--stats-json", sp, "--segments-json", gp,
                      "-o", str(tmp_path / "r.html")])
    assert rc == 1
    assert "LIST of segment objects" in capsys.readouterr().err
    with open(gp, "w") as f:  # markup smuggled into a numeric field
        json.dump([{"path": "x", "start_frame": "<img>", "end_frame": 1,
                    "frames": 1}], f)
    rc = report_main(["--stats-json", sp, "--segments-json", gp,
                      "-o", str(tmp_path / "r.html")])
    assert rc == 1 and "error:" in capsys.readouterr().err


def test_report_embeds_flicker_map(tmp_path):
    sp = str(tmp_path / "s.json")
    _write_stats(sp)
    fp = str(tmp_path / "flicker.png")
    with open(fp, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\nfakepng")
    from dips.report import main as report_main
    out = str(tmp_path / "r.html")
    rc = report_main(["--stats-json", sp, "--flicker", fp, "-o", out])
    assert rc == 0
    doc = open(out).read()
    assert "Flicker amplitude map" in doc and "flicker map" in doc
