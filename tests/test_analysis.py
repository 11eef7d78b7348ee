"""Analysis ops (temporal DFT, FFT denoise) and heatmap accumulation."""

import numpy as np
import pytest

from dips.models import DiPsEngine
from dips.ops import analysis
from dips.ops.oracle import DiPsOracle
from dips.properties import DiPsFilter, DiPsMethod, DiPsProperties, OutputMode
from tests.conftest import make_clip


def test_temporal_dft_matches_numpy():
    r = np.random.default_rng(0)
    traces = r.standard_normal((16, 6, 7)).astype(np.float32)
    mag, phase = analysis.temporal_dft(traces)
    f = np.fft.rfft(traces, axis=0)
    np.testing.assert_allclose(np.asarray(mag), np.abs(f), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(phase), np.angle(f), rtol=1e-3,
                               atol=1e-3)


def test_temporal_dft_reference_vector():
    """The reference's dft.py analyses [0, 1, 0, -1]: energy only at k=1."""
    mag, _ = analysis.temporal_dft(np.array([0., 1., 0., -1.], np.float32))
    np.testing.assert_allclose(np.asarray(mag), [0.0, 2.0, 0.0], atol=1e-5)


def test_fft_denoise_matches_reference_recipe():
    r = np.random.default_rng(1)
    img = r.integers(0, 256, (64, 80)).astype(np.float32)
    radius = 10
    got = np.asarray(analysis.fft_denoise(img, radius))
    # the reference recipe in numpy (image_denoise.py:13-30)
    f = np.fft.fftshift(np.fft.fft2(img))
    rows, cols = img.shape
    mask = np.zeros_like(img)
    mask[rows // 2 - radius:rows // 2 + radius,
         cols // 2 - radius:cols // 2 + radius] = 1
    exp = np.abs(np.fft.ifft2(np.fft.ifftshift(f * mask)))
    np.testing.assert_allclose(got, exp, rtol=1e-3, atol=1e-2)


def test_fft_denoise_removes_high_frequency():
    x = np.zeros((64, 64), np.float32)
    x += np.sin(np.arange(64) * np.pi)[None, :] * 50  # checkerboard columns
    x += 100.0
    out = np.asarray(analysis.fft_denoise(x, radius=4))
    assert np.abs(out - 100.0).max() < 1.0  # high-freq stripe removed


@pytest.mark.parametrize("output",
                         [OutputMode.COLORIZE, OutputMode.ABSDIFF])
def test_engine_heatmap_matches_oracle(output, clip):
    props = DiPsProperties(output=output, window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    o = DiPsOracle(props)
    o.run(clip)
    eng = DiPsEngine(props, clip.shape[1], clip.shape[2], batch=5)
    eng.process_frames(list(clip))
    np.testing.assert_allclose(eng.heatmap(), o.heatmap, atol=1e-5)
    assert eng.heatmap().max() > 0  # the moving square left a trail


def test_median_heatmap_matches_oracle(clip):
    props = DiPsProperties(window_size=3, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED)
    o = DiPsOracle(props)
    o.run(clip)
    eng = DiPsEngine(props, clip.shape[1], clip.shape[2], batch=5)
    eng.process_frames(list(clip))
    np.testing.assert_allclose(eng.heatmap(), o.heatmap, atol=1e-5)


def test_denoise_frames_batched(rng):
    frames = rng.integers(0, 256, (3, 24, 32, 3), np.uint8)
    out = np.asarray(analysis.denoise_frames(frames, 6))
    assert out.shape == frames.shape and out.dtype == np.uint8
    # low-pass: variance must drop
    assert out.std() < frames.std()


def test_cli_denoise_and_dft(tmp_path, capsys):
    import json
    from dips.cli import main as cli_main
    from dips.io import moving_square_clip, write_clip
    path = str(tmp_path / "in.avi")
    write_clip(moving_square_clip(n=8, height=32, width=48), path)
    dft = str(tmp_path / "dft.json")
    rc = cli_main(["--input", path, "--output", str(tmp_path / "o.avi"),
                   "--temporal=2", "--batch=4", "--denoise", "8",
                   "--dft-json", dft])
    assert rc == 0
    d = json.load(open(dft))
    assert len(d["magnitude"]) == 8 // 2 + 1


# -- FlickerAnalyzer (streaming per-pixel temporal-frequency map) ----------

def _np_flicker_power(frames, freq_hz, fps, tau, chroma="all"):
    """float32 mirror of ops/analysis._flicker_update + power()."""
    import math
    omega = 2.0 * math.pi * freq_hz / fps
    alpha = np.float32(math.exp(-1.0 / tau))
    cw, sw = np.float32(math.cos(omega)), np.float32(math.sin(omega))
    h, w = frames.shape[1:3]
    zr = np.zeros((h, w), np.float32)
    zi = np.zeros((h, w), np.float32)
    m = np.zeros((h, w), np.float32)
    c, s, bias = np.float32(1.0), np.float32(0.0), np.float32(1.0)
    k = np.float32(1.0) - alpha
    for fr in frames:
        f = fr.astype(np.int32)
        if chroma == "all":
            x = (f.max(axis=-1) + f.min(axis=-1)).astype(np.float32)
        else:
            x = (2 * f[..., {"r": 0, "g": 1, "b": 2}[chroma]]
                 ).astype(np.float32)
        m = alpha * m + k * x
        bias = bias * alpha
        centered = x - m / max(np.float32(1.0) - bias, np.float32(1e-12))
        zr = alpha * zr + k * centered * c
        zi = alpha * zi - k * centered * s
        c2, s2 = c * cw - s * sw, s * cw + c * sw
        n = np.float32(1.0) / np.sqrt(c2 * c2 + s2 * s2)
        c, s = c2 * n, s2 * n
    corr = max(1e-12, 1.0 - float(bias))
    return 4.0 * (zr.astype(np.float64) ** 2 + zi ** 2) / (corr * corr)


def _blink_clip(n, h, w, fps, freq_a, freq_b, seed=0):
    """Gray clip: region A blinks sinusoidally at freq_a, B at freq_b."""
    import math
    r = np.random.default_rng(seed)
    base = r.integers(90, 110, (h, w, 3)).astype(np.float32)
    frames = np.empty((n, h, w, 3), np.uint8)
    t = np.arange(n) / fps
    for i in range(n):
        f = base.copy()
        f[2:6, 2:8] += 80.0 * math.cos(2 * math.pi * freq_a * t[i])
        f[8:12, 10:16] += 80.0 * math.cos(2 * math.pi * freq_b * t[i])
        frames[i] = np.clip(np.rint(f), 0, 255).astype(np.uint8)
    return frames


def test_flicker_matches_numpy_oracle(rng):
    frames = rng.integers(0, 256, (37, 10, 12, 3), np.uint8)
    fa = analysis.FlickerAnalyzer(5.0, 24.0, tau_frames=8.0, batch=16)
    fa.update(frames)
    got = fa.power()
    want = _np_flicker_power(frames, 5.0, 24.0, 8.0)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-3)
    assert fa.frames_seen == 37


def test_flicker_chroma_channels(rng):
    from dips.properties import ChromaFilter
    frames = rng.integers(0, 256, (20, 6, 8, 3), np.uint8)
    for cf, key in ((ChromaFilter.RED, "r"), (ChromaFilter.GREEN, "g"),
                    (ChromaFilter.BLUE, "b")):
        fa = analysis.FlickerAnalyzer(3.0, 20.0, tau_frames=6.0,
                                      chroma=cf, batch=8)
        fa.update(frames)
        np.testing.assert_allclose(
            fa.power(), _np_flicker_power(frames, 3.0, 20.0, 6.0, key),
            rtol=2e-3, atol=1e-3)


def test_flicker_separates_frequencies():
    fps, n = 24.0, 240
    frames = _blink_clip(n, 16, 20, fps, freq_a=6.0, freq_b=2.0)
    fa = analysis.FlickerAnalyzer(6.0, fps, tau_frames=48.0)
    fa.update(frames)
    amp = fa.amplitude()
    in_a = amp[2:6, 2:8].mean()
    in_b = amp[8:12, 10:16].mean()
    bg = np.delete(amp.reshape(-1),
                   np.ravel_multi_index(
                       np.mgrid[2:12, 2:16].reshape(2, -1),
                       amp.shape)).mean()
    assert in_a > 5 * in_b, (in_a, in_b)
    assert in_a > 10 * bg, (in_a, bg)
    # the 2 Hz analyzer picks the other region
    fb = analysis.FlickerAnalyzer(2.0, fps)
    fb.update(frames)
    amp2 = fb.amplitude()
    assert amp2[8:12, 10:16].mean() > 5 * amp2[2:6, 2:8].mean()


def test_flicker_amplitude_recovery():
    """A pure intensity sinusoid A*cos reads back ~A (gray frames:
    lightness = 2*pixel value, so pixel swing 64 -> intensity A = 128)."""
    import math
    fps, n = 30.0, 600
    t = np.arange(n) / fps
    v = 128.0 + 64.0 * np.cos(2 * math.pi * 5.0 * t)
    frames = np.clip(np.rint(v), 0, 255).astype(np.uint8)
    frames = np.broadcast_to(frames[:, None, None, None],
                             (n, 4, 6, 3)).copy()
    fa = analysis.FlickerAnalyzer(5.0, fps, tau_frames=60.0)
    fa.update(frames)
    amp = fa.amplitude()
    np.testing.assert_allclose(amp, 128.0, rtol=0.05)
    # and a DC-only stream reads ~0
    fd = analysis.FlickerAnalyzer(5.0, fps, tau_frames=60.0)
    fd.update(np.full((300, 4, 6, 3), 128, np.uint8))
    assert fd.amplitude().max() < 2.0


def test_flicker_incremental_matches_bulk(rng):
    frames = rng.integers(0, 256, (23, 5, 7, 3), np.uint8)
    bulk = analysis.FlickerAnalyzer(4.0, 24.0, tau_frames=8.0, batch=8)
    bulk.update(frames)
    inc = analysis.FlickerAnalyzer(4.0, 24.0, tau_frames=8.0, batch=8)
    for fr in frames:
        inc.update(fr)  # single (H, W, 3) frames buffer then dispatch
    np.testing.assert_allclose(bulk.power(), inc.power(), rtol=1e-5)
    assert bulk.frames_seen == inc.frames_seen == 23


def test_flicker_reset_and_validation(rng):
    fa = analysis.FlickerAnalyzer(4.0, 24.0, batch=4)
    fa.update(rng.integers(0, 256, (6, 5, 7, 3), np.uint8))
    p1 = fa.power()
    fa.reset()
    assert fa.frames_seen == 0
    with pytest.raises(RuntimeError):
        analysis.FlickerAnalyzer(4.0, 24.0).power()  # no frames yet
    fa.update(rng.integers(0, 256, (6, 5, 7, 3), np.uint8))
    assert fa.power().shape == p1.shape
    with pytest.raises(ValueError):  # geometry change mid-stream
        fa.update(rng.integers(0, 256, (4, 6, 7, 3), np.uint8))
        fa.flush()
    with pytest.raises(ValueError):
        analysis.FlickerAnalyzer(0.0, 24.0)       # freq must be > 0
    with pytest.raises(ValueError):
        analysis.FlickerAnalyzer(12.0, 24.0)      # >= Nyquist
    with pytest.raises(ValueError):
        analysis.FlickerAnalyzer(4.0, 0.0)        # bad fps
    with pytest.raises(ValueError):
        analysis.FlickerAnalyzer(4.0, 24.0, tau_frames=1.0)
    with pytest.raises(ValueError):
        analysis.FlickerAnalyzer(4.0, 24.0).update(
            rng.standard_normal((3, 4, 5, 3)))    # not uint8


def test_cli_flicker(tmp_path, capsys):
    from dips.cli import main as cli_main
    from dips.io import write_clip
    fps = 24.0
    frames = _blink_clip(96, 16, 20, fps, freq_a=6.0, freq_b=2.0)
    path = str(tmp_path / "blink.avi")
    write_clip(frames, path, fps=fps)
    png = str(tmp_path / "flicker.png")
    rc = cli_main(["--input", path, "--output", str(tmp_path / "o.avi"),
                   "--temporal=2", "--batch=8",
                   "--flicker-hz", "6", "--flicker-png", png])
    assert rc == 0
    out = capsys.readouterr().out
    assert "flicker @ 6 Hz" in out and "peak amplitude" in out
    import os
    assert os.path.getsize(png) > 0
    # the reported peak must land inside the 6 Hz region (MJPG encoding
    # perturbs pixels, so parse the printed location)
    import re
    m = re.search(r"x=(\d+) y=(\d+)", out)
    assert m and 2 <= int(m.group(2)) < 6 and 2 <= int(m.group(1)) < 8, out


def test_cli_flicker_flag_gating(tmp_path, capsys):
    from dips.cli import main as cli_main
    rc = cli_main(["--input", "a.avi", "--output", "b.avi",
                   "--flicker-png", str(tmp_path / "x.png")])
    assert rc == 2 and "--flicker-hz" in capsys.readouterr().err
    rc = cli_main(["--live", "--flicker-hz", "5"])
    assert rc == 2 and "--flicker-hz" in capsys.readouterr().err
    # frequency above the clip's Nyquist rate is a user error, not a crash
    from dips.io import moving_square_clip, write_clip
    path = str(tmp_path / "in.avi")
    write_clip(moving_square_clip(n=6, height=16, width=20), path, fps=10.0)
    rc = cli_main(["--input", path, "--output", str(tmp_path / "o.avi"),
                   "--flicker-hz", "50"])
    assert rc == 1 and "resolvable" in capsys.readouterr().err


def test_flicker_geometry_mismatch_is_loud_and_lossless(rng):
    """A mid-stream geometry change raises the analyzer's own error BEFORE
    any buffered frame is consumed — nothing silently vanishes."""
    fa = analysis.FlickerAnalyzer(4.0, 24.0, batch=4)
    fa.update(rng.integers(0, 256, (2, 5, 7, 3), np.uint8))  # buffered
    with pytest.raises(ValueError, match="analyzer geometry"):
        fa.update(rng.integers(0, 256, (2, 6, 7, 3), np.uint8))
    # the two good frames are still pending; feeding two more dispatches
    fa.update(rng.integers(0, 256, (2, 5, 7, 3), np.uint8))
    assert fa.frames_seen == 4
    # even before ANY dispatch the first frame pins the geometry
    fb = analysis.FlickerAnalyzer(4.0, 24.0, batch=16)
    fb.update(rng.integers(0, 256, (5, 7, 3), np.uint8))
    with pytest.raises(ValueError, match="analyzer geometry"):
        fb.update(rng.integers(0, 256, (6, 7, 3), np.uint8))


def test_flicker_flush_uses_single_frame_trace(rng, monkeypatch):
    """Mid-stream flushes dispatch remainders frame-by-frame: only the
    batch shape and N=1 ever reach the jitted update (a serving client
    polling the map must not trigger a compile per remainder size)."""
    fa = analysis.FlickerAnalyzer(4.0, 24.0, batch=8)
    sizes = []
    real = analysis._flicker_update

    def spy(chroma, state, frames, *a):
        sizes.append(int(frames.shape[0]))
        return real(chroma, state, frames, *a)

    monkeypatch.setattr(analysis, "_flicker_update", spy)
    fa.update(rng.integers(0, 256, (13, 4, 6, 3), np.uint8))
    fa.power()   # flushes the 5-frame remainder
    fa.update(rng.integers(0, 256, (3, 4, 6, 3), np.uint8))
    fa.power()
    assert set(sizes) <= {8, 1}, sizes
    assert fa.frames_seen == 16


def test_flicker_degenerate_tau_yields_zero_not_nan():
    """alpha at the float64 boundary (enormous tau / tiny freq) must read
    zero flicker, never 0/0 NaN planes; non-finite parameters are
    rejected outright."""
    fa = analysis.FlickerAnalyzer(1e-15, 30.0, batch=4)  # alpha == 1.0
    fa.update(np.full((8, 4, 6, 3), 128, np.uint8))
    p = fa.power()
    assert np.isfinite(p).all() and p.max() == 0.0
    with pytest.raises(ValueError):
        analysis.FlickerAnalyzer(5.0, 30.0, tau_frames=float("nan"))
    with pytest.raises(ValueError):
        analysis.FlickerAnalyzer(5.0, 30.0, tau_frames=float("inf"))
    with pytest.raises(ValueError):
        analysis.FlickerAnalyzer(5.0, float("inf"))
