"""End-to-end parity: DiPsEngine (XLA batched path) vs the streaming oracle.

Quantized uint8 outputs must agree exactly for pure min/max/absdiff math and
within 1 LSB for transcendental filters (XLA exp/log differ from numpy by
ulps); stats agree to float tolerance.
"""

import numpy as np
import pytest

from dips.models import DiPsEngine
from dips.ops.oracle import DiPsOracle
from dips.properties import (ChromaFilter, DiPsFilter, DiPsMethod,
                             DiPsProperties, OutputMode)
from tests.conftest import make_clip


def run_both(props, frames, batch=5):
    o = DiPsOracle(props)
    exp_out, exp_stats = o.run(frames)
    eng = DiPsEngine(props, frames.shape[1], frames.shape[2], batch=batch)
    got_out, got_stats = eng.process_frames(list(frames))
    if exp_out.ndim == 3:  # oracle single-plane modes -> add channel axis
        exp_out = exp_out[..., None]
    return exp_out, exp_stats, got_out, got_stats


def assert_close(exp_out, exp_stats, got_out, got_stats, exact, npix):
    """Parity contract: integer (absdiff/threshold) paths are bit-exact;
    f32 emphasis paths are within 1 LSB post-quantization (XLA legitimately
    fuses FMAs / distributes constant multiplies, so equal inputs can drift
    by 1 ulp and flip a x.5 rounding tie — SURVEY.md §7 'uint8 fidelity')."""
    assert got_out.shape == exp_out.shape
    if got_out.size:  # emit_maps=False: zero-channel maps, shape-only
        diff = np.abs(got_out.astype(np.int16) - exp_out.astype(np.int16))
        assert diff.max() <= 1, f"u8 mismatch > 1 LSB (max {diff.max()})"
        if exact:  # min/max-only math: no ties unless values collide
            frac = (diff != 0).mean()
            assert frac <= 0.5, f"excessive tie flips ({frac:.2%})"
    np.testing.assert_allclose(got_stats[:, :3], exp_stats[:, :3],
                               atol=1e-5, rtol=1e-4)
    # changed-pixel counts may flip on knife-edge pixels only
    assert np.abs(got_stats[:, 3] - exp_stats[:, 3]).max() <= 0.01 * npix


CASES = [
    # (method, output, filter, window, temporal, chroma, exact)
    (DiPsMethod.OVERALL, OutputMode.COLORIZE, DiPsFilter.UNFILTERED, 3, 4,
     ChromaFilter.ALL, True),
    (DiPsMethod.OVERALL, OutputMode.COLORIZE, DiPsFilter.SIGMOID, 3, 4,
     ChromaFilter.ALL, False),
    (DiPsMethod.OVERALL, OutputMode.GRAYSCALE, DiPsFilter.INVERSE_SIGMOID, 1,
     2, ChromaFilter.RED, False),
    (DiPsMethod.PER_FRAME, OutputMode.COLORIZE, DiPsFilter.SIGMOID, 5, 3,
     ChromaFilter.ALL, False),
    (DiPsMethod.PER_FRAME, OutputMode.GRAYSCALE, DiPsFilter.UNFILTERED, 1, 1,
     ChromaFilter.GREEN, True),
    (DiPsMethod.OVERALL, OutputMode.COLORIZE, DiPsFilter.UNFILTERED, 7, 4,
     ChromaFilter.BLUE, True),
]


@pytest.mark.parametrize(
    "method,output,filt,window,temporal,chroma,exact", CASES)
def test_engine_matches_oracle(method, output, filt, window, temporal,
                               chroma, exact, clip):
    props = DiPsProperties(method=method, output=output, filter=filt,
                           window_size=window, temporal_size=temporal,
                           chroma=chroma)
    exp_out, exp_stats, got_out, got_stats = run_both(props, clip)
    assert_close(exp_out, exp_stats, got_out, got_stats, exact,
                 clip.shape[1] * clip.shape[2])


@pytest.mark.parametrize("method", [DiPsMethod.OVERALL, DiPsMethod.PER_FRAME])
@pytest.mark.parametrize("output",
                         [OutputMode.ABSDIFF, OutputMode.THRESHOLD])
def test_raw_modes_bit_exact(method, output, clip):
    props = DiPsProperties(method=method, output=output, change_threshold=25)
    exp_out, exp_stats, got_out, got_stats = run_both(props, clip)
    np.testing.assert_array_equal(got_out, exp_out)
    np.testing.assert_allclose(got_stats, exp_stats, atol=1e-5, rtol=1e-4)


def test_refresh_markers_and_partial_batches(clip):
    props = DiPsProperties(refresh_markers=(4, 7), window_size=3,
                           filter=DiPsFilter.UNFILTERED)
    exp_out, exp_stats, got_out, got_stats = run_both(props, clip, batch=3)
    assert_close(exp_out, exp_stats, got_out, got_stats, True,
                 clip.shape[1] * clip.shape[2])


def test_odd_geometry_padding():
    """Non-tile-aligned W exercises the validity mask."""
    frames = make_clip(n=7, h=13, w=37, seed=3)
    props = DiPsProperties(window_size=3, filter=DiPsFilter.UNFILTERED)
    exp_out, exp_stats, got_out, got_stats = run_both(props, frames, batch=4)
    assert_close(exp_out, exp_stats, got_out, got_stats, True, 13 * 37)


def test_checkpoint_resume(clip):
    props = DiPsProperties(window_size=3, filter=DiPsFilter.UNFILTERED)
    eng = DiPsEngine(props, clip.shape[1], clip.shape[2], batch=4)
    out_a, stats_a = eng.process_frames(list(clip[:6]))
    state = eng.state_dict()

    eng2 = DiPsEngine(props, clip.shape[1], clip.shape[2], batch=4)
    eng2.load_state_dict(state)
    out_b, stats_b = eng2.process_frames(list(clip[6:]))

    eng3 = DiPsEngine(props, clip.shape[1], clip.shape[2], batch=4)
    out_full, stats_full = eng3.process_frames(list(clip))
    np.testing.assert_array_equal(np.concatenate([out_a, out_b]), out_full)
    np.testing.assert_allclose(np.concatenate([stats_a, stats_b]), stats_full,
                               atol=1e-6)


def test_forced_snapshot(clip):
    props = DiPsProperties(window_size=1, filter=DiPsFilter.UNFILTERED)
    eng = DiPsEngine(props, clip.shape[1], clip.shape[2], batch=4)
    eng.process_frames(list(clip[:4]))
    eng.snapshot()  # the GUI SnapShot button semantics
    out, stats = eng.process_batch(list(clip[4:6]))
    assert stats[0, 1] == 0  # frame 4 became a capture -> zero diff


def test_load_cancels_pending_snapshot(clip):
    """Code-review regression (mirrors the MultiStreamEngine fix): a
    snapshot requested before a checkpoint restore must not fire after it
    and overwrite the restored baseline."""
    props = DiPsProperties(window_size=3, filter=DiPsFilter.UNFILTERED)
    eng = DiPsEngine(props, clip.shape[1], clip.shape[2], batch=4)
    eng.process_frames(list(clip[:6]))
    state = eng.state_dict()

    eng2 = DiPsEngine(props, clip.shape[1], clip.shape[2], batch=4)
    eng2.process_frames(list(clip[:2]))
    eng2.snapshot()          # requested, then superseded by the restore
    eng2.load_state_dict(state)
    out_b, stats_b = eng2.process_frames(list(clip[6:]))
    out_cont, stats_cont = eng.process_frames(list(clip[6:]))
    np.testing.assert_array_equal(out_b, out_cont)
    np.testing.assert_allclose(stats_b, stats_cont, atol=1e-6)

def test_checkpoint_to_disk(clip, tmp_path):
    """Crash/preemption recovery: save to a file mid-stream, resume in a
    fresh engine, outputs must equal an uninterrupted run."""
    props = DiPsProperties(window_size=3, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED)
    h, w = clip.shape[1], clip.shape[2]
    eng = DiPsEngine(props, h, w, batch=4)
    out_a, _ = eng.process_frames(list(clip[:7]))
    ckpt = str(tmp_path / "state.npz")
    eng.save(ckpt)

    eng2 = DiPsEngine(props, h, w, batch=4)
    eng2.load(ckpt)
    out_b, _ = eng2.process_frames(list(clip[7:]))

    eng3 = DiPsEngine(props, h, w, batch=4)
    out_full, _ = eng3.process_frames(list(clip))
    np.testing.assert_array_equal(np.concatenate([out_a, out_b]), out_full)
    np.testing.assert_allclose(eng2.heatmap(), eng3.heatmap(), atol=1e-6)


def test_engine_reset(clip):
    props = DiPsProperties(window_size=1, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED)
    h, w = clip.shape[1], clip.shape[2]
    eng = DiPsEngine(props, h, w, batch=4)
    a, sa = eng.process_frames(list(clip))
    eng.reset()
    assert eng.frame_index == 0 and eng.heatmap().max() == 0
    b, sb = eng.process_frames(list(clip))
    np.testing.assert_array_equal(a, b)  # reset == fresh engine
    np.testing.assert_allclose(sa, sb, atol=1e-6)


def test_backend_auto_resolution():
    """Every backend runs the one XLA step: median modes compile
    ``reference.batch_step``, raw modes ``reference.absdiff_step``."""
    from dips.ops import reference
    assert DiPsEngine(DiPsProperties(), 8, 16)._step is reference.batch_step
    raw = DiPsProperties(output=OutputMode.ABSDIFF)
    assert DiPsEngine(raw, 8, 16)._step is reference.absdiff_step
    with pytest.raises(TypeError):
        DiPsEngine(DiPsProperties(), 8, 16, backend="xla")


def test_process_frames_empty():
    eng = DiPsEngine(DiPsProperties(), 8, 16, batch=2)
    out, stats = eng.process_frames([])
    assert out.shape == (0, 8, 16, 3) and stats.shape == (0, 4)


def test_checkpoint_mode_mismatch_rejected(tmp_path):
    """A raw-mode checkpoint (u8 (3,Hp,Wp) baseline) must be rejected by a
    median-mode engine at load time, not fail opaquely inside jit later."""
    raw_eng = DiPsEngine(DiPsProperties(output=OutputMode.ABSDIFF,
                                        temporal_size=1), 8, 16, batch=2)
    raw_eng.process_batch([make_clip(n=1, h=8, w=16)[0]])
    p = str(tmp_path / "raw.npz")
    raw_eng.save(p)
    med_eng = DiPsEngine(DiPsProperties(), 8, 16, batch=2)
    with pytest.raises(ValueError, match="baseline shape"):
        med_eng.load(p)


@pytest.mark.parametrize("method,window",
                         [(DiPsMethod.OVERALL, 3), (DiPsMethod.PER_FRAME, 3),
                          (DiPsMethod.OVERALL, 1)])
def test_hwc_input_layout_bit_exact(method, window):
    """input_layout='hwc' (device-side transpose+pad) matches the host
    planarize path bit-for-bit in every mode, including partial batches,
    refresh markers and a forced snapshot."""
    props = DiPsProperties(window_size=window, temporal_size=2,
                           method=method, filter=DiPsFilter.UNFILTERED,
                           refresh_markers=(5,))
    h, w = 20, 44
    clip = make_clip(n=9, h=h, w=w, seed=31)
    kw = dict(batch=4)
    ep = DiPsEngine(props, h, w, input_layout="planar", **kw)
    eh = DiPsEngine(props, h, w, input_layout="hwc", **kw)
    for lo, hi in ((0, 4), (4, 7), (7, 9)):  # full + two partial batches
        op, sp = ep.process_batch(list(clip[lo:hi]))
        oh, sh = eh.process_batch(list(clip[lo:hi]))
        np.testing.assert_array_equal(oh, op)
        np.testing.assert_allclose(sh, sp, atol=1e-6)
    ep.snapshot()
    eh.snapshot()
    op, _ = ep.process_batch([clip[0]])
    oh, _ = eh.process_batch([clip[0]])
    np.testing.assert_array_equal(oh, op)


def test_hwc_checkpoint_interops_with_planar(tmp_path):
    """hwc engines keep planar-format checkpoints: save on hwc, resume on
    a planar engine (and back) bit-identically."""
    props = DiPsProperties(window_size=1, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED)
    h, w = 16, 24
    clip = make_clip(n=9, h=h, w=w, seed=32)
    eh = DiPsEngine(props, h, w, batch=3, input_layout="hwc")
    eh.process_frames(list(clip[:3]))
    path = str(tmp_path / "hwc.npz")
    eh.save(path)
    ep = DiPsEngine(props, h, w, batch=3)
    ep.load(path)
    out_p, _ = ep.process_frames(list(clip[3:6]))
    out_h, _ = eh.process_frames(list(clip[3:6]))
    np.testing.assert_array_equal(out_p, out_h)
    # and back onto an hwc engine
    ep.save(path)
    eh2 = DiPsEngine(props, h, w, batch=3, input_layout="hwc")
    eh2.load(path)
    out_a, _ = eh2.process_frames(list(clip[6:9]))
    out_b, _ = ep.process_frames(list(clip[6:9]))
    np.testing.assert_array_equal(out_a, out_b)


def test_hwc_rejects_planar_entry_points():
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    eng = DiPsEngine(props, 16, 24, batch=2, input_layout="hwc")
    assert eng.tail_rows == 0
    assert eng.new_batch_buffer().shape == (2, 16, 24, 3)
    with pytest.raises(ValueError, match="hwc"):
        eng.process_planar([np.zeros((3, 16, 128), np.uint8)])
    with pytest.raises(ValueError):
        eng.process_batch([np.zeros((4, 4, 3), np.uint8)])
    with pytest.raises(ValueError, match="input_layout"):
        DiPsEngine(props, 16, 24, input_layout="chw")


def test_hwc_bgr_layout_accepts_cv2_frames():
    """input_layout='hwc_bgr' takes cv2's native BGR frames; the channel
    swap folds into the device transpose and checkpoints stay RGB-planar."""
    props = DiPsProperties(window_size=3, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED)
    h, w = 16, 24
    clip = make_clip(n=5, h=h, w=w, seed=33)
    ep = DiPsEngine(props, h, w, batch=2)
    eb = DiPsEngine(props, h, w, batch=2, input_layout="hwc_bgr")
    op, sp = ep.process_frames(list(clip))
    ob, sb = eb.process_frames([f[:, :, ::-1] for f in clip])  # BGR feed
    np.testing.assert_array_equal(ob, op)
    np.testing.assert_allclose(sb, sp, atol=1e-6)
    # checkpoint tails are RGB planes either way
    np.testing.assert_array_equal(eb.state_dict()["tail"],
                                  ep.state_dict()["tail"])


def test_checkpoint_geometry_recorded_and_validated(tmp_path):
    """Checkpoints carry the TRUE geometry: loading into an engine of a
    different resolution fails even when both pad to the same tile shape
    (12x40 and 16x64 both pad to 16x128)."""
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    clip = make_clip(n=2, h=12, w=40, seed=34)
    eng = DiPsEngine(props, 12, 40, batch=2)
    eng.process_frames(list(clip))
    path = str(tmp_path / "g.npz")
    eng.save(path)
    import numpy as _np
    assert list(_np.load(path)["geometry"]) == [12, 40]
    with pytest.raises(ValueError, match="geometry"):
        DiPsEngine(props, 16, 64, batch=2).load(path)
