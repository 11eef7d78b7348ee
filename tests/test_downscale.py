"""On-device input decimation (``downscale``): device pool vs host twin,
engine equivalence vs pre-pooled frames, and the streaming/CLI surface."""

import numpy as np
import pytest

from dips.models import DiPsEngine
from dips.ops import reference
from dips.properties import (DiPsFilter, DiPsMethod, DiPsProperties,
                             OutputMode)


@pytest.mark.parametrize("k", [2, 3, 4])
def test_device_pool_matches_host_twin(k):
    """The layout prep's k x k decimation must be BIT-identical to
    pool_frame_host (checkpoint tails depend on it)."""
    import jax.numpy as jnp
    r = np.random.default_rng(k)
    h, w = 24 * k, 36 * k
    frame = r.integers(0, 256, (h, w, 3), np.uint8)
    hp, wp = reference.pad_geometry(h // k, w // k)
    _, _, prep = reference.make_layout_prep("hwc", h // k, w // k, hp, wp,
                                            downscale=k)
    dev = np.asarray(prep(jnp.asarray(frame[None])))[0]
    host = reference.pool_frame_host(frame, k)
    np.testing.assert_array_equal(
        dev[:, :h // k, :w // k], np.moveaxis(host, -1, 0))


def test_pool_host_exact_means():
    """Box mean with round-half-even on a hand-computable case."""
    f = np.zeros((2, 2, 3), np.uint8)
    f[..., 0] = [[10, 20], [30, 40]]          # mean 25
    f[..., 1] = [[1, 0], [0, 0]]              # mean 0.25 -> 0
    f[..., 2] = [[1, 1], [0, 0]]              # mean 0.5 -> 0 (half-to-even)
    out = reference.pool_frame_host(f, 2)
    assert out.shape == (1, 1, 3)
    assert list(out[0, 0]) == [25, 0, 0]


@pytest.mark.parametrize("method", [DiPsMethod.OVERALL,
                                    DiPsMethod.PER_FRAME])
def test_downscale_engine_equals_pre_pooled(method):
    """A downscale-k engine fed full-res frames must match a plain engine
    fed host-pooled frames bit-for-bit (the decimation is the only
    difference, and its two implementations are twins)."""
    k = 2
    r = np.random.default_rng(0)
    clip = r.integers(0, 256, (6, 32, 48, 3), np.uint8)
    props = DiPsProperties(window_size=3, temporal_size=2, method=method,
                           filter=DiPsFilter.UNFILTERED)
    eng_k = DiPsEngine(props, 32, 48, batch=3, downscale=k)
    assert (eng_k.height, eng_k.width) == (16, 24)
    assert (eng_k.in_height, eng_k.in_width) == (32, 48)
    eng_1 = DiPsEngine(props, 16, 24, batch=3)
    pooled = [reference.pool_frame_host(f, k) for f in clip]
    out_k, stats_k = eng_k.process_frames(list(clip))
    out_1, stats_1 = eng_1.process_frames(pooled)
    np.testing.assert_array_equal(out_k, out_1)
    np.testing.assert_allclose(stats_k, stats_1, atol=1e-6)


def test_downscale_checkpoint_roundtrip(tmp_path):
    """Checkpoints live at the analysis geometry: a downscale engine's
    state restores into another downscale engine and the streams agree."""
    k = 2
    r = np.random.default_rng(1)
    clip = r.integers(0, 256, (8, 16, 32, 3), np.uint8)
    props = DiPsProperties(window_size=3, temporal_size=2)
    a = DiPsEngine(props, 16, 32, batch=4, downscale=k)
    a.process_frames(list(clip[:4]))
    p = str(tmp_path / "ck.npz")
    a.save(p)
    b = DiPsEngine(props, 16, 32, batch=4, downscale=k)
    b.load(p)
    oa, sa = a.process_frames(list(clip[4:]))
    ob, sb = b.process_frames(list(clip[4:]))
    np.testing.assert_array_equal(oa, ob)
    np.testing.assert_allclose(sa, sb, atol=1e-6)


def test_downscale_validation():
    props = DiPsProperties()
    with pytest.raises(ValueError):
        DiPsEngine(props, 30, 40, downscale=4)   # 30 % 4 != 0
    with pytest.raises(ValueError):
        DiPsEngine(props, 32, 40, downscale=0)
    with pytest.raises(ValueError):
        # explicit planar layout cannot host the device decimation
        reference.make_layout_prep("planar", 16, 20, 16, 128, downscale=2)


def test_downscale_roi_and_heatmap_at_analysis_geometry():
    """roi/heatmap/stats follow the decimated geometry."""
    r = np.random.default_rng(2)
    clip = r.integers(0, 256, (4, 32, 64, 3), np.uint8)
    props = DiPsProperties(output=OutputMode.ABSDIFF, temporal_size=2,
                           roi=(2, 4, 14, 28))  # fits 16x32, not centered
    eng = DiPsEngine(props, 32, 64, batch=4, downscale=2)
    outs, stats = eng.process_frames(list(clip))
    assert outs.shape == (4, 16, 32, 3)
    assert eng.heatmap().shape == (16, 32)
    assert eng.analysis_pixels == 12 * 24


def test_stream_dips_downscale(tmp_path):
    """The streaming loop decodes full-res and yields decimated maps; the
    written video is at the analysis geometry."""
    import cv2
    from dips.app import DiPsJob, perform_dips
    path = str(tmp_path / "in.avi")
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 30,
                         (64, 32))
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (32, 64, 3), np.uint8)
    for i in range(10):
        f = base.copy()
        f[4:12, (4 + 4 * i) % 48:(4 + 4 * i) % 48 + 8] = (0, 255, 0)
        wr.write(f)
    wr.release()
    out = str(tmp_path / "out.avi")
    job = DiPsJob(properties=DiPsProperties(temporal_size=2),
                  video_path=path, output_path=out, batch=4,
                  downscale=2)
    stats = perform_dips(job)
    assert stats.shape[0] == 10
    cap = cv2.VideoCapture(out)
    assert (int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))) == (32, 16)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    assert n == 10
    assert job.frame_geometry == (16, 32)


def test_cli_downscale(tmp_path):
    import cv2
    from dips.cli import main
    path = str(tmp_path / "in.avi")
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 30,
                         (64, 32))
    rng = np.random.default_rng(1)
    for _ in range(6):
        wr.write(rng.integers(0, 256, (32, 64, 3), np.uint8))
    wr.release()
    out = str(tmp_path / "out.avi")
    assert main([f"--input={path}", f"--output={out}", "--downscale=2",
                 "--temporal=2", "--batch=3"]) == 0
    cap = cv2.VideoCapture(out)
    assert int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)) == 32
    cap.release()
    # downscale outside the single-run mode is rejected
    assert main([f"--input={path}", "--thumbnail",
                 str(tmp_path / "t.png"), "--downscale=2"]) == 2


def test_multistream_downscale_matches_single():
    """MultiStreamEngine(downscale=k) must equal per-stream DiPsEngine
    downscale runs (the serving coalescer's decimation path)."""
    from dips.parallel import MultiStreamEngine, stream_mesh
    k = 2
    r = np.random.default_rng(3)
    clips = [r.integers(0, 256, (5, 16, 32, 3), np.uint8) for _ in range(2)]
    props = DiPsProperties(window_size=3, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED)
    ms = MultiStreamEngine(props, 16, 32, n_streams=2, batch=5,
                           mesh=stream_mesh(1), downscale=k)
    assert (ms.height, ms.width) == (8, 16)
    out, stats, _ = ms.process_batch([list(c) for c in clips])
    for si, clip in enumerate(clips):
        eng = DiPsEngine(props, 16, 32, batch=5, downscale=k)
        eo, es = eng.process_frames(list(clip))
        np.testing.assert_array_equal(out[si], eo)
        np.testing.assert_allclose(stats[si], es, atol=1e-6)


def test_cli_inputs_downscale(tmp_path):
    """--inputs batch mode composes with --downscale (decimated outputs
    per stream)."""
    import cv2
    from dips.cli import main
    paths = []
    rng = np.random.default_rng(4)
    for s in range(2):
        p = str(tmp_path / f"cam{s}.avi")
        wr = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"MJPG"), 30,
                             (32, 16))
        for _ in range(5):
            wr.write(rng.integers(0, 256, (16, 32, 3), np.uint8))
        wr.release()
        paths.append(p)
    outd = str(tmp_path / "out")
    assert main(["--inputs", *paths, f"--output-dir={outd}",
                 "--downscale=2", "--temporal=2", "--batch=5"]) == 0
    import os
    outs = sorted(os.listdir(outd))
    assert len(outs) == 2
    cap = cv2.VideoCapture(os.path.join(outd, outs[0]))
    assert (int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))) == (16, 8)
    cap.release()
