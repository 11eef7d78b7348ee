"""Multi-stream sharding over the virtual 8-device CPU mesh."""

import numpy as np
import jax
import pytest

from dips.parallel import MultiStreamEngine, make_sharded_step, stream_mesh
from dips.models import DiPsEngine
from dips.ops.oracle import DiPsOracle
from dips.properties import DiPsFilter, DiPsProperties, OutputMode
from tests.conftest import make_clip


def test_mesh_uses_all_devices():
    mesh = stream_mesh()
    assert mesh.devices.size == 8  # conftest forces 8 virtual CPU devices


def test_sharded_matches_single_stream():
    """8 streams sharded over 8 devices == 8 independent single-stream runs."""
    props = DiPsProperties(window_size=3, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED)
    h, w = 12, 40
    clips = [make_clip(n=6, h=h, w=w, seed=s) for s in range(8)]

    ms = MultiStreamEngine(props, h, w, n_streams=8, batch=3)
    outs, stats, gmean = [], [], []
    for i in range(0, 6, 3):
        o, st, g = ms.process_batch([list(c[i:i + 3]) for c in clips])
        outs.append(o)
        stats.append(st)
        gmean.append(g)
    out = np.concatenate(outs, axis=1)
    stat = np.concatenate(stats, axis=1)

    for s, c in enumerate(clips):
        eng = DiPsEngine(props, h, w, batch=3)
        exp_out, exp_stats = eng.process_frames(list(c))
        np.testing.assert_array_equal(out[s], exp_out)
        np.testing.assert_allclose(stat[s], exp_stats, atol=1e-5)

    # the psum'd global mean matches the host-side mean of per-frame means
    np.testing.assert_allclose(gmean[-1], stat[:, 3:, 1].mean(), rtol=1e-5)


def test_stream_failure_isolation():
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    h, w = 8, 16
    clips = [make_clip(n=3, h=h, w=w, seed=s) for s in range(8)]
    bad = list(clips[3])
    bad[1] = np.zeros((4, 4, 3), np.uint8)  # wrong geometry mid-stream

    ms = MultiStreamEngine(props, h, w, n_streams=8, batch=3)
    feeds = [list(c) for c in clips]
    feeds[3] = bad
    out, stats, _ = ms.process_batch(feeds)
    assert 3 in ms.failed  # isolated, not raised
    assert out.shape[0] == 8  # siblings unaffected
    eng = DiPsEngine(props, h, w, batch=3)
    exp_out, _ = eng.process_frames(list(clips[0]))
    np.testing.assert_array_equal(out[0], exp_out)


def test_staggered_stream_start_uses_own_cursor():
    """A stream that joins late must capture its baseline on ITS first frame
    and fire refresh markers on its own index, not the global one."""
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED, refresh_markers=(2,))
    h, w = 8, 16
    clips = [make_clip(n=9, h=h, w=w, seed=s) for s in range(8)]
    ms = MultiStreamEngine(props, h, w, n_streams=8, batch=3)
    late = 7
    outs = {si: [] for si in range(8)}
    stats = {si: [] for si in range(8)}
    for step in range(3):
        feeds = []
        for si in range(8):
            if si == late:
                # joins one batch late, then feeds its clip from ITS frame 0
                fr = [] if step == 0 else list(clips[si][(step - 1) * 3:
                                                         step * 3])
            else:
                fr = list(clips[si][step * 3:(step + 1) * 3])
            feeds.append(fr)
        o, st, _ = ms.process_batch(feeds)
        for si in range(8):
            n = len(feeds[si])
            outs[si].append(o[si, :n])
            stats[si].append(st[si, :n])
    assert ms.frame_cursors[late] == 6 and ms.frame_cursors[0] == 9
    # the late stream's first 6 frames == an independent single-stream run
    eng = DiPsEngine(props, h, w, batch=3)
    exp_out, exp_stats = eng.process_frames(list(clips[late][:6]))
    np.testing.assert_array_equal(np.concatenate(outs[late]), exp_out)
    np.testing.assert_allclose(np.concatenate(stats[late]), exp_stats,
                               atol=1e-5)


def test_failed_stream_revive_and_reset():
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    h, w = 8, 16
    clips = [make_clip(n=9, h=h, w=w, seed=s) for s in range(8)]
    ms = MultiStreamEngine(props, h, w, n_streams=8, batch=3)
    ms.process_batch([list(c[:3]) for c in clips])

    feeds = [list(c[3:6]) for c in clips]
    feeds[2] = [np.zeros((2, 2, 3), np.uint8)]  # bad frame -> isolated
    ms.process_batch(feeds)
    assert 2 in ms.failed and ms.frame_cursors[2] == 3

    # while failed, its feeds are ignored entirely
    ms.process_batch([list(c[6:9]) for c in clips])
    assert ms.frame_cursors[2] == 3 and ms.frame_cursors[0] == 9

    # revive: continues from the old state (baseline + cursor preserved)
    ms.revive(2)
    assert 2 not in ms.failed
    out, st, _ = ms.process_batch(
        [list(c[6:9]) if si == 2 else [] for si, c in enumerate(clips)])
    assert ms.frame_cursors[2] == 6
    eng = DiPsEngine(props, h, w, batch=3)
    eng.process_frames(list(clips[2][:3]))
    exp_out, exp_stats = eng.process_batch(list(clips[2][6:9]))
    np.testing.assert_array_equal(out[2, :3], exp_out)
    np.testing.assert_allclose(st[2, :3], exp_stats, atol=1e-5)

    # reset_stream: restarts fresh — next frame is a capture again
    ms.reset_stream(2)
    assert ms.frame_cursors[2] == 0 and ms.heatmaps()[2].max() == 0
    out2, st2, _ = ms.process_batch(
        [[clips[2][0]] if si == 2 else [] for si in range(8)])
    assert st2[2, 0, 3] == 0  # capture frame: zero changed pixels
    # siblings untouched by the reset
    assert ms.frame_cursors[0] == 9


def test_global_mean_masks_invalid_slots():
    """ADVICE regression: the psum'd global mean must exclude padding-
    replicated slots of short streams and dead/failed streams entirely."""
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    h, w = 8, 16
    clips = [make_clip(n=3, h=h, w=w, seed=s) for s in range(8)]
    ms = MultiStreamEngine(props, h, w, n_streams=8, batch=3)
    feeds = [list(c) for c in clips]
    feeds[2] = feeds[2][:1]                       # short: 2 padded slots
    feeds[5] = [np.zeros((4, 4, 3), np.uint8)]    # bad geometry: failed
    out, stats, gmean = ms.process_batch(feeds)
    assert 5 in ms.failed
    valid_vals = []
    for si, f in enumerate(feeds):
        if si == 5:
            continue
        valid_vals.extend(stats[si, :len(f), 1])
    np.testing.assert_allclose(gmean, np.mean(valid_vals), rtol=1e-5)


def test_stream_count_validation():
    props = DiPsProperties()
    with pytest.raises(ValueError):
        MultiStreamEngine(props, 8, 16, n_streams=5, batch=2)


def test_sharded_step_matches_single_engines():
    """The vmapped step under shard_map over the 8-device mesh matches
    eight single-stream engines bit-for-bit."""
    props = DiPsProperties(window_size=3, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED)
    clips = [make_clip(n=2, h=12, w=40, seed=s) for s in range(8)]
    ms = MultiStreamEngine(props, 12, 40, n_streams=8, batch=2)
    out, stats, _ = ms.process_batch([list(c) for c in clips])
    for s, c in enumerate(clips):
        eo, es = DiPsEngine(props, 12, 40, batch=2).process_frames(list(c))
        np.testing.assert_array_equal(out[s], eo)
        np.testing.assert_allclose(stats[s], es, atol=1e-6)


def test_run_dips_on_files_cli(tmp_path, capsys):
    """Multi-video CLI: 3 videos of different lengths, outputs truncated per
    stream, single-stream parity for stream 0."""
    from dips.cli import main as cli_main
    from dips.io import VideoReader, moving_square_clip, write_clip
    lens = [10, 7, 5]
    paths = []
    clips = []
    for i, n in enumerate(lens):
        c = moving_square_clip(n=n, height=32, width=48, seed=i)
        p = str(tmp_path / f"v{i}.avi")
        write_clip(c, p, fps=10)
        paths.append(p)
        clips.append(c)
    outdir = str(tmp_path / "out")
    rc = cli_main(["--inputs", *paths, "--output-dir", outdir,
                   "--temporal=2", "--batch=3", "--filter=none"])
    assert rc == 0
    assert "3 streams" in capsys.readouterr().out
    for i, n in enumerate(lens):
        with VideoReader(str(tmp_path / "out" / f"v{i}.dips.avi")) as r:
            assert len(list(r)) == n


def test_multi_input_cli_raw_mode(tmp_path, capsys):
    """Raw modes work through the multi-stream CLI path too."""
    import os
    from dips.cli import main as cli_main
    from dips.io import moving_square_clip, write_clip
    p = str(tmp_path / "v.avi")
    write_clip(moving_square_clip(n=4, height=16, width=24), p)
    rc = cli_main(["--inputs", p, "--output-dir", str(tmp_path / "o"),
                   "--output-mode", "absdiff", "--temporal=2", "--batch=2"])
    assert rc == 0
    assert os.path.exists(tmp_path / "o" / "v.dips.avi")


def test_multistream_raw_matches_single():
    props = DiPsProperties(output=OutputMode.ABSDIFF, temporal_size=2)
    h, w = 12, 40
    clips = [make_clip(n=4, h=h, w=w, seed=s) for s in range(8)]
    ms = MultiStreamEngine(props, h, w, n_streams=8, batch=4)
    out, stats, _ = ms.process_batch([list(c) for c in clips])
    for s, c in enumerate(clips):
        eng = DiPsEngine(props, h, w, batch=4)
        exp_out, exp_stats = eng.process_frames(list(c))
        np.testing.assert_array_equal(out[s], exp_out)
        np.testing.assert_allclose(stats[s], exp_stats, atol=1e-5)


def test_rowsharded_matches_single_device():
    """One stream with rows sharded over 8 devices == single-device path
    (exercises the ppermute halo exchange for every window size)."""
    import jax.numpy as jnp
    from dips.ops import reference
    from dips.ops.reference import pad_geometry
    from dips.parallel.rowsharded import make_rowsharded_step
    from dips.parallel import stream_mesh

    h, w, b, t = 32, 40, 4, 2
    hp, wp = pad_geometry(h, w)
    mesh = stream_mesh()
    mesh = jax.sharding.Mesh(mesh.devices, ("rows",))
    r = np.random.default_rng(0)
    raw = jnp.asarray(r.integers(0, 256, (t + b, 3, hp, wp), np.uint8))
    flags = jnp.asarray(np.array([True, False, False, False]))
    valid = jnp.ones((b,), bool)

    for window in (1, 3, 5, 7):
        props = DiPsProperties(window_size=window, temporal_size=t,
                               filter=DiPsFilter.UNFILTERED)
        exp = reference.batch_step(
            props, h, w, raw, jnp.zeros((hp, wp), jnp.float32), flags,
            jnp.zeros((hp, wp), jnp.float32), valid)
        step = make_rowsharded_step(props, h, w, mesh)
        got = step(raw, jnp.zeros((hp, wp), jnp.float32), flags,
                   jnp.zeros((hp, wp), jnp.float32), valid)
        np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(exp[0]))
        np.testing.assert_allclose(np.asarray(got[1]), np.asarray(exp[1]),
                                   atol=1e-5)
        np.testing.assert_allclose(np.asarray(got[2]), np.asarray(exp[2]),
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(got[3]), np.asarray(exp[3]),
                                   atol=1e-5)


def test_rowsharded_rejects_too_small_slabs():
    from dips.parallel.rowsharded import make_rowsharded_step
    import jax.numpy as jnp
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()), ("rows",))
    props = DiPsProperties(window_size=7, temporal_size=1)
    step = make_rowsharded_step(props, 16, 24, mesh)  # slabs of 2 < halo 3
    with pytest.raises(Exception):
        step(jnp.zeros((3, 3, 16, 128), jnp.uint8),
             jnp.zeros((16, 128), jnp.float32),
             jnp.zeros((2,), bool), jnp.zeros((16, 128), jnp.float32),
             jnp.ones((2,), bool))


def test_grid2d_streams_by_rows():
    """2-D mesh (2 streams x 4 row slabs): matches single-device runs."""
    from dips.ops import reference
    from dips.ops.reference import pad_geometry
    from dips.parallel.grid2d import grid_mesh, make_grid_step
    import jax.numpy as jnp

    props = DiPsProperties(window_size=3, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED)
    h, w, b, t, s = 32, 40, 4, 2, 2
    hp, wp = pad_geometry(h, w)
    mesh = grid_mesh(2, 4)
    r = np.random.default_rng(3)
    raw = jnp.asarray(r.integers(0, 256, (s, t + b, 3, hp, wp), np.uint8))
    flags = jnp.asarray(np.tile([True, False, False, False], (s, 1)))
    valid = jnp.ones((s, b), bool)
    baseline = jnp.zeros((s, hp, wp), jnp.float32)
    heatmap = jnp.zeros((s, hp, wp), jnp.float32)

    step = make_grid_step(props, h, w, mesh)
    out, stats, nb, nh, gmean = step(raw, baseline, flags, heatmap, valid)

    means = []
    for si in range(s):
        exp = reference.batch_step(
            props, h, w, raw[si], jnp.zeros((hp, wp), jnp.float32),
            flags[si], jnp.zeros((hp, wp), jnp.float32), valid[si])
        np.testing.assert_array_equal(np.asarray(out[si]),
                                      np.asarray(exp[0]))
        np.testing.assert_allclose(np.asarray(stats[si]),
                                   np.asarray(exp[1]), atol=1e-5)
        means.append(np.asarray(exp[1])[:, 1])
    np.testing.assert_allclose(float(gmean), np.mean(means), rtol=1e-5)


def test_multistream_engine_on_2d_grid_mesh():
    """MultiStreamEngine over a (stream x rows) mesh == 1-D mesh results."""
    from dips.parallel.grid2d import grid_mesh
    props = DiPsProperties(window_size=3, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED)
    h, w = 32, 40
    clips = [make_clip(n=4, h=h, w=w, seed=s) for s in range(2)]
    ms2d = MultiStreamEngine(props, h, w, n_streams=2, batch=4,
                             mesh=grid_mesh(2, 4))
    out2d, stats2d, g2d = ms2d.process_batch([list(c) for c in clips])
    ms1d = MultiStreamEngine(props, h, w, n_streams=2, batch=4,
                             mesh=stream_mesh(2))
    out1d, stats1d, g1d = ms1d.process_batch([list(c) for c in clips])
    np.testing.assert_array_equal(out2d, out1d)
    np.testing.assert_allclose(stats2d, stats1d, atol=1e-5)
    np.testing.assert_allclose(g2d, g1d, rtol=1e-5)


def test_mesh_cli_2d_grid(tmp_path, capsys):
    """--mesh 2x4 routes multi-input runs through the 2-D grid."""
    from dips.cli import main as cli_main
    from dips.io import VideoReader, moving_square_clip, write_clip
    paths = []
    for i in range(2):
        p = str(tmp_path / f"v{i}.avi")
        write_clip(moving_square_clip(n=6, height=32, width=48, seed=i), p)
        paths.append(p)
    outdir = str(tmp_path / "out")
    rc = cli_main(["--inputs", *paths, "--output-dir", outdir,
                   "--mesh", "2x4", "--temporal=2", "--batch=3",
                   "--filter=none"])
    assert rc == 0
    assert "2 streams" in capsys.readouterr().out
    for i in range(2):
        with VideoReader(str(tmp_path / "out" / f"v{i}.dips.avi")) as r:
            assert len(list(r)) == 6


def test_mesh_cli_grid_matches_stream_mesh(tmp_path, capsys):
    """--mesh 2x4 (streams x row slabs) through the CLI batch surface
    writes the same videos as the 1-D stream mesh."""
    from dips.cli import main as cli_main
    from dips.io import VideoReader, moving_square_clip, write_clip
    paths = []
    for i in range(2):
        p = str(tmp_path / f"v{i}.avi")
        write_clip(moving_square_clip(n=4, height=32, width=48, seed=i), p)
        paths.append(p)
    frames = {}
    for mesh in ("2x4", "2x1"):
        outdir = str(tmp_path / f"out_{mesh}")
        rc = cli_main(["--inputs", *paths, "--output-dir", outdir,
                       "--mesh", mesh, "--temporal=2", "--batch=4",
                       "--filter=none"])
        assert rc == 0
        with VideoReader(str(tmp_path / f"out_{mesh}" / "v0.dips.avi")) as r:
            frames[mesh] = list(r)
    assert len(frames["2x4"]) == 4
    for a, e in zip(frames["2x4"], frames["2x1"]):
        np.testing.assert_array_equal(a, e)


def test_mesh_cli_bad_spec(tmp_path, capsys):
    from dips.cli import main as cli_main
    rc = cli_main(["--inputs", "x.avi", "--output-dir", str(tmp_path),
                   "--mesh", "oops"])
    assert rc == 2


def test_multistream_checkpoint_roundtrip(tmp_path):
    """save/load mid-stream: the resumed engine continues bit-identically
    to an uninterrupted run (cursors, baselines, tails, failures)."""
    props = DiPsProperties(window_size=1, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED)
    h, w = 8, 16
    clips = [make_clip(n=6, h=h, w=w, seed=s) for s in range(8)]
    ms = MultiStreamEngine(props, h, w, n_streams=8, batch=3)
    feeds1 = [list(c[:3]) for c in clips]
    feeds1[4] = [np.zeros((2, 2, 3), np.uint8)]  # stream 4 fails
    ms.process_batch(feeds1)
    path = str(tmp_path / "ms.npz")
    ms.save(path)

    ms2 = MultiStreamEngine(props, h, w, n_streams=8, batch=3)
    ms2.load(path)
    assert ms2.frame_cursors == ms.frame_cursors and 4 in ms2.failed
    feeds2 = [list(c[3:6]) for c in clips]
    out_resumed, st_resumed, _ = ms2.process_batch(feeds2)
    out_cont, st_cont, _ = ms.process_batch(feeds2)
    np.testing.assert_array_equal(out_resumed, out_cont)
    np.testing.assert_allclose(st_resumed, st_cont, atol=1e-6)

    with pytest.raises(ValueError):
        MultiStreamEngine(props, 16, 40, n_streams=8, batch=3).load(path)


def test_multistream_heatmaps_and_reset():
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    clips = [make_clip(n=3, h=8, w=16, seed=s) for s in range(8)]
    ms = MultiStreamEngine(props, 8, 16, n_streams=8, batch=3)
    ms.process_batch([list(c) for c in clips])
    hm = ms.heatmaps()
    assert hm.shape == (8, 8, 16) and hm.max() > 0
    ms.reset()
    assert ms.frame_index == 0 and ms.heatmaps().max() == 0


def test_run_dips_on_files_fps_mismatch_rejected(tmp_path):
    """Code-review regression: mixed-fps inputs must error, not silently
    retime the faster stream to the first reader's clock."""
    from dips.app import run_dips_on_files
    from dips.errors import VideoPathError
    from dips.io import moving_square_clip, write_clip
    a = str(tmp_path / "a.avi")
    b = str(tmp_path / "b.avi")
    write_clip(moving_square_clip(n=4, height=16, width=24), a, fps=30)
    write_clip(moving_square_clip(n=4, height=16, width=24), b, fps=60)
    with pytest.raises(VideoPathError, match="fps"):
        run_dips_on_files([a, b], str(tmp_path / "o"), batch=2)


def test_stream_mesh_overrequest_rejected():
    with pytest.raises(ValueError, match="devices requested"):
        stream_mesh(n_devices=99)


def test_grid_mesh_builds_the_grid_step():
    """A ("stream", "rows") mesh runs the 2-D grid step: state is laid
    out over both axes."""
    from dips.parallel.grid2d import grid_mesh
    eng = MultiStreamEngine(DiPsProperties(), 32, 40, n_streams=2, batch=2,
                            mesh=grid_mesh(2, 4))
    assert len(eng._heatmap.sharding.device_set) == 1  # before a step
    eng.process_batch([list(make_clip(n=2, h=32, w=40, seed=k))
                       for k in range(2)])
    assert len(eng._heatmap.sharding.device_set) == 8


def test_per_stream_snapshot():
    """snapshot(stream) re-captures only that stream's baseline on its next
    frame; snapshot() re-captures all (the serving SnapShot surface)."""
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    h, w = 8, 16
    clips = [make_clip(n=3, h=h, w=w, seed=70 + s) for s in range(8)]
    ms = MultiStreamEngine(props, h, w, n_streams=8, batch=1)
    for k in range(2):
        ms.process_batch([[c[k]] for c in clips])
    ms.snapshot(2)
    _, stats, _ = ms.process_batch([[c[2]] for c in clips])
    # stream 2 diffed against a just-re-captured baseline -> zero change;
    # its siblings kept their frame-0 baseline -> nonzero vs frame 2
    assert stats[2, 0, 1] == 0
    assert all(stats[s, 0, 1] > 0 for s in range(8) if s != 2)
    ms.snapshot()
    _, stats, _ = ms.process_batch([[c[2]] for c in clips])
    assert np.all(stats[:, 0, 1] == 0)


@pytest.mark.parametrize("n_devices", [4, 2])
def test_per_stream_checkpoint_roundtrip(tmp_path, n_devices):
    """save_stream/load_stream restore ONE slot mid-stream without touching
    siblings: after a detour and a reload, the engine continues bit-identically
    to a twin that never detoured (one or two streams per device)."""
    props = DiPsProperties(window_size=3, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED)
    h, w = 12, 40
    clips = [make_clip(n=6, h=h, w=w, seed=80 + s) for s in range(4)]
    kw = dict(n_streams=4, batch=3, mesh=stream_mesh(n_devices))
    ctl = MultiStreamEngine(props, h, w, **kw)   # uninterrupted control
    ms = MultiStreamEngine(props, h, w, **kw)
    feeds1 = [list(c[:3]) for c in clips]
    ctl.process_batch(feeds1)
    ms.process_batch(feeds1)

    path = str(tmp_path / "slot.npz")
    ms.save_stream(2, path)
    # stream 2 wanders onto other frames; siblings idle (empty feeds)
    detour = make_clip(n=3, h=h, w=w, seed=99)
    ms.process_batch([[], [], list(detour), []])
    assert ms.frame_cursors[2] == 6
    ms.load_stream(2, path)
    assert ms.frame_cursors[2] == 3

    feeds2 = [list(c[3:6]) for c in clips]
    out_r, st_r, _ = ms.process_batch(feeds2)
    out_c, st_c, _ = ctl.process_batch(feeds2)
    np.testing.assert_array_equal(out_r, out_c)
    np.testing.assert_allclose(st_r, st_c, atol=1e-6)

    # geometry mismatch is rejected before any state is touched
    with pytest.raises(ValueError):
        MultiStreamEngine(props, 32, 40, **kw).load_stream(0, path)


def test_slot_checkpoint_interops_with_single_engine(tmp_path):
    """A DiPsEngine checkpoint restores into a MultiStreamEngine slot and
    vice versa (same npz format): a serving session migrates between a
    dedicated server and a coalesced slot without losing its stream."""
    props = DiPsProperties(window_size=1, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED)
    h, w = 8, 16
    clip = make_clip(n=9, h=h, w=w, seed=7)
    other = make_clip(n=9, h=h, w=w, seed=8)

    # single-engine half, saved at frame 3
    eng = DiPsEngine(props, h, w, batch=3)
    eng.process_frames(list(clip[:3]))
    p1 = str(tmp_path / "single.npz")
    eng.save(p1)

    # restores into slot 1 of a LIVE multi-stream engine (slot 0 mid-stream)
    ms = MultiStreamEngine(props, h, w, n_streams=2, batch=3,
                           mesh=stream_mesh(2))
    ms.process_batch([list(other[:3]), list(other[:3])])
    ms.load_stream(1, p1)
    assert ms.frame_cursors == [3, 3]
    out_ms, _, _ = ms.process_batch([list(other[3:6]), list(clip[3:6])])
    out_eng, _ = eng.process_frames(list(clip[3:6]))
    np.testing.assert_array_equal(out_ms[1], out_eng)
    # slot 0's own stream was untouched by the slot-1 load
    ctl = DiPsEngine(props, h, w, batch=3)
    ctl.process_frames(list(other[:3]))
    out_ctl, _ = ctl.process_frames(list(other[3:6]))
    np.testing.assert_array_equal(out_ms[0], out_ctl)

    # and back: slot checkpoint -> fresh single engine
    p2 = str(tmp_path / "slot.npz")
    ms.save_stream(1, p2)
    eng2 = DiPsEngine(props, h, w, batch=3)
    eng2.load(p2)
    assert eng2.frame_index == 6
    out_a, _ = eng2.process_frames(list(clip[6:9]))
    out_b, _ = eng.process_frames(list(clip[6:9]))
    np.testing.assert_array_equal(out_a, out_b)


@pytest.mark.parametrize("n_devices", [8, 1])
def test_multistream_hwc_layout_bit_exact(n_devices):
    """input_layout='hwc' (device-side planarize) matches the host-planar
    multi-stream engine bit-for-bit, one or all streams per device,
    including empty feeds, short feeds and a failed stream."""
    props = DiPsProperties(window_size=3, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED)
    h, w = 12, 40
    clips = [make_clip(n=6, h=h, w=w, seed=100 + s) for s in range(8)]
    kw = dict(n_streams=8, batch=3, mesh=stream_mesh(n_devices))
    mp = MultiStreamEngine(props, h, w, input_layout="planar", **kw)
    mh = MultiStreamEngine(props, h, w, input_layout="hwc", **kw)
    feeds1 = [list(c[:3]) for c in clips]
    feeds1[2] = feeds1[2][:1]                      # short feed
    feeds1[5] = [np.zeros((4, 4, 3), np.uint8)]    # bad frame -> failed
    for feeds in (feeds1,
                  [list(c[3:6]) if s != 3 else []  # stream 3 idles
                   for s, c in enumerate(clips)]):
        op, sp, gp = mp.process_batch(feeds)
        oh, sh, gh = mh.process_batch(feeds)
        np.testing.assert_array_equal(oh, op)
        np.testing.assert_allclose(sh, sp, atol=1e-6)
        np.testing.assert_allclose(gh, gp, rtol=1e-6)
    assert 5 in mh.failed and mh.frame_cursors == mp.frame_cursors


def test_multistream_hwc_bgr_layout():
    props = DiPsProperties(window_size=1, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED)
    h, w = 8, 16
    clips = [make_clip(n=3, h=h, w=w, seed=110 + s) for s in range(8)]
    mp = MultiStreamEngine(props, h, w, n_streams=8, batch=3)
    mb = MultiStreamEngine(props, h, w, n_streams=8, batch=3,
                           input_layout="hwc_bgr")
    op, sp, _ = mp.process_batch([list(c) for c in clips])
    ob, sb, _ = mb.process_batch([[f[:, :, ::-1] for f in c] for c in clips])
    np.testing.assert_array_equal(ob, op)
    np.testing.assert_allclose(sb, sp, atol=1e-6)


def test_run_dips_on_files_hwc_layout(tmp_path):
    """--input-layout hwc flows through the multi-video batch path and
    produces the same outputs as the planar default."""
    from dips.app import run_dips_on_files
    from dips.io import VideoReader, moving_square_clip, write_clip
    paths = []
    for i in range(2):
        c = moving_square_clip(n=6, height=32, width=48, seed=i)
        p = str(tmp_path / f"v{i}.avi")
        write_clip(c, p, fps=10)
        paths.append(p)
    props = DiPsProperties(window_size=1, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED)
    d1, d2 = str(tmp_path / "planar"), str(tmp_path / "hwc")
    c1 = run_dips_on_files(paths, d1, properties=props, batch=3)
    c2 = run_dips_on_files(paths, d2, properties=props, batch=3,
                           input_layout="hwc")
    assert list(c1) == list(c2) == [6, 6]
    import os
    for i in range(2):
        f1 = os.path.join(d1, f"v{i}.dips.avi")
        f2 = os.path.join(d2, f"v{i}.dips.avi")
        with VideoReader(f1) as r1, VideoReader(f2) as r2:
            for a, b in zip(r1, r2):
                np.testing.assert_array_equal(a, b)


def test_load_cancels_pending_snapshot(tmp_path):
    """Code-review regression: a snapshot requested BEFORE a full-state
    restore must not fire after it (it would re-capture every baseline
    and silently discard the checkpoint's)."""
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    h, w = 8, 16
    clips = [make_clip(n=4, h=h, w=w, seed=s) for s in range(8)]
    ms = MultiStreamEngine(props, h, w, n_streams=8, batch=2)
    ms.process_batch([list(c[:2]) for c in clips])
    path = str(tmp_path / "snap.npz")
    ms.save(path)

    ms2 = MultiStreamEngine(props, h, w, n_streams=8, batch=2)
    ms2.process_batch([list(c[:2]) for c in clips])
    ms2.snapshot()          # requested, then superseded by the restore
    ms2.load(path)
    out2, st2, _ = ms2.process_batch([list(c[2:4]) for c in clips])
    out1, st1, _ = ms.process_batch([list(c[2:4]) for c in clips])
    # identical to the uninterrupted engine: the snapshot did NOT fire
    np.testing.assert_array_equal(out2, out1)
    np.testing.assert_allclose(st2, st1, atol=1e-6)


@pytest.mark.parametrize("option", ["backend", "ring_carry", "slab_impl"])
def test_removed_options_rejected(option):
    """The options that chose between step implementations are gone: a
    launch that still passes one fails loudly instead of silently
    proceeding."""
    props = DiPsProperties(window_size=3, temporal_size=2)
    with pytest.raises(TypeError, match=option):
        MultiStreamEngine(props, 12, 40, n_streams=8, batch=2,
                          **{option: None})
    with pytest.raises(TypeError, match=option):
        DiPsEngine(props, 12, 40, batch=2, **{option: None})


def test_mesh_cli_2d_grid_raw_modes(tmp_path, capsys):
    """--mesh SxR accepts raw modes: an absdiff fleet
    runs on the 2-D grid and writes per-stream diff videos identical to
    the 1-D mesh run; a stats_only fleet needs no output dir at all."""
    import json
    from dips.cli import main as cli_main
    from dips.io import VideoReader, moving_square_clip, write_clip
    paths = []
    for i in range(2):
        p = str(tmp_path / f"v{i}.avi")
        write_clip(moving_square_clip(n=4, height=32, width=48, seed=i), p)
        paths.append(p)
    frames = {}
    for name, mesh_args in (("2d", ["--mesh", "2x4"]), ("1d", [])):
        outdir = str(tmp_path / f"out_{name}")
        rc = cli_main(["--inputs", *paths, "--output-dir", outdir,
                       "--output-mode=absdiff", "--temporal=2",
                       "--batch=4", *mesh_args])
        assert rc == 0
        with VideoReader(str(tmp_path / f"out_{name}" / "v0.dips.avi")) as r:
            frames[name] = list(r)
    assert len(frames["2d"]) == 4
    for a, e in zip(frames["2d"], frames["1d"]):
        np.testing.assert_array_equal(a, e)
    # the no-map events fleet: stats_only + --mesh, JSON out, no videos
    sj = str(tmp_path / "stats.json")
    rc = cli_main(["--inputs", *paths, "--output-mode=stats_only",
                   "--mesh", "2x4", "--temporal=2", "--batch=4",
                   "--stats-json", sj])
    assert rc == 0
    with open(sj) as f:
        doc = json.load(f)
    assert len(doc) == 2 and all(len(v) == 4 for v in doc.values())


def test_mesh_cli_events_fleet(tmp_path):
    """The full headline workflow end to end: a no-map events fleet
    (stats_only) with motion-event segmentation AND fleet flicker on the
    2-D grid — events/stats/flicker JSON out, zero video egress."""
    import json
    from dips.cli import main as cli_main
    from dips.io import moving_square_clip, write_clip
    paths = []
    for i in range(2):
        p = str(tmp_path / f"cam{i}.avi")
        write_clip(moving_square_clip(n=8, height=32, width=48, seed=i), p)
        paths.append(p)
    ej = str(tmp_path / "events.json")
    sj = str(tmp_path / "stats.json")
    rc = cli_main(["--inputs", *paths, "--output-mode=stats_only",
                   "--mesh", "2x4", "--temporal=2", "--batch=4",
                   "--events-json", ej, "--event-on", "0.001",
                   "--stats-json", sj, "--flicker-hz", "5"])
    assert rc == 0
    with open(ej) as f:
        events = json.load(f)
    assert len(events) == 2  # one event list per camera
    with open(sj) as f:
        stats = json.load(f)
    assert all(len(v) == 8 for v in stats.values())
