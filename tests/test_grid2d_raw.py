"""Raw (absdiff/threshold/stats-only) modes on the 2-D stream x rows mesh.

Raw modes have no stencil, so the 2-D grid needs no halo: each device
diffs its slab of its streams independently and only the statistic
reductions cross devices.  This is the no-map fleet deployment — many
huge cameras where stream count alone can't use all devices.

Integer modes are an exact-equality contract vs the full-height step
(absdiff parity per the reference's dips/src/gpu/shaders/
dips_shader.wgsl:213-236).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from dips.models import DiPsEngine
from dips.ops import reference
from dips.ops.reference import pad_geometry
from dips.parallel.grid2d import grid_mesh, make_grid_step
from dips.parallel.multistream import MultiStreamEngine, stream_mesh
from dips.properties import DiPsMethod, DiPsProperties, OutputMode
from tests.conftest import make_clip

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device test mesh")


def _raw_inputs(props, h, w, s, b, seed=3):
    t = props.temporal_size
    hp, wp = pad_geometry(h, w)
    r = np.random.default_rng(seed)
    raw = np.zeros((s, t + b, 3, hp, wp), np.uint8)
    raw[..., :h, :w] = r.integers(0, 256, (s, t + b, 3, h, w), np.uint8)
    flags = np.zeros((s, b), bool)
    flags[:, 0] = True
    return (jnp.asarray(raw), jnp.asarray(flags),
            jnp.asarray(np.ones((s, b), bool)), hp, wp)


@pytest.mark.parametrize("grid", [(2, 4), (1, 8)])
@pytest.mark.parametrize("mode,method", [
    (OutputMode.ABSDIFF, DiPsMethod.OVERALL),
    (OutputMode.ABSDIFF, DiPsMethod.PER_FRAME),
    (OutputMode.THRESHOLD, DiPsMethod.OVERALL),
    (OutputMode.STATS_ONLY, DiPsMethod.OVERALL),
])
def test_grid_raw_tail_bit_identical(grid, mode, method):
    """make_grid_step raw modes on a (streams x rows) mesh == per-stream
    full-height steps: maps byte-exact, stats to float tolerance."""
    props = DiPsProperties(output=mode, method=method, temporal_size=2,
                           change_threshold=20)
    h, w, s, b = 32, 40, 2, 4
    raw, flags, valid, hp, wp = _raw_inputs(props, h, w, s, b)
    step = make_grid_step(props, h, w, grid_mesh(*grid))
    out, stats, nb, nh, gmean = step(
        raw, jnp.zeros((s, 3, hp, wp), jnp.uint8), flags,
        jnp.zeros((s, hp, wp), jnp.float32), valid)
    assert np.isfinite(float(gmean))
    for si in range(s):
        eo, es, eb, eh = reference.absdiff_step(
            props, h, w, raw[si], jnp.zeros((3, hp, wp), jnp.uint8),
            flags[si], jnp.zeros((hp, wp), jnp.float32), valid[si])
        np.testing.assert_array_equal(np.asarray(out[si]), np.asarray(eo))
        np.testing.assert_allclose(np.asarray(stats[si]), np.asarray(es),
                                   atol=1e-6)
        np.testing.assert_array_equal(np.asarray(nb[si]), np.asarray(eb))
        np.testing.assert_allclose(np.asarray(nh[si]), np.asarray(eh),
                                   atol=1e-5)


@pytest.mark.parametrize("method", [DiPsMethod.OVERALL,
                                    DiPsMethod.PER_FRAME])
def test_grid_raw_two_batches_bit_identical(method):
    """Carried baseline/heatmap slab state on the 2-D grid across two
    batches (the last T raw frames lead the next batch) == absdiff_step
    per stream, byte-exact."""
    props = DiPsProperties(output=OutputMode.ABSDIFF, method=method,
                           temporal_size=2)
    h, w, s, b = 32, 40, 2, 4
    t = props.temporal_size
    hp, wp = pad_geometry(h, w)
    r = np.random.default_rng(11)
    step = make_grid_step(props, h, w, grid_mesh(2, 4))
    bl = jnp.zeros((s, 3, hp, wp), jnp.uint8)
    hm = jnp.zeros((s, hp, wp), jnp.float32)
    valid = jnp.asarray(np.ones((s, b), bool))
    exp = [(jnp.zeros((3, hp, wp), jnp.uint8),
            jnp.zeros((hp, wp), jnp.float32)) for _ in range(s)]
    frames = np.zeros((s, 2 * b, 3, hp, wp), np.uint8)
    frames[..., :h, :w] = r.integers(0, 256, (s, 2 * b, 3, h, w), np.uint8)
    tail = np.repeat(frames[:, :1], t, axis=1)
    for bi in range(2):
        new = frames[:, bi * b:(bi + 1) * b]
        raw = jnp.asarray(np.concatenate([tail, new], axis=1))
        tail = new[:, -t:]
        fl = np.zeros((s, b), bool)
        fl[:, 0] = bi == 0
        fl = jnp.asarray(fl)
        out, stats, bl, hm, gmean = step(raw, bl, fl, hm, valid)
        assert np.isfinite(float(gmean))
        for si in range(s):
            eb, eh = exp[si]
            eo, es, eb, eh = reference.absdiff_step(
                props, h, w, raw[si], eb, fl[si], eh, valid[si])
            exp[si] = (eb, eh)
            np.testing.assert_array_equal(np.asarray(out[si]),
                                          np.asarray(eo))
            np.testing.assert_allclose(np.asarray(stats[si]),
                                       np.asarray(es), atol=1e-6)
            np.testing.assert_array_equal(np.asarray(bl[si]),
                                          np.asarray(eb))
            np.testing.assert_allclose(np.asarray(hm[si]), np.asarray(eh),
                                       atol=1e-5)


@pytest.mark.parametrize("grid", [(2, 4), (1, 8)])
def test_grid_raw_roi(grid):
    """roi row bounds fold into the slab-local mask windows (the roi
    spans a strict subset of the row slabs)."""
    props = DiPsProperties(output=OutputMode.ABSDIFF, temporal_size=2,
                           roi=(6, 4, 26, 36))
    h, w, s, b = 32, 40, 2, 4
    raw, flags, valid, hp, wp = _raw_inputs(props, h, w, s, b, seed=5)
    step = make_grid_step(props, h, w, grid_mesh(*grid))
    out, stats, _, nh, _ = step(
        raw, jnp.zeros((s, 3, hp, wp), jnp.uint8), flags,
        jnp.zeros((s, hp, wp), jnp.float32), valid)
    for si in range(s):
        eo, es, _, eh = reference.absdiff_step(
            props, h, w, raw[si], jnp.zeros((3, hp, wp), jnp.uint8),
            flags[si], jnp.zeros((hp, wp), jnp.float32), valid[si])
        np.testing.assert_array_equal(np.asarray(out[si]), np.asarray(eo))
        np.testing.assert_allclose(np.asarray(stats[si]), np.asarray(es),
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(nh[si]), np.asarray(eh),
                                   atol=1e-5)


@pytest.mark.parametrize("mode", [OutputMode.ABSDIFF, OutputMode.THRESHOLD,
                                  OutputMode.STATS_ONLY])
@pytest.mark.parametrize("grid", [(2, 4), (2, 2)])
def test_engine_2d_raw_matches_single_device(mode, grid):
    """MultiStreamEngine raw modes on the 2-D mesh reproduce per-stream
    single-device engines through the full engine surface (two batches:
    carried state crosses a step boundary)."""
    props = DiPsProperties(output=mode, temporal_size=2,
                           change_threshold=20, refresh_markers=(5,))
    h, w, batch = 32, 40, 4
    clips = [make_clip(n=8, h=h, w=w, seed=40 + k) for k in range(2)]
    eng = MultiStreamEngine(props, h, w, n_streams=2, batch=batch,
                            mesh=grid_mesh(*grid))
    outs, stats = [], []
    for i in range(0, 8, batch):
        o, st, g = eng.process_batch([list(c[i:i + batch]) for c in clips])
        assert np.isfinite(g)
        outs.append(o)
        stats.append(st)
    out = np.concatenate(outs, axis=1)
    stat = np.concatenate(stats, axis=1)
    for k, c in enumerate(clips):
        ref = DiPsEngine(props, h, w, batch=batch)
        exp_out, exp_stats = ref.process_frames(list(c))
        np.testing.assert_array_equal(out[k], exp_out)
        np.testing.assert_allclose(stat[k], exp_stats, atol=1e-5)
        np.testing.assert_allclose(eng.heatmaps()[k], ref.heatmap(),
                                   atol=1e-4)


def test_engine_2d_raw_matches_1d_mesh():
    """The same fleet on a 2-D (2 x 4) mesh and a 1-D 8-stream mesh must
    agree bit-exactly (only the sharding layout differs)."""
    props = DiPsProperties(output=OutputMode.ABSDIFF, temporal_size=2)
    h, w, batch = 32, 40, 4
    clips = [make_clip(n=4, h=h, w=w, seed=60 + k) for k in range(2)]
    res = {}
    for name, mesh in (("2d", grid_mesh(2, 4)), ("1d", stream_mesh(2))):
        eng = MultiStreamEngine(props, h, w, n_streams=2, batch=batch,
                                mesh=mesh)
        o, st, g = eng.process_batch([list(c) for c in clips])
        res[name] = (o, st, g)
    np.testing.assert_array_equal(res["2d"][0], res["1d"][0])
    np.testing.assert_allclose(res["2d"][1], res["1d"][1], atol=1e-6)
    assert res["2d"][2] == pytest.approx(res["1d"][2], abs=1e-6)


def test_engine_2d_raw_packed_wire():
    """packed_wire rides the sharded THRESHOLD path: bit-packed masks on
    the 2-D mesh unpack to the plain engine's maps."""
    props = DiPsProperties(output=OutputMode.THRESHOLD, temporal_size=2,
                           change_threshold=20)
    h, w, batch = 32, 40, 4
    clips = [make_clip(n=4, h=h, w=w, seed=70 + k) for k in range(2)]
    outs = {}
    for packed in (True, False):
        eng = MultiStreamEngine(props, h, w, n_streams=2, batch=batch,
                                mesh=grid_mesh(2, 4), packed_wire=packed)
        o, st, _ = eng.process_batch([list(c) for c in clips])
        outs[packed] = (o, st)
    np.testing.assert_array_equal(outs[True][0], outs[False][0])
    np.testing.assert_allclose(outs[True][1], outs[False][1], atol=0)


def test_engine_2d_stats_only_shape():
    """STATS_ONLY on the 2-D mesh: zero-channel maps, real stats."""
    props = DiPsProperties(output=OutputMode.STATS_ONLY, temporal_size=2)
    h, w = 32, 40
    eng = MultiStreamEngine(props, h, w, n_streams=2, batch=2,
                            mesh=grid_mesh(2, 4))
    clips = [make_clip(n=2, h=h, w=w, seed=k) for k in range(2)]
    o, st, _ = eng.process_batch([list(c) for c in clips])
    assert o.shape == (2, 2, h, w, 0)
    assert np.isfinite(st).all() and (st != 0).any()


def test_grid_raw_alignment_guard():
    """A rows axis that does not divide the padded height fails eagerly,
    from the step builder and from the engine."""
    props = DiPsProperties(output=OutputMode.ABSDIFF, temporal_size=2)
    with pytest.raises(ValueError, match="must divide the padded height"):
        make_grid_step(props, 24, 40, grid_mesh(1, 5))
    with pytest.raises(ValueError, match="must divide the padded height"):
        MultiStreamEngine(props, 24, 40, n_streams=1, batch=2,
                          mesh=grid_mesh(1, 5))


def test_engine_2d_raw_hwc_layout():
    """input_layout='hwc' (device-side transpose+pad before the grid
    step) composes with raw modes on the 2-D mesh — bit-identical to the
    host-planarize path."""
    props = DiPsProperties(output=OutputMode.ABSDIFF, temporal_size=2)
    h, w, batch = 32, 40, 4
    clips = [make_clip(n=4, h=h, w=w, seed=90 + k) for k in range(2)]
    res = {}
    for layout in ("planar", "hwc"):
        eng = MultiStreamEngine(props, h, w, n_streams=2, batch=batch,
                                mesh=grid_mesh(2, 4), input_layout=layout)
        o, st, _ = eng.process_batch([list(c) for c in clips])
        res[layout] = (o, st)
    np.testing.assert_array_equal(res["hwc"][0], res["planar"][0])
    np.testing.assert_allclose(res["hwc"][1], res["planar"][1], atol=0)


def test_engine_2d_raw_downscale():
    """On-device downscale composes with raw modes on the 2-D mesh: a
    downscale=2 grid engine fed full-res frames matches a plain grid
    engine fed host-pooled frames bit-exactly."""
    from dips.ops import reference
    props = DiPsProperties(output=OutputMode.ABSDIFF, temporal_size=2)
    h, w, k, batch = 64, 80, 2, 4
    clips = [make_clip(n=4, h=h, w=w, seed=95 + i) for i in range(2)]
    ek = MultiStreamEngine(props, h, w, n_streams=2, batch=batch,
                           mesh=grid_mesh(2, 4), downscale=k)
    e1 = MultiStreamEngine(props, h // k, w // k, n_streams=2, batch=batch,
                           mesh=grid_mesh(2, 4))
    ok_, sk, _ = ek.process_batch([list(c) for c in clips])
    o1, s1, _ = e1.process_batch(
        [[reference.pool_frame_host(f, k) for f in c] for c in clips])
    np.testing.assert_array_equal(ok_, o1)
    np.testing.assert_allclose(sk, s1, atol=1e-6)


def test_engine_2d_raw_failure_isolation():
    """Per-stream failure isolation holds on the 2-D raw fleet: a bad
    frame kills only its stream, the sibling's results are unaffected,
    and reset_stream rejoins the failed camera fresh."""
    props = DiPsProperties(output=OutputMode.ABSDIFF, temporal_size=2)
    h, w, batch = 32, 40, 4
    clips = [make_clip(n=4, h=h, w=w, seed=97 + k) for k in range(2)]
    eng = MultiStreamEngine(props, h, w, n_streams=2, batch=batch,
                            mesh=grid_mesh(2, 4))
    bad = [np.zeros((3, 3, 3), np.uint8)]  # wrong geometry -> StreamError
    out, stats, _ = eng.process_batch([bad, list(clips[1])])
    assert 0 in eng.failed and 1 not in eng.failed
    ref = DiPsEngine(props, h, w, batch=batch)
    exp_out, exp_stats = ref.process_frames(list(clips[1]))
    np.testing.assert_array_equal(out[1], exp_out)
    np.testing.assert_allclose(stats[1], exp_stats, atol=1e-5)
    # the failed camera rejoins fresh and produces correct results
    eng.reset_stream(0)
    out2, stats2, _ = eng.process_batch([list(clips[0]), []])
    ref0 = DiPsEngine(props, h, w, batch=batch)
    exp0, exps0 = ref0.process_frames(list(clips[0]))
    np.testing.assert_array_equal(out2[0], exp0)
    np.testing.assert_allclose(stats2[0], exps0, atol=1e-5)


def test_engine_2d_raw_checkpoint_roundtrip(tmp_path):
    """Raw grid engines resume bit-identically from a checkpoint (u8
    baseline, raw tails; mirrors the median grid checkpoint test)."""
    props = DiPsProperties(output=OutputMode.ABSDIFF, temporal_size=2,
                           method=DiPsMethod.PER_FRAME)
    h, w = 32, 40
    clips = [make_clip(n=8, h=h, w=w, seed=110 + k) for k in range(2)]
    eng = MultiStreamEngine(props, h, w, n_streams=2, batch=4,
                            mesh=grid_mesh(2, 4))
    eng.process_batch([list(c[:4]) for c in clips])
    p = str(tmp_path / "grid_raw.npz")
    eng.save(p)
    eng2 = MultiStreamEngine(props, h, w, n_streams=2, batch=4,
                             mesh=grid_mesh(2, 4))
    eng2.load(p)
    o1, s1, _ = eng.process_batch([list(c[4:]) for c in clips])
    o2, s2, _ = eng2.process_batch([list(c[4:]) for c in clips])
    np.testing.assert_array_equal(o1, o2)
    np.testing.assert_array_equal(s1, s2)
