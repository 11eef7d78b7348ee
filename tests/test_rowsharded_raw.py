"""Raw (absdiff/threshold/stats-only) modes on a rows mesh.

No stencil -> no halo exchange: each shard diffs its slab independently,
only the statistic reductions cross devices (psum/pmax).  Row-sharding a
raw mode is a bandwidth play: R row shards add up R devices' memory
bandwidth for one enormous (8K-class) stream.

Integer modes are an exact-equality contract vs the full-height step.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from dips.properties import DiPsMethod, DiPsProperties, OutputMode
from dips.ops import reference
from dips.ops.reference import pad_geometry
from dips.parallel.rowsharded import make_rowsharded_step
from jax.sharding import Mesh

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device test mesh")


def _mesh(n=8):
    return Mesh(np.asarray(jax.devices()[:n]), ("rows",))


def _raw_inputs(props, h, w, b, seed=3):
    t = props.temporal_size
    hp, wp = pad_geometry(h, w)
    r = np.random.default_rng(seed)
    raw = np.zeros((t + b, 3, hp, wp), np.uint8)
    raw[..., :h, :w] = r.integers(0, 256, (t + b, 3, h, w), np.uint8)
    flags = np.zeros((b,), bool)
    flags[0] = True
    return (jnp.asarray(raw), jnp.asarray(flags),
            jnp.asarray(np.ones((b,), bool)), hp, wp)


@pytest.mark.parametrize("n_rows", [2, 8])
@pytest.mark.parametrize("mode,method", [
    (OutputMode.ABSDIFF, DiPsMethod.OVERALL),
    (OutputMode.ABSDIFF, DiPsMethod.PER_FRAME),
    (OutputMode.THRESHOLD, DiPsMethod.OVERALL),
    (OutputMode.STATS_ONLY, DiPsMethod.OVERALL),
])
def test_raw_rowsharded_bit_identical(n_rows, mode, method):
    """rowsharded raw step == full-height step: maps byte-exact, stats
    to float tolerance (reduction order differs across shards)."""
    props = DiPsProperties(output=mode, method=method, temporal_size=2,
                           change_threshold=20)
    h, w, b = 64, 40, 4
    raw, flags, valid, hp, wp = _raw_inputs(props, h, w, b)
    step = make_rowsharded_step(props, h, w, _mesh(n_rows))
    bl0 = jnp.zeros((3, hp, wp), jnp.uint8)
    hm0 = jnp.zeros((hp, wp), jnp.float32)
    out, stats, nb, nh = step(raw, bl0, flags, hm0, valid)
    eo, es, eb, eh = reference.absdiff_step(
        props, h, w, raw, jnp.zeros((3, hp, wp), jnp.uint8), flags,
        jnp.zeros((hp, wp), jnp.float32), valid)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(eo))
    np.testing.assert_allclose(np.asarray(stats), np.asarray(es), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(nb), np.asarray(eb))
    np.testing.assert_allclose(np.asarray(nh), np.asarray(eh), atol=1e-5)


@pytest.mark.parametrize("n_rows", [2, 8])
def test_raw_rowsharded_roi(n_rows):
    """roi stats fold correctly across shard-local row windows (the roi
    spans a strict subset of the slabs)."""
    props = DiPsProperties(output=OutputMode.ABSDIFF, temporal_size=2,
                           roi=(10, 4, 50, 36))
    h, w, b = 64, 40, 4
    raw, flags, valid, hp, wp = _raw_inputs(props, h, w, b, seed=5)
    step = make_rowsharded_step(props, h, w, _mesh(n_rows))
    out, stats, _, nh = step(raw, jnp.zeros((3, hp, wp), jnp.uint8), flags,
                             jnp.zeros((hp, wp), jnp.float32), valid)
    eo, es, _, eh = reference.absdiff_step(
        props, h, w, raw, jnp.zeros((3, hp, wp), jnp.uint8), flags,
        jnp.zeros((hp, wp), jnp.float32), valid)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(eo))
    np.testing.assert_allclose(np.asarray(stats), np.asarray(es), atol=1e-6)
    np.testing.assert_allclose(np.asarray(nh), np.asarray(eh), atol=1e-5)


@pytest.mark.parametrize("method", [DiPsMethod.OVERALL,
                                    DiPsMethod.PER_FRAME])
def test_raw_rowsharded_two_batches_bit_identical(method):
    """Carried baseline/heatmap slab state across two batches (the tail
    protocol: the last T raw frames lead the next batch) == the
    full-height step, byte-exact."""
    props = DiPsProperties(output=OutputMode.ABSDIFF, method=method,
                           temporal_size=2)
    h, w, b = 64, 40, 4
    t = props.temporal_size
    hp, wp = pad_geometry(h, w)
    r = np.random.default_rng(11)
    step = make_rowsharded_step(props, h, w, _mesh())
    bl = eb = jnp.zeros((3, hp, wp), jnp.uint8)
    hm = eh = jnp.zeros((hp, wp), jnp.float32)
    valid = jnp.asarray(np.ones((b,), bool))
    frames = np.zeros((2 * b, 3, hp, wp), np.uint8)
    frames[..., :h, :w] = r.integers(0, 256, (2 * b, 3, h, w), np.uint8)
    tail = np.stack([frames[0]] * t)
    for bi in range(2):
        new = frames[bi * b:(bi + 1) * b]
        raw = jnp.asarray(np.concatenate([tail, new]))
        tail = new[-t:]
        flags = jnp.asarray([bi == 0] + [False] * (b - 1))
        out, stats, bl, hm = step(raw, bl, flags, hm, valid)
        eo, es, eb, eh = reference.absdiff_step(
            props, h, w, raw, eb, flags, eh, valid)
        np.testing.assert_array_equal(np.asarray(out), np.asarray(eo))
        np.testing.assert_allclose(np.asarray(stats), np.asarray(es),
                                   atol=1e-6)
        np.testing.assert_array_equal(np.asarray(bl), np.asarray(eb))
        np.testing.assert_allclose(np.asarray(hm), np.asarray(eh),
                                   atol=1e-5)


def test_raw_rowsharded_alignment_guard():
    """A rows axis that does not divide the padded height fails eagerly
    with a clear message, not deep inside shard_map."""
    with pytest.raises(ValueError, match="divide the padded height"):
        make_rowsharded_step(
            DiPsProperties(output=OutputMode.ABSDIFF, temporal_size=2),
            24, 40, Mesh(np.asarray(jax.devices()[:5]), ("rows",)))
