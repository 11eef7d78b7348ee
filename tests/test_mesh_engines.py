"""The median-mode mesh paths on the virtual 8-device CPU mesh: stream
meshes of every size, stream x rows grids, and one stream split by rows,
each against single-device runs of the same frames."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dips.models import DiPsEngine
from dips.ops import reference
from dips.parallel import MultiStreamEngine, stream_mesh
from dips.parallel.grid2d import grid_mesh
from dips.parallel.rowsharded import make_rowsharded_step
from dips.properties import (DiPsFilter, DiPsMethod, DiPsProperties,
                             OutputMode)
from tests.conftest import make_clip

CASES = {
    "overall-sigmoid-w3-markers": DiPsProperties(
        window_size=3, temporal_size=2, refresh_markers=(4,)),
    "per_frame-gray-w5": DiPsProperties(
        method=DiPsMethod.PER_FRAME, output=OutputMode.GRAYSCALE,
        filter=DiPsFilter.UNFILTERED, window_size=5, temporal_size=3),
    "overall-w7-exact": DiPsProperties(
        window_size=7, temporal_size=2, filter=DiPsFilter.UNFILTERED),
    "overall-no-maps": DiPsProperties(
        window_size=3, temporal_size=2, filter=DiPsFilter.UNFILTERED,
        emit_maps=False),
}


def _run_multi(eng, clips, batch):
    outs, stats = [], []
    for i in range(0, clips[0].shape[0], batch):
        o, s, _ = eng.process_batch([list(c[i:i + batch]) for c in clips])
        outs.append(o)
        stats.append(s)
    return np.concatenate(outs, axis=1), np.concatenate(stats, axis=1)


def _assert_matches_single(props, h, w, clips, out, stats, heat, batch):
    for k, c in enumerate(clips):
        ref = DiPsEngine(props, h, w, batch=batch)
        ro, rs = ref.process_frames(list(c))
        np.testing.assert_array_equal(out[k], ro)
        np.testing.assert_allclose(stats[k], rs, atol=1e-5)
        np.testing.assert_allclose(heat[k], ref.heatmap(), atol=1e-5)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
def test_stream_mesh_matches_single_engines(name, n_devices):
    """Eight streams over a 1-, 2-, 4- or 8-device stream mesh."""
    props = CASES[name]
    h, w, batch = 16, 40, 3
    clips = [make_clip(n=6, h=h, w=w, seed=s) for s in range(8)]
    eng = MultiStreamEngine(props, h, w, n_streams=8, batch=batch,
                            mesh=stream_mesh(n_devices))
    out, stats = _run_multi(eng, clips, batch)
    _assert_matches_single(props, h, w, clips, out, stats, eng.heatmaps(),
                           batch)


@pytest.mark.parametrize("name", ["overall-sigmoid-w3-markers",
                                  "per_frame-gray-w5"])
@pytest.mark.parametrize("grid", [(2, 4), (4, 2), (1, 8), (2, 2)])
def test_grid_mesh_matches_single_engines(name, grid):
    """Streams x row slabs: the halo exchange on every rows axis size."""
    props = CASES[name]
    h, w, batch = 32, 40, 4
    s = grid[0]
    clips = [make_clip(n=8, h=h, w=w, seed=10 + k) for k in range(s)]
    eng = MultiStreamEngine(props, h, w, n_streams=s, batch=batch,
                            mesh=grid_mesh(*grid))
    out, stats = _run_multi(eng, clips, batch)
    _assert_matches_single(props, h, w, clips, out, stats, eng.heatmaps(),
                           batch)


@pytest.mark.parametrize("window", [3, 5, 7])
@pytest.mark.parametrize("rows", [2, 4, 8])
def test_rowsharded_step_matches_single_device(window, rows):
    """One stream split by rows: every slab gets its neighbours' halo
    rows, so the exact median matches the single-device step."""
    h, w, b, t = 48, 40, 4, 2
    hp, wp = reference.pad_geometry(h, w)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:rows]), ("rows",))
    props = DiPsProperties(window_size=window, temporal_size=t,
                           filter=DiPsFilter.UNFILTERED,
                           method=DiPsMethod.PER_FRAME)
    r = np.random.default_rng(window * rows)
    raw = jnp.asarray(r.integers(0, 256, (t + b, 3, hp, wp), np.uint8))
    flags = jnp.zeros((b,), bool)
    valid = jnp.ones((b,), bool)

    def zeros():
        return jnp.zeros((hp, wp), jnp.float32)

    exp = reference.batch_step(props, h, w, raw, zeros(), flags, zeros(),
                               valid)
    got = make_rowsharded_step(props, h, w, mesh)(raw, zeros(), flags,
                                                  zeros(), valid)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(exp[0]))
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(exp[1]),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(got[3]), np.asarray(exp[3]),
                               atol=1e-5)
