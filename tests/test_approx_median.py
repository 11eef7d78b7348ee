"""Separable approximate spatial median (DiPsProperties.approx_median):
parity across oracle / XLA / Pallas / row-sharded paths, rank-bound
guarantees vs the exact median, and the CLI flag."""

import numpy as np
import pytest

from dips.models import DiPsEngine
from dips.ops import networks, reference
from dips.ops.oracle import DiPsOracle, spatial_median
from dips.properties import DiPsFilter, DiPsProperties
from tests.conftest import make_clip


@pytest.mark.parametrize("window", [3, 5, 7])
def test_rank_bounds_vs_exact(window, rng):
    """The separable median is one of the window's own values, with at
    least ceil(w/2)^2 values on each side (classic separability bound)."""
    plane = rng.integers(0, 256, (20, 30)).astype(np.float32)
    approx = spatial_median(plane, window, approx=True)
    p = window // 2
    k = ((window + 1) // 2) ** 2
    padded = np.zeros((20 + 2 * p, 30 + 2 * p), np.float32)
    padded[p:p + 20, p:p + 30] = plane
    for y in range(20):
        for x in range(0, 30, 7):  # sample columns to keep it fast
            win = padded[y:y + window, x:x + window].ravel()
            v = approx[y, x]
            assert v in win
            assert (win <= v).sum() >= k and (win >= v).sum() >= k


def test_approx_differs_but_tracks_exact(rng):
    plane = rng.integers(0, 256, (24, 40)).astype(np.float32)
    exact = spatial_median(plane, 7)
    approx = spatial_median(plane, 7, approx=True)
    assert not np.array_equal(exact, approx)  # it is an approximation
    # ...but a close one even on uniform noise (rank-bounded)
    assert np.abs(exact - approx).mean() < 30


@pytest.mark.parametrize("window", [3, 5, 7])
def test_xla_matches_oracle_approx(window, rng):
    plane = rng.integers(0, 256, (16, 40)).astype(np.float32)
    exp = spatial_median(plane, window, approx=True)
    got = np.asarray(reference.spatial_median(
        np.asarray(plane), window, approx=True))
    np.testing.assert_array_equal(got, exp)  # pure min/max: bit-exact


@pytest.mark.parametrize("window", [5, 7])
def test_engine_parity_approx(window):
    """Full pipeline with approx_median: oracle == the XLA step."""
    props = DiPsProperties(window_size=window, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED, approx_median=True)
    frames = make_clip(n=6, h=14, w=44, seed=4)
    o = DiPsOracle(props)
    exp_out, exp_stats = o.run(frames)
    if exp_out.ndim == 3:
        exp_out = exp_out[..., None]
    eng = DiPsEngine(props, 14, 44, batch=3)
    got_out, got_stats = eng.process_frames(list(frames))
    d = np.abs(got_out.astype(int) - exp_out.astype(int))
    assert d.max() <= 1
    np.testing.assert_allclose(got_stats, exp_stats, atol=1e-4, rtol=1e-4)


def test_rowsharded_parity_approx():
    import jax
    import jax.numpy as jnp
    from dips.ops.reference import pad_geometry
    from dips.parallel.rowsharded import make_rowsharded_step

    props = DiPsProperties(window_size=7, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED, approx_median=True)
    h, w, b, t = 32, 40, 2, 2
    hp, wp = pad_geometry(h, w)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()), ("rows",))
    r = np.random.default_rng(0)
    raw = jnp.asarray(r.integers(0, 256, (t + b, 3, hp, wp), np.uint8))
    flags = jnp.asarray([True, False])
    valid = jnp.ones((b,), bool)
    exp = reference.batch_step(props, h, w, raw,
                               jnp.zeros((hp, wp), jnp.float32), flags,
                               jnp.zeros((hp, wp), jnp.float32), valid)
    step = make_rowsharded_step(props, h, w, mesh)
    got = step(raw, jnp.zeros((hp, wp), jnp.float32), flags,
               jnp.zeros((hp, wp), jnp.float32), valid)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(exp[0]))


def test_comparator_count_reduction():
    """The whole point: ~10x fewer comparators at window 7."""
    col_sort, merge_ops, _ = networks.column_median_plan(7)
    exact_ops = len(col_sort) + len(merge_ops)
    approx_ops = 2 * len(networks.median_network(7))
    assert approx_ops * 5 < exact_ops, (approx_ops, exact_ops)


def test_cli_approx_flag(tmp_path):
    from dips.cli import main as cli_main, build_parser, props_from_args
    args = build_parser().parse_args(["--approx-median", "--win_size=7"])
    p = props_from_args(args)
    assert p.approx_median and p.window_size == 7
    assert not props_from_args(build_parser().parse_args([])).approx_median


