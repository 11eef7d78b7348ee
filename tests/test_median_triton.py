"""The Triton exact-median kernel (ops/median_triton.py) in the Pallas
interpreter, against the plain XLA median and the numpy oracle, and the
step's choice between the two by window size and platform."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl

from dips.ops import median_triton, oracle, reference


def _planes(shape, seed=0):
    r = np.random.default_rng(seed)
    return r.integers(0, 511, shape).astype(np.float32)


def _pad(x, p):
    return jnp.pad(jnp.asarray(x), [(0, 0)] * (x.ndim - 2) + [(p, p)] * 2)


@pytest.fixture()
def interpreted(monkeypatch):
    """No Triton compiler on the CPU: run the kernel in the interpreter."""
    monkeypatch.setattr(median_triton, "_pallas_call", functools.partial(
        pl.pallas_call, interpret=True))




@pytest.mark.parametrize("window", median_triton.WINDOWS)
@pytest.mark.parametrize("shape", [(2, 16, 128),      # tiles exactly
                                   (1, 13, 150),      # ragged rows/cols
                                   (2, 3, 8, 256)])   # two leading axes
def test_kernel_matches_xla_median(window, shape, interpreted):
    x = _planes(shape, seed=window)
    padded = _pad(x, window // 2)
    got = np.asarray(median_triton.window_median(padded, window))
    exp = np.asarray(reference.xla_window_median(padded, window))
    assert got.shape == shape
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("window", median_triton.WINDOWS)
def test_kernel_matches_oracle(window, interpreted):
    """Zero borders included: the oracle's spatial median, plane by
    plane."""
    x = _planes((2, 11, 40), seed=10 + window)
    got = np.asarray(median_triton.window_median(_pad(x, window // 2), window))
    for k in range(x.shape[0]):
        np.testing.assert_array_equal(
            got[k], oracle.spatial_median(x[k], window))


@pytest.mark.parametrize("window", [3, 7])
def test_kernel_uses_given_halo_rows(window, interpreted):
    """The row-sharded body hands the kernel its neighbours' halo rows
    instead of zeros: the kernel medians whatever padding it is given."""
    p = window // 2
    ext = _planes((2, 8 + 2 * p, 128 + 2 * p), seed=3)
    ext[..., :, :p] = 0
    ext[..., :, -p:] = 0
    ext = jnp.asarray(ext)
    np.testing.assert_array_equal(
        np.asarray(median_triton.window_median(ext, window)),
        np.asarray(reference.xla_window_median(ext, window)))


def test_kernel_under_vmap(interpreted):
    """The stream engines vmap the step over streams."""
    x = _planes((3, 2, 8, 128), seed=4)
    padded = _pad(x, 2)
    got = jax.vmap(lambda v: median_triton.window_median(v, 5))(padded)
    np.testing.assert_array_equal(
        np.asarray(got), np.asarray(reference.xla_window_median(padded, 5)))


def test_kernel_float16_compares_are_exact_at_the_extremes(interpreted):
    """Intensities span [0, 510]; float16 holds every one of them."""
    x = np.zeros((1, 8, 128), np.float32)
    x[0, ::2] = 510.0
    x[0, 1::2, ::3] = 509.0
    padded = _pad(x, 1)
    np.testing.assert_array_equal(
        np.asarray(median_triton.window_median(padded, 3)),
        np.asarray(reference.xla_window_median(padded, 3)))


def _lowered(window, platform):
    x = jnp.zeros((2, 16 + 2 * (window // 2), 128 + 2 * (window // 2)))
    f = jax.jit(functools.partial(reference.exact_window_median,
                                  window=window))
    return f.trace(x).lower(lowering_platforms=(platform,)).as_text()


@pytest.mark.parametrize("window", median_triton.WINDOWS)
def test_step_picks_the_kernel_on_gpu_only(window):
    """Lowered for CUDA the median is the Triton kernel; lowered for the
    CPU it is plain XLA (no kernel, no interpreter)."""
    assert "window_median_w" in _lowered(window, "cuda")
    cpu = _lowered(window, "cpu")
    assert "window_median_w" not in cpu and "triton" not in cpu.lower()


@pytest.mark.parametrize("window", [9, 11])
def test_unmeasured_windows_stay_on_xla(window):
    assert window not in median_triton.WINDOWS
    assert "window_median_w" not in _lowered(window, "cuda")


def test_spatial_median_modes_route():
    """approx and quirk keep their own networks; the exact path goes
    through the dispatcher and matches the oracle on the CPU."""
    x = _planes((2, 10, 30), seed=6)
    exact = np.asarray(reference.spatial_median(jnp.asarray(x), 5))
    for k in range(2):
        np.testing.assert_array_equal(exact[k],
                                      oracle.spatial_median(x[k], 5))
    approx = np.asarray(reference.spatial_median(jnp.asarray(x), 5,
                                                 approx=True))
    assert approx.shape == exact.shape and not np.array_equal(approx, exact)


@pytest.mark.gpu
@pytest.mark.parametrize("window", median_triton.WINDOWS)
def test_compiled_kernel_matches_xla_median(window):
    """The kernel as Triton compiles it for the card, at 1080p."""
    x = _planes((4, 1080, 1920), seed=window)
    padded = _pad(x, window // 2)
    got = jax.jit(functools.partial(median_triton.window_median,
                                    window=window))(padded)
    np.testing.assert_array_equal(
        np.asarray(got),
        np.asarray(reference.xla_window_median(padded, window)))
