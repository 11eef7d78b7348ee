"""Test configuration: run everything on a virtual 8-device CPU mesh.

Unless ``JAX_PLATFORMS`` names a platform, the CPU backend is forced
before any jax backend initialisation, and the host is split into 8
virtual devices for the sharding tests (SURVEY.md §4: meshes degrade to
CPU via xla_force_host_platform_device_count).  What only a GPU can run
is marked ``gpu`` and skips on the CPU; on the card run it with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_median_triton.py``.
"""

import os

os.environ["XLA_FLAGS"] = (
    "--xla_force_host_platform_device_count=8 "
    + os.environ.get("XLA_FLAGS", ""))

import jax  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """``gpu`` tests need a compiled kernel on the card; elsewhere they
    skip.  Decided per test, never at collection, so every xdist worker
    collects the same tests."""
    if (request.node.get_closest_marker("gpu")
            and jax.devices()[0].platform != "gpu"):
        pytest.skip("needs an NVIDIA GPU: a compiled Triton kernel has no "
                    "CPU form (chip_smoke.py runs it on the card)")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def make_clip(n=12, h=12, w=140, seed=0, moving=True):
    """Synthetic uint8 RGB clip: static noise background + a moving bright
    square, so overall and per-frame modes both see real signal."""
    r = np.random.default_rng(seed)
    base = r.integers(0, 256, (h, w, 3), np.uint8)
    frames = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        f = base.copy()
        if moving:
            y = (2 + i) % max(h - 4, 1)
            x = (3 + 2 * i) % max(w - 4, 1)
            f[y:y + 4, x:x + 4] = [250, 30, 30]
        frames[i] = f
    return frames


@pytest.fixture(scope="session")
def clip():
    return make_clip()
