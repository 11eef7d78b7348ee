"""Hermetic multi-chip dry run: the driver-facing sharding validation.

Run as ``python -m dips._dryrun N``: forces an N-device **virtual CPU
mesh** before any JAX backend is initialised — regardless of parent-process
environment (a parent may already hold an accelerator) — then compiles +
executes every multi-chip path on tiny shapes:

  1. data parallelism over streams (shard_map + psum), plus the
     multi-host engine's global-array plumbing;
  2. spatial row sharding of one stream with ppermute halo exchange
     (median and raw modes);
  3. the composite 2-D (stream x rows) grid (median and raw modes).

``__graft_entry__.dryrun_multichip`` invokes this module in a fresh
subprocess so the platform forcing can never race a pre-initialised backend
(an in-process guard keyed off env vars would silently land the mesh work
on the accelerator).  Failures propagate loudly: non-zero exit, traceback
on stderr.
"""

from __future__ import annotations

import os
import sys


def run(n_devices: int) -> None:
    """The mesh workload.  Requires >= n_devices JAX devices (the caller is
    responsible for platform setup; see :func:`main`)."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    from dips.parallel import (MultiStreamEngine, make_rowsharded_step,
                               stream_mesh)
    from dips.parallel.grid2d import grid_mesh
    from dips.properties import DiPsFilter, DiPsProperties
    from dips.ops.reference import pad_geometry

    have = len(jax.devices())
    if have < n_devices:
        raise RuntimeError(
            f"dryrun needs {n_devices} devices, backend "
            f"{jax.default_backend()!r} provides {have}")

    props = DiPsProperties(window_size=3, temporal_size=2,
                           filter=DiPsFilter.SIGMOID)
    h, w = 16, 24
    s = n_devices
    rng = np.random.default_rng(0)
    feeds = [[rng.integers(0, 256, (h, w, 3), np.uint8) for _ in range(2)]
             for _ in range(s)]

    # 1. stream-axis data parallelism, planar and device-side hwc layouts
    mesh = stream_mesh(n_devices)
    for layout in ("planar", "hwc"):
        eng = MultiStreamEngine(props, h, w, n_streams=s, batch=2,
                                mesh=mesh, input_layout=layout)
        out, stats, gmean = eng.process_batch(feeds)
        assert out.shape == (s, 2, h, w, 3), (layout, out.shape)
        assert np.isfinite(stats).all() and np.isfinite(gmean), layout

    # 1b. the multi-host engine: in a single process it degenerates to
    # every stream being local, but the global-array plumbing
    # (make_array_from_single_device_arrays in, addressable-shard gather
    # out) is exactly what runs per host on a cluster.  Median and raw
    # (events-fleet) modes, two batches so the carried baseline/heatmap
    # cross a step boundary inside global arrays
    from dips.parallel import MultiHostStreamEngine
    from dips.properties import OutputMode
    for mh_props, c in ((props, 3),
                        (DiPsProperties(output=OutputMode.STATS_ONLY,
                                        temporal_size=2), 0)):
        mh = MultiHostStreamEngine(mh_props, h, w, n_streams=s, batch=2,
                                   mesh=mesh)
        assert mh.local_stream_ids == list(range(s))
        feed = mh.local_frames_template()
        for si in mh.local_stream_ids:
            feed[si] = feeds[si]
        for _ in range(2):
            mout, mstats, mgmean = mh.process_batch(feed)
            assert mout.shape == (s, 2, h, w, c), mout.shape
            assert np.isfinite(mstats).all() and np.isfinite(mgmean)

    # 2. spatial row sharding with halo exchange (ppermute), median and
    # raw (absdiff) modes — the 8K-class single-enormous-stream shape
    # (tiny stand-in geometry)
    rows_mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:n_devices]),
                                  ("rows",))
    hh = max(8 * n_devices, 16)  # >= 1 tile row per device
    hp, wp = pad_geometry(hh, 24)
    t, b = props.temporal_size, 2
    raw = jnp.asarray(rng.integers(0, 256, (t + b, 3, hp, wp), np.uint8))
    rawp = DiPsProperties(output=OutputMode.ABSDIFF, temporal_size=t)
    for rp, bl in ((props, jnp.zeros((hp, wp), jnp.float32)),
                   (rawp, jnp.zeros((3, hp, wp), jnp.uint8))):
        step = make_rowsharded_step(rp, hh, 24, rows_mesh)
        out2, stats2, _, _ = step(
            raw, bl, jnp.asarray([True, False]),
            jnp.zeros((hp, wp), jnp.float32), jnp.ones((b,), bool))
        assert out2.shape[0] == b and np.isfinite(np.asarray(stats2)).all()

    # 3. composite 2-D grid: streams x row slabs on one mesh, median and
    # raw modes through the full engine surface (two batches)
    s_ax = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    r_ax = n_devices // s_ax
    gmesh = grid_mesh(s_ax, r_ax)
    gh = 8 * r_ax
    for gp in (props, rawp):
        geng = MultiStreamEngine(gp, gh, 24, n_streams=s_ax, batch=b,
                                 mesh=gmesh)
        gfeeds = [[rng.integers(0, 256, (gh, 24, 3), np.uint8)
                   for _ in range(b)] for _ in range(s_ax)]
        for _ in range(2):
            gout, gstats, ggm = geng.process_batch(gfeeds)
            assert gout.shape == (s_ax, b, gh, 24, 3)
            assert np.isfinite(gstats).all() and np.isfinite(ggm)


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    n = int(args[0]) if args else 8

    # Platform forcing MUST precede any backend initialisation.  Replace any
    # inherited host-device-count flag with ours, then pin the CPU platform
    # via jax.config (which wins over an inherited JAX_PLATFORMS).
    # No try/except: if the config update fails the backend was already
    # initialised and this process cannot honestly dry-run — fail loudly.
    flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
             if "xla_force_host_platform_device_count" not in f]
    os.environ["XLA_FLAGS"] = " ".join(
        [f"--xla_force_host_platform_device_count={n}"] + flags)
    import jax
    jax.config.update("jax_platforms", "cpu")

    # Persistent compile cache (keyed on platform, so CPU entries never
    # collide with the accelerator ones bench.py writes).
    from dips.utils.compilecache import enable_compile_cache
    enable_compile_cache()

    run(n)
    print("DRYRUN-OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
