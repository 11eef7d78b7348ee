"""Composite 2-D mesh sharding: streams x rows.

Combines the two parallel axes on one ``Mesh((S, R), ("stream", "rows"))``:
each device owns a horizontal slab of one subset of streams.  Stencil halos
travel between row-neighbours via ppermute (as in rowsharded.py), per-frame
statistics reduce over the row axis, and the optional global scalar reduces
over both axes.

This is the deployment shape for "many huge streams": e.g. 16 devices as a
(4 streams x 4 slabs) grid.

MEDIAN modes vmap the row-slab body (``rowsharded._row_body``) over the
shard's local streams.  RAW modes (absdiff/threshold/stats-only) have no
stencil at all: no halo — each device diffs its slab of its streams
independently (``rowsharded._raw_row_body``) and only the statistic
reductions cross devices.  This is the no-map events fleet on a mesh.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.reference import pad_geometry
from ..properties import DiPsProperties, OutputMode
from .rowsharded import _raw_row_body, _row_body


def grid_mesh(n_streams_axis: int, n_rows_axis: int,
              devices=None) -> Mesh:
    """A (stream, rows) 2-D mesh over the first S*R devices."""
    if n_streams_axis < 1 or n_rows_axis < 1:
        # numpy reshape(-1, R) would silently reinterpret a negative axis
        # into a valid-looking (but wrong-topology) mesh
        raise ValueError(
            f"mesh axes must be >= 1, got {n_streams_axis}x{n_rows_axis}")
    if devices is None:
        devices = jax.devices()
    need = n_streams_axis * n_rows_axis
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    arr = np.asarray(devices[:need]).reshape(n_streams_axis, n_rows_axis)
    return Mesh(arr, ("stream", "rows"))


def _grid_gmean(stats, valid):
    """Valid-slot-masked global mean |diff| over BOTH mesh axes.  Stats
    are full-frame values replicated on every rows shard (the bodies
    reduce over "rows" internally), so the extra "rows" psum cancels
    between total and count."""
    vw = valid.astype(jnp.float32)
    total = lax.psum(lax.psum(jnp.sum(stats[..., 1] * vw), "rows"),
                     "stream")
    count = lax.psum(lax.psum(jnp.sum(vw), "rows"), "stream")
    return total / jnp.maximum(count, 1.0)


def _make_grid_raw_step(props: DiPsProperties, h: int, w: int, mesh: Mesh):
    """Raw-mode (absdiff/threshold/stats-only) body of
    :func:`make_grid_step`: same signature, u8 (S, 3, Hp, Wp) baseline.
    This is the fleet-on-a-mesh shape (many huge cameras in a no-map
    events fleet) when stream count alone cannot use all devices: S stream
    shards x R row slabs, no halo at all."""

    def per_shard(raw, baseline, flags, heatmap, valid):
        def one_stream(r, bl, fl, hm, vd):
            return _raw_row_body(props, h, w, r, bl, fl, hm, vd, "rows")
        out, stats, nb, nh = jax.vmap(one_stream)(
            raw, baseline, flags, heatmap, valid)
        return out, stats, nb, nh, _grid_gmean(stats, valid)

    sharded = jax.shard_map(
        per_shard, mesh=mesh,
        in_specs=(P("stream", None, None, "rows", None),   # raw
                  P("stream", None, "rows", None),         # baseline u8
                  P("stream"),                             # flags
                  P("stream", "rows", None),               # heatmap
                  P("stream")),                            # valid
        out_specs=(P("stream", None, None, "rows", None),  # out
                   P("stream", None, None),                # stats (row-dup)
                   P("stream", None, "rows", None),        # baseline
                   P("stream", "rows", None),              # heatmap
                   P()),                                   # global scalar
        check_vma=False)
    return jax.jit(sharded, donate_argnums=(1, 3))


def make_grid_step(props: DiPsProperties, h: int, w: int, mesh: Mesh):
    """Jitted step over a ("stream", "rows") mesh.

    Maps raw u8 (S, T+B, 3, Hp, Wp), baseline (S, Hp, Wp), flags (S, B),
    heatmap (S, Hp, Wp), valid (S, B) -> (out (S, B, C, Hp, Wp),
    stats (S, B, NUM_STATS), new baseline, new heatmap, global scalar).
    S must divide by the stream axis, Hp by the rows axis.

    RAW modes (absdiff/threshold/stats-only) carry a u8 (S, 3, Hp, Wp)
    baseline and need no halo at all (no stencil): each device diffs its
    slab of its streams independently and only the statistic reductions
    cross devices (:func:`_make_grid_raw_step`).
    """
    hp = pad_geometry(h, w)[0]
    if hp % mesh.shape["rows"]:
        raise ValueError(f"rows axis {mesh.shape['rows']} must divide the "
                         f"padded height {hp}")
    if props.output in (OutputMode.ABSDIFF, OutputMode.THRESHOLD,
                        OutputMode.STATS_ONLY):
        # raw modes: no stencil, no halo — their own body (u8 baseline)
        return _make_grid_raw_step(props, h, w, mesh)

    def per_shard(raw, baseline, flags, heatmap, valid):
        # raw: (S_local, T+B, 3, Hs, Wp) — vmap the row-slab body over
        # the local stream axis; collectives inside reference the
        # "rows" axis name, which vmap passes through untouched.
        def one_stream(r, bl, fl, hm, vd):
            return _row_body(props, h, w, r, bl, fl, hm, vd, "rows")
        out, stats, new_b, new_h = jax.vmap(one_stream)(
            raw, baseline, flags, heatmap, valid)
        return out, stats, new_b, new_h, _grid_gmean(stats, valid)

    sharded = jax.shard_map(
        per_shard, mesh=mesh,
        in_specs=(P("stream", None, None, "rows", None),
                  P("stream", "rows", None), P("stream"),
                  P("stream", "rows", None), P("stream")),
        out_specs=(P("stream", None, None, "rows", None),
                   P("stream", None, None), P("stream", "rows", None),
                   P("stream", "rows", None), P()),
        check_vma=False)
    return jax.jit(sharded, donate_argnums=(1, 3))
