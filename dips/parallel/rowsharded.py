"""Row-sharded single-stream processing: spatial parallelism over the mesh.

Data parallelism over streams (multistream.py) is the primary scaling axis,
but a single enormous stream (e.g. 8K/16K scientific captures) can also be
split *spatially*: each device owns a horizontal slab of every frame, and
the spatial median's stencil halo rows are exchanged between neighbouring
devices with ``jax.lax.ppermute`` before filtering — the sequence-
parallel analogue for this workload (frames have no sequence axis to split,
but they do have rows; SURVEY.md §2 calls every other axis N/A).

Everything else (temporal median, baseline capture, diff, emphasis, stats)
is row-local, so after the halo exchange each shard runs the standard
pipeline stages on its slab; per-frame statistics are reduced with ``psum``.

Semantics match ``ops/reference.batch_step`` exactly (same oracle) — tested
slab-for-slab against the single-device path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..properties import DiPsMethod, DiPsProperties, OutputMode
from ..ops import reference
from ..ops.networks import quirk_window_select, separable_median


def _halo_exchange(slab: jnp.ndarray, p: int, axis: str) -> jnp.ndarray:
    """(..., Hs, W) -> (..., Hs + 2p, W): neighbours' boundary rows.

    The first shard's top halo and the last shard's bottom halo are zero
    (the pipeline's zero out-of-bounds stencil semantics).
    """
    n = lax.axis_size(axis)
    idx = lax.axis_index(axis)
    # send my bottom rows DOWN (to idx+1) -> they become his top halo
    down = [(i, (i + 1) % n) for i in range(n)]
    top_halo = lax.ppermute(slab[..., -p:, :], axis, down)
    # send my top rows UP (to idx-1) -> they become his bottom halo
    up = [(i, (i - 1) % n) for i in range(n)]
    bottom_halo = lax.ppermute(slab[..., :p, :], axis, up)
    zero = jnp.zeros_like(top_halo)
    top_halo = jnp.where(idx == 0, zero, top_halo)
    bottom_halo = jnp.where(idx == n - 1, zero, bottom_halo)
    return jnp.concatenate([top_halo, slab, bottom_halo], axis=-2)


def make_rowsharded_step(props: DiPsProperties, h: int, w: int, mesh: Mesh,
                         axis: str = "rows"):
    """Jitted single-stream step with the H axis sharded over ``mesh``.

    Maps raw u8 (T+B, 3, Hp, Wp), baseline (Hp, Wp) f32 (median modes) or
    (3, Hp, Wp) u8 (raw modes), flags (B,), heatmap (Hp, Wp), valid (B,)
    -> (out u8 (B, C, Hp, Wp), stats (B, NUM_STATS), new baseline, new
    heatmap); Hp must divide evenly by the mesh size.

    Median/emphasis modes exchange the spatial stencil's halo rows between
    neighbouring devices; RAW modes (absdiff/threshold/stats-only) have no
    stencil, so no halo at all — each shard diffs its slab independently
    and only the statistic reductions cross devices (psum/pmax).
    Row-sharding a raw mode is a bandwidth play, not a stencil one: R row
    shards add up R devices' memory bandwidth for one enormous stream (the
    8K-class deployment this module's docstring motivates).
    """
    hp = reference.pad_geometry(h, w)[0]
    if hp % mesh.shape[axis]:
        raise ValueError(f"{mesh.shape[axis]} row shards must divide the "
                         f"padded height {hp}")
    raw_mode = props.output in (OutputMode.ABSDIFF, OutputMode.THRESHOLD,
                                OutputMode.STATS_ONLY)
    if raw_mode:
        return _make_rowsharded_raw_step(props, h, w, mesh, axis)

    def per_shard(raw, baseline, flags, heatmap, valid):
        return _row_body(props, h, w, raw, baseline, flags, heatmap,
                         valid, axis)

    sharded = jax.shard_map(
        per_shard, mesh=mesh,
        in_specs=(P(None, None, axis, None), P(axis, None), P(None),
                  P(axis, None), P(None)),
        out_specs=(P(None, None, axis, None), P(None), P(axis, None),
                   P(axis, None)),
        check_vma=False)
    return jax.jit(sharded, donate_argnums=(1, 3))


def _raw_row_body(props, h, w, raw, baseline, flags, heatmap, valid, axis):
    """Portable XLA raw (absdiff/threshold/stats-only) slab body: integer
    diff on the owned rows, roi masking in GLOBAL row coordinates,
    statistics reduced over ``axis`` (psum/pmax).  Mirrors
    ops/reference.absdiff_step's conventions slab-locally."""
    t = props.temporal_size
    hs, wp = raw.shape[-2], raw.shape[-1]
    row0 = lax.axis_index(axis) * hs
    new = raw[t:]
    prev_raw = raw[t - 1:-1]
    if props.method == DiPsMethod.OVERALL:
        new_baseline, baselines = reference.capture_scan(baseline, new,
                                                         flags)
    else:
        new_baseline = baseline
        baselines = prev_raw

    signed = baselines.astype(jnp.int16) - new.astype(jnp.int16)
    d16 = jnp.abs(signed)
    d_u8 = d16.astype(jnp.uint8)
    dmax = jnp.max(d_u8, axis=1, keepdims=True)

    inv = jnp.float32(1.0 / (3 * props.analysis_pixels(h, w) * 255))
    sf = signed.astype(jnp.float32)
    af = d16.astype(jnp.float32)
    changed = (dmax[:, 0] >= jnp.uint8(props.change_threshold)
               ).astype(jnp.float32)
    if props.roi is not None:
        y0, x0, y1, x1 = props.roi_bounds(h, w)
        rows = lax.broadcasted_iota(jnp.int32, (hs, wp), 0) + row0
        cols = lax.broadcasted_iota(jnp.int32, (hs, wp), 1)
        rm = ((rows >= y0) & (rows < y1) & (cols >= x0)
              & (cols < x1)).astype(jnp.float32)
        sf = sf * rm
        af = af * rm
        changed = changed * rm
    stats = jnp.stack([
        lax.psum(jnp.sum(sf, axis=(1, 2, 3)), axis) * inv,
        lax.psum(jnp.sum(af, axis=(1, 2, 3)), axis) * inv,
        lax.pmax(jnp.max(af, axis=(1, 2, 3)), axis) * jnp.float32(1 / 255.),
        lax.psum(jnp.sum(changed, axis=(1, 2)), axis),
    ], axis=-1)
    vw = valid.astype(jnp.float32)[:, None, None]
    heatmap = heatmap + jnp.sum(
        jnp.sum(af, axis=1) * jnp.float32(1.0 / (3 * 255.0)) * vw, axis=0)

    if props.out_channels == 0:
        out = jnp.zeros((d_u8.shape[0], 0, hs, wp), jnp.uint8)
    elif props.output == OutputMode.THRESHOLD:
        out = jnp.where(dmax >= jnp.uint8(props.change_threshold),
                        jnp.uint8(255), jnp.uint8(0))
    else:
        out = d_u8
    return out, stats, new_baseline, heatmap


def _make_rowsharded_raw_step(props, h, w, mesh, axis):
    """Raw-mode body of :func:`make_rowsharded_step` (no halo; the stats
    collectives are the only cross-device traffic).  Baseline is u8
    (3, Hp, Wp)."""

    def per_shard(raw, baseline, flags, heatmap, valid):
        return _raw_row_body(props, h, w, raw, baseline, flags,
                             heatmap, valid, axis)

    sharded = jax.shard_map(
        per_shard, mesh=mesh,
        in_specs=(P(None, None, axis, None), P(None, axis, None), P(None),
                  P(axis, None), P(None)),
        out_specs=(P(None, None, axis, None), P(None), P(None, axis, None),
                   P(axis, None)),
        check_vma=False)
    return jax.jit(sharded, donate_argnums=(1, 3))


def _row_body(props, h, w, raw, baseline, flags, heatmap, valid, axis):
    """Single-stream row-slab pipeline body (shared with rowsharded.py's
    per_shard, factored for vmap over streams).

    Statistics here are reduced over ``axis`` only; the caller combines
    streams.
    """
    t = props.temporal_size
    window = props.window_size
    p = window // 2
    hs, wp = raw.shape[-2], raw.shape[-1]
    if hs < p:
        raise ValueError(f"row slab {hs} < halo {p}")
    row0 = lax.axis_index(axis) * hs

    planes = reference.intensity_planar(raw, props.chroma)
    if window > 1:
        ext = _halo_exchange(planes, p, axis)
        ext = jnp.pad(ext, [(0, 0), (0, 0), (p, p)])
        vtaps = [ext[:, dy:dy + hs, :] for dy in range(window)]

        def shift(x, dx):
            return x[..., p + dx:p + dx + wp]

        if props.quirk_compat:
            filtered = quirk_window_select(vtaps[:window - 1], shift,
                                           jnp.minimum, jnp.maximum)
        elif props.approx_median:
            filtered = separable_median(vtaps, shift, jnp.minimum,
                                        jnp.maximum)
        else:
            filtered = reference.exact_window_median(ext, window)
    else:
        filtered = planes
    if props.quirk_compat:
        # rgba8unorm store-back quantization before the temporal median
        # (see ops/reference.batch_step)
        filtered = jnp.float32(2.0) * jnp.rint(filtered * jnp.float32(0.5))
    cur_all = reference.temporal_median_windows(filtered, t)
    prev, cur = cur_all[:-1], cur_all[1:]

    if props.method == DiPsMethod.OVERALL:
        new_baseline, baselines = reference.capture_scan(baseline, cur, flags)
        raw_diff = (baselines - cur) * jnp.float32(reference.INTENSITY_SCALE)
    else:
        new_baseline = baseline
        raw_diff = (prev - cur) * jnp.float32(reference.INTENSITY_SCALE)

    rows = lax.broadcasted_iota(jnp.int32, (hs, wp), 0) + row0
    cols = lax.broadcasted_iota(jnp.int32, (hs, wp), 1)
    mask = ((rows < h) & (cols < w)).astype(jnp.float32)
    raw_diff = raw_diff * mask

    # statistics/heatmap reduce over the analysis region (roi bounds are
    # GLOBAL row coordinates — exactly what ``rows`` carries here); the
    # output path keeps the validity-masked full frame
    if props.roi is None:
        dm = raw_diff
    else:
        y0, x0, y1, x1 = props.roi_bounds(h, w)
        rm = ((rows >= y0) & (rows < y1) & (cols >= x0)
              & (cols < x1)).astype(jnp.float32)
        dm = raw_diff * rm
    a = jnp.abs(dm)
    thr = jnp.float32(props.change_threshold) / jnp.float32(255.0)
    inv_n = jnp.float32(1.0 / props.analysis_pixels(h, w))
    stats = jnp.stack([
        lax.psum(jnp.sum(dm, axis=(-2, -1)), axis) * inv_n,
        lax.psum(jnp.sum(a, axis=(-2, -1)), axis) * inv_n,
        lax.pmax(jnp.max(a, axis=(-2, -1)), axis),
        lax.psum(jnp.sum((a >= thr).astype(jnp.float32), axis=(-2, -1)),
                 axis),
    ], axis=-1)
    vw = valid.astype(jnp.float32)[:, None, None]
    heatmap = heatmap + jnp.sum(a * vw, axis=0)

    if props.out_channels == 0:
        # emit_maps=False: median-pipeline stats/heatmap, zero-channel maps
        out = jnp.zeros((raw_diff.shape[0], 0, hs, wp), jnp.uint8)
        return out, stats, new_baseline, heatmap
    d = reference.emphasize(raw_diff, props.filter,
                            props.sigmoid_horizontal_scalar,
                            props.sensitivity)
    out = reference.render_output(props, d, cur, flags)
    return out, stats, new_baseline, heatmap
