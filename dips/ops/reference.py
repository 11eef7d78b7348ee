"""Batched jnp/XLA implementation of the DiPs pipeline.

This is the portable device path: pure ``jax.numpy`` + ``lax`` with static
shapes, jit-compiled once per (properties, geometry) — the XLA analogue of the
reference's specialised WGSL pipelines (dips/src/gpu/mod.rs:101-109),
tested against ``ops/oracle.py``.  Every engine runs this step; on a GPU
the exact spatial median of the common windows is one hand-written kernel
(``ops/median_triton.py``), chosen by window size.

Batch protocol
--------------
The reference processes one frame per dispatch with a blocking readback
(dips/src/gpu/mod.rs:346-391).  Here the host feeds **B new frames plus a
T-frame raw tail** per step (T = temporal ring length), so each step is one
device dispatch with no intra-batch host sync:

* input ``raw``: uint8 planar ``(T + B, 3, Hp, Wp)`` — frames ``[0:T]`` are
  the previous batch's last T raw frames (first batch: T copies of frame 0,
  which reproduces the oracle's ring-prefill warm-up), frames ``[T:]`` are new;
* spatial+temporal filtering yields ``B + 1`` ring medians ``cur[0..B]``,
  where ``cur[0]`` is the previous frame's value (needed by PER_FRAME mode)
  and ``cur[1..B]`` correspond to the new frames;
* ``snap_flags (B,)`` marks overall-mode baseline captures (frame 0 and
  refresh markers — ref dips_alt/src/lib.rs:668-670), resolved sequentially
  inside the step with a ``lax.scan``;
* geometry is padded to tiles (Hp multiple of 8, Wp multiple of 128) with
  a validity mask so padded pixels contribute zero diff and no statistics.

Outputs: uint8 planar maps ``(B, C, Hp, Wp)``, per-frame stats ``(B, 4)``
(``oracle.STAT_NAMES``), and the carried baseline.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..properties import (ChromaFilter, DiPsFilter, DiPsMethod,
                          DiPsProperties, OutputMode)
from . import median_triton, networks
from .oracle import INV_SIGMOID_EPS, NUM_STATS


def pad_geometry(h: int, w: int) -> Tuple[int, int]:
    """Bucket (H, W) up to tiles: H→×8, W→×128, so every geometry in a
    bucket shares one compiled step (SURVEY.md §7 'Dynamic shape
    avoidance'; analogous to the reference's 256-byte row padding,
    dips/src/gpu/mod.rs:33-37).

    W additionally keeps >= 4 columns of zero padding.  The bucketed shape
    is part of the on-disk contract: engine checkpoints, the packed wire
    format (``ops/wire.py``) and every engine's device state are laid out
    in it, so the rule stays fixed whatever the device.
    """
    hp = -(-h // 8) * 8
    wp = -(-w // 128) * 128
    if wp - w < 4:
        wp += 128
    return hp, wp


def pool_frame_host(frame_u8: "np.ndarray", k: int) -> "np.ndarray":
    """Host twin of the device decimation in :func:`make_layout_prep`:
    uint8 (H, W, C) -> (H//k, W//k, C) by k x k box mean, rounded
    half-to-even.  Bit-identical to the device path (exact integer sums,
    the same f32 ``* 1/k**2`` multiply, the same ``rint``) — the engines
    use it only for the <= T checkpoint-tail frames per batch."""
    import numpy as np
    h, w, c = frame_u8.shape
    s = frame_u8.astype(np.int32).reshape(h // k, k, w // k, k, c)
    s = s.sum(axis=(1, 3), dtype=np.int32)
    v = np.rint(s.astype(np.float32) * np.float32(1.0 / (k * k)))
    return v.astype(np.int32).astype(np.uint8)


def make_layout_prep(layout: str, height: int, width: int,
                     hp: int, wp: int, downscale: int = 1):
    """Input-layout contract shared by the engines (DiPsEngine and
    MultiStreamEngine must never drift apart on it).

    Returns ``(normalized_layout, swap_rb, prep)``: ``normalized_layout``
    is "planar" or "hwc"; ``swap_rb`` says the raw bytes are BGR
    ("hwc_bgr" — cv2's native order, swapped for free inside the device
    transpose); ``prep`` (None for planar) is a jitted device transform
    taking uint8 HWC frames with ANY number of leading batch axes to
    padded planar ``(..., 3, Hp, Wp)`` — transpose + optional channel
    swap + (8, 128) pad fused into one XLA op.

    ``downscale = k > 1`` (hwc layouts only): the prep takes FULL-RES
    frames ``(..., height*k, width*k, 3)`` and decimates them on device
    first — k x k box mean on the integer scale, rounded half-to-even
    (``pool_frame_host`` is the bit-identical host twin) — so a 4K
    camera analyzes at 1080p cost with no host resize pass.
    ``height``/``width`` are always the ANALYSIS (post-scale) dims."""
    if layout not in ("planar", "hwc", "hwc_bgr"):
        raise ValueError(f"unknown input_layout {layout!r}")
    norm = "hwc" if layout.startswith("hwc") else layout
    swap = layout == "hwc_bgr"
    k = int(downscale)
    if k < 1:
        raise ValueError(f"downscale must be >= 1, got {downscale}")
    if norm != "hwc":
        if k > 1:
            raise ValueError(
                "downscale runs on the device and needs the hwc upload "
                "path (input_layout='hwc'/'hwc_bgr')")
        return norm, swap, None

    def _prep(x):
        n = x.ndim - 3  # leading batch axes
        if k > 1:
            s = x.astype(jnp.int32).reshape(
                *x.shape[:n], height, k, width, k, 3)
            s = s.sum(axis=(n + 1, n + 3))
            x = jnp.rint(s.astype(jnp.float32)
                         * jnp.float32(1.0 / (k * k))
                         ).astype(jnp.int32).astype(jnp.uint8)
        x = jnp.transpose(x, tuple(range(n)) + (n + 2, n, n + 1))
        if swap:
            x = x[..., ::-1, :, :]
        return jnp.pad(x, ((0, 0),) * (n + 1)
                       + ((0, hp - height), (0, wp - width)))

    return norm, swap, jax.jit(_prep)


# ---------------------------------------------------------------------------
# Stage functions (jnp mirrors of ops/oracle.py)
# ---------------------------------------------------------------------------

#: See ops/oracle.INTENSITY_SCALE: filtering runs on the integer intensity
#: scale [0, 510]; the diff is scaled to [-1, 1] with one rounding.
#: Kept as a python float — a module-level jnp constant would initialise
#: the JAX backend at import time (breaking hermetic platform forcing).
INTENSITY_SCALE = 1.0 / 510.0


def intensity_planar(rgb_u8: jnp.ndarray, chroma: ChromaFilter) -> jnp.ndarray:
    """uint8 planar (..., 3, H, W) -> f32 (..., H, W) INTEGER-valued
    intensity in [0, 510] (oracle.intensity_int's jnp mirror)."""
    f = rgb_u8.astype(jnp.int32)
    if chroma == ChromaFilter.RED:
        v = 2 * f[..., 0, :, :]
    elif chroma == ChromaFilter.GREEN:
        v = 2 * f[..., 1, :, :]
    elif chroma == ChromaFilter.BLUE:
        v = 2 * f[..., 2, :, :]
    else:
        r, g, b = f[..., 0, :, :], f[..., 1, :, :], f[..., 2, :, :]
        v = (jnp.maximum(jnp.maximum(r, g), b)
             + jnp.minimum(jnp.minimum(r, g), b))
    return v.astype(jnp.float32)


def xla_window_median(padded: jnp.ndarray, window: int) -> jnp.ndarray:
    """(..., H + 2p, W + 2p) planes padded by p = window // 2 on every side
    (zeros, or a neighbour's halo rows) -> (..., H, W) exact medians.

    The column-factored plan from ops/networks.py: the w vertical shifts
    are sorted once per plane (shared by every horizontal offset) and a
    rank-pruned merge network selects the median, with no data-dependent
    sort.  Plain jnp, left to XLA; the reference for
    ``median_triton.window_median``.
    """
    p = window // 2
    h, w = padded.shape[-2] - 2 * p, padded.shape[-1] - 2 * p
    vtaps = [padded[..., dy:dy + h, :] for dy in range(window)]
    return networks.window_median(
        vtaps, lambda v, dx: v[..., p + dx:p + dx + w],
        jnp.minimum, jnp.maximum)


def exact_window_median(padded: jnp.ndarray, window: int) -> jnp.ndarray:
    """:func:`xla_window_median`, except that on a GPU the windows of
    ``median_triton.WINDOWS`` run as one Triton kernel.  The choice is
    made when the step is lowered for its platform; both give identical
    medians."""
    xla = functools.partial(xla_window_median, window=window)
    if window not in median_triton.WINDOWS:
        return xla(padded)
    return lax.platform_dependent(
        padded, cuda=functools.partial(median_triton.window_median,
                                       window=window),
        default=xla)


def spatial_median(planes: jnp.ndarray, window: int,
                   approx: bool = False, quirk: bool = False) -> jnp.ndarray:
    """(..., H, W) centered odd-window median, zero-padded borders
    (:func:`exact_window_median`).  ``approx`` selects the separable
    approximation (networks.separable_median,
    DiPsProperties.approx_median); ``quirk`` the reference's bug-for-bug
    off-center rank select (networks.quirk_window_select,
    DiPsProperties.quirk_compat).
    """
    if window <= 1:
        return planes
    p = window // 2
    h, w = planes.shape[-2], planes.shape[-1]
    pad = [(0, 0)] * (planes.ndim - 2) + [(p, p), (p, p)]
    padded = jnp.pad(planes, pad)
    if not (approx or quirk):
        return exact_window_median(padded, window)

    def shift(x, dx):
        return x[..., p + dx:p + dx + w]

    if quirk:
        vtaps = [padded[..., dy:dy + h, :] for dy in range(window - 1)]
        return networks.quirk_window_select(vtaps, shift, jnp.minimum,
                                            jnp.maximum)
    vtaps = [padded[..., dy:dy + h, :] for dy in range(window)]
    return networks.separable_median(vtaps, shift, jnp.minimum, jnp.maximum)


def temporal_median_windows(filtered: jnp.ndarray, t: int) -> jnp.ndarray:
    """(N, H, W) -> (N - t + 1, H, W): median over each length-t window."""
    n = filtered.shape[0]
    m = n - t + 1
    taps = [filtered[k:k + m] for k in range(t)]
    return networks.median_of(taps, jnp.minimum, jnp.maximum)


def emphasize(diff: jnp.ndarray, filt: DiPsFilter, sigmoid_scalar: float,
              sensitivity: float) -> jnp.ndarray:
    """Map ×0.5 → sigmoid / inverse-sigmoid / identity → ×sensitivity
    (ref dips_shader.wgsl:97-118,217-229)."""
    d = diff * jnp.float32(0.5)
    k = jnp.float32(sigmoid_scalar)
    if filt == DiPsFilter.SIGMOID:
        d = jnp.float32(1.0) / (jnp.float32(1.0) + jnp.exp(-k * d)) - jnp.float32(0.5)
    elif filt == DiPsFilter.INVERSE_SIGMOID:
        dc = jnp.clip(d, -0.5 + INV_SIGMOID_EPS, 0.5 - INV_SIGMOID_EPS)
        d = -jnp.log(jnp.float32(1.0) / (dc + jnp.float32(0.5)) - jnp.float32(1.0)) / k
    return d * jnp.float32(sensitivity)


def diff_to_color_planes(d: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Signed diff -> (r, g, b) f32 planes: red negative, green positive
    (closed form of the reference's HSL call at l=0.5, dips_shader.wgsl:30-36)."""
    s = jnp.abs(d)
    hi = jnp.float32(0.5) + s * jnp.float32(0.5)
    lo = jnp.float32(0.5) - s * jnp.float32(0.5)
    neg = d < 0
    r = jnp.where(neg, hi, lo)
    g = jnp.where(neg, lo, hi)
    return r, g, lo


def quantize_u8(x: jnp.ndarray) -> jnp.ndarray:
    """f32 [0,1] -> uint8 round-half-even (rgba8unorm store semantics)."""
    return jnp.rint(jnp.clip(x, 0.0, 1.0) * jnp.float32(255.0)).astype(jnp.uint8)


def masked_stats(raw_diff: jnp.ndarray, n_valid: int,
                 change_threshold: int) -> jnp.ndarray:
    """(B, H, W) masked raw diff -> (B, NUM_STATS) f32 reductions."""
    a = jnp.abs(raw_diff)
    thr = jnp.float32(change_threshold) / jnp.float32(255.0)
    inv_n = jnp.float32(1.0 / n_valid)
    return jnp.stack([
        jnp.sum(raw_diff, axis=(-2, -1)) * inv_n,
        jnp.sum(a, axis=(-2, -1)) * inv_n,
        jnp.max(a, axis=(-2, -1)),
        jnp.sum((a >= thr).astype(jnp.float32), axis=(-2, -1)),
    ], axis=-1)


def capture_scan(baseline, cur, flags):
    """OVERALL-mode baseline pinning, resolved sequentially inside the step:
    returns (carried baseline, per-frame pinned baselines).  Shared by the
    single-device step and the row-sharded body so their semantics cannot
    drift."""
    def capture(bl, xs):
        c, flag = xs
        bl = jnp.where(flag, c, bl)
        return bl, bl
    return lax.scan(capture, baseline, (cur, flags))


def render_output(props: DiPsProperties, d: jnp.ndarray, cur: jnp.ndarray,
                  flags: jnp.ndarray) -> jnp.ndarray:
    """Emphasised diff -> quantized uint8 maps; OVERALL capture frames
    render the freshly pinned baseline as gray (ref snapshot branch,
    dips_alt/.../pre_compute_shader.wgsl:231-235).  Shared by batch_step
    and the row-sharded body."""
    if props.output == OutputMode.COLORIZE:
        r, g, bch = diff_to_color_planes(d)
        out = jnp.stack([r, g, bch], axis=1)              # (B, 3, H, W)
    else:  # GRAYSCALE: 0.5 - diff (ref dips_shader.wgsl:236)
        out = (jnp.float32(0.5) - d)[:, None]             # (B, 1, H, W)
    if props.method == DiPsMethod.OVERALL:
        out = jnp.where(flags[:, None, None, None],
                        (cur * jnp.float32(INTENSITY_SCALE))[:, None], out)
    return quantize_u8(out)


def valid_mask(hp: int, wp: int, h: int, w: int,
               roi=None) -> jnp.ndarray:
    """(Hp, Wp) f32 mask: 1 on true pixels, 0 on tile padding.  With
    ``roi`` = (y0, x0, y1, x1) the mask is that analysis rectangle instead
    (the caller validates it against h x w via props.roi_bounds)."""
    y0, x0, y1, x1 = (0, 0, h, w) if roi is None else roi
    rows = lax.broadcasted_iota(jnp.int32, (hp, wp), 0)
    cols = lax.broadcasted_iota(jnp.int32, (hp, wp), 1)
    return ((rows >= y0) & (rows < y1)
            & (cols >= x0) & (cols < x1)).astype(jnp.float32)


# ---------------------------------------------------------------------------
# Full batched step (median/emphasis modes)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnums=(0, 1, 2),
                   donate_argnums=(4, 6))  # baseline/heatmap update in place
def batch_step(props: DiPsProperties, h: int, w: int,
               raw: jnp.ndarray, baseline: jnp.ndarray,
               snap_flags: jnp.ndarray, heatmap: jnp.ndarray,
               valid: jnp.ndarray
               ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """One device step over B new frames (see module docstring).

    Args:
      props: static pipeline configuration (specialises the compile).
      h, w: true (unpadded) image geometry, static.
      raw: uint8 (T + B, 3, Hp, Wp) planar frames, tail-first.
      baseline: f32 (Hp, Wp) carried overall-mode baseline.
      snap_flags: bool (B,) overall-mode capture flags for the new frames.
      heatmap: f32 (Hp, Wp) accumulated |diff| carry (BASELINE configs[2]).
      valid: bool (B,) — False for the replicated padding frames of a
        partial batch (their diffs must not reach carried accumulators).

    Returns: (out_u8 (B, C, Hp, Wp), stats (B, NUM_STATS), new_baseline,
    new_heatmap).
    """
    t = props.temporal_size
    hp, wp = raw.shape[-2], raw.shape[-1]
    mask = valid_mask(hp, wp, h, w)

    planes = intensity_planar(raw, props.chroma)          # (T+B, Hp, Wp)
    filtered = spatial_median(planes, props.window_size, props.approx_median,
                              props.quirk_compat)
    if props.quirk_compat:
        # rgba8unorm store-back of the filtered plane before the temporal
        # median (dips_shader.wgsl:187): round to the uint8 grid = even
        # integers on the [0, 510] scale, half-to-even
        filtered = jnp.float32(2.0) * jnp.rint(filtered * jnp.float32(0.5))
    cur_all = temporal_median_windows(filtered, t)        # (B+1, Hp, Wp)
    prev, cur = cur_all[:-1], cur_all[1:]                 # each (B, Hp, Wp)

    if props.method == DiPsMethod.OVERALL:
        new_baseline, baselines = capture_scan(baseline, cur, snap_flags)
        raw_diff = (baselines - cur) * jnp.float32(INTENSITY_SCALE)
    else:  # PER_FRAME: diff vs previous ring median; flags are inert
        new_baseline = baseline
        raw_diff = (prev - cur) * jnp.float32(INTENSITY_SCALE)

    raw_diff = raw_diff * mask
    # statistics/heatmap reduce over the analysis region (roi or the whole
    # frame); the OUTPUT path keeps the full-frame raw_diff
    if props.roi is None:
        dm = raw_diff
    else:
        dm = raw_diff * valid_mask(hp, wp, h, w, props.roi_bounds(h, w))
    stats = masked_stats(dm, props.analysis_pixels(h, w),
                         props.change_threshold)
    vw = valid.astype(jnp.float32)[:, None, None]
    heatmap = heatmap + jnp.sum(jnp.abs(dm) * vw, axis=0)

    if props.out_channels == 0:
        # emit_maps=False: full median pipeline ran for stats/heatmap,
        # no emphasis/quantize and a zero-channel output (no map bytes)
        out = jnp.zeros((raw_diff.shape[0], 0, hp, wp), jnp.uint8)
        return out, stats, new_baseline, heatmap
    d = emphasize(raw_diff, props.filter, props.sigmoid_horizontal_scalar,
                  props.sensitivity)
    # (Stats need no special-casing: the scan pins the baseline *before*
    # diffing, so capture frames already have an exactly-zero diff map.)
    return (render_output(props, d, cur, snap_flags), stats, new_baseline,
            heatmap)


# ---------------------------------------------------------------------------
# Raw uint8 fast path: ABSDIFF / THRESHOLD (cv2.absdiff parity surface)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnums=(0, 1, 2),
                   donate_argnums=(4, 6))  # baseline/heatmap update in place
def absdiff_step(props: DiPsProperties, h: int, w: int,
                 raw: jnp.ndarray, baseline_raw: jnp.ndarray,
                 snap_flags: jnp.ndarray, heatmap: jnp.ndarray,
                 valid: jnp.ndarray
                 ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Bit-exact uint8 absdiff/threshold step (the cv2.absdiff parity mode).

    Same protocol as :func:`batch_step`, but the diff is integer
    ``|cur - baseline|`` on the raw planar frames — byte-equal to
    ``cv2.absdiff``.  Stats keep the f32 intensity-diff convention so the two
    paths report comparable reductions.

    Args/returns as :func:`batch_step`, with ``baseline_raw`` uint8
    ``(3, Hp, Wp)`` and C = 3 (ABSDIFF), 1 (THRESHOLD) or 0 (STATS_ONLY:
    no map — statistics and heatmap only, the events-fleet shape).
    """
    t = props.temporal_size
    new = raw[t:]                                          # (B, 3, Hp, Wp)
    prev_raw = raw[t - 1:-1]

    if props.method == DiPsMethod.OVERALL:
        new_baseline, baselines = capture_scan(baseline_raw, new,
                                               snap_flags)
    else:
        new_baseline = baseline_raw
        baselines = prev_raw

    # Integer domain throughout (tile padding is zero in both operands, so
    # the dead zone contributes nothing to any reduction).
    signed = baselines.astype(jnp.int16) - new.astype(jnp.int16)
    d16 = jnp.abs(signed)
    d_u8 = d16.astype(jnp.uint8)                           # (B, 3, Hp, Wp)
    dmax = jnp.max(d_u8, axis=1, keepdims=True)

    # Channel-mean statistics on the uint8 diff (oracle._process_raw),
    # reduced over the analysis region (tile padding is zero in both
    # operands, so full-frame mode needs no mask at all).
    hp, wp = raw.shape[-2], raw.shape[-1]
    inv = jnp.float32(1.0 / (3 * props.analysis_pixels(h, w) * 255))
    sf = signed.astype(jnp.float32)
    af = d16.astype(jnp.float32)
    changed = (dmax[:, 0] >= jnp.uint8(props.change_threshold)
               ).astype(jnp.float32)
    if props.roi is not None:
        rm = valid_mask(hp, wp, h, w, props.roi_bounds(h, w))
        sf = sf * rm
        af = af * rm
        changed = changed * rm
    stats = jnp.stack([
        jnp.sum(sf, axis=(1, 2, 3)) * inv,
        jnp.sum(af, axis=(1, 2, 3)) * inv,
        jnp.max(af, axis=(1, 2, 3)) * jnp.float32(1 / 255.0),
        jnp.sum(changed, axis=(1, 2)),
    ], axis=-1)
    vw = valid.astype(jnp.float32)[:, None, None]
    heatmap = heatmap + jnp.sum(
        jnp.sum(af, axis=1) * jnp.float32(1.0 / (3 * 255.0)) * vw, axis=0)

    if props.out_channels == 0:
        # STATS_ONLY or emit_maps=False: zero-channel output — nothing to
        # compute, (near-)nothing to move
        out = jnp.zeros((d_u8.shape[0], 0) + d_u8.shape[2:], jnp.uint8)
    elif props.output == OutputMode.THRESHOLD:
        out = jnp.where(dmax >= jnp.uint8(props.change_threshold),
                        jnp.uint8(255), jnp.uint8(0))
    else:
        out = d_u8
    return out, stats, new_baseline, heatmap
