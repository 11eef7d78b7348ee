"""Multi-stream sharding: batch many videos across a device mesh.

The reference is strictly one process / one GPU / one stream (SURVEY.md §2
parallelism inventory).  The meaningful parallelism for this workload is
**data parallelism over streams**: stack S independent video streams, shard
the stream axis over a 1-D device mesh with ``jax.shard_map``, run the
per-stream pipeline on each shard, and reduce global statistics with
``psum`` — XLA inserts the collectives (SURVEY.md §2 "Communication
backend" row).

Tensor/pipeline/sequence/expert parallelism are N/A for this workload (no
matmuls, no sequence attention — SURVEY.md §2): a frame's pixel math is
local, so the only cross-device axes are streams (here) and, for a single
giant stream, row-sharding (parallel/rowsharded.py).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..errors import StreamError
from ..properties import DiPsProperties, OutputMode
from ..ops import reference
from ..ops.oracle import NUM_STATS

_RAW_MODES = (OutputMode.ABSDIFF, OutputMode.THRESHOLD,
              OutputMode.STATS_ONLY)


def stream_mesh(n_devices: Optional[int] = None,
                devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """A 1-D mesh over the stream axis (``jax.devices()`` order)."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            if n_devices > len(devices):
                raise ValueError(
                    f"stream_mesh: {n_devices} devices requested, only "
                    f"{len(devices)} available")
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), ("stream",))


def make_sharded_step(props: DiPsProperties, h: int, w: int, mesh: Mesh):
    """Build a jitted multi-stream step sharded over ``mesh``.

    The returned function maps
      raw (S, T+B, 3, Hp, Wp) u8, baseline (S, [3,] Hp, Wp), flags (S, B),
      heatmap (S, Hp, Wp), valid (S, B)
    -> (out (S, B, C, Hp, Wp) u8, stats (S, B, NUM_STATS) f32, new baseline,
        new heatmap, global_mean_abs_diff scalar)
    with S sharded over the stream axis; the scalar is a cross-device
    ``psum`` mean.
    """
    raw_mode = props.output in _RAW_MODES
    step = (reference.absdiff_step if raw_mode
            else reference.batch_step).__wrapped__

    def per_shard(raw, baseline, flags, heatmap, valid):
        out, stats, new_b, new_h = jax.vmap(
            lambda r, b, f, hm, v: step(props, h, w, r, b, f, hm, v))(
                raw, baseline, flags, heatmap, valid)
        return out, stats, new_b, new_h, _gmean_impl(stats, valid)

    sharded = jax.shard_map(
        per_shard, mesh=mesh,
        in_specs=(P("stream"), P("stream"), P("stream"), P("stream"),
                  P("stream")),
        out_specs=(P("stream"), P("stream"), P("stream"), P("stream"), P()),
        check_vma=False)
    # baseline/heatmap carries update in place across steps
    return jax.jit(sharded, donate_argnums=(1, 3))


def _gmean_impl(stats, valid):
    """Global mean |diff| over VALID slots only (psum): padding
    replicas and dead streams must not pollute the aggregate."""
    vw = valid.astype(jnp.float32)
    total = jax.lax.psum(jnp.sum(stats[..., 1] * vw), axis_name="stream")
    count = jax.lax.psum(jnp.sum(vw), axis_name="stream")
    return total / jnp.maximum(count, 1.0)


class MultiStreamEngine:
    """Batch runner over S parallel streams with per-stream failure isolation.

    Mirrors ``DiPsEngine`` but the leading axis is streams; feed one frame
    list per stream.  A stream that errors on the host side (short video,
    bad frame) is masked out and reported — it does not abort the batch
    (SURVEY.md §5 'Failure detection': the reference panics instead).
    """

    #: multi-host engines set this: the jitted step contains COLLECTIVES,
    #: so every "nothing to do locally" shortcut (no tails to rebuild, an
    #: all-empty process_batch round) must still enter the step — one
    #: process skipping it while a peer runs it deadlocks the mesh
    _lockstep_collectives = False

    def __init__(self, props: DiPsProperties, height: int, width: int,
                 n_streams: int, batch: int = 8,
                 mesh: Optional[Mesh] = None,
                 packed_wire: bool = False,
                 input_layout: str = "planar",
                 downscale: int = 1):
        self.props = props
        if packed_wire and (props.output != OutputMode.THRESHOLD
                            or props.out_channels == 0):
            raise ValueError("packed_wire requires THRESHOLD output with "
                             "emit_maps=True (there must be masks to pack)")
        self.packed_wire = bool(packed_wire)
        self._raw_mode = props.output in _RAW_MODES
        #: on-device input decimation per stream (mirrors DiPsEngine):
        #: frames arrive at the full input geometry, the pipeline runs at
        #: height/k x width/k (the hwc upload path is implied)
        self.downscale = int(downscale)
        if self.downscale < 1:
            raise ValueError(f"downscale must be >= 1, got {downscale}")
        self.in_height, self.in_width = int(height), int(width)
        if self.downscale > 1:
            k = self.downscale
            if height % k or width % k:
                raise ValueError(
                    f"downscale {k} must divide the input geometry "
                    f"{height}x{width}")
            height, width = height // k, width // k
            if input_layout == "planar":
                input_layout = "hwc"  # decimation runs in the device prep
        self.height, self.width = int(height), int(width)
        self.hp, self.wp = reference.pad_geometry(height, width)
        self.batch = int(batch)
        self.input_layout, self._swap_rb, self._hwc_prep = (
            reference.make_layout_prep(input_layout, self.height,
                                       self.width, self.hp, self.wp,
                                       downscale=self.downscale))
        self.mesh = mesh if mesh is not None else stream_mesh()
        if "rows" in self.mesh.axis_names:
            # composite 2-D (stream x rows) grid: each device owns a
            # horizontal slab of a subset of streams (grid2d.make_grid_step)
            from .grid2d import make_grid_step
            n_shard = self.mesh.shape["stream"]
            self._step = make_grid_step(props, height, width, self.mesh)
        else:
            n_shard = self.mesh.devices.size
            self._step = make_sharded_step(props, height, width, self.mesh)
        if n_streams % n_shard:
            raise ValueError(
                f"n_streams={n_streams} must be a multiple of the stream "
                f"axis size {n_shard}")
        self.n_streams = int(n_streams)
        self._stage_bufs = None        # lazily-built persistent staging
        self._stage_written = set()    # rows holding stale frame bytes
        self.reset()

    # -- device-array hooks ---------------------------------------------------
    # The multi-host subclass (parallel/multihost.py) overrides these three
    # to lift host buffers into GLOBAL jax.Arrays (this process contributes
    # only its addressable shards) and to read back only the local shards.
    # Single-process engines map host<->device 1:1.
    def _zeros(self, shape, dtype):
        """Carried device state, leading axis = streams."""
        return jnp.zeros(shape, dtype)

    def _to_device(self, x):
        """Host->device for step inputs, leading axis = streams."""
        return jnp.asarray(x)

    def _fetch(self, x, n: Optional[int] = None):
        """Device->host; ``n`` optionally slices the second (frame) axis
        before the transfer."""
        return np.asarray(x if n is None else x[:, :n])

    # -- host staging hooks ---------------------------------------------------
    # Host-side staging buffers hold only the streams THIS process feeds:
    # a single-process engine stages all of them; the multi-host subclass
    # stages its local share (a 16-host pod must not zero 16x the memory).
    def _staging(self, hwc: bool):
        """Persistent host staging buffers for :meth:`process_batch`.

        Allocating + page-faulting these fresh per batch is real hot-path
        cost (the planar tail-protocol buffer is S*(T+B)*3*Hp*Wp bytes —
        gigabytes at 1080p): reuse instead.  Safe because process_batch
        blocks on the step's OUTPUTS before returning, so the previous
        step can no longer be reading a (possibly zero-copy-aliased on
        the CPU backend) input when the buffers are refilled; donation
        only ever applies to carried state, never the raw input.  Rows a
        batch does not write are re-zeroed from ``_stage_written`` so the
        staged bytes stay bitwise identical to fresh zeros."""
        if self._stage_bufs is None:
            sh, t, b = self._stage_rows(), self.props.temporal_size, \
                self.batch
            if hwc:
                buf = np.zeros((sh, b, self.in_height, self.in_width, 3),
                               np.uint8)
                tails = np.zeros((sh, t, 3, self.hp, self.wp), np.uint8)
            else:
                buf = np.zeros((sh, t + b, 3, self.hp, self.wp), np.uint8)
                tails = None
            self._stage_bufs = (buf, tails,
                                np.zeros((sh, b), np.bool_),
                                np.zeros((sh, b), np.bool_))
        buf, tails, flags, valid = self._stage_bufs
        flags[:] = False
        valid[:] = False
        return buf, tails, flags, valid

    def _stage_rows(self) -> int:
        """Leading dim of host staging buffers."""
        return self.n_streams

    def _stage_index(self, si: int) -> int:
        """Staging-buffer row for global stream ``si``; -1 = not ours."""
        return si

    def _stage_gather(self, seq) -> np.ndarray:
        """Per-global-stream host values -> staging order."""
        return np.asarray(seq)

    def reset(self) -> None:
        self.frame_cursors = [0] * self.n_streams
        self._tails = [None] * self.n_streams
        if self._raw_mode:
            self._baseline = self._zeros(
                (self.n_streams, 3, self.hp, self.wp), jnp.uint8)
        else:
            self._baseline = self._zeros((self.n_streams, self.hp, self.wp),
                                         jnp.float32)
        self._heatmap = self._zeros((self.n_streams, self.hp, self.wp),
                                    jnp.float32)
        self._snap_pending = [False] * self.n_streams
        self.failed: dict[int, StreamError] = {}

    def snapshot(self, stream: Optional[int] = None) -> None:
        """Force baseline re-capture on the next processed frame — for one
        stream, or all of them (the multi-stream GUI-SnapShot analogue;
        mirrors ``DiPsEngine.snapshot``)."""
        if stream is None:
            self._snap_pending = [True] * self.n_streams
        else:
            self._snap_pending[stream] = True

    @property
    def frame_index(self) -> int:
        """Furthest per-stream cursor (streams advance independently)."""
        return max(self.frame_cursors, default=0)

    # -- per-stream failure recovery (SURVEY.md §5 'Failure detection /
    #    elastic recovery': the reference panics; here a stream can rejoin) --
    def revive(self, stream: int) -> None:
        """Clear a stream's failure and let it continue from its old state
        (cursor, baseline and ring tail are preserved)."""
        self.failed.pop(stream, None)

    def reset_stream(self, stream: int) -> None:
        """Clear a stream's failure AND restart it fresh: cursor back to 0
        (so its next frame re-captures the baseline), ring tail dropped,
        baseline/heatmap rows zeroed.  Sibling streams are untouched."""
        self.failed.pop(stream, None)
        self.frame_cursors[stream] = 0
        self._snap_pending[stream] = False
        self._tails[stream] = None
        self._baseline = self._baseline.at[stream].set(0)
        self._heatmap = self._heatmap.at[stream].set(0)

    def heatmaps(self) -> np.ndarray:
        """(S, H, W) accumulated |diff| heatmaps, cropped (multi-host
        engines return only this process's streams)."""
        return self._fetch(self._heatmap)[:, :self.height, :self.width]

    # -- checkpoint / resume (SURVEY.md §5; mirrors DiPsEngine) -------------
    def state_dict(self) -> dict:
        return {
            "frame_cursors": list(self.frame_cursors),
            "baseline": self._fetch(self._baseline),
            "heatmap": self._fetch(self._heatmap),
            "tails": [np.stack(t) if t is not None else None
                      for t in self._tails],
            "failed": sorted(self.failed),
        }

    def load_state_dict(self, state: dict) -> None:
        bl = np.asarray(state["baseline"])
        expect = ((self.n_streams, 3, self.hp, self.wp) if self._raw_mode
                  else (self.n_streams, self.hp, self.wp))
        if bl.shape != expect:
            raise ValueError(
                f"checkpoint baseline shape {bl.shape} != engine's "
                f"expected {expect}")
        if len(state["frame_cursors"]) != self.n_streams:
            raise ValueError("checkpoint stream count mismatch")
        self.frame_cursors = [int(c) for c in state["frame_cursors"]]
        self._baseline = self._to_device(np.asarray(state["baseline"]))
        self._heatmap = self._to_device(np.asarray(state["heatmap"]))
        self._tails = [list(t) if t is not None else None
                       for t in state["tails"]]
        self.failed = {
            int(si): StreamError(int(si),
                                 RuntimeError("restored from checkpoint"))
            for si in state.get("failed", ())}
        # a snapshot requested before the restore must not fire after it
        # (it would re-capture every baseline and discard the checkpoint's);
        # mirrors the per-stream load_stream_state
        self._snap_pending = [False] * self.n_streams

    # -- per-stream checkpointing (DiPsEngine-compatible format) ------------
    def stream_state_dict(self, stream: int) -> dict:
        """One slot's streaming state, in ``DiPsEngine.state_dict`` form —
        a slot checkpoint restores into a single-stream engine and vice
        versa (the serve daemon uses this to park/restore coalesced
        sessions to disk)."""
        tl = self._tails[stream]
        return {
            "frame_index": self.frame_cursors[stream],
            "baseline": np.asarray(self._baseline[stream]),
            "heatmap": np.asarray(self._heatmap[stream]),
            "tail": np.stack(tl) if tl is not None else None,
        }

    def load_stream_state(self, stream: int, state: dict) -> None:
        """Restore ONE slot from a ``DiPsEngine``-format state dict; sibling
        slots keep their live state."""
        bl = np.asarray(state["baseline"])
        expect = ((3, self.hp, self.wp) if self._raw_mode
                  else (self.hp, self.wp))
        if bl.shape != expect:
            raise ValueError(
                f"checkpoint baseline shape {bl.shape} != engine's "
                f"expected per-stream {expect}")
        t = self.props.temporal_size
        tail = state.get("tail")
        if tail is not None:
            tl = [np.asarray(f) for f in tail][-t:]
            if len(tl) < t:  # short tail: replicate the oldest (seeding rule)
                tl = [tl[0]] * (t - len(tl)) + tl
            if tl[0].shape != (3, self.hp, self.wp):
                raise ValueError(
                    f"checkpoint tail frame shape {tl[0].shape} != "
                    f"{(3, self.hp, self.wp)}")
            self._tails[stream] = tl
        else:
            self._tails[stream] = None
        self.failed.pop(stream, None)
        self._snap_pending[stream] = False
        self.frame_cursors[stream] = int(state["frame_index"])
        self._baseline = self._baseline.at[stream].set(jnp.asarray(bl))
        hm = state.get("heatmap")
        if hm is not None:
            self._heatmap = self._heatmap.at[stream].set(jnp.asarray(hm))

    def save_stream(self, stream: int, path: str) -> None:
        """Checkpoint one slot to disk — byte-compatible with
        ``DiPsEngine.save`` (same npz keys), so sessions migrate between a
        dedicated server and a coalesced slot."""
        s = self.stream_state_dict(stream)
        np.savez_compressed(
            path, frame_index=s["frame_index"], baseline=s["baseline"],
            heatmap=s["heatmap"],
            tail=s["tail"] if s["tail"] is not None
            else np.zeros((0,), np.uint8),
            geometry=np.asarray([self.height, self.width], np.int64))

    def load_stream(self, stream: int, path: str) -> None:
        z = np.load(path)
        if "geometry" in z.files:
            gh, gw = (int(v) for v in z["geometry"])
            if (gh, gw) != (self.height, self.width):
                raise ValueError(
                    f"checkpoint geometry {gh}x{gw} != engine "
                    f"{self.height}x{self.width}")
        tail = z["tail"]
        self.load_stream_state(stream, {
            "frame_index": int(z["frame_index"]),
            "baseline": z["baseline"],
            "heatmap": z["heatmap"],
            "tail": tail if tail.size else None,
        })

    def save(self, path: str) -> None:
        s = self.state_dict()
        t = self.props.temporal_size
        tails = np.stack([
            tl if tl is not None else np.zeros((t, 3, self.hp, self.wp),
                                               np.uint8)
            for tl in s["tails"]])
        has_tail = np.asarray([tl is not None for tl in s["tails"]])
        np.savez_compressed(
            path, frame_cursors=np.asarray(s["frame_cursors"]),
            baseline=s["baseline"], heatmap=s["heatmap"], tails=tails,
            has_tail=has_tail, failed=np.asarray(s["failed"], np.int64))

    def load(self, path: str) -> None:
        z = np.load(path)
        self.load_state_dict({
            "frame_cursors": z["frame_cursors"].tolist(),
            "baseline": z["baseline"],
            "heatmap": z["heatmap"],
            "tails": [z["tails"][i] if z["has_tail"][i] else None
                      for i in range(z["tails"].shape[0])],
            "failed": z["failed"].tolist(),
        })

    def _planarize(self, frame: np.ndarray) -> np.ndarray:
        if frame.shape[:2] != (self.height, self.width):
            raise ValueError(
                f"frame shape {frame.shape} != "
                f"{(self.height, self.width, 3)}")
        # single-pass native layout transform (numpy fallback inside)
        from .. import native
        return native.planarize(frame, self.hp, self.wp)

    def process_batch(self, frames_per_stream: Sequence[Sequence[np.ndarray]]
                      ) -> Tuple[np.ndarray, np.ndarray, float]:
        """Process up to ``batch`` frames for each of the S streams.

        All live streams must supply the same number of frames n (dead or
        exhausted streams pass an empty list and are replayed with zeros).
        Returns (out (S, n, H, W, C), stats (S, n, NUM_STATS), global mean);
        multi-host engines return only this process's S_local streams.
        """
        s = self.n_streams
        if len(frames_per_stream) != s:
            raise ValueError(f"expected {s} streams")
        n = max((len(f) for f in frames_per_stream), default=0)
        if n == 0 and not self._lockstep_collectives:
            # multi-host engines run an all-invalid step instead: a host
            # whose cameras all stalled this round must still enter the
            # collective or its peers deadlock in the psum
            return (np.zeros((self._stage_rows(), 0, self.height,
                              self.width, self.props.out_channels),
                             np.uint8),
                    np.zeros((self._stage_rows(), 0, NUM_STATS),
                             np.float32), 0.0)
        if n > self.batch:
            raise ValueError(f"{n} frames > batch {self.batch}")
        t, b = self.props.temporal_size, self.batch
        hwc = self.input_layout == "hwc"

        # hwc: raw HWC frames; transpose+pad runs on device (one XLA op).
        # Only the checkpoint tails pay a host planarize (<= t/stream).
        buf, tails_prev, flags, valid = self._staging(hwc)
        written = set()
        for si, frames in enumerate(frames_per_stream):
            row = self._stage_index(si)
            if row < 0 or si in self.failed:
                continue  # remote or dead stream: nothing to stage
            try:
                if hwc:
                    from .. import native
                    if self.downscale > 1:
                        # checkpoint tails at the analysis geometry (the
                        # bit-identical host twin of the device pool)
                        pl = lambda f: native.planarize(
                            reference.pool_frame_host(f, self.downscale),
                            self.hp, self.wp, swap_rb=self._swap_rb)
                    else:
                        pl = lambda f: native.planarize(
                            f, self.hp, self.wp, swap_rb=self._swap_rb)
                    for f in frames:
                        if f.shape != (self.in_height, self.in_width, 3):
                            raise ValueError(
                                f"frame shape {f.shape} != "
                                f"{(self.in_height, self.in_width, 3)}")
                    # planar tail bookkeeping only (checkpoint format,
                    # always RGB planes)
                    planar = [pl(f) for f in frames[-t:]]
                    if frames and len(frames) > t:
                        first_pl = pl(frames[0])
                    elif planar:
                        first_pl = planar[0]
                else:
                    planar = [self._planarize(f) for f in frames]
                    first_pl = planar[0] if planar else None
            except Exception as e:  # bad frame: isolate the stream
                self.failed[si] = StreamError(si, e)
                continue
            n_si = len(frames)
            if n_si:
                if self._tails[si] is None:
                    self._tails[si] = [first_pl] * t
                tp = np.stack(self._tails[si])
                if hwc:
                    tails_prev[row] = tp
                else:
                    buf[row, :t] = tp
                for i in range(b):
                    if hwc:
                        buf[row, i] = frames[min(i, n_si - 1)]
                    else:
                        buf[row, t + i] = planar[min(i, n_si - 1)]
                valid[row, :n_si] = True
                # markers fire on each stream's OWN cursor, so staggered
                # starts and stalled streams stay correct
                cursor = self.frame_cursors[si]
                for i in range(n_si):
                    flags[row, i] = (cursor + i == 0 or
                                     (cursor + i) in
                                     self.props.refresh_markers)
                if self._snap_pending[si]:
                    flags[row, 0] = True
                    self._snap_pending[si] = False
                self._tails[si] = (self._tails[si] + planar)[-t:]
                self.frame_cursors[si] = cursor + n_si
                written.add(row)

        # persistent buffers: rows staged on a PREVIOUS batch but not this
        # one (stream died / went empty) would otherwise leak stale frames
        # into the step — re-zero them so the staged bytes are bitwise
        # identical to freshly-zeroed buffers
        for row in self._stage_written - written:
            buf[row] = 0
            if tails_prev is not None:
                tails_prev[row] = 0
        self._stage_written = written

        if hwc:
            # tail protocol: prepend the planar tails on device
            raw_dev = jnp.concatenate(
                [self._to_device(tails_prev),
                 self._hwc_prep(self._to_device(buf))], axis=1)
        else:
            raw_dev = self._to_device(buf)
        out, stats, self._baseline, self._heatmap, gmean = self._step(
            raw_dev, self._baseline, self._to_device(flags),
            self._heatmap, self._to_device(valid))

        if self.packed_wire:
            # bit-pack masks on device before the download (ops/wire.py:
            # 8 rows -> one byte-plane row), unpack + crop on the host
            from ..ops import wire
            packed = np.asarray(wire.pack_mask(out[:, :n]))
            out = wire.unpack_mask(packed)[
                :, :, :, :self.height, :self.width]
        elif out.shape[2] == 0:
            # STATS_ONLY: no map bytes on device; only stats/heatmap travel
            out = np.empty((out.shape[0], n, 0, self.height, self.width),
                           np.uint8)
        else:
            out = self._fetch(out, n)[:, :, :, :self.height, :self.width]
        out = np.moveaxis(out, 2, -1)
        return out, self._fetch(stats, n), float(gmean)
