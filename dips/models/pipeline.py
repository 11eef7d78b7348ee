"""DiPsEngine — the flagship streaming pipeline model.

Replaces the reference's three per-frame engines (``ComputeState``
dips/src/gpu/mod.rs:39-398, ``DiPsCompute`` dips_alt/src/dips_compute/
mod.rs:243-647, and the dips_opencv clone) with one batched, stateful JAX
engine.  Differences that matter on the device:

* **Batched dispatch, no per-frame sync.**  The reference uploads, dispatches
  and synchronously reads back every frame (dips/src/gpu/mod.rs:346-391).
  The engine dispatches B frames per device step and only materialises
  results when the caller consumes them — JAX's async dispatch overlaps host
  decode with device compute.
* **One step, one protocol.**  Every batch runs the jitted XLA step in
  ``ops/reference.py``: the host keeps the last T raw frames and prepends
  them to each batch, so every step is a pure function of its inputs plus
  the donated baseline/heatmap carry.  Checkpoints store that raw tail.
* **Geometry bucketing.**  Frames are padded once on the host
  (``reference.pad_geometry``); a validity mask keeps padding out of
  outputs and statistics (the reference's analogue is 256-byte row
  padding, dips/src/gpu/mod.rs:33-37).
"""

from __future__ import annotations

import collections
from typing import Deque, List, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..properties import DiPsProperties, OutputMode
from ..ops import reference
from ..ops.oracle import NUM_STATS
from ..ops.reference import pad_geometry
from .. import native


_RAW_MODES = (OutputMode.ABSDIFF, OutputMode.THRESHOLD,
              OutputMode.STATS_ONLY)


class DiPsEngine:
    """Stateful streaming engine: feed uint8 RGB frames, get diff maps + stats.

    Args:
      props: pipeline configuration (static; changing it means a new engine,
        mirroring the reference's pipeline-rebuild-on-change semantics,
        dips_alt/src/lib.rs:267-293).
      height, width: true INPUT frame geometry.  With ``downscale = k > 1``
        the engine decimates on device (k x k box mean inside the layout
        prep) and the analysis geometry — maps, stats, heatmap, roi,
        checkpoints — becomes ``height/k x width/k`` (``.height``/
        ``.width``; the input dims stay on ``.in_height``/``.in_width``).
        The hwc upload path is implied (planar auto-promotes).
      batch: frames per device dispatch (B).
      device: optional jax.Device to place state on.
      packed_wire: THRESHOLD mode only — bit-pack the binary masks on the
        device before the D2H copy (8x less transfer; see ops/wire.py) and
        unpack on the host, so the public output is unchanged.
      input_layout: "planar" (default) — the host planarizes each frame to
        padded (3, Hp, Wp) before upload (the SSSE3 native path); or
        "hwc" — raw (H, W, 3) RGB frames are uploaded as-is and the
        transpose+pad runs ON DEVICE (one XLA op before the fused kernel).
        "hwc" moves the per-frame host layout pass onto the device,
        which pays wherever host decode is the wall.  "hwc_bgr"
        additionally folds cv2's BGR->RGB swap into the device transform
        (free), so the decode path does NO per-frame host work beyond a
        memcpy.  Checkpoints remain
        RGB-planar (only the T tail frames are planarized on the host,
        once per batch).
    """

    def __init__(self, props: DiPsProperties, height: int, width: int,
                 batch: int = 8,
                 device: Optional[jax.Device] = None,
                 packed_wire: bool = False,
                 input_layout: str = "planar",
                 downscale: int = 1):
        if height <= 0 or width <= 0:
            raise ValueError(f"bad geometry {height}x{width}")
        if batch < 1:
            raise ValueError("batch must be >= 1")
        self.props = props
        #: on-device input decimation (``downscale = k > 1``): frames
        #: arrive at the FULL ``height x width`` but the whole pipeline —
        #: maps, statistics, heatmap, roi, checkpoints — runs at the
        #: decimated ``height/k x width/k`` analysis geometry (a 4K feed
        #: at 1080p cost).  The k x k box mean runs inside the device
        #: layout prep (ops/reference.make_layout_prep), so the hwc
        #: upload path is implied; ``in_height``/``in_width`` keep the
        #: full input dims, ``height``/``width`` become the analysis dims.
        self.downscale = int(downscale)
        if self.downscale < 1:
            raise ValueError(f"downscale must be >= 1, got {downscale}")
        self.in_height, self.in_width = int(height), int(width)
        if self.downscale > 1:
            k = self.downscale
            if height % k or width % k:
                raise ValueError(
                    f"downscale {k} must divide the input geometry "
                    f"{height}x{width} (crop the stream or pick a "
                    f"divisor)")
            height, width = height // k, width // k
            if input_layout == "planar":
                input_layout = "hwc"  # decimation runs in the device prep
        self.height, self.width = int(height), int(width)
        # an out-of-bounds analysis region must fail HERE with the real
        # geometry in hand, not as a trace error mid-stream
        props.roi_bounds(self.height, self.width)
        self.hp, self.wp = pad_geometry(self.height, self.width)
        self.batch = int(batch)
        self.device = device
        self._raw_mode = props.output in _RAW_MODES
        self._step = (reference.absdiff_step if self._raw_mode
                      else reference.batch_step)
        if packed_wire and (props.output != OutputMode.THRESHOLD
                            or props.out_channels == 0):
            raise ValueError("packed_wire requires THRESHOLD output with "
                             "emit_maps=True (there must be masks to pack)")
        self.packed_wire = bool(packed_wire)
        #: "hwc_bgr" accepts frames in cv2's native BGR order and folds the
        #: channel swap into the device transpose (free) — the decode path
        #: then does NO per-frame host work beyond a memcpy
        self.input_layout, self._swap_rb, self._hwc_prep = (
            reference.make_layout_prep(input_layout, self.height,
                                       self.width, self.hp, self.wp,
                                       downscale=self.downscale))
        #: optional StageTimers: when set, dispatch/collect split their
        #: time into h2d (host->device upload), dispatch (async kernel
        #: launch) and d2h (device sync + download + interleave) stages.
        self.timers = None
        self.reset()

    # -- state ------------------------------------------------------------
    @property
    def analysis_pixels(self) -> int:
        """Pixels the per-frame statistics reduce over: the roi area when
        ``props.roi`` is set, else the whole frame — the right ``pixels``
        for a ``changed_frac`` MotionDetector on this engine."""
        return self.props.analysis_pixels(self.height, self.width)

    @property
    def tail_rows(self) -> int:
        """Leading tail rows in a :meth:`new_batch_buffer` buffer (0 in
        hwc mode — new frames go at ``buf[tail_rows + i]``)."""
        if getattr(self, "input_layout", "planar") == "hwc":
            return 0
        return self.props.temporal_size

    def reset(self) -> None:
        """Clear all streaming state (frame cursor, ring tail, baseline)."""
        t = self.props.temporal_size
        self.frame_index = 0
        self._tail: Deque[np.ndarray] = collections.deque(maxlen=t)
        if self._raw_mode:
            self._baseline = jnp.zeros((3, self.hp, self.wp), jnp.uint8)
        else:
            self._baseline = jnp.zeros((self.hp, self.wp), jnp.float32)
        self._heatmap = jnp.zeros((self.hp, self.wp), jnp.float32)
        if self.device is not None:
            self._baseline = jax.device_put(self._baseline, self.device)
            self._heatmap = jax.device_put(self._heatmap, self.device)

    # -- helpers ------------------------------------------------------------
    def _planarize(self, frame: np.ndarray) -> np.ndarray:
        """(H, W, 3) uint8 -> padded planar (3, Hp, Wp) uint8 (single native
        pass when libframepump is available)."""
        if frame.shape != (self.height, self.width, 3):
            raise ValueError(
                f"frame shape {frame.shape} != {(self.height, self.width, 3)}")
        return native.planarize(frame, self.hp, self.wp)

    def _is_capture(self, idx: int) -> bool:
        return idx == 0 or idx in self.props.refresh_markers

    def snapshot(self) -> None:
        """Force a baseline re-capture on the next frame (the GUI SnapShot
        button, ref dips_alt/src/lib.rs:296-298)."""
        self._force_snapshot = True

    _force_snapshot = False

    # -- core ---------------------------------------------------------------
    def process_batch(self, frames: Sequence[np.ndarray],
                      packed: bool = False
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Process up to ``batch`` frames.

        Args: frames: list of uint8 (H, W, 3) RGB frames.
          packed: return device-packed padded masks (see :meth:`collect`).
        Returns: (outputs uint8 (n, H, W, C), stats f32 (n, NUM_STATS)).
        """
        if self.input_layout == "hwc":
            n = len(frames)
            if n == 0:
                return (np.zeros((0, self.height, self.width,
                                  self.props.out_channels), np.uint8),
                        np.zeros((0, NUM_STATS), np.float32))
            if n > self.batch:
                raise ValueError(f"got {n} frames > batch {self.batch}")
            buf = self.new_batch_buffer()
            for i, f in enumerate(frames):
                if f.shape != (self.in_height, self.in_width, 3):
                    raise ValueError(
                        f"frame shape {f.shape} != "
                        f"{(self.in_height, self.in_width, 3)}")
                buf[i] = f
            return self.process_buffer(buf, n, packed=packed)
        return self.process_planar([self._planarize(f) for f in frames],
                                   packed=packed)

    def new_batch_buffer(self) -> np.ndarray:
        """Allocate the engine's batch buffer: planar layout —
        (tail_rows+B, 3, Hp, Wp) uint8, fill rows
        [tail_rows : tail_rows+n] with planarized frames (e.g. pop the
        decode ring straight into ``buf[engine.tail_rows + i]``), the
        zero-extra-copy streaming path (tail_rows is T); hwc layout —
        (B, H, W, 3) uint8, fill rows [0:n] with raw RGB frames (the
        device does the rest)."""
        if self.input_layout == "hwc":
            return np.empty((self.batch, self.in_height, self.in_width, 3),
                            np.uint8)
        return np.empty((self.tail_rows + self.batch, 3, self.hp, self.wp),
                        np.uint8)

    def process_buffer(self, buf: np.ndarray, n: int, packed: bool = False
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Process ``n`` frames already written at
        ``buf[tail_rows:tail_rows+n]`` (padded planar layout); the engine
        fills the tail rows and padding."""
        return self.collect(self.dispatch_async(buf, n), packed=packed)

    def process_planar(self, planar: Sequence[np.ndarray],
                       packed: bool = False
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Process frames already in padded planar (3, Hp, Wp) uint8
        layout."""
        if self.input_layout == "hwc":
            raise ValueError(
                "process_planar on an input_layout='hwc' engine: feed raw "
                "(H, W, 3) frames via process_batch/process_buffer instead")
        n = len(planar)
        if n == 0:
            return (np.zeros((0, self.height, self.width,
                              self.props.out_channels), np.uint8),
                    np.zeros((0, NUM_STATS), np.float32))
        if n > self.batch:
            raise ValueError(f"got {n} frames > batch {self.batch}")
        buf = self.new_batch_buffer()
        tr = self.tail_rows
        for i in range(n):
            buf[tr + i] = planar[i]
        return self.process_buffer(buf, n, packed=packed)

    def _stage(self, name):
        import contextlib
        return (self.timers.stage(name) if self.timers
                else contextlib.nullcontext())

    def dispatch_async(self, buf: np.ndarray, n: int):
        """Launch the device step WITHOUT waiting for results: returns an
        opaque handle for :meth:`collect`.  JAX dispatch is asynchronous,
        so a caller can keep one batch in flight while converting the
        previous one — host<->device transfer overlaps device compute (the
        double-buffering the reference's per-frame blocking readback never
        had).  Engine state (tail/cursor/baseline futures) advances at
        dispatch time, so calls must stay ordered."""
        t = self.props.temporal_size
        b = self.batch
        tr = self.tail_rows
        if n < 1 or n > b:
            raise ValueError(f"n={n} outside 1..{b}")
        hwc = self.input_layout == "hwc"
        if hwc:
            # raw (B, H, W, 3) buffer; transpose+pad (and any BGR swap)
            # runs on device.  The checkpoint tail stays RGB-planar
            # (portable): only the last min(t, n) frames pay a host
            # planarize.
            if self.downscale > 1:
                # checkpoint tails live at the analysis geometry: decimate
                # on the host (bit-identical twin of the device pool)
                # before planarizing — <= T frames per batch pay this
                pl = lambda f: native.planarize(
                    reference.pool_frame_host(f, self.downscale),
                    self.hp, self.wp, swap_rb=self._swap_rb)
            else:
                pl = lambda f: native.planarize(f, self.hp, self.wp,
                                                swap_rb=self._swap_rb)
            for i in range(n, b):
                buf[i] = buf[n - 1]  # replicate last for padding
            if not self._tail:  # first batch: prefill ring with frame 0
                self._tail.extend([pl(buf[0])] * t)
            tail_prev = np.stack(list(self._tail))
            self._tail.extend(pl(buf[i]) for i in range(max(0, n - t), n))
        else:
            if not self._tail:  # first batch: prefill ring with frame 0
                self._tail.extend([buf[tr].copy()] * t)
            buf[:t] = np.stack(list(self._tail))
            for i in range(n, b):
                buf[tr + i] = buf[tr + n - 1]  # replicate last for padding
            self._tail.extend(buf[tr + max(0, n - t):tr + n].copy())

        flags = np.zeros((b,), np.bool_)
        valid = np.zeros((b,), np.bool_)
        valid[:n] = True
        for i in range(n):
            flags[i] = self._is_capture(self.frame_index + i)
        if self._force_snapshot:
            flags[0] = True
            self._force_snapshot = False

        with self._stage("h2d"):
            raw_dev = jnp.asarray(buf)
        with self._stage("dispatch"):
            if hwc:
                # tail protocol: prepend the T planar tail frames on device
                raw_dev = jnp.concatenate(
                    [jnp.asarray(tail_prev), self._hwc_prep(raw_dev)], axis=0)
            out, stats, self._baseline, self._heatmap = self._step(
                self.props, self.height, self.width,
                raw_dev, self._baseline, jnp.asarray(flags),
                self._heatmap, jnp.asarray(valid))
            if self.packed_wire:
                from ..ops import wire
                out = wire.pack_mask(out)
        self.frame_index += n
        return out, stats, n

    def collect(self, handle, packed: bool = False
                ) -> Tuple[np.ndarray, np.ndarray]:
        """Materialise a :meth:`dispatch_async` handle on the host.

        ``packed=True`` (packed_wire engines only) skips the host unpack
        and returns the device-packed padded masks (n, 1, Hp//8, Wp)
        verbatim — for consumers that forward the packed bytes (the serve
        daemon's packed transport) without a pointless unpack/repack."""
        out, stats, n = handle
        if packed and not self.packed_wire:
            raise ValueError("packed collect requires packed_wire=True")
        with self._stage("d2h"):
            if out.shape[1] == 0:
                # STATS_ONLY: no map bytes exist on device; only the stats
                # travel
                out_np = np.empty((n, self.height, self.width, 0), np.uint8)
                return out_np, np.asarray(stats[:n])
            out_np = np.asarray(out[:n])
            if packed:
                return out_np, np.asarray(stats[:n])
            if self.packed_wire:
                from ..ops import wire
                out_np = wire.unpack_mask(out_np)
            if self.props.out_channels == 3:
                hwc = np.empty((n, self.height, self.width, 3), np.uint8)
                for i in range(n):
                    native.interleave(out_np[i], self.height, self.width,
                                      out=hwc[i])
                out_np = hwc
            else:
                out_np = np.moveaxis(
                    out_np[:, :, :self.height, :self.width], 1, -1)
            stats_np = np.asarray(stats[:n])
        return out_np, stats_np


    def process_frames(self, frames: Sequence[np.ndarray],
                       packed: bool = False
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Process an arbitrary number of frames, batching internally."""
        if not frames:
            return (np.zeros((0, self.height, self.width,
                              self.props.out_channels), np.uint8),
                    np.zeros((0, NUM_STATS), np.float32))
        outs: List[np.ndarray] = []
        stats: List[np.ndarray] = []
        for i in range(0, len(frames), self.batch):
            o, s = self.process_batch(frames[i:i + self.batch],
                                      packed=packed)
            outs.append(o)
            stats.append(s)
        return np.concatenate(outs), np.concatenate(stats)

    # -- checkpoint / resume (SURVEY.md §5) ----------------------------------
    def state_dict(self) -> dict:
        """Serializable streaming state: baseline + ring tail + cursor.

        The reference's only persistent state is exactly this trio
        (SURVEY.md §5 'Checkpoint / resume'); saving it lets a long streaming
        job resume mid-video.
        """
        return {
            "frame_index": self.frame_index,
            "baseline": np.asarray(self._baseline),
            "tail": np.stack(list(self._tail)) if self._tail else None,
            "heatmap": np.asarray(self._heatmap),
        }

    def load_state_dict(self, state: dict) -> None:
        bl = np.asarray(state["baseline"])
        expect = ((3, self.hp, self.wp) if self._raw_mode
                  else (self.hp, self.wp))
        if bl.shape != expect:
            raise ValueError(
                f"checkpoint baseline shape {bl.shape} != engine's expected "
                f"{expect} (raw and median modes have different baseline "
                f"representations)")
        self.frame_index = int(state["frame_index"])
        self._baseline = jnp.asarray(state["baseline"])
        self._tail.clear()
        if state["tail"] is not None:
            # same seeding rule as MultiStreamEngine.load_stream_state: a
            # short tail (saved before T frames were seen) replicates its
            # oldest frame up to T — the running tail is always exactly T
            # deep, and the next dispatch stacks it as (T, ...)
            t = self.props.temporal_size
            tl = [np.asarray(f) for f in state["tail"]][-t:]
            if tl and tl[0].shape != (3, self.hp, self.wp):
                raise ValueError(
                    f"checkpoint tail frame shape {tl[0].shape} != "
                    f"{(3, self.hp, self.wp)}")
            if tl and len(tl) < t:
                tl = [tl[0]] * (t - len(tl)) + tl
            self._tail.extend(tl)
        if "heatmap" in state and state["heatmap"] is not None:
            self._heatmap = jnp.asarray(state["heatmap"])
        # a snapshot requested before the restore must not fire after it
        # (it would re-capture the baseline and discard the checkpoint's);
        # mirrors MultiStreamEngine.load_state_dict
        self._force_snapshot = False

    def heatmap(self) -> np.ndarray:
        """Accumulated per-pixel sum of |diff| so far, cropped to true
        geometry (the intensity-change heatmap)."""
        return np.asarray(self._heatmap)[:self.height, :self.width]

    def save(self, path: str) -> None:
        """Persist streaming state so a long job can resume after a crash
        or preemption (SURVEY.md §5 'Checkpoint / resume')."""
        state = self.state_dict()
        np.savez_compressed(
            path, frame_index=state["frame_index"],
            baseline=state["baseline"], heatmap=state["heatmap"],
            tail=state["tail"] if state["tail"] is not None
            else np.zeros((0,), np.uint8),
            # true geometry (padded arrays alone are ambiguous): lets a
            # geometry-flexible consumer size an engine from the file
            geometry=np.asarray([self.height, self.width], np.int64))

    def load(self, path: str) -> None:
        z = np.load(path)
        if "geometry" in z.files:  # absent in pre-geometry checkpoints
            gh, gw = (int(v) for v in z["geometry"])
            if (gh, gw) != (self.height, self.width):
                raise ValueError(
                    f"checkpoint geometry {gh}x{gw} != engine "
                    f"{self.height}x{self.width}")
        tail = z["tail"]
        self.load_state_dict({
            "frame_index": int(z["frame_index"]),
            "baseline": z["baseline"],
            "heatmap": z["heatmap"],
            "tail": tail if tail.size else None,
        })
