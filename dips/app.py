"""Application API: the reference's L4 entry functions, rebuilt.

Maps one-to-one onto the reference surface (SURVEY.md §1 L4):

* ``DiPsJob``           <- ``DiPsProperties`` builder incl. paths + callback
                            (dips/src/lib.rs:63-170)
* ``perform_dips``      <- dips/src/lib.rs:252-257
* ``run_dips_on_file``  <- dips_alt/src/lib.rs:554-690
* ``custom_dips_on_files`` <- dips_alt/src/lib.rs:693-900 (raw .dat batch)
* ``extract_thumbnail`` <- dips/src/lib.rs:263-266 (re-exported from io)

The streaming loop runs host decode on a worker thread feeding a bounded
queue (the analogue of GStreamer's streaming thread + appsink callback,
dips/src/frame_extractor.rs:206-276) so decode overlaps device compute
instead of the reference's fully serialized decode->upload->dispatch->
blocking-readback per frame.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .errors import DecodeError, FrameCallbackError, OutputPathError, VideoPathError
from .models import DiPsEngine
from .ops.oracle import NUM_STATS
from .properties import DiPsProperties, Encoding
from .io.video import VideoReader, VideoWriter
from . import native
from .io.thumbnail import extract_thumbnail  # noqa: F401  (re-export, L4 parity)
from .io.datfiles import read_dat_dir
from .utils.profiling import StageTimers

log = logging.getLogger("dips")

#: Observation hook called once per processed frame with
#: (frame_index, input_rgb, output_map, stats_row).  The reference's
#: callback (fn(u32,u32,&[u8],&mut ComputeState) -> Vec<u8>,
#: dips/src/lib.rs:23) *computes* the frame; here compute is batched on
#: device, so the hook observes/overrides the already-computed map: return
#: None to keep it, or a replacement uint8 array to override.
FrameCallback = Callable[[int, np.ndarray, np.ndarray, np.ndarray],
                         Optional[np.ndarray]]


@dataclasses.dataclass
class DiPsJob:
    """Builder-style job config: pipeline properties + endpoints.

    Field parity with the reference builder (video_path, frame_callback,
    output_path, colorize, spatial window, sensitivity, filter, chroma —
    dips/src/lib.rs:75-169) with the pipeline knobs living in ``properties``.
    """

    properties: DiPsProperties = dataclasses.field(
        default_factory=DiPsProperties)
    video_path: Optional[str] = None
    output_path: Optional[str] = None
    encoding: Encoding = Encoding.MJPG
    frame_callback: Optional[FrameCallback] = None
    batch: int = 8
    #: media backend for decode/encode: "opencv", "gstreamer" or "auto"
    #: (the reference's primary ingest is GStreamer, frame_extractor.rs:38).
    video_backend: str = "auto"
    queue_depth: int = 4  # decode-ahead batches
    #: parallel decode workers (contiguous chunks, order-preserving chain).
    #: Decode is the e2e wall on most hosts — the device outruns one
    #: decoder.  Requires a seekable container with a reliable frame count
    #: (AVI/MJPG).
    decode_workers: int = 1
    #: collect per-stage timings (SURVEY.md §5 tracing; see utils.profiling);
    #: populated on the job as ``job.timers`` after a run.
    profile: bool = False
    timers: Optional["StageTimers"] = None
    #: FFT low-pass post-analysis of the diff maps before they are yielded
    #: (BASELINE configs[4]; ops/analysis.fft_denoise radius).
    denoise_radius: Optional[int] = None
    #: VFR-safe egress: dup/drop frames onto the CFR writer schedule so a
    #: variable-frame-rate input does not retime (GStreamer egress instead
    #: carries the PTS through directly, like the reference's appsrc path,
    #: frame_extractor.rs:242-262).  Populated per-run: ``job.frame_pts``.
    retime_vfr: bool = False
    frame_pts: Optional[list] = None
    #: run artifact: (height, width) of the processed video, populated by
    #: ``perform_dips`` (resolution-dependent post-analysis — e.g. the
    #: ``changed_frac`` event metric — needs the pixel count)
    frame_geometry: Optional[tuple] = None
    #: run artifact: the engine that processed the stream (its heatmap /
    #: checkpoint state outlive the run; ``--heatmap-png`` reads it)
    engine: Optional[object] = None
    #: event-triggered recording (io/eventrecorder.py): dict with ``dir``
    #: (segment output directory) and optional ``pre_roll`` / ``post_roll``
    #: frame counts and ``detector`` (MotionDetector kwargs) — the run
    #: additionally writes one clip per motion burst, pre/post-roll
    #: included, instead of relying on the continuous output alone
    record_events: Optional[dict] = None
    #: run artifact: the recorded segments (span, frames, events, path)
    event_segments: Optional[list] = None
    #: adaptive baseline refresh (ops/refresh.BaselineRefreshPolicy
    #: kwargs): automates the reference's SnapShot button — when the scene
    #: changes wholesale (lighting flip, camera bump, scene cut) the
    #: policy re-pins the baseline so OVERALL mode recovers instead of
    #: diffing hot forever.  Keys: ``threshold`` (changed fraction,
    #: default 0.6), ``persist`` (consecutive frames, default 3),
    #: ``cooldown`` (default persist + 2*batch — must cover the snapshot
    #: latency), ``metric``.  OVERALL method only.
    auto_refresh: Optional[dict] = None
    #: run artifact: frame indices where the auto-refresh policy fired
    baseline_refreshes: Optional[list] = None
    #: batches kept in flight on the device (2 = dispatch batch k+1 while
    #: batch k downloads, so the upload and download overlap).  Default 1
    #: until a measurement on the card decides it.
    pipeline_depth: int = 1
    #: THRESHOLD only: bit-pack masks on the device before the D2H copy
    #: (8x less device->host transfer; ops/wire.py).  Output is unchanged.
    packed_wire: bool = False
    #: "planar" (default): decode workers planarize each frame on the host
    #: (fused native pass) before upload.  "hwc": workers stage the RAW
    #: decoded bytes and the transpose/pad/channel-swap runs ON DEVICE —
    #: the host's per-frame work drops to a memcpy.  The right trade when
    #: decode is the wall and the device has headroom.
    input_layout: str = "planar"
    #: yield the decoded RGB input frame from :func:`stream_dips` (the
    #: second tuple element).  Rebuilding HWC from the planar batch costs a
    #: full host pass per frame (~7 ms at 1080p), so it is skipped — the
    #: element is None — unless requested.  None = auto: on exactly when
    #: ``frame_callback`` is set (the callback receives the input frame).
    yield_inputs: Optional[bool] = None
    #: abort when the decoder delivers nothing for this long (seconds).
    #: None = wait forever — the right setting for sparse/bursty live
    #: sources (motion-triggered rtsp:// cameras) where silence is normal.
    decode_stall_s: Optional[float] = 30.0
    #: on-device input decimation: analyze (and emit) at 1/k scale — the
    #: k x k box mean runs inside the device layout prep, so a 4K feed
    #: costs ~1080p device work and the host never resizes.  Output maps,
    #: statistics, events and the written video are at the decimated
    #: geometry; k must divide the input dimensions.
    downscale: int = 1
    #: a pre-opened reader to use instead of opening ``video_path``
    #: (stream_dips takes ownership and closes it).  Lets callers probe
    #: fps/geometry without a second connect — network sources (rtsp/srt)
    #: may reject or stall overlapping sessions.
    reader: Optional[object] = None

    # builder parity ------------------------------------------------------
    def with_video_path(self, p: str) -> "DiPsJob":
        return dataclasses.replace(self, video_path=p)

    def with_output_path(self, p: str) -> "DiPsJob":
        return dataclasses.replace(self, output_path=p)

    def with_encoding(self, e: Encoding | str) -> "DiPsJob":
        e = Encoding[e.upper()] if isinstance(e, str) else e
        return dataclasses.replace(self, encoding=e)

    def with_frame_callback(self, cb: FrameCallback) -> "DiPsJob":
        return dataclasses.replace(self, frame_callback=cb)

    def with_properties(self, props: DiPsProperties) -> "DiPsJob":
        return dataclasses.replace(self, properties=props)

    def with_video_backend(self, b: str) -> "DiPsJob":
        return dataclasses.replace(self, video_backend=b)


def _decode_worker(reader: VideoReader, hp: int, wp: int,
                   ring: "native.FrameRing", stop: threading.Event,
                   errbox: list, pts_q, timers: Optional[StageTimers] = None,
                   stage: str = "decode", limit: Optional[int] = None,
                   own_reader: bool = False, raw_hwc: bool = False) -> None:
    """Decode thread: fused BGR->planar conversion (native, single pass)
    staged into the bounded frame ring — the rebuild's analogue of the
    GStreamer streaming thread feeding appsink.  Per-frame PTS travel in a
    side deque (appended before the push so the consumer never sees a frame
    without its timestamp).  ``limit`` bounds the frames decoded (chunked
    parallel decode); ``stage`` names this worker's timer."""
    # Readers that decode natively to RGB (GStreamer) skip the BGR round
    # trip: planarize without the swap instead of reversing + re-reversing.
    rgb_native = getattr(reader, "native_rgb", False)
    it = (reader.iter_rgb_timed() if rgb_native else reader.iter_bgr_timed())
    done = 0
    # per-worker stage names: StageTimers accumulators are only safe when
    # each name is written by a single thread
    stage_pl = stage.replace("decode", "planarize")
    try:
        while limit is None or done < limit:
            if timers:
                with timers.stage(stage):
                    item = next(it, None)
            else:
                item = next(it, None)
            if item is None or stop.is_set():
                return
            frame, pts = item
            if raw_hwc:
                # hwc layout: stage the raw decoded bytes; the layout
                # transform (and any BGR swap) runs on the device
                payload = np.ascontiguousarray(frame)
            elif timers:
                with timers.stage(stage_pl):
                    payload = native.planarize(frame, hp, wp,
                                               swap_rb=not rgb_native)
            else:
                payload = native.planarize(frame, hp, wp,
                                           swap_rb=not rgb_native)
            pts_q.append(pts)
            if not ring.push(payload):
                return
            done += 1
    except Exception as e:  # pragma: no cover - decoder internals
        errbox.append(e)
    finally:
        ring.close()
        if own_reader:
            reader.close()


class _RingChain:
    """Ordered consumption across N chunk rings: pop drains ring k fully
    (closed + empty) before advancing to ring k+1, keeping frame order
    strictly sequential while later chunks decode in parallel."""

    def __init__(self, rings, pts_qs):
        self.rings = rings
        self.pts_qs = pts_qs
        self._k = 0
        self.last_pts = None

    def pop(self, out, timeout_ms: int) -> int:
        while self._k < len(self.rings):
            rc = self.rings[self._k].pop(out, timeout_ms=timeout_ms)
            if rc == 0:
                q = self.pts_qs[self._k]
                self.last_pts = q.popleft() if q else None
                return 0
            if rc == -1:  # this chunk is done: move to the next
                self._k += 1
                continue
            return rc  # timeout
        return -1

    def close(self) -> None:
        for r in self.rings:
            r.close()


def stream_dips(job: DiPsJob) -> Iterator[Tuple[int, Optional[np.ndarray],
                                                np.ndarray, np.ndarray]]:
    """Core streaming loop: yields (frame_index, input, output, stats) while
    a decode thread keeps the device fed (bounded ring = backpressure).

    ``input`` is the decoded RGB frame when ``job.yield_inputs`` resolves
    true (explicitly, or automatically because a ``frame_callback`` is
    set), else None — reassembling HWC from the planar device layout is a
    full host pass per frame that the main encode path never reads."""
    if not job.video_path:
        raise VideoPathError("no video path set (DiPsJob.with_video_path)")
    import collections
    from .io.gstreamer import open_video
    if job.input_layout not in ("planar", "hwc"):
        raise ValueError(f"unknown input_layout {job.input_layout!r}")
    # downscale decimates inside the device layout prep: hwc path implied
    hwc_mode = job.input_layout == "hwc" or job.downscale > 1
    reader = (job.reader if job.reader is not None
              else open_video(job.video_path, job.video_backend))
    # readers that decode natively to RGB skip the device channel swap
    rgb_native = getattr(reader, "native_rgb", False)
    layout = ("planar" if not hwc_mode
              else ("hwc" if rgb_native else "hwc_bgr"))
    try:
        engine = DiPsEngine(job.properties, reader.height, reader.width,
                            batch=job.batch,
                            packed_wire=job.packed_wire, input_layout=layout,
                            downscale=job.downscale)
    except Exception:
        reader.close()
        raise
    hp, wp = engine.hp, engine.wp
    slot_bytes = (reader.height * reader.width * 3 if hwc_mode
                  else 3 * hp * wp)
    timers = StageTimers() if job.profile else None
    job.timers = timers
    job.engine = engine  # run artifact: heatmap/state outlive the stream
    engine.timers = timers  # h2d / dispatch / d2h split inside "device"
    job.frame_pts = []
    stop = threading.Event()
    errbox: list = []
    slots = max(2, job.queue_depth) * job.batch

    nw = max(1, int(job.decode_workers))
    total = getattr(reader, "frame_count", -1)
    if nw > 1 and total and total > 0 and hasattr(reader, "seek_frame"):
        # Parallel chunked decode: N readers, each seeked to its contiguous
        # chunk, feeding its own bounded ring; the chain consumes chunks in
        # order while later chunks pre-decode (decode is the usual wall on
        # multi-core hosts — the chip outruns one decoder by far).
        nw = min(nw, total)
        reader.close()
        per = total // nw
        bounds = [(k * per, per if k < nw - 1 else total - (nw - 1) * per)
                  for k in range(nw)]
        rings = [native.FrameRing(slots=max(2, slots // nw),
                                  slot_bytes=slot_bytes) for _ in range(nw)]
        pts_qs = [collections.deque() for _ in range(nw)]
        workers = []
        opened: list = []
        try:
            for k, (start, count) in enumerate(bounds):
                rd = open_video(job.video_path, job.video_backend)
                opened.append(rd)
                rd.seek_frame(start)
                suffix = "" if k == 0 else str(k)
                workers.append(threading.Thread(
                    target=_decode_worker,
                    args=(rd, hp, wp, rings[k], stop, errbox, pts_qs[k],
                          timers, f"decode{suffix}", count, True, hwc_mode),
                    daemon=True))
        except BaseException:
            # a later chunk's open/seek failing (file renamed between the
            # probe and here, FD exhaustion) must not leak the readers
            # already opened — no worker owns them yet
            for rd in opened:
                try:
                    rd.close()
                except Exception:
                    pass
            raise
        source = _RingChain(rings, pts_qs)
        readers_to_close: list = []
    else:
        ring = native.FrameRing(slots=slots, slot_bytes=slot_bytes)
        pts_q: collections.deque = collections.deque()
        workers = [threading.Thread(
            target=_decode_worker,
            args=(reader, hp, wp, ring, stop, errbox, pts_q, timers,
                  "decode", None, False, hwc_mode),
            daemon=True)]
        source = _RingChain([ring], [pts_q])
        readers_to_close = [reader]
    for wk in workers:
        wk.start()

    idx = 0
    h, w = engine.height, engine.width
    t = engine.tail_rows  # buffer offset of new frames (0 in ring-carry)
    want_inputs = (job.yield_inputs if job.yield_inputs is not None
                   else job.frame_callback is not None)

    def emit(pending):
        """Collect a dispatched batch and yield its frames."""
        nonlocal idx
        handle, batch, pts_batch = pending
        if timers:
            with timers.stage("device"):
                outs, stats = engine.collect(handle)
            timers.add_frames(len(batch))
        else:
            outs, stats = engine.collect(handle)
        if job.denoise_radius:
            from .ops.analysis import denoise_frames
            outs = np.asarray(
                denoise_frames(outs, int(job.denoise_radius)))
        for i in range(len(batch)):
            out = outs[i]
            job.frame_pts.append(pts_batch[i])
            # RGB input for hooks/consumers — a full host pass, built only
            # when something reads it
            if not want_inputs:
                inp = None
            elif hwc_mode:
                inp = (batch[i] if rgb_native
                       else np.ascontiguousarray(batch[i][:, :, ::-1]))
            else:
                inp = native.interleave(batch[i], h, w)
            if job.frame_callback is not None:
                try:
                    replacement = job.frame_callback(idx, inp, out, stats[i])
                except Exception as e:
                    raise FrameCallbackError(str(e)) from e
                if replacement is not None:
                    out = replacement
            yield idx, inp, out, stats[i]
            idx += 1

    try:
        # pipeline_depth 2: one batch stays in flight — while batch k
        # downloads/encodes, batch k+1 is already dispatched (JAX async),
        # the double-buffering the reference's per-frame blocking readback
        # never had.  Depth 1 collects immediately (see DiPsJob).
        overlap = int(getattr(job, "pipeline_depth", 1) or 1) > 1
        pending = None
        eos = False
        patient = job.decode_stall_s is None
        stall_ms = (30000 if patient
                    else max(1, int(job.decode_stall_s * 1e3)))
        while not eos:
            # pop decoded frames straight into the device batch buffer —
            # no intermediate staging copy
            buf = engine.new_batch_buffer()
            n = 0
            pts_batch = []
            while n < job.batch:
                rc = source.pop(buf[t + n], timeout_ms=stall_ms)
                if rc == -1:
                    eos = True
                    break
                if rc == -2:
                    if n:
                        break  # flush what we have
                    if patient:  # sparse live source: silence is normal
                        if errbox:
                            break
                        continue
                    raise DecodeError("decode stalled (ring timeout; "
                                      "decode_stall_s=None waits forever)")
                pts_batch.append(source.last_pts)
                n += 1
            if errbox:
                raise DecodeError(str(errbox[0])) from errbox[0]
            if n:
                # views stay valid: each loop allocates a fresh buffer and
                # dispatch_async only writes the tail/padding rows
                batch = [buf[t + i] for i in range(n)]
                if timers:
                    with timers.stage("device"):
                        handle = engine.dispatch_async(buf, n)
                else:
                    handle = engine.dispatch_async(buf, n)
                prev, pending = pending, (handle, batch, pts_batch)
                if prev is not None:
                    yield from emit(prev)
                if not overlap:
                    yield from emit(pending)
                    pending = None
        if pending is not None:
            yield from emit(pending)
    finally:
        stop.set()
        source.close()
        # join the decode threads BEFORE releasing their readers: cv2's
        # VideoCapture.release() racing a concurrent read() on another
        # thread is undefined behaviour (can crash)
        for wk in workers:
            wk.join(timeout=10.0)
        for r in readers_to_close:
            r.close()


def perform_dips(job: DiPsJob) -> np.ndarray:
    """Run the whole job: input video -> diff-map video; returns per-frame
    stats (N, NUM_STATS).  (ref: perform_dips, dips/src/lib.rs:252-257.)

    Map suppression (``props.out_channels == 0``: OutputMode.STATS_ONLY,
    or ``emit_maps=False`` on any pipeline) runs the whole configured
    pipeline with the map suppressed end to end: no output video is
    written (``output_path`` must be unset), the return value / stats
    artifacts / heatmap / auto-refresh are the products."""
    stats_only = job.properties.out_channels == 0
    if stats_only:
        if job.output_path:
            raise OutputPathError(
                "output_path set with a map-suppressed pipeline "
                "(STATS_ONLY / emit_maps=False) — it writes no video "
                "(drop the output, or re-enable maps)")
        if job.record_events:
            raise ValueError(
                "record_events writes diff-map clips; a map-suppressed "
                "pipeline (STATS_ONLY / emit_maps=False) has no maps to "
                "record (use events/stats artifacts instead)")
        if job.denoise_radius:
            raise ValueError("denoise filters diff maps; a map-suppressed "
                             "pipeline (STATS_ONLY / emit_maps=False) has "
                             "none")
    elif not job.output_path:
        raise OutputPathError("no output path set (DiPsJob.with_output_path)")
    if not job.video_path:
        raise VideoPathError("no video path set")
    from .io.gstreamer import open_video, open_writer
    # probe fps/geometry on the reader stream_dips will CONSUME — a
    # second connect would double-session network sources (rtsp/srt).
    # A caller-provided reader (e.g. the CLI's --flicker-hz fps probe)
    # is reused for the same reason, not re-opened.
    reader = (job.reader if job.reader is not None
              else open_video(job.video_path, job.video_backend))
    fps, w, h = reader.fps, reader.width, reader.height
    if job.downscale > 1:
        # the written video, event clips and pixel counts all live at the
        # analysis geometry (the engine validates the same divisibility)
        k = int(job.downscale)
        if h % k or w % k:
            reader.close()
            raise ValueError(
                f"downscale {k} must divide the input geometry {h}x{w}")
        h, w = h // k, w // k
    caller_job = job
    job = dataclasses.replace(job, reader=reader)

    if stats_only:
        import contextlib
        writer = contextlib.nullcontext()
        writer.close = lambda: None

        def emit(out, pts):
            pass  # no maps, nothing to encode
    else:
        try:
            writer = open_writer(job.output_path, fps, w, h, job.encoding,
                                 job.video_backend)
        except Exception:
            reader.close()
            raise
        from .io.gstreamer import GstVideoWriter
        from .io.video import CfrRetimer
        gst_writer = isinstance(writer, GstVideoWriter)
        retimer = (CfrRetimer(fps)
                   if (job.retime_vfr and not gst_writer) else None)

        def emit(out, pts):
            if gst_writer:
                writer.write(out, pts=pts)  # VFR-preserving: PTS ride
            elif retimer is not None:
                for f in retimer.feed(out, pts):
                    writer.write(f)
            else:
                writer.write(out)

    recorder = None
    if job.record_events:
        try:  # a bad config must not leak the opened reader/writer
            import os
            from .io.eventrecorder import EventRecorder
            from .ops.events import MotionDetector
            cfg = dict(job.record_events)
            rdir = cfg.pop("dir")
            os.makedirs(rdir, exist_ok=True)
            det_cfg = dict(cfg.pop("detector", {}) or {})
            if det_cfg.get("metric") == "changed_frac":
                det_cfg.setdefault(
                    "pixels", job.properties.analysis_pixels(h, w))
            det_cfg.setdefault("on_threshold", "auto")
            stem = os.path.splitext(os.path.basename(job.output_path))[0]

            def _open_segment(i, start):
                p = os.path.join(rdir, f"{stem}.event{i:03d}_f{start}.avi")
                return open_writer(p, fps, w, h, job.encoding,
                                   job.video_backend)

            recorder = EventRecorder(
                MotionDetector(**det_cfg), _open_segment,
                pre_roll=cfg.pop("pre_roll", 30),
                post_roll=cfg.pop("post_roll", 30))
            if cfg:
                raise ValueError(
                    f"unknown record_events keys: {sorted(cfg)}")
        except Exception:
            reader.close()
            writer.close()
            raise

    refresher = None
    if job.auto_refresh is not None:
        try:  # a bad config must not leak the opened reader/writer
            from .properties import DiPsMethod
            from .ops.refresh import BaselineRefreshPolicy
            if job.properties.method is not DiPsMethod.OVERALL:
                raise ValueError(
                    "auto_refresh re-pins the OVERALL baseline; "
                    "method=per_frame has none")
            cfg = dict(job.auto_refresh)
            if cfg.get("metric", "changed_frac") == "changed_frac":
                cfg.setdefault(
                    "pixels", job.properties.analysis_pixels(h, w))
            # must swallow the snapshot latency: up to 2 in-flight batches
            # still diff against the old baseline after a trigger
            cfg.setdefault(
                "cooldown", cfg.get("persist", 3) + 2 * job.batch)
            refresher = BaselineRefreshPolicy(**cfg)
        except Exception:
            reader.close()
            writer.close()
            raise

    stats_rows: List[np.ndarray] = []
    try:
        with writer:
            for idx, _inp, out, stats in stream_dips(job):
                pts = job.frame_pts[-1] if job.frame_pts else None
                if job.timers:
                    with job.timers.stage("encode"):
                        emit(out, pts)
                else:
                    emit(out, pts)
                if recorder is not None:
                    recorder.feed(out, stats, idx)
                if refresher is not None and refresher.feed(idx, stats):
                    job.engine.snapshot()
                    log.info("auto-refresh: baseline re-capture requested "
                             "at frame %d", idx)
                stats_rows.append(stats)
                if idx % 100 == 0:
                    log.info("frame %d", idx)
    finally:
        if recorder is not None:
            # ANY exit — decode error, Ctrl-C on a live camera — must
            # close the open segment writer, or the in-progress clip (the
            # evidence this feature exists to retain) is unplayable
            job.event_segments = recorder.finish()
        # run artifacts land on the CALLER's job even when the run died
        # mid-stream (stream_dips populated the internal copy that
        # carries the pre-opened reader)
        caller_job.timers = job.timers
        caller_job.frame_pts = job.frame_pts
        caller_job.frame_geometry = (h, w)
        caller_job.engine = job.engine
        caller_job.event_segments = job.event_segments
        if refresher is not None:
            caller_job.baseline_refreshes = job.baseline_refreshes = (
                list(refresher.refreshes))
    if job.timers:
        log.info("%s", job.timers)
    return (np.stack(stats_rows) if stats_rows
            else np.zeros((0, NUM_STATS), np.float32))


def run_dips_on_file(input_path: str, output_path: str,
                     encoding: Encoding | str = Encoding.MJPG,
                     properties: Optional[DiPsProperties] = None,
                     refresh_markers: Sequence[int] = (),
                     batch: int = 8,
                     video_backend: str = "auto") -> np.ndarray:
    """dips_alt CLI-style entry (ref dips_alt/src/lib.rs:554-690): bare
    refresh markers re-capture the baseline mid-stream."""
    props = properties or DiPsProperties()
    if refresh_markers:
        props = props.with_refresh_markers(
            tuple(props.refresh_markers) + tuple(refresh_markers))
    job = DiPsJob(properties=props, video_path=input_path,
                  output_path=output_path, batch=batch,
                  video_backend=video_backend)
    job = job.with_encoding(encoding)
    return perform_dips(job)


def init_frame_extractor() -> None:
    """Media-stack initialisation hook (ref: dips/src/lib.rs:248-250, which
    runs gst::init).  The OpenCV backend needs none; the optional GStreamer
    backend initialises lazily — kept as a no-op for API parity."""


def init_thumbnail_extractor() -> None:
    """Parity hook (ref: dips/src/lib.rs:259-261); see
    :func:`init_frame_extractor`."""


def run_dips_app(properties: Optional[DiPsProperties] = None,
                 camera: int = 0) -> int:
    """Live webcam app (ref: run_dips_app, dips_alt/src/lib.rs:543-552);
    delegates to the cv2 preview loop in live.py."""
    from .live import run_live
    return run_live(properties or DiPsProperties(), camera=camera)


def run_dips_on_files(input_paths: Sequence[str], output_dir: str,
                      encoding: Encoding | str = Encoding.MJPG,
                      properties: Optional[DiPsProperties] = None,
                      batch: int = 8,
                      mesh=None, input_layout: str = "planar",
                      video_backend: str = "auto",
                      events: Optional[dict] = None,
                      collect_stats: bool = False,
                      downscale: int = 1,
                      auto_refresh: Optional[dict] = None,
                      flicker: Optional[dict] = None):
    """Batched multi-stream differencing over many videos (BASELINE
    configs[3]): decode S files in lockstep, run the sharded multi-stream
    step over the device mesh, write one diff video per input.

    All inputs must share geometry/fps (the multi-stream batch is one
    stacked tensor).  Streams shorter than the longest are padded on device
    and their outputs truncated.  Returns per-stream frame counts.

    ``events``: optional MotionDetector kwargs (see ops/events.py; pixels
    is filled in from the shared geometry) — one detector segments EACH
    stream's stats, and the return becomes ``(counts, events_per_stream)``
    with one list of closed :class:`~dips.ops.events.MotionEvent` per
    input.

    ``collect_stats=True`` appends a per-stream stats list to the return
    (``counts, [events,] stats_per_stream`` — each entry
    (n_i, NUM_STATS) for that stream's true frame count).

    ``downscale=k`` decimates every stream on device (k x k box mean in
    the layout prep): inputs decode at full resolution, the diff videos,
    statistics and events land at the 1/k analysis geometry.

    ``auto_refresh``: optional BaselineRefreshPolicy kwargs (see
    ops/refresh.py) — each stream gets its own adaptive baseline refresh,
    so a wholesale scene change on one input re-pins only ITS baseline
    (OVERALL method only).  Appends a per-stream list of fired frame
    indices to the return.

    ``flicker``: optional dict(freq_hz=..., tau_frames=None) — per-stream
    flicker maps via ONE FleetFlickerAnalyzer (all streams' demodulator
    planes updated in one device dispatch per round, ops/analysis.py;
    fps comes from the shared reader clock).  Appends a (S, H_in, W_in)
    array of amplitude maps to the return (full INPUT geometry — the
    analyzer sees the decoded frames, before any downscale).
    """
    import os
    from .io.gstreamer import open_video, open_writer
    from .parallel import MultiStreamEngine, stream_mesh
    props = properties or DiPsProperties()
    enc = Encoding[encoding.upper()] if isinstance(encoding, str) else encoding
    if input_layout not in ("planar", "hwc"):
        # frames from readers are always RGB — "hwc_bgr" (an engine-level
        # layout for raw decoder bytes) would silently swap channels here
        raise ValueError(f"unknown input_layout {input_layout!r}")

    readers: list = []
    writers: list = []
    try:
        for p in input_paths:
            readers.append(open_video(p, video_backend))
        h, w, fps = readers[0].height, readers[0].width, readers[0].fps
        for r in readers[1:]:
            if (r.height, r.width) != (h, w):
                raise VideoPathError(
                    f"{r.path}: geometry {r.width}x{r.height} != {w}x{h} "
                    f"(multi-stream batches require uniform geometry)")
            if abs(r.fps - fps) > 0.51:  # the documented shared-fps contract
                raise VideoPathError(
                    f"{r.path}: fps {r.fps:g} != {fps:g} (multi-stream "
                    f"outputs share one clock; retime or process "
                    f"separately)")

        mesh = mesh if mesh is not None else stream_mesh()
        n_dev = dict(zip(mesh.axis_names, mesh.devices.shape)).get(
            "stream", mesh.devices.size)
        s = len(readers)
        pad_streams = (-s) % n_dev  # stream axis: a multiple of its size
        eng = MultiStreamEngine(props, h, w, n_streams=s + pad_streams,
                                batch=batch, mesh=mesh,
                                input_layout=input_layout,
                                downscale=downscale)
        # outputs/stats/events land at the analysis geometry
        h, w = eng.height, eng.width

        stats_only = props.out_channels == 0
        if not stats_only:  # STATS_ONLY: no diff videos, no writers at all
            os.makedirs(output_dir, exist_ok=True)
            # inputs sharing a basename (camA/clip.avi + camB/clip.avi)
            # must not overwrite each other's output: disambiguate by
            # stream index
            stems = [os.path.splitext(os.path.basename(p))[0]
                     for p in input_paths]
            dup = {t for t in stems if stems.count(t) > 1}
            for si, stem in enumerate(stems):
                name = (f"{stem}.{si}" if stem in dup else stem) + ".dips.avi"
                writers.append(open_writer(os.path.join(output_dir, name),
                                           fps, w, h, enc, video_backend))
        counts = np.zeros(s, np.int64)
        detectors = None
        if events is not None:
            from .ops.events import MotionDetector
            cfg = dict(events)
            if cfg.get("metric") == "changed_frac":
                cfg.setdefault("pixels", props.analysis_pixels(h, w))
            detectors = [MotionDetector(**cfg) for _ in range(s)]
            stream_events: list = [[] for _ in range(s)]
        refreshers = None
        if auto_refresh is not None:
            from .properties import DiPsMethod
            from .ops.refresh import BaselineRefreshPolicy
            if props.method is not DiPsMethod.OVERALL:
                raise ValueError(
                    "auto_refresh re-pins the OVERALL baseline; "
                    "method=per_frame has none")
            rcfg = dict(auto_refresh)
            if rcfg.get("metric", "changed_frac") == "changed_frac":
                rcfg.setdefault("pixels", props.analysis_pixels(h, w))
            # the re-capture lands on the NEXT batch dispatch
            rcfg.setdefault("cooldown", rcfg.get("persist", 3) + 2 * batch)
            refreshers = [BaselineRefreshPolicy(**rcfg) for _ in range(s)]
        stream_stats: Optional[list] = ([[] for _ in range(s)]
                                        if collect_stats else None)
        fleet_flicker = None
        if flicker is not None:
            from .ops.analysis import FleetFlickerAnalyzer
            fcfg = dict(flicker)
            fleet_flicker = FleetFlickerAnalyzer(s, chroma=props.chroma)
            fleet_flicker.configure_all(
                float(fcfg.pop("freq_hz")), fps,
                tau_frames=fcfg.pop("tau_frames", None))
            if fcfg:
                raise ValueError(f"unknown flicker options {sorted(fcfg)}")
        done = [False] * s
        while not all(done):
            feeds = []
            for si in range(s + pad_streams):
                if si >= s or done[si]:
                    feeds.append([])
                    continue
                frames = []
                for _ in range(batch):
                    f = readers[si].read()
                    if f is None:
                        done[si] = True
                        break
                    frames.append(f)
                feeds.append(frames)
            if not any(feeds):
                break
            out, stats, _ = eng.process_batch(feeds)
            if fleet_flicker is not None:
                # one stacked scan dispatch for the whole fleet round;
                # failed streams stop feeding below, so gate them here too
                fleet_flicker.update(
                    [fd if si < s and si not in eng.failed else []
                     for si, fd in enumerate(feeds[:s])])
            for si in range(s):
                if si in eng.failed:
                    # isolated stream: stop decoding/writing it — its buffer
                    # rows are zeros, not real diff maps
                    if not done[si]:
                        log.warning("stream %d (%s) failed and was "
                                    "isolated: %s", si, input_paths[si],
                                    eng.failed[si])
                        done[si] = True
                    continue
                n = len(feeds[si])
                if not stats_only:
                    for k in range(n):
                        writers[si].write(out[si, k])
                counts[si] += n
                if detectors is not None and n:
                    stream_events[si] += detectors[si].update(
                        stats[si, :n],
                        start_index=eng.frame_cursors[si] - n)
                if refreshers is not None and n:
                    start = eng.frame_cursors[si] - n
                    if any([refreshers[si].feed(start + k, stats[si, k])
                            for k in range(n)]):
                        eng.snapshot(stream=si)
                        log.info("auto-refresh: stream %d baseline "
                                 "re-capture at frame %d", si,
                                 refreshers[si].refreshes[-1])
                if stream_stats is not None and n:
                    stream_stats[si].append(stats[si, :n])
    finally:
        for r in readers:
            r.close()
        for wr in writers:
            wr.close()
    if eng.failed:
        counts = counts.copy()
        for si in eng.failed:
            if si < s:
                counts[si] = -1  # sentinel: failed stream, output truncated
    out = [counts]
    if detectors is not None:
        for si in range(s):
            stream_events[si] += detectors[si].flush()  # EOS closes opens
        out.append(stream_events)
    if stream_stats is not None:
        from .ops.oracle import NUM_STATS as _NS
        out.append([np.concatenate(rows) if rows
                    else np.zeros((0, _NS), np.float32)
                    for rows in stream_stats])
    if refreshers is not None:
        out.append([list(r.refreshes) for r in refreshers])
    if fleet_flicker is not None:
        # a run that decoded zero frames (all inputs empty) has no flicker
        # state at all — return zero maps at the input geometry rather
        # than raising from amplitudes()
        out.append(fleet_flicker.amplitudes()
                   if any(fleet_flicker.frames_seen)
                   else np.zeros((s, readers[0].height, readers[0].width),
                                 np.float32))
    return out[0] if len(out) == 1 else tuple(out)


def custom_dips_on_files(data_dir: str, output_path: str,
                         width: int = 273, height: int = 640,
                         fps: float = 5.0,
                         properties: Optional[DiPsProperties] = None,
                         encoding: Encoding = Encoding.MJPG,
                         batch: int = 8,
                         show: bool = False) -> np.ndarray:
    """Raw 'Dat_N.d' instrument-dump batch mode (ref dips_alt/src/lib.rs:
    693-900; geometry defaults mirror its hardcoded 273x640, fps=5).

    ``show`` previews each diff map in a window while processing (the
    reference's imshow progress, dips_alt/src/lib.rs:679-682); silently
    skipped on headless hosts.
    """
    props = properties or DiPsProperties()
    frames = list(read_dat_dir(data_dir, width, height))
    if not frames:
        raise VideoPathError(f"no Dat_*.d files in {data_dir}")
    engine = DiPsEngine(props, height, width, batch=batch)
    preview = None
    if show:
        from .live import _to_bgr
        import os as _os
        import sys as _sys
        if not _sys.platform.startswith("linux") or (
                _os.environ.get("DISPLAY")
                or _os.environ.get("WAYLAND_DISPLAY")):
            import cv2
            preview = (cv2, _to_bgr)
        else:
            log.warning("dat preview requested but no display; skipping")
    stats_rows = []
    with VideoWriter(output_path, fps, width, height, encoding) as writer:
        for i in range(0, len(frames), batch):
            outs, stats = engine.process_batch(frames[i:i + batch])
            for o in outs:
                writer.write(o)
                if preview is not None:
                    cv2, to_bgr = preview
                    cv2.imshow("DiPs dat", to_bgr(o))
                    cv2.waitKey(1)
            stats_rows.append(stats)
    if preview is not None:
        preview[0].destroyAllWindows()
    return np.concatenate(stats_rows)
