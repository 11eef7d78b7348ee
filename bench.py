"""Benchmark harness: 1080p frames/sec/device of the XLA step.

Headline metric: sustained device throughput of the bit-exact ABSDIFF
parity mode — the same computation `cv2.absdiff` performs (uint8
|frame - baseline| per channel) plus per-frame statistics and the
accumulated heatmap.  The full median/emphasis/colorize pipeline (which the
CPU baseline does not attempt) is measured alongside and reported on
stderr.

Methodology: frames are resident in device memory and a `lax.fori_loop` of
pipeline steps runs inside one jit — one dispatch, no host round-trips —
then a two-point fit removes the fixed dispatch overhead.  Host transfers
are measured by ``--e2e`` (file decode -> device -> host diff maps).  The
CPU baseline gets the same courtesy: frames pre-decoded in RAM,
preallocated output, tight loop, best of several trials.

Every run names its device (platform, device kind, count, and the card's
name and power limit where ``nvidia-smi`` exists) on stderr and in the
JSON line.  Prints exactly ONE JSON line on stdout.
"""

import argparse
import json
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _timed(fn):
    t0 = time.time()
    fn()
    return time.time() - t0


def device_info() -> dict:
    """What this run measured on: JAX's view plus the card's power limit."""
    import jax
    from dips.doctor import nvidia_smi
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "nvidia_smi": nvidia_smi()}


def bench_cpu_absdiff(frames, baseline, trials=3, seconds=1.5):
    """cv2.absdiff frames/s on the host CPU, or None without OpenCV."""
    try:
        import cv2
    except ImportError:
        return None
    dst = np.empty_like(baseline)
    best = 0.0
    for _ in range(trials):
        cv2.absdiff(frames[0], baseline, dst)
        t0 = time.time()
        n = 0
        while time.time() - t0 < seconds:
            for f in frames:
                cv2.absdiff(f, baseline, dst)
            n += len(frames)
        best = max(best, n / (time.time() - t0))
    return best


def _fit(loop, args, iters):
    """Per-call seconds of ``loop(n, *args)`` from a two-point fit over
    ``iters`` = (n1, n2) loop lengths (min of 3 timings each)."""
    import jax
    t0 = time.time()
    jax.block_until_ready(loop(2, *args))
    log(f"  compile+warmup: {time.time() - t0:.1f}s")
    n1, n2 = iters
    times = [min(_timed(lambda: jax.block_until_ready(loop(n, *args)))
                 for _ in range(3)) for n in (n1, n2)]
    per_step = (times[1] - times[0]) / (n2 - n1)
    if per_step <= 0:
        raise RuntimeError(f"non-positive two-point fit {times}: raise "
                           f"--iters")
    return per_step


def bench_device(props, h, w, batch, iters=(10, 60)):
    """Sustained device rate of one pipeline config (module docstring)."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from dips.ops import reference
    from dips.ops.reference import pad_geometry
    from dips.properties import OutputMode

    raw_mode = props.output in (OutputMode.ABSDIFF, OutputMode.THRESHOLD,
                                OutputMode.STATS_ONLY)
    hp, wp = pad_geometry(h, w)
    t = props.temporal_size
    raw = jax.random.randint(jax.random.key(0), (t + batch, 3, hp, wp), 0,
                             256, jnp.int32).astype(jnp.uint8)
    if raw_mode:
        baseline = jnp.zeros((3, hp, wp), jnp.uint8)
    else:
        baseline = jnp.zeros((hp, wp), jnp.float32)
    heatmap = jnp.zeros((hp, wp), jnp.float32)
    flags = jnp.zeros((batch,), bool).at[0].set(True)
    valid = np.ones((batch,), bool)
    step = (reference.absdiff_step if raw_mode
            else reference.batch_step).__wrapped__

    @jax.jit
    def loop(n, raw, baseline, heatmap, flags):
        def body(_, carry):
            bl, hm, acc = carry
            out, stats, bl, hm = step(props, h, w, raw, bl, flags, hm,
                                      valid)
            # consume outputs so nothing is dead-code-eliminated
            # (STATS_ONLY has a zero-channel out: nothing to consume)
            o = (out[0, 0, 0, 0].astype(jnp.float32) if out.size
                 else jnp.float32(0))
            return bl, hm, acc + stats.sum() + o
        return lax.fori_loop(0, n, body, (baseline, heatmap,
                                          jnp.float32(0)))[2]

    per_step = _fit(loop, (raw, baseline, heatmap, flags), iters)
    fps = batch / per_step
    log(f"  {per_step / batch * 1e3:.4f} ms/frame -> {fps:.0f} fps/device")
    return fps


def _write_bench_clip(path, h, w, n, fps=30):
    import cv2
    r = np.random.default_rng(0)
    base = r.integers(0, 256, (h, w, 3), np.uint8)
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), fps, (w, h))
    if not wr.isOpened():
        raise RuntimeError("MJPG writer unavailable")
    for i in range(n):
        f = base.copy()
        y = (10 + 3 * i) % max(h - 40, 1)
        x = (10 + 7 * i) % max(w - 40, 1)
        f[y:y + 40, x:x + 40] = (40, 220, 40)
        wr.write(f)
    wr.release()


def bench_cpu_e2e(path):
    """CPU decode-to-diff-map baseline: cv2 decode loop + absdiff per frame
    (the like-for-like end-to-end job on the host CPU)."""
    import cv2
    cap = cv2.VideoCapture(path)
    ok, first = cap.read()  # baseline frame: warm decode, outside the timer
    if not ok:
        raise RuntimeError(f"could not decode bench clip {path}")
    dst = np.empty_like(first)
    n = 0
    t0 = time.time()
    while True:
        ok, f = cap.read()
        if not ok:
            break
        cv2.absdiff(f, first, dst)
        n += 1
    dt = time.time() - t0
    cap.release()
    return n / dt if dt > 0 else 0.0


def bench_e2e(h, w, n_frames, batch, decode_workers, mode="absdiff",
              temporal=4):
    """Measured end-to-end decode-to-diff-map fps through the real streaming
    pipeline (file decode -> planarize -> device step -> host diff maps),
    with per-stage shares from StageTimers.  ``mode``: "absdiff"
    (3-channel maps), "threshold" (1-channel masks), "threshold-packed"
    (masks bit-packed on device before D2H, ops/wire.py) or "stats-only"."""
    import tempfile
    from dips.app import DiPsJob, stream_dips
    from dips.properties import DiPsProperties, OutputMode

    d = tempfile.mkdtemp()
    path = f"{d}/bench.avi"
    t0 = time.time()
    _write_bench_clip(path, h, w, n_frames)
    log(f"  clip synthesized: {n_frames}f {w}x{h} ({time.time() - t0:.1f}s)")

    cpu_fps = bench_cpu_e2e(path)
    log(f"  CPU e2e baseline (decode + cv2.absdiff): {cpu_fps:.0f} fps")

    out_mode = {"absdiff": OutputMode.ABSDIFF,
                "stats-only": OutputMode.STATS_ONLY}.get(
                    mode, OutputMode.THRESHOLD)
    props = DiPsProperties(output=out_mode, temporal_size=temporal)

    def run(profile):
        job = DiPsJob(properties=props, video_path=path, batch=batch,
                      video_backend="opencv",
                      decode_workers=decode_workers, profile=profile,
                      packed_wire=(mode == "threshold-packed"))
        t0 = time.time()
        n = sum(1 for _ in stream_dips(job))
        return n, time.time() - t0, job.timers

    run(False)  # warm-up: compile + page the file into cache
    n, dt, timers = run(True)
    fps = n / dt
    log(f"  e2e[{mode}]: {n} frames in {dt:.2f}s -> {fps:.0f} fps "
        f"({decode_workers} decode worker(s))")
    for name, row in timers.summary().items():
        log(f"    {name:<12} {row}")
    return fps, cpu_fps


def bench_multistream(s, h, w, batch, temporal=4, iters=(5, 25)):
    """Aggregate rate of S streams on one device: the MultiStreamEngine
    per-shard body (the XLA step vmapped over streams)."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from dips.ops import reference
    from dips.ops.reference import pad_geometry
    from dips.properties import DiPsProperties, OutputMode

    hp, wp = pad_geometry(h, w)
    t = temporal
    props = DiPsProperties(output=OutputMode.ABSDIFF, temporal_size=t)
    raw = jax.random.randint(jax.random.key(0), (s, t + batch, 3, hp, wp),
                             0, 256, jnp.int32).astype(jnp.uint8)
    baseline = jnp.zeros((s, 3, hp, wp), jnp.uint8)
    heatmap = jnp.zeros((s, hp, wp), jnp.float32)
    flags = np.zeros((s, batch), bool)
    flags[:, 0] = True
    valid = np.ones((s, batch), bool)
    step = jax.vmap(lambda r, b2, f, h2, v: reference.absdiff_step.__wrapped__(
        props, h, w, r, b2, f, h2, v))

    @jax.jit
    def loop(n, raw, baseline, heatmap):
        def body(_, carry):
            bl, hm, acc = carry
            out, stats, bl, hm = step(raw, bl, flags, hm, valid)
            return bl, hm, acc + stats.sum() + out.ravel()[0].astype(
                jnp.float32)
        return lax.fori_loop(0, n, body,
                             (baseline, heatmap, jnp.float32(0)))[2]

    per_step = _fit(loop, (raw, baseline, heatmap), iters)
    agg = s * batch / per_step
    log(f"  {s} x {w}x{h}: {agg:.0f} fps aggregate ({agg / s:.0f} "
        f"fps/stream)")
    return agg


PRESETS = {
    "headline-1080p": dict(h=1080, w=1920, method="overall"),
    "overall-480p": dict(h=480, w=854, method="overall"),
    "perframe-720p": dict(h=720, w=1280, method="per_frame"),
    "heatmap-1080p": dict(h=1080, w=1920, method="overall"),  # heatmap is
    # always accumulated by the step; same measurement surface
    "streaming-4k": dict(h=2160, w=3840, method="overall"),
}


def _emit(metric, value, unit, base, device):
    print(json.dumps({
        "metric": metric,
        "value": round(value, 1),
        "unit": unit,
        "vs_baseline": round(value / base, 2) if base else None,
        "device": device,
    }))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=sorted(PRESETS), default=None,
                    help="benchmark config")
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--window", type=int, default=3)
    ap.add_argument("--temporal", type=int, default=4)
    ap.add_argument("--approx-median", action="store_true",
                    help="bench the separable approximate spatial median")
    ap.add_argument("--iters", default="10,60", metavar="N1,N2",
                    help="two-point-fit loop lengths (default 10,60)")
    ap.add_argument("--full-pipeline-headline", action="store_true",
                    help="report the median/colorize pipeline as the "
                         "headline instead of the absdiff parity mode")
    ap.add_argument("--stats-only", action="store_true",
                    help="ALSO bench OutputMode.STATS_ONLY (the no-map "
                         "events-fleet mode: statistics + heatmap, no "
                         "map egress) and report it as the headline")
    ap.add_argument("--no-maps", action="store_true",
                    help="ALSO bench the full median pipeline with "
                         "emit_maps=False (median-filtered stats/heatmap, "
                         "no map computation or egress) and report it as "
                         "the headline")
    ap.add_argument("--e2e", action="store_true",
                    help="measured end-to-end decode-to-diff-map fps on a "
                         "real clip (file decode included) instead of the "
                         "device-resident step rate")
    ap.add_argument("--e2e-frames", type=int, default=150)
    ap.add_argument("--e2e-mode", default="absdiff",
                    choices=["absdiff", "threshold", "threshold-packed",
                             "stats-only"],
                    help="e2e output mode; threshold-packed bit-packs the "
                         "masks on device before D2H (8x less transfer); "
                         "stats-only suppresses maps entirely (the fleet "
                         "events/metrics shape: ~128 B/frame D2H)")
    ap.add_argument("--decode-workers", type=int, default=1)
    ap.add_argument("--streams", type=int, metavar="S",
                    help="bench the multi-stream aggregate for S streams "
                         "of --height x --width on one device instead of "
                         "the single-stream step")
    ap.add_argument("--compile-cache", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="persist compiled executables "
                         "($JAX_COMPILATION_CACHE_DIR, else "
                         "<checkout>/.jax_cache) so repeat runs skip jit "
                         "compilation (default: on)")
    ap.add_argument("--backend-timeout", type=float, default=600.0,
                    metavar="S",
                    help="seconds to wait for jax backend init; a wedged "
                         "driver can block jax.devices() instead of "
                         "failing — on timeout print an error JSON line "
                         "and exit 1")
    args = ap.parse_args()

    if args.compile_cache:  # before any compile
        from dips.utils.compilecache import enable_compile_cache
        log(f"compile cache: {enable_compile_cache()}")

    # Backend watchdog BEFORE any jax backend touch (doctor.py owns the
    # probe): a hang here must become a machine-readable failure.
    from dips.doctor import _probe_jax
    jinfo = _probe_jax(args.backend_timeout)
    if jinfo.get("backend") is None:
        print(json.dumps({
            "metric": "backend_unreachable", "value": 0.0,
            "unit": "frames/s/device", "vs_baseline": 0.0,
            "error": jinfo.get("hint") or "jax backend init failed",
        }))
        sys.exit(1)
    device = device_info()
    log(f"device: {device}")

    try:
        iters = tuple(int(v) for v in args.iters.split(","))
        assert len(iters) == 2 and 0 < iters[0] < iters[1]
    except (ValueError, AssertionError):
        print(json.dumps({"metric": "bad_iters", "value": 0.0,
                          "unit": "frames/s/device", "vs_baseline": 0.0,
                          "error": f"--iters wants N1,N2 ascending, got "
                                   f"{args.iters!r}"}))
        sys.exit(2)

    if args.e2e:
        fps, cpu_fps = bench_e2e(args.height, args.width, args.e2e_frames,
                                 args.batch, args.decode_workers,
                                 mode=args.e2e_mode, temporal=args.temporal)
        suffix = "" if args.e2e_mode == "absdiff" else f"_{args.e2e_mode}"
        _emit(f"{args.height}p_e2e_decode_to_diffmap"
              f"{suffix.replace('-', '_')}_fps", fps, "frames/s", cpu_fps,
              device)
        return

    from dips.properties import DiPsMethod, DiPsProperties, OutputMode
    method = DiPsMethod.OVERALL
    h, w = args.height, args.width
    name = "absdiff_parity"
    if args.preset:
        cfg = PRESETS[args.preset]
        h, w = cfg["h"], cfg["w"]
        method = DiPsMethod[cfg["method"].upper()]
        name = args.preset

    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (h, w, 3), np.uint8) for _ in range(8)]
    cpu_fps = bench_cpu_absdiff(frames, frames[0])
    log(f"cv2.absdiff CPU baseline: {cpu_fps} fps @ {w}x{h}")

    if args.streams:
        agg = bench_multistream(args.streams, h, w, args.batch,
                                args.temporal, iters)
        _emit(f"{h}p_x{args.streams}_aggregate_fps_per_device", agg,
              "frames/s/device", cpu_fps, device)
        return

    raw_props = DiPsProperties(output=OutputMode.ABSDIFF, method=method,
                               temporal_size=args.temporal)
    full_props = DiPsProperties(window_size=args.window, method=method,
                                temporal_size=args.temporal,
                                approx_median=args.approx_median)
    log("ABSDIFF parity mode (bit-exact vs cv2.absdiff):")
    absdiff_fps = bench_device(raw_props, h, w, args.batch, iters=iters)
    log("full pipeline (median/sigmoid/colorize/stats/heatmap):")
    full_fps = bench_device(full_props, h, w, args.batch, iters=iters)
    if args.no_maps:
        log("median pipeline, emit_maps=False (filtered stats, no maps):")
        value = bench_device(full_props.with_emit_maps(False), h, w,
                             args.batch, iters=iters)
        metric = f"{h}p_{name}_median_no_maps_fps_per_device"
    elif args.stats_only:
        so_props = DiPsProperties(output=OutputMode.STATS_ONLY,
                                  method=method,
                                  temporal_size=args.temporal)
        log("STATS_ONLY mode (no map, stats+heatmap only):")
        value = bench_device(so_props, h, w, args.batch, iters=iters)
        metric = f"{h}p_{name}_stats_only_fps_per_device"
    elif args.full_pipeline_headline:
        value, metric = (full_fps,
                         f"{h}p_{name}_full_pipeline_fps_per_device")
    else:
        value, metric = absdiff_fps, f"{h}p_{name}_fps_per_device"
    _emit(metric, value, "frames/s/device", cpu_fps, device)


if __name__ == "__main__":
    main()
