#!/usr/bin/env python3
"""Smoke run of the main path on the GPU, compared with the numpy oracle.

    python3 chip_smoke.py                # one card
    python3 chip_smoke.py --four-cards   # the multi-card paths only

One card: 1080p (1920x1080) frames from a seeded generator go through the
paths a user calls — ``DiPsEngine.process_frames`` (window 3, T=4, B=16:
OVERALL with refresh markers, PER_FRAME, ABSDIFF, THRESHOLD, STATS_ONLY
and the exact window-7 median), ``MultiStreamEngine``, and an in-process
``DiPsServer`` answering ``DiPsClient`` requests (a named session with a
snapshot and a heatmap, and a ``--coalesce`` run of several sessions).
The first frames of every phase are compared with ``ops/oracle.py``
under ``dips.validate``'s tolerances:

* raw modes: u8 maps bit-exact and ``changed_count`` exact;
* f32 emphasis paths: at most 1 LSB, and at most 1% tie flips where the
  path is pure min/max (the GPU's ``exp`` and FMA contraction can flip an
  exact x.5 rounding tie);
* statistics ``atol 1e-4, rtol 1e-3`` (another summation order);
* heatmap ``atol 1e-3``.

The remaining frames are only timed.  Each hand-written kernel of the
path (the Triton exact median, one per window of
``median_triton.WINDOWS``) is also compared, as compiled for the card,
with the plain XLA median on 1080p planes: bit-exact.  ``--four-cards``
runs a 4-stream ``MultiStreamEngine`` on ``stream_mesh(4)`` against
single-card engines, and one 4320x7680 stream row-sharded over four
cards against the same frames on one card.

Every phase that fails ends the run with a non-zero exit.  The last line
of standard output is the JSON verdict; a run without a GPU prints
``{"ok": false, ...}`` and exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time

import numpy as np

H, W = 1080, 1920
BATCH = 16
#: the 8K stream of the rows-mesh check (about 34 M pixels per frame)
H8, W8, BATCH8 = 4320, 7680, 4

#: validate.CASES entries run here (the main path's configurations)
SMOKE_CASES = ("overall/colorize/sigmoid/w3/t4 + markers",
               "per_frame/colorize/sigmoid/w3/t4",
               "overall/absdiff (cv2 parity)",
               "per_frame/threshold",
               "overall/stats_only (no-map fleet mode)",
               "overall/colorize/unfiltered/w7 exact median")


def log(msg: str) -> None:
    print(msg, flush=True)


def verdict(ok: bool, devices=None, error: str = "") -> str:
    """The last line: the device as JAX reports it, or the failure."""
    if not ok:
        return json.dumps({"ok": False, "error": error})
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def require_gpu(devices) -> str:
    """'' when the run may proceed, else why it may not."""
    if not devices or devices[0].platform != "gpu":
        plat = devices[0].platform if devices else "none"
        return f"no GPU: jax platform is {plat!r}"
    return ""


def _cases():
    from dips import validate
    by_name = {name: (props, exact) for name, props, exact in validate.CASES}
    return [(n,) + by_name[n] for n in SMOKE_CASES]


def _per_batch(process, frames, batch):
    """Seconds per batch of ``process`` over ``frames`` (results fetched
    to the host, so the device work is done when the clock stops)."""
    starts = range(0, len(frames), batch)
    t0 = time.perf_counter()
    for i in starts:
        process(frames[i:i + batch])
    return (time.perf_counter() - t0) / len(starts)


def phase_engine(name, props, exact, frames, n_check):
    """One DiPsEngine configuration: compare, then time.  Returns the
    compile seconds (first batch minus a steady one)."""
    from dips import DiPsEngine
    from dips import validate
    expected = validate.oracle_run(props, frames[:n_check])
    eng = DiPsEngine(props, H, W, batch=BATCH)
    t0 = time.perf_counter()
    out, stats = eng.process_frames(list(frames[:n_check]))
    first = time.perf_counter() - t0
    m = validate.compare(props, (out, stats, eng.heatmap()), expected,
                         exact)
    per_batch = _per_batch(lambda f: eng.process_batch(list(f)),
                           frames[n_check:], BATCH)
    compile_s = max(0.0, first - per_batch)
    log(f"PASS {name}: compile_s={compile_s:.2f} "
        f"fps={BATCH / per_batch:.1f} max_u8_diff={m['max_u8_diff']} "
        f"tie_flip_frac={m['tie_flip_frac']:.6f}")
    return compile_s


def phase_multistream(frames, n_check, n_streams=2):
    """MultiStreamEngine on a one-card mesh, every stream vs the oracle."""
    from dips import DiPsProperties, MultiStreamEngine, stream_mesh
    from dips import validate
    props = DiPsProperties(refresh_markers=(5,))
    clips = np.stack([np.roll(frames, 97 * k, axis=2)
                      for k in range(n_streams)], axis=1)  # (N, S, ...)
    eng = MultiStreamEngine(props, H, W, n_streams=n_streams, batch=BATCH,
                            mesh=stream_mesh(1))

    def process(f):
        return eng.process_batch([list(f[:, k]) for k in range(n_streams)])

    res = [process(clips[i:min(i + BATCH, n_check)])
           for i in range(0, n_check, BATCH)]
    out = np.concatenate([r[0] for r in res], axis=1)
    stats = np.concatenate([r[1] for r in res], axis=1)
    heat = eng.heatmaps()
    worst = {"max_u8_diff": 0, "tie_flip_frac": 0.0}
    for k in range(n_streams):
        m = validate.compare(
            props, (out[k], stats[k], heat[k]),
            validate.oracle_run(props, clips[:n_check, k]), False)
        worst = {key: max(worst[key], m[key]) for key in worst}
    per_batch = _per_batch(process, clips[n_check:], BATCH)
    log(f"PASS multistream {n_streams}x{H}p: "
        f"fps={n_streams * BATCH / per_batch:.1f} "
        f"max_u8_diff={worst['max_u8_diff']} "
        f"tie_flip_frac={worst['tie_flip_frac']:.6f}")


def _best_seconds(fn, *args, reps=5):
    import jax
    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def phase_kernels(n_planes=BATCH + 4):
    """Every hand-written kernel against the plain XLA reference on
    ``n_planes`` full-size intensity planes (the T + B planes of a step):
    the Triton exact median per window, bit-exact, and both timed."""
    import functools
    import jax
    import jax.numpy as jnp
    from dips.ops import median_triton, reference
    rng = np.random.default_rng(1)
    planes = jnp.asarray(rng.integers(0, 511, (n_planes, H, W))
                         .astype(np.float32))
    for w in median_triton.WINDOWS:
        p = w // 2
        padded = jnp.pad(planes, ((0, 0), (p, p), (p, p)))
        kern = jax.jit(functools.partial(median_triton.window_median,
                                         window=w))
        ref = jax.jit(functools.partial(reference.xla_window_median,
                                        window=w))
        got, exp = np.asarray(kern(padded)), np.asarray(ref(padded))
        assert got.shape == exp.shape == (n_planes, H, W), got.shape
        bad = int((got != exp).sum())
        assert bad == 0, f"triton w{w} median: {bad} pixels differ from XLA"
        log(f"PASS kernel median w{w} {n_planes}x{H}x{W} vs XLA: exact; "
            f"triton {_best_seconds(kern, padded) * 1e3:.3f} ms "
            f"xla {_best_seconds(ref, padded) * 1e3:.3f} ms")


def _serve(srv):
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return t


def phase_serve(frames, n_frames=6):
    """In-process daemon: a named session (process, snapshot, heatmap) and
    a coalesced run of several sessions, replies vs the oracle."""
    from dips import DiPsProperties
    from dips import validate
    from dips.serve import DiPsClient, DiPsServer
    props = DiPsProperties(refresh_markers=(5,))
    clip = frames[:n_frames]
    expected = validate.oracle_run(props, clip)

    srv = DiPsServer(props, H, W, port=0, batch=1, max_sessions=2)
    _serve(srv)
    try:
        cli = DiPsClient(srv.port, session="cam-A")
        assert cli.hello()["config"]["height"] == H
        t0 = time.perf_counter()
        outs, stats = zip(*(cli.process(f) for f in clip))
        dt = time.perf_counter() - t0
        m = validate.compare(props, (np.stack(outs), np.stack(stats),
                                     cli.heatmap()), expected, False)
        cli.snapshot()
        _, s = cli.process(frames[n_frames])
        assert s[1] == 0, "snapshot did not re-capture the baseline"
        assert cli.heatmap().shape == (H, W)
        cli.close()
    finally:
        srv.shutdown()
    log(f"PASS serve named session: {n_frames} replies in {dt:.2f}s "
        f"max_u8_diff={m['max_u8_diff']} "
        f"tie_flip_frac={m['tie_flip_frac']:.6f}")

    n_sess = 3
    srv = DiPsServer(props, H, W, port=0, batch=2, coalesce=n_sess)
    _serve(srv)
    results = [None] * n_sess
    clips = [np.roll(clip, 131 * k, axis=1) for k in range(n_sess)]

    def run(k):
        c = DiPsClient(srv.port, session=f"cam-{k}")
        assert c.hello()["config"]["coalesced"] is True
        o, s = zip(*(c.process(f) for f in clips[k]))
        results[k] = (np.stack(o), np.stack(s), c.heatmap())
        c.close()

    try:
        t0 = time.perf_counter()
        ts = [threading.Thread(target=run, args=(k,)) for k in range(n_sess)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=600)
        dt = time.perf_counter() - t0
        for k in range(n_sess):
            assert results[k] is not None, f"coalesced session {k} failed"
            validate.compare(props, results[k],
                             validate.oracle_run(props, clips[k]), False)
    finally:
        srv.shutdown()
    log(f"PASS serve --coalesce {n_sess} sessions: "
        f"{n_sess * n_frames} replies in {dt:.2f}s")


def one_card(n_frames: int) -> None:
    import jax
    from dips import validate
    n_check = 12
    t0 = time.perf_counter()
    frames = validate.clip(n_check + n_frames, H, W)
    log(f"frames: {len(frames)}x{H}x{W} generated in "
        f"{time.perf_counter() - t0:.1f}s")
    phase_kernels()
    cold = {}
    for name, props, exact in _cases():
        cold[name] = phase_engine(name, props, exact, frames, n_check)
    phase_multistream(frames, n_check)
    phase_serve(frames)
    # warm compile: drop the in-memory executables; the persistent cache
    # must serve the recompile
    name, props, exact = _cases()[0]
    jax.clear_caches()
    warm = phase_engine(name, props, exact, frames[:n_check + BATCH],
                        n_check)
    log(f"compile seconds {name}: cold={cold[name]:.2f} warm={warm:.2f}")


def four_cards(n_frames: int) -> None:
    import jax
    from dips import DiPsEngine, DiPsProperties, MultiStreamEngine
    from dips import validate
    from dips.parallel import stream_mesh
    from dips.parallel.grid2d import grid_mesh
    devs = jax.devices()[:4]
    assert len(devs) == 4, f"--four-cards needs 4 GPUs, found {len(devs)}"
    props = DiPsProperties(refresh_markers=(5,))

    # (a) four 1080p streams, one per card
    frames = validate.clip(n_frames, H, W)
    clips = [np.roll(frames, 97 * k, axis=2) for k in range(4)]
    eng = MultiStreamEngine(props, H, W, n_streams=4, batch=BATCH,
                            mesh=stream_mesh(4))
    outs, stats = [], []
    t0 = time.perf_counter()
    for i in range(0, n_frames, BATCH):
        o, s, _ = eng.process_batch([list(c[i:i + BATCH]) for c in clips])
        outs.append(o)
        stats.append(s)
    dt = time.perf_counter() - t0
    out, stat, heat = (np.concatenate(outs, 1), np.concatenate(stats, 1),
                       eng.heatmaps())
    placed = eng._heatmap.sharding.device_set
    assert len(placed) == 4, f"streams sit on {len(placed)} cards"
    for k, c in enumerate(clips):
        ref = DiPsEngine(props, H, W, batch=BATCH)
        ro, rs = ref.process_frames(list(c))
        validate.compare(props, (out[k], stat[k], heat[k]),
                         (ro, rs, ref.heatmap()), False)
    log(f"PASS stream mesh 4x{H}p vs 4 single-card runs: "
        f"{4 * n_frames} frames in {dt:.2f}s (first batch compiles)")

    # (b) one 8K stream split by rows over the four cards
    h8, w8, b8 = H8, W8, BATCH8
    frames8 = validate.clip(2 * b8, h8, w8, seed=8)
    eng = MultiStreamEngine(props, h8, w8, n_streams=1, batch=b8,
                            mesh=grid_mesh(1, 4))
    outs, stats = [], []
    t0 = time.perf_counter()
    for i in range(0, len(frames8), b8):
        o, s, _ = eng.process_batch([list(frames8[i:i + b8])])
        outs.append(o[0])
        stats.append(s[0])
    dt = time.perf_counter() - t0
    placed = eng._heatmap.sharding.device_set
    assert len(placed) == 4, f"row slabs sit on {len(placed)} cards"
    in_use = [(d.memory_stats() or {}).get("bytes_in_use") for d in devs]
    assert all(b is None or b > 0 for b in in_use), \
        f"idle card: bytes_in_use={in_use}"
    ref = DiPsEngine(props, h8, w8, batch=b8)
    ro, rs = ref.process_frames(list(frames8))
    m = validate.compare(props, (np.concatenate(outs), np.concatenate(stats),
                                 eng.heatmaps()[0]),
                         (ro, rs, ref.heatmap()), False)
    log(f"PASS rows mesh {h8}x{w8} over 4 cards vs one card: "
        f"{len(frames8)} frames in {dt:.2f}s (first batch compiles) "
        f"max_u8_diff={m['max_u8_diff']} bytes_in_use={in_use}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card stream-mesh and rows-mesh "
                         "checks")
    ap.add_argument("--frames", type=int, default=64,
                    help="timed 1080p frames per phase after the 12 "
                         "compared ones (default 64)")
    args = ap.parse_args(argv)

    import jax
    devices = jax.devices()
    why = require_gpu(devices)
    if why:
        print(verdict(False, error=why), flush=True)
        return 2
    from dips.doctor import nvidia_smi
    from dips.utils.compilecache import enable_compile_cache
    cache = enable_compile_cache()
    log(nvidia_smi() or "nvidia-smi: not available")
    log(f"jax.devices(): {devices}")
    log(f"compile cache: {cache} ({len(os.listdir(cache))} entries "
        f"before this run)")
    from dips import native
    log(f"host layout kernels: "
        f"{native.SIMD_NAMES.get(native.simd_level())}")
    if args.four_cards:
        four_cards(max(args.frames // 2, BATCH))
    else:
        one_card(args.frames)
    print(verdict(True, jax.devices()), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
