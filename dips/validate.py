"""Deployment acceptance check: on-device parity against the numpy oracle.

``python -m dips.validate [--quick] [--height H --width W] [--frames N]``
runs every pipeline configuration through ``DiPsEngine`` on the CURRENT
jax backend, at full 1080p frames by default, and compares each with the
numpy oracle (``ops/oracle.py``).  Exit code 0 = the installed
jax/dips stack produces correct results on this host.

Tolerances (:func:`compare`; docs/DESIGN.md "Numerics contract"):

* raw modes (absdiff / threshold / stats-only): u8 maps bit-exact and
  ``changed_count`` exact — integer arithmetic end to end;
* f32 emphasis paths: at most 1 LSB per u8 map value.  A device's
  ``exp`` and fused multiply-add contraction can flip an exact x.5
  rounding tie of the final quantize; where the path is pure min/max
  (unfiltered emphasis) at most 1% of the values may differ at all;
  ``changed_count`` within 1% of the frame's pixels (knife-edge pixels
  at the threshold);
* statistics: ``atol 1e-4, rtol 1e-3`` — the device sums in another
  order than numpy;
* heatmap: ``atol 1e-3`` (a sum of per-frame |diff| planes).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from .models import DiPsEngine
from .ops.oracle import DiPsOracle
from .properties import (DiPsFilter, DiPsMethod, DiPsProperties,
                         OutputMode)

_RAW_MODES = (OutputMode.ABSDIFF, OutputMode.THRESHOLD,
              OutputMode.STATS_ONLY)


def _roi(h: int, w: int):
    """An analysis region inside an h x w frame (10% margins, taller
    bottom margin)."""
    return (h // 10, w // 10, 4 * h // 5, 9 * w // 10)


#: (name, properties, exact): ``exact`` marks pure min/max emphasis paths,
#: held to the 1% tie-flip bound on top of the 1-LSB bound.  Properties
#: that depend on the geometry are given as ``(h, w) -> properties``.
CASES = [
    ("overall/colorize/sigmoid/w3/t4 + markers",
     DiPsProperties(refresh_markers=(5,)), False),
    ("per_frame/colorize/sigmoid/w3/t4",
     DiPsProperties(method=DiPsMethod.PER_FRAME), False),
    ("overall/absdiff (cv2 parity)",
     DiPsProperties(output=OutputMode.ABSDIFF), True),
    ("per_frame/threshold",
     DiPsProperties(method=DiPsMethod.PER_FRAME,
                    output=OutputMode.THRESHOLD, change_threshold=20), True),
    ("overall/stats_only (no-map fleet mode)",
     DiPsProperties(output=OutputMode.STATS_ONLY, refresh_markers=(5,)),
     True),
    ("overall/colorize/unfiltered/w7 exact median",
     DiPsProperties(window_size=7, filter=DiPsFilter.UNFILTERED), True),
    ("overall/colorize/unfiltered/w5/t2",
     DiPsProperties(window_size=5, temporal_size=2,
                    filter=DiPsFilter.UNFILTERED), True),
    ("per_frame/gray/inv_sig/w3/t3",
     DiPsProperties(method=DiPsMethod.PER_FRAME,
                    output=OutputMode.GRAYSCALE,
                    filter=DiPsFilter.INVERSE_SIGMOID, temporal_size=3),
     False),
    ("overall/colorize/w7 approx-median",
     DiPsProperties(window_size=7, temporal_size=2,
                    filter=DiPsFilter.UNFILTERED, approx_median=True),
     True),
    ("overall/colorize/w5 quirk-compat",
     DiPsProperties(window_size=5, temporal_size=2,
                    filter=DiPsFilter.UNFILTERED, quirk_compat=True), True),
    ("overall/median no-maps (emit_maps=False)",
     DiPsProperties(window_size=3, temporal_size=2,
                    filter=DiPsFilter.UNFILTERED, emit_maps=False,
                    refresh_markers=(5,)), True),
    ("overall/absdiff + roi (analysis region)",
     lambda h, w: DiPsProperties(output=OutputMode.ABSDIFF, temporal_size=2,
                                 roi=_roi(h, w)), True),
    ("per_frame/colorize + roi",
     lambda h, w: DiPsProperties(method=DiPsMethod.PER_FRAME,
                                 temporal_size=2,
                                 filter=DiPsFilter.UNFILTERED,
                                 roi=_roi(h, w)), True),
]

#: the configurations ``--quick`` runs (one per step family)
QUICK = ("overall/colorize/sigmoid/w3/t4 + markers",
         "overall/absdiff (cv2 parity)",
         "overall/colorize/unfiltered/w7 exact median")


def clip(n: int, height: int, width: int, seed: int = 0) -> np.ndarray:
    """Seeded (n, H, W, 3) uint8 frames: noise background + a moving
    square (signal for overall and per-frame modes alike)."""
    from .io.synthetic import moving_square_clip
    return moving_square_clip(n, height, width, seed=seed,
                              square=max(8, min(height, width) // 16))


def oracle_run(props: DiPsProperties, frames: np.ndarray):
    """The numpy spec on ``frames``: (maps (N, H, W, C), stats, heatmap)."""
    o = DiPsOracle(props)
    out, stats = o.run(frames)
    if out.ndim == 3:
        out = out[..., None]
    return out, stats, o.heatmap


def compare(props: DiPsProperties, got, expected, exact: bool) -> dict:
    """Hold (maps, stats, heatmap) ``got`` to the oracle's ``expected``
    within the module's tolerances; raises AssertionError on a violation.
    Returns the measured ``max_u8_diff`` and ``tie_flip_frac``."""
    got_out, got_stats, got_heat = got
    exp_out, exp_stats, exp_heat = expected
    if got_out.shape != exp_out.shape:
        raise AssertionError(f"map shape {got_out.shape} != {exp_out.shape}")
    raw = props.output in _RAW_MODES
    diff = np.abs(got_out.astype(np.int16) - exp_out.astype(np.int16))
    max_diff = int(diff.max()) if diff.size else 0
    flips = float((diff != 0).mean()) if diff.size else 0.0
    if raw:
        assert max_diff == 0, f"u8 diff {max_diff} != 0"
    else:
        assert max_diff <= 1, f"u8 diff {max_diff} > 1"
        if exact:
            assert flips <= 0.01, f"tie-flip fraction {flips:.3%} > 1%"
    np.testing.assert_allclose(got_stats[:, :3], exp_stats[:, :3],
                               atol=1e-4, rtol=1e-3)
    h, w = exp_heat.shape
    cnt_tol = 0 if raw else 0.01 * h * w
    cnt_err = float(np.abs(got_stats[:, 3] - exp_stats[:, 3]).max())
    assert cnt_err <= cnt_tol, f"changed_count off by {cnt_err}"
    np.testing.assert_allclose(got_heat, exp_heat, atol=1e-3)
    return {"max_u8_diff": max_diff, "tie_flip_frac": flips}


def check_engine(engine: DiPsEngine, frames: np.ndarray, exact: bool,
                 feed=None, expected=None) -> dict:
    """Run ``frames`` through a fresh ``engine`` and compare with the
    oracle.  ``feed`` maps the frames to what the engine consumes (e.g.
    BGR bytes for an ``hwc_bgr`` engine); ``expected`` is a precomputed
    :func:`oracle_run` result."""
    if expected is None:
        expected = oracle_run(engine.props, frames)
    src = list(frames) if feed is None else [feed(f) for f in frames]
    out, stats = engine.process_frames(src)
    return compare(engine.props, (out, stats, engine.heatmap()), expected,
                   exact)


def _case(results, name, verbose, fn) -> int:
    """Run one gate; record and print its outcome; 1 = failed."""
    t0 = time.time()
    try:
        m = fn() or {}
        ok, err = True, None
    except Exception as e:
        m, ok, err = {}, False, e
    if verbose:
        if ok:
            extra = "".join(f" {k}={v:g}" for k, v in m.items())
            print(f"  PASS {name:<44s} ({time.time() - t0:.1f}s){extra}")
        else:
            print(f"  FAIL {name:<44s} {err}")
    if results is not None:
        results.append({"case": name, "ok": ok,
                        "seconds": round(time.time() - t0, 2), **m,
                        **({"error": str(err)[:500]} if err else {})})
    return 0 if ok else 1


def run(quick: bool = False, verbose: bool = True, results=None,
        height: int = 1080, width: int = 1920, n_frames: int = 12,
        batch: int = 16) -> int:
    """Every case (``quick``: :data:`QUICK`) at ``height`` x ``width``
    over ``n_frames`` seeded frames, plus the device-side input layout
    and downscale gates.  Returns 0 when all pass."""
    import jax
    from .ops import reference
    frames = clip(n_frames, height, width)
    if verbose:
        print(f"backend: {jax.default_backend()}, devices: {jax.devices()}, "
              f"frames: {n_frames}x{height}x{width}")
    failures = 0
    for name, props, exact in CASES:
        if quick and name not in QUICK:
            continue
        if callable(props):
            props = props(height, width)
        failures += _case(results, name, verbose, lambda: check_engine(
            DiPsEngine(props, height, width, batch=batch), frames, exact))
    if quick:
        return _verdict(failures, verbose)

    unf = DiPsProperties(filter=DiPsFilter.UNFILTERED)
    # raw RGB bytes up, transpose + pad + BGR swap on the device: pure
    # layout, so it is held to the same contract as the planar path
    failures += _case(results, "input-layout hwc_bgr", verbose,
                      lambda: check_engine(
                          DiPsEngine(unf, height, width, batch=batch,
                                     input_layout="hwc_bgr"),
                          frames, True, feed=lambda f: f[:, :, ::-1]))
    k = 2
    if height % k == 0 and width % k == 0:
        # on-device k x k decimation vs the oracle on host-pooled frames
        # (reference.pool_frame_host is the decimation's host twin)
        pooled = np.stack([reference.pool_frame_host(f, k) for f in frames])
        failures += _case(results, "on-device downscale=2", verbose,
                          lambda: check_engine(
                              DiPsEngine(unf, height, width, batch=batch,
                                         downscale=k),
                              frames, True,
                              expected=oracle_run(unf, pooled)))
    return _verdict(failures, verbose)


def _verdict(failures: int, verbose: bool) -> int:
    if verbose:
        print("PASS: device numerics match the oracle" if not failures
              else f"FAIL: {failures} case(s) diverged")
    return 1 if failures else 0


def soak(n_frames: int = 512, verbose: bool = True, results=None,
         height: int = 48, width: int = 180, batch: int = 16) -> int:
    """Streaming soak: ``n_frames`` through one engine with refresh
    markers, held to the oracle frame by frame; then a fresh engine
    restored from a mid-stream checkpoint replays the rest and must
    reproduce the original run's maps and statistics bit for bit."""
    props = DiPsProperties(window_size=3, temporal_size=4,
                           filter=DiPsFilter.UNFILTERED,
                           refresh_markers=(37, 201, 202, 450))
    frames = clip(n_frames, height, width, seed=3)
    # last batch boundary at-or-before the midpoint (always hit)
    ckpt_at = max(0, (n_frames // 2 // batch - 1) * batch)

    def body():
        eng = DiPsEngine(props, height, width, batch=batch)
        outs, stats, ckpt = [], [], None
        for start in range(0, n_frames, batch):
            if start == ckpt_at:
                ckpt = eng.state_dict()
            o, s = eng.process_batch(list(frames[start:start + batch]))
            outs.append(o)
            stats.append(s)
        out, st = np.concatenate(outs), np.concatenate(stats)
        m = compare(props, (out, st, eng.heatmap()),
                    oracle_run(props, frames), True)
        assert ckpt is not None
        replay = DiPsEngine(props, height, width, batch=batch)
        replay.load_state_dict(ckpt)
        ro, rs = [], []
        for start in range(ckpt_at, n_frames, batch):
            o, s = replay.process_batch(list(frames[start:start + batch]))
            ro.append(o)
            rs.append(s)
        assert np.array_equal(np.concatenate(ro), out[ckpt_at:]), \
            "checkpoint replay maps diverged"
        assert np.array_equal(np.concatenate(rs), st[ckpt_at:]), \
            "checkpoint replay stats diverged"
        return m

    return 1 if _case(results, f"soak {n_frames}f + ckpt replay", verbose,
                      body) else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="dips on-device numerics acceptance check")
    ap.add_argument("--quick", action="store_true",
                    help=f"{len(QUICK)} cases instead of {len(CASES)} "
                         f"(fewer compiles)")
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--frames", type=int, default=12,
                    help="frames compared per case (default 12)")
    ap.add_argument("--soak", type=int, nargs="?", const=512, default=None,
                    metavar="N",
                    help="streaming soak: N frames (default 512) with "
                         "markers, held to the oracle, plus a mid-stream "
                         "checkpoint replay")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write a machine-readable result artifact (per-"
                         "case pass/fail + environment) to PATH")
    ap.add_argument("--with-soak", type=int, nargs="?", const=512,
                    default=None, metavar="N",
                    help="ALSO run the N-frame soak after the case matrix "
                         "(one artifact covering both)")
    from .utils.compilecache import (add_compile_cache_flag,
                                     apply_compile_cache_flag)
    add_compile_cache_flag(ap)
    args = ap.parse_args(argv)
    apply_compile_cache_flag(args)

    results = [] if args.json else None
    t0 = time.time()
    if args.soak is not None:
        rc = soak(args.soak, results=results)
    else:
        rc = run(args.quick, results=results, height=args.height,
                 width=args.width, n_frames=args.frames)
        if args.with_soak is not None and rc == 0:
            rc |= soak(args.with_soak, results=results)
    if args.json:
        import jax
        doc = {
            "tool": "dips.validate",
            "jax_backend": jax.default_backend(),
            "devices": [str(d) for d in jax.devices()],
            "jax_version": jax.__version__,
            "geometry": [args.height, args.width],
            "quick": bool(args.quick),
            "ok": rc == 0,
            "cases": results,
            "passed": sum(1 for r in results if r["ok"]),
            "failed": sum(1 for r in results if not r["ok"]),
            "elapsed_s": round(time.time() - t0, 1),
        }
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
        print(f"wrote {args.json}")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
