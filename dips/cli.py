"""Command-line interface, mirroring the reference CLI surface.

Option parity with ``dips_alt/src/help.txt:1-59`` and its hand-rolled
``--key=value`` parser (dips_alt/src/main.rs:14-81): --input, --output,
--encoding (RGBA/HFYU/H264 + MJPG/mp4v), --filter (sigmoid/inv_sig/none),
--sig_scalar (clamped 1..10), --chroma (r/g/b/""), --win_size (odd 1..7),
--colorize, --live, bare integers as refresh markers — plus the rebuild's
first-class extras: --method overall|per_frame (README.md:7-11 promises both),
--output-mode, --temporal, --batch, --stats-json, and utility
modes --thumbnail / --subsample / --dat-dir.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from .properties import (ChromaFilter, DiPsFilter, DiPsMethod, DiPsProperties,
                         Encoding, OutputMode)

_FILTERS = {"sigmoid": DiPsFilter.SIGMOID, "inv_sig": DiPsFilter.INVERSE_SIGMOID,
            "none": DiPsFilter.UNFILTERED, "": DiPsFilter.UNFILTERED}
_CHROMA = {"r": ChromaFilter.RED, "g": ChromaFilter.GREEN,
           "b": ChromaFilter.BLUE, "": ChromaFilter.ALL,
           "all": ChromaFilter.ALL}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dips",
        description="accelerated video frame-difference pixels (DiPs)")
    p.add_argument("markers", nargs="*", type=int, metavar="N",
                   help="bare integers: refresh-marker frame indices "
                        "(re-capture the baseline)")
    p.add_argument("--input", help="input video file")
    p.add_argument("--output", help="output video file")
    p.add_argument("--inputs", nargs="+", metavar="FILE",
                   help="multiple input videos: batched multi-stream mode, "
                        "sharded over the device mesh (requires --output-dir)")
    p.add_argument("--output-dir", help="output directory for --inputs mode")
    p.add_argument("--mesh", metavar="SxR",
                   help="2-D device mesh for --inputs mode: S stream shards "
                        "x R row slabs (e.g. 2x4); default is a 1-D stream "
                        "mesh over all devices")
    p.add_argument("--encoding", default="MJPG",
                   help="RGBA | HFYU | H264 | MJPG | mp4v")
    p.add_argument("--filter", default="sigmoid",
                   help="sigmoid | inv_sig | none")
    p.add_argument("--sig_scalar", type=float, default=5.0,
                   help="sigmoid horizontal scalar, clamped 1..10")
    p.add_argument("--chroma", default="",
                   help="r | g | b | '' (luminance)")
    p.add_argument("--win_size", type=int, default=3,
                   help="spatial median window, odd, clamped 1..7")
    p.add_argument("--approx-median", action="store_true",
                   help="separable spatial median (fast approximation "
                        "with documented rank bounds; default is exact)")
    p.add_argument("--quirk-compat", action="store_true",
                   help="replicate the reference's WGSL spatial-filter "
                        "bugs bit-for-bit (off-center window, structural "
                        "zeros, (n/2)+1 pick, u8 re-quantization) instead "
                        "of the clean median — for matching legacy output")
    p.add_argument("--roi", metavar="Y0,X0,Y1,X1",
                   help="analysis region (pixel bounds, end exclusive): "
                        "per-frame statistics, the heatmap and motion "
                        "events consider only this rectangle; output maps "
                        "stay full-frame")
    p.add_argument("--colorize", default="true",
                   help="true | false (false = grayscale diff)")
    p.add_argument("--method", default="overall",
                   choices=["overall", "per_frame"],
                   help="diff vs pinned snapshot or vs previous frame")
    p.add_argument("--output-mode", default=None,
                   choices=["colorize", "grayscale", "absdiff", "threshold",
                            "stats_only"],
                   help="overrides --colorize with absdiff/threshold modes; "
                        "stats_only suppresses the diff map entirely "
                        "(statistics/events/heatmap only — no output "
                        "video, far higher chip throughput)")
    p.add_argument("--no-maps", action="store_true",
                   help="suppress diff-map output for ANY pipeline "
                        "(emit_maps=False): the full configured pipeline "
                        "(spatial/temporal medians, emphasis, colorize/"
                        "grayscale stats semantics) still runs, but no map "
                        "bytes are computed or transferred — median-"
                        "filtered statistics/events/heatmap at stats-only "
                        "egress cost.  --output-mode stats_only is the "
                        "raw-absdiff shorthand (skips the medians too)")
    p.add_argument("--sensitivity", type=float, default=5.0)
    p.add_argument("--temporal", type=int, default=4,
                   help="temporal median ring length, 1..16")
    p.add_argument("--threshold", type=int, default=10,
                   help="uint8 change threshold for stats / threshold mode")
    p.add_argument("--batch", type=int, default=8,
                   help="frames per device dispatch")
    p.add_argument("--video-backend", default="auto",
                   choices=["auto", "opencv", "gstreamer"],
                   help="media decode/encode backend (the reference's "
                        "primary ingest is GStreamer)")
    p.add_argument("--retime-vfr", action="store_true",
                   help="dup/drop frames onto the CFR writer schedule so "
                        "variable-frame-rate inputs do not drift")
    p.add_argument("--decode-workers", type=int, default=1, metavar="N",
                   help="parallel chunked decode threads (order-preserving; "
                        "needs a seekable container)")
    p.add_argument("--pipeline-depth", type=int, default=1,
                   choices=[1, 2],
                   help="2 = keep one device batch in flight (overlap "
                        "transfers with compute; helps on PCIe hosts, "
                        "hurts on serialized links)")
    p.add_argument("--packed-wire", action="store_true",
                   help="THRESHOLD output only: bit-pack masks on the "
                        "device before download (8x less D2H transfer)")
    p.add_argument("--downscale", type=int, default=1, metavar="K",
                   help="on-device input decimation: analyze (and write) "
                        "at 1/K scale — K x K box mean inside the device "
                        "layout prep, so a 4K feed costs ~1080p device "
                        "work with no host resize.  K must divide the "
                        "input dimensions")
    p.add_argument("--input-layout", choices=("planar", "hwc"),
                   default="planar",
                   help="'hwc': upload raw decoded frames and run the "
                        "layout transform (+BGR swap) on the device - "
                        "frees the host's per-frame planarize pass for "
                        "decode")
    p.add_argument("--stats-json", metavar="PATH",
                   help="write per-frame statistics to a JSON file; with "
                        "--inputs, one row list per stream keyed by "
                        "input path")
    p.add_argument("--events-json", metavar="PATH",
                   help="segment the per-frame stats into motion events "
                        "(hysteresis + debounce, ops/events.py) and write "
                        "them to a JSON file; with --inputs, one event "
                        "list per stream keyed by input path")
    p.add_argument("--event-on", default=0.01, metavar="X|auto",
                   type=lambda s: s if s == "auto" else float(s),
                   help="metric level that OPENS an event (default 0.01 "
                        "= 1%% of pixels changed with the default "
                        "metric); 'auto' estimates each stream's noise "
                        "floor online (rolling low-quartile + IQR of "
                        "idle frames) — use for lossy/compressed sources "
                        "whose floor is scene-dependent")
    p.add_argument("--event-off", type=float, default=None, metavar="X",
                   help="level that closes it (default: half of "
                        "--event-on; invalid with --event-on auto, "
                        "which computes its own close level)")
    p.add_argument("--event-metric", default="changed_frac",
                   choices=("mean_abs_diff", "max_abs_diff",
                            "changed_count", "changed_frac"),
                   help="which per-frame statistic drives segmentation "
                        "(changed_frac = changed pixels / frame pixels, "
                        "resolution-independent)")
    p.add_argument("--event-min-frames", type=int, default=2, metavar="N",
                   help="discard events shorter than N frames (default 2)")
    p.add_argument("--heatmap-png", metavar="PATH",
                   help="save the run's accumulated |diff| heatmap as a "
                        "PNG (single-hue sequential rendering; embeddable "
                        "via dips-report --heatmap)")
    p.add_argument("--record-events", metavar="DIR",
                   help="event-triggered recording: additionally write "
                        "one clip per motion burst into DIR (pre/post-"
                        "roll included, bursts during post-roll merge); "
                        "the --event-* flags configure its detector and "
                        "DIR/segments.json records the spans")
    p.add_argument("--pre-roll", type=int, default=30, metavar="N",
                   help="frames kept before each recorded event "
                        "(default 30)")
    p.add_argument("--post-roll", type=int, default=30, metavar="N",
                   help="frames kept after each recorded event "
                        "(default 30)")
    p.add_argument("--auto-refresh", metavar="FRAC[:PERSIST[:COOLDOWN]]",
                   help="adaptive baseline refresh (overall method): "
                        "re-capture the snapshot when at least FRAC of "
                        "the analysis pixels stay changed for PERSIST "
                        "consecutive frames (default 3), then hold off "
                        "COOLDOWN frames (default covers the snapshot "
                        "latency).  Automates the reference's SnapShot "
                        "button for unattended scene changes; fired "
                        "frame indices are printed after the run.  In "
                        "--inputs mode each stream gets its own policy; "
                        "with --live it arms the preview's 'a' toggle")
    p.add_argument("--event-cooldown", type=int, default=0, metavar="N",
                   help="sub-threshold frames tolerated inside one event "
                        "before it closes (default 0)")
    p.add_argument("--profile", action="store_true",
                   help="print per-stage timings after the run")
    p.add_argument("--trace-dir", metavar="DIR",
                   help="capture a jax.profiler device trace into DIR")
    p.add_argument("--denoise", type=int, metavar="R",
                   help="FFT low-pass denoise radius applied to diff maps "
                        "(post-analysis, see ops/analysis.fft_denoise)")
    p.add_argument("--dft-json", metavar="PATH",
                   help="write the temporal DFT of the per-frame "
                        "mean-|diff| series to a JSON file")
    p.add_argument("--flicker-hz", type=float, metavar="F",
                   help="per-PIXEL temporal-frequency analysis: stream a "
                        "single-bin demodulator at F Hz over the input "
                        "(ops/analysis.FlickerAnalyzer) and print the "
                        "peak oscillation amplitude + location; F must be "
                        "below the input's Nyquist rate (fps/2). Costs "
                        "one extra host pass + device stream per frame")
    p.add_argument("--flicker-png", metavar="PATH",
                   help="save the --flicker-hz amplitude map as a PNG "
                        "(sequential rendering like --heatmap-png)")
    p.add_argument("--flicker-tau", type=float, metavar="N",
                   help="averaging time constant in frames for "
                        "--flicker-hz (default: max(16, 4*fps/F))")
    p.add_argument("--live", action="store_true",
                   help="live preview window (requires a display; the "
                        "reference's winit/egui GUI equivalent). Default "
                        "source is the webcam; add --input FILE-or-URI "
                        "(e.g. rtsp://cam/...) to preview that instead")
    # utility modes
    p.add_argument("--thumbnail", metavar="OUT.png",
                   help="extract a 240px-high thumbnail of --input and exit")
    p.add_argument("--subsample", type=int, metavar="N",
                   help="keep every Nth frame of --input into --output and exit")
    p.add_argument("--dat-dir", metavar="DIR",
                   help="process a directory of raw Dat_N.d dumps instead of "
                        "a video file")
    p.add_argument("--dat-geometry", default="273x640",
                   help="WIDTHxHEIGHT of raw dumps (default 273x640)")
    from .utils.compilecache import add_compile_cache_flag
    add_compile_cache_flag(p)
    return p


def props_from_args(args: argparse.Namespace) -> DiPsProperties:
    if args.output_mode:
        output = OutputMode[args.output_mode.upper()]
    else:
        output = (OutputMode.COLORIZE if args.colorize.lower() != "false"
                  else OutputMode.GRAYSCALE)
    try:
        filt = _FILTERS[args.filter.lower()]
    except KeyError:
        raise SystemExit(f"unknown --filter {args.filter!r} "
                         f"(sigmoid | inv_sig | none)")
    try:
        chroma = _CHROMA[args.chroma.lower()]
    except KeyError:
        raise SystemExit(f"unknown --chroma {args.chroma!r} (r | g | b | '')")
    return DiPsProperties(
        method=DiPsMethod[args.method.upper()],
        output=output,
        filter=filt,
        chroma=chroma,
        window_size=args.win_size,
        temporal_size=args.temporal,
        sensitivity=args.sensitivity,
        sigmoid_horizontal_scalar=args.sig_scalar,
        refresh_markers=tuple(args.markers),
        change_threshold=args.threshold,
        approx_median=args.approx_median,
        quirk_compat=getattr(args, "quirk_compat", False),
        roi=_parse_roi(args.roi),
        emit_maps=not getattr(args, "no_maps", False),
    )


def _parse_roi(spec: Optional[str]):
    if not spec:
        return None
    try:
        parts = tuple(int(v) for v in spec.split(","))
    except ValueError:
        parts = ()
    if len(parts) != 4:
        # ValueError: the props_from_args caller turns it into rc 2
        raise ValueError(f"--roi wants Y0,X0,Y1,X1 integers, got {spec!r}")
    return parts


def _parse_encoding(name: str) -> Optional[Encoding]:
    up = name.upper()
    if up in Encoding.__members__:
        return Encoding[up]
    try:
        return Encoding(name)
    except ValueError:
        print(f"unknown --encoding {name!r} "
              f"(RGBA | HFYU | H264 | MJPG | mp4v)", file=sys.stderr)
        return None


def _detector_cfg(args) -> dict:
    """The --event-* flags as MotionDetector kwargs (shared by
    --events-json, --record-events, and the --inputs events path)."""
    return dict(on_threshold=args.event_on, off_threshold=args.event_off,
                metric=args.event_metric,
                min_frames=args.event_min_frames,
                cooldown=args.event_cooldown)


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    from .utils.compilecache import apply_compile_cache_flag
    apply_compile_cache_flag(args)

    if args.event_on == "auto" and args.event_off is not None:
        # the detector would reject this too, but only once a run is
        # already under way in some modes — fail at the flag level
        print("--event-off is computed in auto mode (estimated floor + "
              "margin/2) — drop it or use a fixed --event-on",
              file=sys.stderr)
        return 2

    stats_only = args.output_mode == "stats_only" or args.no_maps
    if stats_only:
        why = ("--output-mode stats_only" if args.output_mode == "stats_only"
               else "--no-maps")
        if args.output or args.output_dir:
            print(f"{why} writes no diff video — drop "
                  "--output/--output-dir (stats/events/heatmap artifacts "
                  "are the products)", file=sys.stderr)
            return 2
        for flag, val in (("--record-events", args.record_events),
                          ("--denoise", args.denoise),
                          ("--packed-wire", args.packed_wire),
                          ("--live", args.live),
                          ("--dat-dir", args.dat_dir),
                          ("--thumbnail", args.thumbnail),
                          ("--subsample", args.subsample is not None),
                          ("--retime-vfr", args.retime_vfr)):
            if val:
                print(f"{flag} needs diff maps; {why} suppresses them",
                      file=sys.stderr)
                return 2

    if (args.flicker_png or args.flicker_tau is not None) \
            and args.flicker_hz is None:
        print("--flicker-png/--flicker-tau need --flicker-hz",
              file=sys.stderr)
        return 2
    if args.downscale < 1:
        print(f"--downscale must be >= 1, got {args.downscale}",
              file=sys.stderr)
        return 2
    if args.downscale > 1 and (args.dat_dir or args.live or args.thumbnail
                               or args.subsample is not None):
        # decimation is an engine feature of the run modes; thumbnail/
        # subsample are host transcodes and the preview is 1:1
        print("--downscale needs the --input/--output or --inputs modes",
              file=sys.stderr)
        return 2
    auto_refresh = None
    if args.auto_refresh:
        from .ops.refresh import parse_auto_refresh_arg
        try:
            auto_refresh = parse_auto_refresh_arg(args.auto_refresh)
        except ValueError:
            print(f"bad --auto-refresh {args.auto_refresh!r} "
                  "(want FRAC[:PERSIST[:COOLDOWN]], e.g. 0.6:3:64)",
                  file=sys.stderr)
            return 2
    if args.auto_refresh and (args.dat_dir or args.thumbnail
                              or args.subsample is not None):
        # dat/subsample/thumbnail have no streaming baseline (--live DOES:
        # it starts the preview with the policy armed; 'a' toggles it)
        print("--auto-refresh needs the --input/--output, --inputs or "
              "--live modes", file=sys.stderr)
        return 2
    for flag, val in (("--heatmap-png", args.heatmap_png),
                      ("--record-events", args.record_events),
                      ("--flicker-hz", args.flicker_hz is not None)):
        # --flicker-hz also runs in --inputs mode (one FleetFlickerAnalyzer
        # over all streams, ops/analysis.py); the other flags stay
        # single-stream
        inputs_ok = flag == "--flicker-hz" and args.inputs
        if val and not inputs_ok and (
                args.inputs or args.dat_dir or args.live
                or args.thumbnail or args.subsample is not None):
            # every one of those modes either has no single engine/stream
            # or exits before the artifact tail — rejecting beats
            # silently writing nothing
            print(f"{flag} needs the --input/--output or --inputs modes",
                  file=sys.stderr)
            return 2
    for flag, val in (("--stats-json", args.stats_json),
                      ("--events-json", args.events_json),
                      ("--dft-json", args.dft_json)):
        # same principle for the JSON artifacts: --live/--thumbnail/
        # --subsample return before the artifact tail (--inputs and
        # --dat-dir DO honor stats/events; --inputs skips the DFT)
        live_only = args.live and not args.dat_dir
        if val and (live_only or args.thumbnail
                    or args.subsample is not None
                    or (args.inputs and flag == "--dft-json")):
            print(f"{flag} is not written in this mode — use the "
                  f"--input/--output (or --dat-dir) run modes",
                  file=sys.stderr)
            return 2

    flicker = None  # --flicker-hz analyzer (run mode populates it)

    if args.thumbnail:
        if not args.input:
            print("--thumbnail requires --input", file=sys.stderr)
            return 2
        from .io.thumbnail import extract_thumbnail
        extract_thumbnail(args.input, args.thumbnail)
        print(f"thumbnail written: {args.thumbnail}")
        return 0

    if args.subsample is not None:
        if args.subsample < 1:
            print(f"--subsample must be >= 1, got {args.subsample}",
                  file=sys.stderr)
            return 2
        if not (args.input and args.output):
            print("--subsample requires --input and --output", file=sys.stderr)
            return 2
        from .io.subsample import subsample_video
        n = subsample_video(args.input, args.output, args.subsample)
        print(f"wrote {n} frames to {args.output}")
        return 0

    from .errors import DiPsError

    try:
        props = props_from_args(args)
    except ValueError as e:  # e.g. an inverted --roi rectangle
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.inputs:
        if not args.output_dir and not stats_only:
            print("--inputs requires --output-dir (or --output-mode "
                  "stats_only for a no-video fleet run)", file=sys.stderr)
            return 2
        from .app import run_dips_on_files
        from .errors import DiPsError
        enc = _parse_encoding(args.encoding)
        if enc is None:
            return 2
        mesh = None
        if args.mesh:
            from .parallel.grid2d import grid_mesh
            try:
                s_ax, r_ax = (int(v) for v in args.mesh.lower().split("x"))
            except ValueError:
                print(f"bad --mesh {args.mesh!r} (want SxR, e.g. 2x4)",
                      file=sys.stderr)
                return 2
            try:
                mesh = grid_mesh(s_ax, r_ax)
            except ValueError as e:  # e.g. more devices than the host has
                print(f"error: {e}", file=sys.stderr)
                return 1
        ev_cfg = _detector_cfg(args) if args.events_json else None
        want_stats = bool(args.stats_json)
        flicker_cfg = (dict(freq_hz=args.flicker_hz,
                            tau_frames=args.flicker_tau)
                       if args.flicker_hz is not None else None)
        try:
            result = run_dips_on_files(args.inputs, args.output_dir or ".",
                                       enc, props,
                                       batch=args.batch,
                                       mesh=mesh,
                                       input_layout=args.input_layout,
                                       video_backend=args.video_backend,
                                       events=ev_cfg,
                                       collect_stats=want_stats,
                                       downscale=args.downscale,
                                       auto_refresh=auto_refresh,
                                       flicker=flicker_cfg)
        except (DiPsError, NotImplementedError, ValueError) as e:
            # ValueError: engine/mesh configuration (row slab < halo,
            # rows not dividing the height, ...) — a user error, not a
            # crash
            print(f"error: {e}", file=sys.stderr)
            return 1
        # run_dips_on_files appends optional elements in a fixed order:
        # counts, [events,] [stats,] [refreshes]
        res = list(result) if isinstance(result, tuple) else [result]
        counts = res.pop(0)
        per_stream = res.pop(0) if ev_cfg is not None else None
        per_stats = res.pop(0) if want_stats else None
        per_refresh = res.pop(0) if auto_refresh is not None else None
        per_flicker = res.pop(0) if flicker_cfg is not None else None
        # duplicate input paths must not collapse to one JSON key
        # (mirrors the output-basename disambiguation): suffix dups
        # with their stream index
        dup = {p for p in args.inputs if args.inputs.count(p) > 1}
        keys = [f"{p}#{si}" if p in dup else p
                for si, p in enumerate(args.inputs)]
        if per_stream is not None:
            with open(args.events_json, "w") as f:
                json.dump({k: [e.to_dict() for e in evs]
                           for k, evs in zip(keys, per_stream)}, f)
            n_ev = sum(len(evs) for evs in per_stream)
            print(f"{n_ev} motion event(s) across {len(per_stream)} "
                  f"streams written: {args.events_json}")
        if per_stats is not None:
            from .ops.oracle import STAT_NAMES
            with open(args.stats_json, "w") as f:
                json.dump({k: [dict(zip(STAT_NAMES, map(float, row)))
                               for row in rows]
                           for k, rows in zip(keys, per_stats)}, f)
            print(f"per-stream stats written: {args.stats_json}")
        if per_refresh is not None:
            hot = {k: idxs for k, idxs in zip(keys, per_refresh) if idxs}
            if hot:
                for k, idxs in hot.items():
                    print(f"auto-refresh fired on {k} at frame(s): "
                          + ", ".join(map(str, idxs)))
            else:
                print("auto-refresh: no scene change detected")
        if per_flicker is not None:
            import numpy as np
            for k, amp in zip(keys, per_flicker):
                py, px = np.unravel_index(int(np.argmax(amp)), amp.shape)
                print(f"flicker @ {args.flicker_hz:g} Hz [{k}]: peak "
                      f"amplitude {float(amp[py, px]):.1f} at x={px} "
                      f"y={py}, mean {float(amp.mean()):.2f}")
            if args.flicker_png:
                from .report import _require_matplotlib
                try:
                    _require_matplotlib()
                except RuntimeError as e:
                    print(f"error: {e}", file=sys.stderr)
                    return 1
                import matplotlib.pyplot as plt
                import os as _os
                root, ext = _os.path.splitext(args.flicker_png)
                for si, amp in enumerate(per_flicker):
                    fig, ax = plt.subplots(
                        figsize=(6, 6 * amp.shape[0] / amp.shape[1]))
                    im = ax.imshow(amp, cmap="Blues")
                    ax.set_axis_off()
                    fig.colorbar(im, ax=ax, shrink=0.8)
                    path = f"{root}.{si}{ext or '.png'}"
                    fig.savefig(path, dpi=110, bbox_inches="tight")
                    plt.close(fig)
                    print(f"flicker map written: {path}")
        failed = [i for i, c in enumerate(counts) if c < 0]
        ok_total = int(sum(c for c in counts if c >= 0))
        print(f"processed {len(counts)} streams ({ok_total} frames) -> "
              + (args.output_dir if not stats_only else "stats only"))
        if failed:
            print(f"WARNING: {len(failed)} stream(s) failed and were "
                  f"isolated (outputs truncated): "
                  f"{', '.join(args.inputs[i] for i in failed)}",
                  file=sys.stderr)
            return 1
        return 0

    job = None  # set by the --input/--output mode; dat mode has no job
    if args.dat_dir:
        if not args.output:
            print("--dat-dir requires --output", file=sys.stderr)
            return 2
        from .app import custom_dips_on_files
        try:
            w, h = (int(v) for v in args.dat_geometry.lower().split("x"))
        except ValueError:
            print(f"bad --dat-geometry {args.dat_geometry!r} "
                  f"(want WIDTHxHEIGHT, e.g. 273x640)", file=sys.stderr)
            return 2
        enc = _parse_encoding(args.encoding)
        if enc is None:
            return 2
        try:
            stats = custom_dips_on_files(
                args.dat_dir, args.output, width=w, height=h,
                properties=props, encoding=enc, batch=args.batch,
                show=args.live)  # --live + --dat-dir previews the batch
        except (DiPsError, ValueError) as e:
            # missing dir, bad dumps, or an roi outside the dat geometry:
            # user errors, not tracebacks (same contract as the run mode)
            print(f"error: {e}", file=sys.stderr)
            return 1
        frame_geometry = (h, w)
    elif args.live:
        from .live import run_live
        # the preview loop is strictly frame-at-a-time: a batch-N engine
        # would compute N-1 replicated padding frames per preview frame.
        # --input previews a file or network camera (rtsp://...) instead
        # of the local webcam.
        reader = None
        if args.input:
            from .io.gstreamer import open_video
            try:
                reader = open_video(args.input, args.video_backend)
            except DiPsError as e:
                print(f"error: {e}", file=sys.stderr)
                return 1
        return run_live(props, reader=reader,
                        auto_refresh=auto_refresh)
    else:
        if not args.input or (not args.output and not stats_only):
            print("need --input and --output (see --help; --output-mode "
                  "stats_only runs without --output)", file=sys.stderr)
            return 2
        from .app import DiPsJob, perform_dips
        enc = _parse_encoding(args.encoding)
        if enc is None:
            return 2
        record = None
        if args.record_events:
            record = dict(dir=args.record_events, pre_roll=args.pre_roll,
                          post_roll=args.post_roll,
                          detector=_detector_cfg(args))
        flicker_cb = None
        probed_reader = None
        if args.flicker_hz is not None:
            # the analyzer needs the input's frame rate up front (Nyquist
            # validation + demodulation angle).  The probed reader is
            # HANDED TO the job rather than closed: network sources
            # (rtsp/srt) may reject or stall a second overlapping connect
            # (DiPsJob.reader's contract; multi-worker decode closes it
            # after its own geometry probe and opens per-chunk readers).
            from .io.gstreamer import open_video
            from .ops.analysis import FlickerAnalyzer
            try:
                probed_reader = open_video(args.input, args.video_backend)
                flicker = FlickerAnalyzer(args.flicker_hz,
                                          probed_reader.fps,
                                          tau_frames=args.flicker_tau,
                                          chroma=props.chroma,
                                          batch=args.batch)
            except (DiPsError, ValueError) as e:
                if probed_reader is not None:
                    probed_reader.close()
                print(f"error: {e}", file=sys.stderr)
                return 1

            def flicker_cb(idx, inp, out, stat, _fl=flicker):
                _fl.update(inp)
                return None  # observe-only: the diff map passes through
        job = DiPsJob(properties=props, video_path=args.input,
                      reader=probed_reader,
                      frame_callback=flicker_cb,
                      output_path=args.output, encoding=enc,
                      batch=args.batch,
                      video_backend=args.video_backend,
                      retime_vfr=args.retime_vfr,
                      decode_workers=args.decode_workers,
                      pipeline_depth=args.pipeline_depth,
                      packed_wire=args.packed_wire,
                      input_layout=args.input_layout,
                      downscale=args.downscale,
                      profile=args.profile, denoise_radius=args.denoise,
                      record_events=record, auto_refresh=auto_refresh)
        from .utils.profiling import trace
        try:
            with trace(args.trace_dir):
                stats = perform_dips(job)
        except (DiPsError, ValueError) as e:
            # missing input, decode/encode failures and configuration
            # errors (e.g. a bad --event-* combination) are user errors,
            # not tracebacks — same contract as the --inputs/--live modes
            print(f"error: {e}", file=sys.stderr)
            return 1
        frame_geometry = job.frame_geometry
        if args.profile and job.timers:
            print(job.timers)
        if auto_refresh is not None and job.baseline_refreshes is not None:
            if job.baseline_refreshes:
                print("auto-refresh fired at frame(s): "
                      + ", ".join(map(str, job.baseline_refreshes)))
            else:
                print("auto-refresh: no scene change detected")
        if args.record_events and job.event_segments is not None:
            import os
            with open(os.path.join(args.record_events,
                                   "segments.json"), "w") as f:
                json.dump(job.event_segments, f)
            print(f"{len(job.event_segments)} event segment(s) "
                  f"recorded -> {args.record_events}")

    print(f"processed {stats.shape[0]} frames -> "
          + (args.output if args.output else "stats only"))
    if args.stats_json:
        from .ops.oracle import STAT_NAMES
        rows = [dict(zip(STAT_NAMES, map(float, row))) for row in stats]
        with open(args.stats_json, "w") as f:
            json.dump(rows, f)
        print(f"stats written: {args.stats_json}")
    if args.heatmap_png:
        eng = getattr(job, "engine", None)
        if eng is None:
            print("--heatmap-png needs the --input/--output mode",
                  file=sys.stderr)
            return 2
        from .report import _require_matplotlib
        try:
            _require_matplotlib()
        except RuntimeError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        import matplotlib.pyplot as plt
        hm = eng.heatmap()
        fig, ax = plt.subplots(figsize=(6, 6 * hm.shape[0] / hm.shape[1]))
        # sequential = one hue, light->dark (magnitude)
        im = ax.imshow(hm, cmap="Blues")
        ax.set_axis_off()
        fig.colorbar(im, ax=ax, shrink=0.8)
        fig.savefig(args.heatmap_png, dpi=110, bbox_inches="tight")
        plt.close(fig)
        print(f"heatmap written: {args.heatmap_png}")
    if flicker is not None:
        import numpy as np
        flicker.flush()
        if flicker.frames_seen == 0:
            print("flicker: no frames streamed", file=sys.stderr)
        else:
            amp = flicker.amplitude()
            py, px = np.unravel_index(int(np.argmax(amp)), amp.shape)
            print(f"flicker @ {args.flicker_hz:g} Hz over "
                  f"{flicker.frames_seen} frames: peak amplitude "
                  f"{float(amp[py, px]):.1f} (intensity units, 0-510) at "
                  f"x={px} y={py}, mean {float(amp.mean()):.2f}")
            if args.flicker_png:
                from .report import _require_matplotlib
                try:
                    _require_matplotlib()
                except RuntimeError as e:
                    print(f"error: {e}", file=sys.stderr)
                    return 1
                import matplotlib.pyplot as plt
                fig, ax = plt.subplots(
                    figsize=(6, 6 * amp.shape[0] / amp.shape[1]))
                im = ax.imshow(amp, cmap="Blues")  # sequential, one hue
                ax.set_axis_off()
                fig.colorbar(im, ax=ax, shrink=0.8)
                fig.savefig(args.flicker_png, dpi=110, bbox_inches="tight")
                plt.close(fig)
                print(f"flicker map written: {args.flicker_png}")
    if args.events_json:
        from .ops.events import detect_events
        events = detect_events(
            [stats], **_detector_cfg(args),
            pixels=(props.analysis_pixels(*frame_geometry)
                    if args.event_metric == "changed_frac" and
                    frame_geometry else None))
        with open(args.events_json, "w") as f:
            json.dump([e.to_dict() for e in events], f)
        print(f"{len(events)} motion event(s) written: {args.events_json}")
    if args.dft_json:
        import numpy as np
        from .ops.analysis import temporal_dft
        mag, phase = temporal_dft(stats[:, 1])  # mean |diff| series
        with open(args.dft_json, "w") as f:
            json.dump({"magnitude": np.asarray(mag).tolist(),
                       "phase": np.asarray(phase).tolist()}, f)
        print(f"temporal DFT written: {args.dft_json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
