"""Fleet-telemetry demo: map-suppressed analytics at fleet scale.

The events-fleet deployment shape: many cameras, NO diff-map egress —
each stream's decode feeds the device once and only statistics come back
(~128 B/frame).  Two flavours run side by side over the same synthetic
fleet:

* ``OutputMode.STATS_ONLY`` — the raw integer absdiff signal (fastest);
* ``emit_maps=False`` on the FULL median pipeline — the noise-robust
  signal (spatial+temporal medians suppress sensor noise before the
  diff), still with zero map egress.

Each stream also gets a motion-event segmentation and a per-stream
FLICKER map — every stream's vibration analysis runs in ONE stacked
device dispatch per round (FleetFlickerAnalyzer), not one dispatch per
camera.  One camera carries a vibrating corner; the fleet flicker map
localizes it.

Run on CPU:
  python examples/fleet_telemetry.py --cpu
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import tempfile

import numpy as np


def make_fleet_clips(tmp, n_streams=3, n=48, h=48, w=64, fps=24.0):
    """One video per 'camera': static noise; camera 0 gets a visitor
    mid-stream, camera 1 a 4 Hz vibrating corner patch."""
    import cv2
    paths = []
    for s in range(n_streams):
        r = np.random.default_rng(s)
        base = r.integers(40, 200, (h, w, 3), np.int32)
        path = os.path.join(tmp, f"cam{s}.avi")
        wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), fps,
                             (w, h))
        for i in range(n):
            f = base.copy()
            if s == 0 and 16 <= i < 32:  # visitor crosses camera 0
                x = 4 + 2 * (i - 16)
                f[10:34, x:x + 8] = (230, 230, 230)
            if s == 1:  # camera 1 vibrates at 4 Hz in one corner
                osc = 45 * np.cos(2 * np.pi * 4.0 * i / fps)
                f[4:12, 4:12] += int(round(osc))
            wr.write(np.clip(f, 0, 255).astype(np.uint8)[:, :, ::-1])
        wr.release()
        paths.append(path)
    return paths, fps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    from dips.app import run_dips_on_files
    from dips.properties import DiPsProperties, OutputMode

    with tempfile.TemporaryDirectory() as tmp:
        paths, fps = make_fleet_clips(tmp)

        # -- flavour 1: raw stats-only (the fastest fleet signal) --------
        so = DiPsProperties(output=OutputMode.STATS_ONLY, temporal_size=2)
        counts, events, flicker = run_dips_on_files(
            paths, tmp, properties=so, batch=8,
            events=dict(on_threshold=0.02, metric="changed_frac"),
            flicker=dict(freq_hz=4.0))
        print("stats-only fleet:")
        for s, (c, evs) in enumerate(zip(counts, events)):
            print(f"  cam{s}: {c} frames, {len(evs)} motion event(s)"
                  + "".join(f" [{e.start_frame}..{e.end_frame}]"
                            for e in evs))
        assert len(events[0]) >= 1, "camera 0's visitor must segment"
        assert not events[2], "camera 2 is still"

        # the fleet flicker map localizes camera 1's vibrating corner
        peaks = [np.unravel_index(int(np.argmax(m)), m.shape)
                 for m in flicker]
        amps = [float(m.max()) for m in flicker]
        print(f"  4 Hz flicker peaks: "
              + ", ".join(f"cam{s}@{p} amp {a:.0f}"
                          for s, (p, a) in enumerate(zip(peaks, amps))))
        # cam0's broadband visitor transient leaks a little into the 4 Hz
        # bin over this short window; the steady vibration still dominates
        assert amps[1] > 2 * max(amps[0], amps[2]), \
            "camera 1's vibration must dominate the fleet flicker maps"
        assert peaks[1][0] < 12 and peaks[1][1] < 12, peaks[1]

        # -- flavour 2: MEDIAN pipeline, emit_maps=False ------------------
        # same zero map egress, but the event signal rides the
        # median-filtered (noise-suppressed) diff — the robust choice for
        # noisy/compressed feeds
        med = DiPsProperties(window_size=3, temporal_size=4,
                             emit_maps=False)
        counts2, events2, stats2 = run_dips_on_files(
            paths, tmp, properties=med, batch=8,
            events=dict(on_threshold=0.02, metric="changed_frac"),
            collect_stats=True)
        print("median no-maps fleet:")
        for s, (c, evs) in enumerate(zip(counts2, events2)):
            mean_abs = float(stats2[s][:, 1].mean())
            print(f"  cam{s}: {c} frames, {len(evs)} event(s), "
                  f"mean |diff| {mean_abs:.4f}")
        assert len(events2[0]) >= 1 and not events2[2]
        print("OK: fleet telemetry (stats-only + median no-maps + "
              "fleet flicker) end to end")


if __name__ == "__main__":
    main()
