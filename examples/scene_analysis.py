"""Scene analysis demo: analysis region (roi) + per-pixel flicker map.

A synthetic "instrument bay" camera: a gauge region blinks at a known
frequency while an irrelevant corridor region sees constant motion.
The run (a) scopes motion statistics/events to the gauge via
``props.roi`` so the corridor cannot trigger alerts, and (b) streams a
:class:`~dips.ops.analysis.FlickerAnalyzer` to localize which
pixels oscillate at the gauge's frequency.

Run: python examples/scene_analysis.py [--cpu]
Produces scene_in.avi, scene_out.avi and prints the analysis summary.
"""

import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import numpy as np


def build_clip(n=96, h=96, w=128, fps=24.0, gauge_hz=6.0, seed=3):
    """Gauge region (rows 10-40, cols 10-60) blinks at gauge_hz; the
    'corridor' (rows 60-90, cols 70-120) has a roaming bright square."""
    r = np.random.default_rng(seed)
    base = r.integers(80, 120, (h, w, 3)).astype(np.float32)
    frames = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        f = base.copy()
        f[10:40, 10:60] += 70.0 * math.cos(2 * math.pi * gauge_hz * i / fps)
        y, x = 60 + (i * 3) % 25, 70 + (i * 5) % 45
        f[y:y + 6, x:x + 6] = 240.0  # corridor traffic (outside the roi)
        frames[i] = np.clip(np.rint(f), 0, 255).astype(np.uint8)
    return frames


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    from dips import DiPsJob, DiPsProperties, perform_dips
    from dips.io import write_clip
    from dips.ops.analysis import FlickerAnalyzer
    from dips.ops.events import detect_events

    fps, gauge_hz = 24.0, 6.0
    frames = build_clip(fps=fps, gauge_hz=gauge_hz)
    write_clip(frames, "scene_in.avi", fps=fps)

    # roi scopes stats/events to the gauge; the corridor's traffic is
    # visible in the OUTPUT maps but never in the statistics
    roi = (10, 10, 40, 60)
    props = DiPsProperties(window_size=3, temporal_size=2, roi=roi)
    flicker = FlickerAnalyzer(gauge_hz, fps, chroma=props.chroma, batch=8)
    job = DiPsJob(properties=props, video_path="scene_in.avi",
                  output_path="scene_out.avi",
                  frame_callback=lambda i, inp, out, st:
                      flicker.update(inp))
    stats = perform_dips(job)

    area = props.analysis_pixels(*job.frame_geometry)
    events = detect_events([stats], on_threshold=0.05,
                           metric="changed_frac", pixels=area)
    print(f"{stats.shape[0]} frames; roi {roi} = {area} px")
    print(f"{len(events)} motion event(s) inside the roi "
          f"(the corridor square is outside and cannot alert)")

    amp = flicker.amplitude()
    py, px = np.unravel_index(int(np.argmax(amp)), amp.shape)
    in_gauge = 10 <= py < 40 and 10 <= px < 60
    print(f"flicker @ {gauge_hz:g} Hz: peak {amp[py, px]:.1f} at "
          f"x={px} y={py} ({'inside' if in_gauge else 'OUTSIDE'} the "
          f"gauge region); background mean {np.median(amp):.2f}")


if __name__ == "__main__":
    main()
