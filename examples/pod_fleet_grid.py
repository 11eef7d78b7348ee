"""Fleet demo: raw no-map fleet on the 2-D (stream x rows) grid.

A handful of HUGE cameras where stream count alone can't use every
device.  Each device owns a horizontal slab of a subset of streams; raw
modes (absdiff / threshold / stats-only) have no stencil, so the slabs
need no halo exchange at all — the only cross-device traffic is the
statistic reductions.

Two flavours over the same synthetic fleet:

* ``STATS_ONLY`` — the no-map events fleet (~128 B of D2H per frame per
  stream);
* ``THRESHOLD`` with ``packed_wire`` — bit-packed motion masks on the
  same 2-D grid (8x less D2H when maps ARE wanted).

Run on CPU:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  python examples/pod_fleet_grid.py --cpu
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import numpy as np


def synth_clip(n, h, w, seed):
    r = np.random.default_rng(seed)
    base = r.integers(0, 200, (h, w, 3), np.uint8)
    frames = []
    for i in range(n):
        f = base.copy()
        y, x = (3 * i) % (h - 8), (5 * i) % (w - 8)
        f[y:y + 8, x:x + 8] = 255  # moving block = motion signal
        frames.append(f)
    return frames


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (virtual 8-device mesh)")
    ap.add_argument("--frames", type=int, default=8)
    args = ap.parse_args()
    if args.cpu:
        os.environ.setdefault(
            "XLA_FLAGS", "--xla_force_host_platform_device_count=8")
        import jax
        jax.config.update("jax_platforms", "cpu")

    from dips.parallel import MultiStreamEngine
    from dips.parallel.grid2d import grid_mesh
    from dips.properties import DiPsProperties, OutputMode

    h, w, batch = 32, 96, 4
    mesh = grid_mesh(2, 4)  # 2 stream shards x 4 row slabs = 8 devices
    print(f"mesh: 2 streams x 4 row slabs over {mesh.devices.size} devices")
    clips = [synth_clip(args.frames, h, w, seed=k) for k in range(2)]

    # 1. the events fleet: stats only, zero map egress, carried state
    props = DiPsProperties(output=OutputMode.STATS_ONLY, temporal_size=2,
                           change_threshold=20)
    eng = MultiStreamEngine(props, h, w, n_streams=2, batch=batch,
                            mesh=mesh)
    for i in range(0, args.frames, batch):
        out, stats, gmean = eng.process_batch(
            [c[i:i + batch] for c in clips])
        assert out.shape[-1] == 0  # no map bytes at all
        for si in range(2):
            changed = stats[si, :, 3].astype(int)
            print(f"  stats_only stream {si} frames {i}-{i + batch - 1}: "
                  f"changed px {changed.tolist()} (gmean {gmean:.4f})")
    hm = eng.heatmaps()
    print(f"heatmaps: {hm.shape}, hottest pixel/stream "
          f"{[round(float(x), 2) for x in hm.max(axis=(1, 2))]}")

    # 2. the masked fleet: THRESHOLD + packed wire on the same grid
    props = DiPsProperties(output=OutputMode.THRESHOLD, temporal_size=2,
                           change_threshold=20)
    eng = MultiStreamEngine(props, h, w, n_streams=2, batch=batch,
                            mesh=mesh, packed_wire=True)
    out, stats, _ = eng.process_batch([c[:batch] for c in clips])
    on = (out == 255).mean(axis=(2, 3, 4))
    print(f"threshold+packed_wire: masks {out.shape}, "
          f"on-fraction/frame {np.round(on, 3).tolist()}")


if __name__ == "__main__":
    main()
