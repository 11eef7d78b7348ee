"""Multi-stream demo: 8 videos sharded over the device mesh.

Run with virtual devices:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  python examples/multi_stream.py --cpu
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (virtual mesh)")
    ap.add_argument("--streams", type=int, default=8)
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    from dips.io import moving_square_clip
    from dips.parallel import MultiStreamEngine, stream_mesh
    from dips.properties import DiPsProperties

    mesh = stream_mesh()
    n_dev = mesh.devices.size
    s = max(args.streams // n_dev, 1) * n_dev
    print(f"mesh: {n_dev} devices, {s} streams")

    clips = [moving_square_clip(n=12, height=96, width=128, seed=i)
             for i in range(s)]
    props = DiPsProperties(window_size=3, temporal_size=2)
    eng = MultiStreamEngine(props, 96, 128, n_streams=s, batch=4, mesh=mesh)
    for i in range(0, 12, 4):
        out, stats, gmean = eng.process_batch(
            [list(c[i:i + 4]) for c in clips])
        print(f"frames {i}..{i+3}: out {out.shape}, "
              f"global mean |diff| (psum) = {gmean:.5f}")


if __name__ == "__main__":
    main()
