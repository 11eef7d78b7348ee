"""Serving demo: the TCP daemon with batched requests, checkpointing and
concurrent sessions.

Run on CPU:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  python examples/serving.py --cpu
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import tempfile
import threading

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    from dips import DiPsProperties
    from dips.serve import DiPsClient, DiPsServer

    h, w = 96, 128
    server = DiPsServer(DiPsProperties(window_size=3, temporal_size=2),
                        h, w, port=0, batch=8, max_sessions=2)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    print(f"serving on port {server.port} (2 sessions)")

    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (h, w, 3), np.uint8)
    frames = np.stack([base] * 12)
    for i in range(12):
        y, x = 4 + 3 * i, 8 + 5 * i
        frames[i, y:y + 12, x:x + 12] = (250, 40, 40)

    cli = DiPsClient(server.port)
    print("hello:", cli.hello()["config"])

    # one batched request per device batch (amortises the round trip)
    maps, stats = cli.process_many(frames[:8])
    print(f"batched: {maps.shape} maps, mean|diff| per frame "
          f"{np.round(stats[:, 1], 4)}")

    # checkpoint, diverge, rewind
    ckpt = tempfile.mktemp(suffix=".npz")
    cli.save(ckpt)
    cli.process_many(frames[8:])          # advance past the checkpoint
    resumed = cli.load(ckpt)              # rewind
    print(f"rewound to frame {resumed}")
    maps2, _ = cli.process_many(frames[8:])
    print(f"replayed {maps2.shape[0]} frames after resume")

    # a second concurrent session has fully independent state
    cli2 = DiPsClient(server.port)
    assert cli2.hello()["frame_index"] == 0
    print("second session starts fresh: frame_index 0")
    cli2.close()
    cli.close()
    server.shutdown()

    # low-bandwidth mask transport: THRESHOLD + --packed-wire + packed=True
    # requests move 8x fewer bytes device->host AND server->client
    from dips import OutputMode
    srv2 = DiPsServer(DiPsProperties(output=OutputMode.THRESHOLD,
                                     temporal_size=2),
                      h, w, port=0, batch=8, packed_wire=True)
    threading.Thread(target=srv2.serve_forever, daemon=True).start()
    cli3 = DiPsClient(srv2.port)
    masks, _ = cli3.process_many(frames[:8], packed=True)
    print(f"packed transport: {masks.shape} masks "
          f"({int((masks > 0).sum())} changed px), 1/8 the wire bytes")
    cli3.close()
    srv2.shutdown()

    # many-camera shape: --coalesce folds concurrent sessions' requests
    # into ONE stacked-stream device dispatch (per-slot state stays
    # private); input_layout="hwc" planarizes the wire frames ON DEVICE
    # instead of on the serving host
    srv3 = DiPsServer(DiPsProperties(window_size=3, temporal_size=2),
                      h, w, port=0, batch=1, coalesce=3,
                      input_layout="hwc")
    threading.Thread(target=srv3.serve_forever, daemon=True).start()
    cams = [rng.integers(0, 256, (4, h, w, 3), np.uint8) for _ in range(3)]
    results = [None] * 3

    def camera(i):
        c = DiPsClient(srv3.port, session=f"cam-{i}")
        results[i] = [c.process(f)[1][1] for f in cams[i]]
        if i == 0:  # each session can checkpoint ITS slot independently
            c.save(ckpt)
        c.close()

    threads = [threading.Thread(target=camera, args=(i,)) for i in range(3)]
    [t.start() for t in threads]
    [t.join() for t in threads]
    print("coalesced sessions mean|diff| streams:",
          [np.round(r, 4).tolist()[:2] for r in results])
    with DiPsClient(srv3.port) as mon:
        m = mon.metrics()
        print(f"metrics: {m['frames']} frames in "
              f"{m['coalesce_dispatches']} dispatches "
              f"(mean fill {m['coalesce_mean_fill']}), request p50 "
              f"{m['latency_ms']['p50']} ms")
    srv3.shutdown()
    print("done")


if __name__ == "__main__":
    main()
