"""Multi-host demo, self-contained on one machine.

Spawns TWO worker processes that form a real ``jax.distributed`` cluster
(4 virtual CPU devices each -> one 8-device global mesh) and run
``MultiHostStreamEngine`` over 8 camera streams: each "host" decodes and
feeds only its own 4 streams, the global mean|diff| statistic rides one
cross-host psum, and outputs come back host-locally.  On a real cluster
the SAME worker code runs once per host with the coordinator address,
process count and rank passed to ``init_multihost()``.

  python examples/multi_host.py
"""

import os
import socket
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_WORKER = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")

import numpy as np
from dips.parallel import init_multihost, MultiHostStreamEngine
from dips.properties import DiPsProperties, DiPsFilter

rank, nprocs, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
info = init_multihost(f"127.0.0.1:{port}", nprocs, rank)
print(f"[host {info.process_index}] joined: "
      f"{info.global_device_count} global devices "
      f"({info.local_device_count} local)", flush=True)

props = DiPsProperties(window_size=3, temporal_size=2,
                       filter=DiPsFilter.UNFILTERED)
eng = MultiHostStreamEngine(props, 64, 96, n_streams=8, batch=4)
print(f"[host {rank}] owns streams {eng.local_stream_ids}", flush=True)

rng = np.random.default_rng(rank)
for rnd in range(3):
    feed = eng.local_frames_template()
    for si in eng.local_stream_ids:
        frames = rng.integers(0, 255, (4, 64, 96, 3), np.uint8)
        feed[si] = list(frames)
    out, stats, gmean = eng.process_batch(feed)
    print(f"[host {rank}] round {rnd}: out {out.shape}, "
          f"global mean|diff| (cross-host psum) = {gmean:.5f}", flush=True)
'''


def main():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    # the workers run `python -c`, which puts the CWD (not this repo) on
    # sys.path — hand them the repo root explicitly so a non-installed
    # checkout works from any directory
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER,
                               str(r), "2", str(port)], env=env)
             for r in range(2)]
    rc = 0
    try:
        for p in procs:
            rc |= p.wait(timeout=300)
    except subprocess.TimeoutExpired:
        # one worker crashing at startup leaves its peer blocked in
        # jax.distributed.initialize — don't leak it
        rc = 1
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    print("OK" if rc == 0 else f"FAILED rc={rc}")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
