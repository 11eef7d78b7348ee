"""Multi-host test worker: one process of a 2-process CPU jax.distributed
cluster (4 virtual devices each -> 8 global).  Launched by
tests/test_multihost.py; results land in an npz the parent compares
against a single-process 8-device run.

Usage: python tests/_mh_worker.py RANK NPROCS PORT OUTDIR
       [--checkpoint] [--raw]

``--raw`` runs the ABSDIFF events-fleet shape (u8 carried global state)
instead of the median pipeline.
"""

import os
import sys


def make_clip(n=12, h=12, w=140, seed=0, moving=True):
    """Must match tests/conftest.make_clip (workers cannot import conftest
    without pulling in its CPU-forcing fixtures before jax.distributed)."""
    import numpy as np
    r = np.random.default_rng(seed)
    base = r.integers(0, 256, (h, w, 3), np.uint8)
    frames = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        f = base.copy()
        if moving:
            y = (2 + i) % max(h - 4, 1)
            x = (3 + 2 * i) % max(w - 4, 1)
            f[y:y + 4, x:x + 4] = [250, 30, 30]
        frames[i] = f
    return frames


S_GLOBAL, BATCH, H, W = 8, 2, 16, 24
#: frames fed per (round, rank).  Round 1 is the LOCKSTEP-HAZARD round:
#: rank 0 has nothing (all its cameras stalled) while rank 1 streams on —
#: rank 0 must still enter the collective step, masked invalid.
ROUNDS = [{0: 2, 1: 2}, {0: 0, 1: 2}, {0: 2, 1: 2}]
FRAMES_PER_RANK = {r: sum(plan[r] for plan in ROUNDS) for r in (0, 1)}


def main() -> int:
    rank, nprocs, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    outdir = sys.argv[4]
    do_checkpoint = "--checkpoint" in sys.argv
    raw = "--raw" in sys.argv

    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_platforms", "cpu")

    import numpy as np
    from dips.parallel import init_multihost, MultiHostStreamEngine
    from dips.properties import DiPsProperties, DiPsFilter

    info = init_multihost(f"127.0.0.1:{port}", nprocs, rank)
    assert info.process_index == rank
    assert info.global_device_count == 8, info
    # documented idempotency: a second call just reports the live topology
    again = init_multihost(f"127.0.0.1:{port}", nprocs, rank)
    assert again == info

    if raw:
        # the pod events fleet: raw integer diff, u8 carried global state
        from dips.properties import OutputMode
        props = DiPsProperties(output=OutputMode.ABSDIFF, temporal_size=2)
    else:
        props = DiPsProperties(window_size=3, temporal_size=2,
                               filter=DiPsFilter.UNFILTERED)
    eng = MultiHostStreamEngine(props, H, W, S_GLOBAL, batch=BATCH)
    n_mine = FRAMES_PER_RANK[rank]
    clips = {si: make_clip(n=n_mine, h=H, w=W, seed=100 + si)
             for si in eng.local_stream_ids}

    outs, stats_all, gmeans, cursor = {}, {}, [], 0
    for rnd, plan in enumerate(ROUNDS):
        n_rnd = plan[rank]
        feed = eng.local_frames_template()
        for si in eng.local_stream_ids:
            feed[si] = list(clips[si][cursor:cursor + n_rnd])
        out, stats, gmean = eng.process_batch(feed)
        assert out.shape[0] == eng.n_local_streams, out.shape
        outs[rnd], stats_all[rnd] = out, stats
        gmeans.append(gmean)
        cursor += n_rnd
        if do_checkpoint and rnd == 0:
            # per-host checkpoint round-trip mid-stream: a NEW engine on
            # each host restores its own shard, then continues bit-exactly
            path = os.path.join(outdir, f"ckpt_{rank}.npz")
            eng.save(path)
            eng = MultiHostStreamEngine(props, H, W, S_GLOBAL, batch=BATCH)
            eng.load(path)

    np.savez(os.path.join(outdir, f"rank{rank}.npz"),
             local_stream_ids=np.asarray(eng.local_stream_ids),
             gmeans=np.asarray(gmeans),
             frame_cursors=np.asarray(
                 [eng.frame_cursors[i] for i in eng.local_stream_ids]),
             **{f"out{r}": outs[r] for r in outs},
             **{f"stats{r}": stats_all[r] for r in stats_all})
    print(f"WORKER-{rank}-OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
