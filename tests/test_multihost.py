"""Multi-host stream processing: a REAL 2-process jax.distributed CPU
cluster (4 virtual devices per process -> one 8-device global mesh) must
produce bit-identical outputs to a single-process 8-device run.

This validates the pod deployment path (parallel/multihost.py): global
mesh construction across processes, per-process stream feeding, the
cross-host psum for global stats, the zero-frame-round lockstep hazard
(one host's cameras all stall while the other streams on), and per-host
checkpoint/restore — SURVEY.md §5 'Distributed comm' beyond-parity
scale-out.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from dips.properties import DiPsProperties, DiPsFilter

from tests._mh_worker import (BATCH, FRAMES_PER_RANK, H, ROUNDS, S_GLOBAL,
                              W, make_clip)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = os.path.join(_REPO, "tests", "_mh_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_of(si: int) -> int:
    return 0 if si < S_GLOBAL // 2 else 1


def _expected(raw=False):
    """Single-process reference: all 8 streams on the test process's
    8-device mesh, same clips, same per-round feeds (streams of a rank
    with a zero round pass empty lists, exactly like the cluster).
    ``raw``: the ABSDIFF events-fleet shape (u8 carried global state)."""
    from dips.parallel import MultiStreamEngine
    if raw:
        from dips.properties import OutputMode
        props = DiPsProperties(output=OutputMode.ABSDIFF, temporal_size=2)
    else:
        props = DiPsProperties(window_size=3, temporal_size=2,
                               filter=DiPsFilter.UNFILTERED)
    eng = MultiStreamEngine(props, H, W, n_streams=S_GLOBAL, batch=BATCH)
    clips = [make_clip(n=FRAMES_PER_RANK[_rank_of(si)], h=H, w=W,
                       seed=100 + si) for si in range(S_GLOBAL)]
    cursors = [0] * S_GLOBAL
    outs, stats_all, gmeans = [], [], []
    for plan in ROUNDS:
        feed = []
        for si in range(S_GLOBAL):
            k = plan[_rank_of(si)]
            feed.append(list(clips[si][cursors[si]:cursors[si] + k]))
            cursors[si] += k
        out, stats, gmean = eng.process_batch(feed)
        outs.append(out)
        stats_all.append(stats)
        gmeans.append(gmean)
    return outs, stats_all, np.asarray(gmeans)


def _run_cluster(tmp_path, extra=()):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=_REPO)
    env.pop("JAX_PLATFORMS", None)  # workers force CPU themselves
    procs = [subprocess.Popen(
        [sys.executable, _WORKER, str(r), "2", str(port), str(tmp_path),
         *extra],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    logs = []
    for r, p in enumerate(procs):
        out, _ = p.communicate(timeout=300)
        logs.append(out.decode(errors="replace"))
        assert p.returncode == 0, (
            f"worker {r} failed:\n{logs[r]}\n--- other ---\n"
            + (logs[0] if r else ""))
    return logs


@pytest.mark.parametrize("extra", [(), ("--checkpoint",), ("--raw",),
                                   ("--raw", "--checkpoint")],
                         ids=["fresh", "checkpoint-roundtrip",
                              "raw-fleet", "raw-fleet-checkpoint"])
def test_two_process_cluster_matches_single_process(tmp_path, extra):
    exp_outs, exp_stats, exp_gmeans = _expected(raw="--raw" in extra)

    _run_cluster(tmp_path, extra)

    seen = np.zeros(S_GLOBAL, bool)
    for r in range(2):
        z = np.load(tmp_path / f"rank{r}.npz")
        ids = z["local_stream_ids"]
        assert len(ids) == S_GLOBAL // 2  # each process owns half
        for rnd, plan in enumerate(ROUNDS):
            n_rnd = plan[r]
            out, stats = z[f"out{rnd}"], z[f"stats{rnd}"]
            assert out.shape[1] == n_rnd  # incl. the rank-0 empty round
            for k, si in enumerate(ids):
                np.testing.assert_array_equal(out[k],
                                              exp_outs[rnd][si, :n_rnd])
                np.testing.assert_allclose(stats[k],
                                           exp_stats[rnd][si, :n_rnd],
                                           atol=1e-4, rtol=1e-5)
        seen[ids] = True
        assert (z["frame_cursors"] == FRAMES_PER_RANK[r]).all()
        # the global mean rides a cross-PROCESS psum: both ranks must
        # agree with the single-process value EVERY round — including the
        # round where rank 0 participates all-invalid
        np.testing.assert_allclose(z["gmeans"], exp_gmeans,
                                   atol=1e-4, rtol=1e-5)
    assert seen.all()  # the union of the two hosts covers every stream


def test_init_multihost_single_process_fallback_and_idempotency():
    """No cluster to detect -> trivial topology, no backend poisoning;
    a second call returns the same topology instead of raising."""
    code = (
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "from dips.parallel import init_multihost\n"
        "a = init_multihost()\n"
        "b = init_multihost()\n"
        "assert a == b and a.process_count == 1, (a, b)\n"
        "assert a.is_coordinator\n"
        "print('FALLBACK-OK')\n"
    )
    env = dict(os.environ, PYTHONPATH=_REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "FALLBACK-OK" in out.stdout
