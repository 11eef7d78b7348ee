"""Serving daemon: real socket round-trips against an in-process server."""

import threading

import numpy as np
import pytest

from dips.properties import DiPsFilter, DiPsProperties
from dips.serve import DiPsClient, DiPsServer
from dips.models import DiPsEngine
from tests.conftest import make_clip


@pytest.fixture()
def server():
    props = DiPsProperties(window_size=3, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 24, 40, port=0, batch=1)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv
    srv.shutdown()


def test_serve_round_trip(server):
    clip = make_clip(n=6, h=24, w=40, seed=2)
    cli = DiPsClient(server.port)
    info = cli.hello()
    assert info["ok"] and info["config"]["height"] == 24

    outs, stats = [], []
    for f in clip:
        o, s = cli.process(f)
        outs.append(o)
        stats.append(s)
    cli.close()

    # must equal a local engine run frame-by-frame
    eng = DiPsEngine(DiPsProperties(window_size=3, temporal_size=2,
                                    filter=DiPsFilter.UNFILTERED),
                     24, 40, batch=1)
    exp_out, exp_stats = eng.process_frames(list(clip))
    np.testing.assert_array_equal(np.stack(outs), exp_out)
    np.testing.assert_allclose(np.stack(stats), exp_stats, atol=1e-6)


def test_serve_snapshot_and_heatmap(server):
    clip = make_clip(n=4, h=24, w=40, seed=3)
    cli = DiPsClient(server.port)
    for f in clip[:3]:
        cli.process(f)
    cli.snapshot()
    _, s = cli.process(clip[3])
    assert s[1] == 0  # forced re-capture -> zero diff
    hm = cli.heatmap()
    assert hm.shape == (24, 40) and hm.max() > 0
    cli.close()


def test_serve_bad_geometry_isolation(server):
    cli = DiPsClient(server.port)
    with pytest.raises(RuntimeError):
        cli.process(np.zeros((3, 3, 3), np.uint8))  # wrong geometry
    # the connection and engine survive the failed request
    o, _ = cli.process(make_clip(n=1, h=24, w=40)[0])
    assert o.shape == (24, 40, 3)
    cli.close()


def test_sequential_clients_share_state(server):
    """A reconnecting client continues the same stream (frame cursor and
    baseline persist across connections)."""
    clip = make_clip(n=4, h=24, w=40, seed=9)
    c1 = DiPsClient(server.port)
    c1.process(clip[0])
    c1.close()
    c2 = DiPsClient(server.port)
    info = c2.hello()
    assert info["frame_index"] == 1  # state survived the reconnect
    c2.process(clip[1])
    c2.close()


def test_serve_checkpoint_roundtrip(server, tmp_path):
    """save/load over the wire: a reloaded server continues bit-identically."""
    clip = make_clip(n=6, h=24, w=40, seed=5)
    path = str(tmp_path / "ckpt.npz")
    cli = DiPsClient(server.port)
    for f in clip[:3]:
        cli.process(f)
    cli.save(path)
    for f in clip[3:]:  # diverge the live state past the checkpoint
        cli.process(f)
    assert cli.load(path) == 3  # rewind
    outs = [cli.process(f)[0] for f in clip[3:]]
    cli.close()

    eng = DiPsEngine(DiPsProperties(window_size=3, temporal_size=2,
                                    filter=DiPsFilter.UNFILTERED),
                     24, 40, batch=1)
    eng.process_frames(list(clip[:3]))
    exp_out, _ = eng.process_frames(list(clip[3:]))
    np.testing.assert_array_equal(np.stack(outs), exp_out)


def test_serve_error_isolation(server):
    """A bad request errors that request, not the connection."""
    cli = DiPsClient(server.port)
    with pytest.raises(RuntimeError):
        cli.load("/nonexistent/nope.npz")
    out, stats = cli.process(make_clip(n=1, h=24, w=40)[0])
    assert out.shape == (24, 40, 3)
    cli.close()


def test_malformed_request_does_not_kill_daemon(server):
    """A garbage request must drop that connection only; the daemon keeps
    serving the next client (code-review regression)."""
    import socket
    import struct
    s = socket.create_connection(("127.0.0.1", server.port))
    s.sendall(struct.pack("<I", 12) + b"not json!!!!")
    s.close()
    # oversized header claim must be rejected, not allocated
    s2 = socket.create_connection(("127.0.0.1", server.port))
    s2.sendall(struct.pack("<I", 0xFFFFFFFF))
    s2.close()
    # daemon still alive and serving real work
    cli = DiPsClient(server.port)
    out, stats = cli.process(make_clip(n=1, h=24, w=40)[0])
    assert out.shape == (24, 40, 3)
    cli.close()


def test_shutdown_interrupts_idle_client():
    """shutdown() must stop the server even while a client sits idle in a
    connection (recv timeouts check the stop flag)."""
    import socket
    import time
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 8, 16, port=0, batch=1)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    idle = socket.create_connection(("127.0.0.1", srv.port))
    time.sleep(0.2)  # let the server enter _serve_client
    srv.shutdown()
    t.join(timeout=5.0)
    assert not t.is_alive()
    idle.close()


def test_signal_handler_shutdown_is_prompt_and_frees_port():
    """SIGTERM-style stop: the daemon installs a signal handler that calls
    shutdown(), and Python runs handlers ON the main thread — the very
    thread sitting in serve_forever's accept loop.  shutdown() must not
    wait for the accept loop to finish (it is suspended beneath the
    handler; the wait could only time out), and the port must be genuinely
    free once serve_forever returns."""
    import signal
    import socket
    import time
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 8, 16, port=0, batch=1)
    port = srv.port
    fired = []

    def _handler(signum, frame):
        fired.append(time.monotonic())
        srv.shutdown()

    old = signal.signal(signal.SIGALRM, _handler)
    try:
        signal.setitimer(signal.ITIMER_REAL, 0.3)
        t0 = time.monotonic()
        srv.serve_forever()  # returns once the handler stops it
        elapsed = time.monotonic() - t0
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0.0)
        signal.signal(signal.SIGALRM, old)
    assert fired, "timer never fired"
    # pre-fix this stalled the full 5 s _accept_done timeout per stop
    assert elapsed < 3.0, f"signal-handler shutdown stalled {elapsed:.1f}s"
    # no SO_REUSEADDR here: the bind only succeeds if the port is
    # genuinely free, which is the fast-restart guarantee under test
    s = socket.socket()
    try:
        s.bind(("127.0.0.1", port))
    finally:
        s.close()


def test_concurrent_sessions_have_independent_state(tmp_path):
    """Two clients on a 2-session server stream interleaved; each session's
    results match an independent single-stream engine run."""
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 10, 20, port=0, batch=1, max_sessions=2)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        clips = [make_clip(n=4, h=10, w=20, seed=s) for s in range(2)]
        clients = [DiPsClient(srv.port), DiPsClient(srv.port)]
        outs = {0: [], 1: []}
        for k in range(4):  # interleave frames across the two sessions
            for ci, cli in enumerate(clients):
                o, _ = cli.process(clips[ci][k])
                outs[ci].append(o)
        for ci, cli in enumerate(clients):
            cli.close()
            eng = DiPsEngine(props, 10, 20, batch=1)
            exp, _ = eng.process_frames(list(clips[ci]))
            np.testing.assert_array_equal(np.stack(outs[ci]), exp)
    finally:
        srv.shutdown()


def test_session_limit_rejects_extra_client():
    import socket as sk
    import struct
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 8, 16, port=0, batch=1, max_sessions=1)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        holder = DiPsClient(srv.port)   # occupies the only session
        holder.hello()
        extra = sk.create_connection(("127.0.0.1", srv.port))
        raw_len = extra.recv(4)
        n = struct.unpack("<I", raw_len)[0]
        import json as _json
        resp = _json.loads(extra.recv(n))
        assert not resp["ok"] and "session limit" in resp["error"]
        extra.close()
        holder.close()
    finally:
        srv.shutdown()


def test_process_batch_round_trip(server):
    """Batched requests equal per-frame requests frame-for-frame."""
    clip = make_clip(n=5, h=24, w=40, seed=7)
    c1 = DiPsClient(server.port)
    out_b, stats_b = c1.process_many(np.stack(clip))
    c1.close()
    eng = DiPsEngine(DiPsProperties(window_size=3, temporal_size=2,
                                    filter=DiPsFilter.UNFILTERED),
                     24, 40, batch=1)
    exp_out, exp_stats = eng.process_frames(list(clip))
    np.testing.assert_array_equal(out_b, exp_out)
    np.testing.assert_allclose(stats_b, exp_stats, atol=1e-6)


def test_protocol_fuzz_random_garbage(server):
    """Random byte blobs thrown at the daemon must never kill it."""
    import socket
    import struct
    rng = np.random.default_rng(0)
    for trial in range(12):
        s = socket.create_connection(("127.0.0.1", server.port))
        kind = trial % 4
        if kind == 0:      # random bytes, no framing
            s.sendall(bytes(rng.integers(0, 256, 64, dtype=np.uint8)))
        elif kind == 1:    # valid length, garbage header
            s.sendall(struct.pack("<I", 32)
                      + bytes(rng.integers(0, 256, 32, dtype=np.uint8)))
        elif kind == 2:    # truncated mid-header
            s.sendall(struct.pack("<I", 1000) + b"{\"cmd\"")
        else:              # valid header, absurd payload claim
            hdr = b'{"cmd": "process", "payload_len": 999999999999}'
            s.sendall(struct.pack("<I", len(hdr)) + hdr)
        s.close()
    cli = DiPsClient(server.port)  # still alive
    assert cli.hello()["ok"]
    cli.close()


def test_multisession_anonymous_reconnect_gets_fresh_state():
    """On a multi-session server an untagged reconnect must NOT inherit a
    previous client's streaming state (baseline/cursor isolation)."""
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 10, 20, port=0, batch=1, max_sessions=2)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        clip = make_clip(n=2, h=10, w=20, seed=1)
        a = DiPsClient(srv.port)
        a.process(clip[0])
        assert a.hello()["frame_index"] == 1
        a.close()
        b = DiPsClient(srv.port)  # must not resume A's engine
        assert b.hello()["frame_index"] == 0
        # frame 0 of a fresh stream re-captures the baseline: zero diff
        _, s = b.process(clip[1])
        assert s[1] == 0
        b.close()
    finally:
        srv.shutdown()


def test_single_session_anonymous_never_inherits_evicted_named_state():
    """A single-session daemon's anonymous resume exception covers only
    its own lone anonymous engine.  A NAMED session's engine that was
    evicted into the anonymous pool (named-session cap) must be reset
    before an anonymous client receives it — previously the client
    silently inherited the camera's baseline and frame cursor."""
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 10, 20, port=0, batch=1, max_sessions=1)
    srv.max_named_sessions = 1  # second named token evicts the first
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        clip = make_clip(n=2, h=10, w=20, seed=7)
        a = DiPsClient(srv.port, session="cam-A")
        a.process(clip[0])
        assert a.hello()["frame_index"] == 1
        a.close()                            # parks cam-A
        b = DiPsClient(srv.port, session="cam-B")
        b.process(clip[0])
        b.close()                            # parks cam-B, evicts cam-A
        anon = DiPsClient(srv.port)          # pops cam-A's pooled engine
        assert anon.hello()["frame_index"] == 0
        # frame 0 of a fresh stream re-captures the baseline: zero diff
        _, s = anon.process(clip[1])
        assert s[1] == 0
        anon.close()
    finally:
        srv.shutdown()


def test_named_session_resumes_across_reconnects():
    """A session token parks and resumes its engine on a multi-session
    server; a different token still gets fresh state."""
    props = DiPsProperties(window_size=3, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 24, 40, port=0, batch=1, max_sessions=2)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        clip = make_clip(n=4, h=24, w=40, seed=11)
        a1 = DiPsClient(srv.port, session="cam-A")
        outs = [a1.process(f)[0] for f in clip[:2]]
        a1.close()
        other = DiPsClient(srv.port, session="cam-B")
        assert other.hello()["frame_index"] == 0
        other.close()
        a2 = DiPsClient(srv.port, session="cam-A")
        assert a2.hello()["frame_index"] == 2  # resumed
        outs += [a2.process(f)[0] for f in clip[2:]]
        a2.close()
        eng = DiPsEngine(props, 24, 40, batch=1)
        exp, _ = eng.process_frames(list(clip))
        np.testing.assert_array_equal(np.stack(outs), exp)
    finally:
        srv.shutdown()


# -- coalesced serving: N sessions share one stacked-stream engine ----------

def _coalesced_server(n_slots, h=16, w=24, **kw):
    props = DiPsProperties(window_size=3, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, h, w, port=0, batch=2, coalesce=n_slots, **kw)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, props


def test_coalesced_sessions_match_dedicated_engines():
    """3 concurrent clients on one coalescer must each get EXACTLY what a
    dedicated single-stream engine computes on their frames (private
    baseline/ring/cursor per slot, despite shared dispatches)."""
    srv, props = _coalesced_server(3)
    try:
        clips = [make_clip(n=6, h=16, w=24, seed=20 + i) for i in range(3)]
        results = [None] * 3

        def run(i):
            cli = DiPsClient(srv.port)
            assert cli.hello()["config"]["coalesced"] is True
            outs, stats = [], []
            for f in clips[i]:
                o, s = cli.process(f)
                outs.append(o)
                stats.append(s)
            cli.close()
            results[i] = (np.stack(outs), np.stack(stats))

        ts = [threading.Thread(target=run, args=(i,)) for i in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        for i in range(3):
            assert results[i] is not None, f"client {i} did not finish"
            eng = DiPsEngine(props, 16, 24, batch=1)
            exp_out, exp_stats = eng.process_frames(list(clips[i]))
            np.testing.assert_array_equal(results[i][0], exp_out)
            np.testing.assert_allclose(results[i][1], exp_stats, atol=1e-6)
    finally:
        srv.shutdown()


def test_coalesced_batched_requests_and_snapshot():
    srv, props = _coalesced_server(2)
    try:
        clip = make_clip(n=6, h=16, w=24, seed=31)
        cli = DiPsClient(srv.port)
        outs, stats = cli.process_many(clip[:4])  # spans two device batches
        assert outs.shape == (4, 16, 24, 3)
        cli.snapshot()
        _, s = cli.process(clip[4])
        assert s[1] == 0  # forced re-capture -> zero diff
        hm = cli.heatmap()
        assert hm.shape == (16, 24) and hm.max() > 0
        cli.close()
    finally:
        srv.shutdown()


def test_coalesced_save_load_roundtrip(tmp_path):
    """Per-slot save/load on a coalesced server: a session rewinds to its
    checkpoint and continues bit-identically while its co-tenant streams on
    unaffected."""
    srv, props = _coalesced_server(2)
    try:
        clip_a = make_clip(n=6, h=16, w=24, seed=60)
        clip_b = make_clip(n=6, h=16, w=24, seed=61)
        path = str(tmp_path / "slot.npz")
        a = DiPsClient(srv.port, session="cam-A")
        b = DiPsClient(srv.port, session="cam-B")
        outs_a = [a.process(f)[0] for f in clip_a[:3]]
        outs_b = [b.process(f)[0] for f in clip_b[:3]]
        a.save(path)
        a.process(clip_a[4])            # wander past the checkpoint...
        assert a.load(path) == 3        # ...and rewind to it
        outs_a += [a.process(f)[0] for f in clip_a[3:]]
        outs_b += [b.process(f)[0] for f in clip_b[3:]]
        a.close()
        b.close()
        for clip, outs in ((clip_a, outs_a), (clip_b, outs_b)):
            eng = DiPsEngine(props, 16, 24, batch=1)
            exp, _ = eng.process_frames(list(clip))
            np.testing.assert_array_equal(np.stack(outs), exp)
    finally:
        srv.shutdown()


def test_session_migrates_between_dedicated_and_coalesced(tmp_path):
    """Checkpoints are DiPsEngine-format on both server kinds, so a camera
    session saved on a dedicated server resumes inside a coalesced slot."""
    props = DiPsProperties(window_size=3, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED)
    clip = make_clip(n=6, h=16, w=24, seed=62)
    path = str(tmp_path / "mig.npz")
    ded = DiPsServer(props, 16, 24, port=0, batch=1)
    threading.Thread(target=ded.serve_forever, daemon=True).start()
    try:
        cli = DiPsClient(ded.port)
        outs = [cli.process(f)[0] for f in clip[:3]]
        cli.save(path)
        cli.close()
    finally:
        ded.shutdown()
    srv, _ = _coalesced_server(2)
    try:
        cli = DiPsClient(srv.port, session="cam-M")
        assert cli.load(path) == 3
        outs += [cli.process(f)[0] for f in clip[3:]]
        cli.close()
    finally:
        srv.shutdown()
    eng = DiPsEngine(props, 16, 24, batch=1)
    exp, _ = eng.process_frames(list(clip))
    np.testing.assert_array_equal(np.stack(outs), exp)


def test_coalesced_named_session_resumes_anonymous_does_not():
    srv, props = _coalesced_server(2)
    try:
        clip = make_clip(n=4, h=16, w=24, seed=40)
        a1 = DiPsClient(srv.port, session="cam-A")
        outs = [a1.process(f)[0] for f in clip[:2]]
        a1.close()
        anon = DiPsClient(srv.port)  # fresh slot, not cam-A's state
        assert anon.hello()["frame_index"] == 0
        anon.close()
        a2 = DiPsClient(srv.port, session="cam-A")
        assert a2.hello()["frame_index"] == 2  # resumed slot
        outs += [a2.process(f)[0] for f in clip[2:]]
        a2.close()
        eng = DiPsEngine(props, 16, 24, batch=1)
        exp, _ = eng.process_frames(list(clip))
        np.testing.assert_array_equal(np.stack(outs), exp)
    finally:
        srv.shutdown()


def test_coalesced_slot_exhaustion_evicts_oldest_parked():
    """All slots parked under named tokens: a new client evicts the oldest
    parked session instead of being refused."""
    srv, _ = _coalesced_server(2)
    try:
        clip = make_clip(n=3, h=16, w=24, seed=50)
        for name in ("cam-A", "cam-B"):
            c = DiPsClient(srv.port, session=name)
            c.process(clip[0])
            c.close()
        c = DiPsClient(srv.port, session="cam-C")  # evicts cam-A
        assert c.hello()["frame_index"] == 0
        c.process(clip[1])
        c.close()
        b = DiPsClient(srv.port, session="cam-B")  # survived
        assert b.hello()["frame_index"] == 1
        b.close()
        a = DiPsClient(srv.port, session="cam-A")  # evicted -> fresh
        assert a.hello()["frame_index"] == 0
        a.close()
    finally:
        srv.shutdown()


def test_coalesced_bad_frame_isolated_per_request():
    srv, _ = _coalesced_server(2)
    try:
        cli = DiPsClient(srv.port)
        with pytest.raises(RuntimeError):
            cli.process(np.zeros((3, 3, 3), np.uint8))
        out, _ = cli.process(make_clip(n=1, h=16, w=24)[0])
        assert out.shape == (16, 24, 3)
        cli.close()
    finally:
        srv.shutdown()


def test_coalesced_concurrent_stress_random_ops():
    """4 clients fire interleaved random command mixes at one coalescer;
    nothing deadlocks, every reply is sane, and the daemon finishes all
    sessions (races in the dispatcher would hang or cross wires here)."""
    srv, _ = _coalesced_server(4, h=8, w=16)
    try:
        rng = np.random.default_rng(0)
        clip = make_clip(n=8, h=8, w=16, seed=60)
        errors = []

        def run(i):
            try:
                with DiPsClient(srv.port, session=f"s{i}") as cli:
                    r = np.random.default_rng(i)
                    for _ in range(12):
                        op = r.integers(0, 10)
                        if op < 6:
                            o, s = cli.process(clip[r.integers(0, 8)])
                            assert o.shape == (8, 16, 3)
                            assert np.isfinite(s).all()
                        elif op < 8:
                            o, s = cli.process_many(
                                clip[:int(r.integers(1, 5))])
                            assert np.isfinite(s).all()
                        elif op == 8:
                            cli.snapshot()
                        else:
                            cli.reset()
            except Exception as e:  # surface thread failures to pytest
                errors.append((i, repr(e)))

        ts = [threading.Thread(target=run, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=90)
        assert not errors, errors
        assert not any(t.is_alive() for t in ts), "stress run deadlocked"
    finally:
        srv.shutdown()


def test_coalesced_slots_shard_over_mesh():
    """coalesce_devices=4: 8 session slots shard over a 4-device virtual
    mesh; a client on each shard still gets exactly the dedicated-engine
    result (the multi-chip camera-fleet deployment shape)."""
    props = DiPsProperties(window_size=3, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 16, 24, port=0, batch=2, coalesce=8,
                     coalesce_devices=4)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        assert srv._coalescer.engine.mesh.devices.size == 4
        clips = [make_clip(n=4, h=16, w=24, seed=80 + i) for i in range(8)]
        results = [None] * 8

        def run(i):
            with DiPsClient(srv.port) as cli:
                results[i] = np.stack(
                    [cli.process(f)[0] for f in clips[i]])

        ts = [threading.Thread(target=run, args=(i,)) for i in range(8)]
        for th in ts:
            th.start()
        for th in ts:
            th.join(timeout=90)
        # slot assignment order is nondeterministic under concurrency, so
        # match each result to the clip its client streamed
        for i in range(8):
            assert results[i] is not None
            eng = DiPsEngine(props, 16, 24, batch=1)
            exp, _ = eng.process_frames(list(clips[i]))
            np.testing.assert_array_equal(results[i], exp)
    finally:
        srv.shutdown()


def test_metrics_command(server):
    clip = make_clip(n=3, h=24, w=40, seed=90)
    with DiPsClient(server.port) as cli:
        cli.process(clip[0])
        cli.process_many(clip[1:])
        with pytest.raises(RuntimeError):
            cli.load("/nonexistent/nope.npz")
        m = cli.metrics()
    assert m["frames"] == 3 and m["requests"] >= 4
    assert m["request_errors"] == 1 and m["active_sessions"] == 1
    assert m["connections"] == 1 and m["uptime_s"] >= 0
    assert m["coalesced"] is False and m["frame_index"] == 3
    lat = m["latency_ms"]
    assert lat["count"] == 2  # one process + one process_batch sample
    assert 0 <= lat["p50"] <= lat["p90"] <= lat["p99"] <= lat["max"]


def test_metrics_coalesce_fill(tmp_path):
    """Coalesced servers report device dispatches and mean request fill."""
    srv, _ = _coalesced_server(2)
    try:
        clip = make_clip(n=4, h=16, w=24, seed=91)
        with DiPsClient(srv.port) as cli:
            for f in clip:
                cli.process(f)
            m = cli.metrics()
        assert m["coalesced"] is True
        assert m["coalesce_dispatches"] >= 1
        # single client: each dispatch folded exactly its one frame
        assert 1.0 <= m["coalesce_mean_fill"] <= 2.0
        assert m["latency_ms"]["count"] == 4
    finally:
        srv.shutdown()


def test_coalesced_hwc_input_layout_matches():
    """A coalesced server with input_layout='hwc' (device-side planarize)
    serves bit-identical results."""
    srv, props = _coalesced_server(2, input_layout="hwc")
    try:
        clip = make_clip(n=4, h=16, w=24, seed=70)
        with DiPsClient(srv.port) as cli:
            outs = [cli.process(f)[0] for f in clip]
        eng = DiPsEngine(props, 16, 24, batch=1)
        exp, _ = eng.process_frames(list(clip))
        np.testing.assert_array_equal(np.stack(outs), exp)
    finally:
        srv.shutdown()


def _flexible_server(**kw):
    props = DiPsProperties(window_size=3, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, port=0, batch=2, max_sessions=2, **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, props


def test_flexible_geometry_mixed_fleet():
    """A daemon started WITHOUT height/width serves sessions of different
    resolutions, each sized from its first frame and bit-exact vs a
    dedicated engine."""
    srv, props = _flexible_server()
    try:
        clip_a = make_clip(n=4, h=16, w=24, seed=80)
        clip_b = make_clip(n=4, h=12, w=40, seed=81)
        a = DiPsClient(srv.port, session="cam-A")
        b = DiPsClient(srv.port, session="cam-B")
        # geometry-free commands answer before any frame
        info = a.hello()
        assert info["ok"] and info["config"]["height"] is None
        assert a.metrics()["ok"]
        # state commands need a frame first -> clean error, session survives
        with pytest.raises(RuntimeError, match="geometry"):
            a.snapshot()
        outs_a = [a.process(f)[0] for f in clip_a]
        outs_b = [b.process(f)[0] for f in clip_b]
        assert a.hello()["config"]["height"] == 16
        a.close()
        b.close()
        for (h, w, clip, outs) in ((16, 24, clip_a, outs_a),
                                   (12, 40, clip_b, outs_b)):
            eng = DiPsEngine(props, h, w, batch=2)
            exp, _ = eng.process_frames(list(clip))
            np.testing.assert_array_equal(np.stack(outs), exp)
        with DiPsClient(srv.port) as mon:
            m = mon.metrics()
        assert m["flexible"] is True and m["parked_sessions"] == 2
    finally:
        srv.shutdown()


def test_flexible_named_resume_and_checkpoint_load(tmp_path):
    """Flexible daemon: named sessions park/resume across reconnects, and a
    brand-new session can bind its geometry from a checkpoint file."""
    srv, props = _flexible_server()
    path = str(tmp_path / "flex.npz")
    try:
        clip = make_clip(n=6, h=16, w=24, seed=82)
        c1 = DiPsClient(srv.port, session="cam-R")
        for f in clip[:3]:
            c1.process(f)
        c1.save(path)
        c1.close()
        c2 = DiPsClient(srv.port, session="cam-R")
        assert c2.hello()["frame_index"] == 3  # parked state resumed
        outs = [c2.process(f)[0] for f in clip[3:]]
        c2.close()
        eng = DiPsEngine(props, 16, 24, batch=2)
        exp, _ = eng.process_frames(list(clip))
        np.testing.assert_array_equal(np.stack(outs), exp[3:])

        # fresh anonymous session binds geometry (and state) from the file
        c3 = DiPsClient(srv.port)
        assert c3.load(path) == 3
        out3, _ = c3.process(clip[3])
        np.testing.assert_array_equal(out3, exp[3])
        c3.close()
    finally:
        srv.shutdown()


def test_flexible_coalesce_per_geometry():
    """A flexible daemon with coalesce=N creates one stacked-stream
    coalescer PER GEOMETRY lazily: mixed-resolution camera fleets still
    share device dispatches within each resolution, with per-slot state
    bit-exact vs dedicated engines."""
    props = DiPsProperties(window_size=3, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, port=0, batch=2, coalesce=2, max_sessions=4)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        srv.warm_geometries(["16x24"])  # warm one bucket up front
        geoms = [(16, 24), (16, 24), (12, 40), (12, 40)]
        clips = [make_clip(n=4, h=h, w=w, seed=130 + i)
                 for i, (h, w) in enumerate(geoms)]
        results = [None] * 4
        errors = []

        def cam(i):
            try:
                with DiPsClient(srv.port, session=f"g{i}") as cli:
                    results[i] = [cli.process(f)[0] for f in clips[i]]
            except Exception as e:
                errors.append((i, repr(e)))

        ts = [threading.Thread(target=cam, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not errors, errors
        for i, (h, w) in enumerate(geoms):
            eng = DiPsEngine(props, h, w, batch=2)
            exp, _ = eng.process_frames(list(clips[i]))
            np.testing.assert_array_equal(np.stack(results[i]), exp)
        with DiPsClient(srv.port) as mon:
            m = mon.metrics()
        assert m["coalesced"] is True and m["flexible"] is True
        assert m["coalesce_dispatches"] >= 1
        # a named session resumes on ITS geometry's coalescer
        with DiPsClient(srv.port, session="g0") as cli:
            assert cli.hello()["frame_index"] == 4
    finally:
        srv.shutdown()


def test_flexible_bad_load_path_survives():
    """A bad checkpoint path on a flexible daemon replies a clean error
    (the geometry peek must not drop the connection)."""
    srv, _ = _flexible_server()
    try:
        with DiPsClient(srv.port) as cli:
            with pytest.raises(RuntimeError):
                cli.load("/nonexistent/nope.npz")
            out, _ = cli.process(make_clip(n=1, h=16, w=24)[0])
            assert out.shape == (16, 24, 3)
    finally:
        srv.shutdown()


def test_prometheus_metrics_endpoint():
    """--metrics-port serves Prometheus text format over HTTP."""
    import urllib.request
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 16, 24, port=0, batch=1, metrics_port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        assert srv.metrics_port
        with DiPsClient(srv.port) as cli:
            cli.process(make_clip(n=1, h=16, w=24)[0])
        url = f"http://127.0.0.1:{srv.metrics_port}/metrics"
        body = urllib.request.urlopen(url, timeout=10).read().decode()
        assert "# TYPE dips_requests counter" in body
        assert "dips_frames 1" in body
        assert 'dips_request_latency_ms{quantile="p50"}' in body
        with pytest.raises(Exception):  # non-metrics paths 404
            urllib.request.urlopen(
                f"http://127.0.0.1:{srv.metrics_port}/nope", timeout=10)
    finally:
        srv.shutdown()


def test_warm_geometries_prebuilds_pool():
    """warm_geometries pre-compiles pooled engines so the first camera of
    a resolution reuses one; bad specs and fixed-server mismatches fail
    loudly."""
    srv, props = _flexible_server()
    try:
        srv.warm_geometries(["16x24"])
        with DiPsClient(srv.port) as mon:
            assert mon.metrics()["pooled_engines"] == {"16x24": 1}
        clip = make_clip(n=2, h=16, w=24, seed=95)
        with DiPsClient(srv.port) as cli:
            outs = [cli.process(f)[0] for f in clip]
        eng = DiPsEngine(props, 16, 24, batch=2)
        exp, _ = eng.process_frames(list(clip))
        np.testing.assert_array_equal(np.stack(outs), exp)
        with pytest.raises(ValueError, match="bad geometry"):
            srv.warm_geometries(["16by24"])
    finally:
        srv.shutdown()
    fixed = DiPsServer(DiPsProperties(window_size=1, temporal_size=1),
                       16, 24, port=0)
    try:
        fixed.warm_geometries(["16x24"])  # matching: allowed
        with pytest.raises(ValueError, match="fixed server"):
            fixed.warm_geometries(["1080p"])
    finally:
        fixed.shutdown()


def test_flexible_concurrent_churn_stress(tmp_path):
    """Mixed-geometry clients churn connect/process/save/load/close against
    one flexible daemon; no deadlocks, no cross-geometry state leaks, every
    named session's cursor stays consistent across its reconnect cycles."""
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, port=0, batch=2, max_sessions=4)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    geoms = [(16, 24), (8, 16), (12, 40)]
    errors = []

    def run(i):
        h, w = geoms[i % len(geoms)]
        clip = make_clip(n=6, h=h, w=w, seed=120 + i)
        count = 0
        try:
            for cycle in range(3):  # reconnect churn
                with DiPsClient(srv.port, session=f"cam{i}") as cli:
                    assert cli.hello()["frame_index"] == count, (i, cycle)
                    r = np.random.default_rng(100 + 10 * i + cycle)
                    for _ in range(int(r.integers(1, 4))):
                        o, s = cli.process(clip[count % 6])
                        assert o.shape == (h, w, 3), (i, o.shape)
                        assert np.isfinite(s).all()
                        count += 1
                    if cycle == 1:
                        p = str(tmp_path / f"c{i}.npz")
                        cli.save(p)
                        assert cli.load(p) == count
        except Exception as e:
            errors.append((i, repr(e)))

    ts = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not errors, errors
        assert not any(t.is_alive() for t in ts), "churn deadlocked"
        with DiPsClient(srv.port) as mon:
            m = mon.metrics()
        assert m["parked_sessions"] == 4 and m["request_errors"] == 0
    finally:
        srv.shutdown()


# ---------------------------------------------------------------------------
# session/slot lifecycle hardening (self-review round 2)
# ---------------------------------------------------------------------------

def test_abortive_disconnect_frees_coalescer_slot():
    """A client killed mid-stream (RST, not a clean close) must not leak
    its bound slot: the engine holder releases it on ANY exit path."""
    import socket as socket_mod
    import struct
    import time

    srv, props = _coalesced_server(1)  # ONE slot: a leak blocks everyone
    try:
        f = make_clip(n=1, h=16, w=24)[0]
        for _ in range(3):  # repeat: each leaked slot would be fatal
            c = DiPsClient(srv.port)
            c.process(f)  # binds the only slot
            # abortive close: SO_LINGER(on, 0) makes close() send RST, so
            # the server's recv raises ConnectionResetError mid-session
            c._sock.setsockopt(socket_mod.SOL_SOCKET, socket_mod.SO_LINGER,
                               struct.pack("ii", 1, 0))
            c._sock.close()
            # the slot must come back for the next client
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                with srv._pool_lock:
                    co = srv._coalescer
                with co._cv:
                    if not co._bound:
                        break
                time.sleep(0.05)
            else:
                raise AssertionError("slot still bound after RST")
    finally:
        srv.shutdown()


def test_slow_mid_message_does_not_desync_protocol():
    """The 0.5s idle poll must not fire mid-message: a request trickling
    in slower than the poll interval still parses and gets a reply."""
    import socket as socket_mod
    import json as json_mod
    import struct

    srv, props = _coalesced_server(1)
    try:
        f = make_clip(n=1, h=16, w=24)[0]
        payload = np.ascontiguousarray(f).tobytes()
        hdr = json_mod.dumps({"cmd": "process", "shape": list(f.shape),
                              "payload_len": len(payload)}).encode()
        msg = struct.pack("<I", len(hdr)) + hdr + payload
        s = socket_mod.create_connection(("127.0.0.1", srv.port))
        # drip the request in 3 chunks with >0.5s pauses
        import time
        third = len(msg) // 3
        for chunk in (msg[:third], msg[third:2 * third], msg[2 * third:]):
            s.sendall(chunk)
            time.sleep(0.7)
        raw = s.recv(4)
        n = struct.unpack("<I", raw)[0]
        buf = b""
        while len(buf) < n:
            buf += s.recv(n - len(buf))
        reply = json_mod.loads(buf)
        assert reply["ok"], reply
        s.close()
    finally:
        srv.shutdown()


def test_duplicate_token_park_releases_superseded_slot():
    """Camera reconnects with its token while the old connection still
    drains: when both park, the superseded slot must be freed (was: leaked
    unreachably, exhausting the coalescer)."""
    srv, props = _coalesced_server(2)
    try:
        a = srv._bind_engine("cam")        # slot for connection A
        b = srv._bind_engine("cam")        # reconnect before A parks
        srv._release_engine(a)             # A parks under "cam"
        srv._release_engine(b)             # B supersedes A's parked slot
        # both slots must now be obtainable (one free, one via eviction)
        x = srv._bind_engine(None)
        y = srv._bind_engine(None)
        assert {x.slot, y.slot} == {0, 1}
    finally:
        srv.shutdown()


def test_prometheus_single_type_line_per_family():
    """Duplicate # TYPE lines make Prometheus reject the whole scrape."""
    from dips.serve import _prometheus_text

    text = _prometheus_text({
        "connections": 1, "flexible": True,
        "pooled_engines": {"16x24": 1, "32x48": 2}})
    assert text.count("# TYPE dips_pooled_engines gauge") == 1
    assert 'geometry="16x24"' in text and 'geometry="32x48"' in text


def test_flexible_hello_reports_coalesced_before_bind():
    srv, props = _flexible_server(coalesce=2)
    try:
        with DiPsClient(srv.port) as c:
            assert c.hello()["config"]["coalesced"] is True
    finally:
        srv.shutdown()


def test_bad_shape_strings_get_error_reply():
    """Non-numeric shape entries on the first request must produce an
    error reply, not a silent connection drop."""
    srv, props = _flexible_server()
    try:
        c = DiPsClient(srv.port)
        h, _ = c._rpc({"cmd": "process", "shape": ["a", "b", "c"]})
        assert not h["ok"] and "bad shape" in h["error"]
        # connection survives for a correct request
        o, _ = c.process(make_clip(n=1, h=16, w=24)[0])
        assert o.shape == (16, 24, 3)
        c.close()
    finally:
        srv.shutdown()


def test_geometry_churn_evicts_idle_state():
    """Geometry churn must not accumulate unbounded engines/coalescers:
    idle per-geometry state beyond the caps is evicted."""
    # flexible NON-coalesced: pooled engines capped
    srv, props = _flexible_server()
    try:
        srv.max_pooled_engines = 2
        geoms = [(16, 24), (24, 24), (32, 24)]
        for h, w in geoms:
            with DiPsClient(srv.port) as c:
                c.process(np.zeros((h, w, 3), np.uint8))
        with srv._pool_lock:
            total = sum(len(v) for v in srv._pool.values())
        assert total <= 2
    finally:
        srv.shutdown()

    # flexible coalesced: idle coalescers capped
    srv, props = _flexible_server(coalesce=1)
    try:
        srv.max_geometries = 2
        for h, w in geoms:
            with DiPsClient(srv.port) as c:
                c.process(np.zeros((h, w, 3), np.uint8))
        with srv._pool_lock:
            n = len(srv._coalescers)
        assert n <= 2
    finally:
        srv.shutdown()


# ---------------------------------------------------------------------------
# resilient client (auto-reconnect + exactly-once accounting)
# ---------------------------------------------------------------------------

def test_resilient_client_reconnects_and_resends():
    """A connection killed BEFORE the request reaches the server: the
    client reconnects, resumes the parked session, and resends — the
    stream is bit-identical to an uninterrupted run."""
    from dips.serve import ResilientDiPsClient

    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 16, 24, port=0, batch=2, max_sessions=2)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        clip = make_clip(n=6, h=16, w=24, seed=4)
        c = ResilientDiPsClient(srv.port, session="cam", backoff_s=0.05)
        outs = [c.process(f)[0] for f in clip[:2]]
        c._cli._sock.close()  # dead link; request never sent
        outs += [c.process(f)[0] for f in clip[2:4]]  # reconnect + resend
        c._cli._sock.close()
        o_batch, _ = c.process_many(np.stack(clip[4:6]))
        outs += list(o_batch)
        c.close()

        eng = DiPsEngine(props, 16, 24, batch=2)
        exp, _ = eng.process_frames(list(clip))
        np.testing.assert_array_equal(np.stack(outs), exp)
        assert c.dropped_replies == 0
    finally:
        srv.shutdown()


def test_resilient_client_reply_lost_accounting():
    """A request processed by the server whose reply died on the wire:
    the client must NOT resend (double-processing) — it raises ReplyLost,
    records the drop, and the stream continues correctly aligned."""
    import time

    from dips.errors import ReplyLost
    from dips.serve import ResilientDiPsClient, _send

    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 16, 24, port=0, batch=2, max_sessions=2)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        clip = make_clip(n=4, h=16, w=24, seed=5)
        c = ResilientDiPsClient(srv.port, session="cam", backoff_s=0.05)
        c.process(clip[0])
        # send frame 1 manually, then kill the connection before reading
        # the reply: the server processes it and parks the session
        payload = np.ascontiguousarray(clip[1]).tobytes()
        _send(c._cli._sock, {"cmd": "process",
                             "shape": list(clip[1].shape),
                             "session": "cam",
                             "payload_len": len(payload)}, payload)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:  # wait for the server cursor
            with srv._pool_lock:
                parked = "cam" in srv._named
            if parked:
                break
            time.sleep(0.02)
        c._cli._sock.close()
        time.sleep(0.1)
        with pytest.raises(ReplyLost):
            c.process(clip[1])
        assert c.dropped_replies == 1
        # the NEXT frame continues the stream exactly-once: server cursor
        # is 2 (frames 0 and 1), so frame 2 lands at index 2
        c.process(clip[2])
        assert c.hello()["frame_index"] == 3
        c.close()
    finally:
        srv.shutdown()


def test_resilient_client_survives_server_restart():
    """Daemon restart (session state gone): the client resumes fresh with
    a warning instead of erroring forever."""
    import time

    from dips.serve import ResilientDiPsClient

    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 16, 24, port=0, batch=2, max_sessions=2)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    port = srv.port
    clip = make_clip(n=4, h=16, w=24, seed=6)
    c = ResilientDiPsClient(port, session="cam", retries=8, backoff_s=0.1)
    c.process_many(np.stack(clip[:2]))
    srv.shutdown()
    srv2 = None
    for _ in range(50):  # the old listener can take a moment to release
        time.sleep(0.1)
        try:
            srv2 = DiPsServer(props, 16, 24, port=port, batch=2,
                              max_sessions=2)
            break
        except OSError:
            continue
    assert srv2 is not None, "could not rebind the port"
    threading.Thread(target=srv2.serve_forever, daemon=True).start()
    try:
        out, _ = c.process_many(np.stack(clip[2:4]))  # fresh resume
        assert out.shape == (2, 16, 24, 3)
        assert c.hello()["frame_index"] == 2  # new server: only these 2
        c.close()
    finally:
        srv2.shutdown()


def test_resilient_client_requires_session():
    from dips.serve import ResilientDiPsClient

    with pytest.raises(ValueError, match="session"):
        ResilientDiPsClient(1234)


def test_resilient_client_initial_connect_backoff():
    """A camera that boots BEFORE the daemon is listening dials with
    backoff instead of dying at start-up (and still fails cleanly when
    nothing ever answers)."""
    import socket as sk
    import time

    from dips.serve import ResilientDiPsClient

    # reserve a port the daemon will come up on shortly
    probe = sk.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()

    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    box = {}

    def late_start():
        time.sleep(0.4)
        for _ in range(50):  # TIME_WAIT on the probe can linger briefly
            try:
                box["srv"] = DiPsServer(props, 16, 24, port=port, batch=2,
                                        max_sessions=2)
                break
            except OSError:
                time.sleep(0.1)
        box["srv"].serve_forever()

    threading.Thread(target=late_start, daemon=True).start()
    c = ResilientDiPsClient(port, session="cam", retries=10, backoff_s=0.1)
    try:
        out, _ = c.process_many(np.stack(make_clip(n=2, h=16, w=24)))
        assert out.shape == (2, 16, 24, 3)
    finally:
        c.close()
        box["srv"].shutdown()

    # nothing listening at all: clean ConnectionError after the retries
    with pytest.raises(ConnectionError, match="could not connect"):
        ResilientDiPsClient(port, session="cam", retries=1,
                            backoff_s=0.01)


def test_flexible_prebind_hello_waits_for_token_takeover():
    """Reconnect race on a flexible daemon: a pre-bind hello with a token
    whose old connection has not yet parked must kick + wait, then report
    the TRUE cursor — not frame_index 0 (which a resilient client would
    misread as server-side state loss)."""
    import socket as sk
    import struct

    srv, props = _flexible_server()
    try:
        c1 = DiPsClient(srv.port, session="cam")
        c1.process(make_clip(n=1, h=16, w=24)[0])
        c1.process(make_clip(n=1, h=16, w=24)[0])
        # abortive RST: the server may not have parked "cam" yet
        c1._sock.setsockopt(sk.SOL_SOCKET, sk.SO_LINGER,
                            struct.pack("ii", 1, 0))
        c1._sock.close()
        c2 = DiPsClient(srv.port, session="cam")  # immediate reconnect
        assert c2.hello()["frame_index"] == 2
        c2.close()
    finally:
        srv.shutdown()


# ---------------------------------------------------------------------------
# load generator
# ---------------------------------------------------------------------------

def test_loadgen_measures_daemon():
    from dips.loadgen import parse_geometry, run_load

    assert parse_geometry("480p") == (480, 854)
    assert parse_geometry("32X48") == (32, 48)
    with pytest.raises(ValueError):
        parse_geometry("huge")

    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 16, 24, port=0, batch=2, max_sessions=4)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        s = run_load(srv.port, clients=3, frames=4, height=16, width=24,
                     batch=2)
        assert s["ok"] and s["requests"] == 6 and s["frames"] == 12
        assert s["fps"] > 0 and s["latency_ms"]["p50"] > 0
        # wrong geometry surfaces as a clean error summary, not a hang
        bad = run_load(srv.port, clients=1, frames=2, height=8, width=8)
        assert not bad["ok"] and bad["errors"]
    finally:
        srv.shutdown()


def test_loadgen_rejects_unmeasurable_config():
    """frames < batch means zero measured requests per client: a clean
    error summary, not an IndexError on the empty percentile array (and
    no sockets are even opened)."""
    from dips.loadgen import run_load

    s = run_load(1, clients=2, frames=1, batch=4)
    assert not s["ok"] and "zero measured" in s["errors"][0]
    s = run_load(1, clients=0, frames=4, batch=1)
    assert not s["ok"] and ">= 1" in s["errors"][0]


def test_loadgen_cli_json_line(capsys):
    from dips.loadgen import main as lg_main

    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 16, 24, port=0, batch=1, max_sessions=2)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        rc = lg_main(["--port", str(srv.port), "--clients", "2",
                      "--frames", "3", "--geometry", "16x24"])
        assert rc == 0
        import json as _json
        out = capsys.readouterr().out.strip()
        s = _json.loads(out)
        assert s["ok"] and s["frames"] == 6
    finally:
        srv.shutdown()


def test_link_health_counters():
    """link_drops and takeovers counters surface reconnect storms."""
    import socket as sk
    import struct
    import time

    srv, props = _flexible_server()
    try:
        c1 = DiPsClient(srv.port, session="cam")
        c1.process(make_clip(n=1, h=16, w=24)[0])
        c1._sock.setsockopt(sk.SOL_SOCKET, sk.SO_LINGER,
                            struct.pack("ii", 1, 0))
        c1._sock.close()  # RST -> link_drops
        c2 = DiPsClient(srv.port, session="cam")
        c2.hello()        # may race the park -> takeover best-effort
        c2.process(make_clip(n=1, h=16, w=24)[0])
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            m = c2.metrics()
            if m["link_drops"] >= 1:
                break
            time.sleep(0.05)
        assert m["link_drops"] >= 1
        assert "takeovers" in m
        c2.close()
    finally:
        srv.shutdown()


def test_resilient_fleet_random_rst_stress():
    """8 resilient clients streaming concurrently with random abortive
    RSTs: every session's cursor must stay exactly-once consistent (the
    takeover + park/resume machinery under real contention)."""
    import random
    import socket as sk
    import struct

    from dips.errors import ReplyLost
    from dips.serve import ResilientDiPsClient

    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 16, 24, port=0, batch=2, max_sessions=8)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    n_frames, n_clients = 12, 8
    results = {}
    failures = []

    def cam(k):
        rng = random.Random(k)
        frames = make_clip(n=n_frames, h=16, w=24, seed=k)
        try:
            c = ResilientDiPsClient(srv.port, session=f"s{k}",
                                    backoff_s=0.02, retries=8)
            done = 0
            for f in frames:
                if rng.random() < 0.25:  # abortive RST mid-stream
                    c._cli._sock.setsockopt(
                        sk.SOL_SOCKET, sk.SO_LINGER,
                        struct.pack("ii", 1, 0))
                    c._cli._sock.close()
                try:
                    c.process(f)
                except ReplyLost:
                    pass  # frame accounted server-side; output skipped
                done += 1
            fi = c.hello()["frame_index"]
            results[k] = (fi, done, c.dropped_replies)
            c.close()
        except Exception as e:
            failures.append(f"cam {k}: {e!r}")

    th = [threading.Thread(target=cam, args=(k,)) for k in range(n_clients)]
    for t in th:
        t.start()
    for t in th:
        t.join(timeout=60)
    try:
        assert not failures, failures
        assert len(results) == n_clients
        for k, (fi, done, dropped) in results.items():
            # exactly-once: server cursor equals frames submitted
            assert fi == done == n_frames, (k, fi, done, dropped)
    finally:
        srv.shutdown()


# ---------------------------------------------------------------------------
# autosave: crash-safety checkpoints for named sessions
# ---------------------------------------------------------------------------

def _absdiff_props():
    from dips.properties import OutputMode
    return DiPsProperties(window_size=1, temporal_size=2,
                          filter=DiPsFilter.UNFILTERED,
                          output=OutputMode.ABSDIFF)


def _wait_autosaves(srv, n, timeout=10.0):
    """Autosaves land AFTER the reply (checkpoint IO must not sit in the
    request latency), so a test 'crash' needs to wait for them."""
    import time
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if srv.metrics()["autosaves"] >= n:
            return
        time.sleep(0.02)
    raise AssertionError(
        f"expected {n} autosaves, got {srv.metrics()['autosaves']}")


def test_autosave_restores_after_daemon_restart(tmp_path):
    """A daemon crash between autosaves loses at most the unsaved tail:
    the restarted daemon restores the session from disk, and the
    continued stream is BIT-IDENTICAL to one uninterrupted engine."""
    props = _absdiff_props()
    clip = make_clip(n=6, h=16, w=24, seed=11)

    ref = DiPsEngine(props, 16, 24, batch=2)
    exp_out, exp_stats = ref.process_frames(list(clip))

    srv = DiPsServer(props, 16, 24, port=0, batch=2, max_sessions=2,
                     autosave_dir=str(tmp_path), autosave_every=2)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    c = DiPsClient(srv.port, session="cam")
    out_a1, stats_a1 = c.process_many(np.stack(clip[:2]))
    out_a2, stats_a2 = c.process_many(np.stack(clip[2:4]))
    out_a = np.concatenate([out_a1, out_a2])
    stats_a = np.concatenate([stats_a1, stats_a2])
    # one autosave per 2-frame request; "crash" without close
    _wait_autosaves(srv, 2)
    srv.shutdown()

    srv2 = DiPsServer(props, 16, 24, port=0, batch=2, max_sessions=2,
                      autosave_dir=str(tmp_path), autosave_every=2)
    threading.Thread(target=srv2.serve_forever, daemon=True).start()
    try:
        c2 = DiPsClient(srv2.port, session="cam")
        assert c2.hello()["frame_index"] == 4  # restored, not fresh
        out_b, stats_b = c2.process_many(np.stack(clip[4:6]))
        np.testing.assert_array_equal(
            np.concatenate([out_a, out_b]), exp_out)
        np.testing.assert_allclose(
            np.concatenate([stats_a, stats_b]), exp_stats,
            atol=1e-5, rtol=1e-5)
        assert srv2.metrics()["autorestores"] == 1
        c2.close()
    finally:
        srv2.shutdown()


def test_autosave_flexible_prebind_hello_reports_restored_cursor(tmp_path):
    """Flexible daemon restart: a pre-bind hello with a token recovers
    geometry from the autosave and reports the restored cursor (0 would
    make a resilient client wrongly resume fresh)."""
    srv, props = _flexible_server(autosave_dir=str(tmp_path),
                                  autosave_every=2)
    clip = make_clip(n=4, h=16, w=24, seed=3)
    c = DiPsClient(srv.port, session="cam")
    c.process_many(np.stack(clip))
    _wait_autosaves(srv, 1)
    srv.shutdown()

    srv2, _ = _flexible_server(autosave_dir=str(tmp_path),
                               autosave_every=2)
    try:
        c2 = DiPsClient(srv2.port, session="cam")
        assert c2.hello()["frame_index"] == 4  # pre-bind, geometry peeked
        out, _ = c2.process_many(np.stack(clip))
        assert out.shape == (4, 16, 24, 3)
        c2.close()
    finally:
        srv2.shutdown()


def test_autosave_close_flushes_and_reset_discards(tmp_path):
    """A graceful close flushes the unsaved tail even below the interval;
    an explicit reset discards the checkpoint (a restart must not
    resurrect state the client threw away)."""
    import os

    props = _absdiff_props()
    clip = make_clip(n=3, h=16, w=24, seed=5)
    srv = DiPsServer(props, 16, 24, port=0, batch=3, max_sessions=2,
                     autosave_dir=str(tmp_path), autosave_every=100)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    c = DiPsClient(srv.port, session="cam")
    c.process_many(np.stack(clip))
    c.close()  # interval not reached: the close flushes
    path = srv._autosave_path("cam")
    assert os.path.exists(path)
    srv.shutdown()

    srv2 = DiPsServer(props, 16, 24, port=0, batch=3, max_sessions=2,
                      autosave_dir=str(tmp_path), autosave_every=100)
    threading.Thread(target=srv2.serve_forever, daemon=True).start()
    try:
        c2 = DiPsClient(srv2.port, session="cam")
        assert c2.hello()["frame_index"] == 3
        c2.reset()
        assert not os.path.exists(path)  # checkpoint discarded with state
        assert c2.hello()["frame_index"] == 0
        c2.close()
        # close after reset with zero new frames must not resurrect a file
        assert not os.path.exists(path)
    finally:
        srv2.shutdown()


def test_autosave_coalesced_slot_roundtrip(tmp_path):
    """Coalesced daemons autosave per-slot state through the same
    DiPsEngine-compatible checkpoints; a restarted coalesced daemon
    restores the slot."""
    srv, props = _flexible_server(coalesce=2, autosave_dir=str(tmp_path),
                                  autosave_every=2)
    clip = make_clip(n=4, h=16, w=24, seed=9)
    c = DiPsClient(srv.port, session="cam")
    c.process_many(np.stack(clip))
    _wait_autosaves(srv, 1)
    srv.shutdown()

    srv2, _ = _flexible_server(coalesce=2, autosave_dir=str(tmp_path),
                               autosave_every=2)
    try:
        c2 = DiPsClient(srv2.port, session="cam")
        assert c2.hello()["frame_index"] == 4
        out, _ = c2.process_many(np.stack(clip))
        assert out.shape == (4, 16, 24, 3)
        assert srv2.metrics()["autorestores"] == 1
        c2.close()
    finally:
        srv2.shutdown()


def test_autosave_off_by_default(tmp_path):
    """Without autosave_dir nothing is written and counters stay zero."""
    props = _absdiff_props()
    srv = DiPsServer(props, 16, 24, port=0, batch=2, max_sessions=2)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        c = DiPsClient(srv.port, session="cam")
        c.process_many(np.stack(make_clip(n=2, h=16, w=24)))
        c.close()
        m = srv.metrics()
        assert m["autosaves"] == 0 and m["autorestores"] == 0
    finally:
        srv.shutdown()


def test_autosave_corrupt_file_reads_as_fresh(tmp_path):
    """Review regression: a corrupt autosave .npz (disk damage, torn write)
    must NOT brick the token — the pre-bind hello answers fresh and the
    first processed frames overwrite the bad checkpoint."""
    import os

    srv, _ = _flexible_server(autosave_dir=str(tmp_path), autosave_every=2)
    bad = srv._autosave_path("cam")
    with open(bad, "wb") as f:
        f.write(b"not a zipfile at all")
    try:
        c = DiPsClient(srv.port, session="cam")
        assert c.hello()["frame_index"] == 0  # fresh, not an error
        clip = make_clip(n=2, h=16, w=24, seed=21)
        out, _ = c.process_many(np.stack(clip))
        assert out.shape[0] == 2
        _wait_autosaves(srv, 1)  # the good state replaced the corrupt file
        with np.load(bad) as z:
            assert "geometry" in z.files
        c.close()
    finally:
        srv.shutdown()


def test_autosave_token_named_dot_tmp_not_clobbered(tmp_path):
    """Review regression: the old fixed tmp-file scheme made session
    'cam''s autosave tmp path equal session 'cam.tmp''s checkpoint path,
    deterministically deleting the latter on every autosave of the
    former."""
    import os

    props = _absdiff_props()
    clip = make_clip(n=2, h=16, w=24, seed=23)
    srv = DiPsServer(props, 16, 24, port=0, batch=2, max_sessions=2,
                     autosave_dir=str(tmp_path), autosave_every=2)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        c_tmp = DiPsClient(srv.port, session="cam.tmp")
        c_tmp.process_many(np.stack(clip))
        c_tmp.close()
        c = DiPsClient(srv.port, session="cam")
        c.process_many(np.stack(clip))
        c.close()
        assert os.path.exists(srv._autosave_path("cam"))
        assert os.path.exists(srv._autosave_path("cam.tmp"))
        # and no orphaned tmp litter remains after clean writes
        import glob as _glob
        assert not _glob.glob(str(tmp_path / "*#tmp#*"))
    finally:
        srv.shutdown()


def test_autosave_prebind_metrics_and_close_stay_bindfree(tmp_path):
    """Review regression: a monitoring scrape (metrics) or teardown
    (close) with an unbound token must not trigger checkpoint IO, an
    engine build, or a restore on a flexible daemon."""
    srv, _ = _flexible_server(autosave_dir=str(tmp_path), autosave_every=2)
    clip = make_clip(n=2, h=16, w=24, seed=25)
    c = DiPsClient(srv.port, session="cam")
    c.process_many(np.stack(clip))
    _wait_autosaves(srv, 1)
    srv.shutdown()

    srv2, _ = _flexible_server(autosave_dir=str(tmp_path), autosave_every=2)
    try:
        m = DiPsClient(srv2.port, session="cam")
        assert m.metrics()["ok"]
        m.close()
        assert srv2.metrics()["autorestores"] == 0  # stayed bind-free
        # a real hello still restores
        c2 = DiPsClient(srv2.port, session="cam")
        assert c2.hello()["frame_index"] == 2
        c2.close()
        assert srv2.metrics()["autorestores"] == 1
    finally:
        srv2.shutdown()


def test_autosave_due_counter_not_recycled_with_pooled_engine(tmp_path):
    """Review regression: an engine returned to the anonymous pool with
    unsaved frames on its counter must not hand that counter to the next
    session that binds it (premature / frame-0 checkpoints)."""
    props = _absdiff_props()
    srv = DiPsServer(props, 16, 24, port=0, batch=2, max_sessions=2,
                     autosave_dir=str(tmp_path), autosave_every=100)
    try:
        eng = srv._bind_engine(None)
        eng._autosave_due = 7  # unsaved tail from a previous life
        srv._release_engine(eng)
        eng2 = srv._bind_engine("fresh-token")
        assert eng2 is eng  # pooled engine recycled...
        assert getattr(eng2, "_autosave_due", 0) == 0  # ...counter cleared
    finally:
        srv.shutdown()


# ---------------------------------------------------------------------------
# motion events on the serving path (--events)
# ---------------------------------------------------------------------------

def _event_clip(h=16, w=24):
    """Frames: 4 static, 6 moving, 4 static (uncompressed arrays: the
    changed_frac signal is exact)."""
    static = make_clip(n=4, h=h, w=w, seed=3, moving=False)
    moving = make_clip(n=6, h=h, w=w, seed=3, moving=True)
    return np.concatenate([static, moving, static])


def _event_server(**kw):
    from dips.properties import OutputMode
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED,
                           output=OutputMode.ABSDIFF)
    srv = DiPsServer(props, 16, 24, port=0, batch=4, max_sessions=2,
                     events=dict(on_threshold=0.02, metric="changed_frac",
                                 min_frames=2), **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def test_serve_events_annotate_replies_and_metrics():
    srv = _event_server()
    clip = _event_clip()
    try:
        c = DiPsClient(srv.port, session="cam")
        c.process_many(clip[:4])          # static: nothing
        assert c.last_events == [] and not c.event_open
        c.process_many(clip[4:8])         # motion begins: event opens
        assert c.event_open and c.last_events == []
        all_events = []
        c.process_many(clip[8:12])        # motion ends inside this batch
        all_events += c.last_events
        c.process_many(clip[12:14])       # fully static
        all_events += c.last_events
        assert all_events, "event never closed"
        e = all_events[0]
        assert e["start_frame"] == 4 and 9 <= e["end_frame"] <= 10
        assert not c.event_open
        assert srv.metrics()["motion_events"] == 1
        c.close()
    finally:
        srv.shutdown()


def test_serve_events_survive_park_resume_and_reset_clears():
    """A NAMED session's open event survives a reconnect (park/resume);
    an explicit reset discards it."""
    srv = _event_server()
    clip = _event_clip()
    try:
        c = DiPsClient(srv.port, session="cam")
        c.process_many(clip[:8])          # event open at disconnect
        assert c.event_open
        c.close()                          # named: parks WITHOUT flushing
        c2 = DiPsClient(srv.port, session="cam")
        closed = []
        c2.process_many(clip[8:12])        # resumes the SAME open event
        closed += c2.last_events
        c2.process_many(clip[12:14])
        closed += c2.last_events
        assert closed and closed[0]["start_frame"] == 4  # spans the park
        c2.reset()
        c2.process_many(clip[:4])          # fresh segmentation after reset
        assert c2.last_events == [] and not c2.event_open
        c2.close()
    finally:
        srv.shutdown()


def test_serve_events_anonymous_close_flushes():
    srv = _event_server()
    clip = _event_clip()
    try:
        c = DiPsClient(srv.port)           # anonymous
        c.process_many(clip[:8])
        assert c.event_open
        c.close()                          # end of stream: flush
        assert c.last_events and c.last_events[0]["start_frame"] == 4
        assert srv.metrics()["motion_events"] == 1
    finally:
        srv.shutdown()


def test_serve_events_off_by_default():
    props = DiPsProperties(window_size=1, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 16, 24, port=0, batch=2, max_sessions=2)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        c = DiPsClient(srv.port, session="cam")
        c.process_many(np.stack(make_clip(n=2, h=16, w=24)))
        assert c.last_events == [] and not c.event_open
        assert srv.metrics()["motion_events"] == 0
        c.close()
    finally:
        srv.shutdown()


def test_serve_events_coalesced_per_slot():
    """Coalesced daemon: each slot segments ITS OWN stream — one moving
    camera must not open events on an idle sibling."""
    from dips.properties import OutputMode
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED,
                           output=OutputMode.ABSDIFF)
    srv = DiPsServer(props, 16, 24, port=0, batch=1, coalesce=2,
                     events=dict(on_threshold=0.02, metric="changed_frac",
                                 min_frames=2))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    clip = _event_clip()
    static = make_clip(n=14, h=16, w=24, seed=3, moving=False)
    try:
        a = DiPsClient(srv.port, session="moving-cam")
        b = DiPsClient(srv.port, session="idle-cam")
        opened = False
        for i in range(14):
            a.process(clip[i])
            opened = opened or a.event_open
            b.process(static[i])
            assert not b.event_open and b.last_events == []
        assert opened
        a.close(); b.close()
        assert srv.metrics()["motion_events"] >= 1
    finally:
        srv.shutdown()


def test_serve_events_resilient_client_passthrough():
    """ResilientDiPsClient surfaces event annotations and an open event
    survives its reconnect (the parked session carries the detector)."""
    from dips.serve import ResilientDiPsClient
    from dips.errors import ReplyLost
    srv = _event_server()
    clip = _event_clip()
    try:
        c = ResilientDiPsClient(srv.port, session="cam", retries=3,
                                backoff_s=0.05)
        c.process_many(clip[:8])
        assert c.event_open and c.last_events == []
        # dead link mid-event: reconnect resumes the same open event
        c._cli._sock.close()
        closed = []
        try:
            c.process_many(clip[8:12])
        except ReplyLost:
            pass
        closed += c.last_events
        c.process_many(clip[12:14])
        closed += c.last_events
        assert closed and closed[0]["start_frame"] == 4
        c.close()
    finally:
        srv.shutdown()


def test_combined_feature_stress_events_autosave_restart(tmp_path):
    """The full production stack at once: an --events + --autosave daemon
    serving resilient clients under random RSTs, then a daemon CRASH and
    restart mid-fleet.  Every cursor must stay exactly-once consistent,
    every camera's motion must be flagged, and restored sessions must
    resume their autosaved cursor (never fresh)."""
    import random
    import socket as sk
    import struct

    from dips.errors import ReplyLost
    from dips.properties import OutputMode
    from dips.serve import ResilientDiPsClient

    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED,
                           output=OutputMode.ABSDIFF)

    def start(port=0):
        s = DiPsServer(props, 16, 24, port=port, batch=2, max_sessions=6,
                       autosave_dir=str(tmp_path), autosave_every=2,
                       events=dict(on_threshold=0.02,
                                   metric="changed_frac", min_frames=2))
        threading.Thread(target=s.serve_forever, daemon=True).start()
        return s

    srv = start()
    port = srv.port
    n_clients, n_frames = 6, 16
    restart_gate = threading.Barrier(n_clients + 1)
    results, failures = {}, []

    def cam(k):
        rng = random.Random(100 + k)
        clip = np.concatenate([
            make_clip(n=6, h=16, w=24, seed=k, moving=False),
            make_clip(n=6, h=16, w=24, seed=k, moving=True),
            make_clip(n=4, h=16, w=24, seed=k, moving=False)])
        try:
            c = ResilientDiPsClient(port, session=f"cam{k}",
                                    backoff_s=0.05, retries=20)
            saw_motion, done = False, 0
            for i, f in enumerate(clip):
                if i == 8:
                    restart_gate.wait(timeout=60)  # daemon crash point
                if rng.random() < 0.2:
                    c._cli._sock.setsockopt(
                        sk.SOL_SOCKET, sk.SO_LINGER,
                        struct.pack("ii", 1, 0))
                    c._cli._sock.close()
                try:
                    c.process(f)
                    saw_motion = saw_motion or c.event_open or bool(
                        c.last_events)
                except ReplyLost:
                    pass  # accounted server-side
                done += 1
            fi = c.hello()["frame_index"]
            results[k] = (fi, done, saw_motion)
            c.close()
        except Exception as e:
            failures.append(f"cam {k}: {e!r}")

    th = [threading.Thread(target=cam, args=(k,))
          for k in range(n_clients)]
    for t in th:
        t.start()
    restart_gate.wait(timeout=60)
    # simulate a crash: no graceful close of parked/live sessions
    srv.shutdown()
    srv2 = start(port=port)  # same port: the fleet's reconnects land here
    for t in th:
        t.join(timeout=120)
    try:
        assert not failures, failures
        assert len(results) == n_clients
        for k, (fi, done, saw_motion) in results.items():
            assert done == n_frames, (k, results[k])
            # crash semantics: the restart restores the last autosave, so
            # a session may lose at most autosave_every(=2) frames of
            # cursor (never more, never resumes fresh at 0)
            assert n_frames - 2 <= fi <= n_frames, (k, results[k])
            assert saw_motion, f"cam{k} never saw its motion flagged"
        m = srv2.metrics()
        assert m["autorestores"] >= 1  # the restart restored from disk
    finally:
        srv2.shutdown()


def test_autosave_tmp_sweep_spares_inflight_files(tmp_path):
    """Startup sweeps only OLD orphaned tmp files: a fast restart must
    not delete the previous daemon's in-flight autosave tmp."""
    import os
    import time as _time

    old = tmp_path / "cam.#tmp#aaaa.npz"
    fresh = tmp_path / "cam.#tmp#bbbb.npz"
    for p in (old, fresh):
        p.write_bytes(b"x")
    past = _time.time() - 300
    os.utime(old, (past, past))
    srv = DiPsServer(_absdiff_props(), 16, 24, port=0,
                     autosave_dir=str(tmp_path))
    try:
        assert not old.exists()    # orphan from a crash: swept
        assert fresh.exists()      # possibly in-flight: spared
    finally:
        srv.shutdown()


def test_per_session_roi():
    """Each session binds its own analysis region: stats normalize over
    the roi area, the quiet-region session reports ~no change, hello
    echoes the roi, and a parked named session refuses a different roi
    until reset."""
    from dips.ops.oracle import DiPsOracle
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 24, 40, port=0, batch=1, max_sessions=4)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        clip = make_clip(n=6, h=24, w=40, seed=2)  # square roams mid-frame
        roi_hot = (0, 0, 24, 40)
        roi_quiet = (0, 0, 2, 40)   # the moving square never enters
        with DiPsClient(srv.port, session="hot", roi=roi_hot) as hot, \
                DiPsClient(srv.port, session="quiet",
                           roi=roi_quiet) as quiet:
            assert hot.hello()["config"]["roi"] == list(roi_hot)
            assert quiet.hello()["config"]["roi"] == list(roi_quiet)
            s_hot, s_quiet = [], []
            for f in clip:
                _, sh = hot.process(f)
                _, sq = quiet.process(f)
                s_hot.append(sh)
                s_quiet.append(sq)
            s_hot, s_quiet = np.array(s_hot), np.array(s_quiet)
            # the quiet strip sees (almost) none of the square's motion
            assert s_hot[1:, 3].max() > 0
            assert s_quiet[1:, 3].max() <= s_hot[1:, 3].max() / 4
            # parity with an oracle configured the same way
            o = DiPsOracle(props.with_roi(roi_quiet))
            _, exp = o.run(clip)
            np.testing.assert_allclose(s_quiet[:, :3], exp[:, :3],
                                       atol=1e-5)
        # a parked named session refuses to resume under a DIFFERENT roi
        with DiPsClient(srv.port, session="hot", roi=roi_quiet) as again:
            with pytest.raises(RuntimeError, match="parked with roi"):
                again.process(clip[0])
        # ...but resumes fine under the same one, state intact
        with DiPsClient(srv.port, session="hot", roi=roi_hot) as same:
            assert same.hello()["frame_index"] == len(clip)
        # a malformed roi is a per-request error, not a dropped connection
        with DiPsClient(srv.port) as bad:
            bad.roi = (1, 2, 3)
            with pytest.raises(RuntimeError, match="bad roi"):
                bad.process(clip[0])
            bad.roi = (0, 0, 99, 99)  # exceeds the daemon geometry
            with pytest.raises(RuntimeError, match="roi"):
                bad.process(clip[0])
    finally:
        srv.shutdown()


def test_per_session_roi_rejected_when_coalescing():
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 16, 24, port=0, batch=1, coalesce=2)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        with DiPsClient(srv.port, roi=(0, 0, 8, 8)) as cli:
            with pytest.raises(RuntimeError, match="coalescing"):
                cli.process(np.zeros((16, 24, 3), np.uint8))
    finally:
        srv.shutdown()


def test_roi_session_engine_never_pooled():
    """An anonymous roi'd session's engine must not re-surface for the
    next anonymous client (the pool's contract is the daemon's props)."""
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 16, 24, port=0, batch=1, max_sessions=2)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        f = np.zeros((16, 24, 3), np.uint8)
        with DiPsClient(srv.port, roi=(0, 0, 4, 4)) as a:
            a.process(f)
        with DiPsClient(srv.port) as b:  # plain anonymous session
            b.process(f)
            assert b.hello()["config"]["roi"] is None
        with srv._pool_lock:
            pooled = list(srv._pool)
        assert all(e.props.roi is None for e in pooled)
    finally:
        srv.shutdown()


def _blink_frames(n, h, w, fps, hz, y=slice(2, 6), x=slice(3, 9), seed=0):
    import math
    r = np.random.default_rng(seed)
    base = r.integers(90, 110, (h, w, 3)).astype(np.float32)
    out = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        f = base.copy()
        f[y, x] += 80.0 * math.cos(2 * math.pi * hz * i / fps)
        out[i] = np.clip(np.rint(f), 0, 255).astype(np.uint8)
    return out


def test_per_session_flicker():
    """Sessions opt into server-side flicker analysis; the map localizes
    the blinking region, parks/resumes with the named session, resets on
    reset, and parameter misuse is a per-request error."""
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 16, 24, port=0, batch=1, max_sessions=4)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        fps, hz = 24.0, 6.0
        frames = _blink_frames(48, 16, 24, fps, hz)
        with DiPsClient(srv.port, session="cam", flicker_hz=hz,
                        flicker_fps=fps) as cli:
            for f in frames[:30]:
                cli.process(f)
            amp, meta = cli.flicker()
            assert meta["frames"] == 30 and meta["freq_hz"] == hz
            assert amp.shape == (16, 24)
        # parked + resumed: the window continues (frames accumulate)
        with DiPsClient(srv.port, session="cam", flicker_hz=hz,
                        flicker_fps=fps) as cli:
            for f in frames[30:]:
                cli.process(f)
            amp, meta = cli.flicker()
            assert meta["frames"] == len(frames)
            inside = amp[2:6, 3:9].mean()
            outside = np.delete(
                amp.reshape(-1),
                np.ravel_multi_index(np.mgrid[2:6, 3:9].reshape(2, -1),
                                     amp.shape)).mean()
            assert inside > 5 * outside, (inside, outside)
            # reset drops the window; the next request re-binds it fresh
            cli.reset()
            cli.process(frames[0])
            _, meta = cli.flicker()
            assert meta["frames"] == 1
            # a parameter change without reset is a per-request error
            cli.flicker_hz = 3.0
            with pytest.raises(RuntimeError, match="reset"):
                cli.process(frames[1])
        # misuse: fps without hz / no analyzer bound / hz over Nyquist
        with DiPsClient(srv.port) as c2:
            with pytest.raises(RuntimeError, match="flicker"):
                c2.flicker()
            c2.flicker_fps = 24.0
            with pytest.raises(RuntimeError, match="flicker_hz"):
                c2.process(frames[0])
        with DiPsClient(srv.port, flicker_hz=50.0,
                        flicker_fps=24.0) as c3:
            with pytest.raises(RuntimeError, match="resolvable"):
                c3.process(frames[0])
    finally:
        srv.shutdown()


def test_flicker_on_coalesced_session():
    """Flicker is a separate per-session device stream, so unlike roi it
    works on coalescing daemons too."""
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 16, 24, port=0, batch=1, coalesce=2)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        fps, hz = 24.0, 6.0
        frames = _blink_frames(24, 16, 24, fps, hz)
        with DiPsClient(srv.port, session="cam", flicker_hz=hz,
                        flicker_fps=fps) as cli:
            for f in frames:
                cli.process(f)
            amp, meta = cli.flicker()
            assert meta["frames"] == len(frames)
            assert amp[2:6, 3:9].mean() > amp[10:, 12:].mean()
    finally:
        srv.shutdown()


def test_serve_main_oversized_roi_is_friendly(capsys):
    """serve.main with an --roi larger than the fixed geometry: rc 2 +
    message, not a traceback out of DiPsServer.__init__."""
    from dips.serve import main as serve_main
    rc = serve_main(["--height", "24", "--width", "40", "--port", "0",
                     "--roi", "0,0,99,99"])
    assert rc == 2 and "roi" in capsys.readouterr().err


def test_resilient_client_flicker_passthrough():
    """The fleet edge client rebinds the flicker window on reconnect."""
    from dips.serve import ResilientDiPsClient
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 16, 24, port=0, batch=1, max_sessions=2)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        fps, hz = 24.0, 6.0
        frames = _blink_frames(20, 16, 24, fps, hz)
        cli = ResilientDiPsClient(srv.port, session="edge",
                                  flicker_hz=hz, flicker_fps=fps,
                                  backoff_s=0.05)
        for f in frames[:10]:
            cli.process(f)
        # simulated dead link: the resilient client redials and the next
        # request re-binds the analyzer onto the resumed session
        cli._cli._sock.close()
        for f in frames[10:]:
            cli.process(f)
        amp, meta = cli._cli.flicker()
        assert meta["frames"] == len(frames)
        assert amp.shape == (16, 24)
    finally:
        srv.shutdown()


def test_serve_downscale_daemon():
    """A --downscale daemon accepts full-res frames and replies at the
    analysis geometry, matching a local downscale engine bit-for-bit;
    flexible + fixed modes and the pooled-engine geometry keys agree."""
    props = DiPsProperties(window_size=3, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 32, 48, port=0, batch=2, downscale=2)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        clip = make_clip(n=4, h=32, w=48, seed=5)
        cli = DiPsClient(srv.port)
        info = cli.hello()
        cfg = info["config"]
        assert (cfg["height"], cfg["width"]) == (16, 24)
        assert (cfg["input_height"], cfg["input_width"]) == (32, 48)
        assert cfg["downscale"] == 2
        outs, stats = cli.process_many(np.stack(clip[:2]))
        assert outs.shape == (2, 16, 24, 3)
        o2, s2 = cli.process_many(np.stack(clip[2:]))
        cli.close()
        eng = DiPsEngine(props, 32, 48, batch=2, downscale=2)
        exp_out, exp_stats = eng.process_frames(list(clip))
        np.testing.assert_array_equal(
            np.concatenate([outs, o2]), exp_out)
        np.testing.assert_allclose(
            np.concatenate([stats, s2]), exp_stats, atol=1e-6)
    finally:
        srv.shutdown()


def test_serve_downscale_flexible_pool_and_checkpoint(tmp_path):
    """Flexible downscale daemon: sessions sized from full-res first
    frames, pooled by INPUT geometry, checkpoints (analysis dims) load
    back with the x-k geometry peek."""
    props = DiPsProperties(window_size=1, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, None, None, port=0, batch=1, downscale=2,
                     max_sessions=2)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        clip = make_clip(n=3, h=16, w=32, seed=7)
        path = str(tmp_path / "sess.npz")
        with DiPsClient(srv.port) as cli:
            o, _ = cli.process(clip[0])
            assert o.shape == (8, 16, 3)
            cli.save(path)   # checkpoint at analysis dims (8, 16)
        # a fresh session restores from the checkpoint: the daemon must
        # size the engine from the peeked geometry x k
        with DiPsClient(srv.port) as cli2:
            fi = cli2.load(path)
            assert fi == 1
            o2, _ = cli2.process(clip[1])
            assert o2.shape == (8, 16, 3)
        with srv._pool_lock:
            assert list(srv._pool) == [(16, 32)]  # input-geometry keys
    finally:
        srv.shutdown()


def test_coalesced_mesh_row_sharded_sessions():
    """--coalesce-mesh SxR: coalesced slots on a 2-D (stream x rows)
    grid — the big-frame serving shape.  Two clients
    on a (2 x 4) grid must each get exactly what a dedicated
    single-stream engine computes (row sharding is pure layout)."""
    srv, props = _coalesced_server(2, h=32, w=40, coalesce_mesh=(2, 4))
    try:
        clips = [make_clip(n=4, h=32, w=40, seed=80 + i) for i in range(2)]
        results = [None] * 2

        def run(i):
            cli = DiPsClient(srv.port)
            assert cli.hello()["config"]["coalesced"] is True
            assert cli.metrics()["coalesce_mesh"] == "2x4"
            outs, stats = [], []
            for f in clips[i]:
                o, s = cli.process(f)
                outs.append(o)
                stats.append(s)
            cli.close()
            results[i] = (np.stack(outs), np.stack(stats))

        ts = [threading.Thread(target=run, args=(i,)) for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        for i in range(2):
            assert results[i] is not None, f"client {i} did not finish"
            eng = DiPsEngine(props, 32, 40, batch=1)
            exp_out, exp_stats = eng.process_frames(list(clips[i]))
            np.testing.assert_array_equal(results[i][0], exp_out)
            np.testing.assert_allclose(results[i][1], exp_stats, atol=1e-6)
    finally:
        srv.shutdown()


def test_daemon_coalesce_mesh_flag_validation(capsys):
    """--coalesce-mesh parse errors and the --coalesce-devices conflict
    fail at startup, not at first request."""
    from dips.serve.daemon import main as serve_main
    rc = serve_main(["--coalesce", "2", "--coalesce-mesh", "oops",
                     "--height", "32", "--width", "40"])
    assert rc == 2
    rc = serve_main(["--coalesce", "2", "--coalesce-mesh", "1x4",
                     "--coalesce-devices", "2",
                     "--height", "32", "--width", "40"])
    assert rc == 2
    # without --coalesce there are no slots to shard: fail at startup
    # instead of silently serving per-session on one chip
    rc = serve_main(["--coalesce-mesh", "1x4",
                     "--height", "32", "--width", "40"])
    assert rc == 2
    # non-positive axes are a parse error
    rc = serve_main(["--coalesce", "2", "--coalesce-mesh", "0x4",
                     "--height", "32", "--width", "40"])
    assert rc == 2


def test_flexible_daemon_coalesce_mesh():
    """A geometry-FLEXIBLE daemon with --coalesce-mesh builds each
    geometry's coalescer on the 2-D grid: a session sized from its first
    frame gets row-sharded slots and still matches a dedicated engine."""
    props = DiPsProperties(window_size=3, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, port=0, batch=2, coalesce=2,
                     coalesce_mesh=(2, 4))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        clip = make_clip(n=4, h=32, w=40, seed=33)
        cli = DiPsClient(srv.port)
        outs = [cli.process(f)[0] for f in clip]
        cli.close()
        eng = DiPsEngine(props, 32, 40, batch=1)
        exp, _ = eng.process_frames(list(clip))
        np.testing.assert_array_equal(np.stack(outs), exp)
    finally:
        srv.shutdown()
