"""Webhook alert delivery: WebhookSender unit tests + --event-webhook
integration against a real in-process HTTP receiver.

The reference has no alerting surface at all (SURVEY §5 "failure
detection: absent"); these pin the rebuild's fleet-alert path:
serve.py motion events -> utils/webhook.py -> HTTP POST.
"""

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from dips.properties import DiPsFilter, DiPsProperties, OutputMode
from dips.serve import DiPsClient, DiPsServer
from dips.utils.webhook import WebhookSender
from tests.conftest import make_clip


class _Receiver:
    """Minimal threaded HTTP receiver recording every JSON POST body.

    ``status`` can be changed mid-test to simulate a failing endpoint.
    """

    def __init__(self, status=200):
        self.bodies = []
        self.hits = 0
        self.status = status
        recv = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802 — http.server API
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n)
                recv.hits += 1
                if 200 <= recv.status < 300:
                    recv.bodies.append(json.loads(raw))
                self.send_response(recv.status)
                self.end_headers()

            def log_message(self, *a):  # silence stderr chatter
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_port}/alerts"
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def wait(self, n, timeout=5.0, attr="bodies"):
        deadline = time.time() + timeout
        while time.time() < deadline:
            got = getattr(self, attr)
            cur = got if isinstance(got, int) else len(got)
            if cur >= n:
                return
            time.sleep(0.01)
        raise AssertionError(
            f"receiver saw {getattr(self, attr)} after {timeout}s, "
            f"wanted {n} {attr}")

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.fixture()
def receiver():
    r = _Receiver()
    yield r
    r.close()


# ---------------------------------------------------------------------------
# WebhookSender unit behavior
# ---------------------------------------------------------------------------

def test_sender_delivers_json(receiver):
    outcomes = []
    s = WebhookSender(receiver.url, on_result=outcomes.append)
    assert s.post({"hello": 1})
    receiver.wait(1)
    s.close()
    assert receiver.bodies == [{"hello": 1}]
    assert outcomes == ["delivered"]


def test_sender_rejects_non_http_url():
    with pytest.raises(ValueError, match="http"):
        WebhookSender("ftp://example.com/x")
    with pytest.raises(ValueError, match="http"):
        WebhookSender("/not/a/url")


def test_sender_retries_then_counts_failed():
    recv = _Receiver(status=500)
    outcomes = []
    try:
        s = WebhookSender(recv.url, retries=2, backoff_s=0.01,
                          timeout_s=2.0, on_result=outcomes.append)
        s.post({"x": 1})
        recv.wait(3, attr="hits")          # initial try + 2 retries
        s.close()
        assert recv.hits == 3
        assert outcomes == ["failed"]
    finally:
        recv.close()


def test_sender_recovers_midway_through_retries():
    recv = _Receiver(status=503)
    outcomes = []
    try:
        s = WebhookSender(recv.url, retries=3, backoff_s=0.05,
                          timeout_s=2.0, on_result=outcomes.append)
        s.post({"x": 2})
        recv.wait(1, attr="hits")
        recv.status = 200                  # endpoint comes back
        recv.wait(1)                       # a retry lands the body
        s.close()
        assert outcomes == ["delivered"]
        assert recv.bodies == [{"x": 2}]
    finally:
        recv.close()


def test_sender_unreachable_host_counts_failed():
    outcomes = []
    # bind-then-close: the port is guaranteed closed now
    import socket
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    s = WebhookSender(f"http://127.0.0.1:{port}/x", retries=1,
                      backoff_s=0.01, timeout_s=0.5,
                      on_result=outcomes.append)
    s.post({"x": 3})
    deadline = time.time() + 5
    while not outcomes and time.time() < deadline:
        time.sleep(0.01)
    s.close()
    assert outcomes == ["failed"]


def test_sender_bounded_queue_drops_and_counts(receiver):
    outcomes = []
    s = WebhookSender(receiver.url, queue_max=1, on_result=outcomes.append)
    # stall the worker so the queue stays full: post a payload to a slow
    # endpoint first?  Simpler: close the worker's view by flooding faster
    # than one tiny HTTP round-trip can drain.
    dropped = 0
    for i in range(200):
        if not s.post({"i": i}):
            dropped += 1
    s.close(flush_timeout_s=5.0)
    assert dropped >= 1
    assert outcomes.count("dropped") == dropped
    # everything not dropped was eventually delivered or failed, no limbo
    assert outcomes.count("delivered") + outcomes.count("failed") \
        == 200 - dropped


def test_sender_post_after_close_drops(receiver):
    outcomes = []
    s = WebhookSender(receiver.url, on_result=outcomes.append)
    s.close()
    assert not s.post({"late": True})
    assert outcomes == ["dropped"]


def test_sender_close_flushes_backlog(receiver):
    s = WebhookSender(receiver.url)
    for i in range(8):
        s.post({"i": i})
    s.close(flush_timeout_s=10.0)
    assert [b["i"] for b in receiver.bodies] == list(range(8))


def test_sender_close_does_not_hang_on_dead_receiver():
    """A dead endpoint must not hold close() past its flush timeout."""
    import socket
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    outcomes = []
    s = WebhookSender(f"http://127.0.0.1:{port}/x", retries=5,
                      backoff_s=0.5, timeout_s=5.0,
                      on_result=outcomes.append)
    for i in range(50):
        s.post({"i": i})
    t0 = time.time()
    s.close(flush_timeout_s=0.5)
    assert time.time() - t0 < 3.0
    # close() must also STOP the worker: no retry backoffs or deliveries
    # may outlive it (they used to log warnings minutes after shutdown).
    deadline = time.time() + 2.0
    while s._thread.is_alive() and time.time() < deadline:
        time.sleep(0.02)
    assert not s._thread.is_alive()
    # every queued alert reached a terminal outcome — failed (connection
    # refused is instant) or dropped at abort — none left in limbo.
    assert outcomes.count("failed") + outcomes.count("dropped") == 50


# ---------------------------------------------------------------------------
# serve.py integration (--events --event-webhook)
# ---------------------------------------------------------------------------

def _event_clip(h=16, w=24):
    static = make_clip(n=4, h=h, w=w, seed=3, moving=False)
    moving = make_clip(n=6, h=h, w=w, seed=3, moving=True)
    return np.concatenate([static, moving, static])


def _event_server(**kw):
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED,
                           output=OutputMode.ABSDIFF)
    srv = DiPsServer(props, 16, 24, port=0, batch=4, max_sessions=2,
                     events=dict(on_threshold=0.02, metric="changed_frac",
                                 min_frames=2), **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def test_serve_webhook_posts_closed_events(receiver):
    srv = _event_server(event_webhook=receiver.url)
    clip = _event_clip()
    try:
        c = DiPsClient(srv.port, session="cam")
        for i in range(0, 14, 4):
            c.process_many(clip[i:i + 4])
        receiver.wait(1)
        c.close()
        alert = receiver.bodies[0]
        assert alert["type"] == "motion_event"
        assert alert["session"] == "cam"
        assert alert["geometry"] == "16x24"
        assert alert["port"] == srv.port
        assert alert["event"]["start_frame"] == 4
        assert 9 <= alert["event"]["end_frame"] <= 10
        # webhook delivery outcome surfaces in the daemon metrics
        deadline = time.time() + 5
        while srv.metrics()["webhook_delivered"] < 1 \
                and time.time() < deadline:
            time.sleep(0.01)
        m = srv.metrics()
        assert m["webhook_delivered"] == 1
        assert m["webhook_failed"] == 0 and m["webhook_dropped"] == 0
    finally:
        srv.shutdown()


def test_serve_webhook_anonymous_close_flush_posts(receiver):
    srv = _event_server(event_webhook=receiver.url)
    clip = _event_clip()
    try:
        c = DiPsClient(srv.port)           # anonymous
        c.process_many(clip[:8])           # event open at close
        c.close()                          # flush posts the alert
        receiver.wait(1)
        assert receiver.bodies[0]["event"]["start_frame"] == 4
        assert receiver.bodies[0]["session"] is None
    finally:
        srv.shutdown()


def test_serve_webhook_dead_receiver_does_not_block_sessions():
    """Sessions keep flowing at full speed while the alert endpoint is
    down; failures land in metrics, shutdown stays prompt."""
    import socket
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    srv = _event_server(event_webhook=f"http://127.0.0.1:{port}/x")
    srv._webhook.retries = 0
    srv._webhook.timeout_s = 0.3
    clip = _event_clip()
    try:
        c = DiPsClient(srv.port, session="cam")
        t0 = time.time()
        for i in range(0, 14, 4):
            c.process_many(clip[i:i + 4])
        assert time.time() - t0 < 10.0     # processing never waited on HTTP
        c.close()
        deadline = time.time() + 5
        while srv.metrics()["webhook_failed"] < 1 and time.time() < deadline:
            time.sleep(0.01)
        assert srv.metrics()["webhook_failed"] >= 1
    finally:
        t0 = time.time()
        srv.shutdown()
        assert time.time() - t0 < 5.0


def test_serve_webhook_requires_events():
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    with pytest.raises(ValueError, match="event_webhook requires events"):
        DiPsServer(props, 16, 24, port=0, event_webhook="http://x/y")


def test_serve_webhook_cli_requires_events_flag(capsys):
    from dips.serve import main
    rc = main(["--port", "0", "--height", "16", "--width", "24",
               "--event-webhook", "http://127.0.0.1:9/x"])
    assert rc == 2
    assert "--events" in capsys.readouterr().err


def test_serve_webhook_counters_in_prometheus_text():
    from dips.serve import _prometheus_text
    srv = _event_server()
    try:
        text = _prometheus_text(srv.metrics())
        for name in ("webhook_delivered", "webhook_failed",
                     "webhook_dropped"):
            assert f"dips_{name}" in text
    finally:
        srv.shutdown()
