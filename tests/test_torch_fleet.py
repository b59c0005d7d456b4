"""The port's serving fleet control plane on the CPU: the reference's
unit cases of ``tests/test_fleet.py`` on the port's classes — autoscaler
policies, the router against fake backends (relay, retry, health, SSE
pin and relay, mid-stream failover splice, breaker, deadline), the
controller over a fake replica command (spawn, crash budget, drain,
rollout), durability (journal, leases, adoption, split-brain),
``checkpoint.modeldir`` and the fleet report — plus what the port adds:

- real port replicas (``python -m paddle_tpu_torch.serving.replica
  --device cpu``) spawned by the controller behind its router; the
  replica raises without a card unless given ``--device cpu``;
- replicas given one ``--gpt-decode`` spec hold bit-identical
  parameters in every process;
- the kernel build's file lock: two processes building one library run
  the compiler once;
- the port's closed-loop probe, ``python -m
  paddle_tpu_torch.tools.fleet_probe --fast --device cpu``, as a
  subprocess.

The router and autoscaler are tested against FAKE backends / metrics
sources — dead sockets, 503 readiness, mid-stream deaths, synthetic
pressure — independent of real replica subprocesses; the controller is
tested over a lightweight fake replica command (no torch import per
replica), and the full stack runs inside the probe."""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from paddle_tpu_torch.checkpoint import modeldir
from paddle_tpu_torch.observability import aggregate
from paddle_tpu_torch.observability import registry as obs_registry
from paddle_tpu_torch.serving import fleet as fleet_mod
from paddle_tpu_torch.serving.fleet import (
    AutoscalerPolicy,
    FleetController,
)
from paddle_tpu_torch.serving.router import Router
# one copy of the HTTP helpers across probes and tests
from paddle_tpu_torch.tools.fleet_probe import _post, _sse_collect
from test_torch_cpu_math import pin_vector_math

pin_vector_math(2)  # 2 threads, vector math set up on one (see there)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# autoscaler policy: decisions against a fake metrics source
# ---------------------------------------------------------------------------
def _policy(**kw):
    base = dict(min_replicas=1, max_replicas=4, queue_high=4.0,
                queue_low=1.0, up_ticks=2, down_ticks=4,
                latency_high_ms=0.0)
    base.update(kw)
    return AutoscalerPolicy(**base)


def _q(depth, n=2):
    return [{"queue_depth": depth, "shed_delta": 0, "p95_ms": None}
            for _ in range(n)]


class TestAutoscalerPolicy:
    def test_scale_up_needs_sustained_pressure(self):
        p = _policy()
        target, reason = p.observe(_q(10), 2)
        assert (target, reason) == (2, None)  # one pressured tick: hold
        target, reason = p.observe(_q(10), 2)
        assert (target, reason) == (3, "queue_pressure")

    def test_single_spike_does_not_scale(self):
        p = _policy()
        assert p.observe(_q(10), 2) == (2, None)
        # the spike ends; an idle round resets the streak
        assert p.observe(_q(0), 2) == (2, None)
        assert p.observe(_q(10), 2) == (2, None)

    def test_sheds_count_as_pressure_without_queue(self):
        p = _policy()
        s = [{"queue_depth": 0, "shed_delta": 5, "p95_ms": None}]
        p.observe(s, 2)
        assert p.observe(s, 2) == (3, "queue_pressure")

    def test_latency_pressure_opt_in(self):
        p = _policy(latency_high_ms=100.0)
        s = [{"queue_depth": 0, "shed_delta": 0, "p95_ms": 250.0}]
        p.observe(s, 1)
        assert p.observe(s, 1) == (2, "queue_pressure")
        # disabled (0.0): the same latency is not pressure
        p2 = _policy()
        p2.observe(s, 1)
        assert p2.observe(s, 1) == (1, None)

    def test_scale_down_hysteresis_no_flap(self):
        p = _policy()
        for _ in range(3):
            assert p.observe(_q(0), 3) == (3, None)  # < down_ticks: hold
        assert p.observe(_q(0), 3) == (2, "idle")
        # streak reset after acting: the next idle round does not
        # immediately drop again (no flap straight to the floor)
        assert p.observe(_q(0), 2) == (2, None)

    def test_middle_band_holds_both_streaks(self):
        p = _policy()
        p.observe(_q(10), 2)          # one pressured tick
        p.observe(_q(2), 2)           # middle band: streak survives
        assert p.observe(_q(10), 2) == (3, "queue_pressure")

    def test_clamps_min_max(self):
        p = _policy(min_replicas=2, max_replicas=3)
        for _ in range(10):
            t, _r = p.observe(_q(100), 3)
            assert t == 3  # never past max
        p2 = _policy(min_replicas=2, max_replicas=3)
        for _ in range(20):
            t, _r = p2.observe(_q(0), 2)
            assert t == 2  # never below min
        # an out-of-band target clamps even with no decision
        assert p2.observe([], 7) == (3, None)

    def test_empty_sample_round_resets_streaks(self):
        p = _policy()
        p.observe(_q(10), 2)
        p.observe([], 2)  # nothing ready to scrape
        assert p.observe(_q(10), 2) == (2, None)


# ---------------------------------------------------------------------------
# fake replica gateway for router tests
# ---------------------------------------------------------------------------
def _fake_backend(backend_id, version=1, ready=True, tokens=(1, 2, 3),
                  die_after=None, stall_after=None, stall_s=1.0,
                  infer_status=200, gen_status=200):
    """A stub replica gateway: /readyz (togglable), /v1/infer (echoes
    its id/version and the FORWARDED deadline), /v1/generate (SSE over
    ``tokens``, honoring the resume form — ``resume_tokens`` slices the
    already-emitted prefix off, like a real engine's token-exact
    resume; optionally dies mid-stream after ``die_after`` tokens of a
    request, or stalls ``stall_s`` after ``stall_after`` tokens).
    Every POST body lands in ``state["bodies"]``."""
    state = {"ready": ready, "die_after": die_after,
             "stall_after": stall_after, "stall_s": stall_s,
             "infer_status": infer_status, "gen_status": gen_status,
             "hits": 0, "bodies": []}

    class _H(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def _json(self, code, obj, headers=()):
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.send_header("X-Replica-Id", backend_id)
            self.send_header("X-Model-Version", str(version))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/readyz":
                if state["ready"]:
                    self._json(200, {"status": "ready"})
                else:
                    self._json(503, {"status": "draining"})
            else:
                self._json(404, {"error": "nf"})

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n)) if n else {}
            state["hits"] += 1
            state["bodies"].append(body)
            if self.path == "/v1/infer":
                if state["infer_status"] != 200:
                    self._json(state["infer_status"],
                               {"error": "nope"},
                               headers=(("Retry-After", "1"),))
                    return
                self._json(200, {"backend": backend_id,
                                 "version": version,
                                 "echo": body.get("inputs"),
                                 "deadline": body.get("deadline_ms"),
                                 "tenant": self.headers.get(
                                     "X-Tenant-Id")})
            elif self.path == "/v1/generate":
                if state["gen_status"] != 200:
                    self._json(state["gen_status"], {"error": "busy"},
                               headers=(("Retry-After", "1"),))
                    return
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Transfer-Encoding", "chunked")
                self.send_header("X-Model-Version", str(version))
                self.end_headers()

                def chunk(text):
                    data = text.encode()
                    self.wfile.write(b"%x\r\n" % len(data))
                    self.wfile.write(data)
                    self.wfile.write(b"\r\n")
                    self.wfile.flush()

                resume = body.get("resume_tokens") or []
                send = list(tokens)[len(resume):]
                for i, t in enumerate(send):
                    if state["die_after"] is not None \
                            and i >= state["die_after"]:
                        # abrupt death mid-stream: RST (SO_LINGER 0),
                        # like a SIGKILLed process — a plain close()
                        # would leave the makefile dup holding the
                        # connection open and read as a client timeout
                        import socket as _socket
                        import struct as _struct

                        self.connection.setsockopt(
                            _socket.SOL_SOCKET, _socket.SO_LINGER,
                            _struct.pack("ii", 1, 0),
                        )
                        # break the keep-alive loop so finish() closes
                        # the makefile dups NOW — the RST fires when
                        # the last fd referencing the socket closes
                        self.close_connection = True
                        return
                    if state["stall_after"] is not None \
                            and i >= state["stall_after"]:
                        time.sleep(state["stall_s"])
                    chunk('data: {"token": %d}\n\n' % t)
                    time.sleep(0.01)
                if state["die_after"] is not None \
                        and len(send) >= state["die_after"]:
                    # die_after >= the tokens sent: death in the GAP
                    # between the last token frame and the done frame
                    # (exactly where chaos die_after_tokens kills)
                    import socket as _socket
                    import struct as _struct

                    self.connection.setsockopt(
                        _socket.SOL_SOCKET, _socket.SO_LINGER,
                        _struct.pack("ii", 1, 0),
                    )
                    self.close_connection = True
                    return
                chunk('data: {"done": true, "finish_reason": "length"}'
                      '\n\n')
                self.wfile.write(b"0\r\n\r\n")
                self.wfile.flush()
            else:
                self._json(404, {"error": "nf"})

    srv = ThreadingHTTPServer(("127.0.0.1", 0), _H)
    srv.daemon_threads = True
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    srv.state = state
    srv.backend_id = backend_id
    return srv




def _sse_full(url, body, timeout=30):
    """SSE including comment frames (":"-prefixed — the router's
    failover seam): one parser copy, owned by fleet_probe (same
    sharing contract as ``_post``). Comments come back as bare lines
    (the probe's (line, event-index) pairs collapsed)."""
    status, events, comments, _gaps, headers = _sse_collect(
        url, body, timeout=timeout
    )
    return status, events, [c for c, _i in comments], headers


def _sse_lines(url, body, timeout=30):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    events = []
    with urllib.request.urlopen(req, timeout=timeout) as r:
        status, headers = r.status, dict(r.headers)
        for line in r:
            line = line.decode().strip()
            if line.startswith("data: "):
                events.append(json.loads(line[len("data: "):]))
    return status, events, headers


@pytest.fixture
def router():
    r = Router(port=0, health_interval_s=0.1, retries=2,
               backend_timeout_s=10.0)
    r.start()
    yield r
    r.stop()


class TestRouter:
    def test_relays_infer_and_headers(self, router):
        be = _fake_backend("a", version=3)
        try:
            router.add_backend("a", "127.0.0.1", be.server_address[1],
                               version=3, ready=True)
            st, body, hdrs = _post(router.url("/v1/infer"),
                                   {"inputs": [1, 2]},
                                   headers={"X-Tenant-Id": "t1"})
            assert st == 200
            assert body["backend"] == "a" and body["echo"] == [1, 2]
            assert body["tenant"] == "t1"  # request headers forwarded
            assert hdrs["X-Model-Version"] == "3"  # response relayed
            assert hdrs["X-Routed-Backend"] == "a"
        finally:
            be.shutdown()

    def test_oversized_body_413_before_any_buffering(self, router):
        import http.client

        be = _fake_backend("a")
        try:
            router.add_backend("a", "127.0.0.1", be.server_address[1],
                               ready=True)
            conn = http.client.HTTPConnection("127.0.0.1", router.port,
                                              timeout=10)
            # a declared-huge Content-Length must be refused up front
            # (not buffered, not proxied)
            conn.putrequest("POST", "/v1/infer")
            conn.putheader("Content-Type", "application/json")
            conn.putheader("Content-Length", str(100 * 1024 * 1024 * 1024))
            conn.endheaders()
            resp = conn.getresponse()
            assert resp.status == 413
            conn.close()
            assert be.state["hits"] == 0  # never reached a backend
        finally:
            be.shutdown()

    def test_no_backend_503(self, router):
        st, body, hdrs = _post(router.url("/v1/infer"), {"x": 1})
        assert st == 503
        assert hdrs.get("Retry-After")
        # readyz mirrors it
        try:
            urllib.request.urlopen(router.url("/readyz"), timeout=5)
            assert False, "expected 503"
        except urllib.error.HTTPError as e:
            assert e.code == 503

    def test_failover_dead_backend_retries_transparently(self):
        # backend "a" is a port with NO listener (bound then closed);
        # its lower id makes it the deterministic first pick. The
        # router's health loop must not probe "a" before the request
        # does: a sweep in between marks it not-ready, the pick goes
        # straight to "b" and nothing is retried (the reference's
        # fixture sweeps every 0.1 s, which a loaded host overruns), so
        # this router sweeps once a minute
        import socket

        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        dead_port = s.getsockname()[1]
        s.close()
        router = Router(port=0, health_interval_s=60.0, retries=2,
                        backend_timeout_s=10.0)
        router.start()
        be = _fake_backend("b")
        try:
            router.add_backend("a", "127.0.0.1", dead_port, ready=True)
            router.add_backend("b", "127.0.0.1", be.server_address[1],
                               ready=True)
            c0 = obs_registry.counter("router_retries").value()
            st, body, _ = _post(router.url("/v1/infer"), {"x": 1})
            assert st == 200 and body["backend"] == "b"
            assert obs_registry.counter("router_retries").value() > c0
            # the dead backend was marked not-ready on the spot
            a = [x for x in router.backends() if x["id"] == "a"][0]
            assert a["ready"] is False
        finally:
            be.shutdown()
            router.stop()

    def test_backend_503_readyz_excluded_by_health(self, router):
        be = _fake_backend("a", ready=False)
        try:
            router.add_backend("a", "127.0.0.1", be.server_address[1],
                               ready=True)  # claims ready...
            deadline = time.monotonic() + 5
            while router.ready_count() > 0 and time.monotonic() < deadline:
                time.sleep(0.02)
            assert router.ready_count() == 0  # ...health said otherwise
            be.state["ready"] = True
            deadline = time.monotonic() + 5
            while router.ready_count() == 0 and time.monotonic() < deadline:
                time.sleep(0.02)
            assert router.ready_count() == 1  # re-admitted
            st, body, _ = _post(router.url("/v1/infer"), {"x": 1})
            assert st == 200
        finally:
            be.shutdown()

    def test_least_inflight_spreads_load(self, router):
        b1 = _fake_backend("a")
        b2 = _fake_backend("b")
        try:
            router.add_backend("a", "127.0.0.1", b1.server_address[1],
                               ready=True)
            router.add_backend("b", "127.0.0.1", b2.server_address[1],
                               ready=True)
            for _ in range(8):
                st, _b, _h = _post(router.url("/v1/infer"), {"x": 1})
                assert st == 200
            # sequential requests with 0 inflight tie-break to "a";
            # both ids must have been hit under concurrency
            results = []

            def go():
                results.append(_post(router.url("/v1/infer"),
                                     {"x": 1})[1]["backend"])

            ts = [threading.Thread(target=go) for _ in range(12)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            assert set(results) == {"a", "b"}
        finally:
            b1.shutdown()
            b2.shutdown()

    def test_backpressure_429_passes_through(self, router):
        be = _fake_backend("a", infer_status=429)
        try:
            router.add_backend("a", "127.0.0.1", be.server_address[1],
                               ready=True)
            st, _body, hdrs = _post(router.url("/v1/infer"), {"x": 1})
            # the replica's answer, not a router retry target
            assert st == 429
            assert hdrs.get("Retry-After") == "1"
            assert be.state["hits"] == 1
        finally:
            be.shutdown()

    def test_sse_stream_relays_and_pins(self, router):
        be = _fake_backend("a", tokens=(7, 8, 9))
        try:
            router.add_backend("a", "127.0.0.1", be.server_address[1],
                               ready=True)
            st, events, hdrs = _sse_lines(router.url("/v1/generate"),
                                          {"prompt_ids": [1]})
            assert st == 200
            assert [e["token"] for e in events[:-1]] == [7, 8, 9]
            assert events[-1].get("done") is True
            assert hdrs["X-Routed-Backend"] == "a"
        finally:
            be.shutdown()

    def test_sse_mid_stream_death_surfaces_in_band_error(self, router):
        be = _fake_backend("a", tokens=(1, 2, 3, 4), die_after=2)
        try:
            router.add_backend("a", "127.0.0.1", be.server_address[1],
                               ready=True)
            c0 = obs_registry.counter("router_stream_errors").value()
            st, events, _h = _sse_lines(router.url("/v1/generate"),
                                        {"prompt_ids": [1]})
            # the 200 was already on the wire; the death is IN-BAND and
            # the chunked stream terminates cleanly (no client OSError)
            assert st == 200
            assert [e.get("token") for e in events[:2]] == [1, 2]
            assert "error" in events[-1]
            assert obs_registry.counter(
                "router_stream_errors").value() > c0
            a = [x for x in router.backends() if x["id"] == "a"][0]
            assert a["ready"] is False
        finally:
            be.shutdown()

    def test_health_loop_survives_garbage_backend(self, router):
        """A backend answering garbage (BadStatusLine — an
        HTTPException, not an OSError) must not kill the health
        thread: other backends still get re-admitted afterward."""
        import socket

        garbage_stop = threading.Event()
        gsock = socket.socket()
        gsock.bind(("127.0.0.1", 0))
        gsock.listen(4)

        def garbage_server():
            gsock.settimeout(0.2)
            while not garbage_stop.is_set():
                try:
                    c, _ = gsock.accept()
                except OSError:
                    continue
                try:
                    c.recv(1024)
                    c.sendall(b"not-http-at-all\r\n\r\n")
                finally:
                    c.close()

        gt = threading.Thread(target=garbage_server, daemon=True)
        gt.start()
        be = _fake_backend("b", ready=False)
        try:
            router.add_backend("a", "127.0.0.1",
                               gsock.getsockname()[1], ready=True)
            router.add_backend("b", "127.0.0.1", be.server_address[1],
                               ready=False)
            time.sleep(0.4)  # several probe rounds over the garbage
            be.state["ready"] = True
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                if any(x["ready"] for x in router.backends()
                       if x["id"] == "b"):
                    break
                time.sleep(0.02)
            # the loop is alive: it re-admitted b AFTER probing garbage
            assert any(x["ready"] for x in router.backends()
                       if x["id"] == "b")
            assert router._health_thread.is_alive()
        finally:
            garbage_stop.set()
            gsock.close()
            be.shutdown()

    def test_slow_backend_timeout_is_not_death(self):
        """A backend slower than the proxy timeout: pinned work (the
        non-stream generate path) sheds 504 instead of re-executing
        elsewhere, and the backend is NOT marked failed."""
        slow = Router(port=0, health_interval_s=5.0, retries=2,
                      backend_timeout_s=0.3)
        slow.start()
        be = _fake_backend("a", tokens=(1,))

        # make /v1/generate slow by intercepting POST via state
        orig = be.RequestHandlerClass.do_POST

        def slow_post(handler):
            if handler.path == "/v1/generate":
                time.sleep(0.8)
            orig(handler)

        be.RequestHandlerClass.do_POST = slow_post
        try:
            slow.add_backend("a", "127.0.0.1", be.server_address[1],
                             ready=True)
            st, body, _h = _post(slow.url("/v1/generate"),
                                 {"prompt_ids": [1]})
            assert st == 504
            assert body.get("reason") == "backend_timeout"
            a = [x for x in slow.backends() if x["id"] == "a"][0]
            assert a["ready"] is True  # slow != dead
        finally:
            be.RequestHandlerClass.do_POST = orig
            be.shutdown()
            slow.stop()

    def test_sse_mid_stream_stall_is_timeout_not_death(self):
        """An SSE stream whose next token outruns the backend timeout
        (long decode under pressure) gets an in-band backend_timeout
        event — and the slow replica is NOT marked failed."""
        slow = Router(port=0, health_interval_s=5.0, retries=1,
                      backend_timeout_s=0.3)
        slow.start()
        be = _fake_backend("a", tokens=(1, 2, 3), stall_after=2,
                           stall_s=1.0)
        try:
            slow.add_backend("a", "127.0.0.1", be.server_address[1],
                             ready=True)
            st, events, _h = _sse_lines(slow.url("/v1/generate"),
                                        {"prompt_ids": [1]})
            assert st == 200  # headers were already on the wire
            assert [e.get("token") for e in events[:2]] == [1, 2]
            assert events[-1].get("reason") == "backend_timeout"
            a = [x for x in slow.backends() if x["id"] == "a"][0]
            assert a["ready"] is True  # slow != dead
        finally:
            be.shutdown()
            slow.stop()

    def test_version_flip_routes_only_active(self, router):
        b1 = _fake_backend("a", version=1)
        b2 = _fake_backend("b", version=2)
        try:
            router.add_backend("a", "127.0.0.1", b1.server_address[1],
                               version=1, ready=True)
            router.add_backend("b", "127.0.0.1", b2.server_address[1],
                               version=2, ready=True)
            router.set_active_version(1)
            for _ in range(4):
                st, body, _h = _post(router.url("/v1/infer"), {"x": 1})
                assert st == 200 and body["version"] == 1
            router.set_active_version(2)
            for _ in range(4):
                st, body, _h = _post(router.url("/v1/infer"), {"x": 1})
                assert st == 200 and body["version"] == 2
            # ready_count follows the active version too
            assert router.ready_count() == 1
        finally:
            b1.shutdown()
            b2.shutdown()


# ---------------------------------------------------------------------------
# controller supervision over a FAKE replica command (no torch import)
# ---------------------------------------------------------------------------
_FAKE_REPLICA = r"""
import json, os, signal, sys, threading, time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

endpoint_file, version, mode = sys.argv[1], int(sys.argv[2]), sys.argv[3]

class H(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    def log_message(self, *a): pass
    def _json(self, code, obj):
        data = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.send_header("X-Model-Version", str(version))
        self.end_headers(); self.wfile.write(data)
    def do_GET(self):
        self._json(200 if self.path == "/readyz" else 404,
                   {"status": "ready"})
    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0)); self.rfile.read(n)
        self._json(200, {"version": version})

if mode == "crash":
    # stillborn: die before ever publishing an endpoint / readiness
    time.sleep(0.1); sys.exit(7)
srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
srv.daemon_threads = True
threading.Thread(target=srv.serve_forever, daemon=True).start()
stop = threading.Event()
signal.signal(signal.SIGTERM, lambda *a: stop.set())

def write_endpoint():
    tmp = endpoint_file + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"pid": os.getpid(), "version": version,
                   "gateway_port": srv.server_address[1],
                   "metrics_port": None, "lease_ts": time.time()}, f)
    os.replace(tmp, endpoint_file)

write_endpoint()
if mode == "crash_after_ready":
    time.sleep(0.4); sys.exit(7)
# lease discipline: re-stamp lease_ts like a real replica serve loop —
# except in "lease_stale" mode, which stamps once and goes silent (a
# wedged process whose port still answers)
last = time.time()
while not stop.wait(0.05):
    if mode != "lease_stale" and time.time() - last >= 0.2:
        write_endpoint(); last = time.time()
srv.shutdown()
sys.exit(0)
"""


def _fake_cmd(mode_fn=None):
    """replica_cmd factory: ``mode_fn(rid) -> "serve"|"crash"``."""

    def cmd(rid, version, model_dir, endpoint_file):
        mode = mode_fn(rid) if mode_fn else "serve"
        return [sys.executable, "-c", _FAKE_REPLICA, endpoint_file,
                str(version), mode]

    return cmd


def _controller(tmp_path, **kw):
    base = dict(
        model_dir=str(tmp_path / "model"), workdir=str(tmp_path / "work"),
        replicas=2, min_replicas=1, max_replicas=4, autoscale=False,
        replica_cmd=_fake_cmd(), ready_timeout_s=30.0,
        drain_grace_s=5.0, restart_backoff_s=0.05, poll_s=0.02,
        seed=0,
    )
    base.update(kw)
    os.makedirs(base["model_dir"], exist_ok=True)
    return FleetController(**base)


def _events(ctrl):
    return [e["event"] for e in fleet_mod.load_events(ctrl.workdir)]


class TestFleetController:
    def test_spawns_to_target_and_fronts_router(self, tmp_path):
        ctrl = _controller(tmp_path)
        try:
            ctrl.start(wait_ready_s=30)
            assert ctrl.ready_count() == 2
            assert ctrl.router.ready_count() == 2
            # routing is pinned to the serving version from boot: the
            # FIRST deploy's still-warming replicas must be standby,
            # not least-inflight winners
            assert ctrl.router.active_version == ctrl.version == 1
            st, body, _h = _post(ctrl.router.url("/v1/infer"), {"x": 1})
            assert st == 200 and body["version"] == 1
        finally:
            ctrl.stop()
        ev = _events(ctrl)
        assert ev.count("replica_ready") == 2
        assert "fleet_stop" in ev
        # the stop drained gracefully: SIGTERM exit 0, no crashes
        exits = [e for e in fleet_mod.load_events(ctrl.workdir)
                 if e["event"] == "replica_exit"]
        assert all(e["returncode"] == 0 for e in exits)
        assert "replica_crash" not in ev

    def test_crash_is_replaced_with_backoff(self, tmp_path):
        modes = {0: "crash_after_ready"}  # replica 0 crashes once
        ctrl = _controller(
            tmp_path, replicas=1,
            replica_cmd=_fake_cmd(lambda rid: modes.get(rid, "serve")),
        )
        try:
            ctrl.start(wait_ready_s=30)
            # the fake crashes ~0.4s after publishing its endpoint;
            # the controller must notice and respawn a replacement
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                if ctrl.crashes >= 1 and ctrl.ready_count() == 1:
                    break
                time.sleep(0.02)
            assert ctrl.crashes >= 1
            assert ctrl.ready_count() == 1
        finally:
            ctrl.stop()
        ev = _events(ctrl)
        assert "replica_crash" in ev
        spawns = [e for e in fleet_mod.load_events(ctrl.workdir)
                  if e["event"] == "replica_spawn"]
        assert any(e.get("replacement") for e in spawns)

    def test_crash_budget_gives_up(self, tmp_path):
        ctrl = _controller(
            tmp_path, replicas=1, max_replica_restarts=1,
            replica_cmd=_fake_cmd(lambda rid: "crash"),
        )
        try:
            ctrl.start()
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline and not ctrl._gaveup:
                time.sleep(0.05)
            assert ctrl._gaveup
            with pytest.raises(RuntimeError):
                ctrl.wait_ready(timeout=5)
        finally:
            ctrl.stop()
        assert "giveup" in _events(ctrl)

    def test_scale_down_drains_gracefully(self, tmp_path):
        ctrl = _controller(tmp_path, replicas=3)
        try:
            ctrl.start(wait_ready_s=30)
            ctrl.scale_to(1)
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline:
                if ctrl.ready_count() == 1:
                    infos = ctrl.replica_info()
                    if all(i["state"] in ("ready",) for i in infos):
                        break
                time.sleep(0.02)
            assert ctrl.ready_count() == 1
        finally:
            ctrl.stop()
        ev = fleet_mod.load_events(ctrl.workdir)
        names = [e["event"] for e in ev]
        assert "scale_down" in names
        drains = [e for e in ev if e["event"] == "replica_drain"
                  and e.get("reason") == "scale_down"]
        assert len(drains) == 2
        # drained replicas exited 0 (SIGTERM, not SIGKILL), 0 crashes
        assert "replica_crash" not in names
        assert ctrl.crashes == 0

    def test_scale_to_clamps_and_counts(self, tmp_path):
        ctrl = _controller(tmp_path, replicas=1, max_replicas=2)
        try:
            ctrl.start(wait_ready_s=30)
            assert ctrl.scale_to(10) == 2  # clamped to max
            ctrl.wait_ready(timeout=30)
            assert ctrl.ready_count() == 2
        finally:
            ctrl.stop()
        assert "scale_up" in _events(ctrl)
        # growth on a healthy fleet is NOT a crash replacement: no
        # spawn may carry replacement=true, and none draws the budget
        spawns = [e for e in fleet_mod.load_events(ctrl.workdir)
                  if e["event"] == "replica_spawn"]
        assert not any(e.get("replacement") for e in spawns)

    def test_scale_up_not_gated_by_crash_giveup(self, tmp_path):
        """A giveup on the crash budget blocks crash REPLACEMENTS, not
        capacity growth: once the crash hole is absorbed (target
        lowered to the healthy survivors), a later target raise must
        still spawn — the budget must not gate growth forever."""
        # replica 1 and its replacement crash, burning the budget;
        # everything else serves
        ctrl = _controller(
            tmp_path, replicas=2, max_replica_restarts=1,
            replica_cmd=_fake_cmd(
                lambda rid: "crash" if rid in (1, 2) else "serve"
            ),
        )
        try:
            ctrl.start()
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline and not ctrl._gaveup:
                time.sleep(0.05)
            assert ctrl._gaveup
            assert ctrl.ready_count() == 1  # the healthy survivor
            ctrl.scale_to(1)  # operator accepts the shrunken pool
            time.sleep(0.2)   # reconcile absorbs the crash hole
            ctrl.scale_to(2)  # ...and later wants capacity back
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline \
                    and ctrl.ready_count() < 2:
                time.sleep(0.05)
            assert ctrl.ready_count() == 2  # growth spawned post-giveup
        finally:
            ctrl.stop()

    def test_deploy_rolls_zero_downtime(self, tmp_path):
        ctrl = _controller(tmp_path, replicas=2)
        new_model = tmp_path / "model_v2"
        os.makedirs(str(new_model), exist_ok=True)
        try:
            ctrl.start(wait_ready_s=30)
            old_ids = {i["id"] for i in ctrl.replica_info()}
            # traffic during the rollout: never a non-200
            stop = threading.Event()
            seen, bad = [], []

            def trickle():
                while not stop.is_set():
                    st, body, _h = _post(ctrl.router.url("/v1/infer"),
                                         {"x": 1})
                    (seen if st == 200 else bad).append(
                        body.get("version") if st == 200 else st
                    )
                    time.sleep(0.01)

            t = threading.Thread(target=trickle)
            t.start()
            new_version = ctrl.deploy(str(new_model), ready_timeout_s=30)
            stop.set()
            t.join()
            assert new_version == 2
            assert ctrl.version == 2
            assert ctrl.router.active_version == 2
            assert not bad  # zero dropped
            assert seen and seen[-1] == 2  # traffic ended on v2
            # versions can only move forward 1 -> 2 during the flip
            flips = [v for i, v in enumerate(seen)
                     if i and v != seen[i - 1]]
            assert flips in ([], [2])
            # the old replicas are gone, the new pool serves
            live = ctrl.replica_info()
            assert {i["version"] for i in live} == {2}
            assert not (old_ids & {i["id"] for i in live})
            assert ctrl.ready_count() == 2
        finally:
            ctrl.stop()
        names = _events(ctrl)
        for ev in ("rollout_start", "rollout_ready", "rollout_done"):
            assert ev in names

    def test_post_flip_failure_never_rolls_back(self, tmp_path):
        """A failure AFTER the router flip (e.g. the event log on a
        full disk) must not kill the new version — the router is
        already pinned to it and the old pool is draining; a rollback
        would be a full outage."""
        ctrl = _controller(tmp_path, replicas=1)
        new_model = tmp_path / "model_v2"
        os.makedirs(str(new_model), exist_ok=True)
        try:
            ctrl.start(wait_ready_s=30)
            orig = ctrl.log.event

            def boom(event, **kw):
                if event == "rollout_done":
                    raise OSError("disk full")
                return orig(event, **kw)

            ctrl.log.event = boom
            with pytest.raises(OSError):
                ctrl.deploy(str(new_model), ready_timeout_s=30)
            ctrl.log.event = orig
            assert ctrl.version == 2
            assert ctrl.router.active_version == 2
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline \
                    and ctrl.ready_count(version=2) < 1:
                time.sleep(0.02)
            st, body, _h = _post(ctrl.router.url("/v1/infer"), {"x": 1})
            assert st == 200 and body["version"] == 2
        finally:
            ctrl.stop()

    def test_deploy_abort_keeps_old_version_serving(self, tmp_path):
        calls = {"n": 0}

        def mode(rid):
            calls["n"] += 1
            return "serve" if calls["n"] <= 2 else "crash"

        ctrl = _controller(tmp_path, replicas=2,
                           replica_cmd=_fake_cmd(mode))
        new_model = tmp_path / "model_v2"
        os.makedirs(str(new_model), exist_ok=True)
        try:
            ctrl.start(wait_ready_s=30)
            with pytest.raises((RuntimeError, TimeoutError)):
                ctrl.deploy(str(new_model), ready_timeout_s=10)
            # v1 keeps serving
            assert ctrl.version == 1
            st, body, _h = _post(ctrl.router.url("/v1/infer"), {"x": 1})
            assert st == 200 and body["version"] == 1
            # the half-born new replicas were killed, WAITED on (no
            # zombies left behind), and booked as expected exits
            assert not [i for i in ctrl.replica_info()
                        if i["version"] == 2]
            for r in ctrl._replicas.values():
                if r.version == 2:
                    assert r.proc.poll() is not None
            # at most the stillborns' own crashes — the abort's kills
            # must not be double-booked as crashes on top
            assert ctrl.crashes <= 2
            # ...and rollout-version crashes are deploy()'s failure:
            # they must not burn the SERVING pool's budget or backoff
            assert ctrl._pool_crashes == 0
            assert not ctrl._gaveup
        finally:
            ctrl.stop()
        ev = fleet_mod.load_events(ctrl.workdir)
        assert "rollout_abort" in [e["event"] for e in ev]
        # every spawned replica has a replica_exit bookkeeping event
        spawned = {e["replica"] for e in ev
                   if e["event"] == "replica_spawn"}
        exited = {e["replica"] for e in ev
                  if e["event"] == "replica_exit"}
        assert spawned == exited


# ---------------------------------------------------------------------------
# control-plane durability: journal, leases, adoption
# ---------------------------------------------------------------------------
def _crash_controller(ctrl):
    """Simulate a controller CRASH: supervision thread and router die,
    the journal keeps its lease, and the replicas are orphaned
    mid-serve (nothing drains them). The journal's controller pid is
    rewritten to a reaped child's pid so the restart sees the real
    crash shape (a dead journal-holder) — in-process, both controllers
    would otherwise share os.getpid()."""
    ctrl._stop_evt.set()
    if ctrl._tick_thread is not None:
        ctrl._tick_thread.join(timeout=10)
        ctrl._tick_thread = None
    ctrl._started = False
    if ctrl._owns_router:
        ctrl.router.stop()
    if ctrl._ready_gauge is not None:
        obs_registry.unregister_gauge("fleet_replicas_ready",
                                      ctrl._ready_gauge)
        ctrl._ready_gauge = None
    if ctrl._target_gauge is not None:
        obs_registry.unregister_gauge("fleet_replicas_target",
                                      ctrl._target_gauge)
        ctrl._target_gauge = None
    fleet_mod._LIVE_CONTROLLERS.discard(os.path.realpath(ctrl.workdir))
    st = fleet_mod.read_fleet_state(ctrl.workdir)
    st["controller"]["pid"] = _dead_pid()
    modeldir.commit_json(
        os.path.join(ctrl.workdir, fleet_mod.FLEET_STATE), st)


def _dead_pid():
    """A pid guaranteed dead (spawned, exited, fully reaped)."""
    p = subprocess.Popen([sys.executable, "-c", "pass"])
    p.wait()
    return p.pid


def _reap_orphans(ctrl):
    """Reap the zombie children a crashed controller's pool leaves in
    THIS test process once a later controller kills/drains them."""
    for r in ctrl._replicas.values():
        try:
            if isinstance(r.proc, subprocess.Popen):
                r.proc.wait(timeout=10)
        except Exception:
            pass


def _spawn_orphan(tmp_path, rid, version, mode="serve"):
    """A fake replica spawned OUTSIDE any controller (a survivor of a
    crashed one): writes workdir/endpoints/replica_<rid>.json itself."""
    epdir = tmp_path / "work" / "endpoints"
    os.makedirs(str(epdir), exist_ok=True)
    epf = str(epdir / ("replica_%d.json" % rid))
    p = subprocess.Popen([sys.executable, "-c", _FAKE_REPLICA, epf,
                          str(version), mode])
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline and not os.path.isfile(epf):
        time.sleep(0.02)
    assert os.path.isfile(epf), "orphan fake replica never published"
    return p


def _write_journal(tmp_path, replicas, rollout=None, target=2,
                   version=1, lease_age=3600.0, pid=0):
    """Manufacture a fleet_state.json as a crashed controller would
    have left it: ``replicas`` maps rid -> (version, pid). The default
    lease is ancient and the default holder pid 0, so the split-brain
    guard always lets the restart proceed."""
    work = str(tmp_path / "work")
    os.makedirs(work, exist_ok=True)
    state = {
        "schema_version": 1,
        "controller": {"pid": int(pid),
                       "lease_ts": time.time() - float(lease_age),
                       "boot_id": "test"},
        "intent": {"target": int(target), "version": int(version),
                   "model_dir": str(tmp_path / "model"), "roles": {},
                   "rollout": rollout},
        "ledger": {"pool_crashes": 0, "crashes": 0, "gaveup": False},
        "replicas": {
            str(rid): {"version": v, "model_dir": str(tmp_path / "model"),
                       "role": "mixed", "pid": p}
            for rid, (v, p) in replicas.items()
        },
    }
    modeldir.commit_json(os.path.join(work, fleet_mod.FLEET_STATE),
                         state)
    return state


class TestFleetDurability:
    def test_journal_written_mutated_and_released(self, tmp_path):
        ctrl = _controller(tmp_path)
        try:
            ctrl.start(wait_ready_s=30)
            st = fleet_mod.read_fleet_state(ctrl.workdir)
            assert st["schema_version"] == 1
            assert st["controller"]["pid"] == os.getpid()
            assert st["intent"]["target"] == 2
            assert st["intent"]["version"] == 1
            assert st["intent"]["rollout"] is None
            assert len(st["replicas"]) == 2
            ctrl.scale_to(3)  # an intent mutation journals immediately
            assert fleet_mod.read_fleet_state(
                ctrl.workdir)["intent"]["target"] == 3
        finally:
            ctrl.stop()
        st = fleet_mod.read_fleet_state(ctrl.workdir)
        assert st["controller"] is None  # clean stop releases the lease
        assert st["replicas"] == {}      # ...and the pool drained away

    def test_torn_fleet_state_is_fresh_start(self, tmp_path):
        work = tmp_path / "work"
        os.makedirs(str(work))
        with open(str(work / fleet_mod.FLEET_STATE), "w") as f:
            f.write('{"schema_version": 1, "controller": {"pid": ')
        assert fleet_mod.read_fleet_state(str(work)) is None
        ctrl = _controller(tmp_path)
        try:
            ctrl.start(wait_ready_s=30)  # torn journal: boot fresh
            assert ctrl.ready_count() == 2
            assert fleet_mod.read_fleet_state(
                ctrl.workdir)["schema_version"] == 1
        finally:
            ctrl.stop()

    def test_torn_shared_file_readers_go_stale_not_crash(self, tmp_path):
        from paddle_tpu_torch.serving import kv_tier

        torn = str(tmp_path / "kv_peers.json")
        with open(torn, "w") as f:
            f.write('{"peers": [{"id": 0, "ho')
        assert kv_tier.read_peers(torn) == []
        assert kv_tier.read_peers(str(tmp_path / "absent.json")) == []
        ep = str(tmp_path / "replica_0.json")
        with open(ep, "w") as f:
            f.write('{"pid": 12')
        assert fleet_mod._read_json(ep) is None
        # absent, torn, and parseable-but-wrong-shape journals all read
        # as "no journal" (fresh start), never an exception
        assert fleet_mod.read_fleet_state(str(tmp_path)) is None
        with open(str(tmp_path / fleet_mod.FLEET_STATE), "w") as f:
            f.write("[1, 2]")
        assert fleet_mod.read_fleet_state(str(tmp_path)) is None

    def test_restart_adopts_survivors_replaces_headless_death(
            self, tmp_path):
        ctrl = _controller(tmp_path)
        ctrl.start(wait_ready_s=30)
        pids = {i["id"]: i["pid"] for i in ctrl.replica_info()}
        _crash_controller(ctrl)
        # one replica dies while the fleet is headless
        dead_rid, surv_rid = min(pids), max(pids)
        os.kill(pids[dead_rid], signal.SIGKILL)
        time.sleep(0.2)
        ctrl2 = _controller(tmp_path)
        try:
            ctrl2.start(wait_ready_s=30)
            assert ctrl2.ready_count() == 2
            infos = {i["id"]: i for i in ctrl2.replica_info()}
            # the survivor was ADOPTED in place — same pid, no respawn
            assert infos[surv_rid]["pid"] == pids[surv_rid]
            assert infos[surv_rid]["adopted"] is True
            assert [i["id"] for i in infos.values()
                    if i.get("adopted")] == [surv_rid]
            ev = fleet_mod.load_events(ctrl2.workdir)
            names = [e["event"] for e in ev]
            assert names.count("replica_adopt") == 1
            assert "replica_lost" in names
            rec = [e for e in ev if e["event"] == "controller_recover"]
            assert rec and rec[-1]["adopted"] == 1
            assert rec[-1]["headless_ms"] >= 0
            # exactly one replacement across the whole log: the
            # headless death — the survivor was never respawned
            respawns = [e for e in ev if e["event"] == "replica_spawn"
                        and e.get("replacement")]
            assert len(respawns) == 1
            # the adopted survivor serves through the new router
            st, body, _h = _post(ctrl2.router.url("/v1/infer"), {"x": 1})
            assert st == 200
        finally:
            ctrl2.stop()
            _reap_orphans(ctrl)

    def test_double_start_same_workdir_is_split_brain(self, tmp_path):
        ctrl = _controller(tmp_path)
        try:
            ctrl.start(wait_ready_s=30)
            dup = _controller(tmp_path)
            with pytest.raises(fleet_mod.FleetLockError) as ei:
                dup.start()
            assert ei.value.pid == os.getpid()
            # the loser did not disturb the incumbent
            assert ctrl.ready_count() == 2
        finally:
            ctrl.stop()
        # a clean stop releases the lease: the next start proceeds
        ctrl3 = _controller(tmp_path)
        try:
            ctrl3.start(wait_ready_s=30)
            assert ctrl3.ready_count() == 2
        finally:
            ctrl3.stop()

    def test_split_brain_guard_via_journal_lease(self, tmp_path):
        work = str(tmp_path / "work")
        holder = subprocess.Popen(
            [sys.executable, "-c", "import time; time.sleep(120)"])
        try:
            # a LIVE holder with a fresh lease blocks the start
            _write_journal(tmp_path, {}, lease_age=0.0, pid=holder.pid)
            ctrl = _controller(tmp_path)
            with pytest.raises(fleet_mod.FleetLockError) as ei:
                ctrl.start()
            assert ei.value.pid == holder.pid
            assert ei.value.lease_age_s < 10.0
            # a STALE lease does not block, even with the holder alive
            # (it stopped journaling — supervising nothing)
            _write_journal(tmp_path, {}, lease_age=3600.0,
                           pid=holder.pid)
            ctrl2 = _controller(tmp_path)
            try:
                ctrl2.start(wait_ready_s=30)
                assert ctrl2.ready_count() == 2
            finally:
                ctrl2.stop()
        finally:
            holder.kill()
            holder.wait()
        # a DEAD holder with a FRESH lease does not block either (the
        # common crash-then-restart-within-ttl case)
        _write_journal(tmp_path, {}, lease_age=0.0, pid=holder.pid)
        ctrl3 = _controller(tmp_path)
        try:
            ctrl3.start(wait_ready_s=30)
            assert ctrl3.ready_count() == 2
        finally:
            ctrl3.stop()

    def test_lease_expiry_kills_wedged_replica(self, tmp_path):
        ctrl = _controller(
            tmp_path, replicas=2, lease_ttl_s=1.0,
            replica_cmd=_fake_cmd(
                lambda rid: "lease_stale" if rid == 0 else "serve"),
        )
        try:
            ctrl.start(wait_ready_s=30)
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                ev = fleet_mod.load_events(ctrl.workdir)
                if any(e["event"] == "replica_lease_expired"
                       for e in ev) and ctrl.ready_count() == 2:
                    break
                time.sleep(0.05)
            ev = fleet_mod.load_events(ctrl.workdir)
            exp = [e for e in ev
                   if e["event"] == "replica_lease_expired"]
            assert exp and exp[0]["replica"] == 0
            assert exp[0]["age_s"] >= 1.0  # rounded to 2dp; raw age is strictly > ttl
            assert ctrl.ready_count() == 2  # replaced under the budget
        finally:
            ctrl.stop()

    def test_replicas_without_lease_are_exempt(self, tmp_path):
        """A custom replica_cmd that never stamps lease_ts must never
        be lease-killed — the exit/ready/heartbeat checks still cover
        it (fail-safe, stale-until-rewritten discipline)."""

        class _NullProc(object):
            pid = None

            def kill(self):
                self.killed = True

            def poll(self):
                return None

        ctrl = _controller(tmp_path, lease_ttl_s=0.1)
        epf = str(tmp_path / "ep.json")
        r = fleet_mod._Replica(0, 1, "m", _NullProc(), epf, "hb", "obs")
        modeldir.commit_json(epf, {"pid": 1, "gateway_port": 1})
        assert ctrl._lease_expired(r) is False
        # ...while a stamped-but-stale lease DOES expire
        modeldir.commit_json(epf, {"pid": 1, "gateway_port": 1,
                                   "lease_ts": time.time() - 9.0})
        assert ctrl._lease_expired(r) is True

    def test_interrupted_rollout_pre_flip_aborts_to_old_version(
            self, tmp_path):
        p0 = _spawn_orphan(tmp_path, 0, 1)
        p1 = _spawn_orphan(tmp_path, 1, 1)
        p2 = _spawn_orphan(tmp_path, 2, 2)  # half-born new version
        _write_journal(
            tmp_path, {0: (1, p0.pid), 1: (1, p1.pid), 2: (2, p2.pid)},
            rollout={"phase": "spawning", "version": 2,
                     "model_dir": str(tmp_path / "model"),
                     "from_version": 1, "new_ids": [2]})
        ctrl = _controller(tmp_path)
        try:
            ctrl.start(wait_ready_s=30)
            # pre-flip: the rollout aborts cleanly — v1 keeps serving,
            # the half-born v2 replica is killed, not adopted
            assert ctrl.version == 1
            assert ctrl.router.active_version == 1
            assert ctrl.ready_count(version=1) == 2
            assert p2.wait(timeout=10) != 0
            ev = fleet_mod.load_events(ctrl.workdir)
            ab = [e for e in ev if e["event"] == "rollout_abort"]
            assert ab and ab[-1]["flipped"] is False
            assert [e["event"] for e in ev].count("replica_adopt") == 2
            st, body, _h = _post(ctrl.router.url("/v1/infer"), {"x": 1})
            assert st == 200 and body["version"] == 1
            assert fleet_mod.read_fleet_state(
                ctrl.workdir)["intent"]["rollout"] is None
        finally:
            ctrl.stop()
            for p in (p0, p1, p2):
                try:
                    p.wait(timeout=10)
                except Exception:
                    p.kill()

    def test_interrupted_rollout_post_flip_resumes_drain(self,
                                                         tmp_path):
        p0 = _spawn_orphan(tmp_path, 0, 1)  # old-version straggler
        p1 = _spawn_orphan(tmp_path, 1, 2)
        p2 = _spawn_orphan(tmp_path, 2, 2)
        _write_journal(
            tmp_path, {0: (1, p0.pid), 1: (2, p1.pid), 2: (2, p2.pid)},
            version=2,
            rollout={"phase": "flipped", "version": 2,
                     "model_dir": str(tmp_path / "model"),
                     "from_version": 1, "new_ids": [1, 2]})
        ctrl = _controller(tmp_path)
        try:
            ctrl.start(wait_ready_s=30)
            # post-flip: the new version is the pool; the v1 straggler
            # resumes its drain (SIGTERM -> clean exit 0)
            assert ctrl.version == 2
            assert ctrl.router.active_version == 2
            assert p0.wait(timeout=20) == 0
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline and any(
                    i["version"] == 1 for i in ctrl.replica_info()):
                time.sleep(0.05)
            assert {i["version"]
                    for i in ctrl.replica_info()} == {2}
            assert ctrl.ready_count(version=2) == 2
            ev = fleet_mod.load_events(ctrl.workdir)
            assert "rollout_resume" in [e["event"] for e in ev]
            st, body, _h = _post(ctrl.router.url("/v1/infer"), {"x": 1})
            assert st == 200 and body["version"] == 2
            assert fleet_mod.read_fleet_state(
                ctrl.workdir)["intent"]["rollout"] is None
        finally:
            ctrl.stop()
            for p in (p0, p1, p2):
                try:
                    p.wait(timeout=10)
                except Exception:
                    p.kill()

    def test_chaos_kill_controller_fires_once(self, tmp_path):
        """The FLAGS_chaos_kill_controller_after_s fault SIGKILLs the
        armed process exactly once per marker dir — the restarted
        controller (same env) must never re-fire."""
        script = (
            "import sys, time\n"
            "sys.path.insert(0, %r)\n"
            "from paddle_tpu_torch.testing import chaos\n"
            "t0 = time.monotonic()\n"
            "for _ in range(400):\n"
            "    chaos.maybe_kill_controller(time.monotonic() - t0)\n"
            "    time.sleep(0.01)\n"
            "print('SURVIVED', flush=True)\n"
        ) % os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ)
        env["FLAGS_chaos_kill_controller_after_s"] = "0.05"
        env["FLAGS_chaos_marker_dir"] = str(tmp_path / "markers")
        p = subprocess.run([sys.executable, "-c", script], env=env,
                           capture_output=True, text=True, timeout=120)
        assert p.returncode == -signal.SIGKILL
        assert "CHAOS kill_controller" in p.stdout
        assert os.path.isfile(
            str(tmp_path / "markers" / "fired_kill_controller"))
        # second process, same marker dir: the one-shot never re-fires
        p2 = subprocess.run([sys.executable, "-c", script], env=env,
                            capture_output=True, text=True, timeout=120)
        assert p2.returncode == 0 and "SURVIVED" in p2.stdout
        # disarmed (default flags): a plain run is untouched
        env.pop("FLAGS_chaos_kill_controller_after_s")
        env.pop("FLAGS_chaos_marker_dir")
        p3 = subprocess.run([sys.executable, "-c", script], env=env,
                            capture_output=True, text=True, timeout=120)
        assert p3.returncode == 0 and "SURVIVED" in p3.stdout

    def test_backend_rows_surface_adoption_fields(self, router):
        be = _fake_backend("a", version=3)
        try:
            router.add_backend("a", "127.0.0.1", be.server_address[1],
                               version=3, ready=True, adopted=True,
                               journal_version=3)
            rows = {b["id"]: b for b in router.backends()}
            assert rows["a"]["adopted"] is True
            assert rows["a"]["journal_version"] == 3
            assert rows["a"]["lease_age_s"] is None  # no probe yet
            router.add_backend("b", "127.0.0.1", be.server_address[1],
                               version=3, ready=True)
            rows = {b["id"]: b for b in router.backends()}
            assert rows["b"]["adopted"] is False
            assert rows["b"]["journal_version"] is None
        finally:
            be.shutdown()
    def _export(self, tmp_path, name, payload):
        d = tmp_path / name
        os.makedirs(str(d))
        with open(str(d / "__model__"), "w") as f:
            f.write(payload)
        return str(d)

    def test_publish_versions_latest(self, tmp_path):
        repo = str(tmp_path / "repo")
        e1 = self._export(tmp_path, "e1", "m1")
        e2 = self._export(tmp_path, "e2", "m2")
        assert modeldir.latest(repo) == (None, None)
        v1, d1 = modeldir.publish(e1, repo)
        assert (v1, modeldir.latest(repo)[0]) == (1, 1)
        v2, d2 = modeldir.publish(e2, repo)
        assert v2 == 2
        assert modeldir.latest(repo) == (2, d2)
        assert [v for v, _ in modeldir.versions(repo)] == [1, 2]
        # published dirs are real copies with a manifest
        with open(os.path.join(d2, "__model__")) as f:
            assert f.read() == "m2"
        man = modeldir.read_manifest(d2)
        assert man["version"] == 2
        # plain export dirs have no manifest
        assert modeldir.read_manifest(e1) is None

    def test_torn_version_dir_invisible(self, tmp_path):
        repo = str(tmp_path / "repo")
        e1 = self._export(tmp_path, "e1", "m1")
        modeldir.publish(e1, repo)
        os.makedirs(os.path.join(repo, "v_9"))  # no manifest: torn
        assert modeldir.latest(repo)[0] == 1
        assert [v for v, _ in modeldir.versions(repo)] == [1]

    def test_explicit_version_must_move_forward(self, tmp_path):
        repo = str(tmp_path / "repo")
        e1 = self._export(tmp_path, "e1", "m1")
        modeldir.publish(e1, repo, version=5)
        with pytest.raises(ValueError):
            modeldir.publish(e1, repo, version=3)
        v, _d = modeldir.publish(e1, repo)
        assert v == 6

    def test_commit_json_atomic_no_stage_leak(self, tmp_path):
        """commit_json is the ONE write discipline for every fleet
        shared file: the staged tmp never survives a commit, and a
        re-commit replaces the document in place."""
        p = str(tmp_path / "doc.json")
        assert modeldir.commit_json(p, {"a": 1}) == p
        with open(p) as f:
            assert json.load(f) == {"a": 1}
        modeldir.commit_json(p, {"a": 2}, indent=1)
        with open(p) as f:
            assert json.load(f) == {"a": 2}
        leftovers = [n for n in os.listdir(str(tmp_path))
                     if n.startswith("doc.json.tmp")]
        assert leftovers == []

    def test_fleet_resolves_repo_with_torn_latest_pointer(self,
                                                          tmp_path):
        """A publish torn between the version dir landing and the
        LATEST flip is modeldir.latest()'s documented fallback case;
        the fleet's model resolution must use it — not mistake the
        repo root for an export dir."""
        repo = str(tmp_path / "repo")
        e1 = self._export(tmp_path, "e1", "m1")
        _v, d1 = modeldir.publish(e1, repo)
        os.remove(os.path.join(repo, modeldir.LATEST))  # torn window
        path, version = fleet_mod._resolve_model(repo)
        assert (path, version) == (d1, 1)
        # a plain export dir still resolves to itself
        assert fleet_mod._resolve_model(e1) == (e1, None)


# ---------------------------------------------------------------------------
# fleet report merge (observability/aggregate.py)
# ---------------------------------------------------------------------------
class TestFleetReport:
    def test_log_filename_contract(self):
        # aggregate.fleet_report reads "fleet.log" literally (so a
        # report-only consumer skips the serving import); the literal
        # must track the controller's canonical constant
        assert fleet_mod.FLEET_LOG == "fleet.log"

    def test_merges_events_and_snapshots(self, tmp_path):
        work = str(tmp_path / "work")
        os.makedirs(work)
        from paddle_tpu_torch.distributed.supervisor import _Log

        log = _Log(os.path.join(work, fleet_mod.FLEET_LOG))
        # an OLD run first: the report must scope to the newest boot
        log.event("fleet_boot", target=9, version=9)
        log.event("replica_ready", replica=99, ready_replicas=9)
        log.event("fleet_boot", target=2, version=1)
        for rid in (0, 1, 2):
            log.event("replica_spawn", replica=rid, version=1)
        log.event("replica_ready", replica=0, ready_ms=900.0,
                  ready_replicas=1)
        log.event("replica_ready", replica=1, ready_ms=1100.0,
                  ready_replicas=2)
        log.event("scale_up", from_replicas=2, to_replicas=3,
                  reason="queue_pressure", ready_replicas=2)
        log.event("replica_ready", replica=2, ready_ms=1000.0,
                  ready_replicas=3)
        log.event("replica_crash", replica=1, returncode=-9)
        log.event("replica_exit", replica=1, returncode=-9,
                  ready_replicas=2)
        log.event("scale_down", from_replicas=3, to_replicas=2,
                  reason="idle", ready_replicas=2)
        log.event("rollout_start", version=2, from_version=1)
        log.event("rollout_done", version=2, ms=1234.0,
                  ready_replicas=2)
        # two live replica snapshot dirs + one STALE dir from a dead
        # previous run (replica 7 was never spawned in this run and
        # carries a steady recompile that must not leak into the sum)
        for rid, n, steady in ((0, 42, 0), (2, 7, 0), (7, 999, 3)):
            d = os.path.join(work, "obs", "replica_%d" % rid)
            os.makedirs(d)
            with open(os.path.join(d, "rank_0.jsonl"), "w") as f:
                f.write(json.dumps({
                    "ts": 1.0, "ts_mono": 1.0, "pid": 1000 + rid,
                    "counters": {"gateway_requests": n,
                                 "serving_completed": n},
                    "histograms": {},
                    "compiles": {"steady_recompiles": steady},
                }) + "\n")
        path = aggregate.write_fleet_report(work)
        with open(path) as f:
            rep = json.load(f)
        assert rep["version"] == 2  # rollout_done wins over boot
        assert rep["scale_ups"] == 1 and rep["scale_downs"] == 1
        assert rep["crashes"] == 1
        assert rep["replicas_ready_final"] == 2
        # timeline excludes the dead previous run
        counts = [e["ready_replicas"] for e in rep["replica_timeline"]]
        assert counts == [1, 2, 2, 3, 2, 2, 2]
        assert rep["replicas_reporting"] == [0, 2]  # stale 7 excluded
        assert rep["per_replica"]["0"]["counters"][
            "gateway_requests"] == 42
        assert rep["steady_recompiles"] == 0
        assert any(r["event"] == "rollout_done"
                   for r in rep["rollouts"])
        assert rep["replica_ready_ms"]["count"] == 3


    def test_adoption_audit_scoped_to_newest_run(self, tmp_path):
        """The durability audit: restarts count across the WHOLE log
        (the only fact the full history holds), adoption/respawn/lease
        counts scope to the newest run, and adopted replicas join the
        spawned-set so their snapshots aren't discarded as stale."""
        work = str(tmp_path / "work")
        os.makedirs(work)
        from paddle_tpu_torch.distributed.supervisor import _Log

        log = _Log(os.path.join(work, fleet_mod.FLEET_LOG))
        log.event("fleet_boot", target=3, version=1)
        log.event("replica_spawn", replica=0, version=1)
        log.event("replica_adopt", replica=9, version=1)  # old run
        log.event("fleet_boot", target=3, version=1)  # the restart
        log.event("controller_recover", adopted=2, lost=1,
                  headless_ms=812.5)
        log.event("replica_adopt", replica=1, version=1, pid=4242)
        log.event("replica_adopt", replica=2, version=1, pid=4243)
        log.event("replica_ready", replica=3, ready_ms=5.0,
                  ready_replicas=3)
        log.event("replica_spawn", replica=3, version=1,
                  replacement=True)
        log.event("replica_lease_expired", replica=2, age_s=9.0)
        # an ADOPTED replica's snapshot dir must survive the stale
        # filter (its id was never spawned in this run)
        d = os.path.join(work, "obs", "replica_1")
        os.makedirs(d)
        with open(os.path.join(d, "rank_0.jsonl"), "w") as f:
            f.write(json.dumps({
                "ts": 1.0, "ts_mono": 1.0, "pid": 4242,
                "counters": {"gateway_requests": 7},
                "histograms": {},
                "compiles": {"steady_recompiles": 0},
            }) + "\n")
        path = aggregate.write_fleet_report(work)
        with open(path) as f:
            rep = json.load(f)
        assert rep["adoption"] == {
            "controller_boots": 2,
            "controller_restarts": 1,
            "adopted": 2,
            "respawned": 1,
            "lease_expiries": 1,
            "headless_ms": 812.5,
        }
        assert rep["replicas_reporting"] == [1]


# ---------------------------------------------------------------------------
# batcher queue-depth gauge parity (satellite)
# ---------------------------------------------------------------------------
class TestBatcherQueueGauge:
    def test_standalone_batcher_publishes_gauge(self):
        from paddle_tpu_torch.serving.batcher import MicroBatcher

        b = MicroBatcher(lambda stacked, rows: [stacked[0]],
                         max_batch_size=2, queue_depth=4)
        try:
            assert obs_registry.gauge_values().get(
                "serving_queue_depth") == 0.0
            out, = b.result(b.submit([np.ones((1, 2), "float32")]),
                            timeout=10)
            assert out.shape == (1, 2)
        finally:
            b.stop()
        assert "serving_queue_depth" not in obs_registry.gauge_values()

    def test_gauge_succession_ownership_scoped(self):
        from paddle_tpu_torch.serving.batcher import MicroBatcher

        b1 = MicroBatcher(lambda s, r: [s[0]], max_batch_size=2)
        b2 = MicroBatcher(lambda s, r: [s[0]], max_batch_size=2)
        # b2 re-registered the shared name; stopping the OLDER owner
        # must not tear down the successor's gauge
        b1.stop()
        assert "serving_queue_depth" in obs_registry.gauge_values()
        b2.stop()
        assert "serving_queue_depth" not in obs_registry.gauge_values()


# ---------------------------------------------------------------------------
# closed loop: the port's probe
# ---------------------------------------------------------------------------
def _run_probe():
    """The port's probe as a subprocess on the CPU: (process, report)."""
    p = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.fleet_probe",
         "--fast", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    report = None
    for ln in p.stdout.splitlines():
        if ln.startswith("REPORT "):
            report = json.loads(ln[len("REPORT "):])
    return p, report


def test_fleet_probe_fast_acceptance():
    """The closed loop on real port replicas (``--device cpu``): replica
    SIGKILL mid-load completes every client request through router
    retry, induced pressure scales up with measurably higher
    throughput, idle hysteresis scales back down through a graceful
    drain, a versioned rollout swaps models with zero dropped or wrong
    responses, every replica holds 0 steady-state builds under the
    armed strict gate, streams survive a mid-stream replica kill
    token-exact, the KV tier serves hits by affinity and readmits
    spilled chains, and the controller survives its own SIGKILL.
    As the reference's test, a miss of timing bars only (failures
    prefixed "throughput": a loaded host squeezes them without touching
    any result) earns one rerun; any other miss fails at once."""
    p, report = _run_probe()
    if (p.returncode != 0 and report is not None and report.get("failures")
            and all(f.startswith("throughput")
                    for f in report["failures"])):
        p, report = _run_probe()
    assert p.returncode == 0, "probe failed:\n%s\n%s" % (
        p.stdout[-3000:], p.stderr[-2000:]
    )
    assert "PROBE PASS" in p.stdout
    assert report["schema_version"] == 1 and report["device"] == "cpu"
    assert report["failover"]["failed"] == 0
    assert report["failover"]["requests"] > 0
    assert report["autoscale"]["errors"] == 0
    assert report["autoscale"]["speedup"] >= 1.15
    assert report["scale_down"]["happened"]
    assert report["scale_down"]["trickle_failed"] == 0
    assert report["rollout"]["deployed_version"] == 2
    assert report["rollout"]["during_failed"] == 0
    assert report["rollout"]["post_wrong"] == 0
    assert report["strict"]["steady_recompiles"] == 0
    assert report["fleet_report"]["scale_ups"] >= 1
    gf = report["generate_failover"]
    assert gf["failed_over"] >= 1 and gf["steady_recompiles"] == 0
    assert report["kv_tier"]["measure_hits"] >= 5
    assert report["kv_tier"]["router_affinity_hits"] >= 1
    assert report["kv_tier"]["steady_recompiles"] == 0
    assert report["kv_tier_churn"]["spills"] >= 1
    assert report["kv_tier_churn"]["readmits"] >= 1
    # controller durability: the controller SIGKILLed mid-load costs
    # zero client stream failures through the headless window, the
    # restart ADOPTS both survivors and replaces the one replica killed
    # while headless, the double-start is refused, and a rollout
    # interrupted on either side of the flip lands consistent
    cc = report["controller_crash"]
    assert cc["stream_errors"] == 0
    assert cc["streams"] >= 6
    assert cc["adopted"] == 2
    assert cc["lost"] == 1
    assert cc["respawned"] == 1
    assert cc["headless_ms"] > 0
    assert cc["split_brain_blocked"] is True
    assert cc["steady_recompiles"] == 0
    assert cc["rollout_preflip_version"] == 1
    assert cc["rollout_postflip_version"] == 2


# ---------------------------------------------------------------------------
# durable streaming generations: router failover + resume
# ---------------------------------------------------------------------------
class TestDurableGenerations:
    def test_sse_failover_splices_resumed_stream(self, router):
        """Mid-stream replica death with a survivor available: the
        router re-admits the generation with the emitted suffix and
        splices the continuation — the client sees every token exactly
        once, a failover comment frame at the seam, a clean done event,
        and NO error event. The resumed backend receives the resume
        form with a DECREMENTED deadline."""
        a = _fake_backend("a", tokens=(5, 6, 7, 8), die_after=2)
        b = _fake_backend("b", tokens=(5, 6, 7, 8))
        try:
            router.add_backend("a", "127.0.0.1", a.server_address[1],
                               ready=True)
            router.add_backend("b", "127.0.0.1", b.server_address[1],
                               ready=True)
            c0 = obs_registry.counter("router_generate_failovers").value()
            st, events, comments, _h = _sse_full(
                router.url("/v1/generate"),
                {"prompt_ids": [1], "deadline_ms": 30000},
            )
            assert st == 200
            toks = [e["token"] for e in events if "token" in e]
            assert toks == [5, 6, 7, 8]
            assert not [e for e in events if "error" in e]
            assert events[-1].get("done") is True
            # the spliced done is rewritten to STREAM-level truth: the
            # client saw 4 tokens, not just the resumed hop's 2
            assert events[-1]["tokens"] == 4
            assert any("failover" in c for c in comments), comments
            assert obs_registry.counter(
                "router_generate_failovers").value() > c0
            rb = b.state["bodies"][-1]
            assert rb["resume_tokens"] == [5, 6]
            assert 0 < rb["deadline_ms"] < 30000
        finally:
            a.shutdown()
            b.shutdown()

    def test_sse_failover_survives_second_death(self, router):
        """Two consecutive mid-stream deaths within the failover budget
        (router_generate_retries defaults to 2): the stream still
        completes token-exact across THREE backends."""
        a = _fake_backend("a", tokens=(1, 2, 3, 4, 5), die_after=2)
        b = _fake_backend("b", tokens=(1, 2, 3, 4, 5), die_after=1)
        c = _fake_backend("c", tokens=(1, 2, 3, 4, 5))
        try:
            for srv, bid in ((a, "a"), (b, "b"), (c, "c")):
                router.add_backend(bid, "127.0.0.1",
                                   srv.server_address[1], ready=True)
            st, events, comments, _h = _sse_full(
                router.url("/v1/generate"), {"prompt_ids": [1]})
            assert st == 200
            toks = [e["token"] for e in events if "token" in e]
            assert toks == [1, 2, 3, 4, 5]
            assert not [e for e in events if "error" in e]
            assert len([x for x in comments if "failover" in x]) == 2
        finally:
            a.shutdown()
            b.shutdown()
            c.shutdown()

    def test_sse_unresumable_without_seed_keeps_inband_error(self,
                                                            router):
        """A temperature-sampled request WITHOUT a seed cannot replay:
        mid-stream death degrades to the in-band error event (the
        resume contract) and the survivor is never asked to resume."""
        a = _fake_backend("a", tokens=(1, 2, 3), die_after=1)
        b = _fake_backend("b", tokens=(1, 2, 3))
        try:
            router.add_backend("a", "127.0.0.1", a.server_address[1],
                               ready=True)
            router.add_backend("b", "127.0.0.1", b.server_address[1],
                               ready=True)
            st, events, comments, _h = _sse_full(
                router.url("/v1/generate"),
                {"prompt_ids": [1], "temperature": 1.0},
            )
            assert st == 200
            last = events[-1]
            assert "error" in last and "resumable" in last["resume"]
            assert last["emitted_count"] == 1
            assert not comments
            assert b.state["bodies"] == []
            # wait for the health loop to re-admit "a" (readyz is 200;
            # only the request path died) so the next request picks it
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                if [x for x in router.backends()
                        if x["id"] == "a"][0]["ready"]:
                    break
                time.sleep(0.02)
            # ...while the SAME request WITH a seed fails over fine
            st, events, comments, _h = _sse_full(
                router.url("/v1/generate"),
                {"prompt_ids": [1], "temperature": 1.0, "seed": 11},
            )
            toks = [e["token"] for e in events if "token" in e]
            assert toks == [1, 2, 3]
            assert any("failover" in x for x in comments)
        finally:
            a.shutdown()
            b.shutdown()

    def test_death_in_done_gap_synthesizes_done_event(self, router):
        """A replica dying AFTER its last token frame but BEFORE the
        done frame (exactly where chaos die_after_tokens kills): every
        token was delivered, so the resume form would be rejected by
        any engine (budget spent / eos emitted) — the router must
        synthesize the done event itself, not error a fully-delivered
        generation."""
        # die_after == len(tokens): the fake dies in the done gap
        a = _fake_backend("a", tokens=(4, 5, 6), die_after=3)
        b = _fake_backend("b", tokens=(4, 5, 6))
        try:
            router.add_backend("a", "127.0.0.1", a.server_address[1],
                               ready=True)
            router.add_backend("b", "127.0.0.1", b.server_address[1],
                               ready=True)
            st, events, comments, _h = _sse_full(
                router.url("/v1/generate"),
                {"prompt_ids": [1], "max_new_tokens": 3},
            )
            assert st == 200
            assert [e["token"] for e in events if "token" in e] \
                == [4, 5, 6]
            assert not [e for e in events if "error" in e]
            last = events[-1]
            assert last.get("done") and last.get("synthesized")
            assert last["finish_reason"] == "length"
            assert last["emitted_count"] == 3
            assert b.state["bodies"] == []  # never asked to resume
            # eos variant: the captured suffix contains the eos id —
            # a fresh dying backend as the only route, so the death in
            # the done gap is deterministic
            router.remove_backend("a")
            router.remove_backend("b")
            c = _fake_backend("c", tokens=(4, 5, 6), die_after=3)
            try:
                router.add_backend("c", "127.0.0.1",
                                   c.server_address[1], ready=True)
                st, events, _c, _h = _sse_full(
                    router.url("/v1/generate"),
                    {"prompt_ids": [1], "eos_id": 6},
                )
                last = events[-1]
                assert last.get("done") and last.get("synthesized")
                assert last["finish_reason"] == "eos"
                assert not [e for e in events if "error" in e]
            finally:
                c.shutdown()
        finally:
            a.shutdown()
            b.shutdown()

    def test_failover_denied_once_deadline_spent(self):
        """The deadline-propagation regression: a failover carries only
        the REMAINING client budget, so a replica death after the
        deadline has passed gives up in-band (resume reason
        'deadline') — the resumed request would 504 at the same
        wall-clock instant the unbroken one would, and the survivor is
        never burdened."""
        r = Router(port=0, health_interval_s=5.0, retries=2,
                   backend_timeout_s=10.0)
        r.start()
        # stalls 0.35s after token 1, then dies at token 2: by the
        # death, the 200ms client budget is long gone
        a = _fake_backend("a", tokens=(1, 2, 3, 4), die_after=2,
                          stall_after=1, stall_s=0.35)
        b = _fake_backend("b", tokens=(1, 2, 3, 4))
        try:
            r.add_backend("a", "127.0.0.1", a.server_address[1],
                          ready=True)
            r.add_backend("b", "127.0.0.1", b.server_address[1],
                          ready=True)
            st, events, comments, _h = _sse_full(
                r.url("/v1/generate"),
                {"prompt_ids": [1], "deadline_ms": 200},
            )
            last = events[-1]
            assert "error" in last and last["resume"] == "deadline"
            assert not comments
            assert b.state["bodies"] == []
        finally:
            a.shutdown()
            b.shutdown()
            r.stop()

    def test_chaos_die_after_tokens_kills_at_exact_token(self):
        """The deterministic mid-stream fault: the armed process
        SIGKILLs itself the moment its Nth stream token hits the wire;
        a process addressed as a DIFFERENT replica never fires."""
        import subprocess

        script = (
            "import os\n"
            "from paddle_tpu_torch.testing import chaos\n"
            "for i in range(5):\n"
            "    print('tok', i, flush=True)\n"
            "    chaos.on_stream_token()\n"
            "print('survived', flush=True)\n"
        )
        env = dict(os.environ, FLAGS_chaos_die_after_tokens="3",
                   FLAGS_chaos_die_replica="0",
                   PADDLE_TPU_REPLICA_ID="0")
        p = subprocess.run([sys.executable, "-c", script], env=env,
                           capture_output=True, text=True, timeout=120)
        assert p.returncode == -9, (p.returncode, p.stdout, p.stderr)
        assert "tok 2" in p.stdout and "tok 3" not in p.stdout
        assert "survived" not in p.stdout
        env["PADDLE_TPU_REPLICA_ID"] = "1"
        p = subprocess.run([sys.executable, "-c", script], env=env,
                           capture_output=True, text=True, timeout=120)
        assert p.returncode == 0 and "survived" in p.stdout


# ---------------------------------------------------------------------------
# per-backend circuit breaker + deadline propagation
# ---------------------------------------------------------------------------
class TestBreakerAndDeadline:
    def test_breaker_opens_on_flapping_backend_then_half_open_probe(
            self):
        """A FLAPPING replica — /readyz 200 (so the health loop keeps
        re-admitting it) but every request 503s — opens its breaker
        after the consecutive-failure threshold and stops eating a
        retry from each request; once healed, a single half-open probe
        closes the breaker and traffic returns."""
        r = Router(port=0, health_interval_s=0.05, retries=2,
                   backend_timeout_s=10.0, breaker_failures=3,
                   breaker_cooldown_s=1.0)
        r.start()
        flap = _fake_backend("a", infer_status=503)
        good = _fake_backend("b")
        try:
            r.add_backend("a", "127.0.0.1", flap.server_address[1],
                          ready=True)
            r.add_backend("b", "127.0.0.1", good.server_address[1],
                          ready=True)
            c0 = obs_registry.counter(
                "router_breaker_open_total").value()
            opened = False
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                st, body, _ = _post(r.url("/v1/infer"), {"x": 1})
                assert st == 200 and body["backend"] == "b"
                a = [x for x in r.backends() if x["id"] == "a"][0]
                if a["breaker"] == "open":
                    opened = True
                    break
                time.sleep(0.07)  # health loop re-admits the flapper
            assert opened, r.backends()
            assert obs_registry.counter(
                "router_breaker_open_total").value() > c0
            assert r.breaker_open_count() == 1
            # while OPEN: excluded from picks even though health says
            # ready — the very next request never touches it
            hits0 = flap.state["hits"]
            st, body, _ = _post(r.url("/v1/infer"), {"x": 1})
            assert body["backend"] == "b"
            assert flap.state["hits"] == hits0
            # heal it; after the cooldown ONE half-open probe readmits
            flap.state["infer_status"] = 200
            closed = False
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                _post(r.url("/v1/infer"), {"x": 1})
                a = [x for x in r.backends() if x["id"] == "a"][0]
                if a["breaker"] == "closed" and a["fail_streak"] == 0:
                    closed = True
                    break
                time.sleep(0.1)
            assert closed, r.backends()
            assert flap.state["hits"] > hits0  # the probe went through
        finally:
            flap.shutdown()
            good.shutdown()
            r.stop()

    def test_deadline_decremented_across_the_hop(self, router):
        """The router forwards deadline_ms minus its own elapsed time —
        never the client's original budget; a request with no deadline
        forwards untouched; a budget already spent at the router sheds
        504 without touching a backend."""
        be = _fake_backend("a")
        try:
            router.add_backend("a", "127.0.0.1", be.server_address[1],
                               ready=True)
            st, body, _ = _post(router.url("/v1/infer"),
                                {"inputs": [1], "deadline_ms": 5000})
            assert st == 200
            assert 0 < body["deadline"] < 5000
            st, body, _ = _post(router.url("/v1/infer"),
                                {"inputs": [1]})
            assert st == 200 and body["deadline"] is None
            hits0 = be.state["hits"]
            st, body, _ = _post(router.url("/v1/infer"),
                                {"inputs": [1], "deadline_ms": 0.0001})
            assert st == 504 and body["reason"] == "deadline"
            assert be.state["hits"] == hits0
        finally:
            be.shutdown()


class TestFailoverHardening:
    def test_resume_pins_to_the_streams_model_version(self, router):
        """A resume must land on the SAME model version that opened the
        stream: during a rollout the active version may have flipped,
        and re-prefilling on different weights would silently splice a
        diverged continuation into a stream sold as token-exact. With
        only a new-version replica left, the stream degrades to the
        in-band error naming the version constraint."""
        a = _fake_backend("a", version=1, tokens=(1, 2, 3), die_after=2)
        b = _fake_backend("b", version=2, tokens=(1, 2, 3))
        try:
            router.add_backend("a", "127.0.0.1", a.server_address[1],
                               version=1, ready=True)
            router.add_backend("b", "127.0.0.1", b.server_address[1],
                               version=2, ready=True)
            router.set_active_version(1)  # a opens the stream
            st, events, comments, _h = _sse_full(
                router.url("/v1/generate"), {"prompt_ids": [1]})
            last = events[-1]
            assert "error" in last
            assert "model version" in last["resume"]
            assert not comments
            assert b.state["bodies"] == []  # v2 never asked to resume
        finally:
            router.set_active_version(None)
            a.shutdown()
            b.shutdown()

    def test_resume_429_is_transient_not_terminal(self, router):
        """A 429 backpressure shed from a resume target (momentarily
        full admission queue) must not kill the durable stream: the
        remaining failover budget tries the next replica, and the busy
        one keeps its ready state (backpressure is not failure)."""
        a = _fake_backend("a", tokens=(1, 2, 3, 4), die_after=2)
        b = _fake_backend("b", tokens=(1, 2, 3, 4), gen_status=429)
        c = _fake_backend("c", tokens=(1, 2, 3, 4))
        try:
            for srv, bid in ((a, "a"), (b, "b"), (c, "c")):
                router.add_backend(bid, "127.0.0.1",
                                   srv.server_address[1], ready=True)
            st, events, comments, _h = _sse_full(
                router.url("/v1/generate"), {"prompt_ids": [1]})
            toks = [e["token"] for e in events if "token" in e]
            assert toks == [1, 2, 3, 4]
            assert not [e for e in events if "error" in e]
            assert any("failover" in x for x in comments)
            assert b.state["hits"] == 1  # asked once, shed 429
            bstate = [x for x in router.backends() if x["id"] == "b"][0]
            assert bstate["ready"] is True  # backpressure != failure
        finally:
            a.shutdown()
            b.shutdown()
            c.shutdown()

    def test_sse_frame_splitter_handles_crlf(self):
        """The spec permits CRLF line endings: a foreign CRLF-framed
        backend's events must still split, parse, and count."""
        from paddle_tpu_torch.serving.router import (
            _frame_token,
            _split_sse_frames,
        )

        frames, rest = _split_sse_frames(
            b'data: {"token": 1}\r\n\r\ndata: {"token": 2}\n\n'
            b'data: {"done": true}\r\n\r\ndata: {"tok'
        )
        assert len(frames) == 3 and rest == b'data: {"tok'
        assert _frame_token(frames[0]) == (1, False)
        assert _frame_token(frames[1]) == (2, False)
        assert _frame_token(frames[2]) == (None, True)


# ---------------------------------------------------------------------------
# the port's replica process, its seeded engine and the kernel build lock
# ---------------------------------------------------------------------------
_SPEC = {"seed": 17, "vocab_size": 97, "hidden_size": 32, "num_layers": 2,
         "num_heads": 2, "intermediate_size": 64, "max_len": 48,
         "slots": 2, "prefill_buckets": [8, 16, 48]}

def _param_digest(spec):
    """sha256 over the seeded engine's parameters, by name."""
    import hashlib

    from paddle_tpu_torch.serving.replica import build_gpt_decode_engine

    eng = build_gpt_decode_engine(spec, device="cpu")
    h = hashlib.sha256()
    for name, p in sorted(eng.model.state_dict().items()):
        h.update(name.encode())
        h.update(p.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def test_seeded_replicas_hold_bit_identical_parameters():
    """Failover resumes a stream on another replica token-exactly only if
    every process given one ``--gpt-decode`` spec holds the same bits: a
    fresh process agrees with this one, and another seed differs."""
    p = subprocess.run(
        [sys.executable, "-c",
         "import json, sys\n"
         "sys.path.insert(0, 'tests')\n"
         "from test_torch_fleet import _param_digest\n"
         "print(_param_digest(json.loads(sys.argv[1])))", json.dumps(_SPEC)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    here = _param_digest(_SPEC)
    assert p.stdout.strip().splitlines()[-1] == here and len(here) == 64
    assert _param_digest(dict(_SPEC, seed=18)) != here


def _saved_classifier(tmp_path):
    from paddle_tpu_torch.tools.fleet_probe import build_model

    d = str(tmp_path / "export")
    xd = build_model(d, 1, "cpu")
    return d, xd


def test_replica_raises_without_a_card_unless_device_cpu(tmp_path):
    """No card and no ``--device cpu``: the replica exits non-zero with
    the port's no-CUDA error before writing an endpoint. With ``--device
    cpu`` it serves, answers ``/readyz`` and drains on SIGTERM with exit
    0 (this machine has no card)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the replica would serve on it")
    d, _xd = _saved_classifier(tmp_path)
    epf = str(tmp_path / "ep.json")
    cmd = [sys.executable, "-m", "paddle_tpu_torch.serving.replica",
           "--model-dir", d, "--endpoint-file", epf]
    p = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    assert "no CUDA device" in p.stderr
    assert not os.path.exists(epf)
    proc = subprocess.Popen(cmd + ["--device", "cpu"], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 120
        while not os.path.exists(epf) and time.monotonic() < deadline:
            assert proc.poll() is None, proc.stdout.read()[-2000:]
            time.sleep(0.1)
        ep = json.load(open(epf))
        with urllib.request.urlopen(
                "http://127.0.0.1:%d/readyz" % ep["gateway_port"],
                timeout=10) as r:
            assert r.status == 200
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def test_controller_serves_port_replicas_on_the_cpu(tmp_path):
    """``FleetController(device="cpu")`` spawns real port replicas
    (``python -m paddle_tpu_torch.serving.replica --device cpu``) behind
    its router: ``/v1/infer`` through the router equals the in-process
    predictor's bits, tagged with the replica and version, and
    ``/v1/generate`` streams the seeded engine's tokens."""
    from paddle_tpu_torch.serving.gateway import decode_tensor, encode_tensor
    from paddle_tpu_torch.serving.replica import build_gpt_decode_engine
    from paddle_tpu_torch.tools.fleet_probe import (
        INFER_ROWS, infer_oracles, matching_bucket)

    d, xd = _saved_classifier(tmp_path)
    oracle = infer_oracles(d, xd, "cpu")
    assert sorted(oracle) == list(INFER_ROWS)
    eng = build_gpt_decode_engine(_SPEC, device="cpu").start()
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5]
    try:
        want = eng.generate(prompt, max_new_tokens=6).tokens(timeout=60)
    finally:
        eng.stop()
    ctrl = FleetController(
        model_dir=d, workdir=str(tmp_path / "work"), replicas=2,
        autoscale=False, seed=0, device="cpu",
        replica_args=["--gpt-decode", json.dumps(_SPEC)],
        replica_env={"FLAGS_serving_strict_compiles": "1"})
    try:
        ctrl.start(wait_ready_s=240)
        assert ctrl.ready_count() == 2
        for _ in range(4):
            st, body, hdrs = _post(ctrl.router.url("/v1/infer"),
                                   {"inputs": [encode_tensor(xd)]})
            assert st == 200
            got = [decode_tensor(t) for t in body["outputs"]]
            assert matching_bucket(got, oracle) is not None
            assert hdrs.get("X-Model-Version") == "1"
            assert hdrs.get("X-Replica-Id") in ("0", "1")
        st, events, _c, _g, _h = _sse_collect(
            ctrl.router.url("/v1/generate"),
            {"prompt_ids": prompt, "max_new_tokens": 6}, timeout=120)
        assert st == 200
        assert [e["token"] for e in events if "token" in e] == want
    finally:
        ctrl.stop()


_FAKE_NVCC = r"""#!%(python)s
import os, sys, time
out = sys.argv[sys.argv.index("-o") + 1]
with open(%(log)r, "a") as f:
    f.write("%%d\n" %% os.getpid())
time.sleep(1.0)
with open(out, "w") as f:
    f.write("not a library")
"""

_BUILD_ONE = r"""
import json, sys
from paddle_tpu_torch.kernels import _build
_build.BUILD_DIR = sys.argv[1]
out = _build.build(["flash_decode"])
print(json.dumps({"cached": out["flash_decode"]["cached"],
                  "builds": _build.builds}))
"""


def test_kernel_build_lock_builds_each_library_once(tmp_path):
    """Two processes build one library together (a fleet's replicas
    starting on one card): the file lock lets one run the compiler and
    the other find the library built. The compiler is a stub that logs
    its pid, sleeps and writes the output, so no ``nvcc`` is needed."""
    cuda = tmp_path / "cuda"
    (cuda / "bin").mkdir(parents=True)
    log = str(tmp_path / "nvcc.log")
    nvcc = cuda / "bin" / "nvcc"
    nvcc.write_text(_FAKE_NVCC % {"python": sys.executable, "log": log})
    nvcc.chmod(0o755)
    env = dict(os.environ, CUDA_HOME=str(cuda))
    build_dir = str(tmp_path / "_build")
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_ONE, build_dir],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-2000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert len(open(log).read().split()) == 1  # one compiler run
    assert sorted(o["cached"] for o in outs) == [False, True]
    assert sorted(o["builds"] for o in outs) == [0, 1]
    libs = [f for f in os.listdir(build_dir) if f.endswith(".so")]
    assert len(libs) == 1 and libs[0].startswith("libflash_decode-")
