"""Replica router — the serving fleet's single front door (port of
``paddle_tpu/serving/router.py``).

One gateway serves one process; a fleet serves one *address*.
The router is a thin L7 proxy over a dynamic set of replica gateways:

  HTTP client --> Router --pick: least-inflight ready backend-->
                      replica Gateway (/v1/infer | /v1/generate)

- **Health**: a background thread polls every backend's ``/readyz``
  each ``FLAGS_router_health_interval_s``; a 503 (the gateway's
  preemption-latch drain flip) or an unreachable socket excludes the
  backend from routing until it answers 200 again. A proxied request
  that hits a dead socket marks the backend not-ready immediately —
  the health thread's cadence never gates failover.
- **Routing**: least-inflight among ready backends of the active
  version (ties broken by id), tracked by the router's own in-flight
  accounting — the cheapest useful load signal, and the one that stays
  correct when a replica stalls.
- **Retry**: ``POST /v1/infer`` is idempotent by contract, so a
  connection-level failure (replica SIGKILLed mid-request, connect
  refused during the controller's respawn window) or a backend 503
  (drain began after the pick) transparently retries on another
  backend, up to ``FLAGS_router_retries`` times. A client sees its
  result, not the replica's death.
- **Streaming**: ``POST /v1/generate`` PINS to its backend — a decode
  stream lives in one engine's KV slot and cannot move. Failures
  before the backend responds retry like infer (nothing decoded,
  nothing sent); once the SSE stream is open, a replica death surfaces
  as the gateway's in-band ``data: {"error": ...}`` event followed by a
  clean chunked terminator, so the client's SSE parser ends sanely
  instead of seeing a torn socket.
- **Versioned rollout**: every backend carries a model version;
  ``set_active_version(v)`` atomically restricts routing to that
  version (``None`` routes all). The fleet controller flips it once
  the new version's replicas are warm, then drains the old ones.

Endpoints: ``POST /v1/infer`` and ``POST /v1/generate`` (proxied),
``GET /healthz`` (listener liveness), ``GET /readyz`` (200 while at
least one routable backend is ready — a fleet-level load balancer can
stack on top), ``GET /backends`` (state snapshot for operators and
probes). Metrics ride the registry: ``router_*`` counters /
gauges / latency histogram, so one ``/metrics`` scrape covers the
router beside whatever else the process runs.
"""

from __future__ import annotations

import http.client
import json
import os
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..fluid import flags as _flags
from ..fluid import profiler as _profiler
from ..observability import exporter as _obs_exporter
from ..observability import flight as _flight
from ..observability import registry as _obs_registry
from ..observability import trace as _trace
from . import kv_tier as _kv_tier
from .access_log import AccessLog
from .gateway import _MAX_BODY_BYTES

__all__ = ["Backend", "Router", "probe_readyz", "probe_readyz_body"]


def probe_readyz(host, port, timeout=1.0):
    """True iff ``GET /readyz`` on (host, port) answers 200 within
    ``timeout`` — the ONE readiness-probe implementation, shared by the
    router's health loop and the fleet controller's startup watch so
    'ready' can never mean two different things."""
    return probe_readyz_body(host, port, timeout=timeout)[0]


def probe_readyz_body(host, port, timeout=1.0):
    """``(ok, body_dict)`` form of the readiness probe: the 200 body
    now carries the replica's KV-tier advertisement (hot prefix-chain
    heads, block size, role) — the router's health loop reads it so
    affinity data rides the poll that already exists instead of a
    second request. A 200 with an unparseable body is still ready
    (affinity is an optimization; readiness is the contract)."""
    try:
        conn = http.client.HTTPConnection(host, port, timeout=timeout)
        try:
            conn.request("GET", "/readyz")
            resp = conn.getresponse()
            raw = resp.read()
            if resp.status != 200:
                return False, None
            try:
                body = json.loads(raw.decode("utf-8"))
            except (ValueError, UnicodeDecodeError):
                body = None
            return True, body if isinstance(body, dict) else None
        finally:
            conn.close()
    except (OSError, http.client.HTTPException):
        # refused/reset/timeout or a torn read (IncompleteRead /
        # BadStatusLine): not ready — never a probe-killing event
        return False, None


def _flag(name, override):
    return override if override is not None else _flags.get_flag(name)


# response headers worth relaying from a replica back to the client
# (identity + backpressure + the rollout-audit version tag)
_RELAY_HEADERS = (
    "Content-Type",
    "Retry-After",
    "X-Request-Id",
    "X-Replica-Id",
    "X-Model-Version",
)
# request headers forwarded to the replica (tenant/priority/id reach the
# replica gateway's admission control untouched)
_FORWARD_HEADERS = (
    "Content-Type",
    "X-Tenant-Id",
    "X-Priority",
    "X-Request-Id",
)


class Backend(object):
    """One routable replica gateway (+ its circuit-breaker state)."""

    __slots__ = ("id", "host", "port", "version", "ready", "inflight",
                 "fail_streak", "breaker_until", "probe_inflight",
                 "probe_t", "prefix_heads", "advert_block", "advert_t",
                 "affinity_score", "role", "adopted", "lease_t",
                 "lease_pid", "journal_version")

    def __init__(self, backend_id, host, port, version=0, ready=False,
                 adopted=False, journal_version=None):
        self.id = str(backend_id)
        self.host = str(host)
        self.port = int(port)
        self.version = int(version)
        self.ready = bool(ready)
        self.inflight = 0
        # durability provenance (stamped by the fleet controller on
        # adoption, refreshed by the health loop from the /readyz
        # lease): adopted = this backend predates the current
        # controller boot; journal_version = what the controller's
        # journal believed its version was; lease_t/lease_pid = the
        # last gateway lease seen (monotonic stamp + serving pid)
        self.adopted = bool(adopted)
        self.journal_version = (None if journal_version is None
                                else int(journal_version))
        self.lease_t = 0.0
        self.lease_pid = None
        # KV-tier advertisement (stamped by the health loop from the
        # /readyz body): the replica's hot prefix-chain head keys, its
        # paged block size, and when the advert was taken — _pick's
        # affinity scorer ignores adverts older than the staleness
        # bound, so a dead replica's heads can't black-hole traffic
        self.prefix_heads = frozenset()
        self.advert_block = 0
        self.advert_t = 0.0        # monotonic stamp of the last advert
        self.affinity_score = 0    # cached tokens of the LAST routed pick
        self.role = "mixed"
        # circuit breaker: consecutive request-path failures open it
        # (excluded from picks until breaker_until), then half-open —
        # a single probe request (probe_inflight) decides re-admission.
        # Orthogonal to `ready` on purpose: the health loop re-admits a
        # backend whose /readyz answers, but a FLAPPING replica (ready
        # yet failing requests) would then eat one transparent retry
        # from every in-flight request — the breaker is what remembers
        # the request-path verdict across health re-admissions.
        self.fail_streak = 0
        self.breaker_until = 0.0  # monotonic expiry of the OPEN state
        self.probe_inflight = False
        self.probe_t = 0.0        # when the half-open probe was admitted

    def breaker_state(self, now=None):
        if self.breaker_until <= 0.0:
            return "closed"
        now = time.monotonic() if now is None else now
        return "open" if now < self.breaker_until else "half_open"

    def as_dict(self):
        out = {
            "id": self.id,
            "host": self.host,
            "port": self.port,
            "version": self.version,
            "ready": self.ready,
            "inflight": self.inflight,
            "breaker": self.breaker_state(),
            "fail_streak": self.fail_streak,
            "role": self.role,
        }
        # affinity debuggability (/backends): what this backend
        # advertises, how it scored on its last routed request, and how
        # stale the advert is — without these, a misroute (stale advert,
        # empty heads, wrong block size) is undiagnosable from outside
        out["prefix_heads"] = len(self.prefix_heads)
        out["prefix_head_sample"] = sorted(self.prefix_heads)[:4]
        out["advert_block"] = self.advert_block
        out["advert_age_s"] = (
            round(time.monotonic() - self.advert_t, 3)
            if self.advert_t else None
        )
        out["affinity_score"] = self.affinity_score
        # durability provenance: adopted-vs-spawned, the journaled
        # version the adoption trusted, and the gateway lease age
        out["adopted"] = self.adopted
        out["journal_version"] = self.journal_version
        out["lease_age_s"] = (
            round(time.monotonic() - self.lease_t, 3)
            if self.lease_t else None
        )
        return out


class _ProxyFailure(Exception):
    """Connection-level failure against one backend. ``timeout=True``
    means the backend was SLOW, not dead — it keeps its ready state
    (the health loop owns that call), and pinned work isn't re-run."""

    def __init__(self, msg, timeout=False):
        super().__init__(msg)
        self.timeout = timeout


class _PayloadTooLarge(ValueError):
    """Request body over _MAX_BODY_BYTES — mapped to HTTP 413."""


class _GenCtx(object):
    """Per-generation failover context threaded through the SSE relay:
    the parsed request (to build resume forms), the router-receipt
    clock + client deadline (a failover must carry the REMAINING
    budget, never a fresh one), and the set of backends this
    generation already failed on."""

    __slots__ = ("parsed", "t_recv", "deadline_ms", "tried", "version")

    def __init__(self, parsed, t_recv, deadline_ms):
        self.parsed = parsed
        self.t_recv = t_recv
        self.deadline_ms = deadline_ms
        self.tried = set()
        # the MODEL VERSION of the backend that opened the stream: a
        # resume must land on the same version — during a rollout the
        # router's active version may already have flipped, and
        # re-prefilling on different weights would silently splice a
        # diverged continuation into a stream sold as token-exact
        self.version = None

    def resumable(self):
        """A generation can move replicas only if its continuation is
        deterministic: greedy always is; a temperature-sampled request
        must carry its seed (the engine-side seed-required rule). An
        unparseable body can't grow a resume form at all."""
        p = self.parsed
        if not isinstance(p, dict):
            return False
        prompt = p.get("prompt_ids")
        if not isinstance(prompt, list) or not prompt:
            return False
        t = p.get("temperature")
        sampled = (isinstance(t, (int, float))
                   and not isinstance(t, bool) and t > 0)
        return (not sampled) or p.get("seed") is not None


def _split_sse_frames(buf):
    """(complete_frames, rest): SSE frames end at a blank line — LF-LF
    (what this repo's gateways emit) or the spec-equally-valid
    CRLF-CRLF a foreign backend may use. The relay forwards COMPLETE
    frames only, so a backend death mid-frame never leaks half an
    event onto the client's wire — the torn tail is discarded and the
    resumed replica re-emits that token."""
    frames = []
    while True:
        i1 = buf.find(b"\n\n")
        i2 = buf.find(b"\r\n\r\n")
        if i2 >= 0 and (i1 < 0 or i2 < i1):
            frames.append(buf[:i2])
            buf = buf[i2 + 4:]
        elif i1 >= 0:
            frames.append(buf[:i1])
            buf = buf[i1 + 2:]
        else:
            return frames, buf


def _rewrite_spliced_done(frame, total_tokens, rid):
    """A SPLICED stream's relayed done event must describe the whole
    stream the client saw, not the final hop: the resumed gateway's
    ``tokens`` counts only its own continuation and its ``request_id``
    is the resume hop's — rewrite both to the stream-level truth (the
    full relayed count, the first hop's id). Non-done frames (tokens,
    in-band errors, comments) pass through untouched, as does every
    frame of an unspliced stream (the caller only rewrites after a
    failover)."""
    for line in frame.split(b"\n"):
        sline = line.rstrip(b"\r")
        if not sline.startswith(b"data: "):
            continue
        try:
            obj = json.loads(sline[len(b"data: "):].decode("utf-8"))
        except (UnicodeDecodeError, ValueError):
            return frame
        if not isinstance(obj, dict) or not obj.get("done"):
            return frame
        obj["tokens"] = int(total_tokens)
        if rid is not None:
            obj["request_id"] = rid
        return b"data: " + json.dumps(obj, sort_keys=True).encode("utf-8")
    return frame


def _frame_token(frame):
    """(token|None, terminal): the token carried by a ``data:`` event
    frame, and whether the frame ends the stream (done or in-band
    error). Non-JSON / comment frames parse as (None, False)."""
    for line in frame.split(b"\n"):
        line = line.rstrip(b"\r")  # CRLF-framed backends
        if not line.startswith(b"data: "):
            continue
        try:
            obj = json.loads(line[len(b"data: "):].decode("utf-8"))
        except (UnicodeDecodeError, ValueError):
            continue
        if not isinstance(obj, dict):
            continue
        if "token" in obj:
            try:
                return int(obj["token"]), False
            except (TypeError, ValueError):
                return None, False
        if "done" in obj or "error" in obj:
            return None, True
    return None, False


class Router(object):
    """Health-checked least-inflight HTTP router over replica gateways.

    The backend set is mutated live (the fleet controller adds a
    replica the moment its ``/readyz`` first answers 200 and removes it
    before draining it); requests already proxied to a removed backend
    complete — removal only stops NEW picks.
    """

    def __init__(self, port=None, host="127.0.0.1", health_interval_s=None,
                 retries=None, backend_timeout_s=None,
                 generate_retries=None, breaker_failures=None,
                 breaker_cooldown_s=None, access_log=None,
                 access_log_max_mb=None, clock=None):
        # the ROUTING-STATE clock (picks, breakers, advert staleness):
        # injectable so the fleet simulator can drive _pick/_mark_failed
        # on its virtual clock; the HTTP forwarding path stays on real
        # wall time (it never runs under the simulator)
        self._clock = clock or time.monotonic
        self.host = host
        self.port_requested = int(_flag("router_port", port))
        # the fleet's PUBLIC front door logs one JSONL line per request
        # (FLAGS_router_access_log; same writer + size rotation as the
        # gateway's): trace_id, backend chosen, retries, failover count
        self.access_log = AccessLog(
            _flag("router_access_log", access_log),
            max_mb=_flag("router_access_log_max_mb", access_log_max_mb),
        )
        self.health_interval_s = float(
            _flag("router_health_interval_s", health_interval_s)
        )
        self.retries = int(_flag("router_retries", retries))
        self.backend_timeout_s = float(
            _flag("router_backend_timeout_s", backend_timeout_s)
        )
        # durable generations: mid-stream backend death/timeout re-admits
        # the generation elsewhere (token-exact resume) up to this many
        # times per stream, within the request deadline; 0 = old
        # behavior (in-band error event)
        self.generate_retries = int(
            _flag("router_generate_retries", generate_retries)
        )
        # per-backend circuit breaker (0 failures = disabled)
        self.breaker_failures = int(
            _flag("router_breaker_failures", breaker_failures)
        )
        self.breaker_cooldown_s = float(
            _flag("router_breaker_cooldown_s", breaker_cooldown_s)
        )
        # cache-affinity staleness bound: an advert the health loop has
        # not refreshed within this window scores zero in _pick
        self.advert_ttl_s = float(_flags.get_flag("kv_tier_advert_ttl_s"))
        self._backends = {}  # id -> Backend
        self._active_version = None  # None = route every version
        self._lock = threading.Lock()
        self._httpd = None
        self._http_thread = None
        self._health_thread = None
        self._stop = threading.Event()
        self._started = False
        self._inflight_gauge = None
        self._ready_gauge = None
        self._breaker_gauge = None

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        if self._started:
            raise RuntimeError("router already started")
        self._stop.clear()
        handler = _make_handler(self)
        self._httpd = ThreadingHTTPServer(
            (self.host, self.port_requested), handler
        )
        self._httpd.daemon_threads = True
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="router_http", daemon=True
        )
        self._http_thread.start()
        self._health_thread = threading.Thread(
            target=self._health_loop, name="router_health", daemon=True
        )
        self._health_thread.start()
        self._started = True
        _obs_exporter.maybe_start_from_flags()
        self._inflight_gauge = lambda r=self: r.total_inflight()
        _obs_registry.register_gauge("router_inflight", self._inflight_gauge)
        self._ready_gauge = lambda r=self: r.ready_count()
        _obs_registry.register_gauge("router_backends_ready",
                                     self._ready_gauge)
        self._breaker_gauge = lambda r=self: r.breaker_open_count()
        _obs_registry.register_gauge("router_breaker_open",
                                     self._breaker_gauge)
        return self

    def stop(self):
        """Close the listener. Proxied requests run on daemon handler
        threads with their own bounded backend timeouts; the fleet
        controller stops the router only after draining the replicas,
        so nothing meaningful can still be in flight."""
        if not self._started:
            return
        self._started = False
        self._stop.set()
        if self._httpd is not None:
            try:
                self._httpd.shutdown()
                self._httpd.server_close()
            except Exception:
                pass
            self._httpd = None
        for t in (self._http_thread, self._health_thread):
            if t is not None and t.is_alive():
                t.join(timeout=5.0)
        self._http_thread = self._health_thread = None
        if self._inflight_gauge is not None:
            _obs_registry.unregister_gauge("router_inflight",
                                           self._inflight_gauge)
            self._inflight_gauge = None
        if self._ready_gauge is not None:
            _obs_registry.unregister_gauge("router_backends_ready",
                                           self._ready_gauge)
            self._ready_gauge = None
        if self._breaker_gauge is not None:
            _obs_registry.unregister_gauge("router_breaker_open",
                                           self._breaker_gauge)
            self._breaker_gauge = None
        # terminal moment for the front door: persist the flight
        # recorder + span black box (no-op when FLAGS_obs_dir unarmed)
        _obs_exporter.dump_blackbox()

    def __enter__(self):
        return self if self._started else self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    @property
    def port(self):
        return self._httpd.server_address[1] if self._httpd else None

    def url(self, path="/readyz"):
        if self._httpd is None:
            raise RuntimeError("router is not listening")
        return "http://%s:%d%s" % (self.host, self.port, path)

    # -- backend registry ----------------------------------------------------
    def add_backend(self, backend_id, host, port, version=0, ready=False,
                    adopted=False, journal_version=None):
        """Register (or replace) one replica gateway. ``ready=True``
        skips the first health-probe gap — the fleet controller adds a
        backend only after polling its ``/readyz`` itself. ``adopted``
        marks a backend inherited from a pre-restart pool (with the
        version the controller journal recorded for it) — provenance
        surfaced on ``/backends``, not a routing input."""
        b = Backend(backend_id, host, port, version=version, ready=ready,
                    adopted=adopted, journal_version=journal_version)
        with self._lock:
            self._backends[b.id] = b
        return b

    def remove_backend(self, backend_id):
        with self._lock:
            return self._backends.pop(str(backend_id), None)

    def set_active_version(self, version):
        """Atomically restrict routing to one model version (``None``
        routes all) — the rollout traffic flip."""
        with self._lock:
            self._active_version = (
                None if version is None else int(version)
            )

    @property
    def active_version(self):
        with self._lock:
            return self._active_version

    def backends(self):
        with self._lock:
            return [b.as_dict() for b in self._backends.values()]

    def ready_count(self):
        with self._lock:
            return sum(1 for b in self._backends.values()
                       if b.ready and self._routable(b))

    def total_inflight(self):
        with self._lock:
            return sum(b.inflight for b in self._backends.values())

    def breaker_open_count(self):
        now = self._clock()
        with self._lock:
            return sum(1 for b in self._backends.values()
                       if b.breaker_state(now) == "open")

    def _routable(self, b):
        return (self._active_version is None
                or b.version == self._active_version)

    def _pick(self, exclude=(), version=None, prompt_ids=None):
        """Least-inflight ready backend of the active version (ties by
        id, so picks are deterministic); reserves an inflight slot.
        ``version`` (a generate-resume pick) additionally pins to ONE
        model version regardless of the active-version filter — the
        resumed continuation must come from the same weights.
        Breaker-aware: OPEN backends are skipped outright; a HALF-OPEN
        backend is eligible for exactly ONE concurrent probe request —
        its zero inflight makes it the least-inflight pick, so the next
        request probes it promptly, but a traffic wave can't pile onto
        a replica that hasn't proven itself yet.

        ``prompt_ids`` arms CACHE-AFFINITY scoring: each eligible
        backend is scored by the expected cached tokens for this
        prompt's hash chain against its advertised head keys (a chain
        key at depth i names the WHOLE (i+1)-block prefix, so the
        deepest advertised match IS the expected hit length). The best
        positive scorer wins (ties by inflight then id); all-zero
        scores fall back to plain least-inflight — and an advert older
        than the staleness bound scores 0, so a dead replica's last
        advertisement can't keep attracting its prefix traffic."""
        now = self._clock()
        chain_cache = {}  # block size -> this prompt's chain keys
        with self._lock:
            ready = []
            for b in self._backends.values():
                if not b.ready or b.id in exclude:
                    continue
                if version is not None:
                    if b.version != version:
                        continue
                elif not self._routable(b):
                    continue
                state = b.breaker_state(now)
                if state == "open":
                    continue
                if state == "half_open" and b.probe_inflight:
                    # one probe at a time — but an ABANDONED probe (its
                    # request resolved neither success nor failure, e.g.
                    # the client vanished mid-relay) must not block
                    # re-admission forever: past the backend timeout it
                    # can no longer be outstanding, reclaim the slot
                    if now - b.probe_t <= self.backend_timeout_s:
                        continue
                score = self._affinity_score(b, prompt_ids, now,
                                             chain_cache)
                ready.append((b, state, score))
            if not ready:
                return None
            best = max(s for _b, _st, s in ready)
            if best > 0:
                b, state, _s = min(
                    ((b, st, s) for b, st, s in ready if s == best),
                    key=lambda x: (x[0].inflight, x[0].id),
                )
                _profiler.bump_counter("router_affinity_hits")
                b.affinity_score = best
            else:
                b, state, _s = min(ready,
                                   key=lambda x: (x[0].inflight, x[0].id))
                if prompt_ids:
                    _profiler.bump_counter("router_affinity_misses")
                b.affinity_score = 0
            if state == "half_open":
                b.probe_inflight = True
                b.probe_t = now
            b.inflight += 1
            return b

    def _affinity_score(self, b, prompt_ids, now, chain_cache):
        """Expected cached tokens on ``b`` for this prompt: the deepest
        advertised chain key, times the block size. Chain keys are
        computed once per (request, block size) and shared across
        backends via ``chain_cache``. Caller holds the lock."""
        if not prompt_ids or not b.prefix_heads or b.advert_block < 1:
            return 0
        if now - b.advert_t > self.advert_ttl_s:
            _profiler.bump_counter("router_affinity_stale")
            return 0
        bs = b.advert_block
        keys = chain_cache.get(bs)
        if keys is None:
            keys = _kv_tier.chain_keys(prompt_ids, bs)
            chain_cache[bs] = keys
        score = 0
        for i, key in enumerate(keys):
            if key in b.prefix_heads:
                score = (i + 1) * bs
        return score

    def _release(self, b):
        with self._lock:
            b.inflight = max(0, b.inflight - 1)
            # NOTE: probe_inflight is NOT cleared here — _release runs
            # for every request on the backend (e.g. a long-lived pinned
            # stream ending), and clearing unconditionally would reopen
            # the single-probe slot while the real probe is still out,
            # letting a traffic wave pile onto an unproven replica. The
            # probe's own terminal outcomes (_note_success /
            # _mark_failed) clear it; an abandoned probe is reclaimed by
            # _pick after the backend timeout.

    def _mark_failed(self, b):
        """A request-path connection failure is a stronger signal than
        the last health poll: stop routing to the backend immediately;
        the health loop re-admits it when /readyz answers again. The
        failure also feeds the per-backend circuit breaker: at
        ``breaker_failures`` CONSECUTIVE request-path failures the
        breaker opens for ``breaker_cooldown_s`` (excluded from picks
        even if /readyz flips healthy in between), then goes half-open
        for a single probe."""
        now = self._clock()
        with self._lock:
            b.ready = False
            b.probe_inflight = False
            b.fail_streak += 1
            if (self.breaker_failures > 0
                    and b.fail_streak >= self.breaker_failures):
                if b.breaker_state(now) != "open":
                    _profiler.bump_counter("router_breaker_open_total")
                b.breaker_until = now + self.breaker_cooldown_s
        _profiler.bump_counter("router_backend_failures")

    def _note_success(self, b):
        """The backend ANSWERED (any relayed status — even a 429 is a
        healthy replica talking): reset the failure streak and close the
        breaker. This is what ends a half-open probe in re-admission."""
        with self._lock:
            b.fail_streak = 0
            b.breaker_until = 0.0
            b.probe_inflight = False

    # -- health loop ---------------------------------------------------------
    def _health_loop(self):
        while not self._stop.wait(self.health_interval_s):
            with self._lock:
                targets = list(self._backends.values())
            # probe CONCURRENTLY: one wedged backend (dropped SYN, hung
            # accept) burning its full probe timeout must not delay
            # every other backend's health transition past the
            # configured cadence — re-admission latency is capacity
            # during exactly the degraded windows this loop exists for
            probes = []
            for b in targets:
                t = threading.Thread(target=self._probe_and_set,
                                     args=(b,), daemon=True)
                t.start()
                probes.append(t)
            for t in probes:
                t.join(timeout=3.0)  # stragglers finish on their own

    def _probe_and_set(self, b):
        try:
            ok, body = self._probe_ready(b)
        except Exception:
            # the supervision path must outlive ANY one bad probe — a
            # dead health loop would strand every _mark_failed backend
            # not-ready forever
            ok, body = False, None
        kv = body.get("kv") if isinstance(body, dict) else None
        with self._lock:
            # the backend may have been removed mid-probe; only flip
            # state on the instance (harmless if orphaned)
            b.ready = ok
            if isinstance(kv, dict):
                # the replica's KV-tier advertisement rides the health
                # poll: hot chain heads + block size + role, stamped
                # with THIS probe's clock so staleness is measurable
                heads = kv.get("heads")
                b.prefix_heads = frozenset(
                    h for h in heads if isinstance(h, str)
                ) if isinstance(heads, list) else frozenset()
                try:
                    b.advert_block = int(kv.get("block") or 0)
                except (TypeError, ValueError):
                    b.advert_block = 0
                b.advert_t = self._clock()
                role = kv.get("role")
                if role in ("prefill", "decode", "mixed"):
                    b.role = role
            lease = body.get("lease") if isinstance(body, dict) else None
            if isinstance(lease, dict):
                # gateway lease rides the same poll: age surfaced on
                # /backends, pid pins WHICH process answered (an
                # adopted backend's port could be re-bound by a
                # stranger after its real replica died)
                b.lease_t = self._clock()
                b.lease_pid = lease.get("pid")

    def _probe_ready(self, b):
        return probe_readyz_body(b.host, b.port,
                                 timeout=min(2.0, self.backend_timeout_s))


# -- HTTP proxy handler ------------------------------------------------------


def _make_handler(router):
    class _Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        server_version = "paddle-tpu-torch-router/1"
        timeout = 60.0

        def log_message(self, *args):
            pass

        # -- plumbing --------------------------------------------------------
        def _send_json(self, code, obj, headers=(), close=False):
            data = json.dumps(obj, sort_keys=True).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            if close:
                self.send_header("Connection", "close")
                self.close_connection = True
            # the router is authoritative for the trace id (it minted
            # or adopted it): stamp every response, including sheds
            # that never reached a replica
            if getattr(self, "_trace_id", None):
                self.send_header("X-Trace-Id", self._trace_id)
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def _read_body(self):
            try:
                n = int(self.headers.get("Content-Length", "0"))
            except ValueError:
                raise ValueError("bad Content-Length")
            if n <= 0:
                raise ValueError("missing request body")
            if n > _MAX_BODY_BYTES:
                # the router is the fleet's PUBLIC front door: the
                # same client-controlled-memory bound the gateway
                # enforces must hold here, before any buffering —
                # otherwise a huge declared Content-Length OOMs the
                # controller host without a backend ever seeing it
                raise _PayloadTooLarge(
                    "request body of %d bytes exceeds the %d-byte cap"
                    % (n, _MAX_BODY_BYTES)
                )
            return self.rfile.read(n)

        def _forward_headers(self):
            out = {}
            for k in _FORWARD_HEADERS:
                v = self.headers.get(k)
                if v is not None:
                    out[k] = v
            # context propagation: every hop of this request — first
            # attempt, infer retry, generate-resume re-admission —
            # carries the SAME trace_id with the router's span as the
            # remote parent, so the replicas' spans all join one tree
            if getattr(self, "_fwd_traceparent", None):
                out["traceparent"] = self._fwd_traceparent
            return out

        # -- GET -------------------------------------------------------------
        def do_GET(self):
            self._trace_id = None  # kept-alive reuse: no stale stamp
            path = self.path.split("?", 1)[0]
            if path == "/healthz":
                # liveness + the clock-anchor pair fleet_trace.py uses
                # to align this process's spans (ts_mono is the span
                # clock, ts the wall it maps to)
                self._send_json(200, dict(
                    {"status": "alive", "pid": os.getpid()},
                    **_trace.clock_anchor()))
            elif path == "/readyz":
                n = router.ready_count()
                if n > 0:
                    self._send_json(200, {
                        "status": "ready", "backends_ready": n,
                        "active_version": router.active_version,
                    })
                else:
                    self._send_json(503, {"status": "no_ready_backends"})
            elif path == "/backends":
                self._send_json(200, {
                    "active_version": router.active_version,
                    "backends": router.backends(),
                })
            else:
                self._send_json(404, {"error": "not found"})

        # -- POST ------------------------------------------------------------
        def do_POST(self):
            self._trace_id = None
            self._fwd_traceparent = None
            path = self.path.split("?", 1)[0]
            if path not in ("/v1/infer", "/v1/generate"):
                self._send_json(404, {"error": "not found"}, close=True)
                return
            # the fleet's front door owns the trace: adopt a caller's
            # W3C traceparent (a foreign mesh tracing through us) or
            # mint a fresh trace_id; every hop this request makes —
            # retries and mid-stream failover resumes included — reuses
            # the SAME id
            tp = _trace.parse_traceparent(self.headers.get("traceparent"))
            trace_id, remote_parent = tp if tp else (
                _trace.new_trace_id(), None
            )
            self._trace_id = trace_id
            # journey facts for the access log + flight recorder
            self._journey = {"backend": None, "retries": 0,
                             "failovers": 0}
            try:
                body = self._read_body()
            except _PayloadTooLarge as e:
                # rejects are logged too — "one line per request" means
                # abuse traffic is visible in the log, like the gateway
                self._send_json(413, {"error": str(e)}, close=True)
                self._log_request(path, 413, time.monotonic())
                return
            except ValueError as e:
                self._send_json(400, {"error": str(e)}, close=True)
                self._log_request(path, 400, time.monotonic())
                return
            # parse ONCE at receipt: the deadline clock starts here (the
            # router's own queue/forward time draws the client's budget
            # down), and /v1/generate failover needs the parsed form to
            # build resume bodies. An unparseable body forwards verbatim
            # — the replica's 400 is the answer
            t_recv = time.monotonic()
            parsed = self._parse_json(body)
            deadline_ms = self._deadline_of(parsed)
            _profiler.bump_counter("router_requests")
            t0 = time.monotonic()
            try:
                with _trace.trace_scope(trace_id, remote_parent), \
                        _trace.span("router_request", cat="router",
                                    endpoint=path) as sp:
                    # propagation must not depend on the ring buffer
                    # being armed: with the tracer flagged off the span
                    # records nothing, but the hops still need a parent
                    # id so the replicas' ids stay consistent. Prefer
                    # the caller's remote parent then — the replicas'
                    # spans chain to a span that really exists (in the
                    # foreign mesh) instead of a fabricated id
                    self._fwd_traceparent = _trace.format_traceparent(
                        trace_id,
                        sp.span_id or remote_parent or os.urandom(8).hex(),
                    )
                    if path == "/v1/infer":
                        status = self._proxy_json(path, body, parsed,
                                                  t_recv, deadline_ms)
                    else:
                        status = self._proxy_generate(body, parsed,
                                                      t_recv, deadline_ms)
                    if sp.args is not None:
                        sp.args["status"] = status
                        sp.args["backend"] = self._journey["backend"]
            except ConnectionError:
                status = 499  # client went away; nothing left to write
            except Exception as e:  # the handler thread must survive
                status = 500
                try:
                    self._send_json(500, {"error": repr(e)}, close=True)
                except Exception:
                    pass
            if status is not None and status < 400:
                _profiler.bump_histogram(
                    "router_latency_ms", (time.monotonic() - t0) * 1e3
                )
            self._log_request(path, status, t0)

        def _log_request(self, endpoint, status, t0):
            """One JSONL access-log line + one flight-recorder record
            per proxied request: the trace id, which backend answered,
            how many transparent retries and mid-stream failovers the
            client never saw. The router's log is what an operator
            greps FIRST — it names the replica to look at next."""
            j = getattr(self, "_journey", None) or {}
            rec = {
                "ts": time.time(),
                "endpoint": endpoint,
                "status": int(status) if status is not None else None,
                "ms": round((time.monotonic() - t0) * 1e3, 3),
                "trace_id": self._trace_id,
                "backend": j.get("backend"),
                "retries": j.get("retries", 0),
                "failovers": j.get("failovers", 0),
            }
            rid = self.headers.get("X-Request-Id")
            if rid:
                rec["request_id"] = rid
            router.access_log.write(rec)
            _flight.note(rec)
            if status is not None and status >= 500:
                _flight.dump_on_error()

        @staticmethod
        def _parse_json(body):
            try:
                obj = json.loads(body.decode("utf-8"))
            except (UnicodeDecodeError, ValueError):
                return None
            return obj if isinstance(obj, dict) else None

        @staticmethod
        def _deadline_of(parsed):
            if parsed is None:
                return None
            v = parsed.get("deadline_ms")
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                return None
            return float(v) if v > 0 else None

        @staticmethod
        def _remaining_ms(t_recv, deadline_ms):
            """The client budget LEFT after the router's own elapsed
            time (None = no deadline armed)."""
            if deadline_ms is None:
                return None
            return deadline_ms - (time.monotonic() - t_recv) * 1e3

        def _forward_body(self, body, parsed, t_recv, deadline_ms):
            """The bytes to forward: with a deadline armed, the body is
            re-serialized with ``deadline_ms`` decremented by the
            router's elapsed time — a replica (and, critically, a
            failover re-admission) can never be granted more budget
            than the client has left, so a resumed request 504s at the
            same wall-clock instant the unbroken one would. Returns
            None when the budget is already gone."""
            left = self._remaining_ms(t_recv, deadline_ms)
            if left is None:
                return body
            if left <= 0:
                return None
            return json.dumps(dict(parsed, deadline_ms=left),
                              sort_keys=True).encode("utf-8")

        def _send_deadline_504(self):
            _profiler.bump_counter("router_deadline_sheds")
            self._send_json(
                504,
                {"error": "client deadline exhausted at the router",
                 "reason": "deadline"},
                close=True,
            )
            return 504

        def _no_backend(self):
            _profiler.bump_counter("router_no_backend")
            self._send_json(
                503,
                {"error": "no ready replica for the active version",
                 "active_version": router.active_version},
                headers=(("Retry-After", "1"),), close=True,
            )
            return 503

        def _backend_request(self, b, path, body):
            """One proxied POST; returns (conn, resp). Raises
            _ProxyFailure on connection-level errors (the backend is
            marked not-ready)."""
            conn = http.client.HTTPConnection(
                b.host, b.port, timeout=router.backend_timeout_s
            )
            try:
                conn.request("POST", path, body=body,
                             headers=self._forward_headers())
                resp = conn.getresponse()
                return conn, resp
            except socket.timeout as e:
                # a healthy-but-slow replica (a long non-stream
                # generation) is NOT death: don't yank it from
                # rotation on the request path — that's the health
                # loop's judgment to make
                conn.close()
                _profiler.bump_counter("router_backend_timeouts")
                raise _ProxyFailure(str(e) or "backend timeout",
                                    timeout=True)
            except (OSError, http.client.HTTPException) as e:
                # OSError covers refused/reset; HTTPException covers a
                # replica dying between accept and status line
                # (BadStatusLine on a torn read)
                conn.close()
                router._mark_failed(b)
                raise _ProxyFailure(str(e))

        def _relay(self, resp, data, backend_id):
            headers = [(k, resp.headers[k]) for k in _RELAY_HEADERS
                       if k in resp.headers and k != "Content-Type"]
            headers.append(("X-Routed-Backend", backend_id))
            if getattr(self, "_trace_id", None):
                headers.append(("X-Trace-Id", self._trace_id))
            ctype = resp.headers.get("Content-Type", "application/json")
            self.send_response(resp.status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)
            return resp.status

        def _proxy_json(self, path, body, parsed, t_recv, deadline_ms,
                        gen_ctx=None):
            """Retrying proxy for idempotent JSON requests. A backend
            503 means the request was REJECTED unexecuted (drain began
            after the pick) — as retriable as a dead socket. Everything
            else, including 429 backpressure, is the replica's answer
            and relays verbatim. ``gen_ctx`` marks the /v1/generate
            path: a 200 SSE response hands off to the failover-capable
            stream relay, and pre-response timeouts shed instead of
            re-executing pinned work."""
            tried = set() if gen_ctx is None else gen_ctx.tried
            for attempt in range(router.retries + 1):
                fwd = self._forward_body(body, parsed, t_recv,
                                         deadline_ms)
                if fwd is None:
                    # the budget died in the router's own queue — the
                    # same 504 the replica's dispatch shed would return
                    return self._send_deadline_504()
                # /v1/generate bodies carry prompt_ids — the affinity
                # scorer's input; /v1/infer feeds score None (no chain)
                prompt = (parsed.get("prompt_ids")
                          if isinstance(parsed, dict) else None)
                b = router._pick(
                    exclude=tried,
                    prompt_ids=prompt if isinstance(prompt, list) else None,
                )
                if b is None:
                    return self._no_backend()
                tried.add(b.id)
                self._journey["backend"] = b.id
                if attempt:
                    _profiler.bump_counter("router_retries")
                    self._journey["retries"] += 1
                handed_off = False
                try:
                    conn, resp = self._backend_request(b, path, fwd)
                except _ProxyFailure as e:
                    router._release(b)
                    if e.timeout and gen_ctx is not None:
                        # a generation slower than the proxy timeout:
                        # re-executing it elsewhere would burn another
                        # replica's decode slots on work whose first
                        # copy may still be running — shed 504 instead
                        self._send_json(
                            504,
                            {"error": "backend timed out after %.0fs"
                                      % router.backend_timeout_s,
                             "reason": "backend_timeout"},
                            close=True,
                        )
                        return 504
                    continue
                try:
                    if gen_ctx is not None and resp.status == 200:
                        # /v1/generate with "stream": true answers SSE:
                        # hand the open response to the stream relay,
                        # which owns the connection/slot from here
                        ctype = resp.headers.get("Content-Type", "")
                        if "text/event-stream" in ctype:
                            handed_off = True
                            # resumes pin to the weights that opened
                            # the stream (see _GenCtx.version)
                            gen_ctx.version = b.version
                            return self._relay_stream(b, conn, resp,
                                                      gen_ctx)
                    try:
                        data = resp.read()
                    except socket.timeout:
                        # slow, not dead (see _backend_request)
                        _profiler.bump_counter("router_backend_timeouts")
                        if gen_ctx is not None:
                            self._send_json(
                                504,
                                {"error": "backend timed out mid-"
                                          "response",
                                 "reason": "backend_timeout"},
                                close=True,
                            )
                            return 504
                        continue
                    except (OSError, http.client.HTTPException):
                        # the replica died mid-response (reset or
                        # IncompleteRead): idempotent, so the next
                        # attempt re-executes safely
                        router._mark_failed(b)
                        continue
                    if resp.status == 503:
                        router._mark_failed(b)
                        continue
                    # the replica ANSWERED: feed the breaker's
                    # consecutive-failure reset before relaying
                    router._note_success(b)
                    return self._relay(resp, data, b.id)
                finally:
                    if not handed_off:
                        conn.close()
                        router._release(b)
            _profiler.bump_counter("router_no_backend")
            self._send_json(
                502,
                {"error": "every candidate replica failed "
                          "(%d attempted)" % len(tried)},
                close=True,
            )
            return 502

        def _proxy_generate(self, body, parsed, t_recv, deadline_ms):
            # pre-response failures retry exactly like infer (nothing
            # was decoded, nothing was sent); an open SSE stream pins —
            # but a DETERMINISTIC generation (greedy, or sampled with a
            # seed) survives its replica's mid-stream death via a
            # token-exact resume on another replica (_relay_stream)
            ctx = _GenCtx(parsed, t_recv, deadline_ms)
            return self._proxy_json("/v1/generate", body, parsed,
                                    t_recv, deadline_ms, gen_ctx=ctx)

        @staticmethod
        def _finished_reason(ctx, base, captured):
            """The finish_reason of a generation whose relayed tokens
            already satisfy its own termination rules (eos emitted, or
            the max_new_tokens budget reached) — None while more tokens
            are genuinely owed. The engine stops AT eos, so an eos id
            in the captured suffix is necessarily its final token."""
            p = ctx.parsed if isinstance(ctx.parsed, dict) else {}
            eos = p.get("eos_id")
            if (isinstance(eos, int) and not isinstance(eos, bool)
                    and eos in captured):
                return "eos"
            mn = p.get("max_new_tokens")
            if (isinstance(mn, (int, float)) and not isinstance(mn, bool)
                    and mn > 0 and base + len(captured) >= mn):
                return "length"
            return None

        def _resume_attempt(self, ctx, resume_tokens):
            """Try to re-admit an interrupted generation on a healthy
            replica: returns (backend, conn, resp) on success, or
            (None, None, reason) when the generation cannot continue.
            Each call consumes one pick; transient failures (dead
            socket, 503 drain) are the CALLER's to retry under its
            failover budget."""
            prompt = (ctx.parsed.get("prompt_ids")
                      if isinstance(ctx.parsed, dict) else None)
            nb = router._pick(
                exclude=ctx.tried, version=ctx.version,
                prompt_ids=prompt if isinstance(prompt, list) else None,
            )
            if nb is None:
                return None, None, "no healthy replica of the stream's " \
                                   "model version"
            rb = dict(ctx.parsed)
            rb["resume_tokens"] = resume_tokens
            left = self._remaining_ms(ctx.t_recv, ctx.deadline_ms)
            if left is not None:
                if left <= 0:
                    router._release(nb)
                    return None, None, "deadline"
                # the REMAINING budget, never a fresh one: the resumed
                # request must 504 at the same wall-clock instant the
                # unbroken one would
                rb["deadline_ms"] = left
            fwd = json.dumps(rb, sort_keys=True).encode("utf-8")
            try:
                nconn, nresp = self._backend_request(nb, "/v1/generate",
                                                     fwd)
            except _ProxyFailure:
                router._release(nb)
                ctx.tried.add(nb.id)
                return None, None, None  # transient — caller may retry
            ok = (nresp.status == 200
                  and "text/event-stream"
                  in nresp.headers.get("Content-Type", ""))
            if ok:
                return nb, nconn, nresp
            try:
                nresp.read()
            except Exception:  # noqa: BLE001 - drain is best-effort
                pass
            nconn.close()
            router._release(nb)
            ctx.tried.add(nb.id)
            if nresp.status == 503:
                # drain began after the pick: transient, try another
                router._mark_failed(nb)
                return None, None, None
            if nresp.status == 429:
                # backpressure shed (momentarily full admission queue /
                # rate bucket): transient by definition — NOT a failure
                # mark, and the stream's remaining failover budget may
                # find a freer replica
                return None, None, None
            # the replica REFUSED the resume form (validation, seed
            # rule): deterministic rejection, do not hammer the pool
            return None, None, "resume rejected (%d)" % nresp.status

        def _relay_stream(self, b, conn, resp, ctx):
            """Relay an open SSE stream and fail OVER a mid-stream
            replica death or timeout by resuming the generation
            token-exactly on another replica (durable generations).

            Only COMPLETE SSE frames are forwarded (buffered until the
            blank-line frame boundary), so the client's wire never
            carries half an event: on failover the continued stream
            splices cleanly after a ``: failover`` comment frame —
            every token exactly once, then the ordinary done event.
            The relay parses the token ids it forwards; prompt +
            relayed tokens + the request's seed/knobs ARE the resume
            form, so no state beyond this handler is needed. Bounded by
            ``FLAGS_router_generate_retries`` and the client deadline;
            unresumable cases (non-deterministic request, budget or
            deadline exhausted, no healthy replica, resume rejected)
            degrade to the in-band error event + clean terminator.

            read1, NOT readline: http.client's readline goes through
            _peek_chunked, which SWALLOWS the IncompleteRead of a
            truncated chunked stream and reports clean EOF — a replica
            death would look like a normal end of stream; read1
            raises."""
            self.send_response(200)
            for k in ("Content-Type", "Cache-Control", "X-Request-Id",
                      "X-Replica-Id", "X-Model-Version"):
                if k in resp.headers:
                    self.send_header(k, resp.headers[k])
            self.send_header("Transfer-Encoding", "chunked")
            self.send_header("X-Routed-Backend", b.id)
            if getattr(self, "_trace_id", None):
                self.send_header("X-Trace-Id", self._trace_id)
            self.end_headers()
            # tokens a client-sent resume form already covers: the
            # failover's resume body and emitted_count attribution both
            # continue the LOGICAL generation, not just this hop
            base = 0
            if (ctx.parsed
                    and isinstance(ctx.parsed.get("resume_tokens"), list)):
                base = len(ctx.parsed["resume_tokens"])
            # the id the first replica minted (relayed in the headers
            # above): router-synthesized terminal events must carry it
            # like every gateway-written one does
            rid = resp.headers.get("X-Request-Id")
            captured = []  # token ids relayed to the client (this req)
            failovers = 0
            cur, cconn, cresp = b, conn, resp
            while True:  # one iteration per backend hop
                fail = None  # ("timeout"|"death", detail) on loss
                finished = False
                buf = b""
                try:
                    while True:
                        try:
                            data = cresp.read1(65536)
                        except socket.timeout as e:
                            # slow, not dead: no failover mark — but the
                            # CLIENT's stream can still move replicas
                            _profiler.bump_counter(
                                "router_backend_timeouts")
                            fail = ("timeout", str(e) or "backend timeout")
                            break
                        except (OSError,
                                http.client.HTTPException) as e:
                            router._mark_failed(cur)
                            fail = ("death", str(e) or repr(e))
                            break
                        if not data:
                            # clean chunked terminator: the gateway
                            # always precedes it with done/error, so
                            # this is the stream's legitimate end
                            finished = True
                            break
                        buf += data
                        frames, buf = _split_sse_frames(buf)
                        for fr in frames:
                            tok, terminal = _frame_token(fr)
                            if tok is not None:
                                captured.append(tok)
                            if terminal and failovers:
                                # spliced stream: the done event must
                                # carry stream-level tokens/request_id,
                                # not the final hop's locals
                                fr = _rewrite_spliced_done(
                                    fr, len(captured), rid)
                            # raw frame bytes otherwise: no decode/
                            # encode (UTF-8 sequences split by read1
                            # stay intact inside the buffered frame)
                            self._chunk(fr + b"\n\n")
                            if terminal:
                                finished = True
                        if finished:
                            break
                except OSError:
                    # the CLIENT went away: stop pulling tokens for
                    # nobody
                    cconn.close()
                    router._release(cur)
                    return 499
                cconn.close()
                router._release(cur)
                if finished:
                    if fail is None:
                        router._note_success(cur)
                    try:
                        self._chunk_end()
                    except OSError:
                        return 499
                    return 200
                ctx.tried.add(cur.id)
                # the generation may already be COMPLETE: a replica
                # dying in the gap between its last token frame and the
                # done frame (exactly where the chaos hook kills) would
                # produce a resume form every engine REJECTS (budget
                # spent / eos already emitted). The router holds every
                # token, so it synthesizes the done event instead of
                # erroring a fully-delivered generation.
                fin = self._finished_reason(ctx, base, captured)
                if fin is not None:
                    p = ctx.parsed or {}
                    ev = {"done": True, "finish_reason": fin,
                          "tokens": len(captured),
                          "emitted_count": base + len(captured),
                          "synthesized": True,
                          # the state every gateway-written terminal
                          # event carries (seed/knobs echoed from the
                          # request the router already parsed)
                          "seed": p.get("seed"),
                          "temperature": p.get("temperature"),
                          "top_k": p.get("top_k"),
                          "top_p": p.get("top_p")}
                    if rid is not None:
                        ev["request_id"] = rid
                    try:
                        self._chunk("data: %s\n\n" % json.dumps(
                            ev, sort_keys=True))
                        self._chunk_end()
                    except OSError:
                        return 499
                    return 200
                # -- failover: resume the generation elsewhere ---------
                reason = None
                if not ctx.resumable():
                    reason = "request is not resumable (sampled " \
                             "without a seed, or unparseable)"
                spliced = False
                while reason is None and failovers < router.generate_retries:
                    failovers += 1
                    resume = None
                    if ctx.parsed.get("resume_tokens"):
                        resume = list(ctx.parsed["resume_tokens"])
                    nb, nconn, nresp = self._resume_attempt(
                        ctx, (resume or []) + captured
                    )
                    if nb is None:
                        reason = nresp  # terminal reason | None=transient
                        if reason is None and \
                                failovers >= router.generate_retries:
                            reason = "failover budget exhausted"
                        continue
                    _profiler.bump_counter("router_generate_failovers")
                    self._journey["failovers"] += 1
                    self._journey["backend"] = nb.id
                    # the failover seam as a TRACE event: an instant
                    # mark inside the router span's context naming both
                    # replicas — the merged fleet trace links the dead
                    # backend's segment to the survivor's through it
                    _trace.instant(
                        "generate_failover", cat="router",
                        from_backend=cur.id, to_backend=nb.id,
                        resume_at=base + len(captured),
                    )
                    try:
                        # attributable seam: an SSE COMMENT frame (":"
                        # prefix — every spec-compliant parser ignores
                        # it), so the client's data stream stays pure
                        self._chunk(
                            ": failover from=%s to=%s resume_at=%d\n\n"
                            % (cur.id, nb.id, base + len(captured))
                        )
                    except OSError:
                        nconn.close()
                        router._release(nb)
                        return 499
                    cur, cconn, cresp = nb, nconn, nresp
                    spliced = True
                    break
                if spliced:
                    continue
                if reason is None:
                    reason = "failover budget exhausted" \
                        if router.generate_retries > 0 else \
                        "failover disabled (router_generate_retries=0)"
                # -- give up: the in-band error contract ---------------
                kind, detail = fail
                p = ctx.parsed or {}
                # the same reconstruction state every other terminal
                # generate event carries: this is THE path where the
                # client must resume by itself
                state = {"emitted_count": base + len(captured),
                         "resume": reason, "backend": cur.id,
                         "seed": p.get("seed"),
                         "temperature": p.get("temperature"),
                         "top_k": p.get("top_k"),
                         "top_p": p.get("top_p")}
                try:
                    if kind == "timeout":
                        self._chunk("data: %s\n\n" % json.dumps(dict(
                            {"error": "backend timed out mid-stream "
                                      "after %.0fs"
                                      % router.backend_timeout_s,
                             "reason": "backend_timeout"}, **state)))
                        self._chunk_end()
                        return 504
                    _profiler.bump_counter("router_stream_errors")
                    self._chunk("data: %s\n\n" % json.dumps(dict(
                        {"error": "replica lost mid-stream: %s"
                                  % detail}, **state)))
                    self._chunk_end()
                    return 502
                except OSError:
                    return 499

        def _chunk(self, data):
            if isinstance(data, str):
                data = data.encode("utf-8")
            self.wfile.write(b"%x\r\n" % len(data))
            self.wfile.write(data)
            self.wfile.write(b"\r\n")
            self.wfile.flush()

        def _chunk_end(self):
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()

    return _Handler
