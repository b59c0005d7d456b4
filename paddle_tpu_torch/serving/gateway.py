"""HTTP serving gateway — the multi-tenant network front door (port of
``paddle_tpu/serving/gateway.py``).

Everything below this module is in-process: the micro-batcher, the
bucket ladder, the KV-cache decode engine, the strict build gate. The
gateway is the integration layer that turns them into a *service*:

  HTTP client --> [admission control] --> InferenceServer.infer()
                    |                      (micro-batcher + buckets)
                    +-----------------> InferenceServer.generate()
                                           (DecodeEngine, SSE stream)

Handler threads only decode JSON, enqueue and write: every tensor that
reaches the card goes through the batcher's workers or the engine's
loop, as for an in-process caller. A paged engine with a prefix index
exports its chains on ``/v1/kv/prefill`` (read out of the pool on the
engine's loop thread) and advertises its block size and chain heads on
``/readyz``; a replica without a paged prefix index answers
``/v1/kv/prefill`` 503 and advertises its role only.

Endpoints (stdlib ``http.server`` threaded listener, one handler thread
per in-flight request):

- ``POST /v1/infer`` — JSON tensors in, JSON tensors out, through the
  dynamic batcher (concurrent HTTP clients coalesce into device
  batches exactly like in-process callers);
- ``POST /v1/generate`` — prompt ids in; chunked **SSE** token stream
  out (one ``data:`` event per generated token riding the engine's
  ``GenerationStream``), or a single JSON body with ``"stream": false``;
- ``GET /healthz`` — liveness (always 200 while the process runs);
- ``GET /readyz`` — readiness; flips 503 the moment the preemption
  latch is set (``checkpoint.preempt``) or a drain begins, so a load
  balancer stops routing BEFORE the listener closes — the same latch
  the observability exporter's ``/healthz`` reads.

Admission control sits in FRONT of the engine, per tenant
(``X-Tenant-Id`` header, "anon" when absent):

- token-bucket rate limit (``FLAGS_gateway_rate_limit_rps`` refill,
  ``FLAGS_gateway_rate_burst`` capacity) — over it, 429 + Retry-After;
- max-inflight quota (``FLAGS_gateway_tenant_max_inflight``) — a
  flooding tenant 429s at its own quota instead of starving the rest;
- a global cap (``FLAGS_gateway_max_inflight``): beyond it requests
  WAIT in priority order — ``X-Priority: interactive`` (default) is
  granted freed slots before ``batch`` — up to
  ``FLAGS_gateway_admit_timeout_ms``, then shed.

Engine backpressure maps faithfully: ``ServerOverloadedError`` (shed at
admission by the batcher/engine) -> 429 with the engine's own
retry-after hint; ``DeadlineExceededError`` (shed at dispatch) -> 504.
The two shed points stay distinguishable in metrics
(``gateway_shed_admission`` vs ``gateway_shed_dispatch``).

Every request gets an id (``X-Request-Id`` or generated), one JSONL
access-log line (``FLAGS_gateway_access_log``), a ``gateway_request``
span on the handler thread (it time-contains the batcher's
``serving_dispatch``/``predictor_run`` spans, which run on their worker
threads — Perfetto lines them up by containment), and ``gateway_*``
counters/histograms on the registry, so the existing ``/metrics``
exporter publishes per-tenant request/shed/latency with no extra
wiring.

Graceful drain: ``stop()`` (or SIGTERM via ``install_sigterm()``, which
sets the shared preemption latch) flips ``/readyz`` to 503, rejects new
work with 503, waits for every in-flight request — including mid-flight
SSE streams — to complete (bounded by ``FLAGS_gateway_drain_timeout_s``),
and only then closes the listener.
"""

from __future__ import annotations

import http.client
import inspect
import itertools
import json
import os
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..checkpoint import preempt as _preempt
from ..fluid import flags as _flags
from ..fluid import profiler as _profiler
from ..testing import chaos as _chaos
from ..observability import exporter as _obs_exporter
from ..observability import flight as _flight
from ..observability import registry as _obs_registry
from ..observability import trace as _trace
from . import kv_tier as _kv_tier
from .access_log import AccessLog
from .batcher import (
    DeadlineExceededError,
    ServerOverloadedError,
    ServingError,
)

__all__ = ["Gateway", "encode_tensor", "decode_tensor"]


def _flag(name, override):
    return override if override is not None else _flags.get_flag(name)


# -- JSON tensor wire format -------------------------------------------------
# {"data": <nested lists>, "dtype": "float32", "shape": [2, 3]} — shape
# optional (inferred from nesting), dtype defaults to float32. Exact for
# float32: every float32 is exactly a double, json round-trips the
# double, and the cast back recovers the original bits.


def decode_tensor(obj):
    if not isinstance(obj, dict) or "data" not in obj:
        raise ValueError(
            "tensor must be {'data': ..., 'dtype': ..., 'shape': ...}"
        )
    try:
        # `or`: a JSON null dtype means "default" (float32), it must
        # not fall through to np.dtype(None) == float64
        dt = np.dtype(obj.get("dtype") or "float32")
    except TypeError:
        # np.dtype raises TypeError for unknown names; a malformed
        # client body must map to 400, not the generic 500 path
        raise ValueError("unknown dtype %r" % (obj.get("dtype"),))
    try:
        arr = np.asarray(obj["data"], dtype=dt)
    except (TypeError, ValueError):
        raise ValueError("tensor data does not parse as %s" % dt)
    if obj.get("shape") is not None:
        arr = arr.reshape([int(d) for d in obj["shape"]])
    return arr


def encode_tensor(arr):
    arr = np.asarray(arr)
    return {"data": arr.tolist(), "shape": list(arr.shape),
            "dtype": str(arr.dtype)}


_SCHED_KW_CACHE = {}


def _accepts_sched_kwargs(fn):
    """True when ``fn`` (a server's generate) can take the scheduling
    identity kwargs (priority/tenant) — explicitly or via **kwargs.
    Cached by the bound method's underlying function."""
    key = getattr(fn, "__func__", fn)
    hit = _SCHED_KW_CACHE.get(key)
    if hit is None:
        try:
            sig = inspect.signature(fn)
            params = sig.parameters.values()
            hit = any(p.kind is inspect.Parameter.VAR_KEYWORD
                      for p in params) or (
                "priority" in sig.parameters
                and "tenant" in sig.parameters)
        except (TypeError, ValueError):
            hit = False
        _SCHED_KW_CACHE[key] = hit
        if len(_SCHED_KW_CACHE) > 256:  # bespoke-fake churn bound
            _SCHED_KW_CACHE.clear()
            _SCHED_KW_CACHE[key] = hit
    return hit


# -- admission control -------------------------------------------------------


# request bodies are buffered in the handler thread: bound them so a
# client-supplied Content-Length cannot OOM the process (same
# client-controlled-resource class as the tenant-table cap)
_MAX_BODY_BYTES = 64 * 1024 * 1024


class _PayloadTooLarge(ValueError):
    """Request body over _MAX_BODY_BYTES — mapped to HTTP 413."""


class _AdmissionDenied(ServingError):
    """Internal: request shed at GATEWAY admission (never dispatched).
    ``reason`` in {"ratelimit", "quota", "overload"}."""

    def __init__(self, reason, msg, retry_after_ms=1000):
        super().__init__(msg)
        self.reason = reason
        self.retry_after_ms = max(1, int(retry_after_ms))


class _TokenBucket(object):
    """Classic token bucket: ``rate`` tokens/sec refill into ``burst``
    capacity; one token per request. Not thread-safe on its own — the
    controller's lock serializes access. ``clock`` is injectable (the
    fleet simulator feeds its virtual clock; default wall monotonic)."""

    __slots__ = ("rate", "burst", "tokens", "t", "_clock")

    def __init__(self, rate, burst, clock=None):
        self.rate = float(rate)
        self.burst = float(max(1, burst))
        self.tokens = self.burst
        self._clock = clock or time.monotonic
        self.t = self._clock()

    def try_take(self):
        """None on success, else seconds until a token is available."""
        now = self._clock()
        self.tokens = min(self.burst,
                          self.tokens + (now - self.t) * self.rate)
        self.t = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return None
        return (1.0 - self.tokens) / self.rate


# shared rate bucket for the >_MAX_TRACKED_TENANTS long tail — a
# sentinel key no client-supplied tenant string can equal
_OVERFLOW_BUCKET = object()


class _Admission(object):
    """Per-tenant rate limit + inflight quota + global cap with
    priority-ordered waiting. ``admit()`` either returns (after
    reserving an inflight slot) or raises ``_AdmissionDenied``;
    ``release()`` frees the slot and wakes waiters — interactive
    waiters are granted freed capacity before batch waiters.

    The decision chain lives in small ``*_locked`` primitives so two
    callers share ONE policy: the gateway's blocking ``admit()`` and
    the fleet simulator's event-driven ``try_admit``/``try_grant``
    (which parks virtually instead of on the condition). ``clock`` is
    injectable for the same reason — the simulator feeds its virtual
    clock and the rate buckets/deadlines follow it."""

    def __init__(self, rate_rps, burst, tenant_max_inflight, max_inflight,
                 admit_timeout_ms, clock=None):
        self.rate_rps = float(rate_rps)
        self.burst = int(burst)
        self.tenant_max = int(tenant_max_inflight)
        self.global_max = int(max_inflight)
        self.admit_timeout_s = float(admit_timeout_ms) / 1e3
        self._clock = clock or time.monotonic
        self._buckets = {}
        self._inflight = {}
        self._total = 0
        self._waiting = {"interactive": 0, "batch": 0}
        self._cond = threading.Condition()

    @property
    def total_inflight(self):
        with self._cond:
            return self._total

    def waiting_by_class(self):
        """{priority_class: parked-waiter count}: the QUEUED (not yet
        admitted) pressure — what the ``gateway_admit_waiting`` gauges
        export and the SLO policy / simulator read. Grant-time ordering
        alone made this invisible: a batch flood parked on the cap
        looked identical to an idle gateway."""
        with self._cond:
            return dict(self._waiting)

    def _check_rate_locked(self, tenant):
        # rate limit: cheapest check first, fail fast with the
        # bucket's own refill estimate as the retry hint. Buckets
        # key on the RAW tenant name but bounded (the header is
        # client data): past _MAX_TRACKED_TENANTS distinct
        # tenants the long tail shares one sentinel-keyed
        # overflow bucket — a sentinel, not a name, so no real
        # tenant (not even one literally called "overflow") can
        # collide into it, and sanitization collisions ("a-b" vs
        # "a.b") can't couple two tenants' rates
        if self.rate_rps <= 0:
            return
        key = tenant
        if (key not in self._buckets
                and len(self._buckets) >= _MAX_TRACKED_TENANTS):
            key = _OVERFLOW_BUCKET
        bucket = self._buckets.get(key)
        if bucket is None:
            bucket = self._buckets[key] = _TokenBucket(
                self.rate_rps, self.burst, clock=self._clock
            )
        wait_s = bucket.try_take()
        if wait_s is not None:
            raise _AdmissionDenied(
                "ratelimit",
                "tenant %r over %.3g req/s rate limit" %
                (tenant, self.rate_rps),
                retry_after_ms=wait_s * 1e3,
            )

    def _check_quota_locked(self, tenant):
        # tenant quota: the isolation knob — one tenant's flood caps at
        # its own share, the others' headroom survives
        if (self.tenant_max > 0
                and self._inflight.get(tenant, 0) >= self.tenant_max):
            raise _AdmissionDenied(
                "quota",
                "tenant %r at max inflight %d" %
                (tenant, self.tenant_max),
                # a slot frees when one of the tenant's own requests
                # completes; no better estimate than "soon"
                retry_after_ms=50,
            )

    def _cap_blocked_locked(self, cls):
        # global cap, interactive ahead of batch — a batch request only
        # takes capacity while no interactive request is waiting
        return self._total >= self.global_max or (
            cls == "batch" and self._waiting["interactive"] > 0
        )

    def _grant_locked(self, tenant):
        self._inflight[tenant] = self._inflight.get(tenant, 0) + 1
        self._total += 1

    def _try_admit_locked(self, tenant, priority, first=True):
        """One admission attempt (caller holds the lock): the full
        rate→quota→cap chain on the ``first`` attempt; on a wake-up
        retry (``first=False``) the cap plus the post-wait quota
        re-check — several same-tenant requests can pass the pre-wait
        check with 0 inflight, park on the cap, then all wake; without
        the re-check they would all admit and exceed the tenant's
        share. Returns None on grant (slot reserved) or "wait" when
        the request must park; raises _AdmissionDenied otherwise."""
        cls = "batch" if priority == "batch" else "interactive"
        if first:
            self._check_rate_locked(tenant)
            self._check_quota_locked(tenant)
        if self._cap_blocked_locked(cls):
            return "wait"
        if not first:
            self._check_quota_locked(tenant)
        self._grant_locked(tenant)
        return None

    # -- event-driven drivers (the fleet simulator) ---------------------
    def try_admit(self, tenant, priority):
        """Non-blocking first attempt: None on grant, "wait" when the
        caller should park (track the park via note_wait_start/_end and
        retry with try_grant on release/deadline events); raises like
        ``admit()``."""
        with self._cond:
            return self._try_admit_locked(tenant, priority, first=True)

    def try_grant(self, tenant, priority):
        """Wake-up retry for a parked caller (post-wait semantics)."""
        with self._cond:
            return self._try_admit_locked(tenant, priority, first=False)

    def note_wait_start(self, priority):
        cls = "batch" if priority == "batch" else "interactive"
        with self._cond:
            self._waiting[cls] += 1

    def note_wait_end(self, priority):
        cls = "batch" if priority == "batch" else "interactive"
        with self._cond:
            self._waiting[cls] = max(0, self._waiting[cls] - 1)
            if cls == "interactive" and self._waiting["interactive"] == 0:
                # unblock batch waiters parked on the priority predicate
                self._cond.notify_all()

    def admit(self, tenant, priority):
        cls = "batch" if priority == "batch" else "interactive"
        with self._cond:
            if self._try_admit_locked(tenant, priority, first=True) is None:
                return
            # blocked on the global cap (or the interactive-first
            # predicate): WAIT, bounded by the admit timeout
            t_wait = self._clock()
            deadline = t_wait + self.admit_timeout_s
            self._waiting[cls] += 1
            try:
                while True:
                    remaining = deadline - self._clock()
                    if remaining <= 0:
                        raise _AdmissionDenied(
                            "overload",
                            "gateway at max inflight %d (%s waited %.0fms)"
                            % (self.global_max, priority,
                               self.admit_timeout_s * 1e3),
                            retry_after_ms=self.admit_timeout_s * 1e3,
                        )
                    self._cond.wait(remaining)
                    if not self._cap_blocked_locked(cls):
                        break
            finally:
                self._waiting[cls] -= 1
                if cls == "interactive" and self._waiting["interactive"] == 0:
                    # unblock batch waiters parked on the
                    # interactive-priority predicate
                    self._cond.notify_all()
            _profiler.bump_histogram(
                "gateway_admit_wait_ms",
                (self._clock() - t_wait) * 1e3,
            )
            self._check_quota_locked(tenant)  # post-wait re-check
            self._grant_locked(tenant)

    def release(self, tenant):
        with self._cond:
            n = self._inflight.get(tenant, 0) - 1
            if n > 0:
                self._inflight[tenant] = n
            else:
                self._inflight.pop(tenant, None)
            self._total -= 1
            self._cond.notify_all()


# the JSONL access-log writer (with size-based rotation) moved to
# serving/access_log.py — one helper shared with the router's front
# door, so the two logs can never drift apart in format or bounding

_request_ids = itertools.count(1)  # .__next__ atomic under the GIL

# X-Tenant-Id is CLIENT-CONTROLLED: per-tenant metric names and rate
# buckets must not let an attacker grow process memory / Prometheus
# cardinality without bound. The first _MAX_TRACKED_TENANTS distinct
# tenants get their own slug (and so their own metric series and token
# bucket); everyone after that shares the "overflow" slug+bucket. The
# inflight-quota map needs no bound — entries pop at zero.
_MAX_TRACKED_TENANTS = 256


class _TenantTable(object):
    """Bounded tenant -> prometheus-safe slug map (process-wide: the
    metric registry the slugs land in is process-global too)."""

    def __init__(self, cap=_MAX_TRACKED_TENANTS):
        self.cap = int(cap)
        self._map = {}
        self._lock = threading.Lock()

    def slug(self, tenant):
        with self._lock:
            s = self._map.get(tenant)
            if s is None:
                if len(self._map) >= self.cap:
                    return "overflow"
                s = _obs_registry.prom_name(tenant).lower()
                self._map[tenant] = s
            return s


_tenants = _TenantTable()


def _tenant_slug(tenant):
    """Prometheus-safe tenant fragment for per-tenant metric families
    (bounded — see _TenantTable)."""
    return _tenants.slug(tenant)


# -- the gateway -------------------------------------------------------------


class Gateway(object):
    """HTTP front door over an ``InferenceServer`` (whose attached
    ``DecodeEngine``, if any, serves ``/v1/generate``). ``None``
    parameters resolve from the ``FLAGS_gateway_*`` knobs.

    Usage::

        server = serving.InferenceServer(pred, decode_engine=engine)
        server.start(warmup_inputs=[x])
        gw = serving.Gateway(server, port=8500).start()
        gw.install_sigterm()       # SIGTERM -> drain -> close listener
        ...
        gw.stop()                  # graceful: drains in-flight first
    """

    def __init__(self, server, port=None, host="127.0.0.1",
                 rate_limit_rps=None, rate_burst=None,
                 tenant_max_inflight=None, max_inflight=None,
                 admit_timeout_ms=None, drain_timeout_s=None,
                 access_log=None, access_log_max_mb=None,
                 extra_headers=None, role=None):
        self.server = server
        self.host = host
        # fleet KV-tier role: "prefill" replicas compute + publish
        # chain blocks over /v1/kv/prefill; "decode" replicas own
        # slots and pull published blocks on admission miss; "mixed"
        # (default, and the only pre-role behavior) does both locally.
        # Advertised on /readyz so the router and operators see it.
        self.role = str(role or "mixed")
        if self.role not in ("prefill", "decode", "mixed"):
            raise ValueError("role must be prefill|decode|mixed, got %r"
                             % (role,))
        self.kv_peers_file = str(_flags.get_flag("kv_tier_peers_file"))
        self.kv_pull_min_tokens = int(
            _flags.get_flag("kv_tier_pull_min_tokens")
        )
        self.kv_pull_timeout_s = float(
            _flags.get_flag("kv_tier_pull_timeout_s")
        )
        # static response headers stamped on every reply (fleet
        # replicas tag X-Replica-Id / X-Model-Version so the router and
        # rollout audits can attribute each answer)
        self.extra_headers = dict(extra_headers or {})
        self.port_requested = int(_flag("gateway_port", port))
        self.drain_timeout_s = float(
            _flag("gateway_drain_timeout_s", drain_timeout_s)
        )
        self.admission = _Admission(
            _flag("gateway_rate_limit_rps", rate_limit_rps),
            _flag("gateway_rate_burst", rate_burst),
            _flag("gateway_tenant_max_inflight", tenant_max_inflight),
            _flag("gateway_max_inflight", max_inflight),
            _flag("gateway_admit_timeout_ms", admit_timeout_ms),
        )
        self.access_log = AccessLog(
            _flag("gateway_access_log", access_log),
            max_mb=_flag("gateway_access_log_max_mb", access_log_max_mb),
        )
        self._httpd = None
        self._http_thread = None
        self._started = False
        self._draining = False
        self._drain_cond = threading.Condition()
        self._inflight = 0
        self._inflight_gauge = None
        self._draining_gauge = None
        self._waiting_gauges = {}
        self._prev_sigterm = None
        self._sig_installed = False
        self._drain_watch = None
        self._stop_watch = threading.Event()
        self._stopped = threading.Event()

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        if self._started:
            raise RuntimeError("gateway already started")
        handler = _make_handler(self)
        self._httpd = ThreadingHTTPServer(
            (self.host, self.port_requested), handler
        )
        self._httpd.daemon_threads = True
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="gateway_http",
            daemon=True,
        )
        self._http_thread.start()
        self._draining = False
        self._started = True
        # telemetry: the obs exporter lights up /metrics etc. from
        # FLAGS_obs_* (no-op when disarmed) — gateway metrics ride the
        # same registry, so one scrape covers engine + gateway
        _obs_exporter.maybe_start_from_flags()
        self._inflight_gauge = lambda g=self: g._inflight
        _obs_registry.register_gauge("gateway_inflight",
                                     self._inflight_gauge)
        self._draining_gauge = lambda g=self: 1.0 if g._draining else 0.0
        _obs_registry.register_gauge("gateway_draining",
                                     self._draining_gauge)
        # queued (not yet admitted) pressure per priority class — the
        # signal the SLO policy and the fleet simulator read; renders
        # as labeled series gateway_admit_waiting{class="..."}
        self._waiting_gauges = {}
        for _cls in ("interactive", "batch"):
            fn = (lambda g=self, c=_cls:
                  g.admission.waiting_by_class().get(c, 0))
            gname = 'gateway_admit_waiting{class="%s"}' % _cls
            self._waiting_gauges[gname] = fn
            _obs_registry.register_gauge(gname, fn)
        # watch the shared preemption latch: a SIGTERM seen by ANY
        # installed handler (ours via install_sigterm, or a trainer's
        # PreemptionHandler in the same process) drains this gateway
        self._stop_watch.clear()
        self._stopped.clear()
        self._drain_watch = threading.Thread(
            target=self._watch_preemption, name="gateway_drain_watch",
            daemon=True,
        )
        self._drain_watch.start()
        return self

    @property
    def port(self):
        """The BOUND port (differs from 0-requested ephemeral binds);
        None once the listener is closed."""
        return self._httpd.server_address[1] if self._httpd else None

    def url(self, path="/healthz"):
        if self._httpd is None:
            raise RuntimeError("gateway is not listening")
        return "http://%s:%d%s" % (self.host, self.port, path)

    def install_sigterm(self):
        """Route SIGTERM into the graceful-drain path: the handler sets
        the shared preemption latch (``checkpoint.preempt``), which
        flips ``/readyz`` AND the exporter's ``/healthz`` to draining;
        the watch thread then drains in-flight streams and closes the
        listener. A previously installed Python handler (a colocated
        trainer's ``PreemptionHandler`` final save) is CHAINED after the
        latch — its state must not be lost because a gateway installed
        later. Caveat: a chained handler that exits the process
        (``exit_after=True``) will cut the drain short; colocated
        trainers that want the drain should install with
        ``save_in_handler``/``exit_after`` off and poll the latch.
        Main-thread only (signal API constraint) — a gateway driven from
        a worker thread relies on the process's own PreemptionHandler
        setting the same latch."""
        if threading.current_thread() is not threading.main_thread():
            return self
        if self._sig_installed:
            # idempotent: a second install would capture OUR handler as
            # _prev_sigterm and the chain would recurse on SIGTERM
            return self
        self._prev_sigterm = signal.signal(
            signal.SIGTERM, self._on_sigterm
        )
        self._sig_installed = True
        return self

    def _on_sigterm(self, signum, frame):
        # minimal handler: latch, then chain. The drain itself (bounded,
        # seconds) must not run between arbitrary bytecodes on the main
        # thread — the watch thread does it. Once the gateway has
        # stopped the handler degrades to a pure pass-through: a stop()
        # that ran on the watch thread cannot signal.signal() the old
        # handler back (main-thread-only API), so this stays installed
        # but transparent.
        if self._started:
            _preempt.request_preemption()
        prev = self._prev_sigterm
        if callable(prev):  # SIG_DFL / SIG_IGN / None are not
            prev(signum, frame)

    def _watch_preemption(self):
        while not self._stop_watch.wait(0.05):
            if _preempt.preemption_requested():
                self.stop()
                return

    def draining(self):
        return (self._draining or not self._started
                or _preempt.preemption_requested())

    def kv_advert(self):
        """The /readyz KV-tier advertisement: this replica's role plus
        (when a paged prefix index is live) its block size and hot
        chain-head keys — what the router's affinity scorer matches an
        incoming prompt's chain against. Cheap and lock-free; an engine
        without an index advertises role only."""
        out = {"role": self.role}
        eng = getattr(self.server, "_decode_engine", None)
        try:
            if (eng is not None and getattr(eng, "pindex", None) is not None
                    and hasattr(eng, "prefix_heads")):
                out["block"] = eng.block_size
                out["heads"] = eng.prefix_heads()
        except Exception:  # noqa: BLE001 - advert is best-effort
            pass
        return out

    def stop(self, drain_timeout_s=None):
        """Graceful stop: flip NOT-READY, reject new work with 503, wait
        (bounded) for every in-flight request — including mid-stream SSE
        responses — then close the listener. Idempotent; concurrent
        callers (SIGTERM watch + an explicit stop) drain once, and the
        late caller BLOCKS until that drain completes — the documented
        ``gw.stop(); server.stop()`` teardown must not rip the engine
        out from under requests another thread is still draining."""
        timeout = (self.drain_timeout_s if drain_timeout_s is None
                   else float(drain_timeout_s))
        with self._drain_cond:
            in_progress = self._draining
            if not in_progress and not self._started:
                self._restore_sigterm()
                return
            self._draining = True  # /readyz 503 + new requests 503
        if in_progress:
            # another thread owns the drain: wait it out (bounded)
            self._stopped.wait(timeout + 10.0)
            # a watch-thread stop couldn't restore the signal handler
            # (main-thread-only API); finish the job if we can
            self._restore_sigterm()
            return
        self._stop_watch.set()
        deadline = time.monotonic() + timeout
        with self._drain_cond:
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    _profiler.bump_counter("gateway_drain_timeouts")
                    break
                self._drain_cond.wait(remaining)
        if self._httpd is not None:
            try:
                self._httpd.shutdown()
                self._httpd.server_close()
            except Exception:
                pass
        if self._http_thread is not None:
            self._http_thread.join(timeout=5.0)
        self._httpd = None
        # the drain is a terminal moment for this process's serving
        # life: leave the flight-recorder/trace black box on disk (no-op
        # when FLAGS_obs_dir is unarmed)
        _obs_exporter.dump_blackbox()
        if self._inflight_gauge is not None:
            _obs_registry.unregister_gauge("gateway_inflight",
                                           self._inflight_gauge)
            self._inflight_gauge = None
        if self._draining_gauge is not None:
            _obs_registry.unregister_gauge("gateway_draining",
                                           self._draining_gauge)
            self._draining_gauge = None
        for gname, fn in self._waiting_gauges.items():
            _obs_registry.unregister_gauge(gname, fn)
        self._waiting_gauges = {}
        self._restore_sigterm()
        self._started = False
        self._stopped.set()  # unblock concurrent stop() callers

    def _restore_sigterm(self):
        """Put the previous SIGTERM handler back — only possible from
        the main thread (signal API); a stop() driven by the watch
        thread leaves ours installed as a pass-through (_on_sigterm
        checks _started) until a main-thread stop() lands here."""
        if (self._sig_installed
                and threading.current_thread() is threading.main_thread()):
            try:
                signal.signal(signal.SIGTERM, self._prev_sigterm)
                self._sig_installed = False
            except (ValueError, TypeError):
                pass

    def __enter__(self):
        return self if self._started else self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- per-request bookkeeping (called from handler threads) ---------------
    def _enter_request(self):
        with self._drain_cond:
            if self._draining or not self._started:
                return False
            self._inflight += 1
            return True

    def _exit_request(self):
        with self._drain_cond:
            self._inflight -= 1
            self._drain_cond.notify_all()


# -- HTTP handler ------------------------------------------------------------


def _make_handler(gw):
    class _Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        server_version = "paddle-tpu-gateway/1"
        # socket timeout: a client that trickles its body (or stalls a
        # read) is disconnected instead of pinning a handler thread
        timeout = 60.0

        def log_message(self, *args):  # access log is ours, not stderr's
            pass

        # -- plumbing --------------------------------------------------------
        def _send_json(self, code, obj, headers=(), close=False):
            """``close=True`` on any response sent WITHOUT having read
            the request body (early 429/404/503) or after a partial
            read: protocol_version is HTTP/1.1, so a kept-alive client
            would otherwise see the unread body bytes parsed as its
            next request line and desync."""
            data = json.dumps(obj, sort_keys=True).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            if close:
                self.send_header("Connection", "close")
                self.close_connection = True
            # every response names its distributed trace: the client
            # (or the router relaying this) correlates the answer with
            # the merged fleet trace by this one header
            if getattr(self, "_trace_id", None):
                self.send_header("X-Trace-Id", self._trace_id)
            for k, v in gw.extra_headers.items():
                self.send_header(k, v)
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
                raise _PayloadTooLarge(
                    "request body of %d bytes exceeds the %d-byte cap"
                    % (n, _MAX_BODY_BYTES)
                )
            body = self.rfile.read(n)
            try:
                obj = json.loads(body.decode("utf-8"))
            except (UnicodeDecodeError, ValueError):
                raise ValueError("request body is not valid JSON")
            if not isinstance(obj, dict):
                raise ValueError("request body must be a JSON object")
            return obj

        @staticmethod
        def _opt_number(body, key):
            """Optional numeric field -> float|None; a non-numeric value
            is a 400 (ValueError), not a 500 from a downstream compare."""
            v = body.get(key)
            if v is None:
                return None
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                raise ValueError("%r must be a number" % key)
            return float(v)

        def _send_shed_429(self, tenant, rid, reason, retry_after_ms,
                           msg, close=False):
            """The one 429 contract (admission sheds of every kind):
            Retry-After header in ceil'd seconds, machine-readable body,
            admission-shed + per-tenant counters."""
            _profiler.bump_counter("gateway_shed_admission")
            _profiler.bump_counter("gateway_tenant_shed_"
                                   + _tenant_slug(tenant))
            retry_after_ms = max(1, int(retry_after_ms))
            self._send_json(
                429,
                {"error": msg, "reason": reason,
                 "retry_after_ms": retry_after_ms, "request_id": rid},
                headers=(("Retry-After",
                          str(max(1, (retry_after_ms + 999) // 1000))),),
                close=close,
            )

        def _request_meta(self):
            # strip BEFORE the fallback: a whitespace-only header must
            # land in "anon", not mint an empty-string tenant with its
            # own bucket and a malformed metric slug
            tenant = (self.headers.get("X-Tenant-Id") or "").strip() \
                or "anon"
            priority = (self.headers.get("X-Priority") or
                        "interactive").strip().lower()
            if priority not in ("interactive", "batch"):
                priority = "interactive"
            rid = (self.headers.get("X-Request-Id")
                   or "req-%d-%d" % (os.getpid(), next(_request_ids)))
            return tenant, priority, rid

        # -- GET: health/readiness ------------------------------------------
        def do_GET(self):
            # the handler object persists across a kept-alive
            # connection: a previous POST's trace id must not leak onto
            # a health probe's response
            self._trace_id = None
            path = self.path.split("?", 1)[0]
            if path == "/healthz":
                # liveness: the process is up and handling sockets —
                # plus the clock-anchor pair (ts wall / ts_mono span
                # clock) fleet_trace.py aligns this process's spans with
                self._send_json(200, dict(
                    {"status": "alive", "pid": os.getpid()},
                    **_trace.clock_anchor()))
            elif path == "/readyz":
                if gw.draining():
                    self._send_json(503, {"status": "draining"})
                else:
                    # the KV-tier advertisement rides the readiness
                    # poll the router already makes: hot prefix-chain
                    # heads + block size + role, for affinity scoring
                    # the lease stamp doubles as the router's liveness
                    # signal for ADOPTED backends (pid + wall-clock ts,
                    # same shape as the endpoint-file lease)
                    self._send_json(
                        200,
                        {"status": "ready",
                         "inflight": gw.admission.total_inflight,
                         "kv": gw.kv_advert(),
                         "lease": {"pid": os.getpid(),
                                   "ts": time.time()}},
                    )
            else:
                self._send_json(404, {"error": "not found"})

        # -- POST: the serving endpoints ------------------------------------
        def do_POST(self):
            # same kept-alive hygiene as do_GET: a previous request's
            # trace id must not stamp an unmatched route's 404
            self._trace_id = None
            path = self.path.split("?", 1)[0]
            if path == "/v1/infer":
                self._serve(path, self._infer)
            elif path == "/v1/generate":
                self._serve(path, self._generate)
            elif path == "/v1/kv/prefill":
                # internal fleet endpoint (prefill-role replicas):
                # bypasses tenant admission — peers are fleet traffic,
                # not tenants; the engine's own queue bound still sheds
                self._kv_prefill()
            else:
                # body unread -> close, or a kept-alive client desyncs
                self._send_json(404, {"error": "not found"}, close=True)

        def _serve(self, endpoint, fn):
            """Shared request wrapper: drain gate, body read (BEFORE
            admission — an admitted inflight slot must never wait on a
            trickling client body), admission control, span, metrics,
            access log, error->status mapping.

            Distributed trace: an incoming W3C ``traceparent`` (the
            router's, or any foreign caller's) is ADOPTED — this hop's
            ``gateway_request`` span becomes a child of the remote span
            and every engine-side span opened under the scope inherits
            the trace — and a gateway fronted directly mints its own.
            The id goes back out on ``X-Trace-Id``, the SSE terminal
            events, the access-log line, and the flight record."""
            tenant, priority, rid = self._request_meta()
            # stashed for handlers that thread scheduling identity into
            # the engine (_generate) — fn() only receives (tenant, rid,
            # body)
            self._priority = priority
            tp = _trace.parse_traceparent(self.headers.get("traceparent"))
            trace_id, parent_span = tp if tp else (_trace.new_trace_id(),
                                                  None)
            self._trace_id = trace_id
            self._parent_span = parent_span
            self._span_id = None
            t0 = time.monotonic()
            # reset BEFORE any _log call (including the draining-reject
            # below): the handler object is reused across a kept-alive
            # connection, and a stale stash from the previous request
            # must never leak into this request's access-log line
            self._log_extra = None
            self._flight_extra = None
            _profiler.bump_counter("gateway_requests")
            _profiler.bump_counter("gateway_tenant_requests_"
                                   + _tenant_slug(tenant))
            if not gw._enter_request():
                self._send_json(
                    503, {"error": "draining", "request_id": rid},
                    close=True,
                )
                self._log(rid, tenant, priority, endpoint, 503, t0,
                          reason="draining")
                return
            status, reason, tokens = 500, None, None
            try:
                with _trace.trace_scope(trace_id, parent_span), \
                        _trace.span("gateway_request", cat="gateway",
                                    endpoint=endpoint, tenant=tenant,
                                    request_id=rid,
                                    priority=priority) as sp:
                    self._span_id = sp.span_id
                    try:
                        body = self._read_body()
                    except _PayloadTooLarge as e:
                        # refused unread -> must close the connection
                        status, reason = 413, "too_large"
                        self._send_json(413, {"error": str(e),
                                              "request_id": rid},
                                        close=True)
                        return
                    except ValueError as e:
                        # ambiguous read state (bad/missing length,
                        # undecodable body) -> close conservatively
                        status, reason = 400, "bad_request"
                        self._send_json(400, {"error": str(e),
                                              "request_id": rid},
                                        close=True)
                        return
                    # journey facts for the flight record: queue depth
                    # as seen AT entry and how long admission held us
                    inflight_at_entry = gw.admission.total_inflight
                    t_adm = time.monotonic()
                    try:
                        gw.admission.admit(tenant, priority)
                    except _AdmissionDenied as e:
                        status, reason = 429, e.reason
                        # body consumed above: keep-alive stays safe
                        self._send_shed_429(tenant, rid, e.reason,
                                            e.retry_after_ms, str(e))
                        return
                    finally:
                        self._flight_extra = {
                            "admit_wait_ms": round(
                                (time.monotonic() - t_adm) * 1e3, 3),
                            "inflight_at_entry": inflight_at_entry,
                        }
                    try:
                        status, reason, tokens = fn(tenant, rid, body)
                    finally:
                        gw.admission.release(tenant)
                    if sp.args is not None:
                        # the span records its kwargs dict by reference,
                        # so the status lands in the exported trace args
                        sp.args["status"] = status
            except ConnectionError:
                # BrokenPipe AND ConnectionReset/Aborted: the client
                # went away — not a server error, don't write to the
                # dead socket or pollute 5xx monitoring
                status, reason = 499, "client_disconnected"
            except Exception as e:  # handler must never kill the thread
                status, reason = 500, repr(e)
                try:
                    # body state unknown here -> close the connection
                    self._send_json(500, {"error": repr(e),
                                          "request_id": rid}, close=True)
                except Exception:
                    pass
            finally:
                gw._exit_request()
                ms = (time.monotonic() - t0) * 1e3
                if status < 400:
                    _profiler.bump_histogram("gateway_latency_ms", ms)
                    _profiler.bump_histogram(
                        "gateway_tenant_latency_ms_" + _tenant_slug(tenant),
                        ms,
                    )
                self._log(rid, tenant, priority, endpoint, status, t0,
                          reason=reason, tokens=tokens)

        def _log(self, rid, tenant, priority, endpoint, status, t0,
                 reason=None, tokens=None):
            rec = {
                "ts": time.time(),
                "request_id": rid,
                "tenant": tenant,
                "priority": priority,
                "endpoint": endpoint,
                "status": int(status),
                "ms": round((time.monotonic() - t0) * 1e3, 3),
            }
            if getattr(self, "_trace_id", None):
                rec["trace_id"] = self._trace_id
                if self._span_id:
                    rec["span_id"] = self._span_id
                if self._parent_span:
                    rec["parent_span_id"] = self._parent_span
            if reason:
                rec["reason"] = reason
            if tokens is not None:
                rec["tokens"] = int(tokens)
            extra = getattr(self, "_log_extra", None)
            if extra:
                rec.update(extra)
            gw.access_log.write(rec)
            # the same record is this request's flight-recorder entry
            # (plus the admission journey facts) — one shape, two
            # sinks, so the black box and the log can never disagree
            fx = getattr(self, "_flight_extra", None)
            _flight.note(dict(rec, **fx) if fx else rec)
            if status >= 500:
                _flight.dump_on_error()

        # -- /v1/infer -------------------------------------------------------
        def _infer(self, tenant, rid, body):
            """Returns (status, reason, tokens) after writing the
            response. Body: {"inputs": [tensor...], "deadline_ms": f}."""
            try:
                raw = body.get("inputs")
                if not isinstance(raw, list) or not raw:
                    raise ValueError("'inputs' must be a non-empty list "
                                     "of tensors")
                feeds = [decode_tensor(t) for t in raw]
                deadline_ms = self._opt_number(body, "deadline_ms")
            except ValueError as e:
                # body fully consumed by _serve: keep-alive stays safe
                self._send_json(400, {"error": str(e),
                                      "request_id": rid})
                return 400, "bad_request", None
            try:
                outs = gw.server.infer(feeds, deadline_ms=deadline_ms)
            except ServerOverloadedError as e:
                # shed at the ENGINE's admission queue: same 429 +
                # Retry-After contract as the gateway's own sheds
                self._send_shed_429(tenant, rid, "overload",
                                    e.retry_after_ms, str(e))
                return 429, "overload", None
            except DeadlineExceededError as e:
                # shed at DISPATCH: the deadline passed in the queue
                _profiler.bump_counter("gateway_shed_dispatch")
                _profiler.bump_counter("gateway_tenant_shed_"
                                       + _tenant_slug(tenant))
                self._send_json(504, {"error": str(e),
                                      "reason": "deadline",
                                      "request_id": rid})
                return 504, "deadline", None
            except ServingError as e:
                self._send_json(500, {"error": str(e),
                                      "request_id": rid})
                return 500, "serving_error", None
            self._send_json(200, {
                "request_id": rid,
                "outputs": [encode_tensor(o) for o in outs],
            })
            return 200, None, None

        # -- /v1/generate ----------------------------------------------------
        def _generate(self, tenant, rid, body):
            """Body: {"prompt_ids": [...], "max_new_tokens", "eos_id",
            "temperature", "top_k", "top_p", "seed", "stream" (default
            true), "deadline_ms", "resume_tokens"}. Streaming responses
            are chunked SSE: one ``data: {"token": t}`` event per
            generated token, then ``data: {"done": true, ...}``.

            ``resume_tokens`` is the durable-generation resume form:
            the suffix an interrupted run of this exact request already
            emitted (the router builds it from the tokens it relayed
            before a replica died). The stream then emits only the
            token-exact continuation; the done/error events carry
            ``emitted_count`` + seed/knobs so ANY caller can
            reconstruct the next resume request. A temperature-sampled
            resume without its seed is a 400 (the engine's
            seed-required rule — the replayed picks would be
            unreproducible)."""
            try:
                prompt = body.get("prompt_ids")
                if (not isinstance(prompt, list) or not prompt
                        or not all(isinstance(t, int) for t in prompt)):
                    raise ValueError(
                        "'prompt_ids' must be a non-empty list of ints"
                    )
                resume = body.get("resume_tokens")
                if resume is not None:
                    if (not isinstance(resume, list)
                            or not all(isinstance(t, int)
                                       and not isinstance(t, bool)
                                       for t in resume)):
                        raise ValueError(
                            "'resume_tokens' must be a list of ints"
                        )
                stream_mode = bool(body.get("stream", True))
                deadline_ms = self._opt_number(body, "deadline_ms")
                kw = dict(
                    max_new_tokens=body.get("max_new_tokens"),
                    eos_id=body.get("eos_id"),
                    temperature=self._opt_number(body, "temperature"),
                    top_k=body.get("top_k", 0),
                    top_p=self._opt_number(body, "top_p"),
                    seed=body.get("seed"),
                    resume_tokens=resume or None,
                )
            except ValueError as e:
                self._send_json(400, {"error": str(e),
                                      "request_id": rid})
                return 400, "bad_request", None
            timeout = (deadline_ms / 1e3
                       if deadline_ms and deadline_ms > 0 else None)
            # decode-role pull: a cold prompt chain (below the pull
            # threshold) fetches published blocks from a prefill-role
            # peer BEFORE admission, so the local prefill shrinks to
            # the unpulled suffix; any failure degrades to plain local
            # prefill — the pull is never on the correctness path
            self._kv_pull_if_cold(prompt)
            # scheduling identity for the engine's weighted-fair /
            # preemption scheduler; guarded so bespoke server fakes
            # with a positional-only generate() keep working
            if _accepts_sched_kwargs(gw.server.generate):
                kw["priority"] = getattr(self, "_priority", "interactive")
                kw["tenant"] = tenant
            try:
                stream = gw.server.generate(prompt, **kw)
            except ServerOverloadedError as e:
                self._send_shed_429(tenant, rid, "overload",
                                    e.retry_after_ms, str(e))
                return 429, "overload", None
            except (ValueError, TypeError, ServingError) as e:
                code = 500 if isinstance(e, ServingError) else 400
                self._send_json(code, {"error": str(e),
                                       "request_id": rid})
                return code, "bad_request" if code == 400 else "error", None
            if not stream_mode:
                try:
                    toks = stream.tokens(timeout=timeout)
                except TimeoutError as e:
                    # the client's answer is gone: CANCEL so the engine
                    # retires the slot instead of decoding to max_new
                    stream.cancel()
                    _profiler.bump_counter("gateway_shed_dispatch")
                    _profiler.bump_counter("gateway_tenant_shed_"
                                           + _tenant_slug(tenant))
                    self._send_json(504, {"error": str(e),
                                          "reason": "deadline",
                                          "request_id": rid})
                    return 504, "deadline", None
                facts = self._stash_gen_facts(stream)
                self._send_json(200, dict({
                    "request_id": rid,
                    "tokens": toks,
                    "finish_reason": stream.finish_reason,
                }, **facts, **self._resume_state(stream, len(toks))))
                return 200, None, len(toks)
            return self._stream_sse(stream, tenant, rid, timeout)

        def _kv_pull_if_cold(self, prompt):
            """Fleet KV pull (decode-role path): when the local tier
            would cache fewer than ``FLAGS_kv_tier_pull_min_tokens`` of
            this prompt, fetch the chain's published blocks from a
            prefill-role peer (controller-maintained peers file) and
            drop them into the host store — the admission that follows
            re-admits them H2D through the standard spilled-block path.
            Wholly best-effort: any failure (no peers, timeout, dead
            peer, mismatched geometry) counts ``kv_tier_pull_failures``
            and the request prefills locally, token-exact either way."""
            if gw.kv_pull_min_tokens <= 0 or not gw.kv_peers_file:
                return
            eng = getattr(gw.server, "_decode_engine", None)
            if eng is None or getattr(eng, "host_store", None) is None:
                return
            try:
                bs = eng.block_size
                if len(prompt) <= bs:
                    return  # nothing a peer could hand us
                if (eng.estimate_cached_tokens(prompt)
                        >= gw.kv_pull_min_tokens):
                    return
                peers = _kv_tier.read_peers(gw.kv_peers_file)
                if not peers:
                    return
                # chain-root key spreads prompts across peers
                # deterministically: the same prefix always asks the
                # same peer, so peer-side caches stay hot too
                keys = _kv_tier.chain_keys(prompt, bs)
                peer = peers[int(keys[0][:8], 16) % len(peers)]
                conn = http.client.HTTPConnection(
                    str(peer.get("host", "127.0.0.1")),
                    int(peer["port"]), timeout=gw.kv_pull_timeout_s,
                )
                try:
                    conn.request(
                        "POST", "/v1/kv/prefill",
                        json.dumps({"prompt_ids": list(prompt)}),
                        {"Content-Type": "application/json"},
                    )
                    resp = conn.getresponse()
                    raw = resp.read()
                finally:
                    conn.close()
                if resp.status != 200:
                    raise ServingError(
                        "kv pull got HTTP %d" % resp.status
                    )
                doc = json.loads(raw.decode("utf-8"))
                if int(doc.get("block") or 0) != bs:
                    raise ServingError("kv pull block-size mismatch")
                cfg = eng.session.cfg
                row_shape = [cfg.num_heads, bs,
                             cfg.hidden_size // cfg.num_heads]
                entries = _kv_tier.decode_entries(
                    doc.get("blocks") or [], row_shape
                )
                n = eng.offer_blocks(entries)
                _profiler.bump_counter("kv_tier_pulls")
                _profiler.bump_counter("kv_tier_pull_tokens", n * bs)
            except Exception:  # noqa: BLE001 - degrade to local prefill
                _profiler.bump_counter("kv_tier_pull_failures")

        def _kv_prefill(self):
            """POST /v1/kv/prefill (internal fleet endpoint): compute
            and serialize the prompt's chain blocks. If the chain is
            not fully published yet, one 1-token generation drives the
            chunked prefill + publish, then the loop thread exports the
            blocks (host-store blocks serve straight from the tier).
            Returns base64 float32 payloads in chain order."""
            t0 = time.monotonic()
            rid = self.headers.get("X-Request-Id") or "-"
            try:
                body = self._read_body()
            except ValueError as e:
                self._send_json(400, {"error": str(e)}, close=True)
                return
            eng = getattr(gw.server, "_decode_engine", None)
            try:
                prompt = body.get("prompt_ids") \
                    if isinstance(body, dict) else None
                if (not isinstance(prompt, list) or not prompt
                        or not all(isinstance(t, int) for t in prompt)):
                    raise ValueError(
                        "'prompt_ids' must be a non-empty list of ints"
                    )
                if eng is None or getattr(eng, "pindex", None) is None:
                    self._send_json(503, {
                        "error": "no paged prefix index on this replica",
                        "request_id": rid,
                    })
                    return
                bs = eng.block_size
                want = len(prompt) // bs
                if want < 1:
                    raise ValueError(
                        "prompt shorter than one block (%d)" % bs
                    )
                entries = eng.request_export(prompt, timeout=5.0) or []
                if len(entries) < want:
                    # cold chain: one 1-token generation prefills and
                    # publishes it (counts as normal engine traffic)
                    stream = gw.server.generate(prompt, max_new_tokens=1)
                    stream.tokens(timeout=60)
                    entries = eng.request_export(prompt, timeout=5.0) or []
                self._send_json(200, {
                    "block": bs,
                    "count": len(entries),
                    "served_ms": round((time.monotonic() - t0) * 1e3, 3),
                    "blocks": _kv_tier.encode_entries(entries),
                })
            except ValueError as e:
                self._send_json(400, {"error": str(e),
                                      "request_id": rid})
            except ServerOverloadedError as e:
                self._send_json(429, {"error": str(e),
                                      "request_id": rid})
            except Exception as e:  # noqa: BLE001 - internal endpoint
                self._send_json(500, {"error": str(e),
                                      "request_id": rid})

        def _resume_state(self, stream, sent):
            """The reconstruction state every generate done/error event
            carries: how many tokens of the LOGICAL generation are out
            (the resumed suffix plus this stream's emissions) and the
            determinism knobs — enough for any caller (the router's
            failover path, or an end client) to build the next resume
            request without having tracked anything but the tokens.
            ``trace_id`` rides along so the terminal event correlates
            with the merged fleet trace even when the headers are long
            gone (a buffered SSE consumer)."""
            # getattr like _stash_gen_facts: duck-typed stream fakes
            # (tests, bespoke servers) must not break the error path
            state = {
                "emitted_count": (
                    len(getattr(stream, "resume_tokens", ()) or ())
                    + int(sent)
                ),
                "seed": getattr(stream, "seed", None),
                "temperature": getattr(stream, "temperature", 0.0),
                "top_k": getattr(stream, "top_k", 0),
                "top_p": getattr(stream, "top_p", 0.0),
            }
            if getattr(self, "_trace_id", None):
                state["trace_id"] = self._trace_id
            return state

        def _stash_gen_facts(self, stream, fallback_ttft_ms=None):
            """Engine-stamped latency + prefix-cache facts, derived ONCE
            per request: stashed for the access-log line and returned
            for the response payload (JSON body or SSE done event), so
            the two surfaces can never disagree. ``fallback_ttft_ms``
            covers a stream the engine didn't stamp (the SSE writer's
            gateway-side first-chunk wall)."""
            ttft = getattr(stream, "ttft_ms", None)
            if ttft is None:
                ttft = fallback_ttft_ms
            facts = {
                "ttft_ms": round(ttft, 3) if ttft is not None else None,
                "cached_prefix_tokens": int(getattr(
                    stream, "cached_prefix_tokens", 0) or 0),
                # windowed-admission fact (1 = monolithic prefill):
                # with resumed_tokens > 0 this is the proof a resume's
                # re-prefill rode the chunked/prefix path
                "admit_windows": int(getattr(
                    stream, "admit_windows", 0) or 0),
                "resumed_tokens": len(getattr(
                    stream, "resume_tokens", ()) or ()),
            }
            # speculative-decoding facts (paged engine v2): drafted /
            # accepted counts plus the per-request acceptance rate —
            # only when the engine actually drafted, so legacy engines'
            # payloads and log lines stay byte-identical
            drafted = int(getattr(stream, "spec_drafted", 0) or 0)
            if drafted:
                accepted = int(getattr(stream, "spec_accepted", 0) or 0)
                facts["spec_drafted"] = drafted
                facts["spec_accepted"] = accepted
                facts["spec_acceptance"] = round(accepted / drafted, 4)
            # scheduler journey fact: how many times this stream was
            # preemption-evicted and token-exactly re-admitted — only
            # when it happened, so untouched payloads stay identical
            preempted = int(getattr(stream, "preemptions", 0) or 0)
            if preempted:
                facts["preemptions"] = preempted
            # engine-tick journey fact for the flight record: how many
            # fused decode ticks this generation spanned
            ft = getattr(stream, "first_tick", None)
            lt = getattr(stream, "last_tick", None)
            if ft is not None and lt is not None:
                facts["ticks_spanned"] = int(lt) - int(ft) + 1
            self._log_extra = facts
            return facts

        def _stream_sse(self, stream, tenant, rid, timeout):
            """Chunked SSE: headers now, one data event per token as the
            engine emits it, a final done event carrying finish_reason.
            Errors after headers ride an in-band ``{"error": ...}``
            event (the 200 is already on the wire)."""
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.send_header("X-Request-Id", rid)
            if getattr(self, "_trace_id", None):
                self.send_header("X-Trace-Id", self._trace_id)
            for k, v in gw.extra_headers.items():
                self.send_header(k, v)
            self.end_headers()
            sent = 0
            first_tok_ms = None
            t0 = time.monotonic()
            # ENGINE exceptions (deadline, stream failure) and CLIENT
            # write exceptions must be told apart by SOURCE, not type:
            # on py3.10+ socket.timeout IS TimeoutError, so a write to
            # a stalled client that times out is type-identical to the
            # generation deadline — only next(it) can raise the
            # deadline, only _chunk can raise the socket
            it = iter(stream.stream_tokens(timeout=timeout))
            while True:
                try:
                    tok = next(it)
                except StopIteration:
                    break
                except TimeoutError:
                    stream.cancel()  # free the decode slot — see above
                    _profiler.bump_counter("gateway_shed_dispatch")
                    _profiler.bump_counter("gateway_tenant_shed_"
                                           + _tenant_slug(tenant))
                    try:
                        # carries the reconstruction state (emitted
                        # count, seed, knobs) like every terminal
                        # generate event — a caller can resume even a
                        # deadline-cut stream with a fresh budget
                        self._chunk('data: %s\n\n' % json.dumps(
                            dict({"error": "deadline",
                                  "request_id": rid},
                                 **self._resume_state(stream, sent))
                        ))
                        self._chunk_end()
                    except OSError:
                        return 499, "client_stalled", sent
                    return 504, "deadline", sent
                except Exception as e:  # noqa: BLE001
                    # the 200 + chunked framing is already on the
                    # wire: ANY stream failure (the engine fails
                    # streams with the original exception type, not
                    # just ServingError) must ride an in-band error
                    # event — a late _send_json(500) would inject a
                    # raw status line into the chunked body
                    try:
                        self._chunk('data: %s\n\n' % json.dumps(
                            dict({"error": str(e) or repr(e),
                                  "request_id": rid},
                                 **self._resume_state(stream, sent))
                        ))
                        self._chunk_end()
                    except OSError:
                        stream.cancel()
                        return 499, "client_stalled", sent
                    return 500, "stream_error", sent
                if first_tok_ms is None:
                    first_tok_ms = (time.monotonic() - t0) * 1e3
                    _profiler.bump_histogram("gateway_ttft_ms",
                                             first_tok_ms)
                try:
                    self._chunk('data: {"token": %d}\n\n' % tok)
                except OSError as e:
                    # client went away (reset/pipe) or STALLED (write
                    # timeout) mid-stream: nothing left to write to,
                    # and nobody left to decode for. A ConnectionError
                    # re-raises into _serve's 499 mapping; a write
                    # timeout must NOT re-raise — the generic handler
                    # would _send_json(500) into the open chunked body
                    stream.cancel()
                    if isinstance(e, ConnectionError):
                        raise
                    return 499, "client_stalled", sent
                sent += 1
                _profiler.bump_counter("gateway_stream_tokens")
                # chaos seam (no-op unless FLAGS_chaos_die_after_tokens
                # is armed): the process dies AFTER this token hit the
                # wire, pinning replica-death trials to an exact token
                # boundary
                _chaos.on_stream_token()
            # the done event carries the engine-stamped TTFT (falling
            # back to the gateway-side first-chunk wall) and the
            # prefix-cache reuse fact, so a streaming client sees its
            # amortization — same dict the access log records
            facts = self._stash_gen_facts(stream,
                                          fallback_ttft_ms=first_tok_ms)
            try:
                self._chunk('data: %s\n\n' % json.dumps(
                    dict({"done": True,
                          "finish_reason": stream.finish_reason,
                          "tokens": sent, "request_id": rid}, **facts,
                         **self._resume_state(stream, sent)),
                    sort_keys=True,
                ))
                self._chunk_end()
            except OSError as e:
                if isinstance(e, ConnectionError):
                    raise
                return 499, "client_stalled", sent
            return 200, None, sent

        def _chunk(self, text):
            data = text.encode("utf-8")
            self.wfile.write(b"%x\r\n" % len(data))
            self.wfile.write(data)
            self.wfile.write(b"\r\n")
            self.wfile.flush()

        def _chunk_end(self):
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()

    return _Handler
