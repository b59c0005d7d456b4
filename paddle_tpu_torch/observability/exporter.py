"""Lightweight telemetry exporter (port of
``paddle_tpu/observability/exporter.py``): stdlib HTTP + per-rank JSONL
files.

One ``Exporter`` serves three read-only endpoints from a daemon thread
(no dependency beyond ``http.server``):

- ``/metrics`` — the registry in Prometheus text format;
- ``/healthz`` — ``{"status": "ok"|"draining", ...}``; flips to
  ``draining`` (HTTP 503) the moment the PR 3 preemption path has seen
  SIGTERM (``checkpoint.preempt.preemption_requested()``) or the owner
  calls ``set_health(False)`` — so a load balancer or the gang
  supervisor stops routing to a worker that is wrapping up;
- ``/trace`` — the tracer ring buffer as Chrome trace-event JSON
  (open the URL, save, load in Perfetto);
- ``/compiles`` — the build telemetry (``compile_stats``): every
  Executor plan, predictor plan and kernel-library build with its
  trigger and phase, and the steady-state gate's state.

Port policy (``FLAGS_obs_http_port``): -1 disables HTTP entirely, 0
binds an ephemeral port (tests, single-host probes), >0 binds that port
or WALKS UP through ``FLAGS_obs_http_port_retries`` successors when
it's taken — on a multi-rank host every rank calls the same entry point
with the same flag env, and rank k landing on port+k beats rank k
crashing (``obs_port_fallbacks`` counts the walks).

Independent of HTTP, ``FLAGS_obs_dir`` arms per-rank JSONL snapshot
files (``rank_<r>.jsonl``): periodic at ``FLAGS_obs_snapshot_interval_s``
plus one final snapshot at ``stop()``/``final_snapshot()``. The gang
supervisor injects ``FLAGS_obs_dir`` into worker environments and merges
the files into a gang report (``aggregate.py``) — snapshots are the
telemetry that SURVIVES a worker, which is what post-mortem merge needs.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..fluid import flags as _flags
from ..fluid import profiler as _profiler
from . import flight as _flight
from . import registry as _registry
from . import trace as _trace

__all__ = [
    "Exporter",
    "maybe_start_from_flags",
    "global_exporter",
    "stop_global",
    "final_snapshot",
    "dump_blackbox",
]


def _preempting():
    try:
        from ..checkpoint import preempt as _preempt

        return _preempt.preemption_requested()
    except Exception:
        return False


def _make_handler(exporter):
    class _Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # scrapes must not spam stderr
            pass

        def _send(self, code, body, ctype):
            data = body.encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            path = self.path.split("?", 1)[0]
            try:
                if path == "/metrics":
                    self._send(
                        200, _registry.render_prometheus(),
                        "text/plain; version=0.0.4; charset=utf-8",
                    )
                elif path == "/healthz":
                    health = exporter.healthz()
                    code = 200 if health["status"] == "ok" else 503
                    self._send(
                        code, json.dumps(health, sort_keys=True),
                        "application/json",
                    )
                elif path == "/trace":
                    # ?trace_id= narrows the pull to one request's spans
                    # (fleet_trace.py and foreign consumers negotiate on
                    # the payload's schema_version stamp)
                    qs = urllib.parse.parse_qs(
                        self.path.partition("?")[2]
                    )
                    tid = (qs.get("trace_id") or [None])[0]
                    self._send(
                        200, json.dumps(_trace.chrome_trace(trace_id=tid)),
                        "application/json",
                    )
                elif path == "/compiles":
                    from . import compile_stats as _compile_stats

                    self._send(
                        200,
                        json.dumps(_compile_stats.compiles_endpoint(),
                                   sort_keys=True),
                        "application/json",
                    )
                else:
                    self._send(404, '{"error": "not found"}',
                               "application/json")
            except Exception as e:  # a broken render must not kill the server
                try:
                    self._send(500, json.dumps({"error": repr(e)}),
                               "application/json")
                except Exception:
                    pass

    return _Handler


class Exporter(object):
    """HTTP endpoint + snapshot writer for one process. ``None``
    parameters resolve from the ``FLAGS_obs_*`` knobs at start()."""

    def __init__(self, port=None, port_retries=None, snapshot_dir=None,
                 snapshot_interval_s=None, rank=None, host="127.0.0.1"):
        self.port_requested = int(
            _flags.get_flag("obs_http_port", -1) if port is None else port
        )
        self.port_retries = int(
            _flags.get_flag("obs_http_port_retries", 8)
            if port_retries is None else port_retries
        )
        self.snapshot_dir = (
            str(_flags.get_flag("obs_dir", "") or "")
            if snapshot_dir is None else str(snapshot_dir)
        ) or None
        self.snapshot_interval_s = float(
            _flags.get_flag("obs_snapshot_interval_s", 0.0)
            if snapshot_interval_s is None else snapshot_interval_s
        )
        self.rank = _trace.gang_rank(rank)
        self.host = host
        self._httpd = None
        self._http_thread = None
        self._snap_thread = None
        self._stop = threading.Event()
        self._healthy = True
        self._started = False

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        if self._started:
            return self
        self._stop.clear()  # a stop()ed exporter can start() again
        if self.port_requested >= 0:
            self._bind()
            self._http_thread = threading.Thread(
                target=self._httpd.serve_forever, name="obs_exporter_http",
                daemon=True,
            )
            self._http_thread.start()
        if self.snapshot_dir and self.snapshot_interval_s > 0:
            self._snap_thread = threading.Thread(
                target=self._snapshot_loop, name="obs_exporter_snap",
                daemon=True,
            )
            self._snap_thread.start()
        self._started = True
        return self

    def _bind(self):
        handler = _make_handler(self)
        # port 0 is ephemeral — the OS can't collide, so no walk needed
        candidates = (
            [0] if self.port_requested == 0
            else range(self.port_requested,
                       self.port_requested + self.port_retries + 1)
        )
        last_err = None
        for p in candidates:
            try:
                self._httpd = ThreadingHTTPServer((self.host, p), handler)
                self._httpd.daemon_threads = True
                if p not in (0, self.port_requested):
                    _profiler.bump_counter("obs_port_fallbacks")
                return
            except OSError as e:
                last_err = e
                continue
        raise OSError(
            "obs exporter: no free port in [%d, %d]: %s"
            % (self.port_requested,
               self.port_requested + self.port_retries, last_err)
        )

    def stop(self, join_timeout=5.0):
        """Idempotent: final snapshot (when armed), HTTP shutdown, thread
        joins. Safe to call from a SIGTERM-driven teardown — everything
        here is bounded."""
        if not self._started:
            return
        self._started = False
        self._stop.set()
        if self.snapshot_dir:
            try:
                self.write_snapshot()
            except OSError:
                pass
        if self._httpd is not None:
            try:
                self._httpd.shutdown()
                self._httpd.server_close()
            except Exception:
                pass
        for t in (self._http_thread, self._snap_thread):
            if t is not None and t.is_alive():
                t.join(timeout=join_timeout)
        self._httpd = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- endpoints' state ----------------------------------------------------
    @property
    def port(self):
        """The BOUND port (differs from port_requested after an
        ephemeral bind or a port-in-use walk); None when HTTP is off."""
        return self._httpd.server_address[1] if self._httpd else None

    def url(self, path="/metrics"):
        if self._httpd is None:
            raise RuntimeError("exporter has no HTTP endpoint")
        return "http://%s:%d%s" % (self.host, self.port, path)

    def set_health(self, ok):
        """Manual health override (a server draining its queue flips this
        before stop); preemption flips /healthz regardless."""
        self._healthy = bool(ok)

    def healthz(self):
        draining = (not self._healthy) or self._stop.is_set() or _preempting()
        # the clock-anchor pair rides every health answer: ts is wall,
        # ts_mono the SAME clock spans record — what fleet_trace.py
        # aligns per-process trace timelines with (and the NTP-style
        # skew estimate reads ts against the puller's own clock)
        anchor = _trace.clock_anchor()
        return {
            "status": "draining" if draining else "ok",
            "rank": self.rank,
            "pid": os.getpid(),
            "ts": anchor["ts"],
            "ts_mono": anchor["ts_mono"],
        }

    # -- snapshots -----------------------------------------------------------
    def write_snapshot(self):
        if not self.snapshot_dir:
            raise RuntimeError("exporter has no snapshot dir")
        # the black box rides the snapshot cadence: a replica that is
        # later SIGKILLed leaves at most one interval's worth of spans
        # and flight records unrecorded on disk. Dumped BEFORE the
        # registry snapshot so the dump's own counter bumps are inside
        # it — a quiescent process's snapshot must equal its live
        # counters exactly (the obs probe's round-trip bar).
        dump_blackbox(self.snapshot_dir, rank=self.rank)
        return _registry.write_snapshot(self.snapshot_dir, rank=self.rank)

    def _snapshot_loop(self):
        while not self._stop.wait(self.snapshot_interval_s):
            try:
                self.write_snapshot()
            except OSError:
                continue  # a full/unmounted disk must not kill telemetry


# -- process-global convenience entry points --------------------------------
_global = None
_global_lock = threading.Lock()


def maybe_start_from_flags():
    """Start (once) the process-global exporter when the FLAGS_obs_*
    knobs ask for anything — called from both ``InferenceServer.start()``
    and the trainer loop, so EITHER workload lights up telemetry with
    env flags alone. Returns the exporter or None when nothing is
    enabled. Never raises: a telemetry bind failure must not take down
    training or serving."""
    global _global
    with _global_lock:
        if _global is not None:
            return _global
        port = int(_flags.get_flag("obs_http_port", -1))
        snap_dir = str(_flags.get_flag("obs_dir", "") or "")
        if port < 0 and not snap_dir:
            return None
        try:
            _global = Exporter().start()
        except OSError:
            # HTTP bind exhausted its port walk — but the JSONL snapshot
            # side needs no port, and the gang report needs the
            # snapshots: degrade to a port-less exporter when armed
            if not snap_dir:
                return None
            try:
                _global = Exporter(port=-1).start()
            except OSError:
                return None
        return _global


def global_exporter():
    return _global


def stop_global():
    global _global
    with _global_lock:
        exp, _global = _global, None
    if exp is not None:
        exp.stop()


def final_snapshot():
    """Write one registry snapshot for this rank if FLAGS_obs_dir is set
    — works with or without a running exporter (the trainer calls this
    in its ``finally`` so even a worker that never started HTTP leaves
    the per-rank record the gang aggregator merges). The flight-recorder
    and span-dump black boxes ride along: drain/SIGTERM teardowns all
    funnel through here, which is exactly when the post-mortem record
    must hit disk."""
    snap_dir = str(_flags.get_flag("obs_dir", "") or "")
    if not snap_dir:
        return None
    # black box FIRST, same ordering invariant as the snapshot loop:
    # the dump's own counter bumps must land inside the snapshot, so a
    # quiescent process's final snapshot equals its live counters
    dump_blackbox(snap_dir)
    try:
        path = _registry.write_snapshot(snap_dir)
    except OSError:
        path = None
    return path


def trace_dump_path(dirname, rank=None):
    return os.path.join(
        str(dirname), "trace_rank_%d.json" % _trace.gang_rank(rank)
    )


def dump_blackbox(dirname=None, rank=None):
    """Persist the post-mortem pair for this process into ``dirname``
    (default FLAGS_obs_dir): the flight-recorder ring
    (``flight_rank_<r>.json``) and a bounded span dump
    (``trace_rank_<r>.json``, the newest ``FLAGS_trace_dump_spans``
    spans as a standard /trace payload). Atomic whole-file replaces —
    newest state wins — so fleet_trace.py can merge a process that can
    no longer be pulled over HTTP. Never raises."""
    dirname = dirname or str(_flags.get_flag("obs_dir", "") or "")
    if not dirname:
        return None
    _flight.dump(dirname, rank=rank)
    try:
        cap = max(int(_flags.get_flag("trace_dump_spans", 4096)), 1)
    except (TypeError, ValueError):
        cap = 4096
    try:
        os.makedirs(str(dirname), exist_ok=True)
        path = trace_dump_path(dirname, rank=rank)
        tmp = "%s.tmp.%d" % (path, os.getpid())
        with open(tmp, "w") as f:
            json.dump(_trace.chrome_trace(newest=cap), f)
        os.replace(tmp, path)
        return path
    except OSError:
        return None
