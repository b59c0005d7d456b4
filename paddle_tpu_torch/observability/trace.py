"""Thread-safe span tracer with Chrome trace-event export (port of
``paddle_tpu/observability/trace.py``, the whole module).

``with span("decode_step", cat="serving", active=3): ...`` records one
timed span into a bounded ring buffer with its thread, nesting depth and
parent; kwargs land in the record's ``args``. The executor opens
``executor_run``, the GPT train step ``train_step``, the server and
batcher ``serving_warmup``, ``serving_dispatch`` and ``predictor_run``,
the decode session its ``decode_*`` spans, the engine ``decode_tick``
and the gateway ``gateway_request``. Spans time the host: a span around
device work measures device time only where the work ends in a
synchronisation; device timelines come from ``torch.profiler``.

Design constraints, in order:

- **Always-on cheap**: recording is gated by ``FLAGS_obs_trace``
  (default on) behind a flags-version-cached check, and a completed span
  costs two ``perf_counter`` reads, a tuple, and one locked deque append
  (bounded: ``FLAGS_obs_trace_buffer`` newest spans survive — a
  long-lived server must not grow host memory without bound).
- **Thread-safe with explicit nesting**: each thread keeps its own span
  stack (``threading.local``), so parent/child edges are exact with the
  batcher's workers, the engine's loop and the gateway's handler threads
  tracing concurrently. ``tid`` in the export is the OS thread ident,
  ``pid`` is the gang rank (``PADDLE_TRAINER_ID``).
- **Distributed context**: a W3C ``traceparent`` adopted by
  ``trace_scope`` stamps every span opened inside it with the request's
  ``trace_id``; ``current_context()`` hands the context to the thread
  that later works for the request (the batcher's worker, the engine's
  loop), and shared-work spans (a batched dispatch, a fused decode tick)
  list the ``trace_ids`` they served.
- **Standard format**: ``chrome_trace()`` emits trace-event JSON
  (``ph: "X"`` complete events + thread-name metadata) that loads in
  Perfetto / chrome://tracing unchanged.
"""

from __future__ import annotations

import functools
import itertools
import json
import os
import re
import threading
import time
from collections import deque

from ..fluid import flags as _flags

__all__ = [
    "span",
    "traced",
    "instant",
    "enabled",
    "force_enable",
    "gang_rank",
    "get_spans",
    "reset",
    "chrome_trace",
    "save_chrome_trace",
    "new_trace_id",
    "parse_traceparent",
    "format_traceparent",
    "trace_scope",
    "current_context",
    "clock_anchor",
    "TRACE_SCHEMA_VERSION",
]

# /trace payload schema: bumped to 2 when the export grew the
# distributed-tracing envelope (schema_version, clock_anchor, ts_base,
# per-event trace_id/span_id/parent_span_id args) — fleet_trace.py and
# foreign consumers version-negotiate on it
TRACE_SCHEMA_VERSION = 2

# record layout (tuple for append cheapness):
# (name, cat, start_s, end_s, tid, depth, parent_name, span_id, args|None,
#  trace_id|None, span_hex|None, parent_hex|None, is_instant)
# The last four are the DISTRIBUTED identity: trace_id is the W3C
# 32-hex request id minted at the fleet's front door and carried across
# processes via `traceparent`; span_hex/parent_hex are this span's and
# its parent's 16-hex W3C span ids (chained through trace_scope + span
# nesting, so a child on another THREAD or PROCESS still names its real
# parent). All None outside a trace_scope — the always-on in-process
# tracer pays nothing for the fleet machinery.
_lock = threading.Lock()
_buf = deque(maxlen=65536)
_ids = itertools.count(1)  # .__next__ is atomic under the GIL
_tls = threading.local()
_thread_names = {}  # tid -> thread name, for trace metadata
# (flags.version(), enabled) — the disarmed/armed check must cost one
# integer compare on hot paths, same idiom as testing/chaos.py
_enabled_cache = (None, True)
# ref-count of force_enable holders (an explicit profiling session must
# record spans even when the always-on tracer is flagged off)
_force_on = 0


def enabled():
    """Is span recording armed (FLAGS_obs_trace, or a force_enable
    holder)? Cached per flags-version so per-span cost stays at one
    integer compare. The same once-per-flags-change branch applies
    FLAGS_obs_trace_buffer, so the bound takes effect on live paths
    (trainer, server) that never call reset()."""
    global _enabled_cache
    ver = _flags.version()
    cached_ver, cached = _enabled_cache
    if cached_ver != ver:
        cached = bool(_flags.get_flag("obs_trace", True))
        _enabled_cache = (ver, cached)
        _apply_buffer_bound()
    return cached or _force_on > 0


def _buffer_bound():
    try:
        return max(int(_flags.get_flag("obs_trace_buffer", 65536)), 1)
    except (TypeError, ValueError):
        return 65536


def _apply_buffer_bound():
    """Re-size the ring buffer to FLAGS_obs_trace_buffer, keeping the
    newest spans."""
    global _buf
    n = _buffer_bound()
    if _buf.maxlen != n:
        with _lock:
            _buf = deque(_buf, maxlen=n)


def force_enable(on):
    """Arm (``True``) / disarm (``False``) recording regardless of
    FLAGS_obs_trace. Ref-counted: a profiling session holds it so that
    it records a timeline when the always-on tracer was turned off for
    overhead (the reference's ``fluid.profiler.start_profiler`` does)."""
    global _force_on
    _force_on = max(0, _force_on + (1 if on else -1))


# -- distributed trace context ----------------------------------------------
# W3C trace-context shapes: trace_id is 32 lowercase hex, span ids are
# 16. Span ids are DERIVED, not drawn from urandom per span: a random
# per-process seed XOR a Weyl-sequence hash of the process-local span
# counter is unique within the process by construction, collision-odds
# ~2^-64 across processes, and costs one multiply — span enter/exit
# stays on the <2% overhead budget even inside a scope.
_PROC_SEED = int.from_bytes(os.urandom(8), "big")
_SPAN_MASK = (1 << 64) - 1
_TRACEPARENT = re.compile(
    r"^[0-9a-f]{2}-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$"
)


def _span_hex(local_id):
    return "%016x" % (
        (_PROC_SEED ^ (local_id * 0x9E3779B97F4A7C15)) & _SPAN_MASK
    )


def new_trace_id():
    """A fresh W3C trace id (32 hex chars) — minted once per request at
    the fleet's front door (router, or a directly-fronted gateway)."""
    return os.urandom(16).hex()


def parse_traceparent(value):
    """``(trace_id, parent_span_id)`` from a W3C ``traceparent`` header,
    or None for absent/malformed values (a bad header means "mint your
    own", never an error — foreign clients send arbitrary bytes)."""
    if not value:
        return None
    m = _TRACEPARENT.match(str(value).strip().lower())
    if m is None:
        return None
    tid = m.group(1)
    if tid == "0" * 32 or m.group(2) == "0" * 16:
        return None  # the spec's all-zero ids are invalid
    return tid, m.group(2)


def format_traceparent(trace_id, span_id):
    """The ``traceparent`` header value naming ``span_id`` as the
    remote parent of whatever the receiving hop opens."""
    return "00-%s-%s-01" % (trace_id, span_id)


class trace_scope(object):
    """Thread-local ambient trace context: every span opened inside the
    scope records ``trace_id`` and chains ``parent_span_id`` from the
    nearest enclosing span (or the scope's remote parent — the
    traceparent a hop received). ``trace_id=None`` makes the scope a
    no-op, so call sites pass whatever context they captured without
    branching. Scopes nest; each thread owns its own stack."""

    __slots__ = ("_entry", "_pushed")

    def __init__(self, trace_id, parent_span_id=None):
        self._entry = (trace_id, parent_span_id) if trace_id else None
        self._pushed = False

    def __enter__(self):
        if self._entry is not None:
            stack = getattr(_tls, "ctx", None)
            if stack is None:
                stack = _tls.ctx = []
            stack.append(self._entry)
            self._pushed = True
        return self

    def __exit__(self, *exc):
        if self._pushed:
            _tls.ctx.pop()
            self._pushed = False
        return False


def current_context():
    """``(trace_id, parent_span_id)`` of the innermost ambient scope on
    THIS thread (the parent is the nearest enclosing span's id), or
    None. Capture it where a request is accepted and re-enter it via
    ``trace_scope(*ctx)`` on whatever thread later works for that
    request — that hand-off is how the batcher worker's and decode
    loop's spans join the request's tree."""
    stack = getattr(_tls, "ctx", None)
    return stack[-1] if stack else None


def clock_anchor():
    """The ``(ts, ts_mono)`` pair that lets a merger map THIS process's
    span timestamps onto a wall clock: ``ts_mono`` is sampled from the
    SAME clock spans record (``perf_counter``), so
    ``wall = ts + (span_t - ts_mono)`` exactly. Exposed by the
    exporter's ``/healthz``, the replica endpoint file, and the
    ``/trace`` payload itself — fleet_trace.py aligns per-process
    clocks against the controller's anchor."""
    return {"ts": time.time(), "ts_mono": time.perf_counter()}


class span(object):
    """Context manager recording one timed span.

    ``with span("ckpt_snapshot", cat="ckpt", step=7): ...`` — kwargs
    land in the Chrome event's ``args``. Nesting is tracked per thread:
    a span opened inside another becomes its child (``parent``/``depth``
    in the record, time containment in Perfetto). Disabled tracing makes
    enter/exit a near-no-op."""

    __slots__ = ("name", "cat", "args", "_t0", "_armed", "_parent",
                 "trace_id", "span_id", "_parent_hex", "_ctx_pushed")

    def __init__(self, name, cat="host", **args):
        self.name = name
        self.cat = cat
        self.args = args or None
        self._armed = False
        # distributed identity, populated at __enter__ when an ambient
        # trace_scope is active on this thread (None otherwise). span_id
        # is readable the moment the span opens — a hop forwards it in
        # `traceparent` BEFORE its children exist.
        self.trace_id = None
        self.span_id = None

    def __enter__(self):
        if not enabled():
            return self
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        self._parent = stack[-1] if stack else None
        stack.append(self.name)
        self._armed = True
        self._ctx_pushed = False
        ctx = getattr(_tls, "ctx", None)
        if ctx:
            # inside a trace_scope: mint this span's W3C id, remember
            # the enclosing id as parent, and become the ambient parent
            # for anything opened (or captured) underneath
            trace_id, parent = ctx[-1]
            self.trace_id = trace_id
            self._parent_hex = parent
            self.span_id = _span_hex(next(_ids))
            ctx.append((trace_id, self.span_id))
            self._ctx_pushed = True
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if not self._armed:
            return False
        t1 = time.perf_counter()
        self._armed = False
        stack = _tls.stack
        if stack:
            stack.pop()
        if self._ctx_pushed:
            _tls.ctx.pop()
            self._ctx_pushed = False
        tid = threading.get_ident()
        rec = (
            self.name, self.cat, self._t0, t1, tid, len(stack),
            self._parent, next(_ids), self.args,
            self.trace_id, self.span_id,
            self._parent_hex if self.trace_id else None, False,
        )
        with _lock:
            if tid not in _thread_names:  # once per thread, not per span
                _thread_names[tid] = threading.current_thread().name
            _buf.append(rec)
        return False


def instant(name, cat="host", **args):
    """Record a zero-duration INSTANT event (Perfetto ``ph: "i"``) —
    the attributable mark for moments that have no extent, like the
    router's failover splice between two replicas' stream segments.
    Carries the ambient trace context like a span (so the mark lands
    inside the request's tree), costs one append, no-op when tracing
    is off."""
    if not enabled():
        return
    t = time.perf_counter()
    tid = threading.get_ident()
    ctx = getattr(_tls, "ctx", None)
    trace_id = span_hex = parent = None
    if ctx:
        trace_id, parent = ctx[-1]
        span_hex = _span_hex(next(_ids))
    stack = getattr(_tls, "stack", None)
    rec = (
        name, cat, t, t, tid, len(stack) if stack else 0,
        stack[-1] if stack else None, next(_ids), args or None,
        trace_id, span_hex, parent, True,
    )
    with _lock:
        if tid not in _thread_names:
            _thread_names[tid] = threading.current_thread().name
        _buf.append(rec)


def traced(name=None, cat="host"):
    """Decorator form: ``@traced`` / ``@traced("label", cat="serving")``
    wraps the call in a span (label defaults to the qualified name)."""
    if callable(name):  # bare @traced
        return traced(None)(name)

    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with span(label, cat=cat):
                return fn(*a, **kw)

        return wrapper

    return deco


def get_spans(newest=None):
    """Snapshot of the ring buffer as dicts (oldest first); list and
    dicts are copies — same isolation contract as profiler counters.
    ``trace_id``/``span_id``/``parent_span_id`` are the distributed
    identity (None outside a trace_scope); ``instant`` marks
    zero-duration events. ``newest=`` bounds the snapshot to the newest
    N records BEFORE dict conversion — the periodic black-box dump must
    not pay a full-ring copy to keep 1/16th of it."""
    with _lock:
        recs = list(_buf)
    if newest is not None:
        n = int(newest)
        recs = recs[-n:] if n > 0 else []  # -0 would slice the WHOLE ring
    return [
        {
            "name": r[0], "cat": r[1], "start": r[2], "end": r[3],
            "tid": r[4], "depth": r[5], "parent": r[6], "id": r[7],
            "args": dict(r[8]) if r[8] else {},
            "trace_id": r[9], "span_id": r[10],
            "parent_span_id": r[11], "instant": r[12],
        }
        for r in recs
    ]


def reset():
    """Drop every retained span and re-read the buffer bound from
    FLAGS_obs_trace_buffer (so tests can shrink it)."""
    global _buf
    with _lock:
        _buf = deque(maxlen=_buffer_bound())


def gang_rank(rank=None):
    """The gang rank labeling every per-rank artifact (trace ``pid``,
    snapshot filename, exporter identity): an explicit value wins, else
    PADDLE_TRAINER_ID, else 0 (non-numeric counts as unset). One
    resolver so a change to rank discovery can't skew artifacts apart."""
    if rank is not None:
        return int(rank)
    try:
        return int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    except ValueError:
        return 0


def _span_matches(s, trace_id):
    """Does this span belong to ``trace_id``? Either its own distributed
    identity matches, or it is a shared-work span (a batched dispatch /
    fused decode tick) whose ``trace_ids`` args list names the trace."""
    if s["trace_id"] == trace_id:
        return True
    tids = s["args"].get("trace_ids")
    return isinstance(tids, (list, tuple)) and trace_id in tids


def chrome_trace(trace_id=None, newest=None):
    """The retained spans as a Chrome trace-event dict: ``ph: "X"``
    complete events (``ph: "i"`` for instants) with ``ts``/``dur`` in
    microseconds, ``pid`` = gang rank, ``tid`` = thread, nesting by
    containment (exact, because spans close LIFO per thread), plus
    process/thread-name metadata. Loads in Perfetto / chrome://tracing
    as-is. The distributed envelope rides as EXTRA top-level keys
    (Perfetto ignores them): ``schema_version``, ``clock_anchor`` (the
    wall/mono pair a merger aligns on), ``ts_base`` (the mono origin
    subtracted from every ``ts``, so absolute times reconstruct), and
    process identity; per-event ``trace_id``/``span_id``/
    ``parent_span_id`` land in ``args``. ``trace_id=`` filters to one
    request's spans (shared-work spans whose ``trace_ids`` list names
    it included); ``newest=`` keeps only the newest N spans (bounded
    periodic dumps)."""
    # the newest bound applies pre-conversion when it can (no filter);
    # with a trace_id filter it must run AFTER, on the matching spans
    spans = get_spans(newest=None if trace_id is not None else newest)
    if trace_id is not None:
        spans = [s for s in spans if _span_matches(s, trace_id)]
        if newest is not None:
            n = int(newest)
            spans = spans[-n:] if n > 0 else []
    rank = gang_rank()
    t0 = min((s["start"] for s in spans), default=0.0)
    events = [
        {
            "name": "process_name", "ph": "M", "pid": rank, "tid": 0,
            "args": {"name": "rank %d" % rank},
        }
    ]
    with _lock:  # span exits insert names concurrently
        names = list(_thread_names.items())
    # OS thread idents are pthread addresses — huge and collision-prone
    # under any modulus — so the export aliases each distinct ident to a
    # small stable row id (collision-free by construction)
    alias = {
        t: i + 1
        for i, t in enumerate(sorted(
            {t for t, _ in names} | {s["tid"] for s in spans}
        ))
    }
    for tid, tname in sorted(names):
        events.append({
            "name": "thread_name", "ph": "M", "pid": rank,
            "tid": alias[tid], "args": {"name": tname},
        })
    for s in spans:
        args = dict(s["args"])
        args["depth"] = s["depth"]
        if s["parent"]:
            args["parent"] = s["parent"]
        if s["trace_id"]:
            args["trace_id"] = s["trace_id"]
            args["span_id"] = s["span_id"]
            if s["parent_span_id"]:
                args["parent_span_id"] = s["parent_span_id"]
        ev = {
            "name": s["name"], "cat": s["cat"],
            "ts": (s["start"] - t0) * 1e6,
            "pid": rank, "tid": alias[s["tid"]], "args": args,
        }
        if s["instant"]:
            ev["ph"] = "i"
            ev["s"] = "p"  # process-scoped instant mark
        else:
            ev["ph"] = "X"
            ev["dur"] = (s["end"] - s["start"]) * 1e6
        events.append(ev)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "schema_version": TRACE_SCHEMA_VERSION,
        "clock_anchor": clock_anchor(),
        "ts_base": t0,
        "rank": rank,
        "pid_os": os.getpid(),
    }


def save_chrome_trace(path):
    """Write ``chrome_trace()`` to ``path`` (atomic tmp+rename so a
    half-written export never loads as torn JSON). Returns the path."""
    tmp = "%s.tmp.%d" % (path, os.getpid())
    with open(tmp, "w") as f:
        json.dump(chrome_trace(), f)
    os.replace(tmp, path)
    return path
