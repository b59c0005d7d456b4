"""Build telemetry and the strict steady-state serving gate: the torch
counterpart of ``paddle_tpu/observability/xla_stats.py``.

The reference records every XLA build and compile of its executor and
gates steady-state serving on them. The port compiles nothing through
XLA; what it builds on a path that can reach a request is:

- an Executor plan (``fluid/executor.py``: a program's op list, its
  scope reads and frees, built once per program version and fetch list;
  kind ``executor_plan``);
- a predictor plan (``inference/__init__.py``: the first run of an
  ``AnalysisPredictor`` at a new feed-shape signature; kind
  ``predictor_plan``);
- a kernel library (``kernels/_build.py``: one ``nvcc`` of a CUDA
  source; kind ``kernel_library``).

Each build calls ``on_build``, which keeps a bounded record (kind, key,
trigger, diff against the newest prior key of the same label, wall ms,
phase), bumps ``xla_builds`` (the reference's counter name: dashboards
read it) and the ``xla_build_ms`` histogram, and applies the gate.

**Strict serving gate**, with the reference's semantics: a server or
engine arms it (``arm_serving_steady()``, counted per live owner) once
its warmup finished. A build on a serving-request thread (inside a
``serving_request_window()``, as the batcher's workers and the engine's
windows and steps are) and outside a ``warmup_window()`` then bumps
``serving_steady_recompiles`` and, under
``FLAGS_serving_strict_compiles``, raises ``SteadyStateRecompileError``
with the record attached. A colocated trainer's builds never touch the
gate.

The reference's compiler census (``op_census``, ``executable_census``,
``cost_summary``, the per-key FLOP/byte gauges) has no counterpart here:
no compiler hands the port an optimized module to count.
"""

import collections
import itertools
import os
import threading
import time
import weakref
from collections import OrderedDict, deque

from ..fluid import flags as _flags
from ..fluid import profiler as _profiler

__all__ = [
    "KINDS",
    "SteadyStateRecompileError",
    "program_label",
    "on_build",
    "serving_steady",
    "arm_serving_steady",
    "disarm_serving_steady",
    "serving_request_window",
    "warmup_window",
    "get_records",
    "summary",
    "compiles_endpoint",
    "reset",
]

KINDS = ("executor_plan", "predictor_plan", "kernel_library")

_KEY_HISTORY_CAP = 16      # prior keys remembered per label
_LABELS_CAP = 64           # labels carrying key history

_lock = threading.Lock()
_records = deque(maxlen=1024)
_records_flag_ver = None
_key_history = OrderedDict()   # (kind, label) -> [key, ...] newest last
# monotonic process-lifetime totals (not derived from the bounded ring)
_totals = {"builds": 0, "build_ms": 0.0}
_kind_totals = collections.Counter()
_trigger_totals = collections.Counter()
_steady_count = 0         # armed steady-state gates (one per live owner)
_tls = threading.local()  # per-thread request-window + warmup depths

# a program's label: weak (a dead program must collect) and never an
# id() that a later object could reuse
_prog_ids = weakref.WeakKeyDictionary()
_prog_seq = itertools.count(1)


class SteadyStateRecompileError(RuntimeError):
    """A steady-state serving build under FLAGS_serving_strict_compiles.
    Carries the structured record so the shedding layer / client can see
    the attribution."""

    def __init__(self, record):
        self.record = record
        super().__init__(
            "steady-state build in serving (strict mode): kind=%s "
            "trigger=%s label=%s diff=%r"
            % (record["kind"], record["trigger"], record["label"],
               record["diff"])
        )


def program_label(program):
    """``P<n>``: a stable per-process label for a program object."""
    with _lock:
        label = _prog_ids.get(program)
        if label is None:
            label = "P%d" % next(_prog_seq)
            _prog_ids[program] = label
        return label


def _apply_record_bound():
    """Resize the record ring to FLAGS_obs_compile_records on any flags
    change (same once-per-version idiom as trace.enabled)."""
    global _records, _records_flag_ver
    ver = _flags.version()
    if _records_flag_ver == ver:
        return
    _records_flag_ver = ver
    try:
        n = max(int(_flags.get_flag("obs_compile_records", 1024)), 1)
    except (TypeError, ValueError):
        n = 1024
    if _records.maxlen != n:
        _records = deque(_records, maxlen=n)


def _phase():
    if getattr(_tls, "warmup", 0) > 0:
        return "warmup"
    if _steady_count > 0:
        return "steady"
    return ""


def _classify(kind, label, key):
    """Trigger + diff of a build against the newest prior key of the
    same (kind, label); caller holds _lock. ``cold`` for a label never
    built; ``program_mutation`` when its ``version`` moved;
    ``shape_change`` when another component did; ``uncached_rebuild``
    when the key is one already built."""
    hist = _key_history.get((kind, label))
    if not hist:
        return "cold", {}
    prior = hist[-1]
    changed = sorted(n for n in set(prior) | set(key)
                     if prior.get(n) != key.get(n))
    diff = {"changed": changed,
            "detail": {n: [prior.get(n), key.get(n)] for n in changed}}
    if not changed:
        return "uncached_rebuild", diff
    if "version" in changed:
        return "program_mutation", diff
    return "shape_change", diff


def on_build(kind, label, key, wall_ms=0.0):
    """One build of ``kind`` (one of ``KINDS``) for ``label`` (a program
    label or a kernel name) with cache ``key`` (a dict of JSON-able
    components). Records it, classifies its trigger, and applies the
    strict gate: raises SteadyStateRecompileError AFTER recording when
    the gate is armed and tripped. Returns the record."""
    if kind not in KINDS:
        raise ValueError("build kind must be one of %s, got %r"
                         % (KINDS, kind))
    key = dict(key)
    with _lock:
        _apply_record_bound()
        trigger, diff = _classify(kind, label, key)
        hist = _key_history.setdefault((kind, label), [])
        hist[:] = [k for k in hist if k != key]
        hist.append(key)
        del hist[:-_KEY_HISTORY_CAP]
        _key_history.move_to_end((kind, label))
        while len(_key_history) > _LABELS_CAP:
            _key_history.popitem(last=False)
        record = {
            "kind": kind, "label": str(label), "key": key,
            "trigger": trigger, "diff": diff,
            "wall_ms": round(float(wall_ms), 3), "phase": _phase(),
            "ts": time.time(), "rank": _rank(),
        }
        _records.append(record)
        _totals["builds"] += 1
        _totals["build_ms"] += float(wall_ms)
        _kind_totals[kind] += 1
        _trigger_totals[trigger] += 1
        # only a build on a serving-request thread can violate the gate,
        # and the warmup exemption is per thread too (one owner's live
        # warmup must not mask a sibling's steady build)
        steady_violation = (
            _steady_count > 0
            and getattr(_tls, "warmup", 0) == 0
            and getattr(_tls, "depth", 0) > 0
        )
    _profiler.bump_counter("xla_builds")
    _profiler.bump_histogram("xla_build_ms", wall_ms)
    if steady_violation:
        _profiler.bump_counter("serving_steady_recompiles")
        if bool(_flags.get_flag("serving_strict_compiles", False)):
            raise SteadyStateRecompileError(record)
    return record


def _rank():
    from . import trace as _trace

    return _trace.gang_rank()


# ---------------------------------------------------------------------------
# Serving steady-state gate
# ---------------------------------------------------------------------------

def serving_steady(on):
    """Force the steady-state gate to an absolute state (tests / probes).
    Servers and engines use the counted ``arm_serving_steady`` /
    ``disarm_serving_steady`` pair instead, so stopping an old owner
    never disarms the gate out from under a live successor."""
    global _steady_count
    with _lock:
        _steady_count = 1 if on else 0


def arm_serving_steady():
    """One server or engine finished warmup: count its gate in."""
    global _steady_count
    with _lock:
        _steady_count += 1


def disarm_serving_steady():
    """One owner stopped: count its gate out; the gate stays armed while
    any other owner in the process is still live."""
    global _steady_count
    with _lock:
        _steady_count = max(0, _steady_count - 1)


class serving_request_window(object):
    """Marks the current thread as executing a serving request (the
    batcher's workers wrap each dispatch, the engine each window, copy
    and step): only builds inside a request window can violate the armed
    gate. Thread-local and re-entrant."""

    def __enter__(self):
        _tls.depth = getattr(_tls, "depth", 0) + 1
        return self

    def __exit__(self, *exc):
        _tls.depth = max(0, getattr(_tls, "depth", 0) - 1)
        return False


class warmup_window(object):
    """Marks deliberate build activity (server warmup, an engine's
    start-up run): builds inside record with phase ``warmup`` and never
    trip the gate. Thread-local and re-entrant."""

    def __enter__(self):
        _tls.warmup = getattr(_tls, "warmup", 0) + 1
        return self

    def __exit__(self, *exc):
        _tls.warmup = max(0, getattr(_tls, "warmup", 0) - 1)
        return False


# ---------------------------------------------------------------------------
# Read side
# ---------------------------------------------------------------------------

def get_records():
    """Snapshot copy of the retained records, oldest first."""
    with _lock:
        return [dict(r) for r in _records]


def summary():
    """Compact roll-up for snapshots (``registry.snapshot``'s
    ``compiles``): totals by kind and trigger, steady-state violations,
    build wall-clock, and the newest few records. ``builds`` counts every
    kind; ``compiles`` the kernel libraries, the one kind that runs a
    compiler. Totals are process-lifetime counters, not ring-derived."""
    with _lock:
        totals = dict(_totals)
        by_kind = {k: _kind_totals.get(k, 0) for k in KINDS}
        by_trigger = dict(_trigger_totals)
        recent = [
            {"kind": r["kind"], "label": r["label"],
             "trigger": r["trigger"], "wall_ms": r["wall_ms"],
             "phase": r["phase"]}
            for r in list(_records)[-8:]
        ]
    return {
        "builds": totals["builds"],
        "compiles": by_kind["kernel_library"],
        "by_kind": by_kind,
        "by_trigger": by_trigger,
        "steady_recompiles": _profiler.get_counter(
            "serving_steady_recompiles"
        ),
        "build_ms_total": round(totals["build_ms"], 3),
        "recent": recent,
    }


def compiles_endpoint():
    """The exporter's ``/compiles`` document: summary + full records."""
    return {
        "schema_version": 1,
        "ts": time.time(),
        "rank": _rank(),
        "pid": os.getpid(),
        "serving_steady": _steady_count > 0,
        "summary": summary(),
        "records": get_records(),
    }


def reset():
    """Drop records, key history and gate state (tests)."""
    global _steady_count
    with _lock:
        _records.clear()
        _key_history.clear()
        _totals.update(builds=0, build_ms=0.0)
        _kind_totals.clear()
        _trigger_totals.clear()
        _steady_count = 0
        _tls.depth = 0
        _tls.warmup = 0
