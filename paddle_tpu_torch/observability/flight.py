"""Per-request flight recorder (port of
``paddle_tpu/observability/flight.py``): the journey records that
SURVIVE a process.

The span tracer answers "where did the milliseconds go" while the
process is alive to be asked; a crashed or SIGKILLed replica takes its
ring buffer with it. The flight recorder is the black box beside it: a
bounded per-process ring of one JSON record per REQUEST — admission
wait, queue depth at entry, prefill windows, decode ticks spanned,
retries/failovers, terminal status, and the request's trace_id so the
record joins the distributed trace — dumped to ``FLAGS_obs_dir`` on
drain/SIGTERM/final-snapshot, periodically by the exporter's snapshot
loop, and (throttled) the moment a request ends in a server error. The
fleet report merges every process's dump into one slowest-requests
table (``observability.aggregate``).

Writers are the serving front doors (gateway, router): they call
``note(record)`` once per finished request with whatever journey facts
they hold. The ring is bounded by ``FLAGS_trace_flight_records`` —
evictions are counted (``trace_flight_dropped``), never an error.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from ..fluid import flags as _flags
from ..fluid import profiler as _profiler
from . import trace as _trace

__all__ = ["note", "records", "reset", "dump", "dump_on_error",
           "flight_path", "to_journey", "write_journeys",
           "load_journeys", "JOURNEY_SCHEMA_VERSION"]

# the stable journey-export schema (JSONL, one journey per line). Bumped
# only when a FIELD changes meaning — adding optional fields is not a
# bump; consumers (the simulator, the fleet report) read by name and
# ignore what they don't know.
JOURNEY_SCHEMA_VERSION = 1

_lock = threading.Lock()
_buf = deque(maxlen=256)
_flags_seen = None  # re-apply the ring bound when the flags change
_last_error_dump = 0.0


def _bound():
    try:
        return max(int(_flags.get_flag("trace_flight_records", 256)), 1)
    except (TypeError, ValueError):
        return 256


def _apply_bound_locked():
    global _buf, _flags_seen
    ver = _flags.version()
    if ver == _flags_seen:
        return
    _flags_seen = ver
    n = _bound()
    if _buf.maxlen != n:
        _buf = deque(_buf, maxlen=n)


def note(record):
    """Append one per-request journey record (a flat JSON-serializable
    dict). Cheap: one locked append; the oldest record falls off when
    the ring is full (counted, never raised)."""
    with _lock:
        _apply_bound_locked()
        dropped = len(_buf) == _buf.maxlen
        _buf.append(dict(record))
    _profiler.bump_counter("trace_flight_noted")
    if dropped:
        _profiler.bump_counter("trace_flight_dropped")


def records():
    """Copies of the retained records, oldest first."""
    with _lock:
        return [dict(r) for r in _buf]


def reset():
    global _flags_seen
    with _lock:
        _flags_seen = None
        _buf.clear()


def flight_path(dirname, rank=None):
    return os.path.join(
        str(dirname), "flight_rank_%d.json" % _trace.gang_rank(rank)
    )


def dump(dirname=None, rank=None):
    """Write the current ring to ``dirname`` (default FLAGS_obs_dir) as
    ``flight_rank_<r>.json`` — whole-file atomic replace, newest state
    wins, so repeated dumps (periodic + final) never duplicate records
    downstream. Returns the path, or None when no directory is armed.
    Never raises: the recorder must not take down the path it
    observes."""
    dirname = dirname or str(_flags.get_flag("obs_dir", "") or "")
    if not dirname:
        return None
    try:
        os.makedirs(str(dirname), exist_ok=True)
        path = flight_path(dirname, rank=rank)
        tmp = "%s.tmp.%d" % (path, os.getpid())
        payload = {
            "schema_version": _trace.TRACE_SCHEMA_VERSION,
            "ts": time.time(),
            "pid": os.getpid(),
            "records": records(),
        }
        with open(tmp, "w") as f:
            json.dump(payload, f, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        return None
    _profiler.bump_counter("trace_flight_dumps")
    return path


def dump_on_error(throttle_s=5.0):
    """Dump after a request ended in a server error — throttled so an
    error storm costs one disk write per window, not one per failure."""
    global _last_error_dump
    now = time.monotonic()
    with _lock:
        if now - _last_error_dump < throttle_s:
            return None
        _last_error_dump = now
    return dump()


def load(path):
    """Parse one dump file back into its record list ([] on any
    problem — merge tooling treats a torn dump as an empty one)."""
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, ValueError):
        return []
    recs = payload.get("records")
    return recs if isinstance(recs, list) else []


# -- journey export/import ---------------------------------------------------
#
# The flight ring's records are whatever the front door stashed that
# day; the JOURNEY is the stable, versioned view of one — the contract
# the simulator replays and the fleet report tabulates, so neither ever
# reaches into ring internals or chases a gateway field rename.

_J_STR = ("request_id", "tenant", "priority", "endpoint", "reason",
          "trace_id", "backend", "process")
_J_NUM = ("ts", "ms", "status", "tokens", "admit_wait_ms",
          "inflight_at_entry", "ttft_ms", "ticks_spanned", "retries",
          "failovers", "cached_prefix_tokens", "admit_windows",
          "resumed_tokens", "preemptions")


def _num(v):
    if isinstance(v, bool):
        return None
    if isinstance(v, str):
        # hand-edited / re-exported JSONL sometimes quotes numbers;
        # accept them, drop anything unparseable
        try:
            return float(v)
        except ValueError:
            return None
    if not isinstance(v, (int, float)):
        return None
    return float(v) if isinstance(v, float) else int(v)


def to_journey(record):
    """Normalize one raw flight record (or an already-exported journey
    line) into the stable journey dict: known string fields coerced to
    str, known numeric fields to int/float (bad types dropped, never
    raised), ``schema_version`` stamped, unknown fields discarded.
    ``priority`` defaults to ``interactive`` and ``tenant`` to ``anon``
    so every journey is replayable as-is."""
    rec = record if isinstance(record, dict) else {}
    j = {"schema_version": JOURNEY_SCHEMA_VERSION}
    for k in _J_STR:
        v = rec.get(k)
        if v is not None and not isinstance(v, (dict, list)):
            j[k] = str(v)
    for k in _J_NUM:
        v = _num(rec.get(k))
        if v is not None:
            j[k] = v
    j.setdefault("tenant", "anon")
    if j.get("priority") not in ("interactive", "batch"):
        j["priority"] = "interactive"
    return j


def write_journeys(path, records_in=None):
    """Export journeys as JSONL (one ``to_journey`` dict per line) to
    ``path``, atomic replace. ``records_in`` defaults to the live ring.
    Returns the number of lines written."""
    recs = records() if records_in is None else list(records_in)
    rows = [to_journey(r) for r in recs]
    tmp = "%s.tmp.%d" % (str(path), os.getpid())
    with open(tmp, "w") as f:
        for row in rows:
            f.write(json.dumps(row, sort_keys=True) + "\n")
    os.replace(tmp, str(path))
    return len(rows)


def load_journeys(path):
    """Parse a journey JSONL file back into journey dicts (each
    re-normalized through ``to_journey`` — a hand-edited or
    future-versioned line still yields the fields this version knows).
    Torn lines are skipped; a missing file reads as []."""
    out = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except ValueError:
                    continue
                if isinstance(row, dict):
                    out.append(to_journey(row))
    except OSError:
        return []
    return out
