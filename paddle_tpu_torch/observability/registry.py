"""Unified metrics registry (port of
``paddle_tpu/observability/registry.py``): one read side over the
always-on profiler counters and histograms.

The backing store stays ``fluid.profiler``'s locked counters and bounded
histograms, so every ``bump_counter`` call site already publishes here;
this module renders them as Prometheus text for scrape endpoints, as
JSONL snapshots for per-rank files, and owns the shared percentile math.

Gauges are the one signal counters cannot carry (queue depth, slot
occupancy): they register as callables sampled at render time, so a
dead gauge (its owner stopped) is skipped rather than poisoning the
scrape. The decode engine registers ``serving_slot_occupancy``,
``decode_queue_depth`` and, on the paged pool, ``decode_blocks_free``,
``decode_blocks_shared`` and ``decode_spec_acceptance`` while it runs.
"""

import json
import os
import re
import threading
import time

import numpy as np

from ..fluid import profiler as _profiler
from . import trace as _trace

__all__ = [
    "SCHEMA_VERSION",
    "Counter",
    "Histogram",
    "counter",
    "histogram",
    "register_gauge",
    "unregister_gauge",
    "gauge_values",
    "percentiles",
    "render_prometheus",
    "parse_prometheus",
    "snapshot",
    "write_snapshot",
    "snapshot_path",
]

# versions every machine-readable artifact this layer emits (JSONL
# snapshots; aggregate.py stamps its gang report with the same number):
# consumers can dispatch on it instead of sniffing fields
SCHEMA_VERSION = 1

_gauges = {}  # name -> callable() -> number
_gauges_lock = threading.Lock()


class Counter(object):
    """Handle over one always-on profiler counter (monotonic)."""

    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name

    def inc(self, n=1):
        _profiler.bump_counter(self.name, n)

    def value(self):
        return _profiler.get_counter(self.name)


class Histogram(object):
    """Handle over one sliding-window profiler histogram."""

    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name

    def observe(self, value):
        _profiler.bump_histogram(self.name, value)

    def summary(self):
        return _profiler.summarize_histogram(self.name)


def counter(name):
    return Counter(name)


def histogram(name):
    return Histogram(name)


def register_gauge(name, fn):
    """Register ``fn() -> number`` sampled at every render/snapshot.
    Re-registering a name replaces it (a restarted server re-owns its
    gauge)."""
    with _gauges_lock:
        _gauges[name] = fn


def unregister_gauge(name, fn=None):
    """Remove a gauge. With ``fn`` given, removal happens only while it
    is still the registered callable — a stopping owner must not tear
    down a successor's re-registration of the same name."""
    with _gauges_lock:
        if fn is None or _gauges.get(name) is fn:
            _gauges.pop(name, None)


def gauge_values():
    """{name: float} for every registered gauge whose callable still
    works; erroring gauges are skipped (a stopped owner must not poison
    the scrape)."""
    with _gauges_lock:
        items = list(_gauges.items())
    out = {}
    for name, fn in items:
        try:
            out[name] = float(fn())
        except Exception:
            continue
    return out


def percentiles(samples, points=(50, 95, 99)):
    """{count, mean, p<point>...} with linear-interpolation percentiles
    (numpy semantics) rounded to 3 decimals, Nones when empty — the
    exact contract ServingStats.latency_ms always had; it now lives here
    so serving, probes, and the gang aggregator share one formula."""
    if samples is None or len(samples) == 0:
        return {"count": 0, "mean": None,
                **{"p%d" % p: None for p in points}}
    arr = np.asarray(samples, dtype=np.float64)
    out = {"count": int(arr.size), "mean": round(float(arr.mean()), 3)}
    for p in points:
        out["p%d" % p] = round(float(np.percentile(arr, p)), 3)
    return out


# Prometheus metric names: [a-zA-Z_:][a-zA-Z0-9_:]*
_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")


def prom_name(name):
    n = _SANITIZE.sub("_", str(name))
    if not n or n[0].isdigit():
        n = "_" + n
    return n


def render_prometheus():
    """The registry as Prometheus text exposition (version 0.0.4):
    counters as ``counter``, gauges as ``gauge``, histograms as
    ``summary`` (quantile series + _sum/_count over the bounded window).
    Every registered counter round-trips: ``parse_prometheus`` of this
    text recovers exact values (the obs_probe acceptance check)."""
    lines = []
    for name, val in sorted(_profiler.get_counters().items()):
        pn = prom_name(name)
        lines.append("# TYPE %s counter" % pn)
        lines.append("%s %d" % (pn, val))
    gauge_typed = set()
    for name, val in sorted(gauge_values().items()):
        # a gauge registered as 'name{label="v"}' renders as a labeled
        # series under the base family (one TYPE line per family) —
        # how the per-class admission-wait gauges expose their class
        base, _, labels = str(name).partition("{")
        pn = prom_name(base)
        if pn not in gauge_typed:
            gauge_typed.add(pn)
            lines.append("# TYPE %s gauge" % pn)
        series = pn + ("{" + labels if labels else "")
        lines.append("%s %.17g" % (series, val))
    for name, samples in sorted(_profiler.get_histograms().items()):
        pn = prom_name(name)
        s = percentiles(samples, points=(50, 95, 99))
        lines.append("# TYPE %s summary" % pn)
        for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
            lines.append('%s{quantile="%g"} %.17g' % (pn, q, s[key]))
        lines.append("%s_sum %.17g" % (pn, float(np.sum(samples))))
        lines.append("%s_count %d" % (pn, len(samples)))
    return "\n".join(lines) + "\n"


def parse_prometheus(text):
    """Inverse of ``render_prometheus`` for round-trip checks:
    {(name, labels_str): float} — labels_str is "" for plain series."""
    out = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        metric, _, val = line.rpartition(" ")
        if "{" in metric:
            name, _, rest = metric.partition("{")
            labels = rest.rstrip("}")
        else:
            name, labels = metric, ""
        try:
            out[(name, labels)] = float(val)
        except ValueError:
            continue
    return out


def snapshot(rank=None):
    """One JSON-able snapshot of everything registered: schema_version,
    wall-clock ``ts`` (for humans) AND monotonic ``ts_mono`` (orders
    events across NTP steps on one host), rank/pid, counters, gauges,
    and per-histogram summaries: the per-rank record a gang aggregator
    merges."""
    from . import compile_stats as _compile_stats

    rank = _trace.gang_rank(rank)
    hists = {
        name: percentiles(samples, points=(50, 95, 99))
        for name, samples in _profiler.get_histograms().items()
    }
    return {
        "schema_version": SCHEMA_VERSION,
        "ts": time.time(),
        "ts_mono": time.monotonic(),
        "rank": int(rank),
        "pid": os.getpid(),
        "counters": _profiler.get_counters(),
        "gauges": gauge_values(),
        "histograms": hists,
        # per-rank build roll-up (kinds, triggers, steady violations,
        # the newest records), as the reference's compile roll-up
        "compiles": _compile_stats.summary(),
    }


def snapshot_path(dirname, rank=None):
    return os.path.join(
        str(dirname), "rank_%d.jsonl" % _trace.gang_rank(rank)
    )


def write_snapshot(dirname, rank=None):
    """Append one snapshot line to ``dirname/rank_<rank>.jsonl``
    (O_APPEND single write: concurrent writers at worst interleave whole
    lines, and the aggregator skips torn ones). Returns the path."""
    snap = snapshot(rank=rank)
    path = snapshot_path(dirname, rank=snap["rank"])
    os.makedirs(str(dirname), exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(snap, sort_keys=True) + "\n")
    return path
