"""ServingStats — the observability snapshot of a running server (a
copy of ``paddle_tpu/serving/metrics.py``).

All raw signals ride the always-on ``fluid.profiler`` counters and
sliding-window histograms (the surface the ``observability`` registry's
Prometheus/JSONL renderers read), so one snapshot call assembles: queue
depth, batch-fill ratio, bucket-plan hit rate, latency percentiles, and
shed counts. Percentile math is delegated to
``observability.registry.percentiles``. Counter fields are deltas since
the server's ``start()`` (the baseline snapshot), and the latency
percentiles exclude samples recorded before it (via the histogram sample
count at start) — so a fresh server's stats start at zero even when
other serving activity preceded it in the process. Percentiles are over
the histogram's bounded sliding window (the most recent samples).

Known tradeoff: the counters are process-global (one surface for the
executor, predictor, and server alike), so the baseline-delta isolation
is exact for SEQUENTIAL servers only — two servers serving concurrently
in one process see each other's serving_* bumps and latency samples
mixed into their snapshots.
"""

from __future__ import annotations

from ..fluid import profiler as _profiler
from ..observability import registry as _registry

__all__ = ["ServingStats", "snapshot_stats"]

_COUNTERS = (
    "serving_requests",
    "serving_completed",
    "serving_shed_overload",
    "serving_shed_deadline",
    "serving_batches",
    "serving_batched_rows",
    "serving_pad_rows",
    "serving_bucket_hits",
    "serving_bucket_misses",
    "predictor_plan_cache_hits",
    "predictor_plan_cache_misses",
)


class ServingStats(object):
    """Immutable snapshot; ``as_dict()`` for logging/JSON."""

    __slots__ = (
        "queue_depth", "requests", "completed", "shed_overload",
        "shed_deadline", "batches", "batched_rows", "pad_rows",
        "batch_fill_ratio", "bucket_hits", "bucket_misses",
        "bucket_hit_rate", "plan_cache_hits", "plan_cache_misses",
        "latency_ms",
    )

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw.get(k))

    def as_dict(self):
        return {k: getattr(self, k) for k in self.__slots__}

    def __repr__(self):
        return "ServingStats(%s)" % ", ".join(
            "%s=%r" % (k, getattr(self, k)) for k in self.__slots__
        )


def snapshot_stats(baseline=None, queue_depth=0, max_batch_size=1,
                   latency_baseline_count=0):
    """Assemble a ServingStats from the live profiler counters minus the
    ``baseline`` snapshot (dict from profiler.get_counters()).
    ``latency_baseline_count`` (the histogram's sample count at server
    start) excludes a PREVIOUS server's samples from the percentiles;
    once the sliding window has wrapped the slice turns conservative
    (oldest in-window samples dropped), which is exact whenever fewer
    than the window's 65536 samples have ever been recorded."""
    c = _profiler.get_counters()
    base = baseline or {}
    # clamped at zero: a profiler.reset_counters()/reset_profiler() call
    # mid-serving zeroes the live counters under the baseline — report
    # from-zero figures rather than negative ones
    d = {k: max(c.get(k, 0) - base.get(k, 0), 0) for k in _COUNTERS}
    batches = d["serving_batches"]
    rows = d["serving_batched_rows"]
    fill = (
        round(rows / float(batches * max_batch_size), 4) if batches else None
    )
    bh, bm = d["serving_bucket_hits"], d["serving_bucket_misses"]
    hit_rate = round(bh / float(bh + bm), 4) if (bh + bm) else None
    lat = _profiler.get_histogram("serving_latency_ms")
    if latency_baseline_count and len(lat) >= latency_baseline_count:
        lat = lat[latency_baseline_count:]
    # else: a mid-serving histogram reset left fewer samples than the
    # baseline — everything present is post-reset, keep it all
    return ServingStats(
        queue_depth=queue_depth,
        requests=d["serving_requests"],
        completed=d["serving_completed"],
        shed_overload=d["serving_shed_overload"],
        shed_deadline=d["serving_shed_deadline"],
        batches=batches,
        batched_rows=rows,
        pad_rows=d["serving_pad_rows"],
        batch_fill_ratio=fill,
        bucket_hits=bh,
        bucket_misses=bm,
        bucket_hit_rate=hit_rate,
        plan_cache_hits=d["predictor_plan_cache_hits"],
        plan_cache_misses=d["predictor_plan_cache_misses"],
        latency_ms=_registry.percentiles(lat),
    )
