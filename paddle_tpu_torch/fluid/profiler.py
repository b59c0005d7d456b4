"""Always-on counters and value histograms (port of the tally half of
``paddle_tpu/fluid/profiler.py``).

The decode session bumps ``decode_prefills`` / ``decode_steps`` and
records ``decode_prefill_ms`` / ``decode_step_ms`` here, the decode
engine its admission, prefix, resume and preemption counters and
``decode_ttft_ms`` / ``decode_intertoken_ms``; the GPT train
step (``models.gpt.build_gpt_lm_train``) bumps ``train_steps`` and
records ``train_step_ms``, as the reference's trainer does. Thread-safe:
the engine's loop thread bumps while callers read. Each histogram keeps
a bounded window of its newest samples.
"""

import threading
from collections import defaultdict, deque

__all__ = [
    "bump_counter",
    "get_counter",
    "get_counters",
    "reset_counters",
    "bump_histogram",
    "get_histogram",
    "get_histograms",
    "summarize_histogram",
    "reset_histograms",
]

_HISTOGRAM_WINDOW = 65536
_lock = threading.Lock()
_counters = defaultdict(int)
_histograms = {}


def bump_counter(name, n=1):
    with _lock:
        _counters[name] += n


def get_counter(name, default=0):
    with _lock:
        return _counters.get(name, default)


def get_counters():
    """Snapshot copy of every counter (the registry renders these)."""
    with _lock:
        return dict(_counters)


def reset_counters():
    """Clear the counters only; histograms have their own reset."""
    with _lock:
        _counters.clear()


def bump_histogram(name, value):
    """Record one sample (e.g. a step latency in ms)."""
    with _lock:
        h = _histograms.get(name)
        if h is None:
            h = _histograms[name] = deque(maxlen=_HISTOGRAM_WINDOW)
        h.append(float(value))


def get_histogram(name):
    """Snapshot copy of one histogram's samples (empty when absent)."""
    with _lock:
        h = _histograms.get(name)
        return list(h) if h is not None else []


def get_histograms():
    """Snapshot {name: [samples]} of every histogram, list copies."""
    with _lock:
        return {k: list(v) for k, v in _histograms.items()}


def summarize_histogram(name):
    """{count, sum, mean, p50, p99, max} over one histogram's window;
    nearest-rank percentiles (index ceil(p*n)-1), as the reference."""
    samples = sorted(get_histogram(name))
    if not samples:
        return {"count": 0, "sum": 0.0, "mean": 0.0, "p50": 0.0,
                "p99": 0.0, "max": 0.0}
    n = len(samples)

    def rank(p):
        return samples[max(0, -(-p * n // 100) - 1)]

    return {
        "count": n,
        "sum": float(sum(samples)),
        "mean": float(sum(samples) / n),
        "p50": float(rank(50)),
        "p99": float(rank(99)),
        "max": float(samples[-1]),
    }


def reset_histograms():
    with _lock:
        _histograms.clear()
