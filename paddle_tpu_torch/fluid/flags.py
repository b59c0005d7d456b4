"""Runtime flags (port of ``paddle_tpu/fluid/flags.py``: the serving
and decode knobs).

Only the knobs the micro-batching server, the decode engine and its
scheduler read are carried over, with the reference's defaults, plus the
same ``FLAGS_<name>`` environment bridge: an environment variable overrides a default when the
module loads, and ``set_flags`` overrides at run time. ``version()``
counts those writes, so a reader can cache what it derives from a flag
and re-derive it only when the count moves. Later slices add their knobs
here.
"""

import os

__all__ = ["get_flag", "set_flags", "version"]

_DEFAULTS = {
    # InferenceServer's micro-batch coalescer. serving_max_batch_size caps
    # the request rows of one device batch (and tops the default
    # padding-bucket ladder); serving_batch_timeout_ms bounds how long
    # the first request of a batch waits for more; serving_queue_depth
    # bounds admission (beyond it requests shed with retry-after);
    # serving_workers sizes the predictor pool and its dispatch threads;
    # serving_default_deadline_ms is the per-request deadline (0 = none),
    # past which a queued request is shed at dispatch
    "serving_max_batch_size": 8,
    "serving_batch_timeout_ms": 5.0,
    "serving_queue_depth": 64,
    "serving_workers": 2,
    "serving_default_deadline_ms": 0.0,
    # KV-cache slot pool + continuous batching engine. decode_slots sizes
    # the pool (max concurrent streams); decode_max_len caps the per-slot
    # cache length (0 = the model's max_position_embeddings);
    # decode_prefill_buckets overrides the power-of-two prompt ladder
    # (CSV); decode_queue_depth bounds admission (beyond it submissions
    # shed with ServerOverloadedError)
    "decode_slots": 8,
    "decode_max_len": 0,
    "decode_prefill_buckets": "",
    "decode_queue_depth": 64,
    # contiguous pool's prefix store: decode_prefix_block is the reuse
    # granularity in tokens (a prompt reuses its longest cached
    # whole-block prefix, hash-chain keyed and token-verified)
    "decode_prefix_block": 64,
    # paged engine (engine v2): decode_block_size > 0 switches to block
    # tables over ONE shared KV pool (0 = the contiguous slot pool);
    # decode_spec_tokens = k > 1 arms speculative decoding on top of it
    # (a k-1-token draft per slot per tick, one batched verify);
    # decode_spec_draft names the drafter ("ngram" or "repeat");
    # decode_prefill_chunk caps the prompt tokens one tick prefills (0 =
    # one window per prompt); decode_prefix_cache_mb caps the pool
    # blocks the zero-copy prefix index may pin (0 = no prefix caching)
    "decode_block_size": 0,
    "decode_spec_tokens": 0,
    "decode_spec_draft": "ngram",
    "decode_prefill_chunk": 0,
    "decode_prefix_cache_mb": 0.0,
    # decode-slot scheduler: pending admissions dequeue weighted-fair
    # across tenants (stride scheduling; sched_tenant_weights is
    # "tenantA:4,tenantB:1", unlisted tenants weigh 1), interactive
    # strictly ahead of batch; with sched_preempt an interactive request
    # waiting for a slot evicts a batch stream, which re-prefills its
    # prompt and emitted tokens on re-admission (token-exact)
    "sched_preempt": True,
    "sched_tenant_weights": "",
}

_flags = {}
_version = 0  # bumped after every write


def version():
    """A counter that every ``set_flags`` (and the environment read)
    bumps: a cache of flag-derived state revalidates with one compare."""
    return _version


def _coerce(default, text):
    if isinstance(default, bool):
        return text.lower() in ("1", "true", "yes", "on")
    if isinstance(default, int):
        return int(text)
    if isinstance(default, float):
        return float(text)
    return text


def _read_env():
    global _version
    _flags.clear()
    _flags.update(_DEFAULTS)
    for name, default in _DEFAULTS.items():
        env = os.environ.get("FLAGS_" + name)
        if env is not None:
            try:
                _flags[name] = _coerce(default, env)
            except ValueError:
                pass
    _version += 1


def _key(name):
    return name[6:] if name.startswith("FLAGS_") else name


def set_flags(flags):
    """paddle-compatible flag write: {FLAGS_name: value}. Every key is
    validated and coerced before any is applied."""
    global _version
    staged = {}
    for n, v in flags.items():
        key = _key(n)
        if key not in _DEFAULTS:
            raise ValueError("flag %r is not registered" % n)
        staged[key] = (_coerce(_DEFAULTS[key], v) if isinstance(v, str)
                       else v)
    _flags.update(staged)
    _version += 1


def get_flag(name, default=None):
    return _flags.get(_key(name), default)


_read_env()
