"""Runtime flags (port of ``paddle_tpu/fluid/flags.py``: the serving,
decode, gateway, fleet and observability knobs).

Only the knobs that the micro-batching server, the decode engine and its
scheduler, the KV tier, the gateway, the router, the fleet controller
and its simulator, the process supervisor, the strict build gate, the
tracer, the flight recorder, the exporter and the chaos harness read
are carried over, with
the reference's defaults, plus the same ``FLAGS_<name>`` environment
bridge: an environment variable overrides a default when the module
loads, and ``set_flags`` overrides at run time. ``version()`` counts
those writes, so a reader can cache what it derives from a flag and
re-derive it only when the count moves. Later slices add their knobs
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
    # strict serving gate (observability/compile_stats.py): once a
    # server or engine finished its warmup, a build on a serving-request
    # thread (an Executor plan, a predictor plan, a kernel library)
    # raises SteadyStateRecompileError instead of only bumping
    # serving_steady_recompiles
    "serving_strict_compiles": False,
    # HTTP gateway (serving/gateway.py): gateway_port binds the listener
    # (0 = ephemeral); per-tenant token-bucket rate limit
    # (gateway_rate_limit_rps refill, 0 = unlimited; gateway_rate_burst
    # capacity) and inflight quota (gateway_tenant_max_inflight, 0 =
    # unlimited); gateway_max_inflight caps the whole gateway (beyond it
    # requests wait in priority order up to gateway_admit_timeout_ms,
    # then shed 429); gateway_drain_timeout_s bounds the graceful drain;
    # gateway_access_log appends one JSONL line per request ("" = off),
    # rotated past gateway_access_log_max_mb (0 = unbounded)
    "gateway_port": 0,
    "gateway_rate_limit_rps": 0.0,
    "gateway_rate_burst": 20,
    "gateway_tenant_max_inflight": 0,
    "gateway_max_inflight": 64,
    "gateway_admit_timeout_ms": 100.0,
    "gateway_drain_timeout_s": 30.0,
    "gateway_access_log": "",
    "gateway_access_log_max_mb": 0.0,
    # fleet KV tier (serving/kv_tier.py) over the paged pool:
    # kv_tier_host_mb sizes the host-spill store (evicted device blocks
    # spill D2H and readmit H2D on a later chain hit; 0 = off);
    # kv_tier_advert_k bounds the chain-head keys a replica advertises on
    # /readyz for the router's cache affinity, kv_tier_advert_ttl_s the
    # router-side age past which an advertisement is ignored. The
    # role-split pull: a decode-role replica pulls published blocks from
    # a prefill-role peer listed in kv_tier_peers_file when it would
    # cache fewer than kv_tier_pull_min_tokens locally (0 = off), within
    # kv_tier_pull_timeout_s
    "kv_tier_host_mb": 0.0,
    "kv_tier_advert_k": 8,
    "kv_tier_advert_ttl_s": 5.0,
    "kv_tier_peers_file": "",
    "kv_tier_pull_min_tokens": 0,
    "kv_tier_pull_timeout_s": 2.0,
    # serving fleet (serving/fleet.py): a FleetController supervises
    # replica processes behind one Router. The "streak" autoscaler
    # scrapes each replica's /metrics every fleet_scale_interval_s and
    # scales between fleet_min_replicas and fleet_max_replicas: queue
    # depth >= fleet_queue_high (or any shed, or p95 latency over
    # fleet_latency_high_ms when > 0) for fleet_scale_up_ticks scrapes
    # adds a replica, <= fleet_queue_low for fleet_scale_down_ticks
    # drains one. A replica must be ready within
    # fleet_replica_ready_timeout_s; crashes restart with
    # fleet_restart_backoff_s exponential backoff under
    # fleet_max_replica_restarts; drains SIGTERM and SIGKILL after
    # fleet_drain_grace_s. fleet_policy "slo" scales on p95 TTFT /
    # inter-token budgets instead (0 disarms one), scaling down under
    # fleet_slo_headroom x budget
    "fleet_min_replicas": 1,
    "fleet_max_replicas": 4,
    "fleet_scale_interval_s": 2.0,
    "fleet_queue_high": 8.0,
    "fleet_queue_low": 1.0,
    "fleet_latency_high_ms": 0.0,
    "fleet_scale_up_ticks": 2,
    "fleet_scale_down_ticks": 5,
    "fleet_replica_ready_timeout_s": 180.0,
    "fleet_restart_backoff_s": 0.5,
    "fleet_max_replica_restarts": 10,
    "fleet_drain_grace_s": 15.0,
    "fleet_policy": "streak",
    "fleet_slo_ttft_ms": 2000.0,
    "fleet_slo_intertoken_ms": 0.0,
    "fleet_slo_headroom": 0.6,
    # controller durability: replicas re-stamp an endpoint lease every
    # fleet_lease_interval_s, older than fleet_lease_ttl_s means dead;
    # the controller's journal lease (workdir/fleet_state.json) younger
    # than fleet_state_lease_ttl_s with a live pid refuses a second
    # controller (split-brain guard), else the newcomer adopts the pool
    "fleet_lease_interval_s": 1.0,
    "fleet_lease_ttl_s": 5.0,
    "fleet_state_lease_ttl_s": 10.0,
    # fleet simulator (serving/sim): spawn-to-ready lag of a simulated
    # scaled-up replica
    "sim_replica_ready_s": 5.0,
    # replica router (serving/router.py): router_port binds the listener
    # (0 = ephemeral); a health thread polls every backend's /readyz each
    # router_health_interval_s; an idempotent /v1/infer that hits a dead
    # replica retries on another up to router_retries times;
    # router_backend_timeout_s bounds each proxied connect/read; a pinned
    # /v1/generate stream whose replica dies resumes on another with the
    # emitted suffix up to router_generate_retries times (0 = off);
    # router_breaker_failures consecutive failures open a backend's
    # breaker for router_breaker_cooldown_s (0 = no breaker);
    # router_access_log is the router's JSONL access log ("" = off),
    # rotated past router_access_log_max_mb
    "router_port": 0,
    "router_health_interval_s": 0.5,
    "router_retries": 2,
    "router_backend_timeout_s": 60.0,
    "router_generate_retries": 2,
    "router_breaker_failures": 3,
    "router_breaker_cooldown_s": 2.0,
    "router_access_log": "",
    "router_access_log_max_mb": 0.0,
    # process supervision (distributed/supervisor.py; the fleet reuses
    # its heartbeat protocol): staleness bound of a worker heartbeat, the
    # worker-side beat throttle, the grace before a worker's first step,
    # restart backoff (doubling, capped) and the preemption restart
    # budget; elastic_min_world_size > 0 lets a restart shrink the gang,
    # elastic_lr_rescale scales the learning rate with it
    "dist_heartbeat_timeout_s": 60.0,
    "dist_heartbeat_interval_s": 0.5,
    "dist_startup_grace_s": 600.0,
    "dist_restart_backoff_s": 1.0,
    "dist_restart_backoff_max_s": 30.0,
    "dist_max_preempt_restarts": 100,
    "elastic_min_world_size": 0,
    "elastic_lr_rescale": False,
    # flight recorder ring (one journey record per request) and the
    # bounded span dump written beside it (observability/flight.py,
    # exporter.dump_blackbox)
    "trace_flight_records": 256,
    "trace_dump_spans": 4096,
    # deterministic fault injection (testing/chaos.py): -1/0/"" =
    # disarmed; target_rank scopes step faults to one gang member;
    # marker_dir makes each fault one-shot across restarts;
    # die_after_tokens SIGKILLs the process after that many SSE tokens
    "chaos_crash_at_step": -1,
    "chaos_hang_at_step": -1,
    "chaos_lose_rank": -1,
    "chaos_lose_rank_at_step": -1,
    "chaos_lose_rank_for": -1,
    "chaos_nan_grad_at_step": -1,
    "chaos_loss_spike_at_step": -1,
    "chaos_bitflip_grad_at_step": -1,
    "chaos_corrupt_ckpt": False,
    "chaos_slow_feed_ms": 0.0,
    "chaos_rpc_fail_n": 0,
    "chaos_target_rank": -1,
    "chaos_marker_dir": "",
    "chaos_die_after_tokens": -1,
    "chaos_die_replica": -1,
    "chaos_kill_controller_after_s": -1.0,
    # observability: obs_trace gates the span tracer, obs_trace_buffer
    # bounds retained spans; obs_http_port exposes /metrics /healthz
    # /trace /compiles (-1 off, 0 ephemeral, >0 that port or up to
    # obs_http_port_retries successors); obs_dir arms per-rank JSONL
    # snapshots and the black-box dumps, obs_snapshot_interval_s paces
    # them (0 = one final snapshot only); obs_compile_records bounds the
    # build-record ring. obs_compile_census is accepted and recorded:
    # the port has no compiler census to run
    "obs_trace": True,
    "obs_trace_buffer": 65536,
    "obs_http_port": -1,
    "obs_http_port_retries": 8,
    "obs_dir": "",
    "obs_snapshot_interval_s": 0.0,
    "obs_compile_census": True,
    "obs_compile_records": 1024,
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
