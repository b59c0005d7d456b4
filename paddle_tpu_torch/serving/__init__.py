"""Serving runtime (port of ``paddle_tpu/serving``): the in-process
dynamic-batching front and the autoregressive decode runtime.

Concurrent whole-forward requests coalesce into padded-bucket device
batches over a pool of AnalysisPredictor clones sharing one Executor
plan, with bounded admission (load shedding + retry-after), per-request
deadlines, a warmup of every bucket at start (nothing built on the
request path after it) and a ServingStats snapshot riding the always-on
``fluid.profiler`` counters. Generation rides ``DecodeEngine``
(``serving/decode.py``), standalone or through
``InferenceServer.generate()``. ``Gateway`` (``serving/gateway.py``)
puts a server and its engine on HTTP (``POST /v1/infer``, SSE
``POST /v1/generate``, ``/healthz``, ``/readyz``, per-tenant admission,
graceful drain), with one JSONL ``AccessLog`` line per request.

Above one process sits the fleet control plane: ``FleetController``
(``serving/fleet.py``) spawns and supervises replica processes
(``serving/replica.py``) behind a health-checked ``Router``
(``serving/router.py``: least-inflight and cache-affinity picks,
breakers, SSE pin and mid-stream failover with ``resume_tokens``),
autoscales the pool (``AutoscalerPolicy``, ``SLOPolicy``,
``make_policy``) and rolls new model versions with zero downtime;
``serving/sim`` replays workloads through those classes on a virtual
clock.

Quickstart::

    from paddle_tpu_torch import inference, serving

    pred = inference.create_paddle_predictor(inference.AnalysisConfig(d))
    server = serving.InferenceServer(
        pred, max_batch_size=8, batch_timeout_ms=5, num_workers=2
    ).start(warmup_inputs=[example_x])
    out, = server.infer([x_row], deadline_ms=100)
    print(server.stats().as_dict())
    server.stop()
"""

from . import (  # noqa: F401
    access_log,
    batcher,
    buckets,
    decode,
    fleet,
    gateway,
    kv_tier,
    metrics,
    pool,
    router,
    server,
)
from .access_log import AccessLog
from .batcher import (
    DeadlineExceededError,
    MicroBatcher,
    ServerOverloadedError,
    ServingError,
)
from .buckets import BatchPlan, BucketLadder
from .gateway import Gateway
from .decode import (
    DecodeEngine,
    DecodeSession,
    GenerationStream,
    fast_forward_rng,
    sample_token,
)
from .fleet import AutoscalerPolicy, FleetController, SLOPolicy, make_policy
from .metrics import ServingStats, snapshot_stats
from .pool import PredictorPool
from .router import Router
from .server import InferenceServer

__all__ = [
    "access_log",
    "gateway",
    "kv_tier",
    "Gateway",
    "Router",
    "FleetController",
    "AutoscalerPolicy",
    "SLOPolicy",
    "make_policy",
    "fleet",
    "router",
    "AccessLog",
    "batcher",
    "buckets",
    "decode",
    "metrics",
    "pool",
    "server",
    "InferenceServer",
    "DecodeEngine",
    "sample_token",
    "fast_forward_rng",
    "DecodeSession",
    "GenerationStream",
    "MicroBatcher",
    "PredictorPool",
    "BucketLadder",
    "BatchPlan",
    "ServingStats",
    "snapshot_stats",
    "ServingError",
    "ServerOverloadedError",
    "DeadlineExceededError",
]
