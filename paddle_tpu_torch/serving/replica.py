"""One serving replica: the process the FleetController spawns (port of
``paddle_tpu/serving/replica.py``).

``python -m paddle_tpu_torch.serving.replica --model-dir D
--endpoint-file F`` builds the full single-process serving stack over a
saved inference model — AnalysisPredictor -> InferenceServer
(micro-batcher + bucket ladder, warmed) -> Gateway (HTTP front door) —
then reports its ephemeral ports back to the controller through an
atomically written *endpoint file* and heartbeats through the
supervisor's worker protocol (``PADDLE_TPU_HEARTBEAT_FILE``) until a
SIGTERM drains it.

Contract with the controller:

- warmup happens BEFORE the gateway starts listening, so the first
  ``/readyz`` 200 already implies a warmed bucket ladder and built
  kernels (and, under ``FLAGS_serving_strict_compiles``, an armed build
  gate) — the controller can shift rollout traffic on readiness alone;
- ``warmup.npz`` beside the model (one array per feed, ``arr_0..``
  order) provides the warmup example; without it the replica serves
  unwarmed (strict mode would then fail its first request by design);
- every ``/v1/infer`` response carries ``X-Replica-Id`` and
  ``X-Model-Version`` headers (the router relays them), so rollout
  audits can attribute each answer to the replica and version that
  produced it;
- SIGTERM (the controller's drain) rides the gateway's graceful path:
  ``/readyz`` flips 503, every in-flight request completes, the
  listener closes, the process exits 0. Only a crash exits nonzero.

The replica runs on the card (``--device cuda``, the default) and raises
without one; ``--device cpu`` runs the plain path on the CPU.

``/v1/generate`` needs a ``DecodeEngine``: pass ``--gpt-decode '<json
spec>'`` and the replica builds a GPT decode engine beside the
predictor — the spec carries ``GPTConfig.tiny`` overrides plus
``{"seed", "max_len", "slots", "prefill_buckets"}``, and the parameters
come from ``gpt.init_fluid_params(cfg, seed)`` (numpy from the seed), so
every replica spawned with the same spec holds bit-identical weights
(the property that makes a mid-stream failover token-exact: the resumed
replica's logits equal the dead one's). Engine knobs
(``FLAGS_decode_block_size``, ``FLAGS_decode_prefix_cache_mb``,
``FLAGS_kv_tier_host_mb``, ...) ride the environment like everything
else. ``--role`` sets the fleet KV-tier role the gateway advertises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

__all__ = ["build_gpt_decode_engine", "main"]


def _write_endpoint(path, payload):
    """Atomic tmp+replace (the shared ``modeldir.commit_json``
    discipline): the controller must never read a torn file."""
    from ..checkpoint import modeldir as _modeldir

    _modeldir.commit_json(path, payload)


def _load_warmup(model_dir, warmup_path):
    import numpy as np

    path = warmup_path or os.path.join(model_dir, "warmup.npz")
    if not os.path.isfile(path):
        return None
    with np.load(path) as f:
        return [f["arr_%d" % i] for i in range(len(f.files))]


def build_gpt_decode_engine(spec, device="cuda"):
    """A ``DecodeEngine`` on ``device`` from a ``--gpt-decode`` spec dict:
    ``GPTConfig.tiny`` overrides plus ``seed`` (the parameters are
    ``gpt.init_fluid_params(cfg, seed)``, bit-identical in every process
    given the same spec, the replica-interchangeability contract failover
    rests on), ``max_len``, ``slots`` and ``prefill_buckets``. Shared
    with the probes, which build their oracle engines from the same
    spec."""
    from ..models import gpt as _gpt
    from .decode import DecodeEngine

    spec = dict(spec)
    seed = int(spec.pop("seed", 0))
    max_len = int(spec.pop("max_len", 64))
    slots = int(spec.pop("slots", 8))
    buckets = spec.pop("prefill_buckets", None)
    spec.setdefault("hidden_dropout", 0.0)
    spec.setdefault("attention_dropout", 0.0)
    cfg = _gpt.GPTConfig.tiny(**spec)
    cfg.max_position_embeddings = max_len
    model = _gpt.GPTLM(cfg, device=device)
    _gpt.load_fluid_params(model, _gpt.init_fluid_params(cfg, seed))
    return DecodeEngine(model, slots=slots, max_len=max_len,
                        prefill_buckets=buckets)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model-dir", required=True,
                    help="saved inference model (save_inference_model)")
    ap.add_argument("--endpoint-file", required=True,
                    help="where to report the bound ports (atomic JSON)")
    ap.add_argument("--replica-id", default="0")
    ap.add_argument("--version", type=int, default=0,
                    help="model version tag (rollout audit header)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--warmup-npz", default="",
                    help="override the warmup example "
                         "(default: <model-dir>/warmup.npz)")
    ap.add_argument("--gpt-decode", default="",
                    help="JSON spec: attach a seeded GPT DecodeEngine "
                         "so this replica serves /v1/generate "
                         "(see build_gpt_decode_engine)")
    ap.add_argument("--role", default="mixed",
                    choices=("prefill", "decode", "mixed"),
                    help="fleet KV-tier role: prefill replicas compute "
                         "+ publish chain blocks over /v1/kv/prefill; "
                         "decode replicas own slots and pull published "
                         "blocks on admission miss; mixed does both")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model runs (no fallback: cuda "
                         "raises without a card)")
    args = ap.parse_args(argv)

    # heavy imports after argparse: --help must not pay for torch
    from .. import inference, serving
    from ..distributed import supervisor as _supervisor
    from ..fluid import flags as _flags
    from ..fluid.core import resolve_device
    from ..observability import exporter as _obs_exporter
    from ..observability import trace as _trace

    resolve_device(args.device)  # no card and no --device cpu: raise
    config = inference.AnalysisConfig(args.model_dir)
    if args.device == "cpu":
        config.disable_gpu()
    pred = inference.create_paddle_predictor(config)
    engine = None
    if args.gpt_decode:
        engine = build_gpt_decode_engine(json.loads(args.gpt_decode),
                                         device=args.device)
    warmup = _load_warmup(args.model_dir, args.warmup_npz)
    server = serving.InferenceServer(
        pred, decode_engine=engine
    ).start(warmup_inputs=warmup)
    gw = serving.Gateway(
        server, port=0, host=args.host, role=args.role,
        extra_headers={
            "X-Replica-Id": str(args.replica_id),
            "X-Model-Version": str(args.version),
        },
    ).start()
    gw.install_sigterm()

    exp = _obs_exporter.global_exporter()
    # the clock-anchor pair (ts wall / ts_mono span clock) rides the
    # endpoint file so the controller can align this replica's trace
    # timeline even before (or without) pulling its /healthz
    anchor = _trace.clock_anchor()
    endpoint = {
        "pid": os.getpid(),
        "replica_id": str(args.replica_id),
        "version": int(args.version),
        "model_dir": args.model_dir,
        "gateway_port": gw.port,
        "metrics_port": exp.port if exp is not None else None,
        "role": args.role,
        "warmed": warmup is not None,
        "ts": anchor["ts"],
        "ts_mono": anchor["ts_mono"],
        "lease_ts": time.time(),
    }
    _write_endpoint(args.endpoint_file, endpoint)

    lease_interval = float(_flags.get_flag("fleet_lease_interval_s"))
    hb = _supervisor.worker_heartbeat()
    step = 0
    last_lease = time.time()
    try:
        # serve until the gateway's drain closes the listener (SIGTERM
        # -> /readyz 503 -> in-flight completes -> port is None)
        while gw.port is not None:
            if hb is not None:
                hb.beat(step, status="serve")
            # re-stamp the endpoint lease: proof this loop is turning,
            # which outlives the controller (adoption trusts the stamp
            # before any controller is back to probe us)
            if lease_interval > 0 and \
                    time.time() - last_lease >= lease_interval:
                endpoint["lease_ts"] = last_lease = time.time()
                try:
                    _write_endpoint(args.endpoint_file, endpoint)
                except OSError:
                    pass
            step += 1
            time.sleep(0.2)
    finally:
        gw.stop()
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
