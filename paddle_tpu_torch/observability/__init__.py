"""paddle_tpu_torch.observability (port of ``paddle_tpu/observability``):

- ``trace``         — thread-safe span tracer, W3C trace context, Chrome
  trace export
- ``registry``      — Prometheus text and JSONL snapshots over the
  always-on counters, histograms and gauges
- ``exporter``      — stdlib HTTP ``/metrics`` ``/healthz`` ``/trace``
  ``/compiles`` + per-rank snapshot files, armed by ``FLAGS_obs_*``
- ``flight``        — per-request flight recorder, dumped on drain/error
- ``compile_stats`` — build telemetry and the strict steady-state gate
  (the counterpart of the reference's ``xla_stats``)
"""

from . import compile_stats, exporter, flight, registry, trace

__all__ = ["trace", "registry", "exporter", "flight", "compile_stats"]
