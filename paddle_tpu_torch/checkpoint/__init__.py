"""paddle_tpu_torch.checkpoint (port of ``paddle_tpu/checkpoint``): so
far the preemption latch and handler of ``preempt.py``, which the
serving front's readiness and drain read. The checkpoint manager comes
with the training runtime."""

from .preempt import (  # noqa: F401
    PreemptionHandler,
    preemption_requested,
    request_preemption,
)

__all__ = [
    "PreemptionHandler",
    "preemption_requested",
    "request_preemption",
]
