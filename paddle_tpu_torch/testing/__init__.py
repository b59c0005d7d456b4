"""paddle_tpu_torch.testing (port of ``paddle_tpu/testing``) —
deterministic fault injection (chaos): flag/env-driven injection points
plus an in-process ``FaultPlan`` API. The gateway's SSE writer calls
``chaos.on_stream_token``."""

from .chaos import (  # noqa: F401
    FaultPlan,
    active_plan,
    clear,
    install,
)

__all__ = ["FaultPlan", "install", "clear", "active_plan"]
