"""paddle_tpu_torch.checkpoint — fault-tolerant async checkpointing and
resume (port of ``paddle_tpu/checkpoint``).

Step-tagged checkpoint directories with a two-phase atomic commit (stage
under ``tmp.step_<N>/``, fsync, ``os.replace`` to ``step_<N>/``: a torn
directory is never discoverable), a background writer thread that keeps
serialization and disk I/O off the step's critical path, per-rank
sharded save and N->M restore, retention, and SIGTERM preemption
handling with one final synchronous save. ``modeldir`` publishes
exported model versions for serving.

Quickstart::

    from paddle_tpu_torch import checkpoint

    mgr = checkpoint.CheckpointManager("ckpts", keep_max=3)
    start = mgr.restore_or_initialize(main, exe, startup_program=startup)
    for step in range(start + 1, num_steps):
        exe.run(main, feed=batch(step), fetch_list=[loss])
        if step % 50 == 0:
            mgr.save(step, main)          # async: returns after snapshot
    mgr.save(num_steps - 1, main, async_=False)
    mgr.close()
"""

from . import modeldir  # noqa: F401
from .manager import (  # noqa: F401
    CheckpointError,
    CheckpointManager,
    ChecksumError,
    latest_step,
    list_steps,
)
from .preempt import (  # noqa: F401
    PreemptionHandler,
    preemption_requested,
    request_preemption,
)

__all__ = [
    "modeldir",
    "CheckpointManager",
    "CheckpointError",
    "ChecksumError",
    "PreemptionHandler",
    "preemption_requested",
    "request_preemption",
    "latest_step",
    "list_steps",
]
