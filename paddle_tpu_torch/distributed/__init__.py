"""Distributed host services (port of ``paddle_tpu/distributed``).

``elastic`` is the world-size contract (env vars, availability markers,
batch math); ``supervisor`` is the elastic layer under a launch
(heartbeat liveness, gang teardown, restart with resume), whose
heartbeat protocol and event log the serving fleet uses. The launcher
and the training guardian come with the training runtime."""

from . import elastic  # noqa: F401
from . import supervisor  # noqa: F401
