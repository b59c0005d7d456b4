"""Distributed launch and host services (port of
``paddle_tpu/distributed``; reference: python/paddle/distributed/).

``launch`` keeps the reference CLI over ``supervisor``, the elastic layer
under it (heartbeat liveness, gang teardown, restart with resume), whose
heartbeat protocol and event log the serving fleet uses too;
``elastic`` is the world-size contract (env vars, availability markers,
batch math); ``guardian`` is the training guardian."""

from . import elastic  # noqa: F401
from . import supervisor  # noqa: F401
from . import guardian  # noqa: F401
from . import launch  # noqa: F401
