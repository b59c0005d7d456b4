"""Fleet distributed-training facade (port of
``paddle_tpu/fluid/incubate/fleet``; reference:
python/paddle/fluid/incubate/fleet/). The collective mode is here; the
parameter-server mode comes with ROADMAP A12c."""

from . import base  # noqa: F401
from . import collective  # noqa: F401
