"""Contrib (port of the part of ``paddle_tpu/fluid/contrib/`` the port
needs: automatic mixed precision; reference: python/paddle/fluid/contrib/)."""

from . import mixed_precision  # noqa: F401
from .mixed_precision import decorate  # noqa: F401
