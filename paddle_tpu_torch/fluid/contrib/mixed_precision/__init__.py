"""Automatic mixed precision (port of
``paddle_tpu/fluid/contrib/mixed_precision/``; reference:
python/paddle/fluid/contrib/mixed_precision/)."""

from .decorator import decorate, OptimizerWithMixedPrecision  # noqa: F401
from .fp16_lists import AutoMixedPrecisionLists  # noqa: F401
from . import fp16_utils  # noqa: F401
