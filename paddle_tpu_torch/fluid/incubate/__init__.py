"""Incubating APIs (port of ``paddle_tpu/fluid/incubate``; reference:
python/paddle/fluid/incubate/): fleet's collective mode."""

from . import fleet  # noqa: F401
