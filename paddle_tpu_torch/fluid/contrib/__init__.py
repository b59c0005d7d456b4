"""Contrib (port of the part of ``paddle_tpu/fluid/contrib/`` the port
needs: automatic mixed precision and the multi-layer RNN builders;
reference: python/paddle/fluid/contrib/)."""

from . import layers, mixed_precision  # noqa: F401
from .mixed_precision import decorate  # noqa: F401
from .layers.rnn_impl import (  # noqa: F401
    BasicGRUUnit,
    BasicLSTMUnit,
    basic_gru,
    basic_lstm,
)
