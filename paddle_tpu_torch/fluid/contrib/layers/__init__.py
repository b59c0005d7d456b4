"""Contrib layers (port of the part of
``paddle_tpu/fluid/contrib/layers/`` the recurrent models use: the
multi-layer GRU/LSTM builders of ``rnn_impl``)."""

from . import rnn_impl  # noqa: F401
from .rnn_impl import (  # noqa: F401
    BasicGRUUnit,
    BasicLSTMUnit,
    basic_gru,
    basic_lstm,
)
