"""Op lowerings: plain functions on tensors, and the registered rules the
Executor runs (importing the modules registers them)."""

from . import registry  # noqa: F401  (first: the others register into it)
from . import (collective_ops, controlflow_ops, io_ops, loss_ops,
               manip_ops, math_ops, metric_ops, misc_ops, nn_ops,
               optimizer_ops, rnn_fused_ops, rnn_ops, sequence_ops,
               tensor_ops)

__all__ = ["registry", "collective_ops", "controlflow_ops", "io_ops",
           "loss_ops", "manip_ops", "math_ops", "metric_ops", "misc_ops",
           "nn_ops", "optimizer_ops", "rnn_fused_ops", "rnn_ops",
           "sequence_ops", "tensor_ops"]
