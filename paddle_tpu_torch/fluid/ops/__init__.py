"""Op lowerings of the serving and training slices as plain functions on
tensors."""

from . import math_ops, nn_ops, optimizer_ops

__all__ = ["math_ops", "nn_ops", "optimizer_ops"]
