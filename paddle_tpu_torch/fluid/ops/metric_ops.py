"""Metric ops (port of ``accuracy`` in
``paddle_tpu/fluid/ops/metric_ops.py``): the plain function on tensors and
its registered lowering. No gradient, as in the reference."""

import torch

from .. import core
from .registry import SkipInferShape, in_var, op, set_out

__all__ = ["accuracy"]


def accuracy(indices, label):
    """The ``accuracy`` op (``metric_ops.py:12``) from the top-k
    ``indices`` [N, k] and the ``label`` [N, 1] (or [N]): a row is
    correct when any of its k indices is its label. Returns (Accuracy
    float32 [1], Correct int32 [1], Total int32 [1])."""
    lab = label if label.dim() == indices.dim() else label.unsqueeze(-1)
    correct = (indices == lab).any(-1)
    num = correct.sum(dtype=torch.int32).reshape((1,))
    total = correct.numel()
    acc = num.to(torch.float32) / float(total)
    return acc, num, torch.full((1,), total, dtype=torch.int32,
                                device=indices.device)


def _accuracy_infer(op_, block):
    if in_var(op_, block, "Indices") is None:
        raise SkipInferShape()
    set_out(op_, block, "Accuracy", (1,), core.VarDesc.VarType.FP32)
    set_out(op_, block, "Correct", (1,), core.VarDesc.VarType.INT32)
    set_out(op_, block, "Total", (1,), core.VarDesc.VarType.INT32)


@op("accuracy", infer_shape=_accuracy_infer)
def _accuracy(ctx, op_):
    acc, num, total = accuracy(ctx.in1(op_, "Indices"),
                               ctx.in1(op_, "Label"))
    ctx.out(op_, "Accuracy", acc)
    ctx.out(op_, "Correct", num)
    ctx.out(op_, "Total", total)
