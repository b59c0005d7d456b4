"""Metric layers (port of ``paddle_tpu/fluid/layers/metric_op.py``)."""

from .. import core
from ..layer_helper import LayerHelper
from .nn import topk

__all__ = ["accuracy", "auc"]


def accuracy(input, label, k=1, correct=None, total=None):
    """Top-``k`` accuracy of ``input`` [N, classes] against ``label``
    [N, 1] (``metric_op.py:12``): a ``top_k`` op, then the ``accuracy``
    op; returns the float32 [1] accuracy (no gradient). ``correct`` and
    ``total`` may name the int32 [1] variables its counts go to."""
    helper = LayerHelper("accuracy")
    topk_out, topk_indices = topk(input, k=k)
    acc_out = helper.create_variable_for_type_inference(dtype="float32")
    if correct is None:
        correct = helper.create_variable_for_type_inference(
            dtype=core.VarDesc.VarType.INT32)
    if total is None:
        total = helper.create_variable_for_type_inference(
            dtype=core.VarDesc.VarType.INT32)
    helper.append_op(
        type="accuracy",
        inputs={"Out": [topk_out], "Indices": [topk_indices],
                "Label": [label]},
        outputs={"Accuracy": [acc_out], "Correct": [correct],
                 "Total": [total]},
    )
    acc_out.stop_gradient = True
    return acc_out


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,
        slide_steps=1):
    """Streaming AUC over the stateful ``auc`` op (``metric_op.py:34``),
    built by ``extended.auc``."""
    from .extended import auc as _auc

    return _auc(input, label, curve=curve, num_thresholds=num_thresholds,
                topk=topk, slide_steps=slide_steps)
