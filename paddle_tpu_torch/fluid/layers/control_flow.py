"""Comparison layers (port of ``greater_equal`` of
``paddle_tpu/fluid/layers/control_flow.py``, the one the AMP loss scaler
builds): it appends its compare op and returns a bool variable that
takes no gradient. The other compares and the sub-block layers
(``While``, ``Switch``, ``IfElse``) are not ported."""

from .. import core
from ..layer_helper import LayerHelper

__all__ = ["greater_equal"]


def _compare(op_type, x, y, cond=None):
    helper = LayerHelper(op_type)
    if cond is None:
        cond = helper.create_variable_for_type_inference(
            dtype=core.VarDesc.VarType.BOOL)
        cond.stop_gradient = True
    helper.append_op(
        type=op_type, inputs={"X": [x], "Y": [y]}, outputs={"Out": [cond]})
    return cond


def greater_equal(x, y, cond=None):
    return _compare("greater_equal", x, y, cond)
