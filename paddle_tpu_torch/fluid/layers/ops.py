"""Unary layers of the reference's generated table
(``paddle_tpu/fluid/layers/ops.py``), those whose ops the port
registers: each appends its op with ``X`` in and ``Out`` out, in X's
dtype."""

from ..layer_helper import LayerHelper

_UNARY_OPS = ["exp", "tanh", "sqrt", "ceil", "floor", "cos"]

__all__ = list(_UNARY_OPS)


def _make_unary(op_type):
    def layer(x, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
        helper.append_op(type=op_type, inputs={"X": [x]},
                         outputs={"Out": [out]})
        return out

    layer.__name__ = op_type
    layer.__doc__ = "Elementwise %s." % op_type
    return layer


for _op_type in _UNARY_OPS:
    globals()[_op_type] = _make_unary(_op_type)
