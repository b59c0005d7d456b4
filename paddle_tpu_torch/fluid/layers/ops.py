"""Unary layers of the reference's generated table
(``paddle_tpu/fluid/layers/ops.py``): each appends its op with ``X`` in
and ``Out`` out, in X's dtype; ``softshrink``, ``hard_shrink`` and
``thresholded_relu`` take their one attr by keyword."""

from ..layer_helper import LayerHelper

_UNARY_OPS = ["sigmoid", "logsigmoid", "exp", "tanh", "tanh_shrink",
              "softplus", "softsign", "sqrt", "rsqrt", "abs", "ceil",
              "floor", "cos", "sin", "acos", "asin", "atan", "round",
              "reciprocal", "square", "log", "erf"]

__all__ = list(_UNARY_OPS) + ["softshrink", "hard_shrink", "cumsum",
                              "thresholded_relu", "gelu"]


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


def _make_unary_attr(op_type, attr_name, default):
    def layer(x, **kwargs):
        helper = LayerHelper(op_type, name=kwargs.get("name"))
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
        helper.append_op(type=op_type, inputs={"X": [x]},
                         outputs={"Out": [out]},
                         attrs={attr_name: kwargs.get(attr_name, default)})
        return out

    layer.__name__ = op_type
    return layer


softshrink = _make_unary_attr("softshrink", "lambda", 0.5)
hard_shrink = _make_unary_attr("hard_shrink", "threshold", 0.5)
thresholded_relu = _make_unary_attr("thresholded_relu", "threshold", 1.0)


def gelu(x, approximate=False, name=None):
    helper = LayerHelper("gelu", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="gelu", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"approximate": approximate})
    return out


def cumsum(x, axis=None, exclusive=None, reverse=None, name=None):
    helper = LayerHelper("cumsum", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    attrs = {}
    if axis is not None:
        attrs["axis"] = axis
    if exclusive is not None:
        attrs["exclusive"] = exclusive
    if reverse is not None:
        attrs["reverse"] = reverse
    helper.append_op(type="cumsum", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs=attrs)
    return out
