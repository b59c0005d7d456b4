"""Operator overloading on ``Variable`` (copy of
``paddle_tpu/fluid/layers/math_op_patch.py``): ``+ - * / ** % //``,
unary ``-`` and the compares append the ops the reference appends. A
Python scalar operand becomes a ``scale`` op where one can express it,
else a ``fill_constant`` [1] in the variable's dtype and the
``elementwise_*`` op. Applied when ``fluid.layers`` is imported."""

import numpy as np

from .. import core
from ..framework import Variable
from ..layer_helper import LayerHelper


def _create_scalar_op(var, scale=1.0, bias=0.0, bias_after_scale=True):
    helper = LayerHelper("scale")
    out = helper.create_variable_for_type_inference(dtype=var.dtype)
    helper.append_op(
        type="scale", inputs={"X": [var]}, outputs={"Out": [out]},
        attrs={"scale": float(scale), "bias": float(bias),
               "bias_after_scale": bias_after_scale})
    return out


def _scalar_to_var(value, ref_var):
    from .tensor import fill_constant

    return fill_constant(shape=[1], dtype=ref_var.dtype, value=float(value))


def _binary(op_type, x, y, axis=-1, reverse=False):
    if np.isscalar(y):
        if op_type == "elementwise_add":
            return _create_scalar_op(x, 1.0, float(y))
        if op_type == "elementwise_sub":
            if reverse:
                return _create_scalar_op(x, -1.0, float(y))
            return _create_scalar_op(x, 1.0, -float(y))
        if op_type == "elementwise_mul":
            return _create_scalar_op(x, float(y), 0.0)
        if op_type == "elementwise_div" and not reverse:
            return _create_scalar_op(x, 1.0 / float(y), 0.0)
        y = _scalar_to_var(y, x)
    if reverse:
        x, y = y, x
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        type=op_type, inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]},
        attrs={"axis": axis})
    return out


def _compare(op_type, x, y):
    if np.isscalar(y):
        y = _scalar_to_var(y, x)
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(
        dtype=core.VarDesc.VarType.BOOL)
    out.stop_gradient = True
    helper.append_op(
        type=op_type, inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]})
    return out


def monkey_patch_variable():
    Variable.__add__ = lambda s, o: _binary("elementwise_add", s, o)
    Variable.__radd__ = lambda s, o: _binary("elementwise_add", s, o)
    Variable.__sub__ = lambda s, o: _binary("elementwise_sub", s, o)
    Variable.__rsub__ = lambda s, o: _binary("elementwise_sub", s, o,
                                             reverse=True)
    Variable.__mul__ = lambda s, o: _binary("elementwise_mul", s, o)
    Variable.__rmul__ = lambda s, o: _binary("elementwise_mul", s, o)
    Variable.__truediv__ = lambda s, o: _binary("elementwise_div", s, o)
    Variable.__rtruediv__ = lambda s, o: _binary("elementwise_div", s, o,
                                                 reverse=True)
    Variable.__div__ = Variable.__truediv__
    Variable.__pow__ = lambda s, o: _binary("elementwise_pow", s, o)
    Variable.__rpow__ = lambda s, o: _binary("elementwise_pow", s, o,
                                             reverse=True)
    Variable.__mod__ = lambda s, o: _binary("elementwise_mod", s, o)
    Variable.__floordiv__ = lambda s, o: _binary("elementwise_floordiv", s, o)
    Variable.__neg__ = lambda s: _create_scalar_op(s, -1.0, 0.0)
    Variable.__eq__ = lambda s, o: (
        _compare("equal", s, o) if isinstance(o, (Variable, int, float))
        else NotImplemented)
    Variable.__ne__ = lambda s, o: (
        _compare("not_equal", s, o) if isinstance(o, (Variable, int, float))
        else NotImplemented)
    Variable.__lt__ = lambda s, o: _compare("less_than", s, o)
    Variable.__le__ = lambda s, o: _compare("less_equal", s, o)
    Variable.__gt__ = lambda s, o: _compare("greater_than", s, o)
    Variable.__ge__ = lambda s, o: _compare("greater_equal", s, o)
    Variable.__hash__ = lambda s: id(s)


monkey_patch_variable()
