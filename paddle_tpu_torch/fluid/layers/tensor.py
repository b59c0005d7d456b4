"""Tensor-creation layers (port of
``paddle_tpu/fluid/layers/tensor.py``)."""

import numpy as np

from .. import core
from ..framework import Variable
from ..layer_helper import LayerHelper

__all__ = ["create_tensor", "create_parameter", "create_global_var",
           "cast", "concat", "sums", "assign", "fill_constant",
           "fill_constant_batch_size_like", "ones", "zeros", "ones_like",
           "zeros_like", "reverse", "has_inf", "has_nan", "isfinite",
           "range", "linspace", "argmin", "argmax", "argsort", "diag"]


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name)
    return helper.create_variable(name=helper.name, dtype=dtype,
                                  persistable=persistable)


def create_parameter(
    shape, dtype, name=None, attr=None, is_bias=False, default_initializer=None
):
    helper = LayerHelper("create_parameter", name=name)
    from ..param_attr import ParamAttr

    attr = attr or ParamAttr(name=name)
    return helper.create_parameter(attr, shape, dtype, is_bias, default_initializer)


def create_global_var(
    shape, value, dtype, persistable=False, force_cpu=False, name=None
):
    helper = LayerHelper("global_var", name=name)
    var = helper.create_global_variable(
        dtype=dtype, shape=shape, persistable=persistable, name=name
    )
    from ..initializer import Constant

    helper.set_variable_initializer(var, Constant(value=float(value)))
    return var


def cast(x, dtype):
    helper = LayerHelper("cast")
    if not isinstance(dtype, int):
        dtype = core.np_to_dtype(dtype)
    out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(
        type="cast",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"in_dtype": x.dtype, "out_dtype": dtype},
    )
    return out


def sums(input, out=None):
    helper = LayerHelper("sum")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=helper.input_dtype())
    helper.append_op(type="sum", inputs={"X": input}, outputs={"Out": [out]})
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", input=input, name=name)
    out = helper.create_variable_for_type_inference(
        dtype=helper.input_dtype())
    helper.append_op(type="concat", inputs={"X": input},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def assign(input, output=None):
    helper = LayerHelper("assign")
    if isinstance(input, Variable):
        if output is None:
            output = helper.create_variable_for_type_inference(dtype=input.dtype)
        helper.append_op(
            type="assign", inputs={"X": [input]}, outputs={"Out": [output]}
        )
    elif isinstance(input, np.ndarray):
        if output is None:
            output = helper.create_variable_for_type_inference(
                dtype=core.np_to_dtype(input.dtype)
            )
        helper.append_op(
            type="assign_value",
            outputs={"Out": [output]},
            attrs={
                "shape": list(input.shape),
                "dtype": core.np_to_dtype(input.dtype),
                "values": input,
            },
        )
    else:
        raise TypeError("assign expects Variable or numpy array")
    return output


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant")
    if not isinstance(dtype, int):
        dtype = core.np_to_dtype(dtype)
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(
        type="fill_constant",
        outputs={"Out": [out]},
        attrs={
            "shape": list(shape),
            "dtype": dtype,
            "value": float(value),
            "force_cpu": force_cpu,
        },
    )
    out.stop_gradient = True
    return out


def isfinite(x):
    """One bool [1]: every element of ``x`` finite."""
    helper = LayerHelper("isfinite")
    out = helper.create_variable_for_type_inference(
        dtype=core.VarDesc.VarType.BOOL)
    helper.append_op(type="isfinite", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    helper = LayerHelper("fill_constant_batch_size_like")
    if not isinstance(dtype, int):
        dtype = core.np_to_dtype(dtype)
    out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(
        type="fill_constant_batch_size_like",
        inputs={"Input": [input]},
        outputs={"Out": [out]},
        attrs={"shape": list(shape), "dtype": dtype, "value": float(value),
               "input_dim_idx": input_dim_idx,
               "output_dim_idx": output_dim_idx},
    )
    out.stop_gradient = True
    return out


def ones(shape, dtype, force_cpu=False):
    return fill_constant(shape=shape, dtype=dtype, value=1.0,
                         force_cpu=force_cpu)


def zeros(shape, dtype, force_cpu=False):
    return fill_constant(shape=shape, dtype=dtype, value=0.0,
                         force_cpu=force_cpu)


def ones_like(x, out=None):
    helper = LayerHelper("ones_like")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="fill_any_like", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"value": 1.0, "dtype": -1})
    return out


def zeros_like(x, out=None):
    helper = LayerHelper("zeros_like")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="fill_zeros_like", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out


def reverse(x, axis):
    helper = LayerHelper("reverse")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        type="reverse", inputs={"X": [x]}, outputs={"Out": [out]},
        attrs={"axis": axis if isinstance(axis, (list, tuple)) else [axis]})
    return out


def has_inf(x):
    helper = LayerHelper("isinf")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="isinf", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def has_nan(x):
    helper = LayerHelper("isnan")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="isnan", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def range(start, end, step, dtype):
    """[start, end) by step; a number becomes a ``fill_constant`` [1]."""
    helper = LayerHelper("range")
    if not isinstance(start, Variable):
        start = fill_constant([1], dtype, start)
    if not isinstance(end, Variable):
        end = fill_constant([1], dtype, end)
    if not isinstance(step, Variable):
        step = fill_constant([1], dtype, step)
    out = helper.create_variable_for_type_inference(dtype=start.dtype)
    helper.append_op(type="range",
                     inputs={"Start": [start], "End": [end], "Step": [step]},
                     outputs={"Out": [out]})
    return out


def linspace(start, stop, num, dtype):
    helper = LayerHelper("linspace")
    if not isinstance(start, Variable):
        start = fill_constant([1], dtype, start)
    if not isinstance(stop, Variable):
        stop = fill_constant([1], dtype, stop)
    if not isinstance(num, Variable):
        num = fill_constant([1], "int32", num)
    out = helper.create_variable_for_type_inference(dtype=start.dtype)
    helper.append_op(type="linspace",
                     inputs={"Start": [start], "Stop": [stop], "Num": [num]},
                     outputs={"Out": [out]})
    return out


def argmin(x, axis=0):
    helper = LayerHelper("arg_min")
    out = helper.create_variable_for_type_inference(
        core.VarDesc.VarType.INT64)
    helper.append_op(type="arg_min", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def argmax(x, axis=0):
    helper = LayerHelper("arg_max")
    out = helper.create_variable_for_type_inference(
        core.VarDesc.VarType.INT64)
    helper.append_op(type="arg_max", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def argsort(x, axis=-1, name=None):
    helper = LayerHelper("argsort", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    ids = helper.create_variable_for_type_inference(
        core.VarDesc.VarType.INT64)
    helper.append_op(type="argsort", inputs={"X": [x]},
                     outputs={"Out": [out], "Indices": [ids]},
                     attrs={"axis": axis})
    return out, ids


def diag(diagonal):
    helper = LayerHelper("diag")
    out = helper.create_variable_for_type_inference(diagonal.dtype)
    helper.append_op(type="diag", inputs={"Diagonal": [diagonal]},
                     outputs={"Out": [out]})
    return out
