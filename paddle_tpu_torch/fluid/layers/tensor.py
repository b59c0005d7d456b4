"""Tensor-creation layers the GPT train program uses (port of the
matching functions of ``paddle_tpu/fluid/layers/tensor.py``)."""

import numpy as np

from .. import core
from ..framework import Variable
from ..layer_helper import LayerHelper

__all__ = ["create_parameter", "create_global_var", "cast", "concat",
           "sums", "assign", "fill_constant",
           "fill_constant_batch_size_like", "isfinite"]


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
