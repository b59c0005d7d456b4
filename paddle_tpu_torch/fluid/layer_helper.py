"""LayerHelper — the single funnel from layer functions into Block.append_op
(copy of ``paddle_tpu/fluid/layer_helper.py``; reference:
python/paddle/fluid/layer_helper.py:42; append_op feeds Block.append_op at
framework.py:2434). Under the dygraph guard it makes ``VarBase``s and
eager parameters, and ``Block.append_op`` traces each op at once.
"""

from . import unique_name
from .framework import (
    Variable,
    default_main_program,
    default_startup_program,
    in_dygraph_mode,
)
from .initializer import Constant, Xavier
from .param_attr import ParamAttr


class LayerHelper(object):
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = self.kwargs.get("name")
        if name is None:
            self.kwargs["name"] = unique_name.generate(layer_type)

    @property
    def name(self):
        return self.kwargs["name"]

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    def append_op(self, *args, **kwargs):
        return self.main_program.current_block().append_op(*args, **kwargs)

    # -- inputs --
    def multiple_input(self, input_param_name="input"):
        inputs = self.kwargs.get(input_param_name, [])
        if isinstance(inputs, Variable) or not isinstance(inputs,
                                                          (list, tuple)):
            return [inputs]
        return list(inputs)

    def input(self, input_param_name="input"):
        inputs = self.multiple_input(input_param_name)
        if len(inputs) != 1:
            raise ValueError("%s layer needs exactly one input" % self.layer_type)
        return inputs[0]

    @property
    def param_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("param_attr"))

    @property
    def bias_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("bias_attr"))

    def multiple_param_attr(self, length):
        attr = self.param_attr
        if isinstance(attr, ParamAttr):
            attr = [attr]
        if len(attr) != 1 and len(attr) != length:
            raise ValueError("parameter number mismatch")
        if len(attr) == 1 and length != 1:
            attr = [attr[0]] + [ParamAttr(**attr[0].__dict__) for _ in range(length - 1)]
        return attr

    def iter_inputs_and_params(self, input_param_name="input"):
        inputs = self.multiple_input(input_param_name)
        param_attrs = self.multiple_param_attr(len(inputs))
        for ipt, attr in zip(inputs, param_attrs):
            yield ipt, attr

    def input_dtype(self, input_param_name="input"):
        inputs = self.multiple_input(input_param_name)
        dtype = None
        for ipt in inputs:
            if dtype is None:
                dtype = ipt.dtype
            elif dtype != ipt.dtype:
                raise ValueError("all inputs must have the same dtype")
        return dtype

    # -- parameters --
    def create_parameter(
        self, attr, shape, dtype, is_bias=False, default_initializer=None
    ):
        if attr is False:
            return None
        attr = ParamAttr._to_attr(attr)
        if default_initializer is None:
            if is_bias:
                attr._set_default_bias_initializer()
            else:
                attr._set_default_param_initializer()
        else:
            attr._set_default_initializer(default_initializer)
        if attr.name is None:
            attr.name = unique_name.generate(".".join([self.name, "w" if not is_bias else "b"]))

        if in_dygraph_mode():
            from .dygraph import base as dy_base

            return dy_base._create_parameter_eager(
                attr, shape, dtype,
                attr.initializer or (Constant(0.0) if is_bias else Xavier()))
        startup_block = self.startup_program.global_block()
        main_block = self.main_program.global_block()
        param = main_block.create_parameter(
            shape=shape, dtype=dtype, **attr._to_kwargs(with_initializer=True)
        )
        initializer = attr.initializer or (Constant(0.0) if is_bias else Xavier())
        initializer(param, startup_block)
        return param

    def create_variable_for_type_inference(self, dtype, stop_gradient=False):
        if in_dygraph_mode():
            from .dygraph.tracer import VarBase

            return VarBase(
                name=unique_name.generate(".".join([self.name, "tmp"])),
                stop_gradient=stop_gradient)
        return self.main_program.current_block().create_var(
            name=unique_name.generate(".".join([self.name, "tmp"])),
            dtype=dtype,
            persistable=False,
            stop_gradient=stop_gradient,
        )

    create_tmp_variable = create_variable_for_type_inference

    def create_variable(self, *args, **kwargs):
        return self.main_program.current_block().create_var(*args, **kwargs)

    def create_global_variable(self, persistable=False, *args, **kwargs):
        kwargs.setdefault("stop_gradient", True)
        return self.main_program.global_block().create_var(
            *args, persistable=persistable, **kwargs
        )

    def create_or_get_global_variable(self, name, *args, **kwargs):
        block = self.main_program.global_block()
        if name in block.vars:
            return block.vars[name]
        return self.create_global_variable(name=name, *args, **kwargs)

    def set_variable_initializer(self, var, initializer):
        initializer(var, self.startup_program.global_block())

    # -- common epilogues --
    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        bias_attr = self.bias_attr
        if bias_attr is False or bias_attr is None and self.kwargs.get("bias_attr") is False:
            return input_var
        size = list(input_var.shape[dim_start:dim_end])
        if -1 in size:
            raise ValueError("cannot infer bias size from input shape")
        b = self.create_parameter(
            attr=bias_attr, shape=size, dtype=input_var.dtype, is_bias=True
        )
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op(
            type="elementwise_add",
            inputs={"X": [input_var], "Y": [b]},
            outputs={"Out": [tmp]},
            attrs={"axis": dim_start},
        )
        return tmp

    def append_activation(self, input_var):
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        act_type = act.pop("type")
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op(
            type=act_type,
            inputs={"X": [input_var]},
            outputs={"Out": [tmp]},
            attrs=act,
        )
        return tmp

    def is_instance(self, param_name, cls):
        param = self.kwargs.get(param_name)
        if not isinstance(param, cls):
            raise TypeError("%s must be %s" % (param_name, cls))

