"""The fused recurrent layers ``dynamic_lstm``, ``dynamic_lstmp``,
``dynamic_gru``, ``gru_unit`` and ``lstm_unit`` (copy of
``paddle_tpu/fluid/layers/extended.py:94-260``; reference
python/paddle/fluid/layers/nn.py dynamic_lstm:443). Each appends its op
with the reference's slots and attrs; the input is the projected
[B, T, 4D] (or 3D) pre-activation a preceding ``fc`` makes, padded, with
its lengths in the ``@SEQ_LEN`` companion."""

from ..layer_helper import LayerHelper

__all__ = ["dynamic_lstm", "dynamic_lstmp", "dynamic_gru", "gru_unit",
           "lstm_unit"]


def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=True, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None):
    """reference: layers/nn.py dynamic_lstm:443 — input is the projected
    [B, T, 4D] pre-activation (x @ Wx done by a preceding fc)."""
    helper = LayerHelper("dynamic_lstm", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    D = size // 4
    weight = helper.create_parameter(
        attr=helper.param_attr, shape=[D, 4 * D], dtype=dtype
    )
    bias_size = [1, 7 * D] if use_peepholes else [1, 4 * D]
    bias = helper.create_parameter(
        attr=helper.bias_attr, shape=bias_size, dtype=dtype, is_bias=True
    )
    hidden = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    batch_gate = helper.create_variable_for_type_inference(dtype)
    batch_cell_pre_act = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": [input], "Weight": [weight], "Bias": [bias]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    if c_0 is not None:
        inputs["C0"] = [c_0]
    helper.append_op(
        type="lstm",
        inputs=inputs,
        outputs={
            "Hidden": [hidden],
            "Cell": [cell],
            "BatchGate": [batch_gate],
            "BatchCellPreAct": [batch_cell_pre_act],
        },
        attrs={
            "use_peepholes": use_peepholes,
            "is_reverse": is_reverse,
            "gate_activation": gate_activation,
            "cell_activation": cell_activation,
            "candidate_activation": candidate_activation,
        },
    )
    return hidden, cell


def dynamic_lstmp(input, size, proj_size, h_0=None, c_0=None,
                  param_attr=None, bias_attr=None, use_peepholes=True,
                  is_reverse=False, gate_activation="sigmoid",
                  cell_activation="tanh", candidate_activation="tanh",
                  proj_activation="tanh", dtype="float32", name=None):
    helper = LayerHelper("dynamic_lstmp", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    D = size // 4
    weight = helper.create_parameter(
        attr=helper.param_attr, shape=[proj_size, 4 * D], dtype=dtype
    )
    proj_weight = helper.create_parameter(
        attr=None, shape=[D, proj_size], dtype=dtype
    )
    bias_size = [1, 7 * D] if use_peepholes else [1, 4 * D]
    bias = helper.create_parameter(
        attr=helper.bias_attr, shape=bias_size, dtype=dtype, is_bias=True
    )
    projection = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    inputs = {
        "Input": [input], "Weight": [weight], "ProjWeight": [proj_weight],
        "Bias": [bias],
    }
    if h_0 is not None:
        inputs["H0"] = [h_0]
    if c_0 is not None:
        inputs["C0"] = [c_0]
    helper.append_op(
        type="lstmp",
        inputs=inputs,
        outputs={"Projection": [projection], "Cell": [cell]},
        attrs={
            "use_peepholes": use_peepholes,
            "is_reverse": is_reverse,
            "gate_activation": gate_activation,
            "cell_activation": cell_activation,
            "candidate_activation": candidate_activation,
            "proj_activation": proj_activation,
        },
    )
    return projection, cell


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", h_0=None, origin_mode=False):
    helper = LayerHelper("dynamic_gru", input=input, param_attr=param_attr,
                         bias_attr=bias_attr)
    dtype = helper.input_dtype()
    weight = helper.create_parameter(
        attr=helper.param_attr, shape=[size, 3 * size], dtype=dtype
    )
    bias = helper.create_parameter(
        attr=helper.bias_attr, shape=[1, 3 * size], dtype=dtype,
        is_bias=True,
    )
    hidden = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": [input], "Weight": [weight], "Bias": [bias]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    helper.append_op(
        type="gru",
        inputs=inputs,
        outputs={"Hidden": [hidden]},
        attrs={
            "is_reverse": is_reverse,
            "gate_activation": gate_activation,
            "activation": candidate_activation,
            "origin_mode": origin_mode,
        },
    )
    return hidden


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid",
             origin_mode=False):
    helper = LayerHelper("gru_unit", input=input, param_attr=param_attr,
                         bias_attr=bias_attr)
    dtype = helper.input_dtype()
    D = size // 3
    weight = helper.create_parameter(
        attr=helper.param_attr, shape=[D, 3 * D], dtype=dtype
    )
    gate = helper.create_variable_for_type_inference(dtype)
    reset_hidden_pre = helper.create_variable_for_type_inference(dtype)
    updated_hidden = helper.create_variable_for_type_inference(dtype)
    inputs = {
        "Input": [input], "HiddenPrev": [hidden], "Weight": [weight]
    }
    if bias_attr is not False:
        bias = helper.create_parameter(
            attr=helper.bias_attr, shape=[1, 3 * D], dtype=dtype,
            is_bias=True,
        )
        inputs["Bias"] = [bias]
    helper.append_op(
        type="gru_unit",
        inputs=inputs,
        outputs={
            "Gate": [gate],
            "ResetHiddenPrev": [reset_hidden_pre],
            "Hidden": [updated_hidden],
        },
        attrs={
            "activation": activation,
            "gate_activation": gate_activation,
            "origin_mode": origin_mode,
        },
    )
    return updated_hidden, reset_hidden_pre, gate


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """reference: layers/nn.py lstm_unit — fc + lstm_unit op."""
    from .nn import fc

    helper = LayerHelper("lstm_unit", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    size = cell_t_prev.shape[-1]
    concat_in = fc(
        input=[x_t, hidden_t_prev], size=4 * size,
        param_attr=param_attr, bias_attr=bias_attr,
    )
    c = helper.create_variable_for_type_inference(x_t.dtype)
    h = helper.create_variable_for_type_inference(x_t.dtype)
    helper.append_op(
        type="lstm_unit",
        inputs={"X": [concat_in], "C_prev": [cell_t_prev]},
        outputs={"C": [c], "H": [h]},
        attrs={"forget_bias": float(forget_bias)},
    )
    return h, c
