"""The extended layer surface (port of
``paddle_tpu/fluid/layers/extended.py``, the names whose ops the port
lowers): the fused recurrent layers ``dynamic_lstm``, ``dynamic_lstmp``,
``dynamic_gru``, ``gru_unit`` and ``lstm_unit`` (reference
python/paddle/fluid/layers/nn.py dynamic_lstm:443; the input is the
projected [B, T, 4D] (or 3D) pre-activation a preceding ``fc`` makes,
padded, with its lengths in the ``@SEQ_LEN`` companion), the losses,
``auc``, ``edit_distance``, ``chunk_eval`` and the indexing, cropping,
layout and norm layers. Each appends its op with the reference's slots
and attrs."""

import numpy as np

from ..layer_helper import LayerHelper

__all__ = ["dynamic_lstm", "dynamic_lstmp", "dynamic_gru", "gru_unit",
           "lstm_unit", "warpctc", "kldiv_loss", "log_loss", "rank_loss",
           "margin_rank_loss", "bpr_loss", "center_loss",
           "sigmoid_focal_loss", "hinge_loss", "npair_loss", "auc",
           "edit_distance", "chunk_eval", "grid_sampler", "gather_nd",
           "scatter_nd_add", "scatter_nd", "strided_slice", "expand_as",
           "multiplex", "crop", "crop_tensor", "pad_constant_like",
           "unique", "unique_with_counts", "shard_index", "space_to_depth",
           "pixel_shuffle", "shuffle_channel", "temporal_shift", "selu",
           "spectral_norm", "affine_channel"]


def _simple(op_type, inputs, attrs=None, out_slots=("Out",), dtypes=None):
    """One ``op_type`` op with an output a slot (the first input's dtype
    unless ``dtypes`` names one); the output, or a tuple of them."""
    helper = LayerHelper(op_type)
    first = next(iter(inputs.values()))[0]
    outs = [helper.create_variable_for_type_inference(
        dtype=(dtypes or {}).get(slot, getattr(first, "dtype", "float32")))
        for slot in out_slots]
    helper.append_op(type=op_type, inputs=inputs,
                     outputs={s: [o] for s, o in zip(out_slots, outs)},
                     attrs=attrs or {})
    return outs[0] if len(outs) == 1 else tuple(outs)


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


# -- losses (reference ``extended.py:272-376``) -----------------------------
def warpctc(input, label, blank=0, norm_by_times=False, input_length=None,
            label_length=None):
    """CTC loss of padded logits [B, T, C] against labels (``warpctc``)."""
    helper = LayerHelper("warpctc")
    loss = helper.create_variable_for_type_inference(input.dtype)
    grad = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"Logits": [input], "Label": [label]}
    if input_length is not None:
        inputs["LogitsLength"] = [input_length]
    if label_length is not None:
        inputs["LabelLength"] = [label_length]
    helper.append_op(type="warpctc", inputs=inputs,
                     outputs={"Loss": [loss], "WarpCTCGrad": [grad]},
                     attrs={"blank": blank, "norm_by_times": norm_by_times})
    return loss


def kldiv_loss(x, target, reduction="mean", name=None):
    return _simple("kldiv_loss", {"X": [x], "Target": [target]},
                   {"reduction": reduction}, out_slots=("Loss",))


def log_loss(input, label, epsilon=1e-4, name=None):
    return _simple("log_loss", {"Predicted": [input], "Labels": [label]},
                   {"epsilon": epsilon}, out_slots=("Loss",))


def hinge_loss(input, label, name=None):
    return _simple("hinge_loss", {"Logits": [input], "Labels": [label]},
                   out_slots=("Loss",))


def rank_loss(label, left, right, name=None):
    return _simple("rank_loss", {"Label": [label], "Left": [left],
                                 "Right": [right]})


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    helper = LayerHelper("margin_rank_loss")
    out = helper.create_variable_for_type_inference(left.dtype)
    act = helper.create_variable_for_type_inference(left.dtype)
    helper.append_op(type="margin_rank_loss",
                     inputs={"Label": [label], "X1": [left], "X2": [right]},
                     outputs={"Out": [out], "Activated": [act]},
                     attrs={"margin": float(margin)})
    return out


def bpr_loss(input, label, name=None):
    return _simple("bpr_loss", {"X": [input], "Label": [label]},
                   out_slots=("Y",))


def center_loss(input, label, num_classes, alpha, param_attr=None,
                update_center=True):
    """Center loss with a [num_classes, D] center table, updated in
    place at rate ``alpha`` when ``update_center``."""
    helper = LayerHelper("center_loss", **locals())
    dtype = helper.input_dtype()
    centers = helper.create_parameter(attr=helper.param_attr,
                                      shape=[num_classes, input.shape[-1]],
                                      dtype=dtype)
    from .tensor import fill_constant

    rate = fill_constant(shape=[1], dtype="float32", value=float(alpha))
    diff = helper.create_variable_for_type_inference(dtype)
    loss = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="center_loss",
        inputs={"X": [input], "Label": [label], "Centers": [centers],
                "CenterUpdateRate": [rate]},
        outputs={"SampleCenterDiff": [diff], "Loss": [loss],
                 "CentersOut": [centers]},
        attrs={"need_update": update_center})
    return loss


def sigmoid_focal_loss(x, label, fg_num, gamma=2.0, alpha=0.25):
    return _simple("sigmoid_focal_loss",
                   {"X": [x], "Label": [label], "FgNum": [fg_num]},
                   {"gamma": gamma, "alpha": alpha})


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """N-pair loss from ``matmul``, ``softmax_with_cross_entropy`` and
    the means (``extended.py:367``)."""
    from .. import layers as L

    similarity = L.matmul(anchor, positive, transpose_y=True)
    ce = L.mean(L.softmax_with_cross_entropy(similarity, labels))
    l2 = L.mean(L.reduce_sum(anchor * anchor + positive * positive,
                             dim=[1]))
    return ce + l2 * l2_reg * 0.25


# -- metrics ----------------------------------------------------------------
def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,
        slide_steps=1):
    """Streaming AUC: two persistable int64 [num_thresholds + 1] bucket
    tables at 0, updated in place by the ``auc`` op. Returns (AUC,
    [StatPos, StatNeg])."""
    helper = LayerHelper("auc")
    stat_pos = helper.create_global_variable(
        persistable=True, dtype="int64", shape=[num_thresholds + 1])
    stat_neg = helper.create_global_variable(
        persistable=True, dtype="int64", shape=[num_thresholds + 1])
    from ..initializer import Constant

    for var in [stat_pos, stat_neg]:
        helper.set_variable_initializer(var, Constant(value=0.0))
    auc_out = helper.create_variable_for_type_inference(dtype="float64")
    helper.append_op(
        type="auc",
        inputs={"Predict": [input], "Label": [label],
                "StatPos": [stat_pos], "StatNeg": [stat_neg]},
        outputs={"AUC": [auc_out], "StatPosOut": [stat_pos],
                 "StatNegOut": [stat_neg]},
        attrs={"curve": curve, "num_thresholds": num_thresholds})
    return auc_out, [stat_pos, stat_neg]


def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  input_length=None, label_length=None):
    helper = LayerHelper("edit_distance")
    out = helper.create_variable_for_type_inference(dtype="float32")
    seq_num = helper.create_variable_for_type_inference(dtype="int64")
    inputs = {"Hyps": [input], "Refs": [label]}
    if input_length is not None:
        inputs["HypsLength"] = [input_length]
    if label_length is not None:
        inputs["RefsLength"] = [label_length]
    helper.append_op(type="edit_distance", inputs=inputs,
                     outputs={"Out": [out], "SequenceNum": [seq_num]},
                     attrs={"normalized": normalized,
                            "ignored_tokens": list(ignored_tokens or [])})
    return out, seq_num


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None, seq_length=None):
    helper = LayerHelper("chunk_eval")
    outs = [helper.create_variable_for_type_inference(dtype=dt)
            for dt in ["float32"] * 3 + ["int64"] * 3]
    inputs = {"Inference": [input], "Label": [label]}
    if seq_length is not None:
        inputs["SeqLength"] = [seq_length]
    helper.append_op(
        type="chunk_eval", inputs=inputs,
        outputs={s: [o] for s, o in zip(
            ("Precision", "Recall", "F1-Score", "NumInferChunks",
             "NumLabelChunks", "NumCorrectChunks"), outs)},
        attrs={"num_chunk_types": num_chunk_types,
               "chunk_scheme": chunk_scheme,
               "excluded_chunk_types": excluded_chunk_types or []})
    return tuple(outs)


# -- sampling, indexing and manipulation ------------------------------------
def grid_sampler(x, grid, name=None):
    return _simple("grid_sampler", {"X": [x], "Grid": [grid]},
                   out_slots=("Output",))


def gather_nd(input, index, name=None):
    return _simple("gather_nd", {"X": [input], "Index": [index]})


def scatter_nd_add(ref, index, updates, name=None):
    return _simple("scatter_nd_add", {"X": [ref], "Index": [index],
                                      "Updates": [updates]})


def scatter_nd(index, updates, shape, name=None):
    return _simple("scatter_nd", {"Index": [index], "Updates": [updates]},
                   {"shape": list(shape)})


def strided_slice(input, axes, starts, ends, strides):
    return _simple("strided_slice", {"Input": [input]},
                   {"axes": axes, "starts": starts, "ends": ends,
                    "strides": strides})


def expand_as(x, target_tensor, name=None):
    return _simple("expand_as", {"X": [x], "target_tensor": [target_tensor]})


def multiplex(inputs, index):
    helper = LayerHelper("multiplex")
    out = helper.create_variable_for_type_inference(inputs[0].dtype)
    helper.append_op(type="multiplex", inputs={"X": inputs, "Ids": [index]},
                     outputs={"Out": [out]})
    return out


def _crop(op_type, shape_slot, x, shape, offsets):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(x.dtype)
    inputs, attrs = {"X": [x]}, {}
    if hasattr(shape, "name"):
        inputs[shape_slot] = [shape]
    elif shape is not None:
        attrs["shape"] = list(shape)
    if hasattr(offsets, "name"):
        inputs["Offsets"] = [offsets]
    elif offsets is not None:
        attrs["offsets"] = list(offsets)
    helper.append_op(type=op_type, inputs=inputs, outputs={"Out": [out]},
                     attrs=attrs)
    return out


def crop(x, shape=None, offsets=None, name=None):
    """A window of ``x``: ``shape`` a variable (its shape is taken, slot
    Y) or a list; ``offsets`` a variable or a list."""
    return _crop("crop", "Y", x, shape, offsets)


def crop_tensor(x, shape=None, offsets=None, name=None):
    """A window of ``x``: ``shape`` a variable (its values, slot Shape)
    or a list (−1 to the end); ``offsets`` a variable or a list."""
    return _crop("crop_tensor", "Shape", x, shape, offsets)


def pad_constant_like(x, y, pad_value=0.0, name=None):
    return _simple("pad_constant_like", {"X": [x], "Y": [y]},
                   {"pad_value": float(pad_value)})


def unique(x, dtype="int64"):
    helper = LayerHelper("unique")
    out = helper.create_variable_for_type_inference(x.dtype)
    index = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="unique", inputs={"X": [x]},
                     outputs={"Out": [out], "Index": [index]})
    return out, index


def unique_with_counts(x, dtype="int64"):
    helper = LayerHelper("unique_with_counts")
    out = helper.create_variable_for_type_inference(x.dtype)
    index = helper.create_variable_for_type_inference(dtype)
    count = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="unique_with_counts", inputs={"X": [x]},
                     outputs={"Out": [out], "Index": [index],
                              "Count": [count]})
    return out, index, count


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    return _simple("shard_index", {"X": [input]},
                   {"index_num": index_num, "nshards": nshards,
                    "shard_id": shard_id, "ignore_value": ignore_value})


def space_to_depth(x, blocksize, name=None):
    return _simple("space_to_depth", {"X": [x]}, {"blocksize": blocksize})


def pixel_shuffle(x, upscale_factor):
    return _simple("pixel_shuffle", {"X": [x]},
                   {"upscale_factor": upscale_factor})


def shuffle_channel(x, group, name=None):
    return _simple("shuffle_channel", {"X": [x]}, {"group": group})


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None):
    return _simple("temporal_shift", {"X": [x]},
                   {"seg_num": seg_num, "shift_ratio": shift_ratio})


def selu(x, scale=None, alpha=None, name=None):
    attrs = {}
    if scale is not None:
        attrs["scale"] = scale
    if alpha is not None:
        attrs["alpha"] = alpha
    return _simple("selu", {"X": [x]}, attrs)


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """``weight`` over its largest singular value, estimated by power
    iteration on the parameters U [h] and V [w] (kept out of the
    gradient), which the op updates in place."""
    helper = LayerHelper("spectral_norm", **locals())
    dtype = weight.dtype
    h = weight.shape[dim]
    w = int(np.prod(weight.shape)) // h if all(
        s > 0 for s in weight.shape) else h
    u = helper.create_parameter(attr=None, shape=[h], dtype=dtype,
                                default_initializer=None)
    v = helper.create_parameter(attr=None, shape=[w], dtype=dtype,
                                default_initializer=None)
    u.stop_gradient = True
    v.stop_gradient = True
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="spectral_norm",
                     inputs={"Weight": [weight], "U": [u], "V": [v]},
                     outputs={"Out": [out]},
                     attrs={"dim": dim, "power_iters": power_iters,
                            "eps": eps})
    return out


def affine_channel(x, scale=None, bias=None, data_layout="NCHW", name=None,
                   act=None):
    """x·scale + bias by channel; scale and bias created at 1 and 0 when
    not given."""
    helper = LayerHelper("affine_channel", **locals())
    from ..initializer import Constant

    C = x.shape[1] if data_layout == "NCHW" else x.shape[-1]
    if scale is None:
        scale = helper.create_parameter(attr=None, shape=[C], dtype=x.dtype,
                                        default_initializer=Constant(1.0))
    if bias is None:
        bias = helper.create_parameter(attr=None, shape=[C], dtype=x.dtype,
                                       default_initializer=Constant(0.0))
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="affine_channel",
                     inputs={"X": [x], "Scale": [scale], "Bias": [bias]},
                     outputs={"Out": [out]},
                     attrs={"data_layout": data_layout})
    return helper.append_activation(out)
