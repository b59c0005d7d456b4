"""Neural-network layer functions the GPT, BERT, LeNet and ResNet
programs use (port of the matching functions of
``paddle_tpu/fluid/layers/nn.py``, names and signatures as there; each
builds ops through LayerHelper.append_op), the KV-cache and decode
attention layers of the serving programs included.
"""

import numpy as np

from .. import core
from ..framework import Variable
from ..initializer import Constant, Normal
from ..layer_helper import LayerHelper
from ..ops.nn_ops import _pair
from ..param_attr import ParamAttr

__all__ = [
    "fc", "embedding", "layer_norm", "dropout", "softmax", "matmul",
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "mean", "reduce_sum", "reduce_mean", "reshape",
    "unsqueeze", "transpose", "slice", "flash_attention", "scale",
    "softmax_with_cross_entropy", "where", "logical_and",
    "flash_decode_attention", "flash_decode_paged_attention",
    "kv_cache_write", "kv_cache_copy", "kv_cache_gather",
    "kv_cache_write_paged", "kv_cache_gather_paged", "kv_cache_block_copy",
    "conv2d", "pool2d", "batch_norm", "relu", "topk", "elementwise_max",
    "elementwise_min", "elementwise_pow", "logical_not", "one_hot",
    "label_smooth", "autoincreased_step_counter",
    "elementwise_floordiv", "elementwise_mod", "split", "expand",
    "log_softmax", "gather", "clip", "squeeze", "cross_entropy",
    "sequence_pool", "sequence_first_step", "sequence_last_step",
    "sequence_softmax", "sequence_reshape", "sequence_concat",
    "sequence_expand", "sequence_expand_as", "sequence_pad",
    "sequence_unpad", "sequence_slice", "sequence_reverse", "sequence_mask",
    "sequence_enumerate", "sequence_scatter", "sequence_conv", "row_conv",
    "im2sequence", "relu6", "leaky_relu", "elu", "swish", "hard_sigmoid",
    "hard_swish", "brelu", "soft_relu", "pow", "stanh", "sign", "prelu",
    "l2_normalize", "mul", "clip_by_norm", "reduce_max", "reduce_min",
    "reduce_prod", "reduce_all", "reduce_any", "flatten", "stack",
    "unstack", "scatter", "shape", "pad", "pad2d", "maxout", "unfold",
    "cos_sim", "logical_or", "logical_xor", "adaptive_pool2d",
    "uniform_random_batch_size_like", "gaussian_random", "sampling_id",
    "conv2d_transpose", "group_norm", "instance_norm", "lrn",
    "image_resize", "resize_bilinear", "resize_nearest", "grid_sampler",
    "hsigmoid", "nce",
]


def fc(
    input,
    size,
    num_flatten_dims=1,
    param_attr=None,
    bias_attr=None,
    act=None,
    name=None,
):
    """Fully connected (reference: layers/nn.py:233 fc — mul + elementwise_add
    + activation; multiple inputs are summed)."""
    helper = LayerHelper("fc", **locals())
    dtype = helper.input_dtype()
    mul_results = []
    for input_var, param_attr_ in helper.iter_inputs_and_params():
        input_shape = input_var.shape
        param_shape = [
            int(np.prod(input_shape[num_flatten_dims:])),
            size,
        ]
        w = helper.create_parameter(
            attr=param_attr_, shape=param_shape, dtype=dtype
        )
        tmp = helper.create_variable_for_type_inference(dtype)
        helper.append_op(
            type="mul",
            inputs={"X": [input_var], "Y": [w]},
            outputs={"Out": [tmp]},
            attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1},
        )
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(dtype)
        helper.append_op(
            type="sum", inputs={"X": mul_results}, outputs={"Out": [pre_bias]}
        )
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def embedding(
    input,
    size,
    is_sparse=False,
    is_distributed=False,
    padding_idx=None,
    param_attr=None,
    dtype="float32",
):
    """reference: layers/nn.py embedding -> lookup_table op; the gradient
    is dense (``is_sparse`` is recorded, SelectedRows is not ported)."""
    helper = LayerHelper("embedding", **locals())
    w = helper.create_parameter(
        attr=helper.param_attr, shape=size, dtype=dtype, is_bias=False
    )
    tmp = helper.create_variable_for_type_inference(dtype)
    padding_idx = (
        -1
        if padding_idx is None
        else padding_idx
        if padding_idx >= 0
        else (size[0] + padding_idx)
    )
    helper.append_op(
        type="lookup_table",
        inputs={"Ids": [input], "W": [w]},
        outputs={"Out": [tmp]},
        attrs={
            "is_sparse": is_sparse,
            "is_distributed": is_distributed,
            "padding_idx": padding_idx,
        },
    )
    return tmp


def layer_norm(
    input,
    scale=True,
    shift=True,
    begin_norm_axis=1,
    epsilon=1e-5,
    param_attr=None,
    bias_attr=None,
    act=None,
    name=None,
):
    helper = LayerHelper("layer_norm", **locals())
    dtype = helper.input_dtype()
    param_shape = [int(np.prod(input.shape[begin_norm_axis:]))]
    inputs = {"X": [input]}
    if scale:
        s = helper.create_parameter(
            attr=helper.param_attr,
            shape=param_shape,
            dtype=dtype,
            default_initializer=Constant(1.0),
        )
        inputs["Scale"] = [s]
    if shift:
        b = helper.create_parameter(
            attr=helper.bias_attr, shape=param_shape, dtype=dtype, is_bias=True
        )
        inputs["Bias"] = [b]
    mean_out = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    variance_out = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="layer_norm",
        inputs=inputs,
        outputs={"Y": [out], "Mean": [mean_out], "Variance": [variance_out]},
        attrs={"epsilon": epsilon, "begin_norm_axis": begin_norm_axis},
    )
    return helper.append_activation(out)


def dropout(
    x,
    dropout_prob,
    is_test=False,
    seed=None,
    name=None,
    dropout_implementation="downgrade_in_infer",
):
    helper = LayerHelper("dropout", **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    mask = helper.create_variable_for_type_inference(
        dtype=x.dtype, stop_gradient=True
    )
    helper.append_op(
        type="dropout",
        inputs={"X": [x]},
        outputs={"Out": [out], "Mask": [mask]},
        attrs={
            "dropout_prob": dropout_prob,
            "is_test": is_test,
            "fix_seed": seed is not None,
            "seed": seed if seed is not None else 0,
            "dropout_implementation": dropout_implementation,
        },
    )
    return out


def softmax(input, use_cudnn=False, name=None, axis=-1):
    helper = LayerHelper("softmax", **locals())
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type="softmax",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={"axis": axis, "use_cudnn": use_cudnn},
    )
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        type="matmul",
        inputs={"X": [x], "Y": [y]},
        outputs={"Out": [out]},
        attrs={
            "transpose_X": transpose_x,
            "transpose_Y": transpose_y,
            "alpha": float(alpha),
        },
    )
    return out


def _elementwise(op_type, x, y, axis=-1, act=None, name=None):
    helper = LayerHelper(op_type, name=name, act=act)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        type=op_type,
        inputs={"X": [x], "Y": [y]},
        outputs={"Out": [out]},
        attrs={"axis": axis},
    )
    return helper.append_activation(out)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_add", x, y, axis, act, name)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_sub", x, y, axis, act, name)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_mul", x, y, axis, act, name)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_div", x, y, axis, act, name)


def elementwise_max(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_max", x, y, axis, act, name)


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_min", x, y, axis, act, name)


def elementwise_pow(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_pow", x, y, axis, act, name)


def mean(x, name=None):
    helper = LayerHelper("mean", **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="mean", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def _reduce(op_type, input, dim=None, keep_dim=False, name=None):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    if dim is not None and not isinstance(dim, (list, tuple)):
        dim = [dim]
    helper.append_op(
        type=op_type,
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={
            "dim": dim if dim is not None else [0],
            "keep_dim": keep_dim,
            "reduce_all": dim is None,
        },
    )
    return out


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_sum", input, dim, keep_dim, name)


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_mean", input, dim, keep_dim, name)


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    helper = LayerHelper("reshape2", **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    x_shape = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        type="reshape2",
        inputs={"X": [x]},
        outputs={"Out": [out], "XShape": [x_shape]},
        attrs={"shape": list(shape)},
    )
    return helper.append_activation(out)


def unsqueeze(input, axes, name=None):
    helper = LayerHelper("unsqueeze2", **locals())
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    x_shape = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type="unsqueeze2",
        inputs={"X": [input]},
        outputs={"Out": [out], "XShape": [x_shape]},
        attrs={"axes": axes},
    )
    return out


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose2", **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    x_shape = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        type="transpose2",
        inputs={"X": [x]},
        outputs={"Out": [out], "XShape": [x_shape]},
        attrs={"axis": list(perm)},
    )
    return out


def slice(input, axes, starts, ends):
    helper = LayerHelper("slice")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type="slice",
        inputs={"Input": [input]},
        outputs={"Out": [out]},
        attrs={"axes": list(axes), "starts": list(starts), "ends": list(ends)},
    )
    return out


def flash_attention(q, k, v, key_bias=None, bias=None, causal=False,
                    scale=0.0, dropout_rate=0.0, is_test=False,
                    interpret=False, name=None):
    """Fused online-softmax attention over [N, heads, S, d_head] tensors
    (the hand-written CUDA flash kernels on the card, forward and
    backward, no [S, S] tensor ever reaches device memory; their plain
    versions on the CPU). ``key_bias``: optional [N, S] additive key mask;
    ``bias``: optional general additive bias broadcastable to
    [N, heads, S, S] (relative-position / ALiBi), differentiable: its
    gradient comes from the same backward kernels; ``scale`` 0 means
    1/sqrt(d_head). ``dropout_rate``: in-kernel attention-probability
    dropout (seeded per step from the run's generator; disabled when
    ``is_test``). ``interpret`` is the reference's switch for its Pallas
    interpreter, recorded and unused here."""
    helper = LayerHelper("flash_attention", **locals())
    out = helper.create_variable_for_type_inference(dtype=q.dtype)
    inputs = {"Q": [q], "K": [k], "V": [v]}
    if key_bias is not None:
        inputs["KeyBias"] = [key_bias]
    if bias is not None:
        inputs["Bias"] = [bias]
    helper.append_op(
        type="flash_attention",
        inputs=inputs,
        outputs={"Out": [out]},
        attrs={"causal": causal, "scale": float(scale),
               "dropout_rate": float(dropout_rate), "is_test": bool(is_test),
               "interpret": bool(interpret)},
    )
    return out


def flash_decode_attention(q, k, v, key_bias=None, scale=0.0,
                           interpret=False, name=None):
    """Decode-mode single-query fused attention: ``q`` [N, heads, 1,
    d_head] (one live token per KV-cache slot) against the fixed-shape
    cache ``k``/``v`` [N, heads, max_len, d_head]; ``key_bias``
    [N, max_len] additively masks cache positions at or beyond each
    slot's live length (-1e4). Forward only (inference): the
    ``flash_decode`` CUDA kernel on the card, its plain version on the
    CPU; ``scale`` 0 means 1/sqrt(d_head). ``interpret`` is the
    reference's switch for its Pallas interpreter, recorded and unused
    here."""
    helper = LayerHelper("flash_decode_attention", **locals())
    out = helper.create_variable_for_type_inference(dtype=q.dtype)
    inputs = {"Q": [q], "K": [k], "V": [v]}
    if key_bias is not None:
        inputs["KeyBias"] = [key_bias]
    helper.append_op(
        type="flash_decode_attention",
        inputs=inputs,
        outputs={"Out": [out]},
        attrs={"scale": float(scale), "interpret": bool(interpret)},
    )
    return out


def kv_cache_write(cache, new, pos, slot_mode=False, name=None):
    """Write ``new`` into ``cache`` [slots, heads, max_len, d_head] in
    place, O(written bytes), and return the same cache variable (the op's
    output is its input var, so the Executor keeps the updated tensor in
    the scope).

    ``slot_mode=False`` (decode): ``new`` [slots, heads, 1, d_head] is
    one token per slot, ``pos`` [slots, ...] its per-slot position.
    ``slot_mode=True`` (prefill): ``new`` [1, heads, T, d_head] is one
    prompt's K/V and ``pos`` the slot index, or (slot, offset) to land
    the block at ``offset`` of the row (resume prefill). Inference only
    (no gradient)."""
    helper = LayerHelper("kv_cache_write", **locals())
    helper.append_op(
        type="kv_cache_write",
        inputs={"Cache": [cache], "New": [new], "Pos": [pos]},
        outputs={"Out": [cache]},
        attrs={"slot_mode": bool(slot_mode)},
    )
    return cache


def kv_cache_copy(dst, src, dst_loc, src_loc, length, name=None):
    """Copy ``src[src_loc[0], :, src_loc[1]:src_loc[1]+length, :]`` into
    ``dst`` at ``dst_loc`` (both 2-element (row, position) locations,
    fed data) in place, O(copied bytes): a block between the prefix store
    and a slot row, either way. Returns ``dst``. Inference only."""
    helper = LayerHelper("kv_cache_copy", **locals())
    helper.append_op(
        type="kv_cache_copy",
        inputs={"Dst": [dst], "Src": [src], "DstLoc": [dst_loc],
                "SrcLoc": [src_loc]},
        outputs={"Out": [dst]},
        attrs={"length": int(length)},
    )
    return dst


def kv_cache_gather(cache, slot_idx, name=None):
    """One slot's [1, heads, max_len, d_head] row of a [slots, heads,
    max_len, d_head] cache, the slot a fed index: the read half of a
    resume prefill. Inference only."""
    helper = LayerHelper("kv_cache_gather", **locals())
    out = helper.create_variable_for_type_inference(dtype=cache.dtype)
    helper.append_op(
        type="kv_cache_gather",
        inputs={"Cache": [cache], "Pos": [slot_idx]},
        outputs={"Out": [out]},
    )
    return out


def flash_decode_paged_attention(q, k, v, tables, key_bias=None,
                                 scale=0.0, interpret=False, name=None):
    """Decode-mode single-query fused attention through a block table:
    ``q`` [N, heads, 1, d_head] against the shared pool ``k``/``v``
    [blocks, heads, block, d_head], ``tables`` [N, max_blocks] mapping
    each slot's logical blocks to pool blocks; ``key_bias``
    [N, max_blocks*block] masks positions past each slot's live length
    (sink-block garbage included). Forward only: the
    ``flash_decode_paged`` CUDA kernel on the card, its plain version on
    the CPU; ``scale`` 0 means 1/sqrt(d_head); ``interpret`` recorded
    and unused."""
    helper = LayerHelper("flash_decode_paged_attention", **locals())
    out = helper.create_variable_for_type_inference(dtype=q.dtype)
    inputs = {"Q": [q], "K": [k], "V": [v], "Tables": [tables]}
    if key_bias is not None:
        inputs["KeyBias"] = [key_bias]
    helper.append_op(
        type="flash_decode_paged_attention",
        inputs=inputs,
        outputs={"Out": [out]},
        attrs={"scale": float(scale), "interpret": bool(interpret)},
    )
    return out


def kv_cache_write_paged(cache, new, tables, pos, name=None):
    """Write each slot's token window ``new`` [slots, heads, T, d_head]
    into the shared pool ``cache`` [blocks, heads, block, d_head] in
    place through its block table ``tables`` [slots, max_blocks]: token
    j of slot s lands at pool block ``tables[s, (pos[s]+j)//block]``,
    offset ``(pos[s]+j)%block``. Returns ``cache``. Inference only."""
    helper = LayerHelper("kv_cache_write_paged", **locals())
    helper.append_op(
        type="kv_cache_write_paged",
        inputs={"Cache": [cache], "New": [new], "Tables": [tables],
                "Pos": [pos]},
        outputs={"Out": [cache]},
    )
    return cache


def kv_cache_gather_paged(cache, tables, name=None):
    """Each slot's logical [heads, max_blocks*block, d_head] row gathered
    from the pool through its block table: Out [slots, heads,
    max_blocks*block, d_head]. Positions past a slot's live length carry
    whatever the mapped blocks hold; the caller's key bias masks them.
    Inference only."""
    helper = LayerHelper("kv_cache_gather_paged", **locals())
    out = helper.create_variable_for_type_inference(dtype=cache.dtype)
    helper.append_op(
        type="kv_cache_gather_paged",
        inputs={"Cache": [cache], "Tables": [tables]},
        outputs={"Out": [out]},
    )
    return out


def kv_cache_block_copy(cache, src, dst, name=None):
    """``cache[dst[i]] = cache[src[i]]`` in place for the fed pairs (the
    copy-on-write primitive; a src == dst pair is a no-op). Returns
    ``cache``. Inference only."""
    helper = LayerHelper("kv_cache_block_copy", **locals())
    helper.append_op(
        type="kv_cache_block_copy",
        inputs={"Cache": [cache], "Src": [src], "Dst": [dst]},
        outputs={"Out": [cache]},
    )
    return cache


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    """reference: layers/nn.py scale."""
    helper = LayerHelper("scale", **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        type="scale",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"scale": float(scale), "bias": float(bias),
               "bias_after_scale": bias_after_scale},
    )
    return helper.append_activation(out) if act else out


def softmax_with_cross_entropy(
    logits,
    label,
    soft_label=False,
    ignore_index=-100,
    numeric_stable_mode=True,
    return_softmax=False,
    axis=-1,
):
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax = helper.create_variable_for_type_inference(dtype=logits.dtype)
    loss = helper.create_variable_for_type_inference(dtype=logits.dtype)
    helper.append_op(
        type="softmax_with_cross_entropy",
        inputs={"Logits": [logits], "Label": [label]},
        outputs={"Softmax": [softmax], "Loss": [loss]},
        attrs={
            "soft_label": soft_label,
            "ignore_index": ignore_index,
            "numeric_stable_mode": numeric_stable_mode,
            "axis": axis,
        },
    )
    if return_softmax:
        return loss, softmax
    return loss


def where(condition, x, y):
    """``condition ? x : y`` elementwise, broadcast (``nn.py:1269``)."""
    helper = LayerHelper("where")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        type="where",
        inputs={"Condition": [condition], "X": [x], "Y": [y]},
        outputs={"Out": [out]},
    )
    return out


def _logical(op_type, x, y=None, out=None, name=None):
    helper = LayerHelper(op_type, name=name)
    if out is None:
        out = helper.create_variable_for_type_inference(
            dtype=core.VarDesc.VarType.BOOL)
    inputs = {"X": [x]}
    if y is not None:
        inputs["Y"] = [y]
    helper.append_op(type=op_type, inputs=inputs, outputs={"Out": [out]})
    return out


def logical_and(x, y, out=None, name=None):
    """Elementwise ``x and y`` of bool variables (``nn.py:1311``)."""
    return _logical("logical_and", x, y, out, name)


def logical_not(x, out=None, name=None):
    """Elementwise ``not x`` of a bool variable (``nn.py:1323``)."""
    return _logical("logical_not", x, None, out, name)


def one_hot(input, depth, allow_out_of_range=False):
    """fp32 [..., depth] one-hot rows of int ids (``nn.py:1035``)."""
    helper = LayerHelper("one_hot")
    out = helper.create_variable_for_type_inference(
        dtype=core.VarDesc.VarType.FP32)
    helper.append_op(
        type="one_hot", inputs={"X": [input]}, outputs={"Out": [out]},
        attrs={"depth": depth, "allow_out_of_range": allow_out_of_range})
    return out


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32",
                 name=None):
    """(1 − ε)·label + ε over a uniform (or the given) prior
    (``nn.py:1143``)."""
    helper = LayerHelper("label_smooth", **locals())
    out = helper.create_variable_for_type_inference(dtype)
    inputs = {"X": [label]}
    if prior_dist is not None:
        inputs["PriorDist"] = [prior_dist]
    helper.append_op(type="label_smooth", inputs=inputs,
                     outputs={"Out": [out]},
                     attrs={"epsilon": float(epsilon)})
    return out


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """A persistable int64 [1] counter, ``begin - 1`` after the startup
    program, that an ``increment`` op prepended to the main program's
    current block raises by ``step`` at the start of every run, so the
    first run reads ``begin`` (``nn.py:1222``). The counter and its op
    are made once per name and program."""
    helper = LayerHelper("global_step_counter")
    counter_name = counter_name or "@STEP_COUNTER@"
    counter = helper.create_or_get_global_variable(
        name=counter_name, dtype=core.VarDesc.VarType.INT64, shape=[1],
        persistable=True)
    if not getattr(counter, "_step_init_done", False):
        helper.set_variable_initializer(counter,
                                        Constant(value=float(begin - 1)))
        helper.main_program.current_block()._prepend_op(
            type="increment", inputs={"X": [counter]},
            outputs={"Out": [counter]}, attrs={"step": float(step)})
        counter._step_init_done = True
        counter.stop_gradient = True
    return counter


def conv2d(
    input,
    num_filters,
    filter_size,
    stride=1,
    padding=0,
    dilation=1,
    groups=None,
    param_attr=None,
    bias_attr=None,
    use_cudnn=True,
    act=None,
    name=None,
    data_format="NCHW",
):
    """2-D convolution on NCHW (``nn.py:213``): the filter [num_filters,
    C_in / groups, kh, kw] from Normal(0, √(2 / fan_in)), a
    ``depthwise_conv2d`` op when ``groups`` is C_in and ``num_filters`` a
    multiple of it (so a 1-channel input with groups 1 is one, as the
    reference emits it), else ``conv2d``; then the bias over the channel
    dim and the activation."""
    helper = LayerHelper("conv2d", **locals())
    dtype = helper.input_dtype()
    num_channels = input.shape[1]
    groups = groups or 1
    filter_size = _pair(filter_size)
    filter_shape = [num_filters, num_channels // groups] + filter_size
    fan_in = (num_channels // groups) * filter_size[0] * filter_size[1]
    w = helper.create_parameter(
        attr=helper.param_attr,
        shape=filter_shape,
        dtype=dtype,
        default_initializer=Normal(0.0, (2.0 / fan_in) ** 0.5),
    )
    pre_bias = helper.create_variable_for_type_inference(dtype)
    op_type = (
        "depthwise_conv2d"
        if groups == num_channels and num_filters % num_channels == 0
        else "conv2d"
    )
    helper.append_op(
        type=op_type,
        inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [pre_bias]},
        attrs={
            "strides": _pair(stride),
            "paddings": _pair(padding),
            "dilations": _pair(dilation),
            "groups": groups,
            "use_cudnn": use_cudnn,
            "data_format": data_format,
        },
    )
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def pool2d(
    input,
    pool_size=-1,
    pool_type="max",
    pool_stride=1,
    pool_padding=0,
    global_pooling=False,
    use_cudnn=True,
    ceil_mode=False,
    name=None,
    exclusive=True,
):
    """Max or average pooling on NCHW (``nn.py:325``)."""
    helper = LayerHelper("pool2d", **locals())
    dtype = helper.input_dtype()
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="pool2d",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={
            "pooling_type": pool_type,
            "ksize": _pair(pool_size),
            "global_pooling": global_pooling,
            "strides": _pair(pool_stride),
            "paddings": _pair(pool_padding),
            "ceil_mode": ceil_mode,
            "use_cudnn": use_cudnn,
            "exclusive": exclusive,
        },
    )
    return out


def batch_norm(
    input,
    act=None,
    is_test=False,
    momentum=0.9,
    epsilon=1e-5,
    param_attr=None,
    bias_attr=None,
    data_layout="NCHW",
    in_place=False,
    name=None,
    moving_mean_name=None,
    moving_variance_name=None,
    do_model_average_for_mean_and_var=False,
    use_global_stats=False,
):
    """Batch norm (``nn.py:374``): scale (1) and bias (0) parameters, and
    the running Mean (0) and Variance (1), persistable and not trainable,
    which the op rewrites in place (MeanOut / VarianceOut name them)."""
    helper = LayerHelper("batch_norm", **locals())
    dtype = helper.input_dtype()
    channels = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    param_shape = [channels]
    scale = helper.create_parameter(
        attr=helper.param_attr, shape=param_shape, dtype=dtype,
        default_initializer=Constant(1.0))
    bias = helper.create_parameter(
        attr=helper.bias_attr, shape=param_shape, dtype=dtype, is_bias=True)
    mean = helper.create_parameter(
        attr=ParamAttr(name=moving_mean_name, initializer=Constant(0.0),
                       trainable=False),
        shape=param_shape, dtype=dtype)
    mean.stop_gradient = True
    variance = helper.create_parameter(
        attr=ParamAttr(name=moving_variance_name, initializer=Constant(1.0),
                       trainable=False),
        shape=param_shape, dtype=dtype)
    variance.stop_gradient = True
    saved_mean = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    saved_variance = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    out = input if in_place else helper.create_variable_for_type_inference(
        dtype)
    helper.append_op(
        type="batch_norm",
        inputs={"X": [input], "Scale": [scale], "Bias": [bias],
                "Mean": [mean], "Variance": [variance]},
        outputs={"Y": [out], "MeanOut": [mean], "VarianceOut": [variance],
                 "SavedMean": [saved_mean],
                 "SavedVariance": [saved_variance]},
        attrs={"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
               "data_layout": data_layout,
               "use_global_stats": use_global_stats},
    )
    return helper.append_activation(out)


def relu(x, name=None):
    """max(x, 0) (``nn.py:618``)."""
    helper = LayerHelper("relu", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="relu", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={})
    return out


def topk(input, k, name=None):
    """The ``k`` largest entries of the last axis and their int64
    indices (``nn.py:1047``); no gradient."""
    helper = LayerHelper("top_k", **locals())
    values = helper.create_variable_for_type_inference(dtype=input.dtype)
    indices = helper.create_variable_for_type_inference(
        dtype=core.VarDesc.VarType.INT64)
    helper.append_op(
        type="top_k",
        inputs={"X": [input]},
        outputs={"Out": [values], "Indices": [indices]},
        attrs={"k": k if isinstance(k, int) else 1},
    )
    values.stop_gradient = True
    indices.stop_gradient = True
    return values, indices


# ---------------------------------------------------------------------------
# what the recurrent layers, the decoders and the nets use (``nn.py``)
# ---------------------------------------------------------------------------
def elementwise_floordiv(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_floordiv", x, y, axis, act, name)


def elementwise_mod(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_mod", x, y, axis, act, name)


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    helper = LayerHelper("cross_entropy")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type="cross_entropy",
                     inputs={"X": [input], "Label": [label]},
                     outputs={"Out": [out]},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index})
    return out


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", name=name)
    dim = dim if dim >= 0 else dim + len(input.shape)
    if isinstance(num_or_sections, int):
        num, sections = num_or_sections, []
    else:
        num, sections = 0, list(num_or_sections)
    outs = [helper.create_variable_for_type_inference(dtype=input.dtype)
            for _ in range(num or len(sections))]
    helper.append_op(type="split", inputs={"X": [input]},
                     outputs={"Out": outs},
                     attrs={"num": num, "sections": sections, "axis": dim})
    return outs


def expand(x, expand_times, name=None):
    helper = LayerHelper("expand", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="expand", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"expand_times": list(expand_times)})
    return out


def log_softmax(input, axis=-1, name=None):
    helper = LayerHelper("log_softmax", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type="log_softmax", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def gather(input, index, overwrite=True):
    helper = LayerHelper("gather")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type="gather", inputs={"X": [input], "Index": [index]},
                     outputs={"Out": [out]})
    return out


def clip(x, min, max, name=None):
    helper = LayerHelper("clip", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="clip", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"min": float(min), "max": float(max)})
    return out


def squeeze(input, axes, name=None):
    helper = LayerHelper("squeeze2", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    x_shape = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type="squeeze2", inputs={"X": [input]},
                     outputs={"Out": [out], "XShape": [x_shape]},
                     attrs={"axes": axes})
    return out


# -- sequence layers (``nn.py:1585-1790``) -------------------------------------
def _seq_one_in(op_type, x, attrs=None, out_slot="Out", dtype=None):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(dtype=dtype or x.dtype)
    helper.append_op(type=op_type, inputs={"X": [x]},
                     outputs={out_slot: [out]}, attrs=attrs or {})
    return out


def sequence_pool(input, pool_type, is_test=False, pad_value=0.0):
    helper = LayerHelper("sequence_pool")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    max_index = helper.create_variable_for_type_inference(dtype="int32")
    helper.append_op(
        type="sequence_pool", inputs={"X": [input]},
        outputs={"Out": [out], "MaxIndex": [max_index]},
        attrs={"pooltype": pool_type.upper(), "is_test": is_test,
               "pad_value": pad_value})
    return out


def sequence_first_step(input):
    return sequence_pool(input, "first")


def sequence_last_step(input):
    return sequence_pool(input, "last")


def sequence_softmax(input, use_cudnn=False, name=None):
    return _seq_one_in("sequence_softmax", input)


def sequence_reshape(input, new_dim):
    return _seq_one_in("sequence_reshape", input, {"new_dim": new_dim})


def sequence_concat(input, name=None):
    helper = LayerHelper("sequence_concat")
    out = helper.create_variable_for_type_inference(dtype=input[0].dtype)
    helper.append_op(type="sequence_concat", inputs={"X": input},
                     outputs={"Out": [out]})
    return out


def sequence_expand(x, y, ref_level=-1, name=None):
    helper = LayerHelper("sequence_expand")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="sequence_expand", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]}, attrs={"ref_level": ref_level})
    return out


def sequence_expand_as(x, y, name=None):
    helper = LayerHelper("sequence_expand_as")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="sequence_expand_as", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


def sequence_pad(x, pad_value, maxlen=None, name=None):
    helper = LayerHelper("sequence_pad")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    length = helper.create_variable_for_type_inference(dtype="int64")
    helper.append_op(
        type="sequence_pad", inputs={"X": [x], "PadValue": [pad_value]},
        outputs={"Out": [out], "Length": [length]},
        attrs={"padded_length": maxlen if maxlen is not None else -1})
    return out, length


def sequence_unpad(x, length, name=None):
    helper = LayerHelper("sequence_unpad")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="sequence_unpad",
                     inputs={"X": [x], "Length": [length]},
                     outputs={"Out": [out]})
    return out


def sequence_slice(input, offset, length, name=None):
    helper = LayerHelper("sequence_slice")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type="sequence_slice",
        inputs={"X": [input], "Offset": [offset], "Length": [length]},
        outputs={"Out": [out]})
    return out


def sequence_reverse(x, name=None):
    return _seq_one_in("sequence_reverse", x, out_slot="Y")


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    helper = LayerHelper("sequence_mask")
    out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(
        type="sequence_mask", inputs={"X": [x]}, outputs={"Y": [out]},
        attrs={"maxlen": maxlen if maxlen is not None else -1,
               "out_dtype": core.np_to_dtype(dtype)})
    return out


def sequence_enumerate(input, win_size, pad_value=0, name=None):
    return _seq_one_in("sequence_enumerate", input,
                       {"win_size": win_size, "pad_value": pad_value})


def sequence_scatter(input, index, updates, name=None):
    helper = LayerHelper("sequence_scatter")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type="sequence_scatter",
        inputs={"X": [input], "Ids": [index], "Updates": [updates]},
        outputs={"Out": [out]})
    return out


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, bias_attr=None, param_attr=None, act=None,
                  name=None):
    helper = LayerHelper("sequence_conv", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    filter_param = helper.create_parameter(
        attr=helper.param_attr, shape=[filter_size * input.shape[-1],
                                       num_filters], dtype=dtype)
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="sequence_conv",
        inputs={"X": [input], "Filter": [filter_param]},
        outputs={"Out": [pre_bias]},
        attrs={"contextStride": filter_stride,
               "contextStart": -int(filter_size // 2),
               "contextLength": filter_size})
    pre_act = helper.append_bias_op(pre_bias, dim_start=2)
    return helper.append_activation(pre_act)


def row_conv(input, future_context_size, param_attr=None, act=None):
    helper = LayerHelper("row_conv", param_attr=param_attr, act=act)
    dtype = input.dtype
    filter_param = helper.create_parameter(
        attr=helper.param_attr,
        shape=[future_context_size + 1, input.shape[-1]], dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="row_conv",
                     inputs={"X": [input], "Filter": [filter_param]},
                     outputs={"Out": [out]})
    return helper.append_activation(out)


def im2sequence(input, filter_size=1, stride=1, padding=0,
                input_image_size=None, out_stride=1, name=None):
    helper = LayerHelper("im2sequence")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    fs = filter_size if isinstance(filter_size, (list, tuple)) else [
        filter_size, filter_size]
    st = stride if isinstance(stride, (list, tuple)) else [stride, stride]
    pd = padding if isinstance(padding, (list, tuple)) else [padding] * 4
    helper.append_op(type="im2sequence", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"kernels": fs, "strides": st, "paddings": pd})
    return out


# ---------------------------------------------------------------------------
# the op corpus's layers (``nn.py``): activations with attrs, reductions,
# products, padding and data movement, the transposed convolution and
# group norm; each appends the reference's op, slots and attrs
# ---------------------------------------------------------------------------
def _unary_attr_layer(op_type, x, attrs, name=None):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type=op_type, inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs=attrs)
    return out


def relu6(x, threshold=6.0, name=None):
    return _unary_attr_layer("relu6", x, {"threshold": threshold}, name)


def leaky_relu(x, alpha=0.02, name=None):
    return _unary_attr_layer("leaky_relu", x, {"alpha": alpha}, name)


def elu(x, alpha=1.0, name=None):
    return _unary_attr_layer("elu", x, {"alpha": alpha}, name)


def swish(x, beta=1.0, name=None):
    return _unary_attr_layer("swish", x, {"beta": beta}, name)


def hard_sigmoid(x, slope=0.2, offset=0.5, name=None):
    return _unary_attr_layer("hard_sigmoid", x,
                             {"slope": slope, "offset": offset}, name)


def hard_swish(x, threshold=6.0, scale=6.0, offset=3.0, name=None):
    return _unary_attr_layer(
        "hard_swish", x,
        {"threshold": threshold, "scale": scale, "offset": offset}, name)


def brelu(x, t_min=0.0, t_max=24.0, name=None):
    return _unary_attr_layer("brelu", x, {"t_min": t_min, "t_max": t_max},
                             name)


def soft_relu(x, threshold=40.0, name=None):
    return _unary_attr_layer("soft_relu", x, {"threshold": threshold}, name)


def pow(x, factor=1.0, name=None):
    return _unary_attr_layer("pow", x, {"factor": factor}, name)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return _unary_attr_layer("stanh", x,
                             {"scale_a": scale_a, "scale_b": scale_b}, name)


def sign(x):
    return _unary_attr_layer("sign", x, {})


def prelu(x, mode, param_attr=None, name=None):
    """max(x, 0) + α·min(x, 0) with a learnable α (``nn.py:671``): one
    (``all``), one a channel (``channel``) or one an element of x's
    trailing dims (``element``), created at 0.25."""
    helper = LayerHelper("prelu", **locals())
    alpha_shape = [1]
    if mode == "channel":
        alpha_shape = [1, x.shape[1], 1, 1]
    elif mode == "element":
        alpha_shape = list(x.shape[1:])
    alpha = helper.create_parameter(
        attr=helper.param_attr, shape=alpha_shape, dtype="float32",
        is_bias=False, default_initializer=Constant(0.25))
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="prelu", inputs={"X": [x], "Alpha": [alpha]},
                     outputs={"Out": [out]}, attrs={"mode": mode})
    return out


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    helper = LayerHelper("l2_normalize", **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    norm = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="l2_normalize", inputs={"X": [x]},
                     outputs={"Out": [out], "Norm": [norm]},
                     attrs={"axis": axis, "epsilon": epsilon})
    return out


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper("mul", **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="mul", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"x_num_col_dims": x_num_col_dims,
                            "y_num_col_dims": y_num_col_dims})
    return out


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper("clip_by_norm", **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="clip_by_norm", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"max_norm": float(max_norm)})
    return out


def reduce_max(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_max", input, dim, keep_dim, name)


def reduce_min(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_min", input, dim, keep_dim, name)


def reduce_prod(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_prod", input, dim, keep_dim, name)


def reduce_all(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_all", input, dim, keep_dim, name)


def reduce_any(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_any", input, dim, keep_dim, name)


def flatten(x, axis=1, name=None):
    helper = LayerHelper("flatten2", **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    x_shape = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="flatten2", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [x_shape]},
                     attrs={"axis": axis})
    return out


def stack(x, axis=0):
    helper = LayerHelper("stack")
    if isinstance(x, Variable):
        x = [x]
    out = helper.create_variable_for_type_inference(dtype=x[0].dtype)
    helper.append_op(type="stack", inputs={"X": x}, outputs={"Y": [out]},
                     attrs={"axis": axis})
    return out


def unstack(x, axis=0, num=None):
    helper = LayerHelper("unstack")
    if num is None:
        num = x.shape[axis]
    outs = [helper.create_variable_for_type_inference(dtype=x.dtype)
            for _ in range(num)]
    helper.append_op(type="unstack", inputs={"X": [x]}, outputs={"Y": outs},
                     attrs={"axis": axis, "num": num})
    return outs


def scatter(input, index, updates, name=None, overwrite=True):
    helper = LayerHelper("scatter", **locals())
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type="scatter",
        inputs={"X": [input], "Ids": [index], "Updates": [updates]},
        outputs={"Out": [out]}, attrs={"overwrite": overwrite})
    return out


def shape(input):
    """Input's shape as an int32 [rank] tensor (``nn.py:1026``)."""
    helper = LayerHelper("shape")
    out = helper.create_variable_for_type_inference(
        dtype=core.VarDesc.VarType.INT32)
    helper.append_op(type="shape", inputs={"Input": [input]},
                     outputs={"Out": [out]})
    return out


def pad(x, paddings, pad_value=0.0, name=None):
    helper = LayerHelper("pad", **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="pad", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"paddings": list(paddings),
                            "pad_value": float(pad_value)})
    return out


def pad2d(input, paddings=(0, 0, 0, 0), mode="constant", pad_value=0.0,
          data_format="NCHW", name=None):
    helper = LayerHelper("pad2d", **locals())
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type="pad2d", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"paddings": list(paddings), "mode": mode,
                            "pad_value": float(pad_value),
                            "data_format": data_format})
    return out


def maxout(x, groups, name=None):
    helper = LayerHelper("maxout", **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="maxout", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"groups": groups})
    return out


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    helper = LayerHelper("unfold", **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        type="unfold", inputs={"X": [x]}, outputs={"Y": [out]},
        attrs={"kernel_sizes": _pair(kernel_sizes),
               "strides": _pair(strides),
               "paddings": list(paddings if isinstance(paddings, (list, tuple))
                                else [paddings] * 4),
               "dilations": _pair(dilations)})
    return out


def cos_sim(X, Y):
    """The rows' cosine similarity (``nn.py:1555``)."""
    helper = LayerHelper("cos_sim")
    out = helper.create_variable_for_type_inference(dtype=X.dtype)
    xnorm = helper.create_variable_for_type_inference(dtype=X.dtype)
    ynorm = helper.create_variable_for_type_inference(dtype=X.dtype)
    helper.append_op(type="cos_sim", inputs={"X": [X], "Y": [Y]},
                     outputs={"Out": [out], "XNorm": [xnorm],
                              "YNorm": [ynorm]})
    return out


def logical_or(x, y, out=None, name=None):
    return _logical("logical_or", x, y, out, name)


def logical_xor(x, y, out=None, name=None):
    return _logical("logical_xor", x, y, out, name)


def adaptive_pool2d(input, pool_size, pool_type="max", require_index=False,
                    name=None):
    """``pool2d`` with ``adaptive`` set (``nn.py:358``)."""
    helper = LayerHelper("adaptive_pool2d", **locals())
    out = helper.create_variable_for_type_inference(helper.input_dtype())
    helper.append_op(type="pool2d", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"pooling_type": pool_type,
                            "ksize": _pair(pool_size), "adaptive": True})
    return out


def uniform_random_batch_size_like(input, shape, dtype="float32",
                                   input_dim_idx=0, output_dim_idx=0,
                                   min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random_batch_size_like", **locals())
    dt = core.np_to_dtype(np.dtype(dtype))
    out = helper.create_variable_for_type_inference(dt)
    helper.append_op(
        type="uniform_random_batch_size_like", inputs={"Input": [input]},
        outputs={"Out": [out]},
        attrs={"shape": list(shape), "input_dim_idx": input_dim_idx,
               "output_dim_idx": output_dim_idx, "min": min, "max": max,
               "seed": seed, "dtype": dt})
    return out


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32"):
    helper = LayerHelper("gaussian_random")
    dt = core.np_to_dtype(np.dtype(dtype))
    out = helper.create_variable_for_type_inference(dt)
    helper.append_op(type="gaussian_random", outputs={"Out": [out]},
                     attrs={"shape": list(shape), "mean": mean, "std": std,
                            "seed": seed, "dtype": dt})
    return out


def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="float32"):
    helper = LayerHelper("sampling_id")
    out = helper.create_variable_for_type_inference(
        core.VarDesc.VarType.INT64)
    helper.append_op(type="sampling_id", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"min": min, "max": max, "seed": seed})
    return out


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=None,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None):
    """The transposed 2-D convolution (``nn.py:272``): Filter
    [C_in, num_filters/groups, kh, kw]; ``output_size`` without
    ``filter_size`` sets the filter size that gives it."""
    helper = LayerHelper("conv2d_transpose", **locals())
    dtype = helper.input_dtype()
    num_channels = input.shape[1]
    groups = groups or 1
    stride = _pair(stride)
    padding = _pair(padding)
    dilation = _pair(dilation)
    if filter_size is None:
        if output_size is None:
            raise ValueError("filter_size or output_size must be set")
        output_size = _pair(output_size)
        filter_size = [
            output_size[0] - (input.shape[2] - 1) * stride[0]
            + 2 * padding[0],
            output_size[1] - (input.shape[3] - 1) * stride[1]
            + 2 * padding[1],
        ]
    else:
        filter_size = _pair(filter_size)
    w = helper.create_parameter(
        attr=helper.param_attr,
        shape=[num_channels, num_filters // groups] + filter_size,
        dtype=dtype)
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="conv2d_transpose", inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [pre_bias]},
        attrs={"strides": stride, "paddings": padding,
               "dilations": dilation, "groups": groups})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None,
               act=None, data_layout="NCHW", name=None):
    """Group normalization (``nn.py:495``): scale created at 1 and bias
    at 0, one a channel (either omitted with ``False``)."""
    helper = LayerHelper("group_norm", **locals())
    dtype = helper.input_dtype()
    channels = input.shape[1]
    inputs = {"X": [input]}
    if param_attr is not False:
        inputs["Scale"] = [helper.create_parameter(
            attr=helper.param_attr, shape=[channels], dtype=dtype,
            default_initializer=Constant(1.0))]
    if bias_attr is not False:
        inputs["Bias"] = [helper.create_parameter(
            attr=helper.bias_attr, shape=[channels], dtype=dtype,
            is_bias=True)]
    mean_out = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    variance_out = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="group_norm", inputs=inputs,
                     outputs={"Y": [out], "Mean": [mean_out],
                              "Variance": [variance_out]},
                     attrs={"epsilon": epsilon, "groups": groups})
    return helper.append_activation(out)


def instance_norm(input, epsilon=1e-5, param_attr=None, bias_attr=None,
                  name=None):
    """Instance normalization (``nn.py:528``): scale created at 1 and
    bias at 0, one a channel; SavedMean / SavedVariance kept out of the
    gradient."""
    helper = LayerHelper("instance_norm", **locals())
    dtype = helper.input_dtype()
    channels = input.shape[1]
    scale = helper.create_parameter(
        attr=helper.param_attr, shape=[channels], dtype=dtype,
        default_initializer=Constant(1.0))
    bias = helper.create_parameter(attr=helper.bias_attr, shape=[channels],
                                   dtype=dtype, is_bias=True)
    saved_mean = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    saved_var = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="instance_norm",
                     inputs={"X": [input], "Scale": [scale], "Bias": [bias]},
                     outputs={"Y": [out], "SavedMean": [saved_mean],
                              "SavedVariance": [saved_var]},
                     attrs={"epsilon": epsilon})
    return out


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    """Local response normalization over ``n`` channels (``nn.py:1064``)."""
    helper = LayerHelper("lrn", **locals())
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    mid = helper.create_variable_for_type_inference(dtype=input.dtype,
                                                    stop_gradient=True)
    helper.append_op(type="lrn", inputs={"X": [input]},
                     outputs={"Out": [out], "MidOut": [mid]},
                     attrs={"n": n, "k": k, "alpha": alpha, "beta": beta})
    return out


def image_resize(input, out_shape=None, scale=None, name=None,
                 resample="BILINEAR", actual_shape=None, align_corners=True,
                 align_mode=1):
    """``bilinear_interp`` (``resample`` "BILINEAR") or
    ``nearest_interp`` of NCHW ``input`` to ``out_shape`` [h, w], or by
    ``scale`` (``nn.py:1115``; ``actual_shape`` is not read, as
    there)."""
    op_type = "bilinear_interp" if resample == "BILINEAR" else \
        "nearest_interp"
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    attrs = {"out_h": out_shape[0] if out_shape else 0,
             "out_w": out_shape[1] if out_shape else 0,
             "scale": scale or 0.0, "align_corners": align_corners,
             "align_mode": align_mode}
    helper.append_op(type=op_type, inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs=attrs)
    return out


def resize_bilinear(input, out_shape=None, scale=None, name=None, **kwargs):
    return image_resize(input, out_shape, scale, name, "BILINEAR", **kwargs)


def resize_nearest(input, out_shape=None, scale=None, name=None, **kwargs):
    return image_resize(input, out_shape, scale, name, "NEAREST", **kwargs)


def grid_sampler(x, grid, name=None):
    """Bilinear sampling of ``x`` at ``grid`` (``nn.py:1287``)."""
    helper = LayerHelper("grid_sampler", **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="grid_sampler", inputs={"X": [x], "Grid": [grid]},
                     outputs={"Output": [out]})
    return out


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None, path_table=None, path_code=None, is_custom=False,
             is_sparse=False):
    """Hierarchical sigmoid loss (``nn.py:1839``): W [num_classes − 1, D]
    for the default tree (num_classes rows for a custom one), a bias
    [rows, 1] unless ``bias_attr`` is False."""
    helper = LayerHelper("hsigmoid", **locals())
    dtype = helper.input_dtype()
    num_nodes = num_classes - 1 if not is_custom else num_classes
    w = helper.create_parameter(attr=param_attr,
                                shape=[max(num_nodes, 1), input.shape[-1]],
                                dtype=dtype)
    inputs = {"X": [input], "Label": [label], "W": [w]}
    if bias_attr is not False:
        inputs["Bias"] = [helper.create_parameter(
            attr=bias_attr, shape=[max(num_nodes, 1), 1], dtype=dtype,
            is_bias=True)]
    if path_table is not None:
        inputs["PathTable"] = [path_table]
    if path_code is not None:
        inputs["PathCode"] = [path_code]
    out = helper.create_variable_for_type_inference(dtype)
    pre_out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="hierarchical_sigmoid", inputs=inputs,
                     outputs={"Out": [out], "PreOut": [pre_out]},
                     attrs={"num_classes": num_classes,
                            "is_sparse": is_sparse})
    return out


def nce(input, label, num_total_classes, sample_weight=None,
        param_attr=None, bias_attr=None, num_neg_samples=None, name=None,
        sampler="uniform", custom_dist=None, seed=0, is_sparse=False):
    """Noise-contrastive estimation cost (``nn.py:1882``): Weight
    [classes, D], a bias [classes, 1] unless ``bias_attr`` is False; a
    ``custom_dist`` becomes a persistable [classes] variable assigned
    from it."""
    helper = LayerHelper("nce", **locals())
    dtype = helper.input_dtype()
    w = helper.create_parameter(attr=param_attr,
                                shape=[num_total_classes, input.shape[-1]],
                                dtype=dtype)
    inputs = {"Input": [input], "Label": [label], "Weight": [w]}
    if sample_weight is not None:
        inputs["SampleWeight"] = [sample_weight]
    if bias_attr is not False:
        inputs["Bias"] = [helper.create_parameter(
            attr=bias_attr, shape=[num_total_classes, 1], dtype=dtype,
            is_bias=True)]
    if custom_dist is not None:
        from .tensor import assign

        probs = helper.main_program.current_block().create_var(
            name=helper.name + "_custom_dist", dtype=dtype,
            shape=[num_total_classes], persistable=True)
        assign(np.asarray(custom_dist, dtype=np.float32), output=probs)
        inputs["CustomDistProbs"] = [probs]
    cost = helper.create_variable_for_type_inference(dtype)
    sample_logits = helper.create_variable_for_type_inference(dtype)
    sample_labels = helper.create_variable_for_type_inference("int64")
    helper.append_op(
        type="nce", inputs=inputs,
        outputs={"Cost": [cost], "SampleLogits": [sample_logits],
                 "SampleLabels": [sample_labels]},
        attrs={"num_total_classes": num_total_classes,
               "num_neg_samples": num_neg_samples or 10, "seed": seed,
               "sampler": {"uniform": 0, "log_uniform": 1,
                           "custom_dist": 2}[sampler],
               "is_sparse": is_sparse})
    return cost
