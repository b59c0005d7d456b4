"""Neural-network layer functions the GPT, BERT, LeNet and ResNet
programs use (port of the matching functions of
``paddle_tpu/fluid/layers/nn.py``, names and signatures as there; each
builds ops through LayerHelper.append_op), the KV-cache and decode
attention layers of the serving programs included.
"""

import numpy as np

from .. import core
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
