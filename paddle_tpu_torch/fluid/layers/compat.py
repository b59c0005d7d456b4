"""The reference's ``layers/compat.py`` names whose ops the port lowers
(``paddle_tpu/fluid/layers/compat.py``): single-op layers and the
compositions (``dice_loss``, ``fsp_matrix``, ``mse_loss``, ``rank``)
built from the same public layers as there."""

import numpy as np

from ..initializer import Xavier
from ..layer_helper import LayerHelper

__all__ = ["lod_reset", "gather_tree", "add_position_encoding",
           "bilinear_tensor_product", "dice_loss", "eye", "fsp_matrix",
           "gaussian_random_batch_size_like", "mse_loss", "random_crop",
           "rank", "similarity_focus", "size", "sum",
           "tensor_array_to_tensor", "uniform_random",
           "continuous_value_model", "ctc_greedy_decoder",
           "image_resize_short", "mean_iou", "teacher_student_sigmoid_loss"]


def _single_out(op_type, inputs, attrs=None, dtype="float32",
                out_slot="Out"):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(type=op_type, inputs=inputs,
                     outputs={out_slot: [out]}, attrs=attrs or {})
    return out


def gather_tree(ids, parents):
    """Beam-search backtrace (reference nn.py:17617, gather_tree_op.cc)."""
    return _single_out("gather_tree", {"Ids": [ids], "Parents": [parents]},
                       dtype=ids.dtype)


def lod_reset(x, y=None, target_lod=None):
    """reference nn.py:9146 over lod_reset_op.cc."""
    helper = LayerHelper("lod_reset")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    inputs = {"X": [x]}
    attrs = {}
    if y is not None:
        inputs["Y"] = [y]
    elif target_lod is not None:
        attrs["target_lod"] = [int(v) for v in target_lod]
    else:
        raise ValueError("y and target_lod should not be both none")
    helper.append_op(type="lod_reset", inputs=inputs,
                     outputs={"Out": [out]}, attrs=attrs)
    return out


def add_position_encoding(input, alpha, beta, name=None):
    return _single_out("add_position_encoding", {"X": [input]},
                       {"alpha": float(alpha), "beta": float(beta)},
                       dtype=input.dtype)


def bilinear_tensor_product(x, y, size, act=None, name=None,
                            param_attr=None, bias_attr=None):
    """out_k = x·W_k·yᵀ + b_k (``nn.py:15890``); W [size, M, N] Xavier."""
    helper = LayerHelper("bilinear_tensor_product", **locals())
    dtype = helper.input_dtype("x")
    w = helper.create_parameter(
        attr=helper.param_attr, shape=[size, x.shape[-1], y.shape[-1]],
        dtype=dtype, default_initializer=Xavier())
    out = helper.create_variable_for_type_inference(dtype=dtype)
    inputs = {"X": [x], "Y": [y], "Weight": [w]}
    if helper.bias_attr is not False:
        inputs["Bias"] = [helper.create_parameter(
            attr=helper.bias_attr, shape=[1, size], dtype=dtype,
            is_bias=True)]
    helper.append_op(type="bilinear_tensor_product", inputs=inputs,
                     outputs={"Out": [out]})
    return helper.append_activation(out)


def dice_loss(input, label, epsilon=1e-5, name=None):
    """1 − 2·|X∩Y|/(|X| + |Y|), averaged over the batch (``nn.py:9745``)."""
    from . import nn as _nn
    from .tensor import cast

    label = cast(label, "float32") if label.dtype != input.dtype else label
    dims = list(range(1, len(input.shape)))
    inse = _nn.reduce_sum(_nn.elementwise_mul(input, label), dim=dims)
    denominator = _nn.elementwise_add(_nn.reduce_sum(input, dim=dims),
                                      _nn.reduce_sum(label, dim=dims))
    score = _nn.scale(
        _nn.elementwise_div(_nn.scale(inse, scale=2.0),
                            _nn.scale(denominator, scale=1.0,
                                      bias=epsilon)),
        scale=-1.0, bias=1.0)
    return _nn.reduce_mean(score, dim=[0])


def eye(num_rows, num_columns=None, batch_shape=None, dtype="float32"):
    """The identity (``tensor.py:1336``); ``batch_shape`` prepends dims
    by unsqueeze and expand, as the reference does."""
    from . import nn as _nn

    out = _single_out("eye", {}, {
        "num_rows": num_rows,
        "num_columns": num_columns if num_columns is not None else num_rows,
        "dtype": dtype}, dtype=dtype)
    if batch_shape is not None:
        for _ in batch_shape:
            out = _nn.unsqueeze(out, axes=[0])
        out = _nn.expand(out, expand_times=list(batch_shape) + [1, 1])
    return out


def fsp_matrix(x, y):
    """x [B, C1, H, W], y [B, C2, H, W] -> [B, C1, C2] = mean over H·W of
    x·y, as reshape, matmul and scale (``nn.py:16696``)."""
    from . import nn as _nn

    c1, c2 = x.shape[1], y.shape[1]
    hw = int(np.prod(x.shape[2:]))
    xf = _nn.reshape(x, shape=[0, c1, hw])
    yf = _nn.reshape(y, shape=[0, c2, hw])
    out = _nn.matmul(xf, _nn.transpose(yf, perm=[0, 2, 1]))
    return _nn.scale(out, scale=1.0 / hw)


def gaussian_random_batch_size_like(input, shape, input_dim_idx=0,
                                    output_dim_idx=0, mean=0.0, std=1.0,
                                    dtype="float32"):
    from .. import core

    return _single_out(
        "gaussian_random_batch_size_like", {"Input": [input]},
        {"shape": list(shape), "input_dim_idx": input_dim_idx,
         "output_dim_idx": output_dim_idx, "mean": mean, "std": std,
         "dtype": core.np_to_dtype(np.dtype(dtype))}, dtype=dtype)


def mse_loss(input, label):
    """The mean of the squared error (``nn.py:17692``)."""
    from . import nn as _nn
    from .loss import square_error_cost

    return _nn.reduce_mean(square_error_cost(input, label))


def random_crop(x, shape, seed=None):
    """Each sample cropped to ``shape`` at a random offset
    (``nn.py:11156``); the draw comes from the run's generator, the
    ``seed`` taken for the reference's signature."""
    return _single_out("random_crop", {"X": [x]}, {"shape": list(shape)},
                       dtype=x.dtype)


def rank(input):
    """The number of dims as an int32 [1], a constant of the program
    (``nn.py:13877``)."""
    from .tensor import assign

    return assign(np.array([len(input.shape)], dtype="int32"))


def similarity_focus(input, axis, indexes, name=None):
    return _single_out("similarity_focus", {"X": [input]},
                       {"axis": axis, "indexes": list(indexes)},
                       dtype=input.dtype)


def size(input):
    return _single_out("size", {"Input": [input]}, dtype="int64")


def sum(x):
    """The sum of a list of tensors (one passes through the op too)."""
    xs = x if isinstance(x, (list, tuple)) else [x]
    return _single_out("sum", {"X": list(xs)}, dtype=xs[0].dtype)


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0,
                   name=None):
    from .. import core

    return _single_out(
        "uniform_random", {},
        {"shape": [int(s) for s in shape], "min": float(min),
         "max": float(max), "seed": seed,
         "dtype": core.np_to_dtype(np.dtype(dtype))}, dtype=dtype)


def tensor_array_to_tensor(input, axis=1, name=None, use_stack=False):
    """A LoD array joined (or stacked) along ``axis``, and each step's
    extent there (int32); -> (out, out_index)."""
    helper = LayerHelper("tensor_array_to_tensor")
    out = helper.create_variable_for_type_inference(
        dtype=getattr(input, "dtype", "float32"))
    out_index = helper.create_variable_for_type_inference(dtype="int32")
    helper.append_op(type="tensor_array_to_tensor", inputs={"X": [input]},
                     outputs={"Out": [out], "OutIndex": [out_index]},
                     attrs={"axis": axis, "use_stack": use_stack})
    return out, out_index


def continuous_value_model(input, cvm, use_cvm=True):
    """The ``cvm`` op (``nn.py:16746``)."""
    return _single_out("cvm", {"X": [input], "CVM": [cvm]},
                       {"use_cvm": use_cvm}, dtype=input.dtype, out_slot="Y")


def ctc_greedy_decoder(input, blank, name=None):
    """``arg_max`` over the classes, then ``ctc_align`` (repeats merged,
    blanks dropped): the padded [B, T] form of the reference's LoD
    result (``nn.py:7231``), its lengths in the ``@SEQ_LEN`` companion."""
    helper = LayerHelper("ctc_greedy_decoder")
    topk = helper.create_variable_for_type_inference(dtype="int64")
    helper.append_op(type="arg_max", inputs={"X": [input]},
                     outputs={"Out": [topk]},
                     attrs={"axis": -1, "keepdims": False})
    out = helper.create_variable_for_type_inference(dtype="int64")
    helper.append_op(type="ctc_align", inputs={"Input": [topk]},
                     outputs={"Output": [out]},
                     attrs={"blank": blank, "merge_repeated": True})
    return out


def image_resize_short(input, out_short_len, resample="BILINEAR"):
    """``image_resize`` so the short side is ``out_short_len``, keeping
    the aspect ratio (``nn.py:10683``)."""
    from . import nn as _nn

    h, w = int(input.shape[2]), int(input.shape[3])
    short = min(h, w)
    out_shape = [int(round(h * out_short_len / short)),
                 int(round(w * out_short_len / short))]
    return _nn.image_resize(input, out_shape=out_shape, resample=resample)


def mean_iou(input, label, num_classes):
    """The ``mean_iou`` op (``nn.py:11351``): (mean IoU float32 [1],
    wrong int32 [num_classes], correct int32 [num_classes])."""
    helper = LayerHelper("mean_iou")
    miou = helper.create_variable_for_type_inference(dtype="float32")
    wrong = helper.create_variable_for_type_inference(dtype="int32")
    correct = helper.create_variable_for_type_inference(dtype="int32")
    helper.append_op(type="mean_iou",
                     inputs={"Predictions": [input], "Labels": [label]},
                     outputs={"OutMeanIou": [miou], "OutWrong": [wrong],
                              "OutCorrect": [correct]},
                     attrs={"num_classes": num_classes})
    return miou, wrong, correct


def teacher_student_sigmoid_loss(input, label, soft_max_up_bound=15.0,
                                 soft_max_lower_bound=-15.0):
    """The ``teacher_student_sigmoid_loss`` op (``loss.py``)."""
    return _single_out("teacher_student_sigmoid_loss",
                       {"X": [input], "Label": [label]},
                       {"soft_max_up_bound": soft_max_up_bound,
                        "soft_max_lower_bound": soft_max_lower_bound},
                       dtype=input.dtype, out_slot="Y")
