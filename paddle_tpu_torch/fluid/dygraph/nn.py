"""The dygraph layers (port of ``paddle_tpu/fluid/dygraph/nn.py``;
reference: python/paddle/fluid/dygraph/nn.py): Conv2D, Pool2D, Linear,
FC, BatchNorm, Embedding, LayerNorm, Dropout, GRUUnit, SequenceConv and
RowConv trace the op lowerings the static engine runs; SpectralNorm
computes on its weight's tensor, outside any op, as the reference's does.
PRelu, GroupNorm, Conv3D, Conv2DTranspose, Conv3DTranspose, NCE,
BilinearTensorProduct and TreeConv trace ops that the port does not
lower yet, so their forward raises the registry's error, which names the
op (ROADMAP A16)."""

import numpy as np
import torch

from ..framework import _dygraph_tracer
from ..initializer import Constant, Normal
from .layers import Layer
from .tracer import VarBase, _to_tensor


def _trace(type, inputs, outputs, attrs):
    return _dygraph_tracer().trace_op(type, inputs, outputs, attrs)


# Conv2D is defined after _ConvNd below (it is the 2-D instance of the
# shared conv base); this placeholder keeps declaration order readable.


class Pool2D(Layer):
    def __init__(
        self,
        name_scope,
        pool_size=-1,
        pool_type="max",
        pool_stride=1,
        pool_padding=0,
        global_pooling=False,
        use_cudnn=True,
        ceil_mode=False,
        exclusive=True,
        dtype="float32",
    ):
        super().__init__(name_scope, dtype)
        self._attrs = {
            "pooling_type": pool_type,
            "ksize": _pair(pool_size),
            "global_pooling": global_pooling,
            "strides": _pair(pool_stride),
            "paddings": _pair(pool_padding),
            "ceil_mode": ceil_mode,
            "exclusive": exclusive,
        }

    def forward(self, input):
        return _trace("pool2d", {"X": [input]}, {"Out": 1}, self._attrs)["Out"][0]


class Linear(Layer):
    def __init__(self, input_dim, output_dim, param_attr=None, bias_attr=None,
                 act=None, dtype="float32"):
        super().__init__("linear", dtype)
        self.weight = self.create_parameter(
            param_attr, [input_dim, output_dim], dtype
        )
        self.bias = (
            None
            if bias_attr is False
            else self.create_parameter(bias_attr, [output_dim], dtype, is_bias=True)
        )
        self._act = act

    def forward(self, input):
        out = _trace(
            "matmul", {"X": [input], "Y": [self.weight]}, {"Out": 1}, {}
        )["Out"][0]
        if self.bias is not None:
            out = _trace(
                "elementwise_add",
                {"X": [out], "Y": [self.bias]},
                {"Out": 1},
                {"axis": len(out.shape) - 1},
            )["Out"][0]
        if self._act:
            out = _trace(self._act, {"X": [out]}, {"Out": 1}, {})["Out"][0]
        return out


class FC(Layer):
    """reference: dygraph/nn.py FC (pre-Linear API, uses mul + sum)."""

    def __init__(self, name_scope, size, num_flatten_dims=1, param_attr=None,
                 bias_attr=None, act=None, is_test=False, dtype="float32"):
        super().__init__(name_scope, dtype)
        self._size = size
        self._num_flatten_dims = num_flatten_dims
        self._param_attr = param_attr
        self._bias_attr = bias_attr
        self._act = act
        self.weight = None
        self.bias = None

    def _build_once(self, input):
        input_shape = input.shape
        param_shape = [
            int(np.prod(input_shape[self._num_flatten_dims:])),
            self._size,
        ]
        self.weight = self.create_parameter(
            self._param_attr, param_shape, self._dtype
        )
        if self._bias_attr is not False:
            self.bias = self.create_parameter(
                self._bias_attr, [self._size], self._dtype, is_bias=True
            )

    def forward(self, input):
        if self.weight is None:
            self._build_once(input)
        out = _trace(
            "mul",
            {"X": [input], "Y": [self.weight]},
            {"Out": 1},
            {"x_num_col_dims": self._num_flatten_dims, "y_num_col_dims": 1},
        )["Out"][0]
        if self.bias is not None:
            out = _trace(
                "elementwise_add",
                {"X": [out], "Y": [self.bias]},
                {"Out": 1},
                {"axis": self._num_flatten_dims},
            )["Out"][0]
        if self._act:
            out = _trace(self._act, {"X": [out]}, {"Out": 1}, {})["Out"][0]
        return out


class BatchNorm(Layer):
    def __init__(
        self,
        name_scope,
        num_channels,
        act=None,
        is_test=False,
        momentum=0.9,
        epsilon=1e-5,
        param_attr=None,
        bias_attr=None,
        dtype="float32",
        data_layout="NCHW",
        use_global_stats=False,
        trainable_statistics=False,
    ):
        super().__init__(name_scope, dtype)
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_layout = data_layout
        self._use_global_stats = use_global_stats
        self._act = act
        self.weight = self.create_parameter(
            param_attr, [num_channels], dtype, default_initializer=Constant(1.0)
        )
        self.bias = self.create_parameter(
            bias_attr, [num_channels], dtype, is_bias=True
        )
        self._mean = self.create_parameter(
            None, [num_channels], dtype, default_initializer=Constant(0.0)
        )
        self._mean.stop_gradient = True
        self._mean.trainable = False
        self._variance = self.create_parameter(
            None, [num_channels], dtype, default_initializer=Constant(1.0)
        )
        self._variance.stop_gradient = True
        self._variance.trainable = False

    def forward(self, input):
        outs = _trace(
            "batch_norm",
            {
                "X": [input],
                "Scale": [self.weight],
                "Bias": [self.bias],
                "Mean": [self._mean],
                "Variance": [self._variance],
            },
            {
                "Y": 1,
                "MeanOut": [self._mean],
                "VarianceOut": [self._variance],
                "SavedMean": 1,
                "SavedVariance": 1,
            },
            {
                "momentum": self._momentum,
                "epsilon": self._epsilon,
                "is_test": not self.training,
                "data_layout": self._data_layout,
                "use_global_stats": self._use_global_stats,
            },
        )
        out = outs["Y"][0]
        if self._act:
            out = _trace(self._act, {"X": [out]}, {"Out": 1}, {})["Out"][0]
        return out


class Embedding(Layer):
    def __init__(self, name_scope=None, size=None, is_sparse=False,
                 is_distributed=False, padding_idx=None, param_attr=None,
                 dtype="float32"):
        super().__init__(name_scope or "embedding", dtype)
        self._size = size
        self._padding_idx = -1 if padding_idx is None else padding_idx
        self.weight = self.create_parameter(param_attr, size, dtype)

    def forward(self, input):
        return _trace(
            "lookup_table",
            {"Ids": [input], "W": [self.weight]},
            {"Out": 1},
            {"padding_idx": self._padding_idx},
        )["Out"][0]


class LayerNorm(Layer):
    def __init__(self, name_scope, scale=True, shift=True, begin_norm_axis=1,
                 epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
                 dtype="float32", normalized_shape=None):
        super().__init__(name_scope, dtype)
        self._begin_norm_axis = begin_norm_axis
        self._epsilon = epsilon
        self._act = act
        self._scale = scale
        self._shift = shift
        self._param_attr = param_attr
        self._bias_attr = bias_attr
        self.weight = None
        self.bias = None

    def forward(self, input):
        if self.weight is None and self._scale:
            n = int(np.prod(input.shape[self._begin_norm_axis:]))
            self.weight = self.create_parameter(
                self._param_attr, [n], self._dtype,
                default_initializer=Constant(1.0),
            )
            if self._shift:
                self.bias = self.create_parameter(
                    self._bias_attr, [n], self._dtype, is_bias=True
                )
        inputs = {"X": [input]}
        if self.weight is not None:
            inputs["Scale"] = [self.weight]
        if self.bias is not None:
            inputs["Bias"] = [self.bias]
        outs = _trace(
            "layer_norm",
            inputs,
            {"Y": 1, "Mean": 1, "Variance": 1},
            {
                "begin_norm_axis": self._begin_norm_axis,
                "epsilon": self._epsilon,
            },
        )
        out = outs["Y"][0]
        if self._act:
            out = _trace(self._act, {"X": [out]}, {"Out": 1}, {})["Out"][0]
        return out


class Dropout(Layer):
    def __init__(self, p=0.5, dropout_implementation="downgrade_in_infer"):
        super().__init__("dropout")
        self._p = p
        self._impl = dropout_implementation

    def forward(self, input):
        return _trace(
            "dropout",
            {"X": [input]},
            {"Out": 1, "Mask": 1},
            {
                "dropout_prob": self._p,
                "is_test": not self.training,
                "dropout_implementation": self._impl,
            },
        )["Out"][0]


class PRelu(Layer):
    def __init__(self, name_scope, mode, param_attr=None, channel=None,
                 input_shape=None, dtype="float32"):
        super().__init__(name_scope, dtype)
        self._mode = mode
        shape = [1]
        if mode == "channel" and channel:
            shape = [1, channel, 1, 1]
        elif mode == "element" and input_shape:
            shape = list(input_shape[1:])
        self.weight = self.create_parameter(
            param_attr, shape, dtype, default_initializer=Constant(0.25)
        )

    def forward(self, input):
        return _trace(
            "prelu",
            {"X": [input], "Alpha": [self.weight]},
            {"Out": 1},
            {"mode": self._mode},
        )["Out"][0]


class GroupNorm(Layer):
    def __init__(self, name_scope, groups, epsilon=1e-5, param_attr=None,
                 bias_attr=None, act=None, data_layout="NCHW", channels=None,
                 dtype="float32"):
        super().__init__(name_scope, dtype)
        self._groups = groups
        self._epsilon = epsilon
        self._act = act
        self._channels = channels
        self._param_attr = param_attr
        self._bias_attr = bias_attr
        self.weight = None
        self.bias = None

    def forward(self, input):
        if self.weight is None:
            c = self._channels or input.shape[1]
            self.weight = self.create_parameter(
                self._param_attr, [c], self._dtype,
                default_initializer=Constant(1.0),
            )
            self.bias = self.create_parameter(
                self._bias_attr, [c], self._dtype, is_bias=True
            )
        outs = _trace(
            "group_norm",
            {"X": [input], "Scale": [self.weight], "Bias": [self.bias]},
            {"Y": 1, "Mean": 1, "Variance": 1},
            {"groups": self._groups, "epsilon": self._epsilon},
        )
        out = outs["Y"][0]
        if self._act:
            out = _trace(self._act, {"X": [out]}, {"Out": 1}, {})["Out"][0]
        return out


class SpectralNorm(Layer):
    """Power-iteration spectral norm (reference: dygraph/nn.py SpectralNorm /
    operators/spectral_norm_op.cc)."""

    def __init__(self, name_scope, dim=0, power_iters=1, eps=1e-12,
                 dtype="float32"):
        super().__init__(name_scope, dtype)
        self._dim = dim
        self._power_iters = power_iters
        self._eps = eps

    def forward(self, weight):
        w = weight.value
        mat = torch.movedim(w, self._dim, 0).reshape(w.shape[self._dim], -1)
        u = torch.ones((mat.shape[0],), dtype=mat.dtype, device=mat.device)
        v = None
        for _ in range(max(self._power_iters, 1)):
            v = mat.T @ u
            v = v / (torch.linalg.vector_norm(v) + self._eps)
            u = mat @ v
            u = u / (torch.linalg.vector_norm(u) + self._eps)
        sigma = u @ mat @ v
        return VarBase(w / sigma, stop_gradient=weight.stop_gradient)


def _pair(v):
    if isinstance(v, (list, tuple)):
        return [int(x) for x in v]
    return [int(v), int(v)]


def _triple(v):
    if isinstance(v, (list, tuple)):
        return [int(x) for x in v]
    return [int(v)] * 3


class _ConvNd(Layer):
    """Shared body for the conv / conv-transpose dygraph layers
    (reference dygraph/nn.py Conv3D:~ / Conv2DTranspose / Conv3DTranspose
    — same param creation, different op type and filter orientation)."""

    _op_type = None
    _transposed = False
    _nd = 2

    def __init__(self, name_scope, num_filters, filter_size, stride=1,
                 padding=0, dilation=1, groups=None, param_attr=None,
                 bias_attr=None, use_cudnn=True, act=None, dtype="float32"):
        super().__init__(name_scope, dtype)
        tile = _pair if self._nd == 2 else _triple
        self._groups = groups or 1
        self._stride = tile(stride)
        self._padding = tile(padding)
        self._dilation = tile(dilation)
        self._act = act
        self._num_filters = num_filters
        self._filter_size = tile(filter_size)
        self._param_attr = param_attr
        self._bias_attr = bias_attr
        self.weight = None
        self.bias = None

    def _build_once(self, input):
        num_channels = input.shape[1]
        if self._transposed:
            # transpose conv filters are [Cin, Cout/groups, *k]
            filter_shape = [
                num_channels, self._num_filters // self._groups,
            ] + self._filter_size
        else:
            filter_shape = [
                self._num_filters, num_channels // self._groups,
            ] + self._filter_size
        fan_in = (num_channels // self._groups) * int(
            np.prod(self._filter_size))
        std = (2.0 / max(fan_in, 1)) ** 0.5
        self.weight = self.create_parameter(
            self._param_attr, filter_shape, self._dtype,
            default_initializer=Normal(0.0, std),
        )
        if self._bias_attr is not False:
            self.bias = self.create_parameter(
                self._bias_attr, [self._num_filters], self._dtype,
                is_bias=True,
            )

    def forward(self, input):
        if self.weight is None:
            self._build_once(input)
        out = _trace(
            self._op_type,
            {"Input": [input], "Filter": [self.weight]},
            {"Output": 1},
            {
                "strides": self._stride,
                "paddings": self._padding,
                "dilations": self._dilation,
                "groups": self._groups,
            },
        )["Output"][0]
        if self.bias is not None:
            out = _trace(
                "elementwise_add", {"X": [out], "Y": [self.bias]},
                {"Out": 1}, {"axis": 1},
            )["Out"][0]
        if self._act:
            out = _trace(self._act, {"X": [out]}, {"Out": 1}, {})["Out"][0]
        return out


class Conv2D(_ConvNd):
    """reference dygraph/nn.py Conv2D over conv2d_op."""

    _op_type = "conv2d"
    _nd = 2


class Conv3D(_ConvNd):
    """reference dygraph/nn.py Conv3D over conv3d_op."""

    _op_type = "conv3d"
    _nd = 3


class Conv2DTranspose(_ConvNd):
    """reference dygraph/nn.py Conv2DTranspose over conv2d_transpose."""

    _op_type = "conv2d_transpose"
    _transposed = True
    _nd = 2


class Conv3DTranspose(_ConvNd):
    """reference dygraph/nn.py Conv3DTranspose over conv3d_transpose."""

    _op_type = "conv3d_transpose"
    _transposed = True
    _nd = 3


class GRUUnit(Layer):
    """reference dygraph/nn.py GRUUnit over gru_unit_op: one step of a
    GRU on (input [B, 3D], hidden_prev [B, D]) -> (hidden, reset_hidden,
    gate)."""

    def __init__(self, name_scope, size, param_attr=None, bias_attr=None,
                 activation="tanh", gate_activation="sigmoid",
                 origin_mode=False, dtype="float32"):
        super().__init__(name_scope, dtype)
        self._size = size  # 3 * hidden per the reference contract
        self._hidden = size // 3
        self._activation = activation
        self._gate_activation = gate_activation
        self._origin_mode = origin_mode
        self.weight = self.create_parameter(
            param_attr, [self._hidden, 3 * self._hidden], dtype)
        self.bias = self.create_parameter(
            bias_attr, [1, 3 * self._hidden], dtype, is_bias=True)

    def forward(self, input, hidden):
        outs = _trace(
            "gru_unit",
            {"Input": [input], "HiddenPrev": [hidden],
             "Weight": [self.weight], "Bias": [self.bias]},
            {"Hidden": 1, "ResetHiddenPrev": 1, "Gate": 1},
            {"activation": self._activation,
             "gate_activation": self._gate_activation,
             "origin_mode": self._origin_mode},
        )
        return (outs["Hidden"][0], outs["ResetHiddenPrev"][0],
                outs["Gate"][0])


class NCE(Layer):
    """reference dygraph/nn.py NCE over nce_op: noise-contrastive
    estimation cost on (input [B, D], label [B, T])."""

    def __init__(self, name_scope, num_total_classes, param_attr=None,
                 bias_attr=None, num_neg_samples=10, sampler="uniform",
                 custom_dist=None, seed=0, is_sparse=False,
                 dtype="float32"):
        super().__init__(name_scope, dtype)
        self._num_total_classes = num_total_classes
        self._num_neg_samples = num_neg_samples
        self._sampler = sampler
        # converted once: re-uploading the full class distribution every
        # forward would be per-step host->device traffic
        self._custom_dist = None
        if custom_dist is not None:
            self._custom_dist = VarBase(
                _to_tensor(np.asarray(custom_dist, np.float32)),
                stop_gradient=True,
            )
        self._param_attr = param_attr
        self._bias_attr = bias_attr
        self.weight = None
        self.bias = None

    def _build_once(self, input):
        dim = input.shape[-1]
        self.weight = self.create_parameter(
            self._param_attr, [self._num_total_classes, dim], self._dtype)
        if self._bias_attr is not False:
            self.bias = self.create_parameter(
                self._bias_attr, [self._num_total_classes, 1], self._dtype,
                is_bias=True)

    def forward(self, input, label, sample_weight=None):
        if self.weight is None:
            self._build_once(input)
        inputs = {"Input": [input], "Label": [label],
                  "Weight": [self.weight]}
        if self.bias is not None:
            inputs["Bias"] = [self.bias]
        if sample_weight is not None:
            inputs["SampleWeight"] = [sample_weight]
        if self._custom_dist is not None:
            inputs["CustomDistProbs"] = [self._custom_dist]
        sampler_id = {"uniform": 0, "log_uniform": 1,
                      "custom_dist": 2}[self._sampler]
        outs = _trace(
            "nce", inputs,
            {"Cost": 1, "SampleLogits": 1, "SampleLabels": 1},
            {"num_total_classes": self._num_total_classes,
             "num_neg_samples": self._num_neg_samples,
             "sampler": sampler_id},
        )
        return outs["Cost"][0]


class BilinearTensorProduct(Layer):
    """reference dygraph/nn.py BilinearTensorProduct over
    bilinear_tensor_product_op."""

    def __init__(self, name_scope, size, name=None, act=None,
                 param_attr=None, bias_attr=None, dtype="float32"):
        super().__init__(name_scope, dtype)
        self._size = size
        self._act = act
        self._param_attr = param_attr
        self._bias_attr = bias_attr
        self.weight = None
        self.bias = None

    def forward(self, x, y):
        if self.weight is None:
            self.weight = self.create_parameter(
                self._param_attr,
                [self._size, x.shape[-1], y.shape[-1]], self._dtype)
            if self._bias_attr is not False:
                self.bias = self.create_parameter(
                    self._bias_attr, [1, self._size], self._dtype,
                    is_bias=True)
        inputs = {"X": [x], "Y": [y], "Weight": [self.weight]}
        if self.bias is not None:
            inputs["Bias"] = [self.bias]
        out = _trace("bilinear_tensor_product", inputs, {"Out": 1},
                     {})["Out"][0]
        if self._act:
            out = _trace(self._act, {"X": [out]}, {"Out": 1}, {})["Out"][0]
        return out


class SequenceConv(Layer):
    """reference dygraph/nn.py SequenceConv over sequence_conv_op
    (context-window conv over [B, T, D] padded sequences here)."""

    def __init__(self, name_scope, num_filters, filter_size=3,
                 filter_stride=1, padding=None, bias_attr=None,
                 param_attr=None, act=None, dtype="float32"):
        super().__init__(name_scope, dtype)
        self._num_filters = num_filters
        self._filter_size = filter_size
        self._param_attr = param_attr
        self._bias_attr = bias_attr
        self._act = act
        self.weight = None
        self.bias = None

    def forward(self, input):
        if self.weight is None:
            d = input.shape[-1]
            self.weight = self.create_parameter(
                self._param_attr,
                [self._filter_size * d, self._num_filters], self._dtype)
            if self._bias_attr is not False:
                self.bias = self.create_parameter(
                    self._bias_attr, [self._num_filters], self._dtype,
                    is_bias=True)
        out = _trace(
            "sequence_conv",
            {"X": [input], "Filter": [self.weight]},
            {"Out": 1},
            {"contextLength": self._filter_size,
             "contextStart": -(self._filter_size // 2)},
        )["Out"][0]
        if self.bias is not None:
            out = _trace("elementwise_add", {"X": [out], "Y": [self.bias]},
                         {"Out": 1}, {"axis": -1})["Out"][0]
        if self._act:
            out = _trace(self._act, {"X": [out]}, {"Out": 1}, {})["Out"][0]
        return out


class RowConv(Layer):
    """reference dygraph/nn.py RowConv over row_conv_op (lookahead conv
    for streaming models)."""

    def __init__(self, name_scope, future_context_size, param_attr=None,
                 act=None, dtype="float32"):
        super().__init__(name_scope, dtype)
        self._future = future_context_size
        self._param_attr = param_attr
        self._act = act
        self.weight = None

    def forward(self, input):
        if self.weight is None:
            self.weight = self.create_parameter(
                self._param_attr,
                [self._future + 1, input.shape[-1]], self._dtype)
        out = _trace("row_conv", {"X": [input], "Filter": [self.weight]},
                     {"Out": 1}, {})["Out"][0]
        if self._act:
            out = _trace(self._act, {"X": [out]}, {"Out": 1}, {})["Out"][0]
        return out


class TreeConv(Layer):
    """reference dygraph/nn.py TreeConv over tree_conv_op."""

    def __init__(self, name_scope, output_size, num_filters=1, max_depth=2,
                 act="tanh", param_attr=None, bias_attr=None, name=None,
                 dtype="float32"):
        super().__init__(name_scope, dtype)
        self._output_size = output_size
        self._num_filters = num_filters
        self._max_depth = max_depth
        self._act = act
        self._param_attr = param_attr
        self._bias_attr = bias_attr
        self.weight = None
        self.bias = None

    def forward(self, nodes_vector, edge_set):
        if self.weight is None:
            feat = nodes_vector.shape[-1]
            self.weight = self.create_parameter(
                self._param_attr,
                [feat, 3, self._output_size, self._num_filters],
                self._dtype)
            if self._bias_attr is not False:
                self.bias = self.create_parameter(
                    self._bias_attr,
                    [self._num_filters], self._dtype, is_bias=True)
        out = _trace(
            "tree_conv",
            {"NodesVector": [nodes_vector], "EdgeSet": [edge_set],
             "Filter": [self.weight]},
            {"Out": 1},
            {"max_depth": self._max_depth},
        )["Out"][0]
        if self.bias is not None:
            # the op emits [B, N, output_size*num_filters]; unflatten so
            # the per-filter bias broadcasts, then restore the layout
            n = out.shape[1]
            out = _trace("reshape", {"X": [out]}, {"Out": 1},
                         {"shape": [-1, n, self._output_size,
                                    self._num_filters]})["Out"][0]
            out = _trace("elementwise_add", {"X": [out], "Y": [self.bias]},
                         {"Out": 1}, {"axis": -1})["Out"][0]
            out = _trace("reshape", {"X": [out]}, {"Out": 1},
                         {"shape": [-1, n, self._output_size *
                                    self._num_filters]})["Out"][0]
        if self._act:
            out = _trace(self._act, {"X": [out]}, {"Out": 1}, {})["Out"][0]
        return out
