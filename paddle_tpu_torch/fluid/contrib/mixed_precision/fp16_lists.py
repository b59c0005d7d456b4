"""AMP op lists (copy of ``paddle_tpu/fluid/contrib/mixed_precision/
fp16_lists.py``; reference: contrib/mixed_precision/fp16_lists.py).

white: ops that run in low precision (matrix-unit bound — matmul/conv),
black: ops that must stay fp32 (reductions/losses/normalization statistics),
gray: follow their inputs.

The default low-precision dtype is bfloat16 — the same exponent range as
fp32, so dynamic loss scaling is unnecessary (kept for fp16 and for API
parity)."""

from __future__ import annotations

white_list = {
    "conv2d",
    "depthwise_conv2d",
    "conv2d_transpose",
    "mul",
    "matmul",
    "bmm",
}

black_list = {
    "exp",
    "square",
    "log",
    "mean",
    "sum",
    "cos_sim",
    "softmax",
    "softmax_with_cross_entropy",
    "sigmoid_cross_entropy_with_logits",
    "cross_entropy",
    "cross_entropy2",
    "layer_norm",
    "reduce_sum",
    "reduce_mean",
}

gray_list = {
    # batch_norm follows its input dtype: the lowering accumulates its
    # statistics in fp32 (nn_ops.py _batch_norm), so a bf16 conv-bn-relu
    # chain stays bf16 end-to-end — halves the HBM bytes of the resnet
    # body (the CUDA-era reference black-listed BN because fp16 lacks
    # the exponent range; bf16 does not)
    "batch_norm",
    # follows its Q/K/V dtype (the flash kernels accumulate fp32
    # internally); without this the rewrite would leave a stale fp32
    # desc on a bf16 runtime value, skipping a protective cast at the
    # next black-list consumer
    "flash_attention",
    "elementwise_add",
    "elementwise_sub",
    "elementwise_mul",
    "elementwise_div",
    "elementwise_max",
    "elementwise_min",
    "elementwise_pow",
    "elementwise_mod",
    "elementwise_floordiv",
    "relu",
    "relu6",
    "leaky_relu",
    "gelu",
    "tanh",
    "sigmoid",
    "dropout",
    "pool2d",
    "reshape2",
    "transpose2",
    "concat",
    "split",
    "slice",
    "stack",
    "squeeze2",
    "unsqueeze2",
    "flatten2",
    "pad",
    "scale",
    "cast",
    "lookup_table",
    "lookup_table_v2",
}


class AutoMixedPrecisionLists(object):
    def __init__(self, custom_white_list=None, custom_black_list=None,
                 custom_black_varnames=None):
        self.white_list = set(white_list)
        self.black_list = set(black_list)
        self.gray_list = set(gray_list)
        self.black_varnames = set(custom_black_varnames or [])
        if custom_white_list:
            for op in custom_white_list:
                self.white_list.add(op)
                self.black_list.discard(op)
        if custom_black_list:
            for op in custom_black_list:
                self.black_list.add(op)
                self.white_list.discard(op)
