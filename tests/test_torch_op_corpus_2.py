"""The op corpus of the port's second A16 slice held against the JAX
package on the CPU: every op that ``paddle_tpu/fluid/ops/nn_ops.py``,
``metric_ops.py``, ``loss_ops.py`` and ``manip_ops.py`` register and the
first slice left, with ``ctc_align``, and the ``fluid.layers`` names
built on them.

Each op runs alone in a one-op program through each package's Executor
on the same numpy inputs: the inputs of the reference's
``tests/test_grad_sweep.py`` ``CASES`` where it has the op, else those
of the reference's per-op tests (``test_op_loss.py``,
``test_op_manip.py``, ``test_op_detection.py``, ``test_op_gap_batch1.py``)
or the case written here. Float outputs must match within 1e-5, integer
and boolean ones exactly; the gradients of sum(out · cot) from
``fluid.gradients`` (``append_backward``) within 1e-4 relative. ``nce``
draws its negatives from the op's generator, so its cost is held to a
float64 numpy cost of the port's own draw, and the draw to each
sampler's range and frequencies.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import profiler as tprofiler
from paddle_tpu_torch.fluid.ops import nn_ops as tnn_ops
from paddle_tpu_torch.fluid.ops import registry as tregistry
from test_grad_sweep import CASES
from test_torch_cpu_math import pin_vector_math
from test_torch_op_corpus import (_desc, _feeds, _grad_outputs, _is_float,
                                  _norm_attr)

pin_vector_math(2)  # 2 threads, vector math set up on one (see there)


def _u(seed, shape, lo=-1.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _i(seed, shape, lo, hi, dtype=np.int64):
    return np.random.RandomState(seed).randint(lo, hi, shape).astype(dtype)


# ---------------------------------------------------------------------------
# the slice's op types, by the reference module that lowers each
# ---------------------------------------------------------------------------
NN_OPS = ["instance_norm", "lrn", "nearest_interp", "interp_nearest",
          "bilinear_interp", "fc", "max_pool2d_with_index",
          "max_pool3d_with_index", "unpool", "spp", "relu_grad"]
METRIC_OPS = ["mean_iou", "auc", "precision_recall", "edit_distance",
              "chunk_eval", "positive_negative_pair"]
LOSS_OPS = ["kldiv_loss", "log_loss", "hinge_loss", "bpr_loss", "rank_loss",
            "margin_rank_loss", "center_loss", "sigmoid_focal_loss",
            "cross_entropy2", "cvm", "modified_huber_loss",
            "teacher_student_sigmoid_loss", "warpctc",
            "hierarchical_sigmoid", "nce"]
MANIP_OPS = ["gather_nd", "scatter_nd_add", "scatter_nd", "strided_slice",
             "expand_as", "multiplex", "crop", "crop_tensor",
             "pad_constant_like", "unique", "unique_with_counts",
             "shard_index", "space_to_depth", "pixel_shuffle",
             "shuffle_channel", "temporal_shift", "minus", "selu", "norm",
             "l1_norm", "affine_channel", "conv_shift", "spectral_norm",
             "grid_sampler"]
MISC_OPS = ["ctc_align"]
SLICE_OPS = NN_OPS + METRIC_OPS + LOSS_OPS + MANIP_OPS + MISC_OPS


def test_slice_has_57_op_types():
    assert len(SLICE_OPS) == len(set(SLICE_OPS)) == 57


def test_registry_holds_every_op_of_the_four_reference_modules():
    """Accounting: every op type the reference lowers in ``nn_ops.py``,
    ``metric_ops.py``, ``loss_ops.py`` and ``manip_ops.py``, plus
    ``ctc_align``, is in the port's registry, which holds 315 of the
    reference's 407."""
    import inspect
    import re

    from paddle_tpu.fluid.ops import loss_ops, manip_ops, metric_ops, nn_ops
    from paddle_tpu.fluid.ops import registry as jregistry

    want = {"ctc_align"}
    for mod in (nn_ops, metric_ops, loss_ops, manip_ops):
        want |= set(re.findall(r'(?:@op|register_op|_register_\w+)\(\s*'
                               r'"([a-z0-9_]+)"', inspect.getsource(mod)))
    port = {t for t in tregistry.all_op_types()
            if not tregistry.is_generic_grad(t)}
    assert not sorted(want - port)
    assert set(SLICE_OPS) <= want
    assert len(port) == 315
    assert len(jregistry.all_op_types()) >= 407


# ---------------------------------------------------------------------------
# cases written here, in the grad sweep's form: inputs {slot: array or
# [(name, array)]}, outputs {slot: shape or [(name, shape)]}, outs (the
# slots the gradient's objective reads), check (input slots to
# differentiate; default every float input), attrs, extra (feeds no slot
# names: a ``@SEQ_LEN`` companion)
# ---------------------------------------------------------------------------
_MP2 = (np.random.RandomState(17).permutation(2 * 3 * 6 * 6).astype(
    np.float32) * 0.05).reshape(2, 3, 6, 6)
_TIES = np.round(_u(30, (1, 2, 5, 5)) * 2) / 2
_CTC_LOGITS = np.random.RandomState(10).rand(2, 4, 3).astype(np.float32)
_NSEL = _u(41, (4, 3, 4, 4))

LOCAL = {
    # nn_ops.py
    "lrn_n5": dict(op="lrn", inputs={"X": _u(1, (2, 7, 3, 3))},
                   outputs={"Out": (2, 7, 3, 3), "MidOut": (2, 7, 3, 3)},
                   outs=["Out"], attrs={"n": 5, "k": 2.0, "alpha": 1e-3,
                                        "beta": 0.75}),
    "fc_3d_relu": dict(op="fc", inputs={"Input": _u(2, (2, 3, 4)),
                                        "W": _u(3, (4, 5)),
                                        "Bias": _u(4, (5,))},
                       outputs={"Out": (2, 3, 5)},
                       attrs={"in_num_col_dims": 2,
                              "activation_type": "relu"}),
    "max_pool2d_with_index": dict(inputs={"X": _MP2},
                                  outputs={"Out": (2, 3, 3, 3),
                                           "Mask": (2, 3, 3, 3)},
                                  outs=["Out"],
                                  attrs={"ksize": [2, 2], "strides": [2, 2],
                                         "paddings": [0, 0]}),
    "max_pool2d_with_index_pad": dict(
        op="max_pool2d_with_index", inputs={"X": _MP2 - 1.0},
        outputs={"Out": (2, 3, 4, 4), "Mask": (2, 3, 4, 4)}, outs=["Out"],
        attrs={"ksize": [3, 3], "strides": [2, 2], "paddings": [2, 2]}),
    "max_pool2d_with_index_ties": dict(
        op="max_pool2d_with_index", inputs={"X": _TIES},
        outputs={"Out": (1, 2, 3, 3), "Mask": (1, 2, 3, 3)}, outs=["Out"],
        check=[], attrs={"ksize": [3, 3], "strides": [2, 2],
                         "paddings": [1, 1]}),
    "max_pool2d_with_index_global": dict(
        op="max_pool2d_with_index", inputs={"X": _MP2},
        outputs={"Out": (2, 3, 1, 1), "Mask": (2, 3, 1, 1)}, outs=["Out"],
        attrs={"ksize": [1, 1], "global_pooling": True}),
    "unpool_sized": dict(op="unpool", inputs={
        "X": _u(5, (1, 2, 2, 2)),
        "Indices": np.array([[[[0, 3], [10, 13]], [[2, 5], [8, 15]]]],
                            np.int32)},
        outputs={"Out": (1, 2, 4, 4)}, check=["X"],
        attrs={"unpooling_type": "max", "ksize": [2, 2], "strides": [2, 2],
               "paddings": [0, 0], "unpooled_size": [4, 4]}),
    "spp_max": dict(op="spp", inputs={"X": _u(6, (2, 3, 5, 6))},
                    outputs={"Out": (2, 63)},
                    attrs={"pyramid_height": 3, "pooling_type": "max"}),
    "relu_grad": dict(inputs={"Out": np.maximum(_u(7, (3, 4)), 0),
                              "Out@GRAD": _u(8, (3, 4))},
                      outputs={"X@GRAD": (3, 4)}),
    # metric_ops.py
    "mean_iou": dict(inputs={
        "Predictions": _i(9, (2, 6, 5), 0, 4, np.int32),
        "Labels": np.where(_i(10, (2, 6, 5), 0, 6) == 5, 255,
                           _i(11, (2, 6, 5), 0, 4)).astype(np.int32)},
        outputs={"OutMeanIou": (1,), "OutWrong": (4,), "OutCorrect": (4,)},
        attrs={"num_classes": 4}),
    "auc": dict(inputs={
        "Predict": np.array([[0.2, 0.8], [0.9, 0.1], [0.4, 0.6],
                             [0.7, 0.3]], np.float32),
        "Label": np.array([[1], [0], [1], [0]], np.int64),
        "StatPos": np.array([0, 1, 0, 2, 0, 0, 1, 0, 0, 3, 1], np.int64),
        "StatNeg": np.array([1, 0, 2, 0, 0, 1, 0, 0, 1, 0, 0], np.int64)},
        outputs={"AUC": (), "StatPosOut": (11,), "StatNegOut": (11,)},
        attrs={"num_thresholds": 10}),
    "precision_recall": dict(inputs={
        "Indices": np.array([[0], [1], [1], [2]], np.int64),
        "Labels": np.array([[0], [1], [2], [2]], np.int64),
        "StatesInfo": np.array([[1, 0, 2, 1], [0, 1, 3, 0], [2, 0, 1, 1]],
                               np.float32)},
        outputs={"BatchMetrics": (1, 6), "AccumMetrics": (1, 6),
                 "AccumStatesInfo": (3, 4)}),
    "precision_recall_weighted": dict(op="precision_recall", inputs={
        "MaxProbs": _u(12, (6, 1), 0.2, 1.0),
        "Indices": _i(13, (6, 1), 0, 3), "Labels": _i(14, (6, 1), 0, 3),
        "Weights": _u(15, (6, 1), 0.5, 2.0),
        "StatesInfo": np.zeros((3, 4), np.float32)},
        outputs={"BatchMetrics": (1, 6), "AccumMetrics": (1, 6),
                 "AccumStatesInfo": (3, 4)}),
    "edit_distance": dict(inputs={
        "Hyps": np.array([[1, 2, 3, 0], [5, 6, 0, 0]], np.int64),
        "Refs": np.array([[1, 3, 3, 4], [5, 6, 7, 0]], np.int64)},
        extra={"hyps_in@SEQ_LEN": np.array([3, 2], np.int32),
               "refs_in@SEQ_LEN": np.array([4, 3], np.int32)},
        outputs={"Out": (2, 1), "SequenceNum": (1,)},
        attrs={"normalized": False}),
    "edit_distance_lengths_normalized": dict(op="edit_distance", inputs={
        "Hyps": _i(16, (3, 6), 0, 4), "Refs": _i(17, (3, 5), 0, 4),
        "HypsLength": np.array([6, 3, 0], np.int64),
        "RefsLength": np.array([5, 4, 2], np.int64)},
        outputs={"Out": (3, 1), "SequenceNum": (1,)},
        attrs={"normalized": True, "ignored_tokens": [0]}),
    "chunk_eval": dict(inputs={
        "Inference": np.array([[0, 1, 4, 2, 3]], np.int64),
        "Label": np.array([[0, 1, 4, 0, 3]], np.int64)},
        extra={"inference_in@SEQ_LEN": np.array([5], np.int32)},
        outputs={"Precision": (1,), "Recall": (1,), "F1-Score": (1,),
                 "NumInferChunks": (1,), "NumLabelChunks": (1,),
                 "NumCorrectChunks": (1,)},
        attrs={"num_chunk_types": 2, "chunk_scheme": "IOB"}),
    "chunk_eval_plain_lengths": dict(op="chunk_eval", inputs={
        "Inference": _i(18, (3, 8), 0, 4), "Label": _i(19, (3, 8), 0, 4),
        "SeqLength": np.array([8, 5, 2], np.int64)},
        outputs={"Precision": (1,), "Recall": (1,), "F1-Score": (1,),
                 "NumInferChunks": (1,), "NumLabelChunks": (1,),
                 "NumCorrectChunks": (1,)},
        attrs={"num_chunk_types": 3, "chunk_scheme": "plain"}),
    "positive_negative_pair": dict(inputs={
        "Score": np.array([[0.8], [0.2], [0.5], [0.6], [0.5], [0.3]],
                          np.float32),
        "Label": np.array([[1], [0], [1], [0], [0], [2]], np.float32),
        "QueryID": np.array([[0], [0], [1], [1], [1], [0]], np.int64)},
        outputs={"PositivePair": (1,), "NegativePair": (1,),
                 "NeutralPair": (1,)}),
    # loss_ops.py
    **{"kldiv_loss_" + r: dict(op="kldiv_loss", inputs={
        "X": np.log(np.random.RandomState(0).rand(4, 5).astype(np.float32)
                    + 0.1),
        "Target": np.where(_u(20, (4, 5)) > -0.6,
                           np.random.RandomState(0).rand(4, 5), 0.0).astype(
                               np.float32)},
        outputs={"Loss": s}, check=["X"], attrs={"reduction": r})
       for r, s in (("mean", ()), ("sum", ()), ("batchmean", ()),
                    ("none", (4, 5)))},
    "log_loss": dict(inputs={
        "Predicted": np.random.RandomState(1).rand(6, 1).astype(np.float32)
        * 0.8 + 0.1, "Labels": _i(21, (6, 1), 0, 2).astype(np.float32)},
        outputs={"Loss": (6, 1)}, check=["Predicted"],
        attrs={"epsilon": 1e-4}),
    "bpr_loss": dict(inputs={"X": np.random.RandomState(3).rand(4, 5).astype(
        np.float32), "Label": _i(22, (4, 1), 0, 5)}, outputs={"Y": (4, 1)}),
    "rank_loss": dict(inputs={"Label": _i(23, (5, 1), 0, 2).astype(
        np.float32), "Left": _u(24, (5, 1)), "Right": _u(25, (5, 1))},
        outputs={"Out": (5, 1)}, check=["Left", "Right"]),
    "center_loss_no_update": dict(op="center_loss", inputs={
        "X": _u(26, (4, 3)), "Label": np.array([0, 1, 0, 2], np.int64),
        "Centers": _u(27, (3, 3)),
        "CenterUpdateRate": np.array([0.1], np.float32)},
        outputs={"SampleCenterDiff": (4, 3), "Loss": (4, 1),
                 "CentersOut": (3, 3)}, outs=["Loss"], check=["X"],
        attrs={"need_update": False}),
    "sigmoid_focal_loss": dict(inputs={
        "X": _u(28, (4, 3)), "Label": _i(29, (4, 1), 0, 4),
        "FgNum": np.array([3], np.int64)}, outputs={"Out": (4, 3)},
        check=["X"], attrs={"gamma": 2.0, "alpha": 0.25}),
    "cross_entropy2": dict(inputs={"X": CASES["cross_entropy2"]["inputs"][
        "X"], "Label": CASES["cross_entropy2"]["inputs"]["Label"]},
        outputs={"Y": (3, 1), "MatchX": (3, 1), "XShape": (0,)},
        outs=["Y"], check=["X"]),
    "cvm_no_cvm": dict(op="cvm", inputs={"X": _u(31, (3, 5), 0.1, 1.0),
                                         "CVM": _u(32, (3, 2), 0.1, 1.0)},
                       outputs={"Y": (3, 3)}, check=["X"],
                       attrs={"use_cvm": False}),
    "teacher_student_all_branches": dict(
        op="teacher_student_sigmoid_loss",
        inputs={"X": _u(33, (6, 1), -3, 3),
                "Label": np.array([[-2.0], [-0.5], [0.0], [0.3], [1.0],
                                   [-1.5]], np.float32)},
        outputs={"Y": (6, 1)}, check=["X"],
        attrs={"soft_max_up_bound": 2.0, "soft_max_lower_bound": -2.0}),
    "warpctc": dict(inputs={"Logits": _CTC_LOGITS,
                            "Label": np.array([[1, 2], [2, 0]], np.int64)},
                    extra={"label_in@SEQ_LEN": np.array([2, 1], np.int32)},
                    outputs={"Loss": (2, 1), "WarpCTCGrad": (2, 4, 3)},
                    outs=["Loss"], check=["Logits"],
                    attrs={"blank": 0, "norm_by_times": False}),
    "warpctc_lengths_norm_by_times": dict(op="warpctc", inputs={
        "Logits": _u(34, (3, 7, 5), -2, 2),
        "Label": np.array([[1, 3, 3], [4, 0, 0], [2, 2, 1]], np.int64)},
        extra={"logits_in@SEQ_LEN": np.array([7, 4, 6], np.int32),
               "label_in@SEQ_LEN": np.array([3, 1, 3], np.int32)},
        outputs={"Loss": (3, 1), "WarpCTCGrad": (3, 7, 5)}, outs=["Loss"],
        check=["Logits"], attrs={"blank": 0, "norm_by_times": True}),
    "warpctc_blank_last": dict(op="warpctc", inputs={
        "Logits": _u(35, (2, 6, 4), -2, 2),
        "Label": np.array([[0, 1], [2, 2]], np.int64)},
        outputs={"Loss": (2, 1), "WarpCTCGrad": (2, 6, 4)}, outs=["Loss"],
        check=["Logits"], attrs={"blank": 3}),
    "hierarchical_sigmoid_custom": dict(op="hierarchical_sigmoid", inputs={
        "X": _u(36, (3, 4)), "W": _u(37, (6, 4), -0.5, 0.5),
        "Label": np.array([[0], [1], [2]], np.int64),
        "PathTable": np.array([[0, 2, -1], [0, 3, 5], [1, 4, -1]], np.int64),
        "PathCode": np.array([[1, 0, 0], [0, 1, 1], [1, 1, 0]], np.int64),
        "Bias": _u(38, (6, 1))},
        outputs={"Out": (3, 1), "PreOut": (3, 3)}, outs=["Out"],
        check=["X", "W", "Bias"], attrs={"num_classes": 6}),
    "hierarchical_sigmoid_no_bias": dict(op="hierarchical_sigmoid", inputs={
        "X": _u(39, (4, 3)), "W": _u(40, (7, 3), -0.5, 0.5),
        "Label": np.array([[0], [7], [3], [5]], np.int64)},
        outputs={"Out": (4, 1), "PreOut": (4, 3)}, outs=["Out"],
        check=["X", "W"], attrs={"num_classes": 8}),
    # manip_ops.py
    "gather_nd": dict(inputs={"X": np.random.RandomState(0).rand(3, 4, 5)
                              .astype(np.float32),
                              "Index": np.array([[0, 1], [2, 3], [0, 1]],
                                                np.int64)},
                      outputs={"Out": (3, 5)}, check=["X"]),
    "scatter_nd_add": dict(inputs={
        "X": np.random.RandomState(1).rand(4, 3).astype(np.float32),
        "Index": np.array([[1], [3], [1]], np.int64),
        "Updates": np.random.RandomState(2).rand(3, 3).astype(np.float32)},
        outputs={"Out": (4, 3)}, check=["X", "Updates"]),
    "scatter_nd_2d": dict(op="scatter_nd", inputs={
        "Index": np.array([[1, 1], [0, 2], [1, 1]], np.int64),
        "Updates": _u(42, (3,))}, outputs={"Out": (3, 4)},
        check=["Updates"], attrs={"shape": [3, 4]}),
    "strided_slice": dict(inputs={"Input": _u(43, (5, 6))},
                          outputs={"Out": (2, 2)},
                          attrs={"axes": [0, 1], "starts": [1, 0],
                                 "ends": [5, 6], "strides": [2, 3]}),
    "strided_slice_negative": dict(op="strided_slice", inputs={
        "Input": _u(44, (5, 6, 4))}, outputs={"Out": (2, 3, 4)},
        attrs={"axes": [0, -2], "starts": [4, -1], "ends": [0, 0],
               "strides": [-2, -2]}),
    "expand_as": dict(inputs={"X": _u(45, (2, 1, 3)),
                              "target_tensor": _u(46, (2, 4, 3))},
                      outputs={"Out": (2, 4, 3)}, check=["X"]),
    "crop": dict(inputs={"X": _u(47, (5, 6))}, outputs={"Out": (3, 3)},
                 attrs={"offsets": [1, 2], "shape": [3, 3]}),
    "crop_offsets_y": dict(op="crop", inputs={
        "X": _u(48, (5, 6)), "Y": _u(49, (3, 2)),
        "Offsets": np.array([1, 5], np.int32)},
        outputs={"Out": (3, 2)}, check=["X"]),
    "crop_tensor_to_end": dict(op="crop_tensor", inputs={
        "X": _u(50, (5, 6))}, outputs={"Out": (4, 5)},
        attrs={"offsets": [0, 1], "shape": [4, -1]}),
    "pad_constant_like": dict(inputs={"X": _u(51, (4, 5)),
                                      "Y": _u(52, (2, 3))},
                              outputs={"Out": (4, 5)}, check=["Y"],
                              attrs={"pad_value": 1.5}),
    "unique": dict(inputs={"X": np.array([2, 3, 3, 1, 5, 3], np.int64)},
                   outputs={"Out": (4,), "Index": (6,)}),
    "unique_float_2d": dict(op="unique", inputs={
        "X": np.array([[0.5, -1.0, 0.5], [2.0, -1.0, 0.0]], np.float32)},
        outputs={"Out": (4,), "Index": (2, 3)}),
    "unique_with_counts": dict(inputs={"X": np.array([2, 3, 3, 1, 5, 3],
                                                     np.int64)},
                               outputs={"Out": (4,), "Index": (6,),
                                        "Count": (4,)}),
    "shard_index": dict(inputs={"X": np.array([[1], [6], [12], [19]],
                                              np.int64)},
                        outputs={"Out": (4, 1)},
                        attrs={"index_num": 20, "nshards": 2, "shard_id": 0,
                               "ignore_value": -1}),
    "shard_index_ignore": dict(op="shard_index", inputs={
        "X": np.array([[1], [6], [12], [19], [13]], np.int64)},
        outputs={"Out": (5, 1)},
        attrs={"index_num": 20, "nshards": 3, "shard_id": 1,
               "ignore_value": 99}),
    "space_to_depth": dict(inputs={"X": _u(53, (2, 3, 4, 6))},
                           outputs={"Out": (2, 12, 2, 3)},
                           attrs={"blocksize": 2}),
    "pixel_shuffle": dict(inputs={"X": _u(54, (2, 8, 3, 3))},
                          outputs={"Out": (2, 2, 6, 6)},
                          attrs={"upscale_factor": 2}),
    "temporal_shift": dict(inputs={"X": _u(55, (6, 8, 2, 2))},
                           outputs={"Out": (6, 8, 2, 2)},
                           attrs={"seg_num": 3, "shift_ratio": 0.25}),
    "minus": dict(inputs={"X": _u(56, (3, 4)), "Y": _u(57, (3, 4))},
                  outputs={"Out": (3, 4)}),
    "selu": dict(inputs={"X": _u(58, (3, 4), -2, 2)},
                 outputs={"Out": (3, 4)},
                 attrs={"scale": 1.0507009873554805,
                        "alpha": 1.6732632423543772}),
    "norm": dict(inputs={"X": _u(59, (3, 4), 0.1, 1.1)},
                 outputs={"Out": (3, 4), "Norm": (3, 1)}, outs=["Out"],
                 attrs={"axis": 1, "epsilon": 1e-10}),
    "affine_channel": dict(inputs={"X": _u(60, (2, 3, 4, 4)),
                                   "Scale": _u(61, (3,)),
                                   "Bias": _u(62, (3,))},
                           outputs={"Out": (2, 3, 4, 4)},
                           attrs={"data_layout": "NCHW"}),
    "affine_channel_nhwc": dict(op="affine_channel", inputs={
        "X": _u(63, (2, 4, 4, 3)), "Scale": _u(64, (3,)),
        "Bias": _u(65, (3,))}, outputs={"Out": (2, 4, 4, 3)},
        attrs={"data_layout": "NHWC"}),
    "conv_shift": dict(inputs={"X": _u(66, (2, 5)), "Y": _u(67, (2, 3))},
                       outputs={"Out": (2, 5)}),
    "spectral_norm": dict(inputs={
        "Weight": _u(68, (4, 3, 2)), "U": _u(69, (3,)), "V": _u(70, (8,))},
        outputs={"Out": (4, 3, 2)}, fetch_inputs=["U", "V"],
        attrs={"dim": 1, "power_iters": 3, "eps": 1e-12}),
    "grid_sampler_outside": dict(op="grid_sampler", inputs={
        "X": _u(71, (2, 3, 4, 4)), "Grid": _u(72, (2, 3, 3, 2), -1.3, 1.3)},
        outputs={"Output": (2, 3, 3, 3)}),
    # misc_ops.py
    "ctc_align": dict(inputs={"Input": np.array(
        [[0, 1, 1, 0, 2, 2, 0, 3], [3, 3, 0, 0, 1, 0, 0, 0]], np.int32)},
        outputs={"Output": (2, 8)},
        attrs={"blank": 0, "merge_repeated": True, "padding_value": 0}),
    "ctc_align_keep_repeats": dict(op="ctc_align", inputs={"Input": np.array(
        [[2, 2, 4, 1, 1, 4], [4, 4, 4, 4, 0, 3]], np.int64)},
        outputs={"Output": (2, 6)},
        attrs={"blank": 4, "merge_repeated": False, "padding_value": -1}),
}

# the grad sweep's cases of the slice's ops, but cross_entropy2 (its
# outputs name an XShift the op does not write: the case above has the
# op's own slots)
SWEEP = sorted(k for k, c in CASES.items()
               if c.get("op_type", k) in SLICE_OPS and k != "cross_entropy2")

# the op whose gradient is held apart: the reference's generic grad
# replays its forward after the forward wrote U and V back (nce, random,
# has tests of its own)
GRAD_APART = {"spectral_norm"}


def _spec(name):
    if name in LOCAL:
        spec = dict(LOCAL[name])
        spec.setdefault("op", name)
    else:
        c = CASES[name]
        spec = dict(op=c.get("op_type", name), inputs=c["inputs"],
                    attrs=c.get("attrs", {}), outs=c.get("outs"),
                    check=c.get("check"),
                    outputs={s: ([(n, z.shape) for n, z in v]
                                 if isinstance(v, list) else v.shape)
                             for s, v in c["outputs"].items()})
    for k, v in (("attrs", {}), ("outs", None), ("check", None),
                 ("extra", {}), ("fetch_inputs", [])):
        spec.setdefault(k, v)
    return spec


# ---------------------------------------------------------------------------
# one op through both packages (the first corpus's runner, with feeds no
# slot names and the inputs' state fetched)
# ---------------------------------------------------------------------------
def run_op(fl, spec, cots=None, as_tensors=False):
    """Run the spec's op alone through package ``fl``: the outputs
    ({name: array}) and, given ``cots`` ({output name: array}), the
    gradients of Σ sum(out · cot) with respect to the differentiated
    inputs ({input name: array}). ``as_tensors``: the port's feeds go in
    as tensors (values with no host copy, as an earlier op's would be)."""
    main, startup = fl.Program(), fl.Program()
    feeds = _feeds(spec)
    check = spec["check"]
    wrt = [n for slot, pairs in feeds for n, a in pairs if _is_float(a)
           and (check is None or slot in check)] if cots else []
    feed = {n: np.asarray(a) for _s, pairs in feeds for n, a in pairs}
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        block = main.global_block()
        var = {n: block.create_var(name=n, shape=list(a.shape),
                                   dtype=str(a.dtype),
                                   stop_gradient=n not in wrt)
               for n, a in feed.items()}
        outputs, out_names = {}, []
        for slot, v in spec["outputs"].items():
            pairs = v if isinstance(v, list) else [(slot.lower(), v)]
            outputs[slot] = [block.create_var(name=n) for n, _s in pairs]
            out_names += [n for n, _s in pairs]
        block.append_op(type=spec["op"],
                        inputs={s: [var[n] for n, _a in p] for s, p in feeds},
                        outputs=outputs, attrs=dict(spec["attrs"]))
        out_names += [slot.lower() + "_in" for slot in spec["fetch_inputs"]]
        fetch = list(out_names)
        if cots:
            terms = []
            for n, cot in cots.items():
                c = block.create_var(name=n + "_cot", shape=list(cot.shape),
                                     dtype="float32")
                feed[n + "_cot"] = cot
                terms.append(fl.layers.reduce_sum(fl.layers.elementwise_mul(
                    block.var(n), c)))
            loss = terms[0] if len(terms) == 1 else fl.layers.sums(terms)
            fetch += [g.name for g in fl.gradients([loss],
                                                   [var[n] for n in wrt])]
    feed.update(spec["extra"])
    if fl is tfluid and as_tensors:
        feed = {n: torch.from_numpy(np.array(a)) for n, a in feed.items()}
    exe = fl.Executor(fl.CPUPlace())
    scope = fl.Scope() if fl is tfluid else fl.core.Scope()
    got = [np.asarray(g) for g in exe.run(main, feed=feed, fetch_list=fetch,
                                          scope=scope)]
    return (dict(zip(out_names, got[:len(out_names)])),
            dict(zip(wrt, got[len(out_names):])))


def _has_grad(op_type):
    return tregistry.get_op_def(op_type).grad_maker is not None


# outputs the desc declares int64 where the reference's JAX (x64 off)
# holds int32 (ROADMAP C): the port keeps the desc's type (by op, or by
# case where only int64 inputs make them int64)
INT64_OUTPUTS = {("auc", "statposout"), ("auc", "statnegout"),
                 ("shard_index", "out"),
                 ("ctc_align_keep_repeats", "output")}

FORWARD = sorted(set(LOCAL) | set(SWEEP))


def _assert_outputs_match(spec, ref, port, name=None):
    for n, want in ref.items():
        got = port[n]
        assert got.shape == want.shape, n
        if _is_float(want):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                       err_msg=n)
        else:
            np.testing.assert_array_equal(got, want, err_msg=n)
            if {(spec["op"], n), (name, n)} & INT64_OUTPUTS:
                assert got.dtype == np.int64, n
            else:
                assert got.dtype == want.dtype, n


@pytest.mark.parametrize("name", FORWARD)
def test_op_matches_reference(name):
    """Forward: float outputs within 1e-5, integer and boolean ones
    exactly, in the reference's type (the desc's int64 where the
    reference's JAX holds int32). Gradient (ops with one but
    ``spectral_norm``, held below): each input's within 1e-4 relative,
    with no forward replayed."""
    spec = _spec(name)
    ref, _ = run_op(jfluid, spec)
    port, _ = run_op(tfluid, spec)
    _assert_outputs_match(spec, ref, port, name)
    if not _has_grad(spec["op"]) or spec["op"] in GRAD_APART:
        return
    cots = _grad_outputs(spec, ref)
    if not cots or spec["check"] == []:
        return
    _o, rg = run_op(jfluid, spec, cots)
    replays = tprofiler.get_counter(tregistry.REPLAY_COUNTER)
    _o, pg = run_op(tfluid, spec, cots)
    assert tprofiler.get_counter(tregistry.REPLAY_COUNTER) == replays
    assert rg and set(pg) == set(rg)
    for n, want in rg.items():
        np.testing.assert_allclose(pg[n], want, rtol=1e-4, atol=1e-6,
                                   err_msg=n + "@GRAD")


def test_every_slice_op_has_a_case():
    covered = {_spec(n)["op"] for n in FORWARD}
    assert set(SLICE_OPS) - covered == {"nce"}


# ---------------------------------------------------------------------------
# the interpolations: every coordinate mapping, both size forms
# ---------------------------------------------------------------------------
INTERP = [(m, ac, am, form) for m in ("bilinear", "nearest")
          for ac in (True, False) for am in ((0, 1) if m == "bilinear"
                                             else (1,))
          for form in ("out_shape", "scale")]


@pytest.mark.parametrize("method,align_corners,align_mode,form", INTERP,
                         ids=["%s-ac%d-am%d-%s" % c for c in INTERP])
def test_interpolation_matches_reference(method, align_corners, align_mode,
                                         form):
    """``bilinear_interp`` and ``nearest_interp`` under each mapping of
    ``_src_coords`` (corner-anchored, ``align_mode`` 1, half-pixel) and
    each size form (``out_h``/``out_w``: up along one axis, down along
    the other; ``scale`` 1.7): forward within 1e-5, the gradient within
    1e-4."""
    attrs = {"align_corners": align_corners, "align_mode": align_mode,
             "interp_method": method}
    if form == "out_shape":
        attrs.update(out_h=7, out_w=3)
        shape = (2, 3, 7, 3)
    else:
        attrs.update(scale=1.7)
        shape = (2, 3, 6, 8)
    spec = dict(op=method + "_interp", inputs={"X": _u(80, (2, 3, 4, 5))},
                outputs={"Out": shape}, attrs=attrs, outs=None, check=None,
                extra={}, fetch_inputs=[])
    ref, _ = run_op(jfluid, spec)
    port, _ = run_op(tfluid, spec)
    _assert_outputs_match(spec, ref, port)
    cots = _grad_outputs(spec, ref)
    _o, rg = run_op(jfluid, spec, cots)
    _o, pg = run_op(tfluid, spec, cots)
    np.testing.assert_allclose(pg["x_in"], rg["x_in"], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("align_corners,align_mode", [(True, 1), (False, 1),
                                                       (False, 0)])
def test_interp_matrix_is_the_four_point_weighting(align_corners,
                                                   align_mode):
    """``interp_matrix``'s rows sum to 1, and the two products equal the
    reference's four weighted gathers evaluated in float64 numpy."""
    x = np.random.RandomState(3).standard_normal((1, 2, 5, 6))
    oh, ow = 9, 4
    m = [tnn_ops.interp_matrix(o, i, align_corners, align_mode,
                               torch.float64, torch.device("cpu")).numpy()
         for o, i in ((oh, 5), (ow, 6))]
    for a in m:
        np.testing.assert_allclose(a.sum(1), 1.0, rtol=0, atol=1e-12)
    sy = tnn_ops.interp_source(oh, 5, align_corners, align_mode)
    sx = tnn_ops.interp_source(ow, 6, align_corners, align_mode)
    y0 = np.clip(np.floor(sy).astype(int), 0, 4)
    x0 = np.clip(np.floor(sx).astype(int), 0, 5)
    y1, x1 = np.clip(y0 + 1, 0, 4), np.clip(x0 + 1, 0, 5)
    wy = (sy - y0)[:, None].astype(np.float64)
    wx = (sx - x0)[None, :].astype(np.float64)
    g = lambda a, b: x[:, :, a][:, :, :, b]  # noqa: E731
    want = (g(y0, x0) * (1 - wy) * (1 - wx) + g(y1, x0) * wy * (1 - wx)
            + g(y0, x1) * (1 - wy) * wx + g(y1, x1) * wy * wx)
    got = tnn_ops.bilinear_interp(torch.from_numpy(x), oh, ow, align_corners,
                                  align_mode).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# ops whose check differs from the one-op form
# ---------------------------------------------------------------------------
def _reference_vjp(op_type, inputs, attrs, out_slot, cot, wrt):
    """The reference's forward rule run once under ``jax.vjp`` with
    respect to the ``wrt`` input slots: (out, {slot: gradient})."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu.fluid.ops import registry as jregistry

    fwd = jregistry.get_op_def(op_type)

    def f(*vals):
        env = {s.lower(): jnp.asarray(a) for s, a in inputs.items()}
        env.update({s.lower(): v for s, v in zip(wrt, vals)})
        ctx = jregistry.LowerCtx(env=env)
        fwd.lower(ctx, jregistry._FakeOp(
            op_type, {s: [s.lower()] for s in inputs},
            {out_slot: ["out"]}, attrs))
        return env["out"]

    out, pullback = jax.vjp(f, *[jnp.asarray(inputs[s]) for s in wrt])
    return np.asarray(out), dict(zip(wrt, (np.asarray(g) for g in
                                           pullback(jnp.asarray(cot)))))


@pytest.mark.parametrize("power_iters", [0, 1, 3])
def test_spectral_norm_gradient_is_the_forwards(power_iters):
    """``spectral_norm``'s gradient with respect to Weight is the vjp of
    the forward that ran (through its power iterations), within 1e-4 of
    ``jax.vjp`` of the reference's rule. The reference's own Executor
    replays the forward for its generic grad after the forward wrote U
    and V back, so its gradient runs the iteration from the updated
    vectors (ROADMAP C); the port keeps the forward's pullback."""
    spec = _spec("spectral_norm")
    spec["attrs"] = dict(spec["attrs"], power_iters=power_iters)
    cot = np.random.RandomState(9).standard_normal((4, 3, 2)).astype(
        np.float32)
    out, want = _reference_vjp("spectral_norm", spec["inputs"],
                               spec["attrs"], "Out", cot, ["Weight"])
    spec["check"] = ["Weight"]
    got, grads = run_op(tfluid, spec, {"out": cot})
    np.testing.assert_allclose(got["out"], out, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grads["weight_in"], want["Weight"],
                               rtol=1e-4, atol=1e-6)


def test_spectral_norm_layer_iterates_across_runs():
    """The layer's U and V are parameters the op writes back in place:
    each run goes on from the last (two runs of one power iteration
    equal one run of two), as the reference's declared state."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        w = tfluid.layers.data("w", [4, 6], append_batch_size=False)
        out = tfluid.layers.spectral_norm(w, dim=0, power_iters=1)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    u_name, v_name = main.global_block().ops[-1].input("U")[0], \
        main.global_block().ops[-1].input("V")[0]
    u0, v0 = scope.get(u_name).clone(), scope.get(v_name).clone()
    wv = _u(90, (4, 6))
    exe.run(main, feed={"w": wv}, fetch_list=[out], scope=scope)
    (second,) = exe.run(main, feed={"w": wv}, fetch_list=[out], scope=scope)
    from paddle_tpu_torch.fluid.ops import manip_ops

    twice, _u2, _v2 = manip_ops.spectral_norm(torch.from_numpy(wv), u0, v0,
                                              0, 2)
    np.testing.assert_allclose(second, twice.numpy(), rtol=1e-6, atol=1e-6)


def test_center_loss_updates_its_centers_in_place():
    """``center_loss`` with ``need_update`` as the layer builds it
    (CentersOut names Centers): the run updates the scope's center table
    in place by rate·Σdiff/(1 + count), and X's gradient is the
    pre-update diff's (the reference's generic grad replays its forward
    after the write and so reads the new centers; ROADMAP C)."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", [4, 3], append_batch_size=False)
        x.stop_gradient = False
        y = tfluid.layers.data("y", [4, 1], dtype="int64",
                               append_batch_size=False)
        loss = tfluid.layers.center_loss(x, y, num_classes=3, alpha=0.5)
        (gx,) = tfluid.gradients([tfluid.layers.reduce_sum(loss)], [x])
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    (cname,) = [o.input("Centers")[0] for o in main.global_block().ops
                if o.type == "center_loss"]
    table = scope.get(cname)
    before = table.numpy().copy()
    xv, yv = _u(91, (4, 3)), np.array([[0], [2], [0], [1]], np.int64)
    lv, g = exe.run(main, feed={"x": xv, "y": yv}, fetch_list=[loss, gx],
                    scope=scope)
    diff = xv - before[yv[:, 0]]
    np.testing.assert_allclose(lv, 0.5 * (diff ** 2).sum(1, keepdims=True),
                               rtol=1e-6)
    np.testing.assert_allclose(g, diff, rtol=1e-6)
    want = before.copy()
    for k in range(3):
        rows = yv[:, 0] == k
        want[k] -= 0.5 * diff[rows].sum(0) / (1.0 + rows.sum())
    assert scope.get(cname).data_ptr() == table.data_ptr()
    np.testing.assert_allclose(table.numpy(), want, rtol=1e-6, atol=1e-7)


def test_warpctc_impossible_alignment_is_finite_as_the_reference():
    """A label longer than its frames allow (3 frames, label 1 1 1
    needs 5): the reference's log-space floor gives a loss near 1e30,
    finite, and so does the port (``F.ctc_loss`` gives inf). Its
    gradient is finite; the possible row's is the reference's within
    1e-4. The impossible row's is the rounding of sums of 1e30-sized
    logs (fp32 keeps no bit of a log-probability beside 1e30), and the
    two packages' ``logaddexp`` pullbacks round it apart (ROADMAP C)."""
    spec = _spec("warpctc")
    spec["inputs"] = {"Logits": _u(92, (2, 3, 3)),
                      "Label": np.array([[1, 1, 1], [1, 2, 0]], np.int64)}
    spec["extra"] = {"label_in@SEQ_LEN": np.array([3, 2], np.int32)}
    spec["outputs"] = {"Loss": (2, 1), "WarpCTCGrad": (2, 3, 3)}
    ref, _ = run_op(jfluid, spec)
    port, _ = run_op(tfluid, spec)
    assert np.isfinite(port["loss"]).all() and port["loss"][0, 0] > 1e29
    np.testing.assert_allclose(port["loss"], ref["loss"], rtol=1e-5)
    logp = torch.log_softmax(torch.from_numpy(spec["inputs"]["Logits"]), -1)
    lib = torch.nn.functional.ctc_loss(
        logp.transpose(0, 1), torch.tensor([[1, 1, 1], [1, 2, 0]]),
        torch.tensor([3, 3]), torch.tensor([3, 2]), reduction="none")
    assert torch.isinf(lib[0])
    np.testing.assert_allclose(port["loss"][1, 0], float(lib[1]), rtol=1e-5)
    cots = {"loss": np.ones((2, 1), np.float32)}
    _o, rg = run_op(jfluid, spec, cots)
    _o, pg = run_op(tfluid, spec, cots)
    assert np.isfinite(pg["logits_in"]).all()
    np.testing.assert_allclose(pg["logits_in"][1], rg["logits_in"][1],
                               rtol=1e-4, atol=1e-6)


def test_warpctc_length_inputs_beat_the_companions():
    """LogitsLength and LabelLength, when given, give the lengths (the
    reference reads only the ``@SEQ_LEN`` companions and ignores them;
    ROADMAP C): the port with the length inputs equals the reference
    with the same lengths as companions."""
    base = _spec("warpctc_lengths_norm_by_times")
    ref, _ = run_op(jfluid, base)
    spec = dict(base, extra={}, inputs=dict(
        base["inputs"], LogitsLength=np.array([7, 4, 6], np.int64),
        LabelLength=np.array([3, 1, 3], np.int64)))
    port, _ = run_op(tfluid, spec)
    np.testing.assert_allclose(port["loss"], ref["loss"], rtol=1e-5)


# ---------------------------------------------------------------------------
# host reads: each input of a host op read once, none from a host feed
# ---------------------------------------------------------------------------
HOST_READS = {"edit_distance": 4, "chunk_eval": 3,
              "positive_negative_pair": 3, "unique": 1,
              "unique_with_counts": 1, "crop_tensor_shape": 1}


@pytest.mark.parametrize("name", sorted(HOST_READS))
def test_host_ops_count_their_reads(name):
    """The host metrics read each input (and companion) once when it
    holds values on the device (fed as tensors: ``op_host_reads`` moves
    by the count) and nothing when the feed's host array holds them;
    ``unique`` and a ``crop_tensor`` Shape tensor read once either way
    (the output's size)."""
    if name == "crop_tensor_shape":
        spec = _spec("crop_tensor_to_end")
        spec["inputs"] = dict(spec["inputs"], Shape=np.array([4, 3],
                                                             np.int32))
        spec["attrs"] = {"offsets": [1, 2]}
    else:
        spec = _spec(name)
    reads = HOST_READS[name]
    before = tprofiler.get_counter(tregistry.HOST_READ_COUNTER)
    got, _ = run_op(tfluid, spec, as_tensors=True)
    assert tprofiler.get_counter(tregistry.HOST_READ_COUNTER) == \
        before + reads
    fixed = name in ("unique", "unique_with_counts")
    before = tprofiler.get_counter(tregistry.HOST_READ_COUNTER)
    again, _ = run_op(tfluid, spec)
    assert tprofiler.get_counter(tregistry.HOST_READ_COUNTER) == \
        before + (reads if fixed else 0)
    for n in got:
        np.testing.assert_array_equal(got[n], again[n])
    if name == "crop_tensor_shape":
        np.testing.assert_array_equal(got["out"],
                                      spec["inputs"]["X"][1:5, 2:5])


# ---------------------------------------------------------------------------
# nce: the cost of the port's own draw, and the draw's distribution
# ---------------------------------------------------------------------------
NCE_CLASSES, NCE_DIM, NCE_NEG = 12, 6, 5
NCE_DIST = np.arange(1, NCE_CLASSES + 1, dtype=np.float64)[::-1]
NCE_DIST = (NCE_DIST / NCE_DIST.sum()).astype(np.float32)


def _nce_spec(sampler, batch=7, num_true=2, weight=True):
    inputs = {"Input": _u(100, (batch, NCE_DIM)),
              "Label": _i(101, (batch, num_true), 0, NCE_CLASSES),
              "Weight": _u(102, (NCE_CLASSES, NCE_DIM)),
              "Bias": _u(103, (NCE_CLASSES, 1))}
    if weight:
        inputs["SampleWeight"] = _u(104, (batch, 1), 0.5, 1.5)
    if sampler == 2:
        inputs["CustomDistProbs"] = NCE_DIST
    return dict(op="nce", inputs=inputs,
                outputs={"Cost": (batch, 1),
                         "SampleLogits": (batch, NCE_NEG),
                         "SampleLabels": (batch, NCE_NEG)},
                outs=["Cost"], check=["Input", "Weight", "Bias"],
                attrs={"num_total_classes": NCE_CLASSES,
                       "num_neg_samples": NCE_NEG, "sampler": sampler,
                       "seed": 0}, extra={}, fetch_inputs=[])


def _nce_numpy(inputs, samples, sampler):
    """Cost [B, 1], d cost/d Input, d cost/d Weight and d cost/d Bias of
    ``loss_ops.py:422-438``'s formula in float64 from the draw."""
    x = inputs["Input"].astype(np.float64)
    w = inputs["Weight"].astype(np.float64)
    b = inputs["Bias"].astype(np.float64).reshape(-1)
    lab = inputs["Label"]
    n = NCE_CLASSES
    if sampler == 2:
        q = lambda ids: NCE_DIST.astype(np.float64)[ids]  # noqa: E731
    elif sampler == 1:
        q = lambda ids: np.log((ids + 2.0) / (ids + 1.0)) / np.log(  # noqa
            n + 1.0)
    else:
        q = lambda ids: np.full(ids.shape, 1.0 / n)  # noqa: E731
    sw = inputs.get("SampleWeight", np.ones((x.shape[0], 1))).astype(
        np.float64)[:, 0]
    cost = np.zeros(x.shape[0])
    gx, gw, gb = np.zeros_like(x), np.zeros_like(w), np.zeros_like(b)
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))  # noqa: E731
    for r in range(x.shape[0]):
        for ids, sign, scale in ((lab[r], -1.0, 1.0 / lab.shape[1]),
                                 (samples[r], 1.0, 1.0)):
            z = w[ids] @ x[r] + b[ids]
            adj = z - np.log(NCE_NEG * q(ids))
            cost[r] += scale * np.log1p(np.exp(sign * adj)).sum() * sw[r]
            d = scale * sign * sig(sign * adj) * sw[r]
            gx[r] += d @ w[ids]
            np.add.at(gw, ids, d[:, None] * x[r][None, :])
            np.add.at(gb, ids, d)
    return cost[:, None], gx, gw, gb


@pytest.mark.parametrize("sampler", [0, 1, 2],
                         ids=["uniform", "log_uniform", "custom_dist"])
def test_nce_cost_and_gradient_of_its_own_draw(sampler):
    """``nce``: SampleLabels int64 [B, k] in [0, N); SampleLogits the
    negatives' w·x + b; Cost within 1e-5 of the float64 numpy cost of
    the reference's formula from those samples, and the gradients of
    Input, Weight and Bias (one run: the backward reuses the forward's
    draw) within 1e-4 of its float64 derivative."""
    spec = _nce_spec(sampler)
    cot = np.ones((7, 1), np.float32)
    got, grads = run_op(tfluid, spec, {"cost": cot})
    samples = got["samplelabels"]
    assert samples.dtype == np.int64 and samples.shape == (7, NCE_NEG)
    assert samples.min() >= 0 and samples.max() < NCE_CLASSES
    ins = spec["inputs"]
    np.testing.assert_allclose(
        got["samplelogits"],
        np.einsum("bkd,bd->bk", ins["Weight"][samples], ins["Input"])
        + ins["Bias"][samples, 0], rtol=1e-5, atol=1e-6)
    cost, gx, gw, gb = _nce_numpy(ins, samples, sampler)
    np.testing.assert_allclose(got["cost"], cost, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(grads["input_in"], gx, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(grads["weight_in"], gw, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(grads["bias_in"].reshape(-1), gb, rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("sampler", [0, 1, 2],
                         ids=["uniform", "log_uniform", "custom_dist"])
def test_nce_sampler_frequencies(sampler):
    """Each sampler's draw (4000 rows × 5): the classes' frequencies
    within 5 standard errors of the sampler's law: 1/N uniform,
    log((k+2)/(k+1))/log(N+1) log-uniform, the custom distribution."""
    spec = _nce_spec(sampler, batch=4000, num_true=1, weight=False)
    spec["inputs"]["Label"] = np.zeros((4000, 1), np.int64)
    spec["inputs"]["Input"] = np.zeros((4000, NCE_DIM), np.float32)
    samples = run_op(tfluid, spec)[0]["samplelabels"].reshape(-1)
    k = np.arange(NCE_CLASSES)
    law = {0: np.full(NCE_CLASSES, 1.0 / NCE_CLASSES),
           1: np.log((k + 2.0) / (k + 1.0)) / np.log(NCE_CLASSES + 1.0),
           2: NCE_DIST.astype(np.float64)}[sampler]
    freq = np.bincount(samples, minlength=NCE_CLASSES) / samples.size
    se = np.sqrt(law * (1 - law) / samples.size)
    assert (np.abs(freq - law) <= 5 * se + 1e-12).all(), (freq, law)


def test_nce_seed_attr_fixes_the_draw():
    spec = _nce_spec(0)
    spec["attrs"] = dict(spec["attrs"], seed=5)
    a = run_op(tfluid, spec)[0]["samplelabels"]
    b = run_op(tfluid, spec)[0]["samplelabels"]
    np.testing.assert_array_equal(a, b)


def test_nce_layer_trains():
    """The ``nce`` layer under SGD, 25 steps on a fixed batch (the
    reference's ``test_op_gap_batch1.py`` drive): the loss falls."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[8], dtype="float32")
        y = tfluid.layers.data(name="y", shape=[1], dtype="int64")
        loss = tfluid.layers.mean(tfluid.layers.nce(
            input=x, label=y, num_total_classes=20, num_neg_samples=5,
            seed=3))
        tfluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    feed = {"x": rng.rand(16, 8).astype(np.float32),
            "y": rng.randint(0, 20, (16, 1)).astype(np.int64)}
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0]) for _ in range(25)]
    assert losses[-1] < losses[0], losses


# ---------------------------------------------------------------------------
# the layers: each new name builds the reference's desc
# ---------------------------------------------------------------------------
def _data(fl, name, shape, dtype="float32"):
    return fl.layers.data(name, shape, dtype=dtype, append_batch_size=False)


def _x(fl, shape=(2, 4, 6, 6)):
    return _data(fl, "x", list(shape))


def _ids(fl, name="l", shape=(4, 1)):
    return _data(fl, name, list(shape), "int64")


LAYERS = {
    # nn.py
    "instance_norm": lambda fl, L: L.instance_norm(_x(fl)),
    "lrn": lambda fl, L: L.lrn(_x(fl), n=3, k=2.0),
    "image_resize": lambda fl, L: L.image_resize(_x(fl), [9, 10]),
    "image_resize_nearest_scale": lambda fl, L: L.image_resize(
        _x(fl), scale=1.5, resample="NEAREST", align_corners=False),
    "resize_bilinear": lambda fl, L: L.resize_bilinear(
        _x(fl), out_shape=[12, 3], align_corners=False, align_mode=0),
    "resize_nearest": lambda fl, L: L.resize_nearest(_x(fl), scale=2.0),
    "grid_sampler": lambda fl, L: L.grid_sampler(
        _x(fl), _data(fl, "g", [2, 3, 3, 2])),
    "grid_sampler_nn": lambda fl, L: L.nn.grid_sampler(
        _x(fl), _data(fl, "g", [2, 3, 3, 2])),
    "hsigmoid": lambda fl, L: L.hsigmoid(_data(fl, "a", [4, 5]), _ids(fl),
                                         num_classes=6),
    "hsigmoid_custom": lambda fl, L: L.hsigmoid(
        _data(fl, "a", [4, 5]), _ids(fl), num_classes=6, bias_attr=False,
        path_table=_ids(fl, "pt", (4, 3)), path_code=_ids(fl, "pc", (4, 3)),
        is_custom=True),
    "nce": lambda fl, L: L.nce(_data(fl, "a", [4, 5]), _ids(fl), 10,
                               num_neg_samples=3, seed=2),
    "nce_custom_dist": lambda fl, L: L.nce(
        _data(fl, "a", [4, 5]), _ids(fl), 4, sampler="custom_dist",
        custom_dist=[0.1, 0.2, 0.3, 0.4], bias_attr=False,
        sample_weight=_data(fl, "sw", [4, 1])),
    # metric_op.py
    "auc": lambda fl, L: L.auc(_data(fl, "p", [4, 2]), _ids(fl),
                               num_thresholds=31)[0],
    # extended.py
    "affine_channel": lambda fl, L: L.affine_channel(_x(fl), act="relu"),
    "affine_channel_given": lambda fl, L: L.affine_channel(
        _x(fl), _data(fl, "s", [4]), _data(fl, "b", [4])),
    "bpr_loss": lambda fl, L: L.bpr_loss(_data(fl, "a", [4, 5]), _ids(fl)),
    "center_loss": lambda fl, L: L.center_loss(_data(fl, "a", [4, 5]),
                                               _ids(fl), 3, 0.5),
    "chunk_eval": lambda fl, L: L.chunk_eval(
        _ids(fl, "i", (2, 5)), _ids(fl, "j", (2, 5)), "IOB", 2,
        seq_length=_ids(fl, "n", (2,)))[2],
    "crop": lambda fl, L: L.crop(_x(fl), shape=[1, 2, 3, 3],
                                 offsets=[0, 1, 1, 2]),
    "crop_var": lambda fl, L: L.crop(_x(fl), shape=_data(fl, "y",
                                                         [1, 2, 3, 3]),
                                     offsets=_ids(fl, "o", (4,))),
    "crop_tensor": lambda fl, L: L.crop_tensor(_x(fl), shape=[1, -1, 3, 3]),
    "crop_tensor_var": lambda fl, L: L.crop_tensor(
        _x(fl), shape=_ids(fl, "s", (4,)), offsets=[0, 0, 1, 1]),
    "edit_distance": lambda fl, L: L.edit_distance(
        _ids(fl, "h", (2, 4)), _ids(fl, "r", (2, 5)),
        ignored_tokens=[0], input_length=_ids(fl, "hl", (2,)),
        label_length=_ids(fl, "rl", (2,)))[0],
    "expand_as": lambda fl, L: L.expand_as(_data(fl, "a", [2, 1]),
                                           _data(fl, "b", [2, 3])),
    "gather_nd": lambda fl, L: L.gather_nd(_x(fl), _ids(fl, "i", (3, 2))),
    "hinge_loss": lambda fl, L: L.hinge_loss(_data(fl, "a", [4, 1]),
                                             _data(fl, "b", [4, 1])),
    "kldiv_loss": lambda fl, L: L.kldiv_loss(_data(fl, "a", [4, 5]),
                                             _data(fl, "b", [4, 5]),
                                             "batchmean"),
    "log_loss": lambda fl, L: L.log_loss(_data(fl, "a", [4, 1]),
                                         _data(fl, "b", [4, 1])),
    "margin_rank_loss": lambda fl, L: L.margin_rank_loss(
        _data(fl, "l", [4, 1]), _data(fl, "a", [4, 1]),
        _data(fl, "b", [4, 1]), 0.2),
    "multiplex": lambda fl, L: L.multiplex(
        [_data(fl, "a", [4, 3]), _data(fl, "b", [4, 3])], _ids(fl)),
    "npair_loss": lambda fl, L: L.npair_loss(
        _data(fl, "a", [4, 5]), _data(fl, "b", [4, 5]), _ids(fl)),
    "pad_constant_like": lambda fl, L: L.pad_constant_like(
        _x(fl), _data(fl, "y", [1, 2, 3, 3]), 0.5),
    "pixel_shuffle": lambda fl, L: L.pixel_shuffle(_x(fl), 2),
    "rank_loss": lambda fl, L: L.rank_loss(_data(fl, "l", [4, 1]),
                                           _data(fl, "a", [4, 1]),
                                           _data(fl, "b", [4, 1])),
    "scatter_nd": lambda fl, L: L.scatter_nd(_ids(fl, "i", (3, 1)),
                                             _data(fl, "u", [3, 4]), [5, 4]),
    "scatter_nd_add": lambda fl, L: L.scatter_nd_add(
        _data(fl, "a", [5, 4]), _ids(fl, "i", (3, 1)),
        _data(fl, "u", [3, 4])),
    "selu": lambda fl, L: L.selu(_x(fl), scale=1.1),
    "shard_index": lambda fl, L: L.shard_index(_ids(fl), 20, 2, 1, 7),
    "shuffle_channel": lambda fl, L: L.shuffle_channel(_x(fl), 2),
    "sigmoid_focal_loss": lambda fl, L: L.sigmoid_focal_loss(
        _data(fl, "a", [4, 5]), _ids(fl), _ids(fl, "f", (1,)), 1.5, 0.3),
    "space_to_depth": lambda fl, L: L.space_to_depth(_x(fl), 3),
    "spectral_norm": lambda fl, L: L.spectral_norm(_data(fl, "w", [4, 6]),
                                                   dim=1, power_iters=2),
    "strided_slice": lambda fl, L: L.strided_slice(_x(fl), [1, 3], [0, 5],
                                                   [4, 0], [2, -2]),
    "temporal_shift": lambda fl, L: L.temporal_shift(_x(fl), 2, 0.2),
    "unique": lambda fl, L: L.unique(_ids(fl, "u", (6,)))[1],
    "unique_with_counts": lambda fl, L: L.unique_with_counts(
        _ids(fl, "u", (6,)))[2],
    "warpctc": lambda fl, L: L.warpctc(
        _data(fl, "a", [2, 5, 4]), _ids(fl, "l", (2, 3)), blank=3,
        norm_by_times=True, input_length=_ids(fl, "n", (2,)),
        label_length=_ids(fl, "m", (2,))),
    # compat.py
    "continuous_value_model": lambda fl, L: L.continuous_value_model(
        _data(fl, "a", [4, 5]), _data(fl, "c", [4, 2]), use_cvm=False),
    "ctc_greedy_decoder": lambda fl, L: L.ctc_greedy_decoder(
        _data(fl, "a", [2, 5, 4]), blank=3),
    "image_resize_short": lambda fl, L: L.image_resize_short(
        _x(fl, (1, 3, 6, 9)), 4),
    "mean_iou": lambda fl, L: L.mean_iou(_ids(fl, "p", (2, 5)),
                                         _ids(fl, "q", (2, 5)), 4)[1],
    "teacher_student_sigmoid_loss":
        lambda fl, L: L.teacher_student_sigmoid_loss(
            _data(fl, "a", [4, 1]), _data(fl, "b", [4, 1]), 10.0),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_builds_reference_desc(name):
    """The layer appends the reference's ops (types, slots with their
    variable names, attrs) and startup ops, and returns the same
    variable."""
    ref = _desc(jfluid, LAYERS[name])
    port = _desc(tfluid, LAYERS[name])
    assert [o[0] for o in port[0]] == [o[0] for o in ref[0]]
    for (t, ri, ro, ra), (_t, pi, po, pa) in zip(ref[0], port[0]):
        assert pi == ri and po == ro, t
        assert {k: _norm_attr(v) for k, v in pa.items()} == \
            {k: _norm_attr(v) for k, v in ra.items()}, t
    assert port[1] == ref[1]
    assert port[2] == ref[2]


def test_every_slice_layer_name_is_ported():
    """The names of the reference's ``nn.py``, ``metric_op.py``,
    ``extended.py`` and ``compat.py`` whose ops this slice lowers are in
    ``fluid.layers`` and resolve to the module the reference's do."""
    import importlib

    names = {
        "nn": ["instance_norm", "lrn", "image_resize", "resize_bilinear",
               "resize_nearest", "grid_sampler", "hsigmoid", "nce"],
        "metric_op": ["auc"],
        "compat": ["continuous_value_model", "ctc_greedy_decoder",
                   "image_resize_short", "mean_iou",
                   "teacher_student_sigmoid_loss"],
    }
    names["extended"] = sorted(
        set(importlib.import_module("paddle_tpu.fluid.layers.extended")
            .__all__) - set(_EXTENDED_LEFT))
    assert len(names["extended"]) == 38
    for mod, ns in names.items():
        for n in ns:
            assert hasattr(tfluid.layers, n), (mod, n)
            ref = getattr(jfluid.layers, n).__module__.rsplit(".", 1)[1]
            port = getattr(tfluid.layers, n).__module__.rsplit(".", 1)[1]
            assert port == ref, n


# the extended names whose ops are still unlowered (ROADMAP A16)
_EXTENDED_LEFT = ["affine_grid", "anchor_generator", "bipartite_match",
                  "box_clip", "conv3d", "conv3d_transpose", "data_norm",
                  "density_prior_box", "generate_proposals", "hash",
                  "multiclass_nms", "polygon_box_transform", "pool3d",
                  "roi_align", "roi_pool", "target_assign", "yolo_box"]


def test_ctc_greedy_decoder_decodes_as_the_reference():
    """``ctc_greedy_decoder`` (argmax, then ``ctc_align``) on [2, 6, 4]
    scores: the reference's ids (its int32 against the desc's int64,
    ROADMAP C), and the kept lengths in the output's ``@SEQ_LEN``
    (which the reference does not fetch) those of a numpy decode."""
    scores = _u(110, (2, 6, 4))
    outs = []
    for fl in (jfluid, tfluid):
        main, startup = fl.Program(), fl.Program()
        with fl.unique_name.guard(), fl.program_guard(main, startup):
            out = fl.layers.ctc_greedy_decoder(_data(fl, "a", [2, 6, 4]),
                                               blank=0)
        exe = fl.Executor(fl.CPUPlace())
        scope = fl.Scope() if fl is tfluid else fl.core.Scope()
        fetch = [out] + ([out.name + "@SEQ_LEN"] if fl is tfluid else [])
        outs.append(exe.run(main, feed={"a": scores}, fetch_list=fetch,
                            scope=scope))
    (ref,), (got, got_len) = outs
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.int64
    ids = scores.argmax(-1)
    for b in range(2):
        want = [int(t) for k, t in enumerate(ids[b])
                if t != 0 and (k == 0 or t != ids[b, k - 1])]
        assert got_len[b] == len(want)
        assert list(got[b, :got_len[b]]) == want
        assert not got[b, got_len[b]:].any()
