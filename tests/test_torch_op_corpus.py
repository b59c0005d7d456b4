"""The op corpus of the port's first A16 slice held against the JAX
package on the CPU: every op that ``paddle_tpu/fluid/ops/math_ops.py``,
``tensor_ops.py`` and ``optimizer_ops.py`` register, with
``lookahead_update``, ``conv2d_transpose``,
``depthwise_conv2d_transpose`` and ``group_norm``, and the
``fluid.layers`` names built on them.

Each op runs alone in a one-op program through each package's Executor
on the same numpy inputs: the inputs of the reference's
``tests/test_grad_sweep.py`` ``CASES`` where it has the op, else the case
written here. The forward outputs must match within 1e-5 (fp32) and
exactly (integer and boolean outputs); the gradients of
sum(out · cot) from ``fluid.gradients`` (``append_backward``) within
1e-4 relative. The random ops are held to shape, dtype, range and
moments; each new layer name to the reference's program desc.
"""

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid.ops import math_ops as jmath_ops
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import profiler as tprofiler
from paddle_tpu_torch.fluid.ops import registry as tregistry
from test_grad_sweep import CASES
from test_torch_cpu_math import pin_vector_math

pin_vector_math(2)  # 2 threads, vector math set up on one (see there)


def _u(seed, shape, lo=-1.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# the slice's op types, by the reference module that lowers each
# ---------------------------------------------------------------------------
MATH_OPS = sorted(set(jmath_ops._ACTIVATIONS) - {
    "relu", "sigmoid", "tanh", "sqrt", "ceil", "floor", "cos", "square",
    "exp", "pow", "gelu"}) + [
    "prelu", "reduce_all", "reduce_any", "reduce_max", "reduce_min",
    "reduce_prod", "frobenius_norm", "clip_by_norm", "l2_normalize", "bmm",
    "dot", "bilinear_tensor_product", "fsp", "cos_sim",
    "squared_l2_distance", "sigmoid_cross_entropy_with_logits",
    "huber_loss", "smooth_l1_loss", "maximum", "sign", "maxout", "unfold",
    "add_position_encoding", "similarity_focus", "sampling_id",
    "uniform_random_batch_size_like"]
TENSOR_OPS = [
    "reshape", "transpose", "squeeze", "unsqueeze", "flatten", "flatten2",
    "range", "fill_zeros_like", "fill_any_like", "fill", "fill_zeros_like2",
    "linspace", "diag", "eye", "gaussian_random_batch_size_like",
    "share_data", "shape", "size", "arg_max", "arg_min", "argsort",
    "where_index", "isinf", "isnan", "stack", "unstack", "scatter", "pad",
    "pad2d", "reverse", "lookup_table_v2", "one_hot_v2", "random_crop",
    "tensor_array_to_tensor"]
NN_OPS = ["conv2d_transpose", "depthwise_conv2d_transpose", "group_norm"]
UPDATE_OPS = ["lars_momentum", "adamax", "decayed_adagrad", "rmsprop",
              "adadelta", "ftrl", "lamb", "dpsgd", "dgc_momentum",
              "lookahead_update"]
SLICE_OPS = MATH_OPS + TENSOR_OPS + NN_OPS + UPDATE_OPS

RANDOM_OPS = {"sampling_id", "uniform_random_batch_size_like",
              "gaussian_random_batch_size_like", "random_crop"}


def test_slice_has_99_op_types():
    assert len(SLICE_OPS) == len(set(SLICE_OPS)) == 99


def test_registry_holds_every_op_of_the_three_reference_modules():
    """Accounting: every op type the reference lowers in
    ``math_ops.py``, ``tensor_ops.py`` and ``optimizer_ops.py``, plus
    ``lookahead_update``, ``conv2d_transpose``,
    ``depthwise_conv2d_transpose`` and ``group_norm``, is in the port's
    registry, which holds 315 of the reference's 407 (the second slice's
    op types: ``tests/test_torch_op_corpus_2.py``)."""
    import inspect
    import re

    from paddle_tpu.fluid.ops import optimizer_ops as jopt
    from paddle_tpu.fluid.ops import tensor_ops as jtensor

    want = set(jmath_ops._ACTIVATIONS)
    for mod in (jmath_ops, jtensor, jopt):
        src = inspect.getsource(mod)
        want |= set(re.findall(r'(?:@op|register_op|_register_\w+)\(\s*'
                               r'"([a-z0-9_]+)"', src))
    want |= {"lookahead_update", "conv2d_transpose",
             "depthwise_conv2d_transpose", "group_norm"}
    # a generic ``<op>_grad`` the registry made on first use is not a type
    port = {t for t in tregistry.all_op_types()
            if not tregistry.is_generic_grad(t)}
    assert not sorted(want - port)
    assert set(SLICE_OPS) <= want
    assert len(port) == 315


# ---------------------------------------------------------------------------
# cases written here, in the grad sweep's form: inputs {slot: array or
# [(name, array)]}, outputs {slot: shape or [(name, shape)]}, outs (the
# slots the gradient's objective reads), check (input slots to
# differentiate; default every float input), attrs
# ---------------------------------------------------------------------------
_X34 = _u(200, (3, 4))
LOCAL = {
    "prelu_channel": dict(op="prelu", inputs={
        "X": _u(201, (2, 3, 2, 2)), "Alpha": _u(202, (1, 3, 1, 1), 0.1, 0.5)},
        outputs={"Out": (2, 3, 2, 2)}, attrs={"mode": "channel"}),
    "prelu_element": dict(op="prelu", inputs={
        "X": _u(203, (2, 3, 2, 2)), "Alpha": _u(204, (3, 2, 2), 0.1, 0.5)},
        outputs={"Out": (2, 3, 2, 2)}, attrs={"mode": "element"}),
    "reduce_all": dict(inputs={"X": _X34 > 0}, outputs={"Out": (3,)},
                       attrs={"dim": [1], "keep_dim": False}),
    "reduce_any": dict(inputs={"X": _X34 > 0.5}, outputs={"Out": (1,)},
                       attrs={"dim": [0], "reduce_all": True}),
    "reduce_max_keep": dict(op="reduce_max", inputs={"X": _u(205, (2, 3, 4))},
                            outputs={"Out": (2, 1, 1)},
                            attrs={"dim": [1, 2], "keep_dim": True}),
    "reduce_prod_all": dict(op="reduce_prod", inputs={
        "X": _u(206, (2, 3), 0.5, 1.5)}, outputs={"Out": (1,)},
        attrs={"reduce_all": True}),
    "bilinear_tensor_product": dict(inputs={
        "X": _u(207, (4, 5)), "Y": _u(208, (4, 6)),
        "Weight": _u(209, (3, 5, 6)), "Bias": _u(210, (1, 3))},
        outputs={"Out": (4, 3)}),
    "fsp": dict(inputs={"X": _u(211, (2, 3, 4, 4)),
                        "Y": _u(212, (2, 5, 4, 4))},
                outputs={"Out": (2, 3, 5)}),
    "cos_sim": dict(inputs={"X": _u(213, (4, 5)), "Y": _u(214, (4, 5))},
                    outputs={"Out": (4, 1), "XNorm": (4, 1),
                             "YNorm": (4, 1)}, outs=["Out"]),
    "cos_sim_broadcast": dict(op="cos_sim", inputs={
        "X": _u(215, (4, 5)), "Y": _u(216, (1, 5))},
        outputs={"Out": (4, 1), "XNorm": (4, 1), "YNorm": (1, 1)},
        outs=["Out"]),
    "squared_l2_distance": dict(inputs={"X": _u(217, (4, 5)),
                                        "Y": _u(218, (4, 5))},
                                outputs={"Out": (4, 1),
                                         "sub_result": (4, 5)},
                                outs=["Out"]),
    "sigmoid_cross_entropy_with_logits": dict(inputs={
        "X": _u(219, (4, 3), -3, 3),
        "Label": (_u(220, (4, 3)) > 0).astype(np.float32)},
        outputs={"Out": (4, 3)}, check=["X"]),
    "sigmoid_xent_ignore_normalize": dict(
        op="sigmoid_cross_entropy_with_logits", inputs={
            "X": _u(221, (4, 3), -3, 3),
            "Label": np.array([[1, 0, -1], [0, 0, 1], [-1, 1, 1], [0, 1, 0]],
                              np.float32)},
        outputs={"Out": (4, 3)}, check=["X"],
        attrs={"ignore_index": -1, "normalize": True}),
    "add_position_encoding": dict(inputs={"X": _u(222, (2, 5, 7))},
                                  outputs={"Out": (2, 5, 7)},
                                  attrs={"alpha": 0.7, "beta": 1.3}),
    "similarity_focus": dict(inputs={"X": _u(223, (2, 3, 4, 5))},
                             outputs={"Out": (2, 3, 4, 5)},
                             attrs={"axis": 1, "indexes": [0, 2]}),
    "sign": dict(inputs={"X": np.array([[-1.5, 0.0, 2.0]], np.float32)},
                 outputs={"Out": (1, 3)}),
    "unfold_stride_pad": dict(op="unfold", inputs={"X": _u(224, (1, 2, 5, 5))},
                              outputs={"Y": (1, 8, 9)},
                              attrs={"kernel_sizes": [2, 2],
                                     "strides": [2, 2],
                                     "paddings": [1, 0, 0, 1],
                                     "dilations": [1, 1]}),
    "fill_zeros_like": dict(inputs={"X": _X34}, outputs={"Out": (3, 4)}),
    "fill_any_like": dict(inputs={"X": _X34}, outputs={"Out": (3, 4)},
                          attrs={"value": 2.5, "dtype": -1}),
    "fill": dict(inputs={}, outputs={"Out": (2, 3)},
                 attrs={"shape": [2, 3], "dtype": 5,
                        "value": [1.0, 2, 3, 4, 5, 6.5]}),
    "fill_zeros_like2": dict(inputs={"X": _X34}, outputs={"Out": (3, 4)},
                             attrs={"dtype": 5}),
    "diag": dict(inputs={"Diagonal": _u(225, (4,))}, outputs={"Out": (4, 4)}),
    "eye": dict(inputs={}, outputs={"Out": (3, 5)},
                attrs={"num_rows": 3, "num_columns": 5, "dtype": 5}),
    "shape": dict(inputs={"Input": _u(226, (2, 3, 4))}, outputs={"Out": (3,)}),
    "size": dict(inputs={"Input": _u(227, (2, 3, 4))}, outputs={"Out": ()}),
    "arg_max": dict(inputs={"X": np.array([[1, 3, 3, 0], [2, 2, 1, 5]],
                                          np.float32)},
                    outputs={"Out": (2,)}, attrs={"axis": 1}),
    "arg_min": dict(inputs={"X": np.array([[1, 0, 3, 0], [2, 2, 1, 5]],
                                          np.float32)},
                    outputs={"Out": (4,)}, attrs={"axis": 0}),
    "argsort": dict(inputs={"X": np.array([[3, 1, 2, 1], [0, 5, 5, 4]],
                                          np.float32)},
                    outputs={"Out": (2, 4), "Indices": (2, 4)},
                    attrs={"axis": 1}, outs=["Out"]),
    "isinf": dict(inputs={"X": np.array([1.0, np.inf, 2.0], np.float32)},
                  outputs={"Out": (1,)}),
    "isnan": dict(inputs={"X": np.array([1.0, 2.0, 3.0], np.float32)},
                  outputs={"Out": (1,)}),
    "pad2d_reflect_nhwc": dict(op="pad2d", inputs={"X": _u(228, (2, 4, 4, 3))},
                               outputs={"Out": (2, 7, 5, 3)},
                               attrs={"paddings": [1, 2, 0, 1],
                                      "mode": "reflect",
                                      "data_format": "NHWC"}),
    "pad2d_edge": dict(op="pad2d", inputs={"X": _u(229, (2, 3, 4, 4))},
                       outputs={"Out": (2, 3, 6, 5)},
                       attrs={"paddings": [1, 1, 0, 1], "mode": "edge",
                              "data_format": "NCHW"}),
    "scatter_add": dict(op="scatter", inputs={
        "X": _u(230, (5, 3)), "Ids": np.array([1, 3], np.int64),
        "Updates": _u(231, (2, 3))}, outputs={"Out": (5, 3)},
        check=["X", "Updates"], attrs={"overwrite": False}),
    "one_hot_v2": dict(inputs={"X": np.array([[1, 0], [3, 7]], np.int64)},
                       outputs={"Out": (2, 2, 4)}, attrs={"depth": 4}),
    "tensor_array_to_tensor": dict(inputs={"X": _u(232, (3, 2, 4))},
                                   outputs={"Out": (2, 12),
                                            "OutIndex": (3,)},
                                   attrs={"axis": 1}, outs=["Out"]),
    "tensor_array_to_tensor_stack": dict(
        op="tensor_array_to_tensor", inputs={"X": _u(233, (3, 2, 4))},
        outputs={"Out": (2, 3, 4), "OutIndex": (3,)},
        attrs={"axis": 1, "use_stack": True}, outs=["Out"]),
    "conv2d_transpose_stride_pad_dil": dict(
        op="conv2d_transpose",
        inputs={"Input": _u(234, (2, 3, 5, 5)),
                "Filter": _u(235, (3, 2, 3, 3), -0.5, 0.5)},
        outputs={"Output": (2, 2, 11, 11)}, outs=["Output"],
        attrs={"strides": [2, 2], "paddings": [1, 1], "dilations": [2, 2],
               "groups": 1}),
    "conv2d_transpose_groups": dict(
        op="conv2d_transpose",
        inputs={"Input": _u(236, (2, 4, 4, 4)),
                "Filter": _u(237, (4, 1, 3, 3), -0.5, 0.5)},
        outputs={"Output": (2, 2, 6, 6)}, outs=["Output"],
        attrs={"strides": [1, 1], "paddings": [0, 0], "dilations": [1, 1],
               "groups": 2}),
    "group_norm": dict(inputs={"X": _u(238, (2, 4, 3, 3)),
                               "Scale": _u(239, (4,), 0.5, 1.5),
                               "Bias": _u(240, (4,))},
                       outputs={"Y": (2, 4, 3, 3), "Mean": (2, 2),
                                "Variance": (2, 2)},
                       attrs={"groups": 2, "epsilon": 1e-5}, outs=["Y"]),
}


def _update_cases():
    """One-op runs of the update ops, outputs named as their inputs (in
    place); inputs: a parameter [3, 4] and its state."""
    p, g = _u(300, (3, 4)), _u(301, (3, 4))
    lr = np.array([0.1], np.float32)
    pos = lambda s: _u(s, (3, 4), 0.1, 1.0)  # noqa: E731
    b = lambda v: np.array([v], np.float32)  # noqa: E731
    cases = {
        "lars_momentum": ({"Velocity": _u(302, (3, 4))},
                          {"mu": 0.9, "lars_coeff": 0.001,
                           "lars_weight_decay": 0.0005}),
        "adamax": ({"Moment": _u(303, (3, 4)), "InfNorm": pos(304),
                    "Beta1Pow": b(0.81)}, {"beta1": 0.9, "beta2": 0.999,
                                           "epsilon": 1e-8}),
        "decayed_adagrad": ({"Moment": pos(305)}, {"decay": 0.9,
                                                   "epsilon": 1e-6}),
        "rmsprop": ({"MeanSquare": pos(306), "Moment": _u(307, (3, 4)),
                     "MeanGrad": _u(308, (3, 4), -0.1, 0.1)},
                    {"decay": 0.9, "epsilon": 1e-6, "momentum": 0.5,
                     "centered": True}),
        "adadelta": ({"AvgSquaredGrad": pos(309),
                      "AvgSquaredUpdate": pos(310)},
                     {"rho": 0.9, "epsilon": 1e-6}),
        "ftrl": ({"SquaredAccumulator": pos(311),
                  "LinearAccumulator": _u(312, (3, 4))},
                 {"l1": 0.01, "l2": 0.02, "lr_power": -0.5}),
        "lamb": ({"Moment1": _u(313, (3, 4)), "Moment2": pos(314),
                  "Beta1Pow": b(0.9), "Beta2Pow": b(0.999)},
                 {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6,
                  "weight_decay": 0.01}),
        "dpsgd": ({}, {"clip": 0.5, "batch_size": 4.0, "sigma": 0.0}),
        "dgc_momentum": ({"Velocity": _u(315, (3, 4)), "U": _u(316, (3, 4)),
                          "V": _u(317, (3, 4)),
                          "CurrentStep": np.array([3.0], np.float32)},
                         {"mu": 0.9, "sparsity_ratio": 0.75,
                          "rampup_begin_step": 2.0}),
        "lookahead_update": ({"SlowParam": _u(318, (3, 4)),
                              "Step": np.array([10], np.int64)},
                             {"alpha": 0.3, "k": 5}),
    }
    out = {}
    outs_of = {"Velocity": "VelocityOut", "Moment": "MomentOut",
               "InfNorm": "InfNormOut", "MeanSquare": "MeanSquareOut",
               "MeanGrad": "MeanGradOut",
               "AvgSquaredGrad": "AvgSquaredGradOut",
               "AvgSquaredUpdate": "AvgSquaredUpdateOut",
               "SquaredAccumulator": "SquaredAccumOut",
               "LinearAccumulator": "LinearAccumOut",
               "Moment1": "Moment1Out", "Moment2": "Moment2Out",
               "Beta1Pow": "Beta1PowOut", "Beta2Pow": "Beta2PowOut",
               "U": "UOut", "V": "VOut", "SlowParam": "SlowParamOut"}
    for op_type, (state, attrs) in cases.items():
        inputs = {"Param": p}
        if op_type != "lookahead_update":
            inputs["Grad"] = g
        if op_type not in ("adadelta", "lookahead_update"):
            inputs["LearningRate"] = lr
        inputs.update(state)
        inplace = {"ParamOut": "Param"}
        inplace.update({outs_of[s]: s for s in state if s in outs_of
                        and not (op_type == "adamax" and s == "Beta1Pow")})
        out[op_type] = dict(op=op_type, inputs=inputs, inplace=inplace,
                            attrs=attrs, check=None, outs=None)
    return out


UPDATE = _update_cases()


def _spec(name):
    if name in LOCAL:
        spec = dict(LOCAL[name])
        spec.setdefault("op", name)
    elif name in UPDATE:
        return UPDATE[name]
    else:
        c = CASES[name]
        spec = dict(op=c.get("op_type", name), inputs=c["inputs"],
                    attrs=c.get("attrs", {}), outs=c.get("outs"),
                    check=c.get("check"),
                    outputs={s: ([(n, z.shape) for n, z in v]
                                 if isinstance(v, list) else v.shape)
                             for s, v in c["outputs"].items()})
    spec.setdefault("attrs", {})
    spec.setdefault("outs", None)
    spec.setdefault("check", None)
    return spec


# ---------------------------------------------------------------------------
# one op through both packages
# ---------------------------------------------------------------------------
def _feeds(spec):
    """[(slot, [(name, array)])] of the spec's inputs."""
    out = []
    for slot, v in spec["inputs"].items():
        if isinstance(v, list):
            out.append((slot, list(v)))
        else:
            out.append((slot, [(slot.lower() + "_in", v)]))
    return out


def _is_float(a):
    return np.asarray(a).dtype.kind == "f"


def run_op(fl, spec, cots=None):
    """Run the spec's op alone through package ``fl``: the outputs
    ({name: array}) and, given ``cots`` ({output name: array}), the
    gradients of Σ sum(out · cot) with respect to the differentiated
    inputs ({input name: array})."""
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
        if "inplace" in spec:
            names = {s: p[0][0] for s, p in feeds}
            for oslot, islot in spec["inplace"].items():
                outputs[oslot] = [var[names[islot]]]
                out_names.append(names[islot])
        else:
            for slot, v in spec["outputs"].items():
                pairs = v if isinstance(v, list) else [(slot.lower(), v)]
                outputs[slot] = [block.create_var(name=n) for n, _s in pairs]
                out_names += [n for n, _s in pairs]
        block.append_op(type=spec["op"],
                        inputs={s: [var[n] for n, _a in p] for s, p in feeds},
                        outputs=outputs, attrs=dict(spec["attrs"]))
        fetch = [block.var(n) for n in out_names]
        if cots:
            terms = []
            for n, cot in cots.items():
                c = block.create_var(name=n + "_cot", shape=list(cot.shape),
                                     dtype="float32")
                feed[n + "_cot"] = cot
                terms.append(fl.layers.reduce_sum(fl.layers.elementwise_mul(
                    block.var(n), c)))
            loss = terms[0] if len(terms) == 1 else fl.layers.sums(terms)
            fetch += fl.gradients([loss], [var[n] for n in wrt])
    exe = fl.Executor(fl.CPUPlace())
    scope = fl.Scope() if fl is tfluid else fl.core.Scope()
    got = [np.asarray(g) for g in exe.run(main, feed=feed, fetch_list=fetch,
                                          scope=scope)]
    return (dict(zip(out_names, got[:len(out_names)])),
            dict(zip(wrt, got[len(out_names):])))


def _grad_outputs(spec, outs):
    """{output name: cot} for the float outputs the objective reads."""
    slots = spec["outs"] or list(spec.get("outputs", {}))
    names = []
    for slot in slots:
        v = spec["outputs"][slot]
        names += [n for n, _s in v] if isinstance(v, list) else [
            slot.lower()]
    rs = np.random.RandomState(7)
    return {n: rs.standard_normal(outs[n].shape).astype(np.float32)
            for n in names if _is_float(outs[n])}


def _has_grad(op_type):
    d = tregistry.get_op_def(op_type)
    return d.grad_maker is not None


def _index_dtype_case(name):
    """The ops whose index output keeps the desc's int64 where the
    reference's JAX (x64 off) gives int32 (ROADMAP C)."""
    return _spec(name)["op"] in ("arg_max", "arg_min", "argsort", "size")


FORWARD = sorted((set(SLICE_OPS) - RANDOM_OPS - {
    "where_index", "range", "linspace"} - set(UPDATE)) | set(LOCAL)) + \
    sorted(UPDATE)


@pytest.mark.parametrize("name", FORWARD)
def test_op_matches_reference(name):
    """Forward: float outputs within 1e-5, integer and boolean ones
    exactly (an index output in int64 where the reference has int32).
    Gradient (ops with one): each input's within 1e-4 relative."""
    spec = _spec(name)
    ref, _ = run_op(jfluid, spec)
    port, _ = run_op(tfluid, spec)
    for n, want in ref.items():
        got = port[n]
        assert got.shape == want.shape, n
        if _is_float(want):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                       err_msg=n)
        else:
            np.testing.assert_array_equal(got, want, err_msg=n)
            if _index_dtype_case(name) and want.dtype.kind in "iu":
                assert got.dtype == np.int64, n
            elif want.dtype == np.bool_:
                assert got.dtype == np.bool_, n
    if "inplace" in spec or not _has_grad(spec["op"]):
        return
    cots = _grad_outputs(spec, ref)
    if not cots:
        return
    _o, rg = run_op(jfluid, spec, cots)
    replays = tprofiler.get_counter(tregistry.REPLAY_COUNTER)
    _o, pg = run_op(tfluid, spec, cots)
    assert tprofiler.get_counter(tregistry.REPLAY_COUNTER) == replays
    assert rg and set(pg) == set(rg)
    for n, want in rg.items():
        np.testing.assert_allclose(pg[n], want, rtol=1e-4, atol=1e-6,
                                   err_msg=n + "@GRAD")


def test_conv2d_transpose_groups_matches_its_definition():
    """``groups`` > 1 with several output channels a group, held to the
    definition (each input pixel scatters its filter into the output, per
    group) in float64 numpy: the reference's regrouped kernel is right
    only at one output channel a group (ROADMAP C), so the port is held
    to the definition here; shapes equal the reference's infer."""
    x = _u(400, (2, 4, 3, 3)).astype(np.float64)
    w = _u(401, (4, 3, 2, 2)).astype(np.float64)  # C_in, C_out/g, kh, kw
    groups, stride, pad, dil = 2, 2, 1, 1
    spec = dict(op="conv2d_transpose",
                inputs={"Input": x.astype(np.float32),
                        "Filter": w.astype(np.float32)},
                outputs={"Output": (2, 6, 4, 4)}, outs=None, check=None,
                attrs={"strides": [stride] * 2, "paddings": [pad] * 2,
                       "dilations": [dil] * 2, "groups": groups})
    got = run_op(tfluid, spec)[0]["output"]
    n, cin, h, wd = x.shape
    cog, kh, kw = w.shape[1:]
    full = np.zeros((n, cog * groups, (h - 1) * stride + kh,
                     (wd - 1) * stride + kw))
    cig = cin // groups
    for c in range(cin):
        gi = c // cig
        for i in range(h):
            for j in range(wd):
                full[:, gi * cog:(gi + 1) * cog, i * stride:i * stride + kh,
                     j * stride:j * stride + kw] += (
                    x[:, c, i, j][:, None, None, None] * w[c][None])
    want = full[:, :, pad:full.shape[2] - pad, pad:full.shape[3] - pad]
    assert got.shape == want.shape == (2, 6, 4, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with jfluid.unique_name.guard():
        main = jfluid.Program()
        with jfluid.program_guard(main, jfluid.Program()):
            xv = jfluid.layers.data("x", [4, 3, 3], dtype="float32")
            out = jfluid.layers.conv2d_transpose(xv, 6, filter_size=2,
                                                 stride=2, padding=1,
                                                 groups=2, bias_attr=False)
    assert tuple(out.shape[1:]) == got.shape[1:]


def test_where_index_reads_once_on_the_host():
    """``where_index``: the int64 coordinates of the nonzero entries,
    equal to ``np.argwhere``; the count is read on the host
    (``op_host_reads`` moves by one). The reference's raises: JAX has
    no shape that depends on data (ROADMAP C)."""
    cond = np.array([[True, False, True], [False, False, True]])
    spec = dict(op="where_index", inputs={"Condition": cond},
                outputs={"Out": (3, 2)}, attrs={}, outs=None, check=None)
    before = tprofiler.get_counter(tregistry.HOST_READ_COUNTER)
    out = run_op(tfluid, spec)[0]["out"]
    assert tprofiler.get_counter(tregistry.HOST_READ_COUNTER) == before + 1
    assert out.dtype == np.int64
    np.testing.assert_array_equal(out, np.argwhere(cond))
    with pytest.raises(Exception, match="data-dependent"):
        run_op(jfluid, spec)


def _run_layer(fl, build):
    """``build(fl.layers)``'s value: the port's through its Executor; the
    reference's under its dygraph guard, where the inputs are concrete
    (its jitted program traces them and then cannot size the output)."""
    if fl is jfluid:
        with jfluid.dygraph.guard(jfluid.CPUPlace()):
            return np.asarray(build(jfluid.layers).numpy())
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        out = build(fl.layers)
    exe = fl.Executor(fl.CPUPlace())
    scope = fl.Scope() if fl is tfluid else fl.core.Scope()
    return np.asarray(exe.run(main, fetch_list=[out], scope=scope)[0])


SHAPE_FROM_VALUES = {
    "range_float": (lambda L: L.range(1.0, 7.5, 1.5, "float32"), 3),
    "range_int": (lambda L: L.range(2, 11, 3, "int64"), 3),
    "range_negative_step": (lambda L: L.range(5.0, -1.0, -2.0, "float32"),
                            3),
    "linspace": (lambda L: L.linspace(-1.0, 2.0, 7, "float32"), 1),
    "linspace_one": (lambda L: L.linspace(3.0, 4.0, 1, "float32"), 1),
}


@pytest.mark.parametrize("name", sorted(SHAPE_FROM_VALUES))
def test_range_and_linspace_match_reference(name):
    """``range`` and ``linspace`` from ``fill_constant`` inputs (the
    reference needs them concrete: its dygraph): values within 1e-5
    (integers exactly), and the port reads Start, End and Step (range)
    or Num (linspace) on the host, each read counted in
    ``op_host_reads``."""
    build, reads = SHAPE_FROM_VALUES[name]
    ref = _run_layer(jfluid, build)
    before = tprofiler.get_counter(tregistry.HOST_READ_COUNTER)
    got = _run_layer(tfluid, build)
    assert tprofiler.get_counter(tregistry.HOST_READ_COUNTER) == \
        before + reads
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_shape_and_size_read_nothing_on_the_host():
    """``shape`` and ``size`` come from the tensor's own metadata: no
    read counted."""
    for name in ("shape", "size"):
        before = tprofiler.get_counter(tregistry.HOST_READ_COUNTER)
        run_op(tfluid, _spec(name))
        assert tprofiler.get_counter(tregistry.HOST_READ_COUNTER) == before


# ---------------------------------------------------------------------------
# random ops: shape, dtype, range and moments
# ---------------------------------------------------------------------------
def _random_spec(name):
    x = np.zeros((4000, 3), np.float32)
    return {
        "uniform_random_batch_size_like": dict(
            op=name, inputs={"Input": x}, outputs={"Out": (4000, 5)},
            attrs={"shape": [-1, 5], "min": -2.0, "max": 3.0, "dtype": 5}),
        "gaussian_random_batch_size_like": dict(
            op=name, inputs={"Input": x}, outputs={"Out": (4000, 5)},
            attrs={"shape": [-1, 5], "mean": 1.5, "std": 2.0, "dtype": 5}),
        "sampling_id": dict(
            op=name, inputs={"X": np.tile(np.array([[0.1, 0.6, 0.3]],
                                                   np.float32), (4000, 1))},
            outputs={"Out": (4000,)}, attrs={}),
        "random_crop": dict(
            op=name, inputs={"X": np.random.RandomState(0).rand(
                2, 3, 8, 8).astype(np.float32)},
            outputs={"Out": (2, 3, 5, 5)}, attrs={"shape": [5, 5]}),
    }[name]


@pytest.mark.parametrize("name", sorted(RANDOM_OPS))
def test_random_op_shape_dtype_range_and_moments(name):
    """The random ops cannot match the reference's draws: each is held
    to the reference's shape and dtype, its range and its first two
    moments (4000 draws: 5 standard errors), ``random_crop`` to the
    content check of the reference's ``tests/test_op_gap_batch1.py``
    (every value of a crop is one of the source's), and each [H, W] crop
    a contiguous window of its source."""
    spec = dict(_random_spec(name), outs=None, check=None)
    ref = next(iter(run_op(jfluid, spec)[0].values()))
    got = next(iter(run_op(tfluid, spec)[0].values()))
    assert got.shape == ref.shape
    want_dtype = np.int64 if name == "sampling_id" else ref.dtype
    assert got.dtype == want_dtype
    if name == "uniform_random_batch_size_like":
        assert got.min() >= -2.0 and got.max() < 3.0
        assert abs(got.mean() - 0.5) < 5 * 5 / np.sqrt(12 * got.size)
        assert abs(got.var() - 25 / 12) < 0.1
    elif name == "gaussian_random_batch_size_like":
        assert abs(got.mean() - 1.5) < 5 * 2.0 / np.sqrt(got.size)
        assert abs(got.std() - 2.0) < 0.05
    elif name == "sampling_id":
        assert set(np.unique(got)) <= {0, 1, 2}
        freq = np.bincount(got, minlength=3) / got.size
        np.testing.assert_allclose(freq, [0.1, 0.6, 0.3], atol=0.04)
    else:
        x = spec["inputs"]["X"]
        assert np.isin(np.round(got, 5), np.round(x, 5)).all()
        for b in range(2):
            for c in range(3):  # each [H, W] of the leading dims alone
                i, j = np.argwhere(x[b, c] == got[b, c, 0, 0])[0]
                np.testing.assert_array_equal(got[b, c],
                                              x[b, c, i:i + 5, j:j + 5])


def test_random_ops_follow_the_seed_attr():
    """A nonzero ``seed`` attr fixes the draw: two runs agree."""
    spec = dict(_random_spec("uniform_random_batch_size_like"), outs=None,
                check=None)
    spec["attrs"] = dict(spec["attrs"], seed=11)
    a = run_op(tfluid, spec)[0]["out"]
    b = run_op(tfluid, spec)[0]["out"]
    np.testing.assert_array_equal(a, b)


def test_dpsgd_noise_has_the_stated_scale():
    """``dpsgd`` at σ > 0: the update minus the noiseless one is
    N(0, (σ·clip·lr/batch)²) (4000 entries, the std within 5%)."""
    g = np.full((4000,), 1e-3, np.float32)
    p = np.zeros((4000,), np.float32)
    spec = dict(op="dpsgd", inputs={"Param": p, "Grad": g,
                                    "LearningRate": np.array([0.5],
                                                             np.float32)},
                inplace={"ParamOut": "Param"}, check=None, outs=None,
                attrs={"clip": 2.0, "batch_size": 4.0, "sigma": 0.8})
    got = run_op(tfluid, spec)[0]["param_in"]
    noiseless = -0.5 * g / 4.0
    d = got - noiseless
    assert abs(d.std() - 0.8 * 2.0 * 0.5 / 4.0) < 0.05 * 0.2
    assert abs(d.mean()) < 5 * 0.2 / np.sqrt(d.size)


# ---------------------------------------------------------------------------
# the layers: each new name builds the reference's desc
# ---------------------------------------------------------------------------
def _data(fl, name, shape, dtype="float32"):
    return fl.layers.data(name, shape, dtype=dtype,
                          append_batch_size=False)


def _x(fl, shape=(2, 3, 4, 4)):
    return _data(fl, "x", list(shape))


LAYERS = {
    # ops.py
    **{n: (lambda n: lambda fl, L: getattr(L, n)(_x(fl)))(n) for n in [
        "abs", "acos", "asin", "atan", "erf", "gelu", "log", "logsigmoid",
        "reciprocal", "round", "rsqrt", "sin", "softplus", "softsign",
        "tanh_shrink"]},
    "softshrink": lambda fl, L: L.softshrink(_x(fl), **{"lambda": 0.3}),
    "hard_shrink": lambda fl, L: L.hard_shrink(_x(fl), threshold=0.2),
    "thresholded_relu": lambda fl, L: L.thresholded_relu(_x(fl),
                                                         threshold=0.4),
    # tensor.py
    "argmax": lambda fl, L: L.argmax(_x(fl), axis=1),
    "argmin": lambda fl, L: L.argmin(_x(fl), axis=2),
    "argsort": lambda fl, L: L.argsort(_x(fl), axis=1)[1],
    "create_tensor": lambda fl, L: L.assign(_x(fl), L.create_tensor(
        "float32", name="ct")),
    "diag": lambda fl, L: L.diag(_data(fl, "d", [4])),
    "linspace": lambda fl, L: L.linspace(0.0, 1.0, 5, "float32"),
    "range": lambda fl, L: L.range(0, 6, 2, "int64"),
    "reverse": lambda fl, L: L.reverse(_x(fl), [1, 2]),
    "zeros": lambda fl, L: L.zeros([2, 3], "float32"),
    "ones": lambda fl, L: L.ones([2, 3], "int64"),
    "zeros_like": lambda fl, L: L.zeros_like(_x(fl)),
    "ones_like": lambda fl, L: L.ones_like(_x(fl)),
    "has_inf": lambda fl, L: L.has_inf(_x(fl)),
    "has_nan": lambda fl, L: L.has_nan(_x(fl)),
    # nn.py
    "brelu": lambda fl, L: L.brelu(_x(fl), 1.0, 5.0),
    "elu": lambda fl, L: L.elu(_x(fl), 0.5),
    "leaky_relu": lambda fl, L: L.leaky_relu(_x(fl), 0.1),
    "relu6": lambda fl, L: L.relu6(_x(fl), 5.0),
    "swish": lambda fl, L: L.swish(_x(fl), 2.0),
    "hard_swish": lambda fl, L: L.hard_swish(_x(fl)),
    "hard_sigmoid": lambda fl, L: L.hard_sigmoid(_x(fl), 0.3),
    "soft_relu": lambda fl, L: L.soft_relu(_x(fl), 20.0),
    "stanh": lambda fl, L: L.stanh(_x(fl)),
    "pow": lambda fl, L: L.pow(_x(fl), 3.0),
    "sign": lambda fl, L: L.sign(_x(fl)),
    "prelu": lambda fl, L: L.prelu(_x(fl), "channel"),
    "prelu_element": lambda fl, L: L.prelu(_x(fl), "element"),
    "maxout": lambda fl, L: L.maxout(_data(fl, "m", [2, 4, 3, 3]), 2),
    "cos_sim": lambda fl, L: L.cos_sim(_data(fl, "a", [4, 5]),
                                       _data(fl, "b", [4, 5])),
    "l2_normalize": lambda fl, L: L.l2_normalize(_x(fl), axis=1),
    "clip_by_norm": lambda fl, L: L.clip_by_norm(_x(fl), 2.0),
    "reduce_max": lambda fl, L: L.reduce_max(_x(fl), dim=1),
    "reduce_min": lambda fl, L: L.reduce_min(_x(fl), dim=[1, 2],
                                             keep_dim=True),
    "reduce_prod": lambda fl, L: L.reduce_prod(_x(fl)),
    "reduce_all": lambda fl, L: L.reduce_all(_data(fl, "c", [2, 3],
                                                   "bool")),
    "reduce_any": lambda fl, L: L.reduce_any(_data(fl, "c", [2, 3], "bool"),
                                             dim=0),
    "pad": lambda fl, L: L.pad(_x(fl), [0, 0, 1, 1, 0, 2, 1, 0], 0.5),
    "pad2d": lambda fl, L: L.pad2d(_x(fl), [1, 0, 2, 1], mode="reflect"),
    "stack": lambda fl, L: L.stack([_x(fl), _x(fl)], axis=1),
    "unstack": lambda fl, L: L.unstack(_x(fl), axis=1)[2],
    "scatter": lambda fl, L: L.scatter(
        _data(fl, "s", [5, 3]), _data(fl, "i", [2], "int64"),
        _data(fl, "u", [2, 3]), overwrite=False),
    "shape": lambda fl, L: L.shape(_x(fl)),
    "flatten": lambda fl, L: L.flatten(_x(fl), axis=2),
    "unfold": lambda fl, L: L.unfold(_x(fl), 2, strides=2, paddings=1),
    "sampling_id": lambda fl, L: L.sampling_id(_data(fl, "p", [4, 3])),
    "uniform_random_batch_size_like":
        lambda fl, L: L.uniform_random_batch_size_like(_x(fl), [-1, 7]),
    "gaussian_random": lambda fl, L: L.gaussian_random([2, 3], std=0.5),
    "mul": lambda fl, L: L.mul(_data(fl, "a", [4, 5]),
                               _data(fl, "b", [5, 2])),
    "logical_or": lambda fl, L: L.logical_or(_data(fl, "c", [2], "bool"),
                                             _data(fl, "d", [2], "bool")),
    "logical_xor": lambda fl, L: L.logical_xor(_data(fl, "c", [2], "bool"),
                                               _data(fl, "d", [2], "bool")),
    "adaptive_pool2d": lambda fl, L: L.adaptive_pool2d(_x(fl), 2, "avg"),
    "conv2d_transpose": lambda fl, L: L.conv2d_transpose(
        _x(fl), 4, filter_size=3, stride=2, padding=1, act="relu"),
    "conv2d_transpose_output_size": lambda fl, L: L.conv2d_transpose(
        _x(fl), 2, output_size=9, stride=2),
    "group_norm": lambda fl, L: L.group_norm(_data(fl, "g", [2, 4, 3, 3]),
                                             2),
    # loss.py
    "huber_loss": lambda fl, L: L.huber_loss(_data(fl, "a", [4, 1]),
                                             _data(fl, "b", [4, 1]), 0.5),
    "smooth_l1": lambda fl, L: L.smooth_l1(_data(fl, "a", [4, 3]),
                                           _data(fl, "b", [4, 3])),
    "sigmoid_cross_entropy_with_logits":
        lambda fl, L: L.sigmoid_cross_entropy_with_logits(
            _data(fl, "a", [4, 3]), _data(fl, "b", [4, 3]),
            ignore_index=-1, normalize=True),
    "mean_squared_error": lambda fl, L: L.mean_squared_error(
        _data(fl, "a", [4, 1]), _data(fl, "b", [4, 1])),
    # compat.py
    "add_position_encoding": lambda fl, L: L.add_position_encoding(
        _data(fl, "e", [2, 5, 6]), 0.5, 1.5),
    "bilinear_tensor_product": lambda fl, L: L.bilinear_tensor_product(
        _data(fl, "a", [4, 5]), _data(fl, "b", [4, 6]), 3, act="tanh"),
    "dice_loss": lambda fl, L: L.dice_loss(_data(fl, "a", [4, 3]),
                                           _data(fl, "b", [4, 3])),
    "eye": lambda fl, L: L.eye(3, 4, batch_shape=[2]),
    "fsp_matrix": lambda fl, L: L.fsp_matrix(_x(fl),
                                             _data(fl, "y", [2, 5, 4, 4])),
    "gaussian_random_batch_size_like":
        lambda fl, L: L.gaussian_random_batch_size_like(_x(fl), [-1, 3]),
    "mse_loss": lambda fl, L: L.mse_loss(_data(fl, "a", [4, 1]),
                                         _data(fl, "b", [4, 1])),
    "random_crop": lambda fl, L: L.random_crop(_x(fl), [2, 2]),
    "rank": lambda fl, L: L.rank(_x(fl)),
    "similarity_focus": lambda fl, L: L.similarity_focus(_x(fl), 1, [0, 2]),
    "size": lambda fl, L: L.size(_x(fl)),
    "sum": lambda fl, L: L.sum([_x(fl), _x(fl)]),
    "tensor_array_to_tensor": lambda fl, L: L.tensor_array_to_tensor(
        L.array_write(_x(fl), L.fill_constant([1], "int64", 0)),
        axis=1)[0],
    "uniform_random": lambda fl, L: L.uniform_random([3, 2], min=0.0),
}


def _desc(fl, build):
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        out = build(fl, fl.layers)
    ops = [(o.type, {k: list(v) for k, v in o.inputs.items()},
            {k: list(v) for k, v in o.outputs.items()},
            {k: v for k, v in o.attrs.items()
             if not k.startswith("op_") and not k.startswith("__")})
           for o in main.global_block().ops]
    sops = [o.type for o in startup.global_block().ops]
    return ops, sops, out.name, tuple(out.shape or ())


def _norm_attr(v):
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, tuple):
        return list(v)
    return v


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


def test_every_reference_layer_of_the_five_modules_is_ported():
    """Every public name of the reference's ``layers/ops.py``,
    ``tensor.py``, ``loss.py`` and ``compat.py`` and ``nn.py`` whose ops
    the port lowers is in ``fluid.layers``; the names left out are the
    ones whose op is unlowered (ROADMAP A16)."""
    import importlib

    left = {
        "nn": {"crf_decoding", "linear_chain_crf"},
        "compat": {"adaptive_pool3d", "box_decoder_and_assign",
                   "collect_fpn_proposals", "deformable_conv",
                   "deformable_roi_pooling", "detection_output",
                   "distribute_fpn_proposals", "filter_by_instag",
                   "generate_mask_labels", "generate_proposal_labels",
                   "get_tensor_from_selected_rows", "merge_selected_rows",
                   "prroi_pool", "psroi_pool", "py_func", "resize_trilinear",
                   "retinanet_detection_output", "retinanet_target_assign",
                   "roi_perspective_transform", "rpn_target_assign",
                   "yolov3_loss"},
    }
    for mod in ("ops", "tensor", "nn", "loss", "compat"):
        ref = importlib.import_module("paddle_tpu.fluid.layers." + mod)
        missing = set(ref.__all__) - set(dir(tfluid.layers))
        assert missing == left.get(mod, set()), mod
