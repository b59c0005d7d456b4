"""The vision slice of the port (``conv2d``, ``depthwise_conv2d``,
``pool2d``, ``batch_norm``, ``sgd`` and ``momentum`` ops, their layers,
``SGDOptimizer`` / ``MomentumOptimizer``, ``models.lenet`` and
``models.resnet``) held against the JAX package on the CPU.

Each op runs in a one-op program through each package's Executor on the
same numpy inputs: its outputs, and the gradients of sum(out · cot) for a
fed random ``cot`` through ``fluid.gradients`` (the port's generic grad
against the reference's ``jax.vjp``). Whole programs are built under a
fresh ``unique_name.guard()`` on both sides, so every variable carries
the reference's name; the reference's startup scope goes into the port's
with ``fluid.load_program_scope``. Tolerances are stated at each
comparison.
"""

import collections

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import lenet as jlenet
from paddle_tpu.models import resnet as jresnet
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import profiler as tprofiler
from paddle_tpu_torch.fluid.ops import registry as tregistry
from paddle_tpu_torch.models import lenet as tlenet
from paddle_tpu_torch.models import resnet as tresnet
from test_torch_cpu_math import pin_vector_math

pin_vector_math(2)  # 2 threads, vector math set up on one (see there)


# ---------------------------------------------------------------------------
# one op through both packages
# ---------------------------------------------------------------------------
def run_op(fl, op_type, feed, ins, outs, attrs=None, loss_out=None, wrt=(),
           low=()):
    """Run ``op_type`` alone through package ``fl`` (``jfluid`` or
    ``tfluid``). ``feed``: {name: array}; ``ins``: {slot: [fed names]};
    ``outs``: {slot: var name} (a fed name for an in-place output).
    Names in ``low`` are cast to bf16 in the program before the op.
    With ``loss_out`` (an output slot) the feed must hold ``cot`` of
    that output's shape, and the gradients of sum(float32(out) · cot)
    with respect to the fed names ``wrt`` are fetched too. Returns
    ({slot: output}, {name: grad}) as float32/int numpy arrays."""
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        block = main.global_block()
        var = {}
        for name, arr in feed.items():
            var[name] = block.create_var(
                name=name, shape=list(arr.shape), dtype=str(arr.dtype),
                stop_gradient=name not in wrt)
        fed = dict(var)
        for name in low:
            fed[name] = fl.layers.cast(var[name], "bfloat16")
        out_vars = {slot: var.get(name) or block.create_var(name=name)
                    for slot, name in outs.items()}
        block.append_op(
            type=op_type,
            inputs={slot: [fed[n] for n in names]
                    for slot, names in ins.items()},
            outputs={slot: [v] for slot, v in out_vars.items()},
            attrs=dict(attrs or {}))
        fetch = [out_vars[s] for s in outs]
        if loss_out is not None:
            out32 = fl.layers.cast(out_vars[loss_out], "float32")
            loss = fl.layers.reduce_sum(
                fl.layers.elementwise_mul(out32, var["cot"]))
            fetch += fl.gradients([loss], [var[n] for n in wrt])
    exe = fl.Executor(fl.CPUPlace())
    scope = fl.Scope() if fl is tfluid else fl.core.Scope()
    got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    got = [np.asarray(g) for g in got]
    got = [g.astype(np.float32) if g.dtype.kind == "V" or "bfloat16" in str(
        g.dtype) else g for g in got]
    return (dict(zip(outs, got[:len(outs)])),
            dict(zip(wrt, got[len(outs):])))


def both(*args, **kw):
    return (run_op(jfluid, *args, **kw), run_op(tfluid, *args, **kw))


def assert_same(ref, port, rtol, atol):
    (ro, rg), (po, pg) = ref, port
    for k in ro:
        np.testing.assert_allclose(po[k], ro[k], rtol=rtol, atol=atol,
                                   err_msg=k)
    for k in rg:
        np.testing.assert_allclose(pg[k], rg[k], rtol=rtol, atol=atol,
                                   err_msg=k + "@GRAD")


def _rand(rs, *shape):
    return rs.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------
CONV_CASES = {
    # name: (op, x [N, C, H, W], filter [O, C/groups, kh, kw], attrs)
    "plain": ("conv2d", (2, 3, 9, 9), (4, 3, 3, 3), {}),
    "stride_pad": ("conv2d", (2, 3, 11, 10), (5, 3, 3, 3),
                   {"strides": [2, 2], "paddings": [1, 1]}),
    "dilation": ("conv2d", (1, 2, 12, 12), (3, 2, 3, 3),
                 {"dilations": [2, 2], "paddings": [2, 2]}),
    "groups": ("conv2d", (2, 4, 8, 8), (6, 2, 3, 3),
               {"groups": 2, "paddings": [1, 1]}),
    "depthwise": ("depthwise_conv2d", (2, 4, 8, 8), (8, 1, 3, 3),
                  {"groups": 4, "paddings": [1, 1]}),
    "depthwise_cin1": ("depthwise_conv2d", (3, 1, 12, 12), (6, 1, 5, 5),
                       {"groups": 1, "paddings": [2, 2]}),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d_matches_reference(case):
    """``conv2d`` / ``depthwise_conv2d`` (stride, padding, dilation,
    groups; the depthwise form with one input channel, LeNet's first
    conv) and their generic grads for input and filter against the
    reference on the same inputs: fp32 both ways, within 1e-5 relative
    and 1e-4 absolute (sums of up to 50 products of unit normals)."""
    op_type, xs, ws, attrs = CONV_CASES[case]
    rs = np.random.RandomState(1)
    attrs = dict({"strides": [1, 1], "paddings": [0, 0],
                  "dilations": [1, 1], "groups": 1}, **attrs)
    x, w = _rand(rs, *xs), _rand(rs, *ws)
    out, _g = run_op(tfluid, op_type, {"x": x, "w": w},
                     {"Input": ["x"], "Filter": ["w"]}, {"Output": "out"},
                     attrs)
    feed = {"x": x, "w": w, "cot": _rand(rs, *out["Output"].shape)}
    ref, port = both(op_type, feed, {"Input": ["x"], "Filter": ["w"]},
                     {"Output": "out"}, attrs, loss_out="Output",
                     wrt=("x", "w"))
    assert port[0]["Output"].shape == ref[0]["Output"].shape
    assert_same(ref, port, rtol=1e-5, atol=1e-4)


POOL_CASES = {
    "max": {"pooling_type": "max", "ksize": [2, 2], "strides": [2, 2]},
    "max_pad": {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
                "paddings": [1, 1]},
    "max_ceil": {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
                 "ceil_mode": True},
    "avg_exclusive": {"pooling_type": "avg", "ksize": [3, 3],
                      "strides": [2, 2], "paddings": [1, 1],
                      "exclusive": True},
    "avg_inclusive": {"pooling_type": "avg", "ksize": [3, 3],
                      "strides": [2, 2], "paddings": [1, 1],
                      "exclusive": False},
    "avg_ceil": {"pooling_type": "avg", "ksize": [2, 2], "strides": [2, 2],
                 "ceil_mode": True, "exclusive": True},
    "global_max": {"pooling_type": "max", "ksize": [1, 1],
                   "global_pooling": True},
    "global_avg": {"pooling_type": "avg", "ksize": [1, 1],
                   "global_pooling": True},
    "adaptive_avg": {"pooling_type": "avg", "ksize": [2, 3],
                     "adaptive": True},
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool2d_matches_reference(case):
    """``pool2d``: max (−inf padding) and avg (padding left out of the
    count with ``exclusive``, counted without), ``ceil_mode``'s extra
    bottom/right padding, global and adaptive pooling, on a 9x9 input
    (odd, so ceil_mode adds a partial window) and its generic grad,
    within 1e-6 (one max, or a mean of at most 81 values)."""
    attrs = dict({"strides": [1, 1], "paddings": [0, 0],
                  "global_pooling": False, "adaptive": False,
                  "ceil_mode": False, "exclusive": True}, **POOL_CASES[case])
    rs = np.random.RandomState(2)
    x = _rand(rs, 2, 3, 9, 9) if not attrs["adaptive"] else _rand(
        rs, 2, 3, 8, 9)
    out, _g = run_op(tfluid, "pool2d", {"x": x}, {"X": ["x"]},
                     {"Out": "out"}, attrs)
    feed = {"x": x, "cot": _rand(rs, *out["Out"].shape)}
    ref, port = both("pool2d", feed, {"X": ["x"]}, {"Out": "out"}, attrs,
                     loss_out="Out", wrt=("x",))
    assert port[0]["Out"].shape == ref[0]["Out"].shape
    assert_same(ref, port, rtol=1e-6, atol=1e-6)


BN_OUTS = {"Y": "y", "MeanOut": "mean", "VarianceOut": "var",
           "SavedMean": "saved_mean", "SavedVariance": "saved_var"}


def _bn_feed(rs, shape=(4, 3, 5, 5)):
    c = shape[1]
    return {"x": (_rand(rs, *shape) * 2.0 + 0.5),
            "scale": _rand(rs, c) + 1.0, "bias": _rand(rs, c),
            "mean": _rand(rs, c) * 0.1,
            "var": np.abs(_rand(rs, c)) + 0.5,
            "cot": _rand(rs, *shape)}


BN_INS = {"X": ["x"], "Scale": ["scale"], "Bias": ["bias"],
          "Mean": ["mean"], "Variance": ["var"]}


@pytest.mark.parametrize("mode", ["train", "is_test", "use_global_stats"])
def test_batch_norm_matches_reference(mode):
    """fp32 ``batch_norm`` in training (biased batch variance E[x²] −
    mean², running stats old·momentum + batch·(1 − momentum) written in
    place, SavedVariance 1/√(var + ε)) and with the running stats
    (``is_test`` / ``use_global_stats``): every output and the grads of
    X, Scale and Bias against the reference, within 1e-5 relative and
    absolute (the port's grad is ``native_batch_norm_backward``, the
    reference's the vjp of its forward: the same function)."""
    rs = np.random.RandomState(3)
    feed = _bn_feed(rs)
    attrs = {"epsilon": 1e-5, "momentum": 0.9, "data_layout": "NCHW",
             "is_test": mode == "is_test",
             "use_global_stats": mode == "use_global_stats"}
    ref, port = both("batch_norm", feed, BN_INS, BN_OUTS, attrs,
                     loss_out="Y", wrt=("x", "scale", "bias"))
    assert_same(ref, port, rtol=1e-5, atol=1e-5)
    if mode == "train":
        x = feed["x"].astype(np.float64)
        bvar = (x ** 2).mean((0, 2, 3)) - x.mean((0, 2, 3)) ** 2
        np.testing.assert_allclose(
            port[0]["VarianceOut"], 0.9 * feed["var"] + 0.1 * bvar,
            rtol=1e-5)
        np.testing.assert_allclose(port[0]["SavedVariance"],
                                   1.0 / np.sqrt(bvar + 1e-5), rtol=1e-5)
    else:
        np.testing.assert_array_equal(port[0]["MeanOut"], feed["mean"])


def test_batch_norm_bf16_input_keeps_fp32_statistics():
    """bf16 X (cast in the program): statistics in fp32, the affine
    folded and applied in fp32, Y cast back to bf16; the running stats
    and saved stats stay fp32 and match the reference's within 1e-5; Y
    within one bf16 rounding (2⁻⁸ relative); X's grad within 2⁻⁷ of its
    scale."""
    rs = np.random.RandomState(4)
    feed = _bn_feed(rs)
    attrs = {"epsilon": 1e-5, "momentum": 0.9, "data_layout": "NCHW",
             "is_test": False, "use_global_stats": False}
    ref, port = both("batch_norm", feed, BN_INS, BN_OUTS, attrs,
                     loss_out="Y", wrt=("x", "scale", "bias"), low=("x",))
    for k in ("MeanOut", "VarianceOut", "SavedMean", "SavedVariance"):
        np.testing.assert_allclose(port[0][k], ref[0][k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(port[0]["Y"], ref[0]["Y"], rtol=2 ** -8,
                               atol=2 ** -8)
    for k in ("scale", "bias"):
        np.testing.assert_allclose(port[1][k], ref[1][k], rtol=1e-4,
                                   atol=1e-3, err_msg=k)
    dx, rdx = port[1]["x"], ref[1]["x"]
    assert np.abs(dx - rdx).max() <= 2 ** -7 * np.abs(rdx).max()


@pytest.mark.parametrize("nesterov", [False, True], ids=["plain", "nesterov"])
def test_momentum_matches_reference(nesterov):
    """``momentum``: v = µ·v + g, p −= lr·v (Nesterov: p −= (g + µ·v)·lr),
    both written in place; within 1e-6 of the reference."""
    rs = np.random.RandomState(5)
    feed = {"p": _rand(rs, 7, 3), "g": _rand(rs, 7, 3), "v": _rand(rs, 7, 3),
            "lr": np.asarray([0.1], np.float32)}
    ref, port = both("momentum", feed,
                     {"Param": ["p"], "Grad": ["g"], "Velocity": ["v"],
                      "LearningRate": ["lr"]},
                     {"ParamOut": "p", "VelocityOut": "v"},
                     {"mu": 0.9, "use_nesterov": nesterov})
    assert_same(ref, port, rtol=1e-6, atol=1e-6)
    v = 0.9 * feed["v"] + feed["g"]
    step = (feed["g"] + 0.9 * v) if nesterov else v
    np.testing.assert_allclose(port[0]["ParamOut"], feed["p"] - 0.1 * step,
                               rtol=1e-6, atol=1e-6)


def test_executor_feeds_and_fetches_own_their_memory():
    """An op that updates a fed variable in place (``momentum`` here)
    leaves the caller's arrays as they were, and an array fetched from
    one run is not changed by the next run's in-place update: the
    reference copies both ways, and so does the port's Executor on the
    CPU, where a tensor could share an array's memory."""
    rs = np.random.RandomState(9)
    feed = {"p": _rand(rs, 4, 3), "g": _rand(rs, 4, 3), "v": _rand(rs, 4, 3),
            "lr": np.asarray([0.1], np.float32)}
    held = {k: v.copy() for k, v in feed.items()}
    ins = {"Param": ["p"], "Grad": ["g"], "Velocity": ["v"],
           "LearningRate": ["lr"]}
    outs = {"ParamOut": "p", "VelocityOut": "v"}
    out, _g = run_op(tfluid, "momentum", feed, ins, outs,
                     {"mu": 0.9, "use_nesterov": False})
    for k, v in held.items():
        np.testing.assert_array_equal(feed[k], v, err_msg=k)
    assert not np.array_equal(out["ParamOut"], feed["p"])

    with tfluid.unique_name.guard():
        main, startup, _f, _l, _a = tlenet.build_lenet_train()
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    step = _image_feed(3, 2, 1, 28, 10)
    w0 = exe.run(main, feed=step, fetch_list=["fc_2.w_0"], scope=scope)[0]
    kept = w0.copy()
    w1 = exe.run(main, feed=step, fetch_list=["fc_2.w_0"], scope=scope)[0]
    np.testing.assert_array_equal(w0, kept)
    assert not np.array_equal(w1, kept)


def test_sgd_matches_reference():
    """``sgd``: p −= lr·g in place; within one fp32 rounding of the
    reference's (XLA may fuse the multiply-add)."""
    rs = np.random.RandomState(6)
    feed = {"p": _rand(rs, 5, 4), "g": _rand(rs, 5, 4),
            "lr": np.asarray([0.01], np.float32)}
    ref, port = both("sgd", feed, {"Param": ["p"], "Grad": ["g"],
                                   "LearningRate": ["lr"]},
                     {"ParamOut": "p"})
    np.testing.assert_allclose(port[0]["ParamOut"], ref[0]["ParamOut"],
                               rtol=2 ** -23, atol=2 ** -24)


# ---------------------------------------------------------------------------
# programs
# ---------------------------------------------------------------------------
def _ops(program):
    return [op.type for op in program.global_block().ops]


def _persistables(program):
    return sorted(v.name for v in program.list_vars() if v.persistable)


BUILDERS = {
    "lenet": (lambda m: m.build_lenet_train(), jlenet, tlenet),
    "resnet50": (lambda m: m.build_resnet_train(50), jresnet, tresnet),
    "resnet50_amp": (lambda m: m.build_resnet_train(50, use_amp=True),
                     jresnet, tresnet),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builders_give_the_reference_programs(name):
    """LeNet, ResNet-50 and ResNet-50's AMP rewrite (built, not run):
    the main program's op types in the reference's order, the startup's,
    the persistables and every variable's shape and type but one, the
    ``top_k`` Indices, int64 here where the reference's desc says int32
    (ROADMAP C). LeNet's first conv is a ``depthwise_conv2d``; ResNet-50
    has 53 convs and batch norms and 161 ``momentum`` ops; the AMP
    rewrite keeps batch norm's Scale, Bias, Mean and Variance fp32."""
    build, jmod, tmod = BUILDERS[name]
    with jfluid.unique_name.guard():
        jmain, jstart, jfeeds, jloss, jacc = build(jmod)
    with tfluid.unique_name.guard():
        tmain, tstart, tfeeds, tloss, tacc = build(tmod)
    assert _ops(tmain) == _ops(jmain)
    assert collections.Counter(_ops(tstart)) == collections.Counter(
        _ops(jstart))
    assert _persistables(tmain) == _persistables(jmain)
    assert [f.name for f in tfeeds] == [f.name for f in jfeeds]
    assert (tloss.name, tacc.name) == (jloss.name, jacc.name)
    jv = {v.name: v for v in jmain.list_vars()}
    for v in tmain.list_vars():
        want = jv[v.name]
        assert tuple(v.shape) == tuple(want.shape), v.name
        if v.name != "top_k_0.tmp_1":
            assert v.dtype == want.dtype, v.name
    counts = collections.Counter(_ops(tmain))
    if name == "lenet":
        assert _ops(tmain).index("depthwise_conv2d") < _ops(tmain).index(
            "conv2d")
    else:
        assert counts["conv2d"] == 53 and counts["batch_norm"] == 53
        assert counts["momentum"] == 161
    if name == "resnet50_amp":
        bn = [op for op in tmain.global_block().ops
              if op.type == "batch_norm"]
        for op in bn:
            for slot in ("Scale", "Bias", "Mean", "Variance"):
                assert tmain.global_block()._var_recursive(
                    op.input(slot)[0]).dtype == \
                    tfluid.core.VarDesc.VarType.FP32


def test_resnet_recompute_raises():
    """``recompute=True`` raised until activation recompute was ported
    (ROADMAP A8); it now builds the reference's desc op for op, replays
    included (``tests/test_torch_recompute.py`` holds its values)."""
    with tfluid.unique_name.guard():
        main = tresnet.build_resnet_train(18, 10, 32, recompute=True)[0]
    with jfluid.unique_name.guard():
        ref = jresnet.build_resnet_train(18, 10, 32, recompute=True)[0]
    types = [o.type for o in main.global_block().ops]
    assert types == [o.type for o in ref.global_block().ops]
    assert "recompute_barrier" in types


def _reference_run(build, feed, steps, fetch_acc=True):
    """The reference's program after its startup run: (startup scope
    arrays of every persistable, [(loss, acc)] of ``steps`` steps, every
    persistable after them)."""
    with jfluid.unique_name.guard():
        main, startup, _feeds, loss, acc = build()
    main.random_seed = startup.random_seed = 11
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.core.Scope()
    with jfluid.executor.scope_guard(scope):
        exe.run(startup)
    names = _persistables(main)
    arrays = {n: np.array(scope.get(n)) for n in names}
    out = []
    for _ in range(steps):
        lv, av = exe.run(main, feed=feed, fetch_list=[loss, acc],
                         scope=scope)
        out.append((float(np.asarray(lv).reshape(-1)[0]),
                    float(np.asarray(av).reshape(-1)[0])))
    after = {n: np.array(scope.get(n)) for n in names}
    return arrays, out, after


def _port_run(build, feed, steps, arrays):
    with tfluid.unique_name.guard():
        main, startup, _feeds, loss, acc = build()
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    tfluid.load_program_scope(main, scope, arrays)
    replays0 = tprofiler.get_counter(tregistry.REPLAY_COUNTER)
    out = []
    for _ in range(steps):
        lv, av = exe.run(main, feed=feed, fetch_list=[loss, acc],
                         scope=scope)
        out.append((float(lv.reshape(-1)[0]), float(av.reshape(-1)[0])))
    assert tprofiler.get_counter(tregistry.REPLAY_COUNTER) == replays0
    after = {n: scope.get(n).numpy() for n in _persistables(main)}
    return out, after


def _assert_state(after, want, rtol):
    """Every persistable within ``rtol`` relative norm of the
    reference's (floored at 1e-6 absolute for an all-zero state)."""
    assert sorted(after) == sorted(want)
    for n, w in want.items():
        d = float(np.linalg.norm(after[n] - w))
        assert d <= rtol * max(float(np.linalg.norm(w)), 1e-6), (n, d)


def _image_feed(seed, n, c, hw, classes):
    rs = np.random.RandomState(seed)
    return {"img": rs.standard_normal((n, c, hw, hw)).astype(np.float32),
            "label": rs.randint(0, classes, (n, 1)).astype(np.int64)}


def test_lenet_three_sgd_steps_match_reference():
    """LeNet, 3 SGD steps (lr 0.01) on a batch of 8 through each
    Executor from the reference's startup scope: losses within 1e-5
    relative, accuracies equal, every parameter within 1e-5 relative
    norm (fp32 both ways)."""
    build = lambda m: (lambda: m.build_lenet_train())  # noqa: E731
    feed = _image_feed(7, 8, 1, 28, 10)
    arrays, ref, ref_after = _reference_run(build(jlenet), feed, 3)
    out, after = _port_run(build(tlenet), feed, 3, arrays)
    np.testing.assert_allclose([o[0] for o in out], [r[0] for r in ref],
                               rtol=1e-5)
    assert [o[1] for o in out] == [r[1] for r in ref]
    _assert_state(after, ref_after, 1e-5)


@pytest.mark.parametrize("size,steps", [(32, 1), (64, 3)],
                         ids=["32px_1step", "64px_3steps"])
def test_resnet18_momentum_steps_match_reference(size, steps):
    """ResNet-18, 10 classes, batch 4, Momentum (lr 0.1, µ 0.9) from the
    reference's startup scope: losses within 1e-4 relative, accuracies
    equal, and every persistable after the steps (parameters,
    velocities, the batch-norm running Mean and Variance) within 1e-3
    relative norm (read: 1.3e-4 at 32x32 after one step, 2e-5 at 64x64
    after three; fp32 both ways).

    At 32x32 the last stage is 1x1, so its batch norms normalize 4 values
    a channel, whose variance E[x²] − mean² loses most of its bits to
    cancellation on both sides: step 1's rounding differences grow with
    every step after it, a trajectory of the rounding, not of the port.
    So that size is held after one step and the three-step run is held
    at 64x64, where the last stage's batch norms see 16 values."""
    build = lambda m: (  # noqa: E731
        lambda: m.build_resnet_train(18, class_num=10, image_size=size))
    feed = _image_feed(8, 4, 3, size, 10)
    arrays, ref, ref_after = _reference_run(build(jresnet), feed, steps)
    out, after = _port_run(build(tresnet), feed, steps, arrays)
    np.testing.assert_allclose([o[0] for o in out], [r[0] for r in ref],
                               rtol=1e-4)
    assert [o[1] for o in out] == [r[1] for r in ref]
    _assert_state(after, ref_after, 1e-3)


def test_load_program_scope_checks_names_and_shapes():
    """``load_program_scope`` takes every persistable of the program and
    nothing else, at the scope's shapes, and copies in place."""
    with tfluid.unique_name.guard():
        main, startup, _f, _l, _a = tlenet.build_lenet_train()
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=scope)
    arrays = {n: np.full(tuple(scope.get(n).shape), 0.5, np.float32)
              for n in _persistables(main)}
    held = {n: scope.get(n) for n in arrays}
    tfluid.load_program_scope(main, scope, arrays)
    for n, t in held.items():
        assert scope.get(n) is t and float(t.reshape(-1)[0]) == 0.5
    missing = dict(arrays)
    missing.pop(sorted(missing)[0])
    with pytest.raises(KeyError, match="missing"):
        tfluid.load_program_scope(main, scope, missing)
    with pytest.raises(KeyError, match="unknown"):
        tfluid.load_program_scope(main, scope, dict(arrays, nope=arrays[
            sorted(arrays)[0]]))
    name = sorted(arrays)[0]
    with pytest.raises(ValueError, match="shape"):
        tfluid.load_program_scope(main, scope, dict(
            arrays, **{name: np.zeros((3, 3, 3, 3), np.float32)}))
