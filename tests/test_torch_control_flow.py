"""Sub-block control flow of the port held against the JAX package on the
CPU: ``while`` and ``conditional_block`` with their gradients
(``append_backward``'s ``while_grad`` / ``conditional_block_grad``), the
layers that build them (``While``, ``Switch``, ``cond``, the compares,
``increment``), the TensorArray and LoD rank-table ops, and the
reference's refusal of a gradient through nested control flow.

Each case builds the same program in both packages (a fresh
``unique_name.guard()`` on each side), runs the reference's startup,
copies its parameters into the port's scope and runs both Executors on
the same feed. The five cases of ``tests/test_while_cond_grad.py`` are
also held to their numpy oracles. Tolerances are stated at each
comparison.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid.ops import registry as jregistry
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import executor as texecutor
from paddle_tpu_torch.fluid import profiler as tprofiler
from paddle_tpu_torch.fluid.ops import registry as tregistry
from test_torch_cpu_math import pin_vector_math
from test_torch_vision import assert_same, both

pin_vector_math(2)  # 2 threads, vector math set up on one (see there)


def _scope(fl):
    return fl.Scope() if fl is tfluid else fl.core.Scope()


def _run_both(build, feed, steps=1):
    """``build(fl)`` -> (main, startup, fetch vars) in each package; the
    reference's startup parameters copied into the port's scope; each
    main run ``steps`` times on ``feed``. Returns ([reference fetches
    per step], [port fetches per step])."""
    out = []
    arrays = None
    for fl in (jfluid, tfluid):
        main, startup, fetch = build(fl)
        exe = fl.Executor(fl.CPUPlace())
        scope = _scope(fl)
        exe.run(startup, scope=scope)
        params = [p.name for p in main.all_parameters()]
        if fl is jfluid:
            arrays = {n: np.array(scope.get(n)) for n in params}
        else:
            for n in params:
                scope.set(n, torch.from_numpy(arrays[n].copy()))
        runs = []
        for _ in range(steps):
            got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
            runs.append([np.asarray(g) for g in got])
        out.append(runs)
    return out


# ---------------------------------------------------------------------------
# the five cases of tests/test_while_cond_grad.py
# ---------------------------------------------------------------------------
def _while_rnn(fl, B, T, H, pre_loop=False, seed=5):
    """mem_{t+1} = tanh(mem_t @ W + x_t) over a ``While`` reading the
    time-major array of x; loss = mean(mem_T) (+ mean of the initial
    memory, read outside the loop, with ``pre_loop``)."""
    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = seed
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        x = fl.layers.data(name="x", shape=[T, H], dtype="float32")
        table = fl.layers.lod_rank_table(x)
        arr = fl.layers.lod_tensor_to_array(x, table)
        i = fl.layers.fill_constant(shape=[1], dtype="int64", value=0)
        n = fl.layers.fill_constant(shape=[1], dtype="int64", value=T)
        if pre_loop:
            w0 = fl.layers.create_parameter(
                shape=[B, H], dtype="float32", name="W0",
                default_initializer=fl.initializer.ConstantInitializer(0.1))
            mem = fl.layers.assign(w0)
            side = fl.layers.reduce_mean(mem)
        else:
            mem = fl.layers.fill_constant(shape=[B, H], dtype="float32",
                                          value=0.0)
        mem.stop_gradient = False
        W = fl.layers.create_parameter(shape=[H, H], dtype="float32",
                                       name="W")
        cond = fl.layers.less_than(i, n)
        loop = fl.layers.While(cond)
        with loop.block():
            xt = fl.layers.array_read(arr, i)
            nm = fl.layers.tanh(fl.layers.matmul(mem, W) + xt)
            fl.layers.assign(nm, output=mem)
            fl.layers.increment(i, value=1, in_place=True)
            fl.layers.less_than(i, n, cond=cond)
        loss = fl.layers.reduce_mean(mem)
        if pre_loop:
            loss = loss + side
    return main, startup, loss


def _numpy_rnn(xb, W, m0):
    """(loss, dloss/dW, dloss/dm0) of the recurrence, in float64."""
    B, T, H = xb.shape
    mems = [m0]
    for t in range(T):
        mems.append(np.tanh(mems[-1] @ W + xb[:, t]))
    g_mem = np.full((B, H), 1.0 / (B * H))
    gW = np.zeros_like(W)
    for t in reversed(range(T)):
        g_pre = g_mem * (1.0 - mems[t + 1] ** 2)
        gW += mems[t].T @ g_pre
        g_mem = g_pre @ W.T
    return mems[-1].mean(), gW, g_mem


def test_while_grad_matches_reference_and_numpy():
    """``test_while_grad_matches_numpy_oracle``: B 2, T 4, H 3. The loss
    and dloss/dW of the port within 1e-5 relative of the reference's,
    and both within 1e-5 relative / 1e-6 absolute of the float64 numpy
    recurrence. The forward reads the condition on the host once an
    iteration and once more at the end."""
    B, T, H = 2, 4, 3

    def build(fl):
        main, startup, loss = _while_rnn(fl, B, T, H)
        with fl.program_guard(main, startup):
            pg = fl.backward.append_backward(loss)
        g = [g for p, g in pg if p.name == "W"][0]
        return main, startup, [loss, g, "W"]

    xb = np.random.RandomState(3).randn(B, T, H).astype(np.float32)
    syncs0 = tprofiler.get_counter(texecutor.HOST_SYNC_COUNTER)
    (ref,), (port,) = _run_both(build, {"x": xb})
    assert tprofiler.get_counter(texecutor.HOST_SYNC_COUNTER) - syncs0 \
        == T + 1
    np.testing.assert_allclose(port[0], ref[0], rtol=1e-5)
    np.testing.assert_allclose(port[1], ref[1], rtol=1e-5, atol=1e-7)
    loss, gW, _gm = _numpy_rnn(xb.astype(np.float64),
                               ref[2].astype(np.float64),
                               np.zeros((B, H)))
    for got in (ref, port):
        np.testing.assert_allclose(float(got[0].reshape(-1)[0]), loss,
                                   rtol=1e-5)
        np.testing.assert_allclose(got[1], gW, rtol=1e-4, atol=1e-6)


def test_while_grad_sums_with_pre_loop_consumer():
    """``test_while_grad_sums_with_pre_loop_consumer``: the initial
    memory, also read before the loop, gets the sum of the through-loop
    cotangent and its direct consumer's (not the post-loop one): the
    port's dloss/dW0 within 1e-5 relative of the reference's and within
    1e-4 relative / 1e-6 absolute of numpy's."""
    B, T, H = 2, 3, 4

    def build(fl):
        main, startup, loss = _while_rnn(fl, B, T, H, pre_loop=True, seed=9)
        with fl.program_guard(main, startup):
            pg = fl.backward.append_backward(loss)
        g0 = [g for p, g in pg if p.name == "W0"][0]
        return main, startup, [g0, "W"]

    xb = np.random.RandomState(6).randn(B, T, H).astype(np.float32)
    (ref,), (port,) = _run_both(build, {"x": xb})
    np.testing.assert_allclose(port[0], ref[0], rtol=1e-5, atol=1e-8)
    _l, _gW, g_m0 = _numpy_rnn(xb.astype(np.float64),
                               ref[1].astype(np.float64),
                               np.full((B, H), 0.1))
    np.testing.assert_allclose(port[0], g_m0 + 1.0 / (B * H), rtol=1e-4,
                               atol=1e-6)


def test_while_rnn_trains_as_the_reference():
    """``test_while_rnn_trains``: 5 SGD steps (lr 0.5) of the loop; each
    loss within 1e-5 relative of the reference's, and the loss falls."""
    B, T, H = 2, 4, 3

    def build(fl):
        main, startup, loss = _while_rnn(fl, B, T, H)
        with fl.program_guard(main, startup):
            fl.optimizer.SGD(learning_rate=0.5).minimize(loss)
        return main, startup, [loss]

    xb = np.random.RandomState(4).randn(B, T, H).astype(np.float32)
    ref, port = _run_both(build, {"x": xb}, steps=5)
    ref_l = [float(r[0].reshape(-1)[0]) for r in ref]
    port_l = [float(p[0].reshape(-1)[0]) for p in port]
    np.testing.assert_allclose(port_l, ref_l, rtol=1e-5)
    assert port_l[-1] < port_l[0], port_l


def _cond_net(fl, flag_value):
    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = 7
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        x = fl.layers.data(name="x", shape=[3], dtype="float32")
        w = fl.layers.create_parameter(
            shape=[3], dtype="float32", name="cw",
            default_initializer=fl.initializer.ConstantInitializer(2.0))
        flag = fl.layers.fill_constant(shape=[1], dtype="float32",
                                       value=flag_value)
        zero = fl.layers.fill_constant(shape=[1], dtype="float32", value=0.0)
        pred = fl.layers.greater_than(flag, zero)
        out = fl.layers.cond(
            pred,
            lambda: fl.layers.elementwise_mul(x, w) * 3.0,
            lambda: fl.layers.elementwise_mul(x, w))
        loss = fl.layers.reduce_sum(out)
        pg = fl.backward.append_backward(loss)
    return main, startup, [loss, [g for p, g in pg if p.name == "cw"][0]]


@pytest.mark.parametrize("flag,scale", [(1.0, 3.0), (-1.0, 1.0)],
                         ids=["true", "false"])
def test_conditional_block_grad_both_branches(flag, scale):
    """``test_conditional_block_grad_both_branches``: ``cond`` over two
    ``conditional_block``s merged by ``where``; the loss and dloss/dw
    equal the reference's (1e-6 relative) and the oracle (scale · x
    summed over the batch)."""
    xb = np.array([[1.0, -2.0, 3.0]], np.float32)
    (ref,), (port,) = _run_both(lambda fl: _cond_net(fl, flag), {"x": xb},
)
    for got in (ref, port):
        np.testing.assert_allclose(got[1], scale * xb.sum(0), rtol=1e-6)
        np.testing.assert_allclose(float(got[0].reshape(-1)[0]),
                                   float((scale * xb * 2.0).sum()),
                                   rtol=1e-6)
    np.testing.assert_allclose(port[1], ref[1], rtol=1e-6)


def test_conditional_block_false_branch_uninitialized_output():
    """``test_conditional_block_false_branch_uninitialized_output``: a
    Switch case that does not run leaves its output, which had no value,
    as zeros of the shape the branch would give it (the reference's
    false-branch value): both packages sum it to 0."""
    def build(fl):
        main, startup = fl.Program(), fl.Program()
        with fl.unique_name.guard(), fl.program_guard(main, startup):
            x = fl.layers.data(name="x", shape=[3], dtype="float32")
            flag = fl.layers.fill_constant(shape=[1], dtype="float32",
                                           value=-1.0)
            zero = fl.layers.fill_constant(shape=[1], dtype="float32",
                                           value=0.0)
            pred = fl.layers.greater_than(flag, zero)
            with fl.layers.Switch() as switch:
                with switch.case(pred):
                    y = fl.layers.elementwise_mul(x, x)
                with switch.default():
                    pass
            out = fl.layers.reduce_sum(y)
        return main, startup, [out, y]

    (ref,), (port,) = _run_both(build, {"x": np.ones((2, 3), np.float32)},
)
    assert float(port[0].reshape(-1)[0]) == float(ref[0].reshape(-1)[0]) \
        == 0.0
    assert port[1].shape == ref[1].shape == (2, 3)


# ---------------------------------------------------------------------------
# Switch, cond and the loop with arrays
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("value", [-2.0, 0.5, 3.0, 7.0])
def test_switch_takes_the_first_case_that_holds(value):
    """A ``Switch`` of three cases and a default writing one global
    variable (``assign`` to it in each case), as the reference's
    piecewise schedules did: the value of the first case that holds, or
    the default's, equal to the reference's."""
    def build(fl):
        main, startup = fl.Program(), fl.Program()
        with fl.unique_name.guard(), fl.program_guard(main, startup):
            x = fl.layers.data(name="x", shape=[1], dtype="float32",
                               append_batch_size=False)
            out = fl.layers.fill_constant(shape=[1], dtype="float32",
                                          value=-1.0)
            with fl.layers.Switch() as switch:
                for bound, v in ((0.0, 10.0), (1.0, 20.0), (5.0, 30.0)):
                    b = fl.layers.fill_constant(shape=[1], dtype="float32",
                                                value=bound)
                    with switch.case(fl.layers.less_than(x, b)):
                        fl.layers.assign(fl.layers.fill_constant(
                            shape=[1], dtype="float32", value=v), out)
                with switch.default():
                    fl.layers.assign(x * 2.0, out)
        return main, startup, [out]

    (ref,), (port,) = _run_both(build, {"x": np.array([value], np.float32)},
)
    want = 10.0 if value < 0 else 20.0 if value < 1 else 30.0 \
        if value < 5 else 2 * value
    assert float(port[0][0]) == float(ref[0][0]) == want


def test_while_writes_an_array_and_reads_it_back():
    """A loop that appends x·i to an array each step (``array_write``),
    then ``array_length``, ``array_read`` of the last step and
    ``array_to_lod_tensor`` of the whole array, against numpy. The
    reference cannot run it: its ``lax.while_loop`` carry keeps its
    shape, so an array cannot grow in a loop (ROADMAP C)."""
    T = 4
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[3], dtype="float32")
        i = tfluid.layers.fill_constant(shape=[1], dtype="int64", value=0)
        n = tfluid.layers.fill_constant(shape=[1], dtype="int64", value=T)
        arr = tfluid.layers.array_write(x, i)
        cond = tfluid.layers.less_than(i, n)
        loop = tfluid.layers.While(cond)
        with loop.block():
            tfluid.layers.increment(i, value=1, in_place=True)
            step = tfluid.layers.cast(i, "float32")
            tfluid.layers.array_write(tfluid.layers.elementwise_mul(
                x, step, axis=0), i, array=arr)
            tfluid.layers.less_than(i, n, cond=cond)
        length = tfluid.layers.array_length(arr)
        last = tfluid.layers.array_read(arr, i)
        table = tfluid.layers.lod_rank_table(
            tfluid.layers.data(name="seq", shape=[T + 1, 3],
                               dtype="float32"))
        whole = tfluid.layers.array_to_lod_tensor(arr, table)
    xb = np.random.RandomState(0).randn(2, 3).astype(np.float32)
    exe = tfluid.Executor(tfluid.CPUPlace())
    got = exe.run(main, feed={"x": xb,
                              "seq": np.zeros((2, T + 1, 3), np.float32)},
                  fetch_list=[length, last, whole, i], scope=tfluid.Scope())
    assert int(got[0][0]) == T + 1 and int(got[3][0]) == T
    np.testing.assert_allclose(got[1], xb * T, rtol=1e-6)
    np.testing.assert_allclose(
        got[2], np.stack([xb] + [xb * k for k in range(1, T + 1)], 1),
        rtol=1e-6)


def test_while_grad_replays_the_forward_dropout_masks():
    """A loop whose body draws dropout masks (rate 0.5) each step: s +=
    dropout(W); loss = sum(s). dloss/dW is the sum of the steps' masks,
    so loss = sum(W · dloss/dW) holds only if ``while_grad``'s replay
    drew the forward's masks (the generators' states kept per step)."""
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 3
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        i = tfluid.layers.fill_constant(shape=[1], dtype="int64", value=0)
        n = tfluid.layers.fill_constant(shape=[1], dtype="int64", value=6)
        W = tfluid.layers.create_parameter(
            shape=[8, 16], dtype="float32", name="W",
            default_initializer=tfluid.initializer.ConstantInitializer(1.5))
        s = tfluid.layers.fill_constant(shape=[8, 16], dtype="float32",
                                        value=0.0)
        s.stop_gradient = False
        cond = tfluid.layers.less_than(i, n)
        loop = tfluid.layers.While(cond)
        with loop.block():
            d = tfluid.layers.dropout(W, dropout_prob=0.5)
            tfluid.layers.assign(s + d, output=s)
            tfluid.layers.increment(i, value=1, in_place=True)
            tfluid.layers.less_than(i, n, cond=cond)
        loss = tfluid.layers.reduce_sum(s)
        (_w, g), = tfluid.backward.append_backward(loss)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    lv, gv = exe.run(main, fetch_list=[loss, g], scope=scope)
    assert 0 < gv.sum() < 6 * 8 * 16            # masks drew both ways
    np.testing.assert_allclose(float(lv.reshape(-1)[0]),
                               float((1.5 * gv).sum()), rtol=1e-6)


def _nested(fl, inner_kind):
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        i = fl.layers.fill_constant(shape=[1], dtype="int64", value=0)
        n = fl.layers.fill_constant(shape=[1], dtype="int64", value=2)
        W = fl.layers.create_parameter(shape=[2, 2], dtype="float32",
                                       name="W")
        mem = fl.layers.fill_constant(shape=[2, 2], dtype="float32",
                                      value=1.0)
        mem.stop_gradient = False
        cond = fl.layers.less_than(i, n)
        loop = fl.layers.While(cond)
        with loop.block():
            if inner_kind == "while":
                j = fl.layers.fill_constant(shape=[1], dtype="int64",
                                            value=0)
                c2 = fl.layers.less_than(j, n)
                inner = fl.layers.While(c2)
                with inner.block():
                    fl.layers.assign(fl.layers.matmul(mem, W), output=mem)
                    fl.layers.increment(j, value=1, in_place=True)
                    fl.layers.less_than(j, n, cond=c2)
            else:
                with fl.layers.Switch() as switch:
                    with switch.case(fl.layers.less_than(i, n)):
                        fl.layers.assign(fl.layers.matmul(mem, W),
                                         output=mem)
            fl.layers.increment(i, value=1, in_place=True)
            fl.layers.less_than(i, n, cond=cond)
        loss = fl.layers.reduce_mean(mem)
        fl.backward.append_backward(loss)
    return main, startup, loss


@pytest.mark.parametrize("inner_kind", ["while", "conditional_block"])
def test_grad_through_nested_control_flow_raises_as_the_reference(
        inner_kind):
    """A ``while`` whose body holds another ``while`` or a
    ``conditional_block``, under ``append_backward``: the forward runs,
    and ``while_grad`` raises ``NotImplementedError`` (wrapped in the
    op error that names it), in both packages for the nested ``while``.
    The reference cannot run a ``Switch`` inside a loop body at all (its
    branch misses the loop's frozen reads: ``KeyError`` in the forward),
    so that form is the port's alone (ROADMAP C)."""
    packages = ((tfluid, tregistry),)
    if inner_kind == "while":
        packages += ((jfluid, jregistry),)
    for fl, registry in packages:
        main, startup, loss = _nested(fl, inner_kind)
        exe = fl.Executor(fl.CPUPlace())
        scope = _scope(fl)
        exe.run(startup, scope=scope)
        with pytest.raises(registry.OpError, match="while_grad") as info:
            exe.run(main, fetch_list=[loss], scope=scope)
        assert isinstance(info.value.__cause__, NotImplementedError)
        assert "nested" in str(info.value.__cause__)


def test_nested_loops_run_forward_as_the_reference():
    """The nested ``while`` without a gradient: (2 outer × 2 inner
    products) the same values as the reference's, within 1e-5."""
    def build(fl):
        main, startup = fl.Program(), fl.Program()
        main.random_seed = startup.random_seed = 2
        with fl.unique_name.guard(), fl.program_guard(main, startup):
            i = fl.layers.fill_constant(shape=[1], dtype="int64", value=0)
            n = fl.layers.fill_constant(shape=[1], dtype="int64", value=2)
            W = fl.layers.create_parameter(shape=[2, 2], dtype="float32",
                                           name="W")
            mem = fl.layers.fill_constant(shape=[2, 2], dtype="float32",
                                          value=1.0)
            cond = fl.layers.less_than(i, n)
            loop = fl.layers.While(cond)
            with loop.block():
                j = fl.layers.fill_constant(shape=[1], dtype="int64",
                                            value=0)
                c2 = fl.layers.less_than(j, n)
                inner = fl.layers.While(c2)
                with inner.block():
                    fl.layers.assign(fl.layers.matmul(mem, W), output=mem)
                    fl.layers.increment(j, value=1, in_place=True)
                    fl.layers.less_than(j, n, cond=c2)
                fl.layers.increment(i, value=1, in_place=True)
                fl.layers.less_than(i, n, cond=cond)
        return main, startup, [mem, "W"]

    (ref,), (port,) = _run_both(build, {})
    np.testing.assert_allclose(port[0], ref[0], rtol=1e-5)
    np.testing.assert_allclose(
        port[0], np.linalg.matrix_power(ref[1].astype(np.float64), 4).sum(
            0, keepdims=True).repeat(2, 0), rtol=1e-5)


def test_a_persistable_written_in_a_loop_reaches_the_scope():
    """A persistable counter incremented inside a loop body (no op of
    the parent block writes it) is written back to the scope: 3 runs of
    a 4-step loop leave 12."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        total = tfluid.layers.create_global_var(
            shape=[1], value=0, dtype="int64", persistable=True,
            name="total")
        i = tfluid.layers.fill_constant(shape=[1], dtype="int64", value=0)
        n = tfluid.layers.fill_constant(shape=[1], dtype="int64", value=4)
        cond = tfluid.layers.less_than(i, n)
        loop = tfluid.layers.While(cond)
        with loop.block():
            tfluid.layers.increment(total, value=1, in_place=True)
            tfluid.layers.increment(i, value=1, in_place=True)
            tfluid.layers.less_than(i, n, cond=cond)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    for _ in range(3):
        exe.run(main, scope=scope)
    assert int(scope.get("total").item()) == 12
    assert scope.get("total").dtype == torch.int64


# ---------------------------------------------------------------------------
# TensorArray / LoD ops, one at a time
# ---------------------------------------------------------------------------
def _rand(rs, *shape):
    return rs.standard_normal(shape).astype(np.float32)


ARRAY_OPS = {
    # name: (op, feed, ins, outs, attrs, wrt)
    "lod_rank_table": ("lod_rank_table", {"x": (3, 5, 2)}, {"X": ["x"]},
                       {"Out": "out"}, {}, ()),
    "lod_tensor_to_array": ("lod_tensor_to_array", {"x": (3, 5, 2)},
                            {"X": ["x"]}, {"Out": "out"}, {}, ("x",)),
    "array_to_lod_tensor": ("array_to_lod_tensor", {"x": (5, 3, 2)},
                            {"X": ["x"]}, {"Out": "out"}, {}, ("x",)),
    "write_to_array": ("write_to_array", {"x": (3, 2), "i": "int0"},
                       {"X": ["x"], "I": ["i"]}, {"Out": "out"}, {},
                       ("x",)),
    "read_from_array": ("read_from_array", {"x": (5, 3, 2), "i": "int3"},
                        {"X": ["x"], "I": ["i"]}, {"Out": "out"}, {},
                        ("x",)),
    "lod_array_length": ("lod_array_length", {"x": (5, 3, 2)},
                         {"X": ["x"]}, {"Out": "out"}, {}, ()),
    "max_sequence_len": ("max_sequence_len", {"rt": "lens"},
                         {"RankTable": ["rt"]}, {"Out": "out"}, {}, ()),
    "shrink_rnn_memory": ("shrink_rnn_memory",
                          {"x": (3, 2), "i": "int1", "rt": "lens"},
                          {"X": ["x"], "I": ["i"], "RankTable": ["rt"]},
                          {"Out": "out"}, {}, ("x",)),
    "is_empty": ("is_empty", {"x": (3, 2)}, {"X": ["x"]}, {"Out": "out"},
                 {}, ()),
    "split_lod_tensor": ("split_lod_tensor", {"x": (4, 2), "m": "mask"},
                         {"X": ["x"], "Mask": ["m"]},
                         {"OutTrue": "t", "OutFalse": "f"}, {"level": 0},
                         ()),
    "merge_lod_tensor": ("merge_lod_tensor",
                         {"x": (4, 2), "a": (4, 2), "b": (4, 2), "m": "mask"},
                         {"X": ["x"], "Mask": ["m"], "InTrue": ["a"],
                          "InFalse": ["b"]}, {"Out": "out"}, {"level": 0},
                         ("a", "b")),
    "select_input": ("select_input", {"a": (3, 2), "b": (3, 2), "m": "int1"},
                     {"X": ["a", "b"], "Mask": ["m"]}, {"Out": "out"}, {},
                     ()),
}


@pytest.mark.parametrize("name", sorted(ARRAY_OPS))
def test_array_op_matches_reference(name):
    """Each TensorArray / LoD op alone on the same inputs: outputs equal
    to the reference's (1e-6), and the generic grads of the
    differentiable ones (sum(out · cot)) within 1e-6. A LoD array is the
    time-major stacked tensor [T, B, ...] in both packages."""
    op_type, shapes, ins, outs, attrs, wrt = ARRAY_OPS[name]
    rs = np.random.RandomState(5)
    feed = {}
    for k, v in shapes.items():
        if v == "lens":
            feed[k] = np.array([4, 2, 5], np.int32)
        elif v == "mask":
            feed[k] = np.array([[True], [False], [False], [True]])
        elif isinstance(v, str):
            feed[k] = np.array([int(v[3:])], np.int64)
        else:
            feed[k] = _rand(rs, *v)
    kw = {}
    if wrt:
        (ref0, _g), _port = both(op_type, feed, ins, outs, attrs)
        feed["cot"] = _rand(rs, *ref0["Out"].shape)
        kw = dict(loss_out="Out", wrt=wrt)
    ref, port = both(op_type, feed, ins, outs, attrs, **kw)
    for slot in outs:
        assert port[0][slot].shape == ref[0][slot].shape, slot
    assert_same(ref, port, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mask", [0, 1])
def test_select_output_routes_to_the_masked_branch(mask):
    """``select_output``: X lands on ``Out[Mask]`` and the other branch
    reads zeros, as in the reference."""
    x = np.random.RandomState(8).randn(2, 3).astype(np.float32)
    got = []
    for fl in (jfluid, tfluid):
        main = fl.Program()
        with fl.unique_name.guard(), fl.program_guard(main, fl.Program()):
            block = main.global_block()
            xv = block.create_var(name="x", shape=[2, 3], dtype="float32")
            mv = block.create_var(name="m", shape=[1], dtype="int32")
            outs = [block.create_var(name="o%d" % k, dtype="float32")
                    for k in range(2)]
            block.append_op(type="select_output",
                            inputs={"X": [xv], "Mask": [mv]},
                            outputs={"Out": outs})
        got.append([np.asarray(o) for o in fl.Executor(fl.CPUPlace()).run(
            main, feed={"x": x, "m": np.array([mask], np.int32)},
            fetch_list=outs, scope=_scope(fl))])
    for r, p in zip(*got):
        np.testing.assert_array_equal(p, r)
    np.testing.assert_array_equal(got[1][mask], x)
    np.testing.assert_array_equal(got[1][1 - mask], 0.0)
