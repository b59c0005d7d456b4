"""The Transformer NMT slice of the port held against the JAX package on
the CPU: the ``one_hot``, ``label_smooth``, ``elementwise_min`` /
``elementwise_pow``, ``increment`` and unary ops, ``Variable``'s
operators (``math_op_patch``), the eight learning-rate schedules, and
``models.transformer``: its programs op for op, three Adam steps with
every persistable compared after each, and ``beam_search_decode``.

Ops run alone through each package's Executor (``run_op`` of
``test_torch_vision``). Programs are built under a fresh
``unique_name.guard()`` on both sides; the reference's startup scope goes
into the port's with ``fluid.load_program_scope``. The reference's
``flash_attention`` op runs its plain (jnp) path on the CPU, the port's
the kernels' plain versions. Dropout is 0 wherever values are compared.
Tolerances are stated at each comparison.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid.layers import learning_rate_scheduler as jlrs
from paddle_tpu.models import transformer as jtfm
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import profiler as tprofiler
from paddle_tpu_torch.fluid.layers import learning_rate_scheduler as tlrs
from paddle_tpu_torch.fluid.ops import registry as tregistry
from paddle_tpu_torch.models import transformer as ttfm
from test_torch_cpu_math import pin_vector_math
from test_torch_vision import assert_same, both

pin_vector_math(2)  # 2 threads, vector math set up on one (see there)

S, T, BATCH = 12, 10, 4
COUNTER = "@LR_DECAY_COUNTER@"


def _rand(rs, *shape):
    return rs.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("allow", [False, True])
def test_one_hot_matches_reference(allow):
    """``one_hot`` of [6, 1] int64 ids at depth 5, two of them outside
    [0, 5): fp32 rows equal to the reference's, zeros for the two, with
    or without ``allow_out_of_range``."""
    ids = np.array([[0], [4], [2], [-1], [5], [3]], np.int64)
    ref, port = both("one_hot", {"ids": ids}, {"X": ["ids"]},
                     {"Out": "out"}, {"depth": 5, "allow_out_of_range": allow})
    assert port[0]["Out"].dtype == np.float32
    np.testing.assert_array_equal(port[0]["Out"], ref[0]["Out"])
    np.testing.assert_array_equal(port[0]["Out"][3:5], 0.0)


@pytest.mark.parametrize("prior", [False, True], ids=["uniform", "prior"])
def test_label_smooth_matches_reference(prior):
    """``label_smooth`` (ε 0.1) of one-hot rows, over a uniform prior or a
    fed ``PriorDist``, and its generic grad: within 1e-6."""
    rs = np.random.RandomState(0)
    label = np.eye(7, dtype=np.float32)[rs.randint(0, 7, 5)]
    feed = {"label": label, "cot": _rand(rs, 5, 7)}
    ins = {"X": ["label"]}
    if prior:
        p = rs.rand(7).astype(np.float32)
        feed["prior"] = (p / p.sum()).reshape(1, 7)
        ins["PriorDist"] = ["prior"]
    ref, port = both("label_smooth", feed, ins, {"Out": "out"},
                     {"epsilon": 0.1}, loss_out="Out", wrt=("label",))
    assert_same(ref, port, rtol=1e-6, atol=1e-6)


# (x shape, y shape, axis): the same shape, and Y lined up at an axis
ELEMENTWISE_CASES = {"same": ((3, 4), (3, 4), -1),
                     "axis1": ((2, 3, 4), (3,), 1),
                     "trailing": ((2, 3, 4), (4,), -1)}


@pytest.mark.parametrize("case", sorted(ELEMENTWISE_CASES))
@pytest.mark.parametrize("op_type", ["elementwise_min", "elementwise_pow"])
def test_elementwise_min_pow_match_reference(op_type, case):
    """``elementwise_min`` / ``elementwise_pow`` with Fluid's axis
    broadcast and their grads in X and Y (summed over the broadcast
    dims): within 1e-5 relative (pow on bases in [0.5, 2], exponents in
    [-1.5, 1.5]; min on inputs with no ties)."""
    xs, ys, axis = ELEMENTWISE_CASES[case]
    rs = np.random.RandomState(1)
    if op_type == "elementwise_pow":
        x = rs.uniform(0.5, 2.0, xs).astype(np.float32)
        y = rs.uniform(-1.5, 1.5, ys).astype(np.float32)
    else:
        x, y = _rand(rs, *xs), _rand(rs, *ys)
    feed = {"x": x, "y": y, "cot": _rand(rs, *xs)}
    ref, port = both(op_type, feed, {"X": ["x"], "Y": ["y"]}, {"Out": "out"},
                     {"axis": axis}, loss_out="Out", wrt=("x", "y"))
    assert_same(ref, port, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["int64", "float32"])
def test_increment_matches_reference_and_keeps_dtype(dtype):
    """``increment`` by 2: the same values, and the port keeps X's dtype
    (int64 stays int64; the reference's JAX, without x64, gives int32)."""
    x = np.array([3, -1], dtype)
    ref, port = both("increment", {"x": x}, {"X": ["x"]}, {"Out": "out"},
                     {"step": 2.0})
    assert port[0]["Out"].dtype == np.dtype(dtype)
    np.testing.assert_array_equal(port[0]["Out"], ref[0]["Out"])
    np.testing.assert_array_equal(port[0]["Out"], x + 2)


@pytest.mark.parametrize("op_type,attrs", [
    ("floor", {}), ("ceil", {}), ("exp", {}), ("cos", {}),
    ("pow", {"factor": 1.5}), ("pow", {"factor": -0.5}), ("tanh", {}),
    ("sqrt", {})], ids=["floor", "ceil", "exp", "cos", "pow1.5", "pow-0.5",
                        "tanh", "sqrt"])
def test_unary_ops_match_reference(op_type, attrs):
    """The unary ops the schedules build, and their generic grads (0 for
    floor / ceil), on positive inputs: within 1e-5 relative."""
    rs = np.random.RandomState(2)
    x = rs.uniform(0.2, 3.0, (4, 5)).astype(np.float32)
    feed = {"x": x, "cot": _rand(rs, 4, 5)}
    ref, port = both(op_type, feed, {"X": ["x"]}, {"Out": "out"}, attrs,
                     loss_out="Out", wrt=("x",))
    assert_same(ref, port, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# Variable's operators
# ---------------------------------------------------------------------------
EXPRESSIONS = {
    "add_scalar": lambda x, y: x + 1.5,
    "radd_scalar": lambda x, y: 2 + x,
    "sub_scalar": lambda x, y: x - 0.5,
    "rsub_scalar": lambda x, y: 1.0 - x,
    "mul_scalar": lambda x, y: x * 3,
    "rmul_scalar": lambda x, y: 0.25 * x,
    "div_scalar": lambda x, y: x / 4.0,
    "rdiv_scalar": lambda x, y: 2.0 / x,
    "pow_scalar": lambda x, y: x ** -0.5,
    "rpow_scalar": lambda x, y: 2.0 ** x,
    "neg": lambda x, y: -x,
    "vars": lambda x, y: (x + y) * (x - y) / y + x ** y,
    "compare": lambda x, y: (x < y, x >= 1.0, x == y, x != 0.5),
}


def _expr_program(fl, expr):
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        x = fl.layers.data(name="x", shape=[3], dtype="float32")
        y = fl.layers.data(name="y", shape=[3], dtype="float32")
        out = expr(x, y)
    return main, list(out) if isinstance(out, tuple) else [out]


def _op_descs(program):
    keep = ("scale", "bias", "bias_after_scale", "axis", "value", "shape",
            "dtype")
    return [(o.type, o.inputs, o.outputs,
             {k: v for k, v in o.attrs.items() if k in keep})
            for o in program.global_block().ops]


@pytest.mark.parametrize("name", sorted(EXPRESSIONS))
def test_variable_operators_build_the_reference_ops(name):
    """Each expression builds the reference's ops in its order, with the
    same inputs, outputs and scale / axis / constant attrs (a scalar
    becomes ``scale`` where it can, else ``fill_constant`` [1] and the
    ``elementwise_*`` op), and computes the same values, within 1e-6."""
    jmain, jouts = _expr_program(jfluid, EXPRESSIONS[name])
    tmain, touts = _expr_program(tfluid, EXPRESSIONS[name])
    assert _op_descs(tmain) == _op_descs(jmain)
    rs = np.random.RandomState(3)
    feed = {"x": rs.uniform(0.5, 2.0, (2, 3)).astype(np.float32),
            "y": rs.uniform(0.5, 2.0, (2, 3)).astype(np.float32)}
    feed["x"][0, 0] = feed["y"][0, 0]
    want = jfluid.Executor(jfluid.CPUPlace()).run(
        jmain, feed=feed, fetch_list=jouts, scope=jfluid.core.Scope())
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        tmain, feed=feed, fetch_list=touts, scope=tfluid.Scope())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# learning-rate schedules
# ---------------------------------------------------------------------------
SCHEDULES = {
    "noam": lambda m: m.noam_decay(64, 4),
    "exponential": lambda m: m.exponential_decay(0.1, 3, 0.5),
    "exponential_staircase": lambda m: m.exponential_decay(0.1, 3, 0.5, True),
    "natural_exp": lambda m: m.natural_exp_decay(0.1, 3, 0.5),
    "natural_exp_staircase": lambda m: m.natural_exp_decay(0.1, 3, 0.5, True),
    "inverse_time": lambda m: m.inverse_time_decay(0.1, 3, 0.5),
    "inverse_time_staircase": lambda m: m.inverse_time_decay(0.1, 3, 0.5,
                                                             True),
    "polynomial": lambda m: m.polynomial_decay(0.1, 6, 0.01, 2.0),
    "polynomial_cycle": lambda m: m.polynomial_decay(0.1, 4, 0.01, 1.0, True),
    "piecewise": lambda m: m.piecewise_decay([2, 5, 7], [1.0, 0.5, 0.1,
                                                         0.05]),
    "cosine": lambda m: m.cosine_decay(0.1, 2, 5),
    "linear_warmup": lambda m: m.linear_lr_warmup(0.1, 4, 0.0, 0.2),
}


def _schedule_runs(fl, mod, name, runs=10):
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        lr = SCHEDULES[name](mod)
    exe = fl.Executor(fl.CPUPlace())
    scope = fl.Scope() if fl is tfluid else fl.core.Scope()
    exe.run(startup, scope=scope)
    out = []
    for _ in range(runs):
        lv, step = exe.run(main, fetch_list=[lr, COUNTER], scope=scope)
        out.append((float(np.asarray(lv).reshape(-1)[0]),
                    int(np.asarray(step).reshape(-1)[0])))
    return main, out


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_reference_over_ten_runs(name):
    """Each schedule, as the only ops of a program, run 10 times from its
    startup: the ops are the reference's, the rate of every run within
    1e-6 relative of the reference's, and ``@LR_DECAY_COUNTER@`` counts
    as the reference's (noam's first run reads 1, the others' 0), an
    int64 in the port's scope."""
    jmain, want = _schedule_runs(jfluid, jlrs, name)
    tmain, got = _schedule_runs(tfluid, tlrs, name)
    assert [o.type for o in tmain.global_block().ops] == \
        [o.type for o in jmain.global_block().ops]
    assert tmain.global_block().ops[0].type == "increment"
    assert [s for _l, s in got] == [s for _l, s in want]
    assert got[0][1] == (1 if name == "noam" else 0)
    np.testing.assert_allclose([lv for lv, _s in got],
                               [lv for lv, _s in want], rtol=1e-6, atol=0)


def test_step_counter_is_made_once_and_kept_int64():
    """Two schedules in one program share one counter and one prepended
    ``increment``; the startup sets it to ``begin - 1``; each run writes
    it back to the scope as int64."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        a = tlrs.exponential_decay(0.1, 3, 0.5)
        b = tlrs.cosine_decay(0.1, 2, 5)
    incs = [o for o in main.global_block().ops if o.type == "increment"]
    assert len(incs) == 1 and main.global_block().ops[0] is incs[0]
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    assert int(scope.get(COUNTER).item()) == -1
    for step in range(3):
        exe.run(main, fetch_list=[a, b], scope=scope)
        counter = scope.get(COUNTER)
        assert counter.dtype == tfluid.core.dtype_to_torch("int64")
        assert int(counter.item()) == step


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def _cfg(mod, flash, label_smooth=0.1, dropout=0.0):
    return mod.TransformerConfig.tiny(use_flash_attention=flash,
                                      label_smooth=label_smooth,
                                      dropout=dropout)


def _ops(program):
    return [(o.type, o.inputs, o.outputs) for o in program.global_block().ops]


def _persistables(program):
    return sorted(v.name for v in program.list_vars() if v.persistable)


FORMS = [(True, 0.1), (True, 0.0), (False, 0.1), (False, 0.0)]
FORM_IDS = ["flash-ls0.1", "flash-ls0", "dense-ls0.1", "dense-ls0"]


@pytest.mark.parametrize("flash,ls", FORMS, ids=FORM_IDS)
def test_train_program_is_the_reference_program(flash, ls):
    """``build_transformer_train(tiny, 12, 10)`` at dropout 0.1, flash and
    dense, label smoothing 0 and 0.1 (built, not run): the main program's
    ops with their inputs and outputs, the startup's op types, the
    persistables, the feeds and the loss are the reference's; every
    variable has its shape and type but the step counter (int64 here,
    int32 in the reference's desc: ROADMAP C). The flash program holds
    3 ``flash_attention`` ops and grads a layer pair, the dense none."""
    with jfluid.unique_name.guard():
        jm, js, jf, jl = jtfm.build_transformer_train(_cfg(jtfm, flash, ls,
                                                           0.1), S, T)
    with tfluid.unique_name.guard():
        tm, ts, tf, tl = ttfm.build_transformer_train(_cfg(ttfm, flash, ls,
                                                           0.1), S, T)
    assert _ops(tm) == _ops(jm)
    assert [o.type for o in ts.global_block().ops] == \
        [o.type for o in js.global_block().ops]
    assert _persistables(tm) == _persistables(jm)
    assert [f.name for f in tf] == [f.name for f in jf]
    assert tl.name == jl.name
    jv = {v.name: v for v in jm.list_vars()}
    for v in tm.list_vars():
        assert tuple(v.shape) == tuple(jv[v.name].shape), v.name
        if v.name != COUNTER:
            assert v.dtype == jv[v.name].dtype, v.name
    types = [o.type for o in tm.global_block().ops]
    layers = _cfg(ttfm, flash).num_layers
    assert types.count("flash_attention") == (3 * layers if flash else 0)
    assert types.count("flash_attention_grad") == (3 * layers if flash
                                                   else 0)
    assert types.count("one_hot") == (1 if ls else 0)
    assert types[0] == "increment"


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "dense"])
def test_infer_program_is_the_reference_program(flash):
    """``build_transformer_infer(tiny, 12, 10)``: the ops with their
    inputs and outputs, the feed names and the logits variable are the
    reference's, and its parameters are the train program's."""
    jp, jfeeds, jlog = jtfm.build_transformer_infer(_cfg(jtfm, flash), S, T)
    tp, tfeeds, tlog = ttfm.build_transformer_infer(_cfg(ttfm, flash), S, T)
    assert _ops(tp) == _ops(jp)
    assert tfeeds == jfeeds and tlog.name == jlog.name
    with tfluid.unique_name.guard():
        tm, _s, _f, _l = ttfm.build_transformer_train(_cfg(ttfm, flash), S,
                                                      T)
    assert sorted(p.name for p in tp.all_parameters()) == sorted(
        p.name for p in tm.all_parameters())


def _batch(seed=0, vocab=1000):
    """[4, 12] sources and [4, 10] targets with ragged real lengths
    (source 12, 7, 3, 10; target 10, 6, 4, 8), padding ids 0."""
    rs = np.random.RandomState(seed)
    src_lens, tgt_lens = (12, 7, 3, 10), (10, 6, 4, 8)
    src_mask = np.zeros((BATCH, S, 1), np.float32)
    tgt_mask = np.zeros((BATCH, T, 1), np.float32)
    for i, (a, b) in enumerate(zip(src_lens, tgt_lens)):
        src_mask[i, :a] = 1.0
        tgt_mask[i, :b] = 1.0
    ids = lambda n: rs.randint(2, vocab, (BATCH, n, 1)).astype(np.int64)
    return {"src_ids": ids(S) * src_mask.astype(np.int64),
            "src_pos": np.tile(np.arange(S).reshape(1, S, 1),
                               (BATCH, 1, 1)).astype(np.int64),
            "src_mask": src_mask,
            "tgt_ids": ids(T) * tgt_mask.astype(np.int64),
            "tgt_pos": np.tile(np.arange(T).reshape(1, T, 1),
                               (BATCH, 1, 1)).astype(np.int64),
            "tgt_mask": tgt_mask,
            "labels": ids(T) * tgt_mask.astype(np.int64)}


LR, WARMUP = 2.0, 4


def _train_program(fl, mod, flash, ls):
    with fl.unique_name.guard():
        main, startup, _f, loss = mod.build_transformer_train(
            _cfg(mod, flash, ls), S, T, learning_rate=LR, warmup_steps=WARMUP)
    names = sorted(p.name for p in main.all_parameters() if p.trainable)
    return main, startup, loss, names


def _reference_steps(flash, ls, steps):
    """The reference's train program run ``steps`` Adam steps from its
    startup: [(every persistable before the step, loss, {param: grad},
    every persistable after it)]."""
    main, startup, loss, names = _train_program(jfluid, jtfm, flash, ls)
    main.random_seed = startup.random_seed = 5
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.core.Scope()
    exe.run(startup, scope=scope)
    state = lambda: {n: np.array(scope.get(n)) for n in _persistables(main)}
    out = []
    for _ in range(steps):
        before = state()
        got = exe.run(main, feed=_batch(), fetch_list=[loss] + [
            n + "@GRAD" for n in names], scope=scope)
        out.append((before, float(np.asarray(got[0]).reshape(-1)[0]),
                    dict(zip(names, (np.asarray(g) for g in got[1:]))),
                    state()))
    return out


def _port_step(flash, ls, before):
    """One step of the port's train program from the persistables
    ``before``: (loss, {param: grad}, every persistable after it)."""
    main, startup, loss, names = _train_program(tfluid, ttfm, flash, ls)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    tfluid.load_program_scope(main, scope, before)
    replays0 = tprofiler.get_counter(tregistry.REPLAY_COUNTER)
    got = exe.run(main, feed=_batch(), fetch_list=[loss] + [
        n + "@GRAD" for n in names], scope=scope)
    assert tprofiler.get_counter(tregistry.REPLAY_COUNTER) == replays0
    assert scope.get(COUNTER).dtype == torch.int64
    return (float(got[0].reshape(-1)[0]), dict(zip(names, got[1:])),
            {n: scope.get(n).numpy().copy() for n in _persistables(main)})


def _zero_grad_param(name):
    """A k-projection bias: its exact gradient is 0, since softmax
    ignores a shift shared by every key of a query."""
    return "att_k.b_0" in name


@pytest.mark.parametrize("flash,ls", FORMS, ids=FORM_IDS)
def test_three_adam_steps_match_reference_executor(flash, ls):
    """``TransformerConfig.tiny`` on ragged source and target masks,
    dropout 0, 3 Adam steps under the Noam schedule (lr 2.0, warmup 4).
    Each step of the port starts from the reference's persistables
    before that step, so a difference of one step cannot grow into the
    next. After every step:

    - the loss within 1e-6 relative (~7e-8 read);
    - every parameter's gradient within 2e-4 relative norm (fp32 sums
      in another order; the small k-projection gradients read up to
      5e-5), the k-projection biases, whose exact gradient is 0
      (softmax ignores a shift shared by every key of a query), within
      1e-8 absolute;
    - every persistable as the reference's: ``@LR_DECAY_COUNTER@``
      equal (1, 2, 3, int64 in the port), the β-pows within 1e-6
      relative, both moments within 1e-4 relative norm (~3e-6 read; the
      k-biases' within 1e-6 absolute), and the parameters within 2
      learning rates of the step on every element and, the k-biases
      aside, within 1e-3 relative norm.
      Adam moves an element by about the learning rate whatever its
      gradient's size, so an element whose gradient is rounding noise
      (the k-biases; elements ~1e-6 of their parameter's largest) steps
      by noise; the parameters read up to 9e-5.

    No generic grad replays its forward."""
    for step, (before, ref_loss, ref_grads, ref_after) in enumerate(
            _reference_steps(flash, ls, 3)):
        loss, grads, after = _port_step(flash, ls, before)
        np.testing.assert_allclose(loss, ref_loss, rtol=1e-6)
        for n, want in ref_grads.items():
            if _zero_grad_param(n):
                assert np.abs(grads[n]).max() <= 1e-8, (n, step)
                continue
            d = float(np.linalg.norm(grads[n] - want))
            assert d <= 2e-4 * float(np.linalg.norm(want)), (n, step, d)
        lr = LR * 64 ** -0.5 * min((step + 1) ** -0.5,
                                   (step + 1) * WARMUP ** -1.5)
        assert sorted(after) == sorted(ref_after)
        assert int(after[COUNTER].reshape(-1)[0]) == step + 1
        for n, want in ref_after.items():
            got = after[n]
            d = float(np.linalg.norm(got - want))
            norm = float(np.linalg.norm(want))
            param = n.split("_moment")[0]
            if n == COUNTER:
                np.testing.assert_array_equal(got, want)
            elif "_pow_acc" in n:
                np.testing.assert_allclose(got, want, rtol=1e-6)
            elif param != n and _zero_grad_param(param):
                assert np.abs(got - want).max() <= 1e-6, (n, step)
            elif param != n:
                assert d <= 1e-4 * norm, (n, step, d)
            else:
                assert np.abs(got - want).max() <= 2 * lr, (n, step)
                assert _zero_grad_param(n) or d <= 1e-3 * norm, \
                    (n, step, d)


def test_flash_and_dense_agree_on_masked_loss_and_gradients():
    """The port's flash and dense programs from the same weights on the
    ragged batch (label smoothing 0.1, dropout 0): the masked loss within
    1e-5 relative and every parameter's step-1 gradient within 1e-4
    relative norm (the k-projection biases, exact gradient 0, within
    1e-8 absolute), though padded target rows attend differently (the
    key-only bias against the dense masks)."""
    arrays = _reference_steps(True, 0.1, 1)[0][0]
    out = {}
    for flash in (True, False):
        with tfluid.unique_name.guard():
            main, startup, _f, loss = ttfm.build_transformer_train(
                _cfg(ttfm, flash), S, T)
        exe = tfluid.Executor(tfluid.CPUPlace())
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
        tfluid.load_program_scope(main, scope, arrays)
        names = sorted(p.name for p in main.all_parameters() if p.trainable)
        got = exe.run(main, feed=_batch(), fetch_list=[loss] + [
            n + "@GRAD" for n in names], scope=scope)
        out[flash] = (float(got[0].reshape(-1)[0]), dict(zip(names, got[1:])))
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-5)
    for n, want in out[False][1].items():
        if _zero_grad_param(n):
            assert np.abs(out[True][1][n]).max() <= 1e-8, n
            continue
        d = float(np.linalg.norm(out[True][1][n] - want))
        assert d <= 1e-4 * max(float(np.linalg.norm(want)), 1e-6), (n, d)


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "dense"])
def test_beam_search_matches_reference_token_for_token(flash):
    """``beam_search_decode`` (beam 3, length penalty 0.6, sources of 12
    with pad id 0 on a ragged tail) over each package's inference
    program from the reference's startup parameters: the sequences
    token for token and the scores within 1e-4 relative of the
    reference's."""
    cfg_j, cfg_t = _cfg(jtfm, flash), _cfg(ttfm, flash)
    jp, _f, jlog = jtfm.build_transformer_infer(cfg_j, S, T)
    tp, _f, tlog = ttfm.build_transformer_infer(cfg_t, S, T)
    with jfluid.unique_name.guard():
        _m, jstart, _f, _l = jtfm.build_transformer_train(cfg_j, S, T)
    jstart.random_seed = 11
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.core.Scope()
    jexe.run(jstart, scope=jscope)
    arrays = {p.name: np.array(jscope.get(p.name))
              for p in tp.all_parameters()}
    texe = tfluid.Executor(tfluid.CPUPlace())
    tscope = tfluid.Scope()
    for n, a in arrays.items():
        tscope.set(n, torch.from_numpy(a.copy()))
    src = np.random.RandomState(4).randint(2, 1000, (2, S)).astype(np.int64)
    src[1, 8:] = 0
    kw = dict(bos_id=1, eos_id=0, beam_size=3, max_len=T,
              length_penalty=0.6, src_pad_id=0)
    want_seqs, want_scores = jtfm.beam_search_decode(
        jexe, jp, jlog, cfg_j, src, scope=jscope, **kw)
    got_seqs, got_scores = ttfm.beam_search_decode(
        texe, tp, tlog, cfg_t, src, scope=tscope, **kw)
    np.testing.assert_array_equal(got_seqs, want_seqs)
    np.testing.assert_allclose(got_scores, want_scores, rtol=1e-4)
    assert got_seqs.shape == (2, 3, T) and (got_seqs[:, :, 0] == 1).all()


@pytest.mark.slow
def test_copy_task_learns_and_beam_search_copies():
    """The reference's copy task (``tests/test_transformer_nmt.py``) on
    the port: 400 Adam steps of a 2-layer width-64 model must bring the
    loss under 0.5, and the best beam must copy > 90% of the source."""
    vocab, s, t, bos, eos = 20, 6, 8, 1, 0
    cfg = ttfm.TransformerConfig.tiny(
        src_vocab=vocab, tgt_vocab=vocab, num_heads=2, label_smooth=0.0,
        dropout=0.0)
    with tfluid.unique_name.guard():
        main, startup, _f, loss = ttfm.build_transformer_train(
            cfg, s, t, learning_rate=0.5, warmup_steps=50)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)

    def batch(rng, n):
        src = rng.randint(2, vocab, (n, s)).astype(np.int64)
        tgt = np.concatenate([np.full((n, 1), bos), src,
                              np.full((n, 1), eos)], 1)[:, :t]
        lab = np.concatenate([src, np.full((n, 2), eos)], 1)[:, :t]
        return src, tgt.astype(np.int64), lab.astype(np.int64)

    rng = np.random.RandomState(0)
    for _ in range(400):
        src, tgt, lab = batch(rng, 32)
        (lv,) = exe.run(main, feed={
            "src_ids": src[..., None],
            "src_pos": np.tile(np.arange(s), (32, 1))[..., None],
            "src_mask": np.ones((32, s, 1), np.float32),
            "tgt_ids": tgt[..., None],
            "tgt_pos": np.tile(np.arange(t), (32, 1))[..., None],
            "tgt_mask": np.ones((32, t, 1), np.float32),
            "labels": lab[..., None]}, fetch_list=[loss], scope=scope)
    assert float(lv.reshape(-1)[0]) < 0.5
    infer, _feeds, logits = ttfm.build_transformer_infer(cfg, s, t)
    src, _tgt, _lab = batch(np.random.RandomState(7), 4)
    seqs, scores = ttfm.beam_search_decode(exe, infer, logits, cfg, src,
                                           bos_id=bos, eos_id=eos,
                                           beam_size=3, max_len=t,
                                           scope=scope)
    assert float((seqs[:, 0, 1:s + 1] == src).mean()) > 0.9
    assert (scores[:, 0] + 1e-6 >= scores[:, 1]).all()
