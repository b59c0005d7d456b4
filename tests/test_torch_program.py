"""The Fluid Program/Executor slice of the port (``paddle_tpu_torch.fluid``:
framework, layers, ``append_backward``, Executor, program-form Adam, and
``models.gpt.build_gpt_lm_train``) held against the JAX package on the
CPU.

Programs are built under a fresh ``unique_name.guard()`` on both sides,
so every variable carries the reference's name. Values cross as numpy
arrays: the reference's startup scope goes into the port's with
``load_fluid_scope``. Dropout is 0 wherever values are compared (the two
packages draw masks from different random streams). Tolerances are
stated at each comparison.
"""

import collections

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import profiler as tprofiler
from paddle_tpu_torch.fluid.ops import registry as tregistry
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.models import gpt as tgpt
from test_torch_cpu_math import pin_vector_math

pin_vector_math(2)  # 2 threads, vector math set up on one (see there)

T = 16
BATCH = 2
LR = 1e-3


def _feed(seed=0, vocab=211):
    rs = np.random.RandomState(seed)
    mask = np.ones((BATCH, T, 1), np.float32)
    mask[1, 11:] = 0.0
    return {"ids": rs.randint(0, vocab, (BATCH, T, 1)).astype("int64"),
            "pos_ids": np.tile(np.arange(T).reshape(1, T, 1),
                               (BATCH, 1, 1)).astype("int64"),
            "input_mask": mask}


def _cfg(mod, flash, dropout=0.0):
    return mod.GPTConfig.tiny(use_flash_attention=flash,
                              max_position_embeddings=T,
                              hidden_dropout=dropout,
                              attention_dropout=dropout)


def _ops(program):
    return collections.Counter(op.type for op in program.global_block().ops)


def _reference_program(flash, steps):
    """The reference's program after its startup run: (startup scope
    arrays, losses of ``steps`` Adam steps, {param: value} after them)."""
    cfg = _cfg(jgpt, flash)
    with jfluid.unique_name.guard():
        main, startup, _feeds, loss = jgpt.build_gpt_lm_train(
            cfg, T, learning_rate=LR)
    main.random_seed = startup.random_seed = 7
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.core.Scope()
    with jfluid.executor.scope_guard(scope):
        exe.run(startup)
    arrays = {n: np.array(scope.get(n)) for n in scope.local_var_names()
              if scope.get(n) is not None}
    losses = [float(np.asarray(exe.run(main, feed=_feed(), fetch_list=[loss],
                                       scope=scope)[0]).reshape(-1)[0])
              for _ in range(steps)]
    params = {n: np.array(scope.get(n))
              for n in tgpt.fluid_param_shapes(_cfg(tgpt, flash))}
    return arrays, losses, params


def _port_program(flash, dropout=0.0):
    with tfluid.unique_name.guard():
        main, startup, feeds, loss = tgpt.build_gpt_lm_train(
            _cfg(tgpt, flash, dropout), T, learning_rate=LR)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    return main, startup, feeds, loss, exe, scope


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "dense"])
def test_gpt_program_has_the_reference_op_types(flash):
    """At 2 layers (dropout 0.1, the config's default) the main and
    startup programs hold the same op types as often as the reference's:
    forward, ``*_grad`` and ``sum`` ops, 36 ``adam`` ops, and the
    startup's ``uniform_random`` / ``fill_constant`` initializers."""
    with jfluid.unique_name.guard():
        jmain, jstart, _f, _l = jgpt.build_gpt_lm_train(
            _cfg(jgpt, flash, 0.1), T)
    with tfluid.unique_name.guard():
        tmain, tstart, feeds, loss = tgpt.build_gpt_lm_train(
            _cfg(tgpt, flash, 0.1), T)
    assert _ops(tmain) == _ops(jmain)
    assert _ops(tstart) == _ops(jstart)
    assert _ops(tmain)["adam"] == 36
    assert [f.name for f in feeds] == ["ids", "pos_ids", "input_mask"]
    assert loss.name == [op.output("Out")[0] for op in
                         jmain.global_block().ops
                         if op.type == "elementwise_div"][0]
    assert sorted(p.name for p in tmain.all_parameters()) == sorted(
        p.name for p in jmain.all_parameters())


@pytest.fixture(scope="module", params=[True, False], ids=["flash", "dense"])
def reference(request):
    arrays, losses, params = _reference_program(request.param, 5)
    return {"flash": request.param, "arrays": arrays, "losses": losses,
            "params": params}


def test_five_adam_steps_match_reference_executor(reference):
    """The reference's startup scope (parameters, moments, β-pows,
    learning rate) copied into the port's with ``load_fluid_scope``, the
    same feed, 5 Adam steps through each package's Executor: losses
    within 1e-5 relative (fp32 on both sides, ~2e-7 seen), parameters
    within 1e-4 relative norm, and over all parameters together. The
    k-projection biases are the exception per parameter: their exact
    gradient is 0 (softmax is shift-invariant), so Adam turns each side's
    rounding noise into lr-sized steps; they are held to an absolute
    5·lr."""
    main, _s, _f, loss, exe, scope = _port_program(reference["flash"])
    tgpt.load_fluid_scope(scope, reference["arrays"])
    losses = [float(exe.run(main, feed=_feed(), fetch_list=[loss],
                            scope=scope)[0].reshape(-1)[0])
              for _ in range(5)]
    np.testing.assert_allclose(losses, reference["losses"], rtol=1e-5)
    assert losses[-1] < losses[0]
    num = den = 0.0
    for name, want in reference["params"].items():
        got = scope.get(name).numpy()
        d = float(np.linalg.norm(got - want))
        num, den = num + d * d, den + float(np.linalg.norm(want)) ** 2
        if "_att_k.b_0" in name:
            assert np.abs(got - want).max() <= 5 * LR, name
        else:
            assert d <= 1e-4 * float(np.linalg.norm(want)), name
    assert np.sqrt(num / den) <= 1e-4


def test_program_step_matches_eager_step():
    """The program and the eager step (``build_gpt_lm_train_eager``) from
    the same weights (``init_fluid_params``) and feeds, flash on: 5 Adam
    losses within 1e-5 relative (the same fp32 functions, the same
    update rule, summed in other orders)."""
    cfg = _cfg(tgpt, True)
    arrays = tgpt.init_fluid_params(cfg, 3)
    main, _s, _f, loss, exe, scope = _port_program(True)
    tgpt.load_fluid_scope(scope, arrays)
    model, _opt, _names, step = tgpt.build_gpt_lm_train_eager(
        cfg, T, learning_rate=LR, device="cpu")
    tgpt.load_fluid_params(model, arrays)
    got = [float(exe.run(main, feed=_feed(i), fetch_list=[loss],
                         scope=scope)[0].reshape(-1)[0]) for i in range(5)]
    want = [step(_feed(i)) for i in range(5)]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_train_step_replays_no_forward():
    """Every generic grad op of the GPT train step uses the closure its
    forward kept (``generic_grad_replays`` stays 0), and the flash grad
    runs from the forward's residuals: on the CPU no kernel launches,
    and the step takes 2 layers' flash forwards, no more."""
    main, _s, _f, loss, exe, scope = _port_program(True)
    generic = [op.type for op in main.global_block().ops
               if tregistry.is_generic_grad(op.type)]
    assert "mul_grad" in generic and "layer_norm_grad" in generic
    r0 = tprofiler.get_counter(tregistry.REPLAY_COUNTER)
    calls = []
    real = tfa.flash_attention_lse_plain

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    tfa.flash_attention_lse_plain = counting
    try:
        exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
    finally:
        tfa.flash_attention_lse_plain = real
    assert tprofiler.get_counter(tregistry.REPLAY_COUNTER) == r0
    assert len(calls) == 2


def test_generic_grad_replays_and_counts_without_its_forward():
    """A generic grad op whose forward is not in the block replays the
    forward on the autograd tape and counts the replay."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[3], dtype="float32")
        x.stop_gradient = False
        y = tfluid.layers.scale(x, scale=3.0)
        loss = tfluid.layers.reduce_sum(y)
        tfluid.append_backward(loss)
    block = main.global_block()
    fwd = [op for op in block.ops if op.type == "scale"][0]
    block.ops.remove(fwd)
    main._bump_version()
    r0 = tprofiler.get_counter(tregistry.REPLAY_COUNTER)
    xv = np.ones((2, 3), np.float32)
    (g,) = tfluid.Executor(tfluid.CPUPlace()).run(
        main, feed={"x": xv, y.name: xv * 3}, fetch_list=["x@GRAD"],
        scope=tfluid.Scope())
    np.testing.assert_array_equal(g, np.full((2, 3), 3.0, np.float32))
    assert tprofiler.get_counter(tregistry.REPLAY_COUNTER) == r0 + 1


def _small_program(mod):
    """fc → layer_norm → softmax → mean of a weighted sum, with its
    backward appended: the grads of every parameter and of the input."""
    fluid = mod
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[5, 6], dtype="float32")
        x.stop_gradient = False
        w = fluid.layers.data(name="w", shape=[5, 4], dtype="float32")
        h = fluid.layers.fc(x, size=4, num_flatten_dims=2, act="gelu")
        h = fluid.layers.layer_norm(h, begin_norm_axis=2)
        p = fluid.layers.softmax(h, axis=-1)
        loss = fluid.layers.mean(fluid.layers.elementwise_mul(p, w))
        pg = fluid.append_backward(loss)
    return main, startup, loss, [g.name for _p, g in pg] + ["x@GRAD"]


def test_append_backward_grads_match_reference():
    """``append_backward`` on a small fc / gelu / layer_norm / softmax
    program: the same grad op types, and every gradient equal to the
    reference Executor's from the same startup values (fp32, atol 1e-6:
    a handful of products of size ~1)."""
    jmain, jstart, jloss, jgrads = _small_program(jfluid)
    tmain, tstart, tloss, tgrads = _small_program(tfluid)
    assert _ops(tmain) == _ops(jmain)
    assert tgrads == jgrads
    rs = np.random.RandomState(9)
    feed = {"x": rs.randn(2, 5, 6).astype(np.float32),
            "w": rs.randn(2, 5, 4).astype(np.float32)}
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.core.Scope()
    with jfluid.executor.scope_guard(jscope):
        jexe.run(jstart)
    want = jexe.run(jmain, feed=feed, fetch_list=[jloss] + jgrads,
                    scope=jscope)
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    texe.run(tstart, scope=tscope)
    for name in tscope.local_var_names():
        tscope.get(name).copy_(torch.from_numpy(np.array(jscope.get(name))))
    got = texe.run(tmain, feed=feed, fetch_list=[tloss] + tgrads,
                   scope=tscope)
    for name, a, b in zip(["loss"] + tgrads, got, want):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6, rtol=1e-5,
                                   err_msg=name)


_RULE_CASES = {
    # name: (rule op, [x shape, y shape or None], forward on (layers, x, y))
    "add_axis": ("elementwise_add", [[2, 3, 4], [3]],
                 lambda L, x, y: L.elementwise_add(x, y, axis=1)),
    "add_same": ("elementwise_add", [[2, 3, 4], [2, 3, 4]],
                 lambda L, x, y: L.elementwise_add(x, y)),
    "add_trailing": ("elementwise_add", [[2, 3, 4], [4]],
                     lambda L, x, y: L.elementwise_add(x, y)),
    "mul": ("mul", [[2, 3, 4], None],
            lambda L, x, y: L.fc(x, size=5, num_flatten_dims=2)),
    "mul_flat": ("mul", [[2, 3, 4], None],
                 lambda L, x, y: L.fc(x, size=5, num_flatten_dims=1)),
    "reshape2": ("reshape2", [[2, 3, 4], None],
                 lambda L, x, y: L.reshape(x, shape=[0, 12])),
    "transpose2": ("transpose2", [[2, 3, 4], None],
                   lambda L, x, y: L.transpose(x, perm=[2, 0, 1])),
    "layer_norm": ("layer_norm", [[2, 3, 4], None],
                   lambda L, x, y: L.layer_norm(x, begin_norm_axis=1)),
    "layer_norm_last": ("layer_norm", [[2, 3, 4], None],
                        lambda L, x, y: L.layer_norm(x, begin_norm_axis=2)),
    "gelu": ("gelu", [[2, 3, 4], None],
             lambda L, x, y: L.fc(x, size=4, num_flatten_dims=2,
                                  act="gelu")),
}


@pytest.mark.parametrize("case", sorted(_RULE_CASES))
def test_vjp_rules_match_the_autograd_tape(case):
    """An op's hand-written pullback (``register_op(vjp=...)``) gives the
    grads the autograd tape gives for the same forward: every input and
    parameter grad of ``sum(op(x, y) · w)``, with the rule in use and
    with it switched off (fp32 on the CPU, rtol 1e-6 / atol 1e-6: the
    same kernels, at most a reduction in another order)."""
    op_type, shapes, forward = _RULE_CASES[case]
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        ins = []
        for name, shape in zip("xy", shapes):
            if shape is not None:
                ins.append(tfluid.layers.data(name, shape, stop_gradient=False,
                                              append_batch_size=False))
        out = forward(tfluid.layers, *(ins + [None] * (2 - len(ins))))
        w = tfluid.layers.data("w", list(out.shape), append_batch_size=False)
        loss = tfluid.layers.reduce_sum(tfluid.layers.elementwise_mul(out, w))
        grads = [g.name for _p, g in tfluid.append_backward(loss)]
    grads += [v.name + "@GRAD" for v in ins]
    rs = np.random.RandomState(5)
    feed = {v.name: rs.randn(*shape).astype(np.float32)
            for v, shape in zip(ins, shapes)}
    feed["w"] = rs.randn(*out.shape).astype(np.float32)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    op_def = tregistry.get_op_def(op_type)
    rule, calls = op_def.vjp, []

    def counting(*args):
        calls.append(1)
        return rule(*args)

    op_def.vjp = counting
    try:
        with_rule = exe.run(main, feed=feed, fetch_list=grads, scope=scope)
        op_def.vjp = None
        with_tape = exe.run(main, feed=feed, fetch_list=grads, scope=scope)
    finally:
        op_def.vjp = rule
    assert calls
    for name, a, b in zip(grads, with_rule, with_tape):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=name)


def test_clone_for_test_drops_dropout_and_the_backward():
    """``clone(for_test=True)`` keeps the forward with every ``is_test``
    attribute set, so the dropout ops and the flash kernel's dropout are
    off: two runs give the same loss, and no backward or update op is
    left."""
    main, _s, _f, loss, exe, scope = _port_program(True, dropout=0.1)
    test_prog = main.clone(for_test=True)
    types = _ops(test_prog)
    assert "adam" not in types and not [t for t in types
                                        if t.endswith("_grad")]
    assert all(op.attr("is_test") for op in test_prog.global_block().ops
               if op.type in ("dropout", "flash_attention"))
    a = exe.run(test_prog, feed=_feed(), fetch_list=[loss], scope=scope)[0]
    b = exe.run(test_prog, feed=_feed(), fetch_list=[loss], scope=scope)[0]
    np.testing.assert_array_equal(a, b)
    c = exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)[0]
    d = exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)[0]
    assert not np.array_equal(c, d)   # training drops (and updates)


def _bias_program(mod, B, N, S, D):
    """q/k/v = fc(x) split into heads, flash attention with a learnable
    per-head bias [1, N, S, S] and causal masking, then mean(out·w);
    Adam at lr 1e-2."""
    fluid = mod
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[S, N * D], dtype="float32")
        w = fluid.layers.data(name="w", shape=[N, S, D], dtype="float32")
        bias = fluid.layers.create_parameter([1, N, S, S], "float32",
                                             name="attn_bias")

        def heads(name):
            h = fluid.layers.fc(x, size=N * D, num_flatten_dims=2, name=name)
            h = fluid.layers.reshape(h, shape=[0, 0, N, D])
            return fluid.layers.transpose(h, perm=[0, 2, 1, 3])

        out = fluid.layers.flash_attention(heads("q"), heads("k"), heads("v"),
                                           bias=bias, causal=True)
        loss = fluid.layers.mean(fluid.layers.elementwise_mul(out, w))
        fluid.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    return main, startup, loss


def test_flash_attention_layer_with_learnable_bias_matches_reference():
    """``fluid.layers.flash_attention(q, k, v, bias=...)`` with a
    ``create_parameter`` per-head bias, trained 3 Adam steps through each
    package's Executor from the same startup values: losses within 1e-5
    relative, and the bias and its step-1 gradient within 1e-5 relative
    / 1e-6 absolute (the reference replays its forward for a general
    bias; the port drives the backward from the forward's residuals —
    the same gradient)."""
    B, N, S, D = 2, 2, 12, 8
    jmain, jstart, jloss = _bias_program(jfluid, B, N, S, D)
    tmain, tstart, tloss = _bias_program(tfluid, B, N, S, D)
    assert _ops(tmain) == _ops(jmain)
    rs = np.random.RandomState(3)
    feed = {"x": rs.randn(B, S, N * D).astype(np.float32),
            "w": rs.randn(B, N, S, D).astype(np.float32)}
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.core.Scope()
    with jfluid.executor.scope_guard(jscope):
        jexe.run(jstart)
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    texe.run(tstart, scope=tscope)
    for name in tscope.local_var_names():
        tscope.get(name).copy_(torch.from_numpy(np.array(jscope.get(name))))
    for i in range(3):
        fetch = [jloss.name] + (["attn_bias@GRAD"] if i == 0 else [])
        want = jexe.run(jmain, feed=feed, fetch_list=fetch, scope=jscope)
        got = texe.run(tmain, feed=feed, fetch_list=fetch, scope=tscope)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5,
                                       atol=1e-7)
    # query row 0 attends to key 0 alone (causal): p = 1 there and the
    # exact gradient of bias[.., 0, 0] is 0, so Adam turns each side's
    # rounding noise into lr-sized steps (as for the k biases above)
    got = tscope.get("attn_bias").numpy()
    want = np.asarray(jscope.get("attn_bias"))
    assert np.abs(got - want)[:, :, 0, 0].max() <= 3 * 1e-2
    got[:, :, 0, 0] = want[:, :, 0, 0]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_load_fluid_scope_checks_names_and_shapes():
    _m, _s, _f, _l, _exe, scope = _port_program(True)
    arrays = tgpt.init_fluid_params(_cfg(tgpt, True), 0)
    tgpt.load_fluid_scope(scope, arrays)
    np.testing.assert_array_equal(scope.get("tok_embedding").numpy(),
                                  arrays["tok_embedding"])
    with pytest.raises(KeyError):
        tgpt.load_fluid_scope(scope, dict(arrays, bogus=np.zeros(1)))
    partial = dict(arrays)
    partial.pop("lm_head.b_0")
    with pytest.raises(KeyError):
        tgpt.load_fluid_scope(scope, partial)
    with pytest.raises(ValueError):
        tgpt.load_fluid_scope(scope, dict(arrays,
                                          **{"lm_head.b_0": np.zeros(3)}))


def test_program_builder_rejects_what_it_does_not_port():
    """``use_amp`` builds and runs (the AMP program; held against the
    reference in ``test_torch_amp.py``); recompute checkpoints, which
    raised until ROADMAP A8, build (``test_torch_recompute.py`` holds
    them against the reference)."""
    with tfluid.unique_name.guard():
        main, startup, _feeds, loss = tgpt.build_gpt_lm_train(
            _cfg(tgpt, True), T, use_amp=True)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    value = exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)[0]
    assert np.isfinite(value).all()
    assert _ops(main)["cast"] > 0
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[3], dtype="float32")
        h = tfluid.layers.fc(x, size=2)
        loss = tfluid.layers.reduce_sum(h)
        params_grads = tfluid.append_backward(loss, checkpoints=[h])
    assert sorted(p.name for p, _g in params_grads) == sorted(
        p.name for p in main.global_block().all_parameters())
    assert "recompute_barrier" in _ops(main)
