"""Automatic mixed precision in the port (``paddle_tpu_torch.fluid.
contrib.mixed_precision``, ``fluid.ir``, the cast / isfinite / compare /
logical / where ops, and ``build_gpt_lm_train(use_amp=True)`` with its
eager counterpart) held against the JAX package on the CPU.

Programs are built under a fresh ``unique_name.guard()`` on both sides,
so every variable and every inserted cast carries the reference's name.
Values cross as numpy arrays; dropout is 0 wherever values are compared.
Tolerances are stated at each comparison.
"""

import collections

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid.contrib.mixed_precision import fp16_lists as jlists
from paddle_tpu.fluid.contrib.mixed_precision import fp16_utils as jutils
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import profiler as tprofiler
from paddle_tpu_torch.fluid.contrib.mixed_precision import fp16_lists as tlists
from paddle_tpu_torch.fluid.contrib.mixed_precision import fp16_utils as tutils
from paddle_tpu_torch.fluid.ops import registry as tregistry
from paddle_tpu_torch.models import gpt as tgpt
from test_torch_cpu_math import pin_vector_math

pin_vector_math(2)  # 2 threads, vector math set up on one (see there)

T = 16
BATCH = 2
LR = 1e-3
FP32, BF16 = 5, 22          # the VarType enum, the same in both packages
INT32, INT64 = 2, 3


def _feed(seed=0, vocab=211):
    rs = np.random.RandomState(seed)
    mask = np.ones((BATCH, T, 1), np.float32)
    mask[1, 11:] = 0.0
    return {"ids": rs.randint(0, vocab, (BATCH, T, 1)).astype("int64"),
            "pos_ids": np.tile(np.arange(T).reshape(1, T, 1),
                               (BATCH, 1, 1)).astype("int64"),
            "input_mask": mask}


def _cfg(mod, flash):
    return mod.GPTConfig.tiny(use_flash_attention=flash,
                              max_position_embeddings=T, hidden_dropout=0.0,
                              attention_dropout=0.0)


def _amp_programs(flash):
    with jfluid.unique_name.guard():
        jprog = jgpt.build_gpt_lm_train(_cfg(jgpt, flash), T,
                                        learning_rate=LR, use_amp=True)
    with tfluid.unique_name.guard():
        tprog = tgpt.build_gpt_lm_train(_cfg(tgpt, flash), T,
                                        learning_rate=LR, use_amp=True)
    return jprog, tprog


def _io(op_):
    return ({k: list(v) for k, v in op_.inputs.items()},
            {k: list(v) for k, v in op_.outputs.items()})


# ---------------------------------------------------------------------------
# (a) the rewrite, exactly
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "dense"])
def test_amp_program_equals_reference_op_for_op(flash):
    """``build_gpt_lm_train(use_amp=True)`` in both packages: the same op
    types in the same order with the same input and output names (so the
    same ``cast`` ops at the same places, reading and writing the same
    vars), and every float var desc of the same dtype. Integer vars
    agree but for the one difference the port makes on purpose: the
    reference's JAX runs int64 ids as int32 (x64 off), so its sliced
    target ids are described int32 where the port keeps int64."""
    (jmain, _js, _jf, _jl), (tmain, _ts, _tf, _tl) = _amp_programs(flash)
    jops, tops = jmain.global_block().ops, tmain.global_block().ops
    assert [o.type for o in tops] == [o.type for o in jops]
    for i, (a, b) in enumerate(zip(jops, tops)):
        assert _io(b) == _io(a), (i, a.type)
        if a.type == "cast":
            assert (int(b.attr("in_dtype")), int(b.attr("out_dtype"))) == \
                (int(a.attr("in_dtype")), int(a.attr("out_dtype"))), i
    jvars, tvars = jmain.global_block().vars, tmain.global_block().vars
    assert sorted(tvars) == sorted(jvars)
    ints = []
    for name, jv in jvars.items():
        jd, td = int(jv.dtype), int(tvars[name].dtype)
        if jd != td:
            ints.append(name)
            assert (jd, td) == (INT32, INT64), (name, jd, td)
    assert ints == ["slice_1.tmp_0"]       # the shifted target ids
    types = collections.Counter(o.type for o in tops)
    assert types["cast"] == (36 if flash else 41)
    flash_ops = [o for o in tops if o.type == "flash_attention"]
    assert len(flash_ops) == (2 if flash else 0)
    for o in flash_ops:
        for slot in ("Q", "K", "V"):
            assert int(tmain.global_block().var(o.input(slot)[0]).dtype) == BF16
        assert int(tmain.global_block().var(o.input("KeyBias")[0]).dtype) \
            == FP32


def _fc_bias_program(fluid):
    """mul (white) -> elementwise_add with an fp32 bias param (gray)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        fluid.layers.fc(input=x, size=4)
    return main


def _raw_conv_bn_program(fluid):
    """A white ``conv2d`` then ``batch_norm`` built from raw ops with
    explicit var descs (the port has no conv or batch-norm layer yet; the
    rewrite reads only the descs)."""
    main = fluid.Program()
    blk = main.global_block()
    shapes = {"img": [-1, 3, 8, 8], "w": [4, 3, 3, 3], "c": [-1, 4, 6, 6],
              "scale": [4], "bias": [4], "mean": [4], "var": [4],
              "y": [-1, 4, 6, 6], "mean_out": [4], "var_out": [4],
              "saved_mean": [4], "saved_var": [4]}
    for name, shape in shapes.items():
        blk.create_var(name=name, shape=shape, dtype="float32")
    blk.append_op(type="conv2d", inputs={"Input": ["img"], "Filter": ["w"]},
                  outputs={"Output": ["c"]},
                  attrs={"strides": [1, 1], "paddings": [0, 0],
                         "dilations": [1, 1], "groups": 1})
    blk.append_op(type="batch_norm",
                  inputs={"X": ["c"], "Scale": ["scale"], "Bias": ["bias"],
                          "Mean": ["mean"], "Variance": ["var"]},
                  outputs={"Y": ["y"], "MeanOut": ["mean_out"],
                           "VarianceOut": ["var_out"],
                           "SavedMean": ["saved_mean"],
                           "SavedVariance": ["saved_var"]},
                  attrs={"epsilon": 1e-5, "momentum": 0.9,
                         "is_test": False})
    return main


def _gray_add_case(fluid, lists, utils):
    main = _fc_bias_program(fluid)
    utils.rewrite_program(main, lists.AutoMixedPrecisionLists())
    return main


def _black_varname_case(fluid, lists, utils):
    main = _fc_bias_program(fluid)
    add = [o for o in main.global_block().ops
           if o.type == "elementwise_add"][-1]
    utils.rewrite_program(main, lists.AutoMixedPrecisionLists(
        custom_black_varnames=[add.inputs["Y"][0]]))
    return main


def _batch_norm_case(fluid, lists, utils):
    main = _raw_conv_bn_program(fluid)
    utils.rewrite_program(main, lists.AutoMixedPrecisionLists())
    return main


def _flash_mask_case(fluid, lists, utils):
    mod = jgpt if fluid is jfluid else tgpt
    with fluid.unique_name.guard():
        main, _s, _f, _l = mod.build_gpt_lm_train(_cfg(mod, True), T,
                                                  use_amp=True)
    return main


def _check_gray_add(main):
    blk = main.global_block()
    add = [o for o in blk.ops if o.type == "elementwise_add"][-1]
    for slot in ("X", "Y"):
        assert int(blk.var(add.inputs[slot][0]).dtype) == BF16, slot
    assert int(blk.var(add.outputs["Out"][0]).dtype) == BF16
    assert ".cast" in add.inputs["Y"][0]


def _check_black_varname(main):
    blk = main.global_block()
    add = [o for o in blk.ops if o.type == "elementwise_add"][-1]
    assert ".cast" not in add.inputs["Y"][0]
    assert int(blk.var(add.outputs["Out"][0]).dtype) == FP32


def _check_batch_norm(main):
    blk = main.global_block()
    bn = [o for o in blk.ops if o.type == "batch_norm"][0]
    assert int(blk.var(bn.inputs["X"][0]).dtype) == BF16
    for slot in ("Scale", "Bias", "Mean", "Variance"):
        assert bn.inputs[slot] == [slot.lower() if slot != "Variance"
                                   else "var"], slot
        assert int(blk.var(bn.inputs[slot][0]).dtype) == FP32, slot
    for slot in ("MeanOut", "VarianceOut", "SavedMean", "SavedVariance"):
        assert int(blk.var(bn.outputs[slot][0]).dtype) == FP32, slot
    assert int(blk.var("y").dtype) == BF16


def _check_flash_mask(main):
    blk = main.global_block()
    fl = [o for o in blk.ops if o.type == "flash_attention"][0]
    for slot in ("Q", "K", "V"):
        assert int(blk.var(fl.inputs[slot][0]).dtype) == BF16, slot
    assert int(blk.var(fl.inputs["KeyBias"][0]).dtype) == FP32
    assert ".cast" not in fl.inputs["KeyBias"][0]


_GRAY_CASES = {
    "gray_add_casts_fp32_bias_after_white_matmul":
        (_gray_add_case, _check_gray_add),
    "black_varname_input_suppresses_gray_desc_flip":
        (_black_varname_case, _check_black_varname),
    "batch_norm_affine_slots_stay_fp32":
        (_batch_norm_case, _check_batch_norm),
    "flash_attention_mask_slots_stay_fp32":
        (_flash_mask_case, _check_flash_mask),
}


@pytest.mark.parametrize("case", sorted(_GRAY_CASES) +
                         ["rewritten_fc_program_still_trains"])
def test_gray_harmonization_matches_reference(case):
    """The five cases of the reference's
    ``tests/test_amp_gray_harmonization.py`` on both packages: each
    rewritten program holds the reference test's expectations, and the
    port's program equals the reference's op for op, name for name and
    dtype for dtype. The training case runs the rewritten fc program in
    both (same parameters and feed, Adam): losses finite, falling, and
    within 1e-2 relative of each other (bf16 products)."""
    if case == "rewritten_fc_program_still_trains":
        return _fc_program_trains()
    build, check = _GRAY_CASES[case]
    with jfluid.unique_name.guard():
        jmain = build(jfluid, jlists, jutils)
    with tfluid.unique_name.guard():
        tmain = build(tfluid, tlists, tutils)
    check(jmain)
    check(tmain)
    jops, tops = jmain.global_block().ops, tmain.global_block().ops
    assert [o.type for o in tops] == [o.type for o in jops]
    for a, b in zip(jops, tops):
        assert _io(b) == _io(a), a.type
    jvars, tvars = jmain.global_block().vars, tmain.global_block().vars
    for name, jv in jvars.items():
        if name in ("ids", "pos_ids") or name.startswith("slice_1"):
            continue                       # int64 ids: see the test above
        assert int(tvars[name].dtype) == int(jv.dtype), name


def _fc_program(fluid, opt_mod):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=x, size=16, act="relu")
        logits = fluid.layers.fc(input=h, size=4)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        opt_mod.decorate(fluid.optimizer.Adam(learning_rate=0.01)) \
            .minimize(loss)
    return main, startup, loss


def _fc_program_trains():
    from paddle_tpu.fluid.contrib import mixed_precision as jmp
    from paddle_tpu_torch.fluid.contrib import mixed_precision as tmp

    rs = np.random.RandomState(0)
    feed = {"x": rs.rand(16, 8).astype("float32"),
            "y": rs.randint(0, 4, (16, 1)).astype("int64")}
    with jfluid.unique_name.guard():
        jmain, jstart, jloss = _fc_program(jfluid, jmp)
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.core.Scope()
    with jfluid.executor.scope_guard(scope):
        exe.run(jstart)
    arrays = {n: np.array(scope.get(n)) for n in scope.local_var_names()
              if scope.get(n) is not None}
    jl = [float(np.asarray(exe.run(jmain, feed=feed, fetch_list=[jloss],
                                   scope=scope)[0]).ravel()[0])
          for _ in range(4)]
    with tfluid.unique_name.guard():
        tmain, tstart, tloss = _fc_program(tfluid, tmp)
    texe = tfluid.Executor(tfluid.CPUPlace())
    tscope = tfluid.Scope()
    texe.run(tstart, scope=tscope)
    for name, arr in arrays.items():
        t = tscope.get(name)
        assert t is not None and tuple(t.shape) == arr.shape, name
        t.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))
    tl = [float(texe.run(tmain, feed=feed, fetch_list=[tloss],
                         scope=tscope)[0].ravel()[0]) for _ in range(4)]
    for losses in (jl, tl):
        assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    np.testing.assert_allclose(tl, jl, rtol=1e-2)


# ---------------------------------------------------------------------------
# (c) the tiny AMP step, JAX against the port
# ---------------------------------------------------------------------------

# bf16 rounds every product operand with unit roundoff 2^-9: the k
# projections' biases, whose exact gradient is 0 (softmax ignores a shift
# shared by all keys), come back as rounding noise of up to ~1e-4 of the
# whole gradient's norm on both sides; the denominator of the relative
# norm is floored at one bf16 step (2^-8) of the whole gradient's norm
GRAD_RTOL, GRAD_FLOOR = 5e-2, 2.0 ** -8


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "dense"])
def test_tiny_amp_step_matches_reference(flash):
    """Same parameters (the reference's startup scope), same feed, dropout
    0: the step-1 loss within 1e-2 relative (bf16 products summed in
    other orders; the reference's CPU attention is its dense fallback,
    which rounds the scores to bf16), every parameter's step-1 gradient
    within 5e-2 relative norm (floored as above), and 3 steps of falling
    losses in both. The port's step replays no forward."""
    (jmain, jstart, _jf, jloss), (tmain, tstart, _tf, tloss) = \
        _amp_programs(flash)
    names = list(tgpt.fluid_param_shapes(_cfg(tgpt, flash)))
    fetch = [jloss.name] + [n + "@GRAD" for n in names]
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.core.Scope()
    with jfluid.executor.scope_guard(scope):
        exe.run(jstart)
    arrays = {n: np.array(scope.get(n)) for n in scope.local_var_names()
              if scope.get(n) is not None}
    jout = exe.run(jmain, feed=_feed(), fetch_list=fetch, scope=scope)
    jl = [float(np.asarray(jout[0]).ravel()[0])] + [
        float(np.asarray(exe.run(jmain, feed=_feed(), fetch_list=[jloss],
                                 scope=scope)[0]).ravel()[0])
        for _ in range(2)]
    texe = tfluid.Executor(tfluid.CPUPlace())
    tscope = tfluid.Scope()
    texe.run(tstart, scope=tscope)
    tgpt.load_fluid_scope(tscope, {n: a for n, a in arrays.items()
                                   if tscope.get(n) is not None})
    replays = tprofiler.get_counter(tregistry.REPLAY_COUNTER)
    tout = texe.run(tmain, feed=_feed(), fetch_list=fetch, scope=tscope)
    tl = [float(tout[0].ravel()[0])] + [
        float(texe.run(tmain, feed=_feed(), fetch_list=[tloss],
                       scope=tscope)[0].ravel()[0]) for _ in range(2)]
    assert tprofiler.get_counter(tregistry.REPLAY_COUNTER) == replays
    assert abs(tl[0] - jl[0]) <= 1e-2 * abs(jl[0]), (tl, jl)
    for losses in (jl, tl):
        assert losses[2] < losses[1] < losses[0], losses
    jg = [np.asarray(a, np.float32) for a in jout[1:]]
    total = float(np.sqrt(sum(float((g ** 2).sum()) for g in jg)))
    for name, want, got in zip(names, jg, tout[1:]):
        assert got.dtype == np.float32, name      # fp32 master gradients
        rel = np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                               GRAD_FLOOR * total)
        assert rel <= GRAD_RTOL, (name, rel)


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "dense"])
def test_eager_amp_step_matches_amp_program(flash):
    """``build_gpt_lm_train_eager(use_amp=True)`` (explicit casts at the
    rewrite's boundaries) against the AMP program on the same weights and
    feed: the step-1 loss within 1e-3 relative (the same bf16 functions;
    a cast at another boundary moves it by ~1e-2), and three steps in
    step."""
    cfg = _cfg(tgpt, flash)
    arrays = tgpt.init_fluid_params(cfg, 3)
    with tfluid.unique_name.guard():
        main, startup, _f, loss = tgpt.build_gpt_lm_train(
            cfg, T, learning_rate=LR, use_amp=True)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    tgpt.load_fluid_scope(scope, arrays)
    prog = [float(exe.run(main, feed=_feed(), fetch_list=[loss],
                          scope=scope)[0].ravel()[0]) for _ in range(3)]
    _model, _opt, _names, step = tgpt.build_gpt_lm_train_eager(
        cfg, T, learning_rate=LR, use_amp=True, device="cpu", seed=3)
    eager = [step(_feed()) for _ in range(3)]
    np.testing.assert_allclose(eager, prog, rtol=1e-3)


def test_amp_logits_are_bf16_and_parameters_stay_fp32():
    cfg = _cfg(tgpt, True)
    model = tgpt.GPTLM(cfg, device="cpu")
    tgpt.load_fluid_params(model, tgpt.init_fluid_params(cfg, 0))
    f = _feed()
    ids, pos, mask = (torch.from_numpy(f[n])
                      for n in ("ids", "pos_ids", "input_mask"))
    with torch.no_grad():
        logits = model(ids, pos, mask, amp_dtype=torch.bfloat16)
        ref = model(ids, pos, mask)
    assert logits.dtype == torch.bfloat16
    assert logits.shape == (BATCH, T, cfg.vocab_size)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    # within bf16 rounding of the fp32 forward
    assert float((logits.float() - ref).abs().max()) < 0.05


# ---------------------------------------------------------------------------
# (d) the dynamic loss scaler
# ---------------------------------------------------------------------------


def _scaled_program(fluid, mp):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        loss = fluid.layers.reduce_sum(fluid.layers.fc(input=x, size=3))
        opt = mp.decorate(fluid.optimizer.Adam(learning_rate=0.1),
                          init_loss_scaling=2.0 ** 15,
                          incr_every_n_steps=2, incr_ratio=2.0,
                          decr_ratio=0.5, use_dynamic_loss_scaling=True)
        opt.minimize(loss)
    masked = [o.output("Out")[0] for o in main.global_block().ops
              if o.type == "where"]
    return main, startup, loss, masked


def test_dynamic_loss_scaling_matches_reference():
    """``decorate(use_dynamic_loss_scaling=True)`` in both packages from
    the same weights: step 1 feeds an inf (every weight gradient is
    inf), steps 2-4 finite values. After each step the loss scale and the
    good-step counter equal the reference's (2^15 shrinks by 0.5, then
    grows by 2 after 2 good steps); on the inf step every masked gradient
    is exactly zero and the parameters do not move."""
    from paddle_tpu.fluid.contrib import mixed_precision as jmp
    from paddle_tpu_torch.fluid.contrib import mixed_precision as tmp

    with jfluid.unique_name.guard():
        jmain, jstart, jloss, jmasked = _scaled_program(jfluid, jmp)
    with tfluid.unique_name.guard():
        tmain, tstart, tloss, tmasked = _scaled_program(tfluid, tmp)
    assert tmasked == jmasked and len(tmasked) == 2
    rs = np.random.RandomState(5)
    good = rs.rand(6, 4).astype("float32")
    bad = good.copy()
    bad[2, 1] = np.inf
    feeds = [bad, good, good, good]
    state = ["loss_scaling", "loss_scaling_good_steps"]
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.core.Scope()
    with jfluid.executor.scope_guard(scope):
        exe.run(jstart)
    arrays = {n: np.array(scope.get(n)) for n in scope.local_var_names()
              if scope.get(n) is not None}
    texe = tfluid.Executor(tfluid.CPUPlace())
    tscope = tfluid.Scope()
    texe.run(tstart, scope=tscope)
    for name, arr in arrays.items():
        tscope.get(name).copy_(torch.from_numpy(np.array(arr)))
    w0 = tscope.get("fc_0.w_0").clone()
    jstates, tstates = [], []
    for i, x in enumerate(feeds):
        jr = exe.run(jmain, feed={"x": x}, fetch_list=state + jmasked,
                     scope=scope)
        tr = texe.run(tmain, feed={"x": x}, fetch_list=state + tmasked,
                      scope=tscope)
        jstates.append([float(np.asarray(v).ravel()[0]) for v in jr[:2]])
        tstates.append([float(v.ravel()[0]) for v in tr[:2]])
        if i == 0:
            for g in tr[2:]:
                assert np.array_equal(g, np.zeros_like(g))
            assert torch.equal(tscope.get("fc_0.w_0"), w0)
    assert tstates == jstates
    assert [s[0] for s in tstates] == [2.0 ** 14, 2.0 ** 14, 2.0 ** 15,
                                       2.0 ** 15]


def test_amp_ops_match_reference_semantics():
    """cast across fp32/bf16/fp16 with its gradient cast back, isfinite
    over all inputs, the compares and logicals, and where with its
    gradient, as program ops on the CPU."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[3], dtype="float32",
                               append_batch_size=False)
        y = tfluid.layers.data(name="y", shape=[3], dtype="float32",
                               append_batch_size=False)
        x.stop_gradient = False
        h = tfluid.layers.cast(tfluid.layers.cast(x, "bfloat16"), "float16")
        back = tfluid.layers.cast(h, "float32")
        fin = tfluid.layers.logical_and(tfluid.layers.isfinite(x),
                                        tfluid.layers.isfinite(y))
        ge = tfluid.layers.greater_equal(x, y)
        picked = tfluid.layers.where(ge, back, y)
        loss = tfluid.layers.reduce_sum(tfluid.layers.elementwise_mul(
            picked, y))
        grads = tfluid.gradients(loss, [x])
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    xv = np.array([1.0, -2.0, 1.0 + 2 ** -10], np.float32)
    yv = np.array([0.5, 3.0, 1.0], np.float32)
    outs = exe.run(main, feed={"x": xv, "y": yv},
                   fetch_list=[h, back, fin, ge, picked, grads[0]],
                   scope=scope, return_numpy=False)
    h_t, back_t, fin_t, ge_t, picked_t, gx = outs
    assert h_t.dtype == torch.float16 and back_t.dtype == torch.float32
    # bf16 keeps 8 bits: 1 + 2^-10 rounds to 1
    np.testing.assert_array_equal(back_t.numpy(), [1.0, -2.0, 1.0])
    assert fin_t.dtype == torch.bool and fin_t.tolist() == [True]
    assert ge_t.tolist() == [True, False, True]
    np.testing.assert_array_equal(picked_t.numpy(), [1.0, 3.0, 1.0])
    # d loss / dx = y where x was picked, 0 elsewhere, cast back to fp32
    assert gx.dtype == torch.float32
    np.testing.assert_array_equal(gx.numpy(), [0.5, 0.0, 1.0])
    yv[1] = np.nan
    fin2 = exe.run(main, feed={"x": xv, "y": yv}, fetch_list=[fin],
                   scope=scope)[0]
    assert fin2.tolist() == [False]


def test_pass_registry_matches_reference():
    """The port registers the reference's AMP, dropout and collective
    gradient-allreduce passes; the two whose ops are not ported raise the
    reference's error for an unknown pass, and a PassBuilder runs the AMP
    rewrite as ``decorate`` does."""
    from paddle_tpu.fluid import ir as jir

    from paddle_tpu_torch.fluid import ir as tir

    assert set(tir.all_registered_passes()) == {
        "amp_rewrite_pass", "delete_dropout_pass",
        "collective_grad_allreduce_pass"}
    assert set(tir.all_registered_passes()) < set(jir.all_registered_passes())
    for name in ("fuse_elewise_add_act_pass", "quantization_transform_pass"):
        with pytest.raises(ValueError):
            tir.get_pass(name)
    built = {}
    for fluid, ir in ((jfluid, jir), (tfluid, tir)):
        with fluid.unique_name.guard():
            main = _fc_bias_program(fluid)
        pb = ir.PassBuilder()
        pb.append_pass("amp_rewrite_pass")
        pb.insert_pass(0, "delete_dropout_pass")
        assert [p.name for p in pb.all_passes()] == ["delete_dropout_pass",
                                                     "amp_rewrite_pass"]
        pb.apply(main)
        built[fluid] = [(o.type, _io(o)) for o in main.global_block().ops]
    assert built[tfluid] == built[jfluid]
    assert [t for t, _io_ in built[tfluid]].count("cast") == 3
