"""The training slice of the port (``paddle_tpu_torch``: the dropout op,
softmax-with-cross-entropy, Adam, and the GPT train step) held against
the JAX package on the CPU.

The GPT runs are one tiny GPT (``GPTConfig.tiny``, 2 layers, 16
positions) whose weights carry across from the reference's startup
scope with ``load_fluid_params``; off the TPU the reference's flash op
takes its dense fallback unless ``cfg.flash_interpret`` asks for the
Pallas kernels in interpret mode, and the port's kernel wrappers run
their plain versions on CPU tensors. Dropout is 0 in every comparison:
the two packages draw dropout masks from different random streams (the
in-kernel hash mask itself is held bit for bit in
``test_torch_kernels.py``). Tolerances are stated at each comparison.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as fluid
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch.fluid import optimizer as toptimizer
from paddle_tpu_torch.fluid import profiler as tprofiler
from paddle_tpu_torch.fluid.ops import math_ops as tmath
from paddle_tpu_torch.fluid.ops import nn_ops as tnn
from paddle_tpu_torch.fluid.ops import optimizer_ops as topt_ops
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.observability import trace as ttrace
from test_torch_cpu_math import pin_vector_math

pin_vector_math(2)  # 2 threads, vector math set up on one (see there)

T = 16          # positions (the tiny GPT's max_position_embeddings)
BATCH = 2
STEPS = 10
LR = 1e-3


def _feed(seed=0, vocab=211):
    """Reference-shaped feeds: [N, T, 1] ids and positions, a float mask
    with a padded tail on the second row."""
    rs = np.random.RandomState(seed)
    mask = np.ones((BATCH, T, 1), np.float32)
    mask[1, 11:] = 0.0
    return {"ids": rs.randint(0, vocab, (BATCH, T, 1)).astype("int64"),
            "pos_ids": np.tile(np.arange(T).reshape(1, T, 1),
                               (BATCH, 1, 1)).astype("int64"),
            "input_mask": mask}


def _tiny(mod, flash, **kw):
    return mod.GPTConfig.tiny(hidden_dropout=0.0, attention_dropout=0.0,
                              use_flash_attention=flash,
                              max_position_embeddings=T, **kw)


def _reference_run(flash, steps, interpret=False):
    """The reference's ``build_gpt_lm_train`` program: (startup params,
    losses of ``steps`` Adam steps at LR, {param: grad} of step 1).
    The grads are fetched in the first run, before its update, so they
    are the lr-independent step-1 gradients."""
    cfg = _tiny(jgpt, flash)
    if interpret:
        cfg.flash_interpret = True
    with fluid.unique_name.guard():
        main, startup, _feeds, loss = jgpt.build_gpt_lm_train(
            cfg, T, learning_rate=LR)
    main.random_seed = startup.random_seed = 7
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.core.Scope()
    with fluid.executor.scope_guard(scope):
        exe.run(startup)
    arrays = {name: np.array(scope.get(name))
              for name in tgpt.fluid_param_shapes(_tiny(tgpt, flash))}
    names = [p.name for p in main.global_block().all_parameters()]
    feed = _feed()
    losses, grads = [], None
    for i in range(steps):
        fetch = [loss] + ([n + "@GRAD" for n in names] if i == 0 else [])
        outs = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        losses.append(float(np.asarray(outs[0]).reshape(-1)[0]))
        if i == 0:
            grads = {n: np.asarray(g) for n, g in zip(names, outs[1:])}
    return arrays, losses, grads


def _port_step(flash, arrays):
    model, opt, feed_names, step = tgpt.build_gpt_lm_train_eager(
        _tiny(tgpt, flash), T, learning_rate=LR, device="cpu", seed=3)
    tgpt.load_fluid_params(model, arrays)
    assert feed_names == ["ids", "pos_ids", "input_mask"]
    return model, opt, step


@pytest.fixture(scope="module", params=[True, False], ids=["flash", "dense"])
def reference(request):
    arrays, losses, grads = _reference_run(request.param, STEPS)
    return {"flash": request.param, "arrays": arrays, "losses": losses,
            "grads": grads}


def test_step1_grads_of_every_parameter_match_reference(reference):
    """Every parameter's step-1 gradient against the reference's
    ``<name>@GRAD``, fp32 on both sides: two layers of products summed
    in different orders, gradients of magnitude up to ~1, so honest
    differences are ~1e-6; a wrong mask, shift or transpose is O(1e-2)."""
    model, _opt, _step = _port_step(reference["flash"], reference["arrays"])
    feed = {k: torch.from_numpy(v) for k, v in _feed().items()}
    n0 = (tfa.flash_attention_lse.launches, tfa.flash_bwd_dq.launches,
          tfa.flash_bwd_dkv.launches)
    loss = tgpt.gpt_lm_loss(model(feed["ids"], feed["pos_ids"],
                                  feed["input_mask"]),
                            feed["ids"], feed["input_mask"])
    loss.backward()
    # on CPU tensors the wrappers run their plain versions
    assert (tfa.flash_attention_lse.launches, tfa.flash_bwd_dq.launches,
            tfa.flash_bwd_dkv.launches) == n0
    np.testing.assert_allclose(float(loss.detach()), reference["losses"][0],
                               rtol=1e-5)
    targets = tgpt._param_targets(model)
    assert sorted(targets) == sorted(reference["grads"])
    for name, (param, transpose) in targets.items():
        got = param.grad.numpy()
        np.testing.assert_allclose(got.T if transpose else got,
                                   reference["grads"][name], atol=2e-6,
                                   rtol=1e-4, err_msg=name)


def test_ten_adam_steps_match_reference(reference):
    """The loss over 10 Adam steps at lr 1e-3: the parameters the port
    updates drift from the reference's by the rounding of each update
    (~1e-7 relative), so the losses agree to ~1e-5; a wrong update rule
    (e.g. bias-corrected epsilon, a skipped parameter) moves them by
    ~1e-3 within a few steps."""
    _model, _opt, step = _port_step(reference["flash"], reference["arrays"])
    c0 = tprofiler.get_counter("train_steps")
    ttrace.reset()
    losses = [step(_feed()) for _ in range(STEPS)]
    np.testing.assert_allclose(losses, reference["losses"], atol=5e-5,
                               rtol=0)
    assert losses[-1] < losses[0]
    assert tprofiler.get_counter("train_steps") == c0 + STEPS
    spans = [s for s in ttrace.get_spans() if s["name"] == "train_step"]
    assert [s["args"]["step"] for s in spans] == list(range(STEPS))
    assert len(tprofiler.get_histogram("train_step_ms")) >= STEPS


def test_two_steps_match_reference_pallas_backward():
    """With ``cfg.flash_interpret`` the reference runs its Pallas forward
    and its residual-driven backward kernels (``flash_attention_grad``)
    in interpret mode; the port's step (plain versions of its kernels on
    the CPU) matches its step-1 gradients and two losses, with the
    tolerances above."""
    arrays, losses, grads = _reference_run(True, 2, interpret=True)
    model, _opt, step = _port_step(True, arrays)
    feed = {k: torch.from_numpy(v) for k, v in _feed().items()}
    tgpt.gpt_lm_loss(model(feed["ids"], feed["pos_ids"], feed["input_mask"]),
                     feed["ids"], feed["input_mask"]).backward()
    for name, (param, transpose) in tgpt._param_targets(model).items():
        got = param.grad.numpy()
        np.testing.assert_allclose(got.T if transpose else got, grads[name],
                                   atol=2e-6, rtol=1e-4, err_msg=name)
    model.zero_grad(set_to_none=True)
    np.testing.assert_allclose([step(_feed()) for _ in range(2)], losses,
                               atol=5e-5, rtol=0)


def _counting_stream(seed, vocab):
    """A learnable stream: token t+1 = token t + 1 (mod vocab), from a
    random start per row."""
    rs = np.random.RandomState(seed)
    start = rs.randint(0, vocab, (BATCH, 1))
    ids = (start + np.arange(T).reshape(1, T)) % vocab
    return {"ids": ids.reshape(BATCH, T, 1).astype("int64"),
            "pos_ids": np.tile(np.arange(T).reshape(1, T, 1),
                               (BATCH, 1, 1)).astype("int64"),
            "input_mask": np.ones((BATCH, T, 1), np.float32)}


def test_dropout_training_is_seeded_and_learns():
    """Port only, hidden and attention dropout 0.1 (the GPT-2 recipe):
    the same seed gives the same losses, another seed other ones, and the
    loss falls on a learnable stream."""
    cfg = tgpt.GPTConfig.tiny(use_flash_attention=True,
                              max_position_embeddings=T)
    assert cfg.hidden_dropout == cfg.attention_dropout == 0.1

    def run(seed):
        _model, _opt, _names, step = tgpt.build_gpt_lm_train_eager(
            cfg, T, learning_rate=3e-3, device="cpu", seed=seed)
        return [step(_counting_stream(i, cfg.vocab_size)) for i in range(12)]

    a, b, c = run(0), run(0), run(5)
    assert a == b
    assert a != c
    assert all(np.isfinite(a))
    assert np.mean(a[-3:]) < np.mean(a[:3]) - 0.1


def test_train_mode_drops_and_serving_does_not():
    """Dropout applies only in a training forward: ``.train()`` with
    ``cfg.is_test`` false. Eval mode, ``is_test`` and the serving modes
    (which always run under the cache plumbing) are deterministic."""
    cfg = tgpt.GPTConfig.tiny(use_flash_attention=True,
                              max_position_embeddings=T)
    model = tgpt.GPTLM(cfg, device="cpu")
    tgpt.load_fluid_params(model, tgpt.init_fluid_params(cfg, 0))
    feed = {k: torch.from_numpy(v) for k, v in _feed().items()}
    args = (feed["ids"], feed["pos_ids"], feed["input_mask"])
    with torch.no_grad():
        e1, e2 = model(*args), model(*args)
        model.train()
        t1, t2 = model(*args), model(*args)
        model.cfg.is_test = True
        t3 = model(*args)
    assert torch.equal(e1, e2) and torch.equal(t3, e1)
    assert not torch.equal(t1, t2) and not torch.equal(t1, e1)


def test_eager_use_amp_builds_and_runs():
    """The eager AMP step builds and runs: a finite loss, fp32 parameters
    and optimizer state after the update."""
    cfg = tgpt.GPTConfig.tiny(use_flash_attention=True,
                              max_position_embeddings=T)
    model, opt, _names, step = tgpt.build_gpt_lm_train_eager(
        cfg, T, use_amp=True, device="cpu")
    loss = step(_feed())
    assert np.isfinite(loss)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(m.dtype == torch.float32 for m in opt.state()["moment1"])


def test_use_amp_raises():
    """The eager AMP step refuses a feed of another length than it was
    built for, as the fp32 step does, and takes no update from it."""
    cfg = tgpt.GPTConfig.tiny(use_flash_attention=True,
                              max_position_embeddings=T)
    model, _opt, _names, step = tgpt.build_gpt_lm_train_eager(
        cfg, T - 1, use_amp=True, device="cpu")
    before = [p.detach().clone() for p in model.parameters()]
    with pytest.raises(ValueError):
        step(_feed())
    assert all(torch.equal(a, p) for a, p in zip(before, model.parameters()))


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------


def _run_reference_dropout(x, p, is_test, impl):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        xv = fluid.layers.data(name="x", shape=list(x.shape[1:]),
                               dtype="float32")
        out = fluid.layers.dropout(xv, p, is_test=is_test,
                                   dropout_implementation=impl)
    (got,) = fluid.Executor(fluid.CPUPlace()).run(
        main, feed={"x": x}, fetch_list=[out], scope=fluid.core.Scope())
    return np.asarray(got)


@pytest.mark.parametrize("impl", ["downgrade_in_infer", "upscale_in_train"])
def test_dropout_op_semantics_match_reference(impl):
    """Test mode equals the reference's op exactly; in training both
    keep each element as it is (``downgrade_in_infer``) or scaled by
    1/(1 − p) (``upscale_in_train``) and zero the rest, at a rate near p,
    and the port's gradient is the same mask. The masks themselves come
    from different random streams."""
    p = 0.3
    x = np.random.RandomState(1).rand(64, 256).astype(np.float32) + 0.5
    tx = torch.from_numpy(x).requires_grad_()
    np.testing.assert_array_equal(
        tnn.dropout(tx, p, is_test=True,
                    dropout_implementation=impl).detach().numpy(),
        _run_reference_dropout(x, p, True, impl))
    scale = 1.0 / (1.0 - p) if impl == "upscale_in_train" else 1.0
    gen = torch.Generator().manual_seed(0)
    out = tnn.dropout(tx, p, dropout_implementation=impl, generator=gen)
    ref = _run_reference_dropout(x, p, False, impl)
    for got in (out.detach().numpy(), ref):
        kept = got != 0
        np.testing.assert_allclose(got[kept], (x * np.float32(scale))[kept],
                                   rtol=1e-6)
        assert abs(1.0 - kept.mean() - p) < 0.02
    out.sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.where(
        out.detach().numpy() != 0, np.float32(scale), 0.0), rtol=1e-6)


def test_softmax_with_cross_entropy_matches_reference():
    """Hard labels with a trailing 1, an ignored index and soft labels,
    against the reference op through a one-op program (fp32, atol 1e-6:
    one log-softmax)."""
    rs = np.random.RandomState(2)
    logits = rs.randn(3, 5, 7).astype(np.float32) * 3
    label = rs.randint(0, 7, (3, 5, 1)).astype("int64")
    label[1, 2, 0] = -100
    soft = rs.rand(3, 5, 7).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    for lab, is_soft in ((label, False), (soft, True)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            lv = fluid.layers.data(name="l", shape=[5, 7], dtype="float32")
            yv = fluid.layers.data(name="y", shape=list(lab.shape[1:]),
                                   dtype="float32" if is_soft else "int64")
            loss = fluid.layers.softmax_with_cross_entropy(
                lv, yv, soft_label=is_soft)
        (want,) = fluid.Executor(fluid.CPUPlace()).run(
            main, feed={"l": logits, "y": lab}, fetch_list=[loss],
            scope=fluid.core.Scope())
        got, sm = tmath.softmax_with_cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(lab),
            soft_label=is_soft, return_softmax=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
        np.testing.assert_allclose(sm.sum(-1).numpy(), 1.0, atol=1e-6)
    assert float(got[1, 2, 0]) != 0.0
    hard = tmath.softmax_with_cross_entropy(torch.from_numpy(logits),
                                            torch.from_numpy(label))
    assert float(hard[1, 2, 0]) == 0.0


def test_adam_matches_reference_optimizer_over_5_steps():
    """``fluid.optimizer.Adam`` on a one-parameter program against the
    port's ``Adam`` on the same loss: the parameter after each of 5
    steps. fp32, atol 1e-6: an update is lr·m/(√v + ε) of size ~lr, and
    a bias-corrected ε or a wrong β power would differ by far more."""
    rs = np.random.RandomState(4)
    x, y = rs.randn(8, 3).astype(np.float32), rs.randn(8, 2).astype(np.float32)
    w0 = rs.randn(3, 2).astype(np.float32)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        xv = fluid.layers.data(name="x", shape=[3], dtype="float32")
        yv = fluid.layers.data(name="y", shape=[2], dtype="float32")
        w = fluid.layers.create_parameter([3, 2], "float32", name="w")
        loss = fluid.layers.reduce_mean(fluid.layers.square_error_cost(
            fluid.layers.matmul(xv, w), yv))
        fluid.optimizer.Adam(learning_rate=0.05).minimize(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.core.Scope()
    with fluid.executor.scope_guard(scope):
        exe.run(startup)
    scope.set("w", w0.copy())
    tw = torch.from_numpy(w0.copy()).requires_grad_()
    opt = toptimizer.Adam(learning_rate=0.05, parameter_list=[tw])
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    for _ in range(5):
        exe.run(main, feed={"x": x, "y": y}, fetch_list=[loss], scope=scope)
        opt.minimize(((tx @ tw - ty) ** 2).mean())
        assert tw.grad is None
        np.testing.assert_allclose(tw.detach().numpy(),
                                   np.asarray(scope.get("w")), atol=1e-6)
    np.testing.assert_allclose(opt.state()["beta1_pow"].numpy(),
                               [np.float32(0.9) ** 6], rtol=1e-6)


def test_adam_op_follows_reference_rule_and_takes_none_grads():
    """The ``adam`` op against the reference's ``_adam`` formulas written
    out in fp32 numpy, for two parameters, one of them without a gradient
    (counted as zeros: its moments decay and it still moves)."""
    rs = np.random.RandomState(6)
    f32 = np.float32
    p = [rs.randn(4, 3).astype(f32), rs.randn(5).astype(f32)]
    g = [rs.randn(4, 3).astype(f32), None]
    m1 = [rs.rand(4, 3).astype(f32), rs.rand(5).astype(f32)]
    m2 = [rs.rand(4, 3).astype(f32), rs.rand(5).astype(f32)]
    b1p, b2p = f32(0.9) ** 3, f32(0.999) ** 3
    lr, b1, b2, eps = f32(0.01), f32(0.9), f32(0.999), f32(1e-8)
    want = []
    for pi, gi, a, b in zip(p, g, m1, m2):
        gi = np.zeros_like(pi) if gi is None else gi
        a = b1 * a + (1 - b1) * gi
        b = b2 * b + (1 - b2) * gi * gi
        lr_t = lr * np.sqrt(1 - b2p) / (1 - b1p)
        want.append(pi - lr_t * a / (np.sqrt(b) + eps))
    tp = [torch.from_numpy(a.copy()) for a in p]
    tm1 = [torch.from_numpy(a.copy()) for a in m1]
    tm2 = [torch.from_numpy(a.copy()) for a in m2]
    pows = (torch.full((2,), float(b1p)), torch.full((2,), float(b2p)))
    topt_ops.adam(tp, [torch.from_numpy(g[0]), None], tm1, tm2, *pows,
                  float(lr))
    for got, w in zip(tp, want):
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pows[0].numpy(), b1p * b1, rtol=1e-7)
    np.testing.assert_allclose(pows[1].numpy(), b2p * b2, rtol=1e-7)
