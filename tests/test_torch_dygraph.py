"""The port's dygraph (``paddle_tpu_torch.fluid.dygraph``: the tracer and
its tape, ``Layer``s, the eager optimizers, learning-rate schedules,
checkpoints and ``TracedLayer``) held against the JAX package on the CPU.

Each case builds the same program in both packages under
``dygraph.guard(CPUPlace())``, copies the reference's parameters into the
port (``state_dict`` -> ``set_dict``; the two draw initial values from
different random streams) and feeds both the same numpy inputs, made from
a seed. The reference's ``flash_attention`` op runs through its plain
(jnp) path on the CPU, the port's through the kernels' plain versions.
Dropout is off wherever values are compared. The BERT classifier is also
held against the port's own static program at the same weights, the
reference's dygraph-against-static method
(``tests/test_dygraph_model_parity.py``). Tolerances are stated at each
comparison: fp32 on both sides, other summation orders.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import profiler as tprofiler
from paddle_tpu_torch.fluid.ops import registry as tregistry
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.testing import dygraph_models as dm
from test_torch_cpu_math import pin_vector_math

pin_vector_math(2)  # 2 threads, vector math set up on one (see there)

BOTH = ((jfluid, "reference"), (tfluid, "port"))


@pytest.fixture(autouse=True)
def _seed_reference_init():
    """The reference's tracer keys its initial values from numpy's global
    generator: seeded, every case starts from the same weights."""
    np.random.seed(2024)


def guard(fl):
    return fl.dygraph.guard(fl.CPUPlace())


def var(fl, a, grad=False):
    v = fl.dygraph.to_variable(a)
    v.stop_gradient = not grad
    return v


def state(layer):
    return {k: v.numpy() for k, v in layer.state_dict().items()}


def grads(layer):
    return {k: v.gradient() for k, v in layer.state_dict().items()}


def scalar(v):
    return float(np.asarray(v.numpy()).reshape(-1)[0])


def close(got, want, rtol, atol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def close_dicts(got, want, rtol, atol):
    assert sorted(got) == sorted(want)
    for k in want:
        assert (got[k] is None) == (want[k] is None), k
        if want[k] is not None:
            close(got[k], want[k], rtol, atol, k)


# ---------------------------------------------------------------------------
# the four cases of tests/test_dygraph.py, port against reference
# ---------------------------------------------------------------------------
def test_forward_backward_gradient_matches_reference():
    """Linear(8, 3), mean, backward: the output and the weight's gradient
    within 1e-6."""
    x = np.random.RandomState(0).rand(4, 8).astype("float32")
    out = {}
    params = None
    for fl, side in BOTH:
        with guard(fl):
            fc = fl.dygraph.Linear(8, 3)
            if params is not None:
                fc.set_dict(params)
            params = state(fc)
            y = fc(var(fl, x))
            loss = fl.layers.mean(y)
            loss.backward()
            out[side] = (y.numpy(), fc.weight.gradient(), scalar(loss))
    for a, b in zip(out["port"], out["reference"]):
        close(a, b, 1e-6, 1e-6)
    assert out["port"][1].shape == (8, 3)


def test_layer_functions_trace_eagerly_as_reference():
    """relu then softmax called under the guard run at once: equal to the
    reference's within 1e-6, rows summing to 1."""
    x = np.random.RandomState(1).rand(2, 6).astype("float32")
    outs = []
    for fl, _side in BOTH:
        with guard(fl):
            outs.append(fl.layers.softmax(fl.layers.relu(var(fl, x)))
                        .numpy())
    close(outs[1], outs[0], 1e-6, 1e-6)
    close(outs[1].sum(-1), np.ones(2), 1e-5, 0)


def _regression(fl, square, xd, yd, params, steps=40):
    """SGD on a linear regression, squared error by ``square`` or, as
    ``tests/test_dygraph.py`` writes it, diff · diff; (losses, the first
    step's weight gradient, the initial state)."""
    with guard(fl):
        lin = fl.dygraph.Linear(8, 1)
        if params is not None:
            lin.set_dict(params)
        init = state(lin)
        opt = fl.optimizer.SGD(learning_rate=0.05,
                               parameter_list=lin.parameters())
        losses, g0 = [], None
        for _ in range(steps):
            diff = fl.layers.elementwise_sub(lin(var(fl, xd)), var(fl, yd))
            sq = fl.layers.square(diff) if square else \
                fl.layers.elementwise_mul(diff, diff)
            loss = fl.layers.mean(sq)
            loss.backward()
            if g0 is None:
                g0 = lin.weight.gradient().copy()
            opt.minimize(loss)
            lin.clear_gradients()
            losses.append(scalar(loss))
    return losses, g0, init


def _numpy_sgd(xd, yd, init, steps=40, lr=0.05):
    """The same regression's SGD in float64 numpy."""
    w = init["weight"].astype(np.float64)
    b = init["bias"].astype(np.float64)
    losses = []
    for _ in range(steps):
        d = xd @ w + b - yd
        losses.append(float((d ** 2).mean()))
        w = w - lr * 2.0 * xd.T @ d / len(xd)
        b = b - lr * 2.0 * d.mean(0)
    return losses


def test_sgd_training_matches_reference_and_converges():
    """40 SGD steps of a linear regression (squared error by ``square``):
    every step's loss within 1e-5 relative of the reference's, and the
    loss falls tenfold."""
    rs = np.random.RandomState(0)
    xd = rs.rand(32, 8).astype("float32")
    yd = xd @ rs.rand(8, 1).astype("float32")
    r_losses, _g, init = _regression(jfluid, True, xd, yd, None)
    p_losses, _g, _i = _regression(tfluid, True, xd, yd, init)
    close(p_losses, r_losses, 1e-5, 1e-7)
    assert p_losses[-1] < p_losses[0] * 0.1


def test_sgd_training_of_the_reference_test_form_is_exact_sgd():
    """``tests/test_dygraph.py``'s form, diff · diff (one VarBase given to
    both operands): the port's 40 losses within 1e-4 relative of float64
    SGD on the same regression, converging. The reference adds that op's
    gradient once per operand slot on top of a vjp that already sums both
    (``tracer.py:293-316``), so its first weight gradient is twice the
    exact one, and the port's, within 1e-5 (ROADMAP queue C)."""
    rs = np.random.RandomState(0)
    xd = rs.rand(32, 8).astype("float32")
    yd = xd @ rs.rand(8, 1).astype("float32")
    _l, r_g0, init = _regression(jfluid, False, xd, yd, None, steps=1)
    p_losses, p_g0, _i = _regression(tfluid, False, xd, yd, init)
    close(p_losses, _numpy_sgd(xd.astype(np.float64),
                               yd.astype(np.float64), init), 1e-4, 1e-7)
    assert p_losses[-1] < p_losses[0] * 0.1
    close(r_g0, 2.0 * p_g0, 1e-5, 1e-7)


def test_state_dict_set_dict_roundtrip_as_reference():
    """``state_dict`` returns the live parameters; ``set_dict`` copies
    arrays back in (a copy: the caller's array is not aliased)."""
    with guard(tfluid):
        lin = tfluid.dygraph.Linear(4, 2)
        live = lin.state_dict()
        assert sorted(live) == ["bias", "weight"]
        snap = {k: v.numpy().copy() for k, v in live.items()}
        lin.weight.set_value(np.zeros_like(snap["weight"]))
        assert not lin.weight.numpy().any()
        lin.set_dict(snap)
        np.testing.assert_array_equal(lin.weight.numpy(), snap["weight"])
        snap["weight"][:] = 7.0
        assert not (lin.weight.numpy() == 7.0).any()
    with guard(jfluid):
        assert sorted(jfluid.dygraph.Linear(4, 2).state_dict()) == \
            ["bias", "weight"]


# ---------------------------------------------------------------------------
# the Layer classes
# ---------------------------------------------------------------------------
def _f32(rs, *shape):
    return rs.standard_normal(shape).astype("float32")


def _lowered_cases():
    rs = np.random.RandomState(3)
    D = dict
    return {
        "Conv2D": (lambda fl: fl.dygraph.Conv2D(
            "c", num_filters=3, filter_size=3, padding=1, act="relu"),
            [_f32(rs, 2, 2, 6, 6)], D()),
        "Pool2D": (lambda fl: fl.dygraph.Pool2D(
            "p", pool_size=2, pool_type="max", pool_stride=2),
            [_f32(rs, 2, 3, 6, 6)], D()),
        "Linear": (lambda fl: fl.dygraph.Linear(5, 4, act="tanh"),
                   [_f32(rs, 3, 5)], D()),
        "FC": (lambda fl: fl.dygraph.FC("fc", size=4, num_flatten_dims=1,
                                        act="relu"),
               [_f32(rs, 3, 2, 3)], D()),
        "BatchNorm": (lambda fl: fl.dygraph.BatchNorm("bn", 3, act="relu"),
                      [_f32(rs, 4, 3, 5, 5)], D()),
        "Embedding": (lambda fl: fl.dygraph.Embedding(size=[10, 4]),
                      [rs.randint(0, 10, (3, 5, 1)).astype("int64")], D()),
        "LayerNorm": (lambda fl: fl.dygraph.LayerNorm("ln",
                                                      begin_norm_axis=1),
                      [_f32(rs, 3, 6)], D()),
        # at is_test: downgrade_in_infer scales by 1 - p, no random draw
        "Dropout": (lambda fl: fl.dygraph.Dropout(p=0.5), [_f32(rs, 3, 6)],
                    D(eval=True)),
        "GRUUnit": (lambda fl: fl.dygraph.GRUUnit("gru", size=12),
                    [_f32(rs, 3, 12), _f32(rs, 3, 4)], D()),
        "SequenceConv": (lambda fl: fl.dygraph.SequenceConv(
            "sc", num_filters=4, filter_size=3), [_f32(rs, 2, 5, 3)], D()),
        "RowConv": (lambda fl: fl.dygraph.RowConv("rc",
                                                  future_context_size=2),
                    [_f32(rs, 2, 5, 3)], D()),
        "PRelu": (lambda fl: fl.dygraph.PRelu("pr", mode="channel",
                                              channel=3),
                  [_f32(rs, 2, 3, 4, 4)], D()),
        "GroupNorm": (lambda fl: fl.dygraph.GroupNorm("gn", groups=2,
                                                      act="relu"),
                      [_f32(rs, 2, 4, 3, 3)], D()),
        "Conv2DTranspose": (lambda fl: fl.dygraph.Conv2DTranspose(
            "ct", num_filters=2, filter_size=3, stride=2, padding=1),
            [_f32(rs, 1, 2, 4, 4)], D()),
        "BilinearTensorProduct": (
            lambda fl: fl.dygraph.BilinearTensorProduct("btp", size=3,
                                                        act="tanh"),
            [_f32(rs, 4, 5), _f32(rs, 4, 6)], D()),
    }


LOWERED = sorted(_lowered_cases())


def _layer_run(fl, make, inputs, opts, params=None):
    """Build the layer (one call outside the tape makes lazy parameters),
    take ``params`` in, then one call: every output, the loss
    Σ mean(out · r) with fixed random r, its backward. Returns (outputs,
    state, parameter grads, input grads)."""
    with guard(fl):
        layer = make(fl)
        if opts.get("eval"):
            layer.eval()
        with fl.dygraph.no_grad():
            layer(*[var(fl, a) for a in inputs])
        if params is not None:
            layer.set_dict(params)
        before = state(layer)
        xs = [var(fl, a, grad=a.dtype == np.float32) for a in inputs]
        outs = layer(*xs)
        outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        loss = None
        for i, o in enumerate(outs):
            r = np.random.RandomState(10 + i).standard_normal(
                o.shape).astype("float32")
            t = fl.layers.mean(fl.layers.elementwise_mul(o, var(fl, r)))
            loss = t if loss is None else fl.layers.elementwise_add(loss, t)
        loss.backward()
        return ([o.numpy() for o in outs], before, state(layer),
                grads(layer), [x.gradient() for x in xs])


@pytest.mark.parametrize("name", LOWERED)
def test_lowered_layer_forward_and_gradients_match_reference(name):
    """Each Layer class whose ops the port lowers: outputs, the state
    after the call (batch norm's running statistics), every parameter's
    gradient and the float inputs' gradients within 1e-5."""
    make, inputs, opts = _lowered_cases()[name]
    r_outs, r_before, r_state, r_grads, r_xg = _layer_run(
        jfluid, make, inputs, opts)
    p_outs, _b, p_state, p_grads, p_xg = _layer_run(
        tfluid, make, inputs, opts, params=r_before)
    assert len(p_outs) == len(r_outs)
    for a, b in zip(p_outs, r_outs):
        close(a, b, 1e-5, 1e-5, name)
    close_dicts(p_state, r_state, 1e-5, 1e-5)
    close_dicts(p_grads, r_grads, 1e-5, 1e-5)
    for a, b in zip(p_xg, r_xg):
        assert (a is None) == (b is None)
        if b is not None:
            close(a, b, 1e-5, 1e-5, name + " input grad")


def _unlowered_cases():
    rs = np.random.RandomState(4)
    return {
        "Conv3D": ("conv3d", lambda fl: fl.dygraph.Conv3D(
            "c3", num_filters=2, filter_size=3), [_f32(rs, 1, 2, 4, 4, 4)]),
        "Conv3DTranspose": ("conv3d_transpose",
                            lambda fl: fl.dygraph.Conv3DTranspose(
                                "ct3", num_filters=2, filter_size=3),
                            [_f32(rs, 1, 2, 3, 3, 3)]),
        "TreeConv": ("tree_conv", lambda fl: fl.dygraph.TreeConv(
            "tc", output_size=3, num_filters=2, max_depth=2),
            [_f32(rs, 1, 5, 4),
             np.array([[[1, 2], [1, 3], [2, 4], [2, 5]]], np.int32)]),
    }


@pytest.mark.parametrize("name", sorted(_unlowered_cases()))
def test_unlowered_layer_raises_naming_its_op(name):
    """Each Layer class whose op the port does not lower yet (ROADMAP
    A16): the reference's forward gives finite values, the port's raises
    the registry's error, which names the op. (``NCE`` runs since the op
    corpus's second slice: see
    ``test_nce_cost_and_weight_gradient_of_its_own_draw``.)"""
    op_type, make, inputs = _unlowered_cases()[name]
    with guard(jfluid):
        out = make(jfluid)(*[var(jfluid, a) for a in inputs])
        assert np.isfinite(out.numpy()).all()
    with guard(tfluid):
        layer = make(tfluid)
        with pytest.raises(NotImplementedError, match="'%s'" % op_type):
            layer(*[var(tfluid, a) for a in inputs])


@pytest.mark.parametrize("sampler", ["uniform", "log_uniform",
                                     "custom_dist"])
def test_nce_cost_and_weight_gradient_of_its_own_draw(sampler,
                                                      monkeypatch):
    """``NCE`` (its ``nce`` op lowered since the op corpus's second
    slice): the cost [4, 1] of the negatives it drew (``nce_samples``,
    recorded) equals the reference's formula in float64 numpy within
    1e-5, and after ``backward`` the weight's gradient equals that
    formula's derivative within 1e-4. The reference's draws come from
    other keys, so the port is held to the formula, not to its values."""
    from paddle_tpu_torch.fluid.ops import loss_ops

    drawn = []
    real = loss_ops.nce_samples

    def record(*args, **kwargs):
        drawn.append(real(*args, **kwargs))
        return drawn[-1]

    monkeypatch.setattr(loss_ops, "nce_samples", record)
    rs = np.random.RandomState(4)
    n, dim, k = 10, 6, 3
    x, label = _f32(rs, 4, dim), rs.randint(0, n, (4, 1)).astype("int64")
    dist = np.arange(1.0, n + 1) / np.arange(1.0, n + 1).sum()
    with guard(tfluid):
        layer = tfluid.dygraph.NCE(
            "nce", num_total_classes=n, num_neg_samples=k, sampler=sampler,
            custom_dist=dist if sampler == "custom_dist" else None)
        cost = layer(var(tfluid, x), var(tfluid, label))
        tfluid.layers.reduce_sum(cost).backward()
        w, b = layer.weight.numpy(), layer.bias.numpy().reshape(-1)
        gw = layer.weight.gradient()
        got = cost.numpy()
    (samples,) = [d.numpy() for d in drawn]
    assert got.shape == (4, 1) and samples.shape == (4, k)
    assert samples.min() >= 0 and samples.max() < n
    q = {"uniform": lambda ids: np.full(ids.shape, 1.0 / n),
         "log_uniform": lambda ids: np.log((ids + 2.0) / (ids + 1.0))
         / np.log(n + 1.0),
         "custom_dist": lambda ids: np.float32(dist)[ids].astype(
             np.float64)}[sampler]
    x64, w64 = x.astype(np.float64), w.astype(np.float64)
    want = np.zeros(4)
    want_gw = np.zeros_like(w64)
    for r in range(4):
        for ids, sign in ((label[r], -1.0), (samples[r], 1.0)):
            adj = w64[ids] @ x64[r] + b[ids] - np.log(k * q(ids))
            want[r] += np.log1p(np.exp(sign * adj)).sum()
            d = sign / (1.0 + np.exp(-sign * adj))
            np.add.at(want_gw, ids, d[:, None] * x64[r][None, :])
    close(got[:, 0], want, 1e-5, 1e-6, "cost")
    close(gw, want_gw, 1e-4, 1e-6, "weight grad")


def test_spectral_norm_matches_reference():
    """SpectralNorm computes on its weight outside any op, as the
    reference's does: the normalized weight within 1e-6."""
    w = _f32(np.random.RandomState(5), 4, 6)
    outs = []
    for fl, _side in BOTH:
        with guard(fl):
            outs.append(fl.dygraph.SpectralNorm("sn", dim=0, power_iters=2)(
                var(fl, w)).numpy())
    close(outs[1], outs[0], 1e-6, 1e-6)


def test_sequential_indexes_as_reference():
    """Sequential by (name, Layer) pairs and positionally."""
    with guard(tfluid):
        model = tfluid.dygraph.Sequential(
            "model", ("l1", tfluid.dygraph.Linear(10, 4)),
            ("l2", tfluid.dygraph.Linear(4, 2)))
        assert len(model) == 2 and model["l1"] is model._sub_layers["l1"]
        x = var(tfluid, np.random.RandomState(0).rand(3, 10)
                .astype("float32"))
        assert model(x).shape == (3, 2)
        del model["l2"]
        assert len(model) == 1
        m2 = tfluid.dygraph.Sequential(tfluid.dygraph.Linear(10, 4))
        assert m2[0] is m2._sub_layers["0"]


def test_layer_bookkeeping_matches_reference():
    """``named_parameters``, ``parameters``, ``sublayers``, ``state_dict``
    keys (batch norm's running statistics among them, not trainable) and
    ``train`` / ``eval`` as the reference's, on a nested model."""
    got = []
    for fl, _side in BOTH:
        with guard(fl):
            model = fl.dygraph.Sequential(
                ("conv", fl.dygraph.Conv2D("c", num_filters=2,
                                           filter_size=3)),
                ("bn", fl.dygraph.BatchNorm("bn", 2)),
                ("head", fl.dygraph.Sequential(fl.dygraph.Linear(4, 2))))
            with fl.dygraph.no_grad():
                model["conv"](var(fl, np.zeros((1, 1, 4, 4), np.float32)))
            model.eval()
            modes = [l.training for l in model.sublayers()]
            model.train()
            got.append(([n for n, _p in model.named_parameters()],
                        [tuple(p.shape) for p in model.parameters()],
                        [p.trainable for p in model.parameters()],
                        len(model.sublayers()), list(model.state_dict()),
                        modes, model["bn"].training))
    assert got[1] == got[0]
    assert got[1][5] == [False] * got[1][3] and got[1][6]


# ---------------------------------------------------------------------------
# BERT with flash attention
# ---------------------------------------------------------------------------
BERT_S, BERT_B, BERT_LR = 16, 3, 1e-2


def _bert_cfg():
    return tbert.BertConfig.tiny(
        vocab_size=97, hidden_size=32, num_heads=4, intermediate_size=64,
        num_layers=2, max_position_embeddings=BERT_S, hidden_dropout=0.0,
        attention_dropout=0.0, use_flash_attention=True)


def _bert_feeds(steps):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(steps):
        lens = rng.integers(BERT_S // 2, BERT_S + 1, BERT_B)
        mask = np.zeros((BERT_B, BERT_S, 1), np.float32)
        sent = np.zeros((BERT_B, BERT_S, 1), np.int64)
        for i, n in enumerate(lens):
            mask[i, :n] = 1.0
            sent[i, n // 2:] = 1
        out.append({
            "src_ids": rng.integers(0, 97, (BERT_B, BERT_S, 1)),
            "pos_ids": np.tile(np.arange(BERT_S).reshape(1, BERT_S, 1),
                               (BERT_B, 1, 1)),
            "sent_ids": sent, "input_mask": mask,
            "label": rng.integers(0, 2, (BERT_B, 1))})
    return out


BERT_FEEDS = ("src_ids", "pos_ids", "sent_ids", "input_mask", "label")


def _bert_dygraph(fl, feeds, params=None):
    """3 Adam steps of the dygraph classifier: (initial state, losses,
    every parameter's gradient at each step)."""
    with guard(fl):
        model = dm.make_bert_classifier(fl, _bert_cfg(), BERT_S)
        if params is not None:
            model.set_dict(params)
        init = state(model)
        opt = fl.optimizer.Adam(learning_rate=BERT_LR,
                                parameter_list=model.parameters())
        losses, step_grads = [], []
        for feed in feeds:
            loss = model(*[var(fl, feed[n]) for n in BERT_FEEDS])
            loss.backward()
            step_grads.append(grads(model))
            opt.minimize(loss)
            model.clear_gradients()
            losses.append(scalar(loss))
    return init, losses, step_grads


@pytest.fixture(scope="module")
def bert_runs():
    feeds = _bert_feeds(3)
    ref = _bert_dygraph(jfluid, feeds)
    return feeds, ref


def _counting_flash(monkeypatch):
    """Count the plain flash forward and backward calls (the CPU's
    stand-ins for the kernels' launches)."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = tfa.flash_attention_lse_plain, tfa.flash_attention_bwd_plain

    def count_fwd(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    def count_bwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)

    monkeypatch.setattr(tfa, "flash_attention_lse_plain", count_fwd)
    monkeypatch.setattr(tfa, "flash_attention_bwd_plain", count_bwd)
    return calls


def test_bert_dygraph_adam_steps_match_reference(bert_runs, monkeypatch):
    """The tiny BERT classifier (2 layers, hidden 32, seq 16) with flash
    attention and the key bias, 3 Adam steps: every loss within 1e-5
    relative and every parameter's gradient at every step within 1e-5 of
    the reference's; one flash forward and one backward a layer a step,
    no generic replay."""
    feeds, (r_init, r_losses, r_grads) = bert_runs
    calls = _counting_flash(monkeypatch)
    replays0 = tprofiler.get_counter(tregistry.REPLAY_COUNTER)
    _init, p_losses, p_grads = _bert_dygraph(tfluid, feeds, params=r_init)
    assert tprofiler.get_counter(tregistry.REPLAY_COUNTER) == replays0
    assert calls == {"fwd": 2 * 3, "bwd": 2 * 3}
    close(p_losses, r_losses, 1e-5, 1e-6)
    for got, want in zip(p_grads, r_grads):
        close_dicts(got, want, 1e-4, 2e-6)


def test_bert_dygraph_matches_the_static_program(bert_runs):
    """The same classifier against the port's static
    ``build_bert_classifier`` program at the same weights (copied by
    ``bert_static_names``): 3 Adam steps, every loss within 1e-5 relative
    and every step's gradients within 1e-5 (``Linear``'s ``matmul``
    against ``fc``'s ``mul``: the same products in other orders)."""
    feeds, _ref = bert_runs
    cfg = _bert_cfg()
    with tfluid.unique_name.guard():
        main, startup, _f, loss, _acc = tbert.build_bert_classifier(
            cfg, BERT_S, learning_rate=BERT_LR)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    names = dm.bert_static_names(cfg)
    init = {names[n]: scope.get(n).numpy().copy() for n in names}
    s_losses, s_grads = [], []
    for feed in feeds:
        out = exe.run(main, feed=feed, fetch_list=[loss] + [
            n + "@GRAD" for n in names], scope=scope)
        s_losses.append(float(out[0].reshape(-1)[0]))
        s_grads.append({names[n]: g for n, g in zip(names, out[1:])})
    _i, d_losses, d_grads = _bert_dygraph(tfluid, feeds, params=init)
    close(d_losses, s_losses, 1e-5, 1e-6)
    for got, want in zip(d_grads, s_grads):
        close_dicts(got, want, 1e-4, 2e-6)


# ---------------------------------------------------------------------------
# the parity file's models, small: MNIST, ResNet-18 (narrow), PTB LSTM
# ---------------------------------------------------------------------------
def _train(fl, model, opt_fn, batches, loss_fn, params=None, build=None):
    if build is not None:
        with fl.dygraph.no_grad():
            model(var(fl, build))
    if params is not None:
        model.set_dict(params)
    init = state(model)
    opt = opt_fn(fl, model.parameters())
    losses, first = [], None
    for batch in batches:
        loss = loss_fn(fl, model, batch)
        loss.backward()
        if first is None:
            first = grads(model)
        opt.minimize(loss)
        model.clear_gradients()
        losses.append(scalar(loss))
    return init, losses, first, state(model)


def _xent(fl, logits, labels):
    return fl.layers.mean(fl.layers.softmax_with_cross_entropy(
        logits, var(fl, labels)))


def _image_loss(fl, model, batch):
    return _xent(fl, model(var(fl, batch[0])), batch[1])


PTB_V, PTB_E, PTB_H, PTB_T, PTB_B = 30, 12, 12, 6, 4


def _ptb_loss(fl, model, batch):
    toks, labs = batch
    steps = model(var(fl, toks))
    total = None
    for t, logits in enumerate(steps):
        term = _xent(fl, logits, labs[:, t, :])
        total = term if total is None else fl.layers.elementwise_add(total,
                                                                     term)
    return fl.layers.scale(total, scale=1.0 / len(steps))


def _ptb_stack_loss(fl, model, batch):
    """The reference parity file's PTB loss: the mean of the ``stack`` of
    the steps' mean losses."""
    toks, labs = batch
    terms = [_xent(fl, logits, labs[:, t, :])
             for t, logits in enumerate(model(var(fl, toks)))]
    return fl.layers.mean(fl.layers.stack(terms))


def _model_case(name):
    rs = np.random.RandomState(6)
    if name == "mnist":
        batches = [(rs.rand(8, 1, 12, 12).astype("float32"),
                    rs.randint(0, 10, (8, 1)).astype("int64"))
                   for _ in range(4)]
        return (dm.make_mnist, lambda fl, ps: fl.optimizer.SGD(
            learning_rate=0.1, parameter_list=ps), batches, _image_loss,
            batches[0][0])
    if name == "resnet18":
        img = rs.rand(8, 3, 16, 16).astype("float32")
        lab = rs.randint(0, 5, (8, 1)).astype("int64")
        return (dm.make_resnet, lambda fl, ps: fl.optimizer.Momentum(
            learning_rate=0.05, momentum=0.9, parameter_list=ps),
            [(img, lab)] * 2, _image_loss, img)
    batches = [(rs.randint(0, PTB_V, (PTB_B, PTB_T)).astype("int64"),
                rs.randint(0, PTB_V, (PTB_B, PTB_T, 1)).astype("int64"))
               for _ in range(4)]
    return (lambda fl: dm.make_ptb(fl, PTB_V, PTB_E, PTB_H, PTB_T),
            lambda fl, ps: fl.optimizer.SGD(learning_rate=0.2,
                                            parameter_list=ps),
            batches, _ptb_stack_loss if name == "ptb_lstm_stack"
            else _ptb_loss, None)


@pytest.mark.parametrize("name", ["mnist", "resnet18", "ptb_lstm",
                                  "ptb_lstm_stack"])
def test_parity_models_train_as_reference(name):
    """Small versions of the reference's dygraph parity models (MNIST
    convnet with SGD, a narrow ResNet-18 with batch norm and Momentum, the
    PTB LSTM LM with SGD, its loss also in the parity file's form, the
    mean of the ``stack`` of the steps' losses), port against reference
    from the same weights:
    every step's loss within 1e-4 relative, the first step's gradients
    within 1e-4 and the final state (parameters and running statistics)
    within 1e-4; no generic replay in the port."""
    make, opt_fn, batches, loss_fn, build = _model_case(name)
    with guard(jfluid):
        r_init, r_losses, r_first, r_final = _train(
            jfluid, make(jfluid), opt_fn, batches, loss_fn, build=build)
    replays0 = tprofiler.get_counter(tregistry.REPLAY_COUNTER)
    with guard(tfluid):
        _i, p_losses, p_first, p_final = _train(
            tfluid, make(tfluid), opt_fn, batches, loss_fn, params=r_init,
            build=build)
    assert tprofiler.get_counter(tregistry.REPLAY_COUNTER) == replays0
    close(p_losses, r_losses, 1e-4, 1e-6)
    close_dicts(p_first, r_first, 1e-4, 1e-5)
    close_dicts(p_final, r_final, 1e-4, 1e-5)


# ---------------------------------------------------------------------------
# the tape's semantics
# ---------------------------------------------------------------------------
def _two_consumer_grads(fl, sorted_sum, xv):
    with guard(fl):
        lin = fl.dygraph.Linear(6, 3)
        lin.weight.set_value(np.ones((6, 3), np.float32) * 0.1)
        lin.bias.set_value(np.zeros((3,), np.float32))
        h = lin(var(fl, xv))
        # two consumers of h: its gradient sums two contributions
        loss = fl.layers.reduce_sum(h) + fl.layers.reduce_sum(
            fl.layers.square(h))
        strategy = fl.dygraph.BackwardStrategy()
        strategy.sorted_sum_gradient = sorted_sum
        loss.backward(strategy)
        return lin.weight.gradient(), h.gradient()


@pytest.mark.parametrize("sorted_sum", [False, True])
def test_sorted_sum_gradient_matches_reference(sorted_sum):
    """``BackwardStrategy.sorted_sum_gradient``: the weight's and the
    shared activation's gradients within 1e-6 of the reference's under
    the same strategy."""
    xv = np.random.RandomState(3).rand(4, 6).astype("float32")
    got = _two_consumer_grads(tfluid, sorted_sum, xv)
    want = _two_consumer_grads(jfluid, sorted_sum, xv)
    for a, b in zip(got, want):
        close(a, b, 1e-6, 1e-6)


def test_no_grad_traces_nothing_for_the_backward():
    """Under ``no_grad`` (context or decorator) the values equal the
    reference's and nothing reaches the parameters; outside it they
    do."""
    x = np.random.RandomState(4).rand(3, 5).astype("float32")
    outs = []
    for fl, _side in BOTH:
        with guard(fl):
            lin = fl.dygraph.Linear(5, 2)
            if outs:
                lin.set_dict(outs[0][1])
            with fl.dygraph.no_grad():
                y = lin(var(fl, x))
            fl.layers.mean(y).backward()
            assert lin.weight.gradient() is None
            y2 = fl.dygraph.no_grad(lambda v: lin(v))(var(fl, x))
            fl.layers.mean(y2).backward()
            assert lin.weight.gradient() is None
            fl.layers.mean(lin(var(fl, x))).backward()
            assert lin.weight.gradient() is not None
            outs.append((y.numpy(), state(lin), lin.weight.gradient()))
    close(outs[1][0], outs[0][0], 1e-6, 1e-6)
    close(outs[1][2], outs[0][2], 1e-6, 1e-6)
    with guard(tfluid):
        assert tfluid.dygraph.to_variable(x).stop_gradient


def test_dygraph_grad_matches_reference():
    """``dygraph.grad(loss, [w, h])``: the gradients of a parameter and
    an activation within 1e-6 of the reference's; the parameter's
    ``_grad`` slot is left untouched (the reference's grad runs
    ``backward()`` and returns the accumulated slot)."""
    x = np.random.RandomState(5).rand(3, 4).astype("float32")
    got, want = None, None
    for fl, side in BOTH:
        with guard(fl):
            lin = fl.dygraph.Linear(4, 3)
            if want is not None:
                lin.set_dict(want[2])
            h = fl.layers.tanh(lin(var(fl, x)))
            loss = fl.layers.mean(fl.layers.square(h))
            gw, gh = fl.dygraph.grad(loss, [lin.weight, h])
            res = (np.asarray(gw.numpy() if hasattr(gw, "numpy") else gw),
                   np.asarray(gh.numpy() if hasattr(gh, "numpy") else gh),
                   state(lin))
            if side == "port":
                got = res
                assert lin.weight.gradient() is None
                with pytest.raises(ValueError, match="allow_unused"):
                    tfluid.dygraph.grad(fl.layers.mean(h), [lin.bias])
            else:
                want = res
    close(got[0], want[0], 1e-6, 1e-6)
    close(got[1], want[1], 1e-6, 1e-6)


def test_gradients_accumulate_across_backward_calls():
    """Two ``backward()`` calls without ``clear_gradients``: the slot
    holds the sum (twice one call's), as the reference's; cleared, one
    call's again."""
    x = np.random.RandomState(6).rand(4, 3).astype("float32")
    res = []
    for fl, _side in BOTH:
        with guard(fl):
            lin = fl.dygraph.Linear(3, 2)
            if res:
                lin.set_dict(res[0][2])
            fl.layers.mean(lin(var(fl, x))).backward()
            one = lin.weight.gradient().copy()
            fl.layers.mean(lin(var(fl, x))).backward()
            two = lin.weight.gradient()
            close(two, 2 * one, 1e-6, 1e-7)
            lin.clear_gradients()
            assert lin.weight.gradient() is None
            res.append((one, two, state(lin)))
    close(res[1][1], res[0][1], 1e-6, 1e-6)


def test_same_input_twice_gets_both_gradients():
    """x·x and x + x: each occurrence of the input is its own operand, so
    the gradient is 2x and 2 (the tape names each occurrence apart)."""
    xv = np.random.RandomState(7).rand(2, 3).astype("float32")
    with guard(tfluid):
        x = var(tfluid, xv, grad=True)
        tfluid.layers.reduce_sum(tfluid.layers.elementwise_mul(x, x)) \
            .backward()
        close(x.gradient(), 2 * xv, 1e-6, 1e-7)
        x.clear_gradient()
        tfluid.layers.reduce_sum(x + x).backward()
        close(x.gradient(), np.full_like(xv, 2.0), 1e-6, 0)


def test_tape_frees_activations_no_pullback_reads():
    """The tape holds ``VarBase``s by weak reference: an activation the
    program drops, and that no pullback saved (``elementwise_add``'s rule
    keeps only shapes), is freed before the backward, which still gives
    the reference's gradients through it (within 1e-6); an activation the
    program still holds gets its gradient."""
    import gc
    import weakref

    rs = np.random.RandomState(8)
    xv, cv = rs.rand(2, 3, 4).astype("float32")
    res = []
    for fl, side in BOTH:
        with guard(fl):
            lin = fl.dygraph.Linear(4, 4)
            if res:
                lin.set_dict(res[0][0])
            h = lin(var(fl, xv))
            a = fl.layers.elementwise_add(h, var(fl, cv))
            b = fl.layers.tanh(a)
            loss = fl.layers.mean(b)
            if side == "port":
                freed = [weakref.ref(h.value), weakref.ref(a.value)]
                del h, a
                gc.collect()
                assert [r() for r in freed] == [None, None]
            loss.backward()
            res.append((state(lin), grads(lin), b.gradient()))
    close_dicts(res[1][1], res[0][1], 1e-6, 1e-6)
    close(res[1][2], res[0][2], 1e-6, 1e-6)


# ---------------------------------------------------------------------------
# the optimizers' dygraph path
# ---------------------------------------------------------------------------
_OPTIMIZERS = {
    "SGD": lambda fl, ps, reg: fl.optimizer.SGD(
        learning_rate=0.1, regularization=reg, parameter_list=ps),
    "Momentum": lambda fl, ps, reg: fl.optimizer.Momentum(
        learning_rate=0.1, momentum=0.9, use_nesterov=True,
        regularization=reg, parameter_list=ps),
    "Adagrad": lambda fl, ps, reg: fl.optimizer.Adagrad(
        learning_rate=0.1, regularization=reg, parameter_list=ps),
    "Adam": lambda fl, ps, reg: fl.optimizer.Adam(
        learning_rate=0.05, regularization=reg, parameter_list=ps),
}


@pytest.mark.parametrize("name", sorted(_OPTIMIZERS))
def test_optimizer_dygraph_updates_match_reference(name):
    """Each optimizer's dygraph path, 4 steps on a 2-layer MLP with L2
    weight decay (global) and a per-parameter learning rate (0.5 on the
    second weight): every loss and every parameter after the last step
    within 1e-5 of the reference's; the accumulators are made once."""
    rs = np.random.RandomState(11)
    x = rs.rand(6, 5).astype("float32")
    y = rs.randint(0, 3, (6, 1)).astype("int64")
    out, params = {}, None
    for fl, side in BOTH:
        with guard(fl):
            l1 = fl.dygraph.Linear(5, 4, act="tanh")
            l2 = fl.dygraph.Linear(4, 3, param_attr=fl.ParamAttr(
                learning_rate=0.5))
            model = fl.dygraph.Sequential(l1, l2)
            if params is not None:
                model.set_dict(params)
            params = state(model)
            opt = _OPTIMIZERS[name](fl, model.parameters(),
                                    fl.regularizer.L2Decay(1e-2))
            losses = []
            for _ in range(4):
                loss = _xent(fl, model(var(fl, x)), y)
                loss.backward()
                opt.minimize(loss)
                model.clear_gradients()
                losses.append(scalar(loss))
            out[side] = (losses, state(model))
            if fl is tfluid:
                accs = sum(len(v) for v in opt._accumulators.values())
                assert accs == {"SGD": 0, "Momentum": 4, "Adagrad": 4,
                                "Adam": 16}[name]
    close(out["port"][0], out["reference"][0], 1e-5, 1e-7)
    close_dicts(out["port"][1], out["reference"][1], 1e-5, 1e-6)


def test_eager_adam_outside_the_guard_is_unchanged():
    """The eager form over raw tensors (the GPT step's) still binds at
    construction and steps outside the guard; under the guard the same
    class takes VarBases."""
    p = torch.nn.Parameter(torch.ones(3))
    opt = tfluid.optimizer.Adam(learning_rate=0.1, parameter_list=[p])
    assert opt._params is not None
    opt.minimize((p * p).sum())
    assert p.grad is None and float(p.detach()[0]) < 1.0


# ---------------------------------------------------------------------------
# learning-rate schedules, TracedLayer, checkpoints
# ---------------------------------------------------------------------------
_SCHEDULES = {
    "PiecewiseDecay": lambda d: d.PiecewiseDecay([3, 6], [0.1, 0.05, 0.01],
                                                 begin=0),
    "NaturalExpDecay": lambda d: d.NaturalExpDecay(0.1, 2, 0.5,
                                                   staircase=True),
    "ExponentialDecay": lambda d: d.ExponentialDecay(0.1, 3, 0.9),
    "InverseTimeDecay": lambda d: d.InverseTimeDecay(0.1, 2, 0.5),
    "PolynomialDecay": lambda d: d.PolynomialDecay(0.1, 5, 0.001,
                                                   power=2.0),
    "PolynomialDecay_cycle": lambda d: d.PolynomialDecay(
        0.1, 4, 0.001, cycle=True),
    "CosineDecay": lambda d: d.CosineDecay(0.1, 2, 5),
    "NoamDecay": lambda d: d.NoamDecay(64, 4),
}


@pytest.mark.parametrize("name", sorted(_SCHEDULES))
def test_learning_rate_schedule_steps_as_reference(name):
    """Each dygraph schedule, 12 calls: the port's learning rates equal
    the reference's (host floats, within 1e-12)."""
    make = _SCHEDULES[name]
    got = make(tfluid.dygraph)
    want = make(jfluid.dygraph)
    close([got() for _ in range(12)], [want() for _ in range(12)], 1e-12, 0)


def test_optimizer_steps_a_schedule_once_a_minimize():
    """SGD with a ``PiecewiseDecay``: the parameter moves by each step's
    rate times the gradient (one schedule step a ``minimize``)."""
    with guard(tfluid):
        lin = tfluid.dygraph.Linear(2, 1)
        lin.weight.set_value(np.zeros((2, 1), np.float32))
        sched = tfluid.dygraph.PiecewiseDecay([2], [0.5, 0.1], begin=0)
        opt = tfluid.optimizer.SGD(learning_rate=sched,
                                   parameter_list=lin.parameters())
        x = np.ones((1, 2), np.float32)
        w = []
        for _ in range(4):
            loss = tfluid.layers.reduce_sum(lin(var(tfluid, x)))
            loss.backward()
            opt.minimize(loss)
            lin.clear_gradients()
            w.append(float(lin.weight.numpy()[0, 0]))
    close(w, [-0.5, -1.0, -1.1, -1.2], 1e-6, 1e-7)


def test_traced_layer_returns_the_reference_values():
    """``TracedLayer.trace`` and a call of the traced layer: detached
    outputs equal to the reference's within 1e-6;
    ``save_inference_model`` raises as the reference's does."""
    x = np.random.RandomState(8).rand(3, 4).astype("float32")
    outs, params = [], None
    for fl, _side in BOTH:
        with guard(fl):
            lin = fl.dygraph.Linear(4, 2, act="relu")
            if params is not None:
                lin.set_dict(params)
            params = state(lin)
            first, traced = fl.dygraph.TracedLayer.trace(lin, [var(fl, x)])
            again = traced(var(fl, x))
            outs.append((first.numpy(), again.numpy()))
            if fl is tfluid:
                assert again.stop_gradient
                with pytest.raises(NotImplementedError):
                    traced.save_inference_model("/nonexistent")
    for a, b in zip(outs[1], outs[0]):
        close(a, b, 1e-6, 1e-6)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoints_load_across_packages(writer, tmp_path):
    """``save_dygraph`` of a layer's state (``.pdparams``) and of a dict
    holding a non-parameter (``.pdopt``) by one package;
    ``load_dygraph`` by the other gives the same arrays, and ``set_dict``
    of them restores the layer."""
    src, dst = (tfluid, jfluid) if writer == "port" else (jfluid, tfluid)
    path = str(tmp_path / "ckpt" / "model")
    with guard(src):
        lin = src.dygraph.Linear(3, 2)
        saved = state(lin)
        src.dygraph.save_dygraph(lin.state_dict(), path)
        moment = src.dygraph.to_variable(np.arange(6, dtype=np.float32))
        src.dygraph.save_dygraph({"moment": moment}, path)
    params, opt_state = dst.dygraph.load_dygraph(path)
    assert sorted(params) == sorted(saved)
    for k in saved:
        np.testing.assert_array_equal(params[k], saved[k])
    np.testing.assert_array_equal(opt_state["moment"],
                                  np.arange(6, dtype=np.float32))
    with guard(dst):
        lin2 = dst.dygraph.Linear(3, 2)
        lin2.set_dict(params)
        for k, v in state(lin2).items():
            np.testing.assert_array_equal(v, saved[k])
    assert tfluid.save_dygraph is tfluid.dygraph.save_dygraph
    assert tfluid.load_dygraph is tfluid.dygraph.load_dygraph


def test_in_place_update_is_outside_autograd():
    """An update between a forward and its backward changes the parameter
    the backward's pullback saved: autograd's version check refuses it
    rather than give a stale gradient; after the backward, updates and
    the next step run."""
    x = np.random.RandomState(9).rand(2, 3).astype("float32")
    with guard(tfluid):
        lin = tfluid.dygraph.Linear(3, 3)
        opt = tfluid.optimizer.SGD(learning_rate=0.1,
                                   parameter_list=lin.parameters())
        loss = tfluid.layers.mean(lin(var(tfluid, x)))
        loss.backward()
        opt.minimize(loss)
        assert not lin.weight.value.requires_grad
        # x's gradient reads the weight
        loss2 = tfluid.layers.mean(lin(var(tfluid, x, grad=True)))
        lin.weight.value.add_(1.0)
        with pytest.raises(RuntimeError, match="inplace"):
            loss2.backward()


def test_static_arithmetic_under_the_guard_raises():
    """A static Variable's operators under the guard raise
    (``_error_if_dygraph``)."""
    main = tfluid.Program()
    with tfluid.program_guard(main):
        v = tfluid.layers.data(name="v", shape=[2], dtype="float32")
    with guard(tfluid):
        assert tfluid.in_dygraph_mode()
        with pytest.raises(RuntimeError, match="dygraph mode"):
            v + 1.0
    assert not tfluid.in_dygraph_mode()
    assert isinstance(v * 2.0, tfluid.framework.Variable)


def test_enable_and_disable_dygraph_switch_the_mode():
    """``enable_dygraph(place)`` / ``disable_dygraph`` enter and leave
    dygraph mode without a ``with``; values land on the place's device.
    (``guard()`` with no place is the card: ``test_torch_import.py``.)"""
    tfluid.dygraph.enable_dygraph(tfluid.CPUPlace())
    try:
        assert tfluid.dygraph.enabled()
        v = tfluid.dygraph.to_variable(np.ones(2, np.float32))
        assert v.value.device.type == "cpu"
    finally:
        tfluid.dygraph.disable_dygraph()
    assert not tfluid.dygraph.enabled()
