"""The optimizers of the port's first A16 slice held against the JAX
package on the CPU: ``LarsMomentumOptimizer``, ``AdamaxOptimizer``,
``DpsgdOptimizer``, ``DecayedAdagradOptimizer``, ``AdadeltaOptimizer``,
``RMSPropOptimizer``, ``FtrlOptimizer``, ``LambOptimizer``,
``DGCMomentumOptimizer``, ``ModelAverage``, ``LookaheadOptimizer``,
``ExponentialMovingAverage`` and ``GradientMergeOptimizer``.

Each program is built in both packages under a fresh
``unique_name.guard()``; the reference's startup scope (parameters,
accumulators, the learning rate) goes into the port's with
``load_program_scope``, and every persistable is compared after each
step. DGC's data-parallel form runs on 2 gloo ranks
(``paddle_tpu_torch.testing.world``) against one process on the whole
batch. The dygraph forms run under each package's guard from the same
weights. A tiny BERT under Lamb (``testing.bert_lamb``) is held to the
reference's program. Tolerances are stated at each comparison.
"""

import os

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import profiler as tprofiler
from paddle_tpu_torch.fluid.ops import registry as tregistry
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.testing import bert_lamb
from paddle_tpu_torch.testing import world as tworld
from test_torch_cpu_math import pin_vector_math

pin_vector_math(2)  # 2 threads, vector math set up on one (see there)

HERE = os.path.abspath(__file__)


def _batch(step, n=16):
    rs = np.random.RandomState(100 + step)
    x = rs.standard_normal((n, 8)).astype(np.float32)
    y = rs.randint(0, 3, (n, 1)).astype(np.int64)
    return {"x": x, "y": y}


def build_mlp(fl, make_opt, minimize=None):
    """fc(8 -> 16, relu) -> fc(-> 3) -> softmax cross entropy, averaged;
    the optimizer from ``make_opt(fl)`` (``minimize(opt, loss)`` when
    given, else ``opt.minimize(loss)``)."""
    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = 31
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        x = fl.layers.data("x", [8], dtype="float32")
        y = fl.layers.data("y", [1], dtype="int64")
        h = fl.layers.fc(x, 16, act="relu")
        logits = fl.layers.fc(h, 3)
        loss = fl.layers.mean(fl.layers.softmax_with_cross_entropy(logits, y))
        opt = make_opt(fl)
        if minimize is None:
            opt.minimize(loss)
        else:
            minimize(opt, loss)
    return main, startup, loss, opt


def _persistables(main):
    return sorted(v.name for v in main.list_vars() if v.persistable
                  and not v.name.startswith(("feed", "fetch")))


def _state(fl, main, scope):
    out = {}
    for n in _persistables(main):
        v = scope.get(n) if fl is tfluid else scope.get(n)
        if v is not None:
            out[n] = np.array(np.asarray(v if fl is jfluid else v.numpy()),
                              dtype=np.float64)
    return out


def run_both(make_opt, steps=3, minimize=None, batches=None):
    """(reference states, port states, reference losses, port losses)
    after each step, both from the reference's startup scope."""
    batches = batches or [_batch(s) for s in range(steps)]
    main, startup, loss, _o = build_mlp(jfluid, make_opt, minimize)
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.core.Scope()
    exe.run(startup, scope=scope)
    arrays = {n: np.array(scope.get(n)) for n in _persistables(main)}
    ref, ref_losses = [], []
    for b in batches:
        (lv,) = exe.run(main, feed=b, fetch_list=[loss], scope=scope)
        ref_losses.append(float(np.asarray(lv).reshape(-1)[0]))
        ref.append(_state(jfluid, main, scope))
    main, startup, loss, _o = build_mlp(tfluid, make_opt, minimize)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    assert sorted(arrays) == _persistables(main)
    tfluid.load_program_scope(main, scope, arrays)
    port, port_losses = [], []
    replays = tprofiler.get_counter(tregistry.REPLAY_COUNTER)
    for b in batches:
        (lv,) = exe.run(main, feed=b, fetch_list=[loss], scope=scope)
        port_losses.append(float(np.asarray(lv).reshape(-1)[0]))
        port.append(_state(tfluid, main, scope))
    assert tprofiler.get_counter(tregistry.REPLAY_COUNTER) == replays
    return ref, port, ref_losses, port_losses


def assert_states(ref, port, rtol=1e-5, atol=1e-6):
    for step, (r, p) in enumerate(zip(ref, port)):
        assert sorted(r) == sorted(p)
        for n in r:
            np.testing.assert_allclose(p[n], r[n], rtol=rtol, atol=atol,
                                       err_msg="step %d %s" % (step + 1, n))


OPTIMIZERS = {
    "lars_momentum": lambda fl: fl.optimizer.LarsMomentumOptimizer(
        0.1, 0.9, lars_coeff=0.01, lars_weight_decay=0.001),
    "adamax": lambda fl: fl.optimizer.Adamax(0.05, beta1=0.8, beta2=0.99),
    "dpsgd": lambda fl: fl.optimizer.Dpsgd(0.1, clip=0.5, batch_size=2.0,
                                           sigma=0.0),
    "decayed_adagrad": lambda fl: fl.optimizer.DecayedAdagrad(0.05,
                                                              decay=0.9),
    "adadelta": lambda fl: fl.optimizer.Adadelta(1.0, rho=0.9),
    "rmsprop": lambda fl: fl.optimizer.RMSProp(0.01, momentum=0.5),
    "rmsprop_centered": lambda fl: fl.optimizer.RMSPropOptimizer(
        0.01, rho=0.9, momentum=0.2, centered=True),
    "ftrl": lambda fl: fl.optimizer.Ftrl(0.1, l1=0.001, l2=0.01),
    "lamb": lambda fl: fl.optimizer.Lamb(0.02, lamb_weight_decay=0.05),
    "lamb_exclude": lambda fl: fl.optimizer.LambOptimizer(
        0.02, lamb_weight_decay=0.05,
        exclude_from_weight_decay_fn=lambda p: p.name.endswith(".b_0")),
    "dgc": lambda fl: fl.optimizer.DGCMomentumOptimizer(
        0.1, 0.9, rampup_begin_step=2, sparsity=[0.75]),
    "dgc_nesterov_clip": lambda fl: fl.optimizer.DGCMomentumOptimizer(
        0.1, 0.9, rampup_begin_step=1, sparsity=[0.5], use_nesterov=True,
        local_grad_clip_norm=0.5),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_reference_over_three_steps(name):
    """Every persistable (parameters and accumulators) within 1e-5
    relative (1e-6 absolute) after each of 3 steps, and the losses; no
    generic grad replayed. DGC's rampup puts both of its branches in the
    3 steps; Dpsgd runs at σ = 0, its exact update (its noise is held to
    its scale in ``test_torch_op_corpus.py``)."""
    ref, port, rl, pl = run_both(OPTIMIZERS[name])
    assert_states(ref, port)
    np.testing.assert_allclose(pl, rl, rtol=1e-5)


def test_lamb_exclude_fn_sets_the_ops_weight_decay():
    """``exclude_from_weight_decay_fn`` true for a parameter gives its
    ``lamb`` op a weight decay of 0, as the reference's desc has it."""
    for fl in (jfluid, tfluid):
        main = build_mlp(fl, OPTIMIZERS["lamb_exclude"])[0]
        wd = {o.input("Param")[0]: o.attr("weight_decay")
              for o in main.global_block().ops if o.type == "lamb"}
        assert wd == {"fc_0.b_0": 0.0, "fc_0.w_0": 0.05, "fc_1.b_0": 0.0,
                      "fc_1.w_0": 0.05}


def _lookahead(fl):
    return fl.optimizer.LookaheadOptimizer(fl.optimizer.SGD(0.1), alpha=0.4,
                                           k=2)


def _gradient_merge(fl):
    return fl.optimizer.GradientMergeOptimizer(fl.optimizer.SGD(0.1),
                                               k_steps=2)


@pytest.mark.parametrize("name,make,steps", [
    ("lookahead", _lookahead, 5), ("gradient_merge", _gradient_merge, 4)],
    ids=["lookahead", "gradient_merge"])
def test_wrapping_optimizer_matches_reference(name, make, steps):
    """Lookahead (k = 2: the slow weights sync on steps 2 and 4) over 5
    steps and GradientMerge (k = 2: the merged update on steps 2 and 4,
    in a ``Switch`` case) over 4: every persistable after each step
    within 1e-5 relative."""
    ref, port, rl, pl = run_both(make, steps=steps)
    assert_states(ref, port)
    np.testing.assert_allclose(pl, rl, rtol=1e-5)
    if name == "gradient_merge":
        w = [s["fc_1.w_0"] for s in port]
        np.testing.assert_array_equal(w[0], w[0] * 0 + ref[0]["fc_1.w_0"])
        assert not np.array_equal(w[1], w[0])  # the update on step 2
        np.testing.assert_array_equal(w[2], w[1])  # none on step 3


def test_ema_apply_and_restore_match_reference():
    """``ExponentialMovingAverage.update()`` after Adam: shadows within
    1e-5 of the reference's after 3 steps; inside ``apply`` the global
    scope's parameters are the bias-corrected shadows and a run there
    gives the reference's loss; ``restore`` brings the training values
    back bit for bit."""
    emas = {}

    def minimize(opt, loss):
        opt.minimize(loss)
        fl = jfluid if isinstance(opt, jfluid.optimizer.Adam) else tfluid
        emas[fl] = fl.optimizer.ExponentialMovingAverage(0.9)
        emas[fl].update()

    make = lambda fl: fl.optimizer.Adam(0.05)  # noqa: E731
    out = {}
    for fl in (jfluid, tfluid):
        main, startup, loss, _o = build_mlp(fl, make, minimize)
        exe = fl.Executor(fl.CPUPlace())
        scope = fl.global_scope()
        if fl is jfluid:
            exe.run(startup)
            arrays = {n: np.array(scope.get(n)) for n in _persistables(main)}
        else:
            exe.run(startup)
            tfluid.load_program_scope(main, scope, arrays)
        for s in range(3):
            exe.run(main, feed=_batch(s), fetch_list=[loss])
        trained = _state(fl, main, scope)
        test_prog = main.clone(for_test=True)
        with emas[fl].apply(exe):
            applied = _state(fl, main, scope)
            (lv,) = exe.run(test_prog, feed=_batch(9), fetch_list=[loss])
        out[fl] = (trained, applied, float(np.asarray(lv).reshape(-1)[0]),
                   _state(fl, main, scope))
    (rt, ra, rl, rr), (pt, pa, pl, pr) = out[jfluid], out[tfluid]
    assert_states([rt, ra], [pt, pa])
    np.testing.assert_allclose(pl, rl, rtol=1e-5)
    for n in pt:
        np.testing.assert_array_equal(pr[n], pt[n])
    assert not np.allclose(pa["fc_0.w_0"], pt["fc_0.w_0"])


def test_model_average_apply_raises_as_reference():
    """``ModelAverage``: both packages take the window settings and raise
    ``NotImplementedError`` from ``apply``."""
    for fl in (jfluid, tfluid):
        ma = fl.optimizer.ModelAverage(0.15, min_average_window=2,
                                       max_average_window=4)
        assert ma.average_window == 0.15
        with pytest.raises(NotImplementedError, match="trainer loop"):
            ma.apply(fl.Executor(fl.CPUPlace()))


def test_optimizer_exports_every_reference_name_but_pipeline():
    want = set(jfluid.optimizer.__all__) - {"PipelineOptimizer"}
    assert want <= set(tfluid.optimizer.__all__)
    for n in want:
        assert hasattr(tfluid.optimizer, n), n


# ---------------------------------------------------------------------------
# DGC: the reference's tests/test_dgc.py cases, and data parallel
# ---------------------------------------------------------------------------
def _dgc_build(fl, make):
    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = 11
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        x = fl.layers.data(name="x", shape=[10], dtype="float32")
        y = fl.layers.data(name="y", shape=[1], dtype="float32")
        pred = fl.layers.fc(input=x, size=1)
        loss = fl.layers.mean(fl.layers.square_error_cost(pred, y))
        make(fl).minimize(loss, startup_program=startup)
    return main, startup, loss


def _dgc_batch(step, rs=None):
    rs = rs or np.random.RandomState(step)
    xb = rs.rand(16, 10).astype("float32")
    return {"x": xb, "y": (xb.sum(1, keepdims=True) * 0.3).astype("float32")}


def _dgc_losses(fl, make, steps=6, arrays=None, feeds=None):
    """The losses of ``steps`` runs (``test_dgc.py``'s ``_run``), and the
    startup arrays (the reference's, or ``arrays`` loaded into the
    port's scope)."""
    main, startup, loss = _dgc_build(fl, make)
    exe = fl.Executor(fl.CPUPlace())
    scope = fl.Scope() if fl is tfluid else fl.core.Scope()
    exe.run(startup, scope=scope)
    if arrays is None:
        arrays = {n: np.array(np.asarray(scope.get(n)))
                  for n in _persistables(main)}
    elif fl is tfluid:
        tfluid.load_program_scope(main, scope, {
            n: arrays[n] for n in _persistables(main)})
    rs = np.random.RandomState(0)
    feeds = feeds or [_dgc_batch(s, rs) for s in range(steps)]
    losses = [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss],
                                       scope=scope)[0]).ravel().mean())
              for f in feeds]
    return losses, arrays


DGC_CASES = {
    # name: (dgc factory, the factory it reduces to or None)
    "sparsity_zero_equals_sgd": (
        lambda fl: fl.optimizer.DGCMomentumOptimizer(
            learning_rate=0.05, momentum=0.9, rampup_begin_step=0,
            sparsity=[0.0]),
        lambda fl: fl.optimizer.SGD(learning_rate=0.05)),
    "warmup_equals_momentum": (
        lambda fl: fl.optimizer.DGCMomentumOptimizer(
            learning_rate=0.05, momentum=0.9, rampup_begin_step=1000,
            sparsity=[0.999]),
        lambda fl: fl.optimizer.MomentumOptimizer(learning_rate=0.05,
                                                  momentum=0.9)),
    "sparse_converges": (
        lambda fl: fl.optimizer.DGCMomentumOptimizer(
            learning_rate=0.05, momentum=0.9, rampup_begin_step=0,
            sparsity=[0.5]), None),
}


@pytest.mark.parametrize("name", sorted(DGC_CASES))
def test_dgc_single_process_cases_of_the_reference(name):
    """The three single-process cases of the reference's
    ``tests/test_dgc.py`` on the port: sparsity 0 equals SGD and the
    warm-up equals momentum (1e-5), the sparse update (sparsity 0.5)
    lowers the loss over 12 steps; each run's losses within 1e-5 of the
    reference's."""
    make, plain = DGC_CASES[name]
    steps = 12 if plain is None else 6
    ref, arrays = _dgc_losses(jfluid, make, steps)
    port, _a = _dgc_losses(tfluid, make, steps, arrays)
    np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-6)
    if plain is None:
        assert port[-1] < port[0]
    else:
        other, _a = _dgc_losses(tfluid, plain, steps, arrays)
        np.testing.assert_allclose(port, other, rtol=1e-5, atol=1e-6)


def _dgc_dp_make(fl):
    return fl.optimizer.DGCMomentumOptimizer(
        learning_rate=0.05, momentum=0.9, rampup_begin_step=2,
        sparsity=[0.0])


def dgc_rank(rank, world, init):
    """One rank of DGC under ``with_data_parallel``: its half of each
    batch; the losses (its own) and the final state."""
    arrays = dict(np.load(init))
    main, startup, loss = _dgc_build(tfluid, _dgc_dp_make)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    tfluid.load_program_scope(main, scope, arrays)
    compiled = tfluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name)
    rs = np.random.RandomState(0)
    for s in range(5):
        b = _dgc_batch(s, rs)
        b = {k: v[rank * 8:(rank + 1) * 8] for k, v in b.items()}
        exe.run(compiled, feed=b, fetch_list=[loss], scope=scope)
    ops = [o.type for o in main.global_block().ops]
    return {"state": _state(tfluid, main, scope), "ops": ops}


def test_dgc_data_parallel_equals_one_process(tmp_path):
    """DGC on 2 gloo ranks, each on half of every batch: its warm-up
    steps sum the gradient over the ring inside ``dgc_momentum`` and its
    sparse steps (sparsity 0: every entry sent) sum the sent tensor
    there; the dense all-reduce leaves DGC's gradients out. Both ranks'
    parameters and accumulators equal one process on the whole batch
    within 1e-5 relative."""
    ref_losses, arrays = _dgc_losses(jfluid, _dgc_dp_make, 1)
    init = str(tmp_path / "init.npz")
    np.savez(init, **arrays)
    main, startup, loss = _dgc_build(tfluid, _dgc_dp_make)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    tfluid.load_program_scope(main, scope, arrays)
    rs = np.random.RandomState(0)
    for s in range(5):
        exe.run(main, feed=_dgc_batch(s, rs), fetch_list=[loss], scope=scope)
    one = _state(tfluid, main, scope)
    ranks = tworld.run_world(HERE + ":dgc_rank", 2, str(tmp_path / "w"),
                             kwargs={"init": init})
    for r in ranks:
        assert "c_allreduce_sum" not in r["ops"] or all(
            "dgc" not in n for n in r["ops"])
        assert sorted(r["state"]) == sorted(one)
        for n in one:
            np.testing.assert_allclose(r["state"][n], one[n], rtol=1e-5,
                                       atol=1e-6, err_msg=n)


# ---------------------------------------------------------------------------
# dygraph
# ---------------------------------------------------------------------------
DYGRAPH = {
    "lars_momentum": lambda fl, ps: fl.optimizer.LarsMomentumOptimizer(
        0.1, 0.9, lars_coeff=0.01, parameter_list=ps),
    "adamax": lambda fl, ps: fl.optimizer.Adamax(0.05, parameter_list=ps),
    "decayed_adagrad": lambda fl, ps: fl.optimizer.DecayedAdagrad(
        0.05, parameter_list=ps),
    "adadelta": lambda fl, ps: fl.optimizer.Adadelta(1.0,
                                                     parameter_list=ps),
    "rmsprop": lambda fl, ps: fl.optimizer.RMSProp(0.01, momentum=0.5,
                                                   parameter_list=ps),
    "ftrl": lambda fl, ps: fl.optimizer.Ftrl(0.1, l1=0.001,
                                             parameter_list=ps),
    "lamb": lambda fl, ps: fl.optimizer.Lamb(0.02, parameter_list=ps),
    "dgc": lambda fl, ps: fl.optimizer.DGCMomentumOptimizer(
        0.1, 0.9, sparsity=[0.5], parameter_list=ps),
    "dpsgd": lambda fl, ps: fl.optimizer.Dpsgd(0.1, clip=0.5,
                                               batch_size=2.0, sigma=0.0),
}


def _dygraph_run(fl, name, weights):
    with fl.dygraph.guard(fl.CPUPlace()):
        l1 = fl.dygraph.Linear(8, 6, act="relu")
        l2 = fl.dygraph.Linear(6, 3)
        params = l1.parameters() + l2.parameters()
        for p, w in zip(params, weights):
            p.set_value(w)
        opt = DYGRAPH[name](fl, params)
        losses = []
        for s in range(3):
            b = _batch(s, 8)
            logits = l2(l1(fl.dygraph.to_variable(b["x"])))
            loss = fl.layers.mean(fl.layers.softmax_with_cross_entropy(
                logits, fl.dygraph.to_variable(b["y"])))
            loss.backward()
            if name == "dpsgd":
                opt.minimize(loss, parameter_list=params)
            else:
                opt.minimize(loss)
            l1.clear_gradients()
            l2.clear_gradients()
            losses.append(float(loss.numpy().reshape(-1)[0]))
        return losses, [np.array(p.numpy()) for p in params]


@pytest.mark.parametrize("name", sorted(DYGRAPH))
def test_dygraph_optimizer_matches_reference(name):
    """The optimizers the reference's dygraph takes (every ``Optimizer``
    subclass: ``_dygraph_minimize``), 3 steps of a two-layer MLP from the
    same weights: losses and parameters within 1e-5 relative."""
    rs = np.random.RandomState(3)
    weights = [rs.uniform(-0.5, 0.5, s).astype(np.float32)
               for s in ((8, 6), (6,), (6, 3), (3,))]
    rl, rp = _dygraph_run(jfluid, name, weights)
    pl, pp = _dygraph_run(tfluid, name, weights)
    np.testing.assert_allclose(pl, rl, rtol=1e-5)
    for a, b in zip(pp, rp):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# tiny BERT under Lamb
# ---------------------------------------------------------------------------
S = 16


def _bert_feed():
    rs = np.random.RandomState(12)
    cfg = tbert.BertConfig.tiny()
    n = 4
    lens = np.array([16, 11, 7, 13])
    mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.float32)
    return {
        "src_ids": rs.randint(0, cfg.vocab_size, (n, S, 1)).astype(np.int64),
        "pos_ids": np.tile(np.arange(S)[None, :, None], (n, 1, 1)).astype(
            np.int64),
        "sent_ids": np.zeros((n, S, 1), np.int64),
        "input_mask": mask[:, :, None],
        "label": rs.randint(0, 2, (n, 1)).astype(np.int64),
    }


def _bert_lamb(fl, mod, arrays=None):
    cfg = mod.BertConfig.tiny(use_flash_attention=True, hidden_dropout=0.0,
                              attention_dropout=0.0)
    with fl.unique_name.guard():
        main, startup, _f, loss, _acc = bert_lamb.build_bert_classifier_lamb(
            cfg, S, learning_rate=1e-3, fluid=fl, bert=mod)
    main.random_seed = startup.random_seed = 5
    exe = fl.Executor(fl.CPUPlace())
    scope = fl.Scope() if fl is tfluid else fl.core.Scope()
    exe.run(startup, scope=scope)
    names = _persistables(main)
    if arrays is None:
        arrays = {n: np.array(scope.get(n)) for n in names}
    else:
        tfluid.load_program_scope(main, scope, arrays)
    losses = [float(np.asarray(exe.run(main, feed=_bert_feed(),
                                       fetch_list=[loss],
                                       scope=scope)[0]).reshape(-1)[0])
              for _ in range(3)]
    ops = [o.type for o in main.global_block().ops]
    return arrays, losses, _state(fl, main, scope), ops


def test_tiny_bert_lamb_matches_reference():
    """``BertConfig.tiny`` at seq 16 with ragged masks, dropout 0, 3 Lamb
    steps (lr 1e-3, weight decay 0.01) through each Executor (the
    reference's flash op on its plain path, the port's through the
    kernels' plain versions): the same op list, losses within 1e-5
    relative, every persistable within 1e-4 relative norm; as with Adam
    (``test_torch_bert.py``), the k-projection biases, whose exact
    gradient is 0, are held to 5·lr absolute a step and their moments to
    1e-6 absolute."""
    arrays, rl, rs, rops = _bert_lamb(jfluid, jbert)
    replays = tprofiler.get_counter(tregistry.REPLAY_COUNTER)
    _a, pl, ps, pops = _bert_lamb(tfluid, tbert, arrays)
    assert tprofiler.get_counter(tregistry.REPLAY_COUNTER) == replays
    assert pops == rops and rops.count("lamb") > 10
    np.testing.assert_allclose(pl, rl, rtol=1e-5)
    assert sorted(ps) == sorted(rs)
    for n in rs:
        if "_att_k.b_0" in n:
            limit = 3 * 5 * 1e-3 if n.endswith(".b_0") else 1e-6
            assert np.abs(ps[n] - rs[n]).max() <= limit, n
            continue
        err = np.linalg.norm(ps[n] - rs[n]) / max(np.linalg.norm(rs[n]),
                                                  1e-12)
        assert err < 1e-4, (n, err)


def test_gradient_merge_with_momentum_equals_the_merged_batch():
    """GradientMerge over an optimizer with accumulators (Momentum,
    k = 2; the reference's raises building this program: ROADMAP C): the
    parameters don't move between a merge's two steps, so the merged
    gradient is the gradient of the two batches joined, and 4 steps equal
    2 Momentum steps on the joined batches (1e-5 relative)."""
    make_gm = lambda fl: fl.optimizer.GradientMergeOptimizer(  # noqa: E731
        fl.optimizer.Momentum(0.1, 0.9), k_steps=2)
    make_m = lambda fl: fl.optimizer.Momentum(0.1, 0.9)  # noqa: E731
    batches = [_batch(s) for s in range(4)]
    joined = [{k: np.concatenate([batches[i][k], batches[i + 1][k]])
               for k in ("x", "y")} for i in (0, 2)]
    states = []
    for make, feeds in ((make_gm, batches), (make_m, joined)):
        main, startup, loss, _o = build_mlp(tfluid, make)
        exe = tfluid.Executor(tfluid.CPUPlace())
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
        got = []
        for f in feeds:
            exe.run(main, feed=f, fetch_list=[loss], scope=scope)
            got.append({n: scope.get(n).numpy().copy() for n in (
                "fc_0.w_0", "fc_0.b_0", "fc_1.w_0", "fc_1.b_0")})
        states.append(got)
    (gm, m) = states
    for merged, plain in ((gm[1], m[0]), (gm[3], m[1])):
        for n in plain:
            np.testing.assert_allclose(merged[n], plain[n], rtol=1e-5,
                                       atol=1e-6, err_msg=n)
