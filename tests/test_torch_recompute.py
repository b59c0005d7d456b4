"""Activation recompute in the port held against the JAX package and
against its own plain step on the CPU: ``append_backward(checkpoints=)``,
``RecomputeOptimizer`` and ``build_resnet_train(recompute=True)``.

- The recompute program is the reference's op for op: the replayed ops
  with their ``@RECOMPUTE@`` / ``@CKPT@`` names, the ``recompute_barrier``
  reads and the grad ops remapped (a small MLP, ResNet-18 at 32x32).
- Its losses and gradients match the reference's (fp32, dropout 0).
- Within the port, recompute equals the plain step to 1e-6 at dropout
  0.1, through the ``dropout`` op (kept, not replayed) and through the
  flash kernel's in-kernel dropout (the replay takes the forward's seed).
- The batch norms' running statistics are advanced once a step.
- The Executor captures the replayed forwards only, and its peak of
  live tensor bytes in a step (``torch.profiler``'s memory timeline on
  the CPU) is below the plain step's.
"""

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile
from torch.profiler._memory_profiler import Action

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import resnet as jresnet
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import executor as texecutor
from paddle_tpu_torch.fluid import profiler as tprofiler
from paddle_tpu_torch.fluid.ops import registry as tregistry
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import resnet as tresnet
from test_torch_cpu_math import pin_vector_math
from test_torch_vision import (_assert_state, _image_feed, _port_run,
                               _reference_run)

pin_vector_math(2)  # 2 threads, vector math set up on one (see there)


def _desc(main):
    return [(o.type, {k: list(v) for k, v in o.inputs.items()},
             {k: list(v) for k, v in o.outputs.items()})
            for o in main.global_block().ops]


def mlp(fl, recompute, layers=8, hidden=32, dropout=0.0, every=3):
    """An fc/tanh stack with an optional dropout after each layer, a
    4-class softmax cross entropy and SGD; checkpoints every ``every``
    layers' outputs. Returns (main, startup, loss)."""
    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = 7
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        x = fl.layers.data(name="x", shape=[hidden], dtype="float32")
        y = fl.layers.data(name="y", shape=[1], dtype="int64")
        h, ckpts = x, []
        for i in range(layers):
            h = fl.layers.fc(h, size=hidden, act="tanh",
                             param_attr=fl.ParamAttr(name="w%d" % i),
                             bias_attr=fl.ParamAttr(name="b%d" % i))
            if dropout:
                h = fl.layers.dropout(
                    h, dropout_prob=dropout,
                    dropout_implementation="upscale_in_train")
            if i % every == every - 1:
                ckpts.append(h)
        pred = fl.layers.fc(h, size=4, param_attr=fl.ParamAttr(name="wo"),
                            bias_attr=fl.ParamAttr(name="bo"))
        loss = fl.layers.mean(fl.layers.softmax_with_cross_entropy(pred, y))
        opt = fl.optimizer.SGD(learning_rate=0.05)
        if recompute:
            opt = fl.optimizer.RecomputeOptimizer(opt)
            opt._set_checkpoints(ckpts)
        opt.minimize(loss)
    return main, startup, loss


def _mlp_feed(hidden=32, n=16):
    rs = np.random.RandomState(0)
    return {"x": rs.standard_normal((n, hidden)).astype(np.float32),
            "y": rs.randint(0, 4, (n, 1)).astype(np.int64)}


_GRADS = ["w0@GRAD", "b0@GRAD", "w4@GRAD", "w7@GRAD", "wo@GRAD"]


def _run(fl, main, startup, loss, feed, arrays=None, steps=1, fetch=None):
    """Steps of ``main`` from the startup scope (the port's loaded with
    ``arrays``); returns ([fetches per step], scope arrays, scope)."""
    exe = fl.Executor(fl.CPUPlace())
    scope = fl.Scope() if fl is tfluid else fl.core.Scope()
    exe.run(startup, scope=scope)
    if arrays is not None:
        tfluid.load_program_scope(main, scope, arrays)
    names = [v.name for v in main.list_vars() if v.persistable]
    start = {n: np.array(scope.get(n)) for n in names}
    out = [[np.asarray(g) for g in exe.run(
        main, feed=feed, fetch_list=[loss] + (fetch or _GRADS),
        scope=scope)] for _ in range(steps)]
    return out, start, scope


@pytest.mark.parametrize("model", ["mlp", "resnet18"])
def test_recompute_program_is_the_reference_program(model):
    """``RecomputeOptimizer`` / ``build_resnet_train(recompute=True)``
    build the reference's desc op for op: types, slots and names,
    replays (``@RECOMPUTE@``), barriered reads (``@CKPT@``) and remapped
    grad ops included."""
    descs = []
    for fl, res in ((jfluid, jresnet), (tfluid, tresnet)):
        if model == "mlp":
            main = mlp(fl, True)[0]
        else:
            with fl.unique_name.guard():
                main = res.build_resnet_train(18, 10, 32, recompute=True)[0]
        descs.append(_desc(main))
    assert descs[1] == descs[0]
    types = [d[0] for d in descs[1]]
    assert "recompute_barrier" in types
    assert any("@RECOMPUTE@" in n for d in descs[1] for names in
               d[2].values() for n in names)


def test_recompute_mlp_matches_reference_and_plain():
    """The MLP with checkpoints every 3 layers: three SGD steps whose
    losses and gradients are within 1e-5 of the reference's recompute
    steps, and equal the port's plain steps to 1e-6; 0 generic replays."""
    feed = _mlp_feed()
    jmain, jstart, jloss = mlp(jfluid, True)
    ref, arrays, _s = _run(jfluid, jmain, jstart, jloss, feed, steps=3)
    r0 = tprofiler.get_counter(tregistry.REPLAY_COUNTER)
    main, startup, loss = mlp(tfluid, True)
    rec, _a, _s = _run(tfluid, main, startup, loss, feed, arrays, steps=3)
    assert tprofiler.get_counter(tregistry.REPLAY_COUNTER) == r0
    main, startup, loss = mlp(tfluid, False)
    plain, _a, _s = _run(tfluid, main, startup, loss, feed, arrays, steps=3)
    for r, p, q in zip(ref, rec, plain):
        for a, b, c in zip(r, p, q):
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(b, c, rtol=1e-6, atol=1e-7)


def test_resnet18_recompute_step_matches_reference():
    """ResNet-18 at 32x32 (10 classes, batch 4, Momentum) with recompute:
    one step's loss within 1e-4 relative of the reference's recompute
    step, accuracies equal, every persistable after it within 1e-3
    relative norm (the tolerances of the plain ResNet-18 parity test,
    ``test_torch_vision.py``); 0 generic replays."""
    def build(m):
        return lambda: m.build_resnet_train(18, class_num=10, image_size=32,
                                            recompute=True)

    feed = _image_feed(8, 4, 3, 32, 10)
    arrays, ref, ref_after = _reference_run(build(jresnet), feed, 1)
    out, after = _port_run(build(tresnet), feed, 1, arrays)
    np.testing.assert_allclose([o[0] for o in out], [r[0] for r in ref],
                               rtol=1e-4)
    assert [o[1] for o in out] == [r[1] for r in ref]
    _assert_state(after, ref_after, 1e-3)


def test_resnet18_recompute_advances_running_stats_once():
    """Two steps of ResNet-18 (64x64) with recompute and without, from
    one startup scope: every persistable (parameters, velocities and the
    batch norms' running Mean and Variance, which a replay must not
    update a second time) equal to 1e-6 relative norm, and every running
    statistic moved by the forward."""
    feed = _image_feed(9, 4, 3, 64, 10)
    got = {}
    for rec in (False, True):
        with tfluid.unique_name.guard():
            main, startup, _f, loss, _acc = tresnet.build_resnet_train(
                18, 10, 64, recompute=rec)
        exe = tfluid.Executor(tfluid.CPUPlace())
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
        names = [v.name for v in main.list_vars() if v.persistable]
        if not rec:
            start = {n: scope.get(n).numpy().copy() for n in names}
        else:
            tfluid.load_program_scope(main, scope, start)
        for _ in range(2):
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        got[rec] = {n: scope.get(n).numpy().copy() for n in names}
    _assert_state(got[True], got[False], 1e-6)
    stats = [n for o in main.global_block().ops if o.type == "batch_norm"
             and "@RECOMPUTE@" not in o.output("MeanOut")[0]
             for n in o.input("Mean") + o.input("Variance")]
    assert len(stats) == 2 * 20
    assert all(not np.allclose(got[True][n], start[n]) for n in stats)


def _bert_program(fl, bert, cfg, seq, recompute, lr=1e-3):
    """``build_bert_classifier``'s program with Adam, wrapped in
    ``RecomputeOptimizer`` when ``recompute``: the checkpoints are the
    encoder layers' outputs, picked from the built program as the last
    op of each ``encoder_layer`` (its second ``layer_norm``; the first
    ``layer_norm`` of the program is the embeddings')."""
    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = 5
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        L = fl.layers
        feeds = [L.data(name=n, shape=[seq, 1], dtype="int64")
                 for n in ("src_ids", "pos_ids", "sent_ids")]
        mask = L.data(name="input_mask", shape=[seq, 1], dtype="float32")
        label = L.data(name="label", shape=[1], dtype="int64")
        _x, pooled = bert.bert_encoder(*feeds, mask, cfg)
        pooled = bert._dropout(pooled, cfg.hidden_dropout, cfg.is_test)
        logits = L.fc(input=pooled, size=2, name="cls")
        loss = L.mean(L.softmax_with_cross_entropy(logits, label))
        L.accuracy(input=L.softmax(logits), label=label)
        block = main.global_block()
        norms = [o for o in block.ops if o.type == "layer_norm"]
        assert len(norms) == 1 + 2 * cfg.num_layers
        ckpts = [block.var(o.output("Y")[0]) for o in norms[2::2]]
        opt = fl.optimizer.Adam(learning_rate=lr)
        if recompute:
            opt = fl.optimizer.RecomputeOptimizer(opt)
            opt._set_checkpoints(ckpts)
        opt.minimize(loss)
    return main, startup, loss


def _bert_feed(seq, n=4, vocab=100):
    rs = np.random.RandomState(1)
    mask = np.ones((n, seq, 1), np.float32)
    mask[1, seq - 3:] = 0.0
    return {"src_ids": rs.randint(0, vocab, (n, seq, 1)).astype(np.int64),
            "pos_ids": np.tile(np.arange(seq).reshape(1, seq, 1),
                               (n, 1, 1)).astype(np.int64),
            "sent_ids": np.zeros((n, seq, 1), np.int64),
            "input_mask": mask,
            "label": rs.randint(0, 2, (n, 1)).astype(np.int64)}


def test_bert_plain_program_is_build_bert_classifier():
    """The recompute cases' plain BERT program is ``build_bert_classifier``
    op for op (only its Adam is built by the caller)."""
    cfg = tbert.BertConfig.tiny(use_flash_attention=True)
    with tfluid.unique_name.guard():
        want = tbert.build_bert_classifier(cfg, 16, learning_rate=1e-3)[0]
    got = _bert_program(tfluid, tbert, cfg, 16, False)[0]
    assert _desc(got) == _desc(want)


@pytest.mark.parametrize("kind", ["dropout_op", "flash_dropout"])
def test_recompute_equals_plain_at_dropout(kind):
    """Dropout 0.1, the same generator state on both sides: the MLP with a
    ``dropout`` op after every layer (its outputs kept, not replayed), and
    the tiny BERT classifier through the flash path, attention dropout
    0.1 in the kernel (the replay takes the forward's seed; a fresh seed
    would give O(1) errors). Three steps' losses and every gradient equal
    the plain program's to 1e-6; the replay draws no seed, so the
    generator streams stay aligned step after step."""
    if kind == "dropout_op":
        feed = _mlp_feed()
        progs = [mlp(tfluid, rec, dropout=0.1) for rec in (False, True)]
        fetch = _GRADS
    else:
        cfg = tbert.BertConfig.tiny(use_flash_attention=True,
                                    hidden_dropout=0.1,
                                    attention_dropout=0.1)
        feed = _bert_feed(16)
        progs = [_bert_program(tfluid, tbert, cfg, 16, rec)
                 for rec in (False, True)]
        fetch = [p.name + "@GRAD" for p in progs[0][0].all_parameters()]
    runs = []
    arrays = None
    for main, startup, loss in progs:
        out, start, _scope = _run(tfluid, main, startup, loss, feed,
                                  arrays, steps=3, fetch=fetch)
        arrays = arrays or start
        runs.append(out)
    for plain, rec in zip(*runs):
        for a, b in zip(plain, rec):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)


def test_flash_replay_without_the_forward_seed_differs():
    """The check above can fail: with the replays drawing fresh flash
    seeds (their ``@RECOMPUTE@`` name not recognised), the recompute
    step's layer-0 gradients move far from the plain step's, while with
    the forward's seed they equal it to 1e-6."""
    from paddle_tpu_torch.fluid.ops import nn_ops

    cfg = tbert.BertConfig.tiny(use_flash_attention=True, hidden_dropout=0.0,
                                attention_dropout=0.3)
    feed = _bert_feed(16)
    progs = [_bert_program(tfluid, tbert, cfg, 16, rec)
             for rec in (False, True, True)]
    fetch = [p.name + "@GRAD" for p in progs[0][0].all_parameters()
             if p.name.startswith("layer_0")]
    assert fetch
    runs, arrays = [], None
    saved = nn_ops.unreplayed_name
    for i, (main, startup, loss) in enumerate(progs):
        if i == 2:
            nn_ops.unreplayed_name = lambda name: name
        try:
            out, start, _scope = _run(tfluid, main, startup, loss, feed,
                                      arrays, steps=1, fetch=fetch)
        finally:
            nn_ops.unreplayed_name = saved
        arrays = arrays or start
        runs.append(out[0])
    plain, rec, fresh = runs
    same = max(float(np.abs(r - p).max()) for r, p in zip(rec, plain))
    rel = max(float(np.linalg.norm(f - p) / max(np.linalg.norm(p), 1e-12))
              for f, p in zip(fresh[1:], plain[1:]))
    assert same <= 1e-6 and rel > 1e-2, (same, rel)


def test_flash_replay_without_the_forward_seed_raises(monkeypatch):
    """A replay that cannot find its forward's ``@FLASH_SEED`` companion
    raises rather than draw a fresh seed (which would give gradients of
    another mask): the tiny BERT recompute step at attention dropout 0.1
    with every seed companion dropped from the run."""
    cfg = tbert.BertConfig.tiny(use_flash_attention=True, hidden_dropout=0.0,
                                attention_dropout=0.1)
    main, startup, loss = _bert_program(tfluid, tbert, cfg, 16, True)
    set_ = tregistry.LowerCtx.set

    def dropping_seeds(ctx, name, value):
        if not name.endswith("@FLASH_SEED"):
            set_(ctx, name, value)

    monkeypatch.setattr(tregistry.LowerCtx, "set", dropping_seeds)
    with pytest.raises(RuntimeError, match="@RECOMPUTE@.*@FLASH_SEED"):
        _run(tfluid, main, startup, loss, _bert_feed(16), steps=1,
             fetch=[main.all_parameters()[0].name + "@GRAD"])


def _peak_bytes(exe, main, feed, fetch, scope):
    """The largest total of tensor bytes alive at once during one run,
    from ``torch.profiler``'s memory timeline (every tensor the run
    creates, freed where it dies)."""
    with profile(activities=[ProfilerActivity.CPU], profile_memory=True,
                 record_shapes=True, with_stack=True) as prof:
        exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    cur = peak = 0
    for _t, action, _key, size in sorted(prof._memory_profile().timeline,
                                         key=lambda r: r[0]):
        if action == Action.CREATE:
            cur += size
        elif action == Action.DESTROY:
            cur -= size
        peak = max(peak, cur)
    return peak


def test_executor_captures_replays_only_and_holds_less():
    """The recompute MLP (12 layers of 256, batch 512, checkpoints every
    3): every forward the Executor captures for a generic grad is a
    replay (its outputs ``@RECOMPUTE@``), none of the originals, and the
    step's peak of live tensor bytes on the CPU is below the plain
    step's (read: 5.5 MB against 7.9 MB)."""
    feed = _mlp_feed(hidden=256, n=512)
    peaks = []
    for rec in (False, True):
        main, startup, loss = mlp(tfluid, rec, layers=12, hidden=256)
        exe = tfluid.Executor(tfluid.CPUPlace())
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        ops = main.global_block().ops
        pairs = texecutor._capture_pairs(ops)
        replayed = [any("@RECOMPUTE@" in n for n in ops[i].output_arg_names)
                    for _j, i in pairs]
        assert pairs and all(replayed) == rec and any(replayed) == rec
        peaks.append(_peak_bytes(exe, main, feed, [loss], scope))
    assert peaks[1] < 0.85 * peaks[0], peaks
