"""The BERT slice of the port (the ``tanh``, ``top_k`` and ``accuracy``
ops, the ``accuracy`` layer, and ``models.bert``'s ``BertConfig``,
``bert_encoder`` and ``build_bert_classifier``) held against the JAX
package on the CPU.

Ops run alone through each package's Executor (``run_op`` of
``test_torch_vision``). Programs are built under a fresh
``unique_name.guard()`` on both sides, so every variable carries the
reference's name; the reference's startup scope goes into the port's with
``fluid.load_program_scope``. The reference's ``flash_attention`` op runs
through its plain (jnp) path on the CPU, as its own BERT tests run it,
the port's through the kernels' plain versions. Dropout is 0 wherever
values are compared (the two packages draw masks from different random
streams). Tolerances are stated at each comparison.
"""

import collections

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import profiler as tprofiler
from paddle_tpu_torch.fluid.ops import registry as tregistry
from paddle_tpu_torch.models import bert as tbert
from test_torch_cpu_math import pin_vector_math
from test_torch_vision import assert_same, both

pin_vector_math(2)  # 2 threads, vector math set up on one (see there)

S = 32
BATCH = 4
LR = 1e-3


def test_tanh_matches_reference():
    """The ``tanh`` activation op and its generic grad: within 1e-6."""
    rs = np.random.RandomState(0)
    x = (rs.standard_normal((3, 7)) * 2).astype(np.float32)
    feed = {"x": x, "cot": rs.standard_normal((3, 7)).astype(np.float32)}
    ref, port = both("tanh", feed, {"X": ["x"]}, {"Out": "out"},
                     loss_out="Out", wrt=("x",))
    assert_same(ref, port, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k", [1, 3])
def test_top_k_matches_reference_ties_to_lower_index(k):
    """``top_k``: the k largest of the last axis, largest first, int64
    indices; rows with equal entries pick the lower index first, as
    ``jax.lax.top_k`` does. Values and indices equal the reference's."""
    rs = np.random.RandomState(1)
    x = rs.randint(0, 4, (6, 9)).astype(np.float32)   # many ties
    x[0] = 2.0                                         # a row all equal
    ref, port = both("top_k", {"x": x}, {"X": ["x"]},
                     {"Out": "vals", "Indices": "idx"}, {"k": k})
    assert port[0]["Indices"].dtype == np.int64
    np.testing.assert_array_equal(port[0]["Out"], ref[0]["Out"])
    np.testing.assert_array_equal(port[0]["Indices"], ref[0]["Indices"])
    np.testing.assert_array_equal(port[0]["Indices"][0], np.arange(k))


@pytest.mark.parametrize("k", [1, 2])
def test_accuracy_matches_reference(k):
    """``accuracy`` from ``top_k``'s indices and [N, 1] labels: Accuracy
    float32 [1], Correct and Total int32 [1], equal to the reference's."""
    rs = np.random.RandomState(2)
    idx = rs.randint(0, 5, (10, k)).astype(np.int64)
    label = rs.randint(0, 5, (10, 1)).astype(np.int64)
    feed = {"vals": rs.standard_normal((10, k)).astype(np.float32),
            "idx": idx, "label": label}
    outs = {"Accuracy": "acc", "Correct": "correct", "Total": "total"}
    ref, port = both("accuracy", feed, {"Out": ["vals"], "Indices": ["idx"],
                                        "Label": ["label"]}, outs)
    for slot, dtype in (("Accuracy", np.float32), ("Correct", np.int32),
                        ("Total", np.int32)):
        assert port[0][slot].dtype == dtype and port[0][slot].shape == (1,)
        np.testing.assert_array_equal(port[0][slot], ref[0][slot])
    assert port[0]["Total"][0] == 10
    assert port[0]["Correct"][0] == (idx == label).any(1).sum()


def _cfg(mod, flash, dropout=0.0):
    return mod.BertConfig.tiny(use_flash_attention=flash,
                               hidden_dropout=dropout,
                               attention_dropout=dropout)


def _ops(program):
    return [op.type for op in program.global_block().ops]


def _persistables(program):
    return sorted(v.name for v in program.list_vars() if v.persistable)


@pytest.mark.parametrize("flash,amp", [(True, False), (False, False),
                                       (True, True), (False, True)],
                         ids=["flash", "dense", "flash_amp", "dense_amp"])
def test_bert_classifier_is_the_reference_program(flash, amp):
    """``build_bert_classifier(BertConfig.tiny, 32)`` (dropout 0.1, the
    config's default), flash and dense, fp32 and AMP (built, not run):
    the main program's op types in the reference's order, the startup's,
    the persistables, the feeds, the loss and accuracy names, and every
    variable's shape and type but the ``top_k`` Indices (int64 here,
    int32 in the reference's desc: ROADMAP C). The flash program holds
    one ``flash_attention`` op and its grad a layer, the pooler's
    ``tanh``, the ``top_k`` / ``accuracy`` pair, and one ``adam`` a
    parameter."""
    with jfluid.unique_name.guard():
        jmain, jstart, jfeeds, jloss, jacc = jbert.build_bert_classifier(
            _cfg(jbert, flash, 0.1), S, use_amp=amp)
    with tfluid.unique_name.guard():
        tmain, tstart, tfeeds, tloss, tacc = tbert.build_bert_classifier(
            _cfg(tbert, flash, 0.1), S, use_amp=amp)
    assert _ops(tmain) == _ops(jmain)
    assert collections.Counter(_ops(tstart)) == collections.Counter(
        _ops(jstart))
    assert _persistables(tmain) == _persistables(jmain)
    assert [f.name for f in tfeeds] == ["src_ids", "pos_ids", "sent_ids",
                                        "input_mask", "label"]
    assert (tloss.name, tacc.name) == (jloss.name, jacc.name)
    jv = {v.name: v for v in jmain.list_vars()}
    for v in tmain.list_vars():
        assert tuple(v.shape) == tuple(jv[v.name].shape), v.name
        if v.name != "top_k_0.tmp_1":
            assert v.dtype == jv[v.name].dtype, v.name
    counts = collections.Counter(_ops(tmain))
    layers = tbert.BertConfig.tiny().num_layers
    assert counts["flash_attention"] == (layers if flash else 0)
    assert counts["flash_attention_grad"] == (layers if flash else 0)
    assert counts["tanh"] == 1 and counts["top_k"] == 1
    assert counts["accuracy"] == 1
    assert counts["adam"] == len(tmain.all_parameters())
    if amp:
        assert counts["cast"] > 0


def _feed(seed=0, vocab=1024):
    """[4, 32] ids, positions, sentence ids 0/1, ragged masks (real
    lengths 32, 20, 9, 27) and labels."""
    rs = np.random.RandomState(seed)
    lens = (32, 20, 9, 27)
    mask = np.zeros((BATCH, S, 1), np.float32)
    for i, n in enumerate(lens):
        mask[i, :n] = 1.0
    sent = np.zeros((BATCH, S, 1), np.int64)
    sent[:, S // 2:] = 1
    return {"src_ids": rs.randint(0, vocab, (BATCH, S, 1)).astype(np.int64),
            "pos_ids": np.tile(np.arange(S).reshape(1, S, 1),
                               (BATCH, 1, 1)).astype(np.int64),
            "sent_ids": sent, "input_mask": mask,
            "label": rs.randint(0, 2, (BATCH, 1)).astype(np.int64)}


def _reference_steps(flash, steps, amp=False):
    """The reference's program after its startup run: (startup scope
    arrays of every persistable, [(loss, acc)] of ``steps`` Adam steps,
    every persistable after them)."""
    with jfluid.unique_name.guard():
        main, startup, _f, loss, acc = jbert.build_bert_classifier(
            _cfg(jbert, flash), S, learning_rate=LR, use_amp=amp)
    main.random_seed = startup.random_seed = 5
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.core.Scope()
    with jfluid.executor.scope_guard(scope):
        exe.run(startup)
    names = _persistables(main)
    arrays = {n: np.array(scope.get(n)) for n in names}
    out = []
    for _ in range(steps):
        lv, av = exe.run(main, feed=_feed(), fetch_list=[loss, acc],
                         scope=scope)
        out.append((float(np.asarray(lv).reshape(-1)[0]),
                    float(np.asarray(av).reshape(-1)[0])))
    return arrays, out, {n: np.array(scope.get(n)) for n in names}


def _port_steps(flash, steps, arrays, amp=False):
    with tfluid.unique_name.guard():
        main, startup, _f, loss, acc = tbert.build_bert_classifier(
            _cfg(tbert, flash), S, learning_rate=LR, use_amp=amp)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    tfluid.load_program_scope(main, scope, arrays)
    replays0 = tprofiler.get_counter(tregistry.REPLAY_COUNTER)
    out = []
    for _ in range(steps):
        lv, av = exe.run(main, feed=_feed(), fetch_list=[loss, acc],
                         scope=scope)
        out.append((float(lv.reshape(-1)[0]), float(av.reshape(-1)[0])))
    assert tprofiler.get_counter(tregistry.REPLAY_COUNTER) == replays0
    return out, {n: scope.get(n).float().numpy() for n in _persistables(main)}


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "dense"])
def test_three_adam_steps_match_reference_executor(flash):
    """``BertConfig.tiny`` at seq 32 with ragged masks, dropout 0, 3 Adam
    steps (lr 1e-3) through each Executor from the reference's startup
    scope: losses within 1e-5 relative, accuracies equal, and every
    persistable after the steps (parameters, both moments, β-pows, the
    learning rate) within 1e-4 relative norm (fp32 both ways; ~1e-6
    read). The exception is the k-projection biases and their moments:
    their exact gradient is 0 (softmax ignores a shift shared by every
    key of a query), so each side's rounding noise is what Adam
    normalises; the biases are held to an absolute 5·lr per step and
    their moments to 1e-6 absolute."""
    arrays, ref, ref_after = _reference_steps(flash, 3)
    out, after = _port_steps(flash, 3, arrays)
    np.testing.assert_allclose([o[0] for o in out], [r[0] for r in ref],
                               rtol=1e-5)
    assert [o[1] for o in out] == [r[1] for r in ref]
    assert sorted(after) == sorted(ref_after)
    for n, want in ref_after.items():
        got = after[n]
        if "_att_k.b_0" in n:
            limit = 3 * 5 * LR if n.endswith(".b_0") else 1e-6
            assert np.abs(got - want).max() <= limit, n
            continue
        d = float(np.linalg.norm(got - want))
        assert d <= 1e-4 * max(float(np.linalg.norm(want)), 1e-6), (n, d)


def test_amp_step_matches_reference_executor():
    """The AMP (bf16) program, flash: the step-1 loss within 1e-2
    relative of the reference's AMP step-1 loss (bf16 products rounded
    in other orders on each side) and within 1e-2 of the port's own fp32
    step; accuracies equal."""
    arrays, ref, _after = _reference_steps(True, 1, amp=True)
    out, _after = _port_steps(True, 1, arrays, amp=True)
    fp32, _a = _port_steps(True, 1, {k: v for k, v in arrays.items()
                                     if k != "loss_scaling"})
    np.testing.assert_allclose(out[0][0], ref[0][0], rtol=1e-2)
    np.testing.assert_allclose(out[0][0], fp32[0][0], rtol=1e-2)
    assert out[0][1] == ref[0][1]


def test_pooled_output_matches_reference():
    """``bert_encoder``'s pooled output (tanh of the first token's fc) on
    ragged masks, flash against the reference's flash and the port's own
    dense encoder from the same weights, within 1e-5: padded query rows
    differ between the two attention forms (the dense bias masks them,
    the key bias does not), but the first token is real in every row."""
    def pooled(fl, mod, flash, arrays=None):
        main, startup = fl.Program(), fl.Program()
        with fl.unique_name.guard(), fl.program_guard(main, startup):
            ins = [fl.layers.data(name=n, shape=[S, 1], dtype=d)
                   for n, d in (("src_ids", "int64"), ("pos_ids", "int64"),
                                ("sent_ids", "int64"),
                                ("input_mask", "float32"))]
            _seq, out = mod.bert_encoder(*ins, _cfg(mod, flash))
        exe = fl.Executor(fl.CPUPlace())
        if fl is jfluid:
            main.random_seed = startup.random_seed = 9
            scope = fl.core.Scope()
            with fl.executor.scope_guard(scope):
                exe.run(startup)
            arrays = {n: np.array(scope.get(n))
                      for n in _persistables(main)}
        else:
            scope = fl.Scope()
            exe.run(startup, scope=scope)
            fl.load_program_scope(main, scope, arrays)
        feed = {k: v for k, v in _feed().items() if k != "label"}
        got = exe.run(main, feed=feed, fetch_list=[out], scope=scope)[0]
        return np.asarray(got), arrays

    want, arrays = pooled(jfluid, jbert, True)
    got, _ = pooled(tfluid, tbert, True, arrays)
    dense, _ = pooled(tfluid, tbert, False, arrays)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dense, got, rtol=1e-5, atol=1e-5)
