"""The recurrent layers of the port held against the JAX package on the
CPU: the ragged (LoD) feed path (``DataFeeder``, ``create_lod_tensor``,
the Executor's padding and ``@SEQ_LEN`` companions), every op of
``sequence_ops.py``, the fused ``lstm`` / ``lstmp`` / ``lstm_unit`` /
``gru`` / ``gru_unit`` ops, ``recurrent``, ``dynamic_decode``,
``gather_tree`` and ``adagrad``, and the layers over them: ``StaticRNN``,
``DynamicRNN``, ``IfElse``, the cell API (``rnn`` with ``LSTMCell`` and
``GRUCell``, forward and reversed, with masked lengths), ``basic_lstm``
/ ``basic_gru``, ``BeamSearchDecoder`` + ``dynamic_decode``, and the
IMDB stacked-LSTM program, each program for program at tiny widths.

An op runs alone in a one-op program of each package (``run_op``);
ragged lengths ride a fed ``x@SEQ_LEN`` companion, which both packages
read. A program is built in both packages under ``unique_name.guard()``
and compared op for op; the reference's startup parameters go into the
port's scope and both Executors run the same feed. Tolerances are
stated at each comparison.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import profiler as tprofiler
from paddle_tpu_torch.fluid.ops import registry as tregistry
from test_torch_cpu_math import pin_vector_math
from test_torch_vision import assert_same, both, run_op

pin_vector_math(2)  # 2 threads, vector math set up on one (see there)


def _rand(rs, *shape):
    return rs.standard_normal(shape).astype(np.float32)


LENS = np.array([5, 2, 4], np.int32)  # a ragged batch of 3, T = 5


# ---------------------------------------------------------------------------
# sequence ops
# ---------------------------------------------------------------------------
def _seq_case(op_type, attrs=None, x_shape=(3, 5, 4), out="Out",
              lens=True, extra=None, grad=True):
    return dict(op_type=op_type, attrs=attrs or {}, x_shape=x_shape,
                out=out, lens=lens, extra=extra or {}, grad=grad)


SEQ_CASES = {
    "pool_sum": _seq_case("sequence_pool", {"pooltype": "SUM"}),
    "pool_average": _seq_case("sequence_pool", {"pooltype": "AVERAGE"}),
    "pool_sqrt": _seq_case("sequence_pool", {"pooltype": "SQRT"}),
    "pool_max": _seq_case("sequence_pool", {"pooltype": "MAX"}),
    "pool_last": _seq_case("sequence_pool", {"pooltype": "LAST"}),
    "pool_first": _seq_case("sequence_pool", {"pooltype": "FIRST"}),
    "softmax": _seq_case("sequence_softmax", x_shape=(3, 5)),
    "reshape": _seq_case("sequence_reshape", {"new_dim": 2}),
    "concat": _seq_case("sequence_concat", extra={"X2": (3, 2, 4)}),
    "expand": _seq_case("sequence_expand", x_shape=(3, 1, 4),
                        extra={"Y": (3, 5, 4)}, lens=False),
    "expand_as": _seq_case("sequence_expand_as", x_shape=(3, 4),
                           extra={"Y": (3, 5, 4)}),
    "pad": _seq_case("sequence_pad", {"padded_length": 7},
                     extra={"PadValue": (1,)}),
    "unpad": _seq_case("sequence_unpad", extra={"Length": "lens64"},
                       lens=False),
    "slice": _seq_case("sequence_slice",
                       extra={"Offset": "offset", "Length": "lens64"},
                       lens=False),
    "reverse": _seq_case("sequence_reverse", out="Y"),
    "conv": _seq_case("sequence_conv",
                      {"contextLength": 3, "contextStart": -1,
                       "contextStride": 1}, extra={"Filter": (12, 6)}),
    "row_conv": _seq_case("row_conv", extra={"Filter": (3, 4)}),
    "lod_reset_attr": _seq_case("lod_reset",
                                {"target_lod": [0, 1, 3, 5]}),
    "scatter": _seq_case("sequence_scatter", x_shape=(3, 6),
                         extra={"Ids": "ids", "Updates": (3, 5)}),
    "im2sequence": _seq_case("im2sequence",
                             {"kernels": [2, 2], "strides": [1, 2],
                              "paddings": [0, 1, 1, 0]},
                             x_shape=(2, 3, 5, 6), lens=False),
}


@pytest.mark.parametrize("case", sorted(SEQ_CASES))
def test_sequence_op_matches_reference(case):
    """Each sequence op on a ragged batch (lengths 5, 2, 4 of 5) and its
    grad (the generic vjp in both packages) within 1e-5 of the
    reference's."""
    c = SEQ_CASES[case]
    rs = np.random.RandomState(3)
    feed = {"x": _rand(rs, *c["x_shape"])}
    ins = {"X": ["x"]}
    if c["lens"]:
        feed["x@SEQ_LEN"] = LENS
    wrt = ["x"]
    for slot, spec in c["extra"].items():
        name = slot.lower()
        if spec == "lens64":
            feed[name] = LENS.astype(np.int64).reshape(-1, 1)
        elif spec == "offset":
            feed[name] = np.array([[0], [1], [0]], np.int64)
        elif spec == "ids":
            feed[name] = rs.randint(0, 6, (3, 5, 1)).astype(np.int64)
            feed["ids@SEQ_LEN"] = LENS
        else:
            feed[name] = _rand(rs, *spec)
            if slot != "PadValue":
                wrt.append(name)
        if slot == "X2":
            ins["X"].append(name)
        else:
            ins[slot] = [name]
    outs = {c["out"]: "out"}
    ref_out, _g = both(c["op_type"], feed, ins, outs, c["attrs"])[0]
    feed["cot"] = _rand(rs, *ref_out[c["out"]].shape)
    ref, port = both(c["op_type"], feed, ins, outs, c["attrs"],
                     loss_out=c["out"], wrt=wrt if c["grad"] else ())
    assert_same(ref, port, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["erase", "enumerate", "mask"])
def test_integer_sequence_op_matches_reference(case):
    """The id ops (no grad) equal the reference's exactly."""
    rs = np.random.RandomState(4)
    ids = rs.randint(0, 4, (3, 5, 1)).astype(np.int64)
    if case == "erase":
        args = ("sequence_erase", {"x": ids, "x@SEQ_LEN": LENS},
                {"X": ["x"]}, {"Out": "out"}, {"tokens": [1, 3]})
    elif case == "enumerate":
        args = ("sequence_enumerate", {"x": ids, "x@SEQ_LEN": LENS},
                {"X": ["x"]}, {"Out": "out"},
                {"win_size": 3, "pad_value": 9})
    else:
        args = ("sequence_mask", {"x": LENS.astype(np.int64)}, {"X": ["x"]},
                {"Y": "out"}, {"maxlen": 6, "out_dtype": 3})
    (ro, _), (po, _) = both(*args)
    for k in ro:
        np.testing.assert_array_equal(po[k], ro[k])


# ---------------------------------------------------------------------------
# fused recurrent ops and adagrad
# ---------------------------------------------------------------------------
FUSED_CASES = {
    # name: (op, {slot: shape}, attrs, out slot)
    "lstm": ("lstm", {"Input": (3, 5, 16), "Weight": (4, 16),
                      "Bias": (1, 28)},
             {"use_peepholes": True}, "Hidden"),
    "lstm_reverse_no_peep": ("lstm", {"Input": (3, 5, 16),
                                      "Weight": (4, 16), "Bias": (1, 16),
                                      "H0": (3, 4), "C0": (3, 4)},
                             {"use_peepholes": False, "is_reverse": True},
                             "Hidden"),
    "lstm_cell_out": ("lstm", {"Input": (3, 5, 16), "Weight": (4, 16),
                               "Bias": (1, 28)},
                      {"use_peepholes": True,
                       "candidate_activation": "relu"}, "Cell"),
    "lstmp": ("lstmp", {"Input": (3, 5, 16), "Weight": (3, 16),
                        "ProjWeight": (4, 3), "Bias": (1, 28)},
              {"use_peepholes": True}, "Projection"),
    "gru": ("gru", {"Input": (3, 5, 12), "Weight": (4, 12),
                    "Bias": (1, 12)}, {}, "Hidden"),
    "gru_origin_reverse": ("gru", {"Input": (3, 5, 12), "Weight": (4, 12),
                                   "Bias": (1, 12), "H0": (3, 4)},
                           {"origin_mode": True, "is_reverse": True},
                           "Hidden"),
    "gru_unit": ("gru_unit", {"Input": (3, 12), "HiddenPrev": (3, 4),
                              "Weight": (4, 12), "Bias": (1, 12)},
                 {"activation": 2, "gate_activation": 1}, "Hidden"),
    "lstm_unit": ("lstm_unit", {"X": (3, 16), "C_prev": (3, 4)},
                  {"forget_bias": 0.5}, "H"),
}


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_rnn_op_matches_reference(case):
    """Each fused recurrence on a ragged batch (lengths 5, 2, 4; padded
    steps carry the state and emit zeros) and its grad with respect to
    every float input within 1e-5 of the reference's ``lax.scan``."""
    op_type, shapes, attrs, out = FUSED_CASES[case]
    rs = np.random.RandomState(5)
    feed = {slot.lower(): _rand(rs, *s) * 0.5 for slot, s in shapes.items()}
    first = next(iter(shapes)).lower()
    if len(shapes[next(iter(shapes))]) == 3:
        feed[first + "@SEQ_LEN"] = LENS
    ins = {slot: [slot.lower()] for slot in shapes}
    outs = {out: "out"}
    if op_type in ("lstm", "lstmp"):
        # the recurrence's other output is compared too
        outs["Cell" if out != "Cell" else "Hidden"] = "other"
    ref_out, _g = both(op_type, feed, ins, outs, attrs)[0]
    feed["cot"] = _rand(rs, *ref_out[out].shape)
    ref, port = both(op_type, feed, ins, outs, attrs, loss_out=out,
                     wrt=[s.lower() for s in shapes])
    assert_same(ref, port, rtol=1e-5, atol=1e-5)


def test_adagrad_op_matches_reference():
    """Three ``adagrad`` updates in place (Param and Moment) equal the
    reference's within 1e-6."""
    rs = np.random.RandomState(6)
    feed = {"p": _rand(rs, 4, 3), "g": _rand(rs, 4, 3),
            "m": np.abs(_rand(rs, 4, 3)), "lr": np.array([0.1], np.float32)}
    got = []
    for fl in (jfluid, tfluid):
        main = fl.Program()
        with fl.program_guard(main, fl.Program()):
            block = main.global_block()
            v = {n: block.create_var(name=n, shape=list(a.shape),
                                     dtype="float32", persistable=n in "pm")
                 for n, a in feed.items()}
            block.append_op(
                type="adagrad",
                inputs={"Param": [v["p"]], "Grad": [v["g"]],
                        "Moment": [v["m"]], "LearningRate": [v["lr"]]},
                outputs={"ParamOut": [v["p"]], "MomentOut": [v["m"]]},
                attrs={"epsilon": 1e-6})
        exe = fl.Executor(fl.CPUPlace())
        scope = fl.Scope() if fl is tfluid else fl.core.Scope()
        runs = []
        for _ in range(3):
            runs.append([np.asarray(a) for a in exe.run(
                main, feed=dict(feed, p=runs[-1][0], m=runs[-1][1])
                if runs else feed, fetch_list=["p", "m"], scope=scope)])
        got.append(runs)
    for r, t in zip(*got):
        for a, b in zip(r, t):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)


def test_gather_tree_matches_reference_and_numpy():
    """``gather_tree`` over [batch 2, T 6, beam 3] equals the reference's
    and a numpy backtrack exactly."""
    rs = np.random.RandomState(7)
    ids = rs.randint(0, 9, (2, 6, 3)).astype(np.int64)
    parents = rs.randint(0, 3, (2, 6, 3)).astype(np.int64)
    (ro, _), (po, _) = both("gather_tree", {"ids": ids, "parents": parents},
                            {"Ids": ["ids"], "Parents": ["parents"]},
                            {"Out": "out"})
    want = np.zeros_like(ids)
    for b in range(2):
        for k in range(3):
            beam = k
            for t in range(5, -1, -1):
                want[b, t, k] = ids[b, t, beam]
                beam = parents[b, t, beam]
    np.testing.assert_array_equal(ro["Out"], want)
    np.testing.assert_array_equal(po["Out"], want)


# ---------------------------------------------------------------------------
# programs: the layers over the ops, op for op and value for value
# ---------------------------------------------------------------------------
def _desc(main):
    return [(o.type, {k: list(v) for k, v in o.inputs.items()},
             {k: list(v) for k, v in o.outputs.items()})
            for b in main.blocks for o in b.ops]


def _lod(fl, arr, lens):
    t = fl.core.LoDTensor()
    t.set(arr, fl.CPUPlace())
    t.set_recursive_sequence_lengths([list(lens)])
    return t


def run_programs(build, feed, grads=True, steps=1, seed=13):
    """``build(fl)`` -> (main, startup, [fetch vars]) in each package,
    under ``unique_name.guard()``; asserts the two descs are op for op
    the same (types, slots and var names, sub-blocks included), copies
    the reference's startup persistables into the port's scope, runs
    both ``steps`` times on ``feed(fl)`` and returns ([reference
    fetches], [port fetches]) of the last run: the fetch vars, then the
    grads of every parameter with ``grads``."""
    out, descs, arrays = [], [], None
    for fl in (jfluid, tfluid):
        main, startup = fl.Program(), fl.Program()
        main.random_seed = startup.random_seed = seed
        with fl.unique_name.guard(), fl.program_guard(main, startup):
            fetch = list(build(fl))
        descs.append(_desc(main))
        names = [f.name for f in fetch]
        if grads:
            names += [p.name + "@GRAD" for p in main.all_parameters()
                      if p.trainable]
        exe = fl.Executor(fl.CPUPlace())
        if fl is jfluid:
            scope = fl.core.Scope()
            exe.run(startup, scope=scope)
            arrays = {v.name: np.array(scope.get(v.name))
                      for v in main.list_vars()
                      if v.persistable and scope.get(v.name) is not None}
        else:
            scope = fl.Scope()
            exe.run(startup, scope=scope)
            fl.load_program_scope(main, scope, arrays)
        for _ in range(steps):
            got = exe.run(main, feed=feed(fl), fetch_list=names,
                          scope=scope)
        out.append([np.asarray(g) for g in got])
    assert descs[1] == descs[0]
    return out


def assert_close(ref, port, rtol, atol):
    for i, (r, p) in enumerate(zip(ref, port)):
        np.testing.assert_allclose(p, r, rtol=rtol, atol=atol,
                                   err_msg="fetch %d" % i)


def _loss_of(fl, *outs):
    return fl.layers.mean(fl.layers.sums(
        [fl.layers.reduce_mean(o) for o in outs]))


def test_static_rnn_matches_reference():
    """``StaticRNN`` (fc over the step input and the memory, tanh) over
    [3, 4, 5]: outputs and every grad within 1e-5 of the reference's."""
    xb = np.random.RandomState(0).rand(3, 4, 5).astype(np.float32)

    def build(fl):
        x = fl.layers.data(name="x", shape=[4, 5], dtype="float32")
        x.stop_gradient = False
        rnn = fl.layers.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            prev = rnn.memory(shape=[6], value=0.0)
            h = fl.layers.fc(input=[xt, prev], size=6, act="tanh")
            rnn.update_memory(prev, h)
            rnn.output(h)
        out = rnn()
        loss = _loss_of(fl, out)
        fl.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return [loss, out]

    ref, port = run_programs(build, lambda fl: {"x": xb})
    assert_close(ref, port, 1e-5, 1e-5)


def test_dynamic_rnn_masks_lengths_as_the_reference():
    """``DynamicRNN`` over a LoD feed (lengths 5, 2, 3 of 5): steps past a
    sequence's end carry the memory and emit zeros; outputs, the last
    step's pool and every grad within 1e-5 of the reference's."""
    xb = np.random.RandomState(1).rand(3, 5, 4).astype(np.float32)
    lens = [5, 2, 3]

    def build(fl):
        x = fl.layers.data(name="x", shape=[5, 4], dtype="float32",
                           lod_level=1)
        drnn = fl.layers.DynamicRNN()
        with drnn.block():
            xt = drnn.step_input(x)
            prev = drnn.memory(shape=[4], value=0.0)
            h = fl.layers.fc(input=[xt, prev], size=4, act="tanh")
            drnn.update_memory(prev, h)
            drnn.output(h)
        out = drnn()
        last = fl.layers.sequence_pool(out, pool_type="last")
        loss = _loss_of(fl, last)
        fl.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return [loss, out, last]

    ref, port = run_programs(build, lambda fl: {"x": _lod(fl, xb, lens)})
    assert_close(ref, port, 1e-5, 1e-5)
    for b, n in enumerate(lens):
        assert np.all(port[1][b, n:] == 0.0)


def test_ifelse_matches_reference():
    """``IfElse`` picks each row's branch by the mask; values and the
    grads of both branches' parameters within 1e-5 of the reference's."""
    xb = np.array([[0.1, 0.1, 0.1], [0.9, 0.9, 0.9], [0.2, 0.3, 0.1]],
                  np.float32)

    def build(fl):
        x = fl.layers.data(name="x", shape=[3], dtype="float32")
        limit = fl.layers.fill_constant(shape=[1], dtype="float32",
                                        value=0.5)
        cond = fl.layers.less_than(
            fl.layers.reduce_mean(x, dim=[1], keep_dim=True), limit)
        ie = fl.layers.IfElse(cond)
        with ie.true_block():
            ie.output(fl.layers.fc(ie.input(x), size=2, act="tanh"))
        with ie.false_block():
            ie.output(fl.layers.scale(fl.layers.fc(ie.input(x), size=2),
                                      scale=-1.0))
        (out,) = ie()
        loss = _loss_of(fl, out)
        fl.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return [loss, out]

    ref, port = run_programs(build, lambda fl: {"x": xb})
    assert_close(ref, port, 1e-5, 1e-5)


RNN_CASES = {
    # name: (cell, is_reverse, with lengths, time_major)
    "lstm": ("lstm", False, False, False),
    "lstm_reverse_lengths": ("lstm", True, True, False),
    "gru_lengths": ("gru", False, True, False),
    "gru_reverse_time_major": ("gru", True, False, True),
}


@pytest.mark.parametrize("case", sorted(RNN_CASES))
def test_rnn_with_cells_matches_reference(case):
    """``rnn`` over ``LSTMCell`` / ``GRUCell`` (one ``recurrent`` op), both
    directions, with ``sequence_length`` masking and time-major input:
    outputs, final states and every grad within 1e-5 of the
    reference's ``lax.scan``."""
    cell_kind, rev, with_lens, time_major = RNN_CASES[case]
    rs = np.random.RandomState(2)
    shape = (6, 3, 4) if time_major else (3, 6, 4)
    xb = rs.rand(*shape).astype(np.float32)
    sl = np.array([6, 3, 4], np.int32)

    def build(fl):
        x = fl.layers.data(name="x", shape=list(shape[1:]),
                           dtype="float32")
        L = fl.layers
        cell = L.LSTMCell(hidden_size=5) if cell_kind == "lstm" else \
            L.GRUCell(hidden_size=5)
        seq = None
        if with_lens:
            seq = L.data(name="sl", shape=[1], dtype="int32")
        outs, final = L.rnn(cell, x, sequence_length=seq,
                            time_major=time_major, is_reverse=rev)
        finals = final if isinstance(final, (list, tuple)) else [final]
        loss = _loss_of(fl, outs, *finals)
        fl.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return [loss, outs] + list(finals)

    def feed(fl):
        return dict({"x": xb}, **({"sl": sl} if with_lens else {}))

    ref, port = run_programs(build, feed)
    assert_close(ref, port, 1e-5, 1e-5)


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_contrib_basic_rnn_matches_reference(kind):
    """``basic_lstm`` / ``basic_gru``: 2 layers, bidirectional, dropout 0,
    with initial states and lengths; outputs, last states and every grad
    within 1e-5 of the reference's."""
    rs = np.random.RandomState(3)
    xb = rs.rand(3, 5, 4).astype(np.float32)
    h0 = rs.rand(4, 3, 6).astype(np.float32)
    c0 = rs.rand(4, 3, 6).astype(np.float32)
    sl = np.array([5, 2, 4], np.int32)

    def build(fl):
        L = fl.layers
        x = L.data(name="x", shape=[5, 4], dtype="float32")
        ih = L.data(name="h0", shape=[3, 6], dtype="float32",
                    append_batch_size=False)
        seq = L.data(name="sl", shape=[1], dtype="int32")
        ih.shape = (4, 3, 6)
        if kind == "lstm":
            ic = L.data(name="c0", shape=[3, 6], dtype="float32",
                        append_batch_size=False)
            ic.shape = (4, 3, 6)
            out, last_h, last_c = fl.contrib.basic_lstm(
                x, ih, ic, 6, num_layers=2, sequence_length=seq,
                bidirectional=True)
            lasts = [last_h, last_c]
        else:
            out, last_h = fl.contrib.basic_gru(
                x, ih, 6, num_layers=2, sequence_length=seq,
                bidirectional=True)
            lasts = [last_h]
        loss = _loss_of(fl, out, *lasts)
        fl.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return [loss, out] + lasts

    ref, port = run_programs(
        build, lambda fl: {"x": xb, "h0": h0.reshape(4, 3, 6),
                           "c0": c0.reshape(4, 3, 6), "sl": sl})
    assert_close(ref, port, 1e-5, 1e-5)


def _beam_program(fl, V=12, H=8, beam=3, steps=6):
    L = fl.layers
    enc_h = L.data(name="ench", shape=[H], dtype="float32")
    enc_c = L.data(name="encc", shape=[H], dtype="float32")
    cell = L.LSTMCell(hidden_size=H, name="dec_lstm")
    dec = L.BeamSearchDecoder(
        cell, start_token=0, end_token=1, beam_size=beam,
        embedding_fn=lambda ids: L.embedding(
            ids, size=[V, H], param_attr=fl.ParamAttr(name="t_emb")),
        output_fn=lambda h: L.fc(h, size=V, name="p", bias_attr=False))
    outputs, states = L.dynamic_decode(dec, inits=[enc_h, enc_c],
                                       max_step_num=steps)
    return outputs, states


def test_beam_search_matches_reference_and_numpy_backtrack():
    """``BeamSearchDecoder`` over one ``LSTMCell`` + ``dynamic_decode``
    (beam 3, 6 steps, 2 sources): the backtracked beams and the final
    log-probs equal the reference's; the op reads "every beam finished"
    on the host once a step and once before the first
    (``control_flow_host_syncs``)."""
    rs = np.random.RandomState(4)
    feed = {"ench": rs.rand(2, 8).astype(np.float32),
            "encc": rs.rand(2, 8).astype(np.float32)}

    def build(fl):
        outputs, states = _beam_program(fl)
        return [outputs, states[-1]]

    s0 = tprofiler.get_counter("control_flow_host_syncs")
    ref, port = run_programs(build, lambda fl: feed, grads=False)
    syncs = tprofiler.get_counter("control_flow_host_syncs") - s0
    np.testing.assert_array_equal(port[0], ref[0])
    np.testing.assert_allclose(port[1], ref[1], rtol=1e-5, atol=1e-5)
    assert port[0].shape == (2, 6, 3)
    assert 2 <= syncs <= 7


def test_beam_search_stops_early_and_fills_the_tail():
    """When every beam has emitted ``end_token`` the loop stops, and the
    steps it did not run read ``end_token`` with each beam's own
    ancestry, as the reference's pre-filled buffers. The end token's
    logit column is biased far up: step 1 takes it and the next two
    tokens from beam 0, step 2 ends the other two beams, and the loop
    reads its flag 3 times (before step 1 and after each step)."""
    feed = {"ench": np.ones((2, 8), np.float32),
            "encc": np.ones((2, 8), np.float32)}

    def build(fl):
        outputs, _states = _beam_program(fl)
        return [outputs]

    for fl in (jfluid, tfluid):
        main, startup = fl.Program(), fl.Program()
        with fl.unique_name.guard(), fl.program_guard(main, startup):
            (outputs,) = build(fl)
        exe = fl.Executor(fl.CPUPlace())
        scope = fl.Scope() if fl is tfluid else fl.core.Scope()
        exe.run(startup, scope=scope)
        w = np.zeros((8, 12), np.float32)
        w[:, 1] = 50.0
        if fl is tfluid:
            scope.set("p.w_0", torch.from_numpy(w))
        else:
            scope.var("p.w_0").get_tensor().set(w, fl.CPUPlace())
        s0 = tprofiler.get_counter("control_flow_host_syncs")
        (res,) = exe.run(main, feed=feed, fetch_list=[outputs], scope=scope)
        res = np.asarray(res)
        assert np.all(res[:, 0, 0] == 1) and np.all(res[:, 1:] == 1), res
        if fl is tfluid:
            assert tprofiler.get_counter("control_flow_host_syncs") - s0 == 3
            np.testing.assert_array_equal(res, ref)
        ref = res


def test_imdb_stacked_lstm_program_matches_reference():
    """The book's ``stacked_lstm_net`` at tiny widths (emb 6, hid 8, 3
    stacked ``dynamic_lstm`` alternating direction, max pools, softmax,
    ``cross_entropy``, Adagrad), fed full-length sequences: the loss and
    every grad over two steps within 1e-5 of the reference's. (With
    ragged lengths the reference's LSTMs run over the padding: its
    length companion stops at the embedding; ROADMAP C.)"""
    rs = np.random.RandomState(5)
    words = rs.randint(0, 30, (4, 6, 1)).astype(np.int64)
    label = rs.randint(0, 2, (4, 1)).astype(np.int64)

    def build(fl):
        return [imdb_stacked_lstm(fl, vocab=30, emb=6, hid=8, seq=6)[0]]

    ref, port = run_programs(
        build, lambda fl: {"words": _lod(fl, words, [6] * 4),
                           "label": label}, steps=2)
    assert_close(ref, port, 1e-5, 1e-5)


def imdb_stacked_lstm(fl, vocab, emb, hid, seq, stacked=3, lr=0.002):
    """(avg cost, prediction) of the PaddlePaddle book's
    ``stacked_lstm_net`` (understand_sentiment), on the padded LoD feed
    ``words`` [N, seq, 1]: fc layers flatten 2 dims, as the padded
    representation needs."""
    L = fl.layers
    data = L.data(name="words", shape=[seq, 1], dtype="int64", lod_level=1)
    label = L.data(name="label", shape=[1], dtype="int64")
    e = L.embedding(input=data, size=[vocab, emb])
    fc1 = L.fc(input=e, size=hid * 4, num_flatten_dims=2)
    lstm1, _ = L.dynamic_lstm(input=fc1, size=hid * 4)
    inputs = [fc1, lstm1]
    for i in range(2, stacked + 1):
        fc = L.fc(input=inputs, size=hid * 4, num_flatten_dims=2)
        lstm, _ = L.dynamic_lstm(input=fc, size=hid * 4,
                                 is_reverse=(i % 2) == 0)
        inputs = [fc, lstm]
    fc_last = L.sequence_pool(input=inputs[0], pool_type="max")
    lstm_last = L.sequence_pool(input=inputs[1], pool_type="max")
    prediction = L.fc(input=[fc_last, lstm_last], size=2, act="softmax")
    avg_cost = L.mean(L.cross_entropy(input=prediction, label=label))
    fl.optimizer.Adagrad(learning_rate=lr).minimize(avg_cost)
    return avg_cost, prediction


# ---------------------------------------------------------------------------
# the LoD feed path
# ---------------------------------------------------------------------------
def test_create_lod_tensor_matches_reference():
    """``create_lod_tensor`` from a list, an array and a LoDTensor, and
    ``create_random_int_lodtensor``: the same data, LoD and lengths as
    the reference's."""
    for fl in (jfluid, tfluid):
        t = fl.create_lod_tensor([[1, 2], [3, 4, 5]], [[2, 3]],
                                 fl.CPUPlace())
        np.testing.assert_array_equal(np.asarray(t.numpy()),
                                      np.arange(1, 6).reshape(5, 1))
        assert t.recursive_sequence_lengths() == [[2, 3]]
        assert t.lod() == [[0, 2, 5]]
        a = fl.create_lod_tensor(np.arange(10).reshape(5, 2), [[2, 3]],
                                 fl.CPUPlace())
        b = fl.create_lod_tensor(a, [[4, 1]], fl.CPUPlace())
        assert b.recursive_sequence_lengths() == [[4, 1]]
        np.random.seed(0)
        r = fl.create_random_int_lodtensor([[2, 3]], [3], fl.CPUPlace(),
                                           0, 9)
        assert list(r.shape()) == [5, 3]
        with pytest.raises(AssertionError):
            fl.create_lod_tensor(np.zeros((4, 1)), [[2, 3]], fl.CPUPlace())
    np.random.seed(0)
    jr = jfluid.create_random_int_lodtensor([[2, 3]], [3], jfluid.CPUPlace(),
                                            0, 9)
    np.random.seed(0)
    tr = tfluid.create_random_int_lodtensor([[2, 3]], [3], tfluid.CPUPlace(),
                                            0, 9)
    np.testing.assert_array_equal(tr.numpy(), jr.numpy())


def test_data_feeder_output_matches_reference_and_pads_in_the_executor():
    """``DataFeeder`` makes the reference's LoDTensors (rows back to back,
    lengths as LoD; dense slots reshaped); the port's Executor pads them
    to [batch, max_len, ...] with zeros and gives the lengths as the
    int32 ``@SEQ_LEN`` companion, which the reference's Executor would
    feed beside its padded values (``executor.py:1375-1400``)."""
    samples = [([1, 2, 3], [0]), ([4, 5], [1]), ([6], [1])]
    feeds = {}
    for fl in (jfluid, tfluid):
        main = fl.Program()
        with fl.program_guard(main, fl.Program()):
            w = fl.layers.data(name="w", shape=[1], dtype="int64",
                               lod_level=1)
            lab = fl.layers.data(name="l", shape=[1], dtype="int64")
        feeds[fl] = fl.DataFeeder([w, lab], fl.CPUPlace()).feed(samples)
    for name in ("w", "l"):
        j, t = feeds[jfluid][name], feeds[tfluid][name]
        np.testing.assert_array_equal(t.numpy(), np.asarray(j.numpy()))
        assert t.recursive_sequence_lengths() == \
            j.recursive_sequence_lengths()
    main = tfluid.Program()
    with tfluid.program_guard(main, tfluid.Program()):
        w = tfluid.layers.data(name="w", shape=[1], dtype="int64",
                               lod_level=1)
        out = tfluid.layers.scale(tfluid.layers.cast(w, "float32"), 1.0)
    exe = tfluid.Executor(tfluid.CPUPlace())
    got = exe.run(main, feed={"w": feeds[tfluid]["w"]},
                  fetch_list=[out, "w@SEQ_LEN"], scope=tfluid.Scope())
    np.testing.assert_array_equal(
        got[0], np.array([[1, 2, 3], [4, 5, 0], [6, 0, 0]], np.float32))
    assert got[1].dtype == np.int32
    np.testing.assert_array_equal(got[1], [3, 2, 1])


def test_lod_feed_lengths_are_read_on_the_host():
    """A LoD feed's lengths enter the run as host arrays: an op reading
    them through ``LowerCtx.host_ints`` gets the feed's numbers without
    reading the tensor."""
    t = tfluid.create_lod_tensor(np.arange(5, dtype=np.int64).reshape(5, 1),
                                 [[2, 3]], tfluid.CPUPlace())
    seen = {}

    def spy(ctx, op_):
        lens = ctx.get("x@SEQ_LEN")
        fed = ctx.host_feeds["x@SEQ_LEN"]
        seen["same"] = fed[0] is lens
        seen["host"] = [int(v) for v in fed[1]]

    tregistry.register_op("_lod_host_spy", lower=spy)
    try:
        main = tfluid.Program()
        with tfluid.program_guard(main, tfluid.Program()):
            x = tfluid.layers.data(name="x", shape=[-1, 1], dtype="int64",
                                   lod_level=1)
            main.global_block().append_op(type="_lod_host_spy",
                                          inputs={"X": [x]}, outputs={})
        tfluid.Executor(tfluid.CPUPlace()).run(main, feed={"x": t})
    finally:
        tregistry._REGISTRY.pop("_lod_host_spy", None)
    assert seen == {"same": True, "host": [2, 3]}


def test_lod_feed_layout_follows_the_program():
    """The program, not the data, decides whether a LoD feed is padded:
    rows back to back (a rank below the declared var's) are padded even
    when every sequence has length 1, so the stacked-LSTM program's
    ``words`` [-1, -1, 1] comes in as [n, 1, 1], and its prediction
    equals that of the same reviews padded 3 steps wide; a feed of the
    declared rank is taken as padded and must be [n, >= max_len, ...]."""
    rs = np.random.RandomState(9)
    samples = [([int(rs.randint(0, 30))], [int(rs.randint(0, 2))])
               for _ in range(6)]
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 7
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        _cost, pred = imdb_stacked_lstm(tfluid, vocab=30, emb=6, hid=8,
                                        seq=-1)
        words = main.global_block().var("words")
        label = main.global_block().var("label")
    feed = tfluid.DataFeeder([words, label], tfluid.CPUPlace()).feed(samples)
    assert feed["words"].shape() == [6]
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    infer = main.clone(for_test=True)
    fed, p1 = exe.run(infer, feed=feed, fetch_list=["words", pred],
                      scope=scope)
    ids = np.array([s[0] for s in samples], np.int64)
    np.testing.assert_array_equal(fed, ids.reshape(6, 1, 1))
    wide = np.zeros((6, 3, 1), np.int64)
    wide[:, 0] = ids
    lod = tfluid.core.LoDTensor(wide)
    lod.set_recursive_sequence_lengths([[1] * 6])
    p2 = exe.run(infer, feed={"words": lod, "label": feed["label"]},
                 fetch_list=[pred], scope=scope)[0]
    np.testing.assert_allclose(p2, p1, rtol=1e-5, atol=1e-6)
    # a var declared [-1, 1] takes [n, T] as its padded batch
    main = tfluid.Program()
    with tfluid.program_guard(main, tfluid.Program()):
        w = tfluid.layers.data(name="w", shape=[1], dtype="int64",
                               lod_level=1)
        out = tfluid.layers.scale(tfluid.layers.cast(w, "float32"), 1.0)
    ones = tfluid.DataFeeder([w], tfluid.CPUPlace()).feed(
        [([5],), ([6],), ([7],)])
    got = exe.run(main, feed=ones, fetch_list=[out], scope=tfluid.Scope())
    np.testing.assert_array_equal(got[0], [[5], [6], [7]])
    flat = tfluid.create_lod_tensor(np.arange(5, dtype=np.int64).reshape(
        5, 1), [[2, 3]], tfluid.CPUPlace())
    with pytest.raises(ValueError, match="padded batch"):
        exe.run(main, feed={"w": flat}, fetch_list=[out],
                scope=tfluid.Scope())


def _plain_lstm(x, w, b, reverse):
    """One ``dynamic_lstm`` over one sequence's rows x [L, 4H] in fp64,
    from Paddle's lstm op documentation: gates [candidate, input, forget,
    output] of x_t + h_{t-1} W + b, peepholes W_ic, W_fc on c_{t-1} and
    W_oc on c_t, sigmoid gates, tanh cell and candidate."""
    H = w.shape[0]
    b = b.reshape(-1)
    gb, wic, wfc, woc = b[:4 * H], b[4 * H:5 * H], b[5 * H:6 * H], b[6 * H:]
    h = c = np.zeros(H)
    out = [None] * len(x)
    for t in (reversed(range(len(x))) if reverse else range(len(x))):
        g = x[t] + h @ w + gb
        i = 1 / (1 + np.exp(-(g[H:2 * H] + c * wic)))
        f = 1 / (1 + np.exp(-(g[2 * H:3 * H] + c * wfc)))
        c = f * c + i * np.tanh(g[:H])
        h = np.tanh(c) / (1 + np.exp(-(g[3 * H:] + c * woc)))
        out[t] = h
    return np.stack(out)


def test_ragged_stacked_lstm_matches_a_plain_per_review_loop():
    """The tiny stacked-LSTM program fed ragged reviews (lengths 1–9) by
    ``DataFeeder``: its predictions within 1e-6 of a plain fp64 loop over
    each review's own rows (embedding, fc, the LSTMs alternating
    direction, the max over the review's rows, softmax fc), which knows
    nothing of padding or lengths. The same loop over the reviews padded
    with id 0 to 9 rows is O(0.1) away, so an unmasked pad shows."""
    rs = np.random.RandomState(12)
    lens = [9, 1, 4, 2, 7, 1, 3]
    samples = [(list(rs.randint(0, 30, n)), [int(rs.randint(0, 2))])
               for n in lens]
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 7
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        _cost, pred = imdb_stacked_lstm(tfluid, vocab=30, emb=6, hid=8,
                                        seq=-1)
        feed_vars = [main.global_block().var(n) for n in ("words", "label")]
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    got = exe.run(main.clone(for_test=True),
                  feed=tfluid.DataFeeder(feed_vars, tfluid.CPUPlace()).feed(
                      samples), fetch_list=[pred], scope=scope)[0]
    p = {q.name: np.asarray(scope.get(q.name), np.float64)
         for q in main.all_parameters()}

    def plain(reviews):
        out = []
        for ids in reviews:
            fc = p["embedding_0.w_0"][ids] @ p["fc_0.w_0"] + p["fc_0.b_0"]
            h = _plain_lstm(fc, p["dynamic_lstm_0.w_0"],
                            p["dynamic_lstm_0.b_0"], False)
            for i in (1, 2):
                fc = (fc @ p["fc_%d.w_0" % i] + h @ p["fc_%d.w_1" % i]
                      + p["fc_%d.b_0" % i])
                h = _plain_lstm(fc, p["dynamic_lstm_%d.w_0" % i],
                                p["dynamic_lstm_%d.b_0" % i], i == 1)
            z = (fc.max(0) @ p["fc_3.w_0"] + h.max(0) @ p["fc_3.w_1"]
                 + p["fc_3.b_0"])
            out.append(np.exp(z - z.max()) / np.exp(z - z.max()).sum())
        return np.stack(out)

    np.testing.assert_allclose(got, plain([s[0] for s in samples]),
                               rtol=0, atol=1e-6)
    unmasked = plain([s[0] + [0] * (9 - len(s[0])) for s in samples])
    assert np.abs(got - unmasked).max() > 1e-2


def test_imdb_stacked_lstm_learns_from_data_feeder_batches():
    """The tiny stacked-LSTM program fed by ``DataFeeder`` from ragged
    reviews (lengths 3–9) through the port's Executor: the lengths reach
    every LSTM and pool (padding changes nothing), and 20 Adagrad steps
    at lr 0.05 on one batch bring the loss down."""
    rs = np.random.RandomState(6)
    lens = rs.randint(3, 10, 8)
    samples = [(list(rs.randint(0, 30, n)), [int(n % 2)]) for n in lens]
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 7
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        cost, pred = imdb_stacked_lstm(tfluid, vocab=30, emb=6, hid=8,
                                       seq=-1, lr=0.05)
        words = main.global_block().var("words")
        label = main.global_block().var("label")
    feeder = tfluid.DataFeeder([words, label], tfluid.CPUPlace())
    feed = feeder.feed(samples)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    infer = main.clone(for_test=True)
    p1 = exe.run(infer, feed=feed, fetch_list=[pred], scope=scope)[0]
    # the same reviews padded 5 steps further give the same prediction
    wide = np.zeros((8, int(lens.max()) + 5), np.int64)
    for i, (ids, _l) in enumerate(samples):
        wide[i, :len(ids)] = ids
    lod = tfluid.core.LoDTensor(wide.reshape(8, -1, 1))
    lod.set_recursive_sequence_lengths([[int(n) for n in lens]])
    p2 = exe.run(infer, feed={"words": lod, "label": feed["label"]},
                 fetch_list=[pred], scope=scope)[0]
    np.testing.assert_allclose(p2, p1, rtol=1e-5, atol=1e-6)
    losses = [float(exe.run(main, feed=feed, fetch_list=[cost],
                            scope=scope)[0]) for _ in range(20)]
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.05, losses


def test_multilevel_sequence_expand_and_lod_reset_by_tensor():
    """``sequence_expand`` by the outer level of a 2-level Y (lengths
    [2, 1] of [3, 1, 2]): its output equal to the reference's and its
    grad to the sums of the cotangent's rows by group (the reference's
    generic-grad replay loses the outer level and raises; ROADMAP C);
    ``lod_reset`` from a Y of offsets with its grad within 1e-6 of the
    reference's."""
    rs = np.random.RandomState(8)
    feed = {"x": _rand(rs, 2, 4), "y": _rand(rs, 3, 3, 4),
            "y@SEQ_LEN": np.array([3, 1, 2], np.int32),
            "y@SEQ_LEN@L0": np.array([2, 1], np.int32)}
    (ro, _), (po, _) = both("sequence_expand", feed,
                            {"X": ["x"], "Y": ["y"]}, {"Out": "out"},
                            {"ref_level": 0})
    np.testing.assert_array_equal(po["Out"], ro["Out"])
    np.testing.assert_array_equal(po["Out"], feed["x"][[0, 0, 1]])
    feed["cot"] = _rand(rs, 3, 4)
    _o, grads = run_op(tfluid, "sequence_expand", feed,
                       {"X": ["x"], "Y": ["y"]}, {"Out": "out"},
                       {"ref_level": 0}, loss_out="Out", wrt=["x"])
    np.testing.assert_allclose(
        grads["x"], np.stack([feed["cot"][:2].sum(0), feed["cot"][2]]),
        rtol=1e-6, atol=1e-6)
    feed = {"x": _rand(rs, 3, 5, 2),
            "offs": np.array([0, 2, 5, 6], np.int64)}
    feed["cot"] = _rand(rs, 3, 5, 2)
    ref, port = both("lod_reset", feed, {"X": ["x"], "Y": ["offs"]},
                     {"Out": "out"}, loss_out="Out", wrt=["x"])
    assert_same(ref, port, rtol=1e-6, atol=1e-6)


LAYER_CASES = ["dynamic_lstmp", "dynamic_gru", "gru_unit", "lstm_unit",
               "sequence_conv_layers"]


@pytest.mark.parametrize("case", LAYER_CASES)
def test_recurrent_layers_build_and_run_as_the_reference(case):
    """``dynamic_lstmp``, ``dynamic_gru``, ``gru_unit``, ``lstm_unit``
    and the sequence layers with parameters (``sequence_conv``,
    ``row_conv``) on a ragged float LoD feed (each ragged layer reads the
    fed var, whose lengths the reference's generic-grad replay also
    sees; ROADMAP C): the reference's desc op for op, and the loss and
    every gradient within 1e-5 of its."""
    rs = np.random.RandomState(9)
    width = {"dynamic_lstmp": 16, "dynamic_gru": 12}.get(case, 6)
    xb = rs.rand(3, 5, width).astype(np.float32)
    lens = [5, 2, 4]

    def build(fl):
        L = fl.layers
        x = L.data(name="x", shape=[5, width], dtype="float32",
                   lod_level=1)
        x.stop_gradient = False
        if case == "dynamic_lstmp":
            proj, cell = L.dynamic_lstmp(x, size=16, proj_size=3)
            outs = [proj, cell]
        elif case == "dynamic_gru":
            outs = [L.dynamic_gru(x, size=4, is_reverse=True)]
        elif case == "gru_unit":
            h0 = L.fc(L.sequence_pool(x, "first"), 4)
            h, r, g = L.gru_unit(L.fc(L.sequence_pool(x, "last"), 12),
                                 h0, size=12)
            outs = [h, r, g]
        elif case == "lstm_unit":
            s = L.sequence_pool(x, "average")
            h0 = L.fc(s, 4)
            c0 = L.fc(s, 4)
            outs = list(L.lstm_unit(s, h0, c0, forget_bias=0.5))
        else:
            outs = [L.sequence_conv(x, num_filters=4, filter_size=3,
                                    act="tanh"),
                    L.row_conv(x, future_context_size=2)]
        loss = _loss_of(fl, *outs)
        fl.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return [loss] + outs

    ref, port = run_programs(build, lambda fl: {"x": _lod(fl, xb, lens)})
    assert_close(ref, port, 1e-5, 1e-5)


NET_CASES = ["simple_img_conv_pool", "img_conv_group", "glu",
             "scaled_dot_product_attention", "sequence_conv_pool"]


@pytest.mark.parametrize("net", NET_CASES)
def test_nets_build_and_run_as_the_reference(net):
    """Each of ``fluid.nets`` builds the reference's desc op for op, and
    its loss and every gradient come within 1e-5 of the reference's
    (``img_conv_group`` with batch norm, dropout 0)."""
    rs = np.random.RandomState(10)
    img = rs.rand(2, 3, 8, 8).astype(np.float32)
    seq = rs.rand(2, 5, 8).astype(np.float32)

    def build(fl):
        L, nets = fl.layers, fl.nets
        if net in ("simple_img_conv_pool", "img_conv_group"):
            x = L.data(name="img", shape=[3, 8, 8], dtype="float32")
            if net == "simple_img_conv_pool":
                out = nets.simple_img_conv_pool(
                    x, num_filters=4, filter_size=3, pool_size=2,
                    pool_stride=2, act="relu")
            else:
                out = nets.img_conv_group(
                    x, conv_num_filter=[4, 4], pool_size=2,
                    conv_act="relu", conv_with_batchnorm=True,
                    pool_stride=2)
        elif net == "glu":
            x = L.data(name="seq", shape=[5, 8], dtype="float32")
            out = nets.glu(x, dim=-1)
        elif net == "scaled_dot_product_attention":
            x = L.data(name="seq", shape=[5, 8], dtype="float32")
            q = L.fc(x, 8, num_flatten_dims=2)
            out = nets.scaled_dot_product_attention(q, x, x, num_heads=2)
        else:
            x = L.data(name="seq", shape=[5, 8], dtype="float32",
                       lod_level=1)
            out = nets.sequence_conv_pool(x, num_filters=4, filter_size=3)
        loss = _loss_of(fl, out)
        fl.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return [loss, out]

    def feed(fl):
        if net in ("simple_img_conv_pool", "img_conv_group"):
            return {"img": img}
        if net == "sequence_conv_pool":
            return {"seq": _lod(fl, seq, [5, 3])}
        return {"seq": seq}

    ref, port = run_programs(build, feed)
    assert_close(ref, port, 1e-5, 1e-5)
