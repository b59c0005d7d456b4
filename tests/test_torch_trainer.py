"""The port's training runtime (``fluid.trainer``,
``Executor.train_from_dataset``, ``checkpoint.CheckpointManager``,
``fluid.debugger``, the ``square`` and ``square_error_cost`` ops) held
against the JAX package on the CPU.

- ``train_from_dataset`` over the same MultiSlot files from the same
  parameters (the reference's startup scope, ``load_fluid_scope``) at
  dropout 0 gives the reference's losses and final parameters.
- A preempted and resumed port run is bit for bit an uninterrupted one,
  at dropout 0.1 (the manifest carries the scope's generator states).
- Checkpoints cross packages: each package's manager restores the
  other's, tensor for tensor, bit for bit.
- The checkpoint manager's hygiene (checksum, torn directories,
  retention, async errors, fallback, sharded restore) behaves as the
  reference's on the same scenario.

Values cross as numpy arrays; tolerances are stated at each comparison.
"""

import os
import signal

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import checkpoint as jcheckpoint
from paddle_tpu.fluid import dataset as jdataset
from paddle_tpu.fluid import debugger as jdebugger
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch import checkpoint as tcheckpoint
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.checkpoint import preempt as tpreempt
from paddle_tpu_torch.fluid import debugger as tdebugger
from paddle_tpu_torch.fluid import trainer as ttrainer
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.tools import train_worker as tw
from test_torch_cpu_math import pin_vector_math

pin_vector_math(2)  # 2 threads, vector math set up on one (see there)

T = 16
BATCH = 4
LR = 1e-3
VOCAB = 211


def _gpt_batches(n, seed):
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        mask = np.ones((BATCH, T, 1), np.float32)
        mask[1, 11 + i % 4:] = 0.0
        out.append({
            "ids": rs.randint(0, VOCAB, (BATCH, T, 1)).astype("int64"),
            "pos_ids": np.tile(np.arange(T).reshape(1, T, 1),
                               (BATCH, 1, 1)).astype("int64"),
            "input_mask": mask})
    return out


def _files(tmp_path, batches, per_file=3):
    d = tmp_path / "files"
    d.mkdir(exist_ok=True)
    for i in range(0, len(batches), per_file):
        tw.write_multislot(str(d / ("part-%05d.txt" % i)),
                           batches[i: i + per_file])
    return sorted(str(p) for p in d.iterdir())


def _cfg(mod, dropout):
    return mod.GPTConfig.tiny(use_flash_attention=True,
                              max_position_embeddings=T,
                              hidden_dropout=dropout,
                              attention_dropout=dropout)


class _ShapedQueueDataset(jdataset.QueueDataset):
    """The reference's QueueDataset with each dense slot batch given its
    var's declared shape, as the port's dataset gives it (data_feed.cc);
    the reference stacks [batch, count]."""

    def _stack_batch(self, slots):
        out = super()._stack_batch(slots)
        return [np.asarray(a).reshape([-1] + list(v.shape[1:]))
                for a, v in zip(out, self.use_var)]


def _recording(fluid_mod, place):
    class Recording(fluid_mod.Executor):
        def run(self, *args, **kwargs):
            outs = super().run(*args, **kwargs)
            if outs:
                self.losses.append(float(np.asarray(outs[0]).reshape(-1)[0]))
            return outs

    exe = Recording(place)
    exe.losses = []
    return exe


def _reference_train(files):
    """The reference's train_from_dataset: (startup arrays, losses, the
    final persistables)."""
    with jfluid.unique_name.guard():
        main, startup, feeds, loss = jgpt.build_gpt_lm_train(
            _cfg(jgpt, 0.0), T, learning_rate=LR)
    exe = _recording(jfluid, jfluid.CPUPlace())
    scope = jfluid.core.Scope()
    with jfluid.executor.scope_guard(scope):
        exe.run(startup)
    arrays = {n: np.array(scope.get(n)) for n in scope.local_var_names()
              if scope.get(n) is not None}
    exe.losses.clear()
    ds = _ShapedQueueDataset()
    ds.set_filelist(files)
    ds.set_batch_size(BATCH)
    ds.set_multislot([False, False, True], dense_slots=[True, True, True])
    ds.set_use_var(feeds)
    steps = exe.train_from_dataset(main, ds, scope=scope, fetch_list=[loss],
                                   print_period=0)
    final = {n: np.array(scope.get(n)) for n in arrays}
    return arrays, list(exe.losses), final, steps


def _port_build(dropout, arrays=None):
    with tfluid.unique_name.guard():
        main, startup, feeds, loss = tgpt.build_gpt_lm_train(
            _cfg(tgpt, dropout), T, learning_rate=LR)
    exe = _recording(tfluid, tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    exe.losses.clear()
    if arrays is not None:
        tfluid.load_program_scope(main, scope, {
            n: a for n, a in arrays.items()
            if n in {v.name for v in main.list_vars() if v.persistable}})
    else:
        tgpt.load_fluid_scope(scope, tgpt.init_fluid_params(
            _cfg(tgpt, dropout), 0))
    return main, feeds, loss, exe, scope


def _state(main, scope):
    return {v.name: scope.get(v.name).detach().clone()
            for v in main.list_vars()
            if v.persistable and isinstance(scope.get(v.name), torch.Tensor)}


# ---------------------------------------------------------------------------
# train_from_dataset against the reference
# ---------------------------------------------------------------------------
def test_train_from_dataset_matches_reference(tmp_path):
    """5 Adam steps of the tiny GPT through each package's
    ``train_from_dataset`` over the same MultiSlot files, from the
    reference's startup scope: losses within 1e-5 relative, every
    parameter and moment within 1e-5 relative norm. The k-projection
    biases are the exception: their exact gradient is 0 (softmax is
    shift-invariant), so Adam turns each side's rounding noise into
    lr-sized steps; they are held to an absolute 5·lr."""
    files = _files(tmp_path, _gpt_batches(5, 0))
    arrays, want_losses, want_final, want_steps = _reference_train(files)
    main, feeds, loss, exe, scope = _port_build(0.0, arrays)
    steps = exe.train_from_dataset(
        main, tw.gpt_dataset(feeds, files, BATCH), scope=scope,
        fetch_list=[loss], print_period=0)
    assert steps == want_steps == 5
    np.testing.assert_allclose(exe.losses, want_losses, rtol=1e-5)
    checked = 0
    for name, want in want_final.items():
        got = scope.get(name)
        if not isinstance(got, torch.Tensor) or want.dtype.kind != "f":
            continue
        got = got.numpy().astype(np.float64)
        want = want.astype(np.float64)
        if "att_k.b" in name or "att_k.b" in name.split("_moment")[0]:
            np.testing.assert_allclose(got, want, rtol=0, atol=5 * LR,
                                       err_msg=name)
            continue
        rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)
        assert rel <= 1e-5, (name, rel)
        checked += 1
    assert checked > 30


def test_train_from_dataset_stages_every_batch_and_counts_steps(tmp_path):
    from paddle_tpu_torch.fluid import profiler

    files = _files(tmp_path, _gpt_batches(4, 1), per_file=2)
    main, feeds, loss, exe, scope = _port_build(0.0)
    h2d0 = profiler.get_counter("io_pipeline_h2d_batches")
    fast0 = profiler.get_counter("executor_feed_fast_lane_steps")
    steps0 = profiler.get_counter("train_steps")
    steps = exe.train_from_dataset(main, tw.gpt_dataset(feeds, files, BATCH),
                                   scope=scope, fetch_list=[loss],
                                   print_period=0)
    assert steps == 4 and len(exe.losses) == 4
    assert profiler.get_counter("io_pipeline_h2d_batches") - h2d0 == 4
    assert profiler.get_counter("executor_feed_fast_lane_steps") - fast0 == 4
    assert profiler.get_counter("train_steps") - steps0 == 4


def test_trainer_factory_and_the_trainers_that_raise():
    f = ttrainer.TrainerFactory()
    assert isinstance(f.create_trainer({"trainer": "MultiTrainer"}),
                      ttrainer.MultiTrainer)
    assert isinstance(f.create_trainer({"trainer": "DistMultiTrainer"}),
                      ttrainer.DistMultiTrainer)
    assert isinstance(f.create_trainer({"trainer": "PipelineTrainer"}),
                      ttrainer.PipelineTrainer)
    main = tfluid.Program()
    exe = tfluid.Executor(tfluid.CPUPlace())
    with pytest.raises(ValueError, match="distributed_lookup_table"):
        ttrainer.DownpourTrainer().train(exe, main, object())
    with pytest.raises(ValueError, match="PipelineOptimizer"):
        ttrainer.PipelineTrainer().train(exe, main, object())
    with pytest.raises(NotImplementedError):
        exe.infer_from_dataset()
    with pytest.raises(ValueError, match="dataset"):
        exe.train_from_dataset(main, None)


# ---------------------------------------------------------------------------
# preemption and resume
# ---------------------------------------------------------------------------
def _train(files, ckpt_dir=None, on_step=None, before=None):
    main, feeds, loss, exe, scope = _port_build(0.1)
    mgr = tcheckpoint.CheckpointManager(ckpt_dir) if ckpt_dir else None
    if before is not None:
        before(main, exe, scope, mgr)
    steps = ttrainer.MultiTrainer().train(
        exe, main, tw.gpt_dataset(feeds, files, BATCH), scope=scope,
        fetch_list=[loss], print_period=0, on_step=on_step,
        ckpt_manager=mgr)
    if mgr is not None:
        mgr.close()
    return steps, list(exe.losses), _state(main, scope), scope


def test_preempted_resume_is_bit_for_bit_an_uninterrupted_run(tmp_path):
    """Dropout 0.1, an interval save every 2 steps over 8: run B stops at
    its own SIGTERM after step 4 with a final save; run C, in a fresh
    program and scope, restores step 4 (parameters, moments and the
    generator states) and replays the stream: its losses and final
    persistables are run A's, bit for bit."""
    files = _files(tmp_path, _gpt_batches(8, 2))
    tfluid.set_flags({"ckpt_save_interval_steps": 2})
    try:
        steps_a, losses_a, state_a, _ = _train(files, str(tmp_path / "a"))

        def sigterm(step):
            if step == 4:
                signal.raise_signal(signal.SIGTERM)

        try:
            steps_b, losses_b, _s, _ = _train(files, str(tmp_path / "b"),
                                              on_step=sigterm)
        finally:
            tpreempt._reset_for_tests()
        assert steps_b == 5 and losses_b == losses_a[:5]
        assert tcheckpoint.list_steps(str(tmp_path / "b")) == [1, 3, 4]
        steps_c, losses_c, state_c, _ = _train(files, str(tmp_path / "b"))
    finally:
        tfluid.set_flags({"ckpt_save_interval_steps": 0})
    assert steps_a == steps_c == 8
    assert losses_c == losses_a[5:]
    assert set(state_c) == set(state_a)
    for n in state_a:
        assert torch.equal(state_c[n], state_a[n]), n


def test_restore_sets_the_generator_states(tmp_path):
    files = _files(tmp_path, _gpt_batches(3, 3))
    _steps, _l, _s, scope = _train(files)
    mgr = tcheckpoint.CheckpointManager(str(tmp_path / "ck"))
    main, _f, _loss, exe, scope2 = _port_build(0.1)
    saved = scope.rng_states()
    mgr.save(2, main, scope=scope, async_=False)
    assert mgr.restore(main, scope=scope2, executor=exe) == 2
    got = scope2.rng_states()
    assert set(got) == set(saved) == {"cpu"}
    for k in saved:
        assert torch.equal(got[k][0], saved[k][0])
        assert torch.equal(got[k][1], saved[k][1])
    mgr.close()


@pytest.mark.parametrize("async_", [True, False], ids=["async", "sync"])
def test_a_save_times_its_crc32_and_fsync(tmp_path, async_):
    """Each committed save adds one sample to ``ckpt_save_ms`` and one to
    each of its parts, ``ckpt_crc32_ms`` and ``ckpt_fsync_ms``, and the
    parts fit inside the whole."""
    from paddle_tpu_torch.fluid import profiler

    main, _startup, _exe, scope = _trained(tfluid, steps=1)
    names = ("ckpt_save_ms", "ckpt_crc32_ms", "ckpt_fsync_ms")
    before = {n: len(profiler.get_histogram(n)) for n in names}
    mgr = tcheckpoint.CheckpointManager(str(tmp_path / "ck"))
    mgr.save(0, main, scope=scope, async_=async_)
    mgr.wait()
    mgr.close()
    got = {n: profiler.get_histogram(n)[before[n]:] for n in names}
    assert all(len(v) == 1 for v in got.values()), got
    whole, crc, fsync = (got[n][0] for n in names)
    assert crc >= 0.0 and fsync >= 0.0 and crc + fsync <= whole


# ---------------------------------------------------------------------------
# checkpoints across packages
# ---------------------------------------------------------------------------
def _mlp(fluid_mod):
    with fluid_mod.unique_name.guard():
        main, startup = fluid_mod.Program(), fluid_mod.Program()
        main.random_seed = startup.random_seed = 7
        with fluid_mod.program_guard(main, startup):
            x = fluid_mod.layers.data(name="x", shape=[4], dtype="float32")
            y = fluid_mod.layers.data(name="y", shape=[1], dtype="int64")
            h = fluid_mod.layers.fc(input=x, size=8, act="relu")
            logits = fluid_mod.layers.fc(input=h, size=3)
            loss = fluid_mod.layers.mean(
                fluid_mod.layers.softmax_with_cross_entropy(logits, y))
            fluid_mod.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return main, startup, loss


def _mlp_batch(s):
    r = np.random.RandomState(100 + s)
    return {"x": r.rand(8, 4).astype("float32"),
            "y": r.randint(0, 3, (8, 1)).astype("int64")}


def _persistables(main, scope):
    out = {}
    for v in main.list_vars():
        if not v.persistable or v.name in ("feed", "fetch"):
            continue
        val = scope.get(v.name)
        if val is not None:
            out[v.name] = np.array(val.numpy() if isinstance(
                val, torch.Tensor) else np.asarray(val))
    return out


def _trained(fluid_mod, steps=3):
    main, startup, loss = _mlp(fluid_mod)
    exe = fluid_mod.Executor(fluid_mod.CPUPlace())
    scope = fluid_mod.Scope() if fluid_mod is tfluid else \
        fluid_mod.core.Scope()
    exe.run(startup, scope=scope)
    for s in range(steps):
        exe.run(main, feed=_mlp_batch(s), fetch_list=[loss], scope=scope)
    return main, startup, exe, scope


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_checkpoints_restore_across_packages_bit_for_bit(tmp_path,
                                                         direction):
    """A checkpoint one package's manager wrote, restored by the other's
    into its own freshly started scope: every tensor equal bit for bit.
    The port's manifest carries its generator states beside the
    reference's ``rng_run_index`` (null); a reference checkpoint has no
    generator states, and the port leaves its generators as they are."""
    d = str(tmp_path / "ck")
    src, dst = (tfluid, jfluid) if direction == "port_to_reference" else \
        (jfluid, tfluid)
    src_ck = tcheckpoint if src is tfluid else jcheckpoint
    dst_ck = jcheckpoint if src is tfluid else tcheckpoint
    main, _st, _exe, scope = _trained(src)
    saved = _persistables(main, scope)
    mgr = src_ck.CheckpointManager(d)
    mgr.save(3, main, scope=scope, async_=False)
    mgr.close()
    main2, _st2, exe2, scope2 = _trained(dst, steps=0)
    before = scope2.rng_states() if dst is tfluid else None
    mgr2 = dst_ck.CheckpointManager(d)
    kw = {"executor": exe2}
    assert mgr2.restore(main2, scope=scope2, **kw) == 3
    mgr2.close()
    got = _persistables(main2, scope2)
    assert set(got) == set(saved) and len(saved) > 8
    for n in saved:
        assert got[n].dtype == saved[n].dtype, n
        assert got[n].tobytes() == saved[n].tobytes(), n
    if dst is tfluid:
        after = scope2.rng_states()
        assert all(torch.equal(after[k][1], before[k][1]) for k in before)


# ---------------------------------------------------------------------------
# checkpoint hygiene, each scenario on both packages
# ---------------------------------------------------------------------------
_PKGS = {"reference": (jfluid, jcheckpoint), "port": (tfluid, tcheckpoint)}


def _retention(fluid_mod, ck, d):
    main, _st, _exe, scope = _trained(fluid_mod, steps=1)
    mgr = ck.CheckpointManager(d, keep_max=2, keep_every_n_steps=4)
    for s in range(10):
        mgr.save(s, main, scope=scope, async_=False)
    mgr.close()
    return ck.list_steps(d)


def _checksum(fluid_mod, ck, d):
    main, _st, _exe, scope = _trained(fluid_mod, steps=1)
    mgr = ck.CheckpointManager(d)
    mgr.save(0, main, scope=scope, async_=False)
    data = os.path.join(d, "step_00000000", "state.pdckpt")
    blob = bytearray(open(data, "rb").read())
    blob[-1] ^= 0xFF
    with open(data, "wb") as f:
        f.write(bytes(blob))
    out = []
    for fn in (lambda: mgr.restore(main, scope=scope),
               lambda: mgr.verify(0)):
        try:
            fn()
            out.append(None)
        except ck.ChecksumError:
            out.append("ChecksumError")
    mgr.close()
    return out


def _torn(fluid_mod, ck, d):
    main, _st, _exe, scope = _trained(fluid_mod, steps=1)
    mgr = ck.CheckpointManager(d)
    mgr.save(2, main, scope=scope, async_=False)
    mgr.close()
    os.makedirs(os.path.join(d, "tmp.step_5"))          # a crashed writer
    os.makedirs(os.path.join(d, "step_00000007"))       # no manifest
    seen = ck.list_steps(d)
    ck.CheckpointManager(d).close()  # rank 0 sweeps the staging dirs
    return [seen, sorted(os.listdir(d))]


def _async_error(fluid_mod, ck, d, monkeypatch):
    io_ops = __import__(fluid_mod.__name__ + ".ops.io_ops",
                        fromlist=["io_ops"])
    main, _st, _exe, scope = _trained(fluid_mod, steps=1)
    mgr = ck.CheckpointManager(d)

    def boom(value):
        raise RuntimeError("disk on fire")

    # the function each writer serializes a tensor with
    monkeypatch.setattr(io_ops, "lod_tensor_stream_parts"
                        if fluid_mod is tfluid else "serialize_lod_tensor",
                        boom)
    mgr.save(2, main, scope=scope, async_=True)
    try:
        mgr.wait()
        raised = None
    except RuntimeError as e:
        raised = str(e)
    monkeypatch.undo()
    out = [raised, mgr.latest_step()]
    mgr.close()
    return out


def _fallback(fluid_mod, ck, d):
    main, _st, _exe, scope = _trained(fluid_mod, steps=1)
    mgr = ck.CheckpointManager(d)
    mgr.save(1, main, scope=scope, async_=False)
    mgr.save(2, main, scope=scope, async_=False)
    data = os.path.join(d, "step_00000002", "state.pdckpt")
    blob = bytearray(open(data, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    with open(data, "wb") as f:
        f.write(bytes(blob))
    restored = mgr.restore_or_initialize(main, scope=scope)
    scrub = mgr.scrub()
    verified = mgr.newest_verified_step()
    mgr.close()
    return [restored, scrub, verified]


def _sharded(fluid_mod, ck, d):
    """Two ranks write a step (one fc weight split on axis 1), a
    one-rank manager restores it whole."""
    main, _st, _exe, scope = _trained(fluid_mod, steps=1)
    name = "fc_0.w_0"
    full = _persistables(main, scope)[name]
    halves = np.array_split(full, 2, axis=1)
    mgrs = []
    for rank in (0, 1):
        piece = np.ascontiguousarray(halves[rank])
        scope.set(name, torch.from_numpy(piece) if fluid_mod is tfluid
                  else piece)
        mgr = ck.CheckpointManager(d, rank=rank, nranks=2,
                                   dist_attrs={name: 1})
        # rank 0's writer publishes once rank 1's shard is staged; its
        # snapshot is taken here, before the scope moves on
        mgr.save(0, main, scope=scope, async_=(rank == 0))
        mgrs.append(mgr)
    for mgr in mgrs:
        mgr.close()
    one = ck.CheckpointManager(d)
    one.restore(main, scope=scope)
    one.close()
    got = _persistables(main, scope)[name]
    return [bool(np.array_equal(got, full)), list(got.shape)]


@pytest.mark.parametrize("case", ["retention", "checksum", "torn",
                                  "async_error", "fallback", "sharded"])
def test_checkpoint_hygiene_behaves_as_reference(tmp_path, monkeypatch,
                                                 case):
    out = {}
    for pkg, (fluid_mod, ck) in _PKGS.items():
        d = str(tmp_path / pkg)
        if case == "async_error":
            out[pkg] = _async_error(fluid_mod, ck, d, monkeypatch)
        else:
            out[pkg] = {"retention": _retention, "checksum": _checksum,
                        "torn": _torn, "fallback": _fallback,
                        "sharded": _sharded}[case](fluid_mod, ck, d)
    assert out["port"] == out["reference"]
    expect = {"retention": [0, 4, 8, 9],
              "checksum": ["ChecksumError", "ChecksumError"],
              "torn": [[2], ["step_00000002", "step_00000007"]],
              "async_error": ["disk on fire", None],
              "fallback": [1, {2: False, 1: True}, 1],
              "sharded": [True, [4, 8]]}[case]
    assert out["port"] == expect


# ---------------------------------------------------------------------------
# NaN/Inf checking, the square ops
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("value", [
    np.array([1.0, np.nan], "float32"), np.array([np.inf], "float64"),
    np.array([1, 2], "int64"), np.array([0.5], "float32"), None])
def test_nonfinite_kind_matches_reference(value):
    want = jdebugger.nonfinite_kind(value)
    assert tdebugger.nonfinite_kind(value) == want
    if value is not None:
        assert tdebugger.nonfinite_kind(torch.from_numpy(value)) == want


def test_executor_scans_fetches_under_check_nan_inf():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="nx", shape=[2], dtype="float32")
        y = tfluid.layers.sqrt(x)
    exe = tfluid.Executor(tfluid.CPUPlace())
    feed = {"nx": np.array([[1.0, -1.0]], "float32")}
    (out,) = exe.run(main, feed=feed, fetch_list=[y])
    assert np.isnan(out).any()  # off by default: no scan
    tdebugger.set_check_nan_inf(True)
    try:
        assert tfluid.get_flags("check_nan_inf")["FLAGS_check_nan_inf"]
        with pytest.raises(tdebugger.NanInfError) as ei:
            exe.run(main, feed=feed, fetch_list=[y])
        assert ei.value.var_name == y.name and ei.value.kind == "nan"
        exe.run(main, feed={"nx": np.ones((1, 2), "float32")},
                fetch_list=[y])
    finally:
        tdebugger.set_check_nan_inf(False)
    assert tdebugger.scan_fetches(["a", "b"], [np.ones(2), None]) == 2


def _square_program(fluid_mod):
    with fluid_mod.unique_name.guard():
        main, startup = fluid_mod.Program(), fluid_mod.Program()
        main.random_seed = startup.random_seed = 3
        with fluid_mod.program_guard(main, startup):
            x = fluid_mod.layers.data(name="x", shape=[4], dtype="float32")
            y = fluid_mod.layers.data(name="y", shape=[1], dtype="float32")
            pred = fluid_mod.layers.fc(input=x, size=1)
            loss = fluid_mod.layers.mean(
                fluid_mod.layers.square_error_cost(pred, y))
            reg = fluid_mod.layers.reduce_sum(fluid_mod.layers.square(pred))
            total = fluid_mod.layers.elementwise_add(
                loss, fluid_mod.layers.scale(reg, scale=0.01))
            fluid_mod.optimizer.SGD(learning_rate=0.1).minimize(total)
    return main, startup, total


def test_square_and_square_error_cost_train_as_reference():
    """``square`` (with its gradient) and ``square_error_cost`` in a
    regression trained by SGD, 4 steps from the reference's startup
    scope: losses within 1e-6 relative, parameters within 1e-6."""
    rs = np.random.RandomState(0)
    feeds = [{"x": rs.rand(6, 4).astype("float32"),
              "y": rs.rand(6, 1).astype("float32")} for _ in range(4)]
    jmain, jstart, jloss = _square_program(jfluid)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.core.Scope()
    jexe.run(jstart, scope=jscope)
    arrays = _persistables(jmain, jscope)
    want = [float(np.asarray(jexe.run(jmain, feed=f, fetch_list=[jloss],
                                      scope=jscope)[0]).reshape(-1)[0])
            for f in feeds]
    tmain, tstart, tloss = _square_program(tfluid)
    texe = tfluid.Executor(tfluid.CPUPlace())
    tscope = tfluid.Scope()
    texe.run(tstart, scope=tscope)
    tfluid.load_program_scope(tmain, tscope, arrays)
    got = [float(texe.run(tmain, feed=f, fetch_list=[tloss],
                          scope=tscope)[0].reshape(-1)[0]) for f in feeds]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    final = _persistables(jmain, jscope)
    for n, v in _persistables(tmain, tscope).items():
        np.testing.assert_allclose(v, final[n], rtol=1e-6, atol=1e-7,
                                   err_msg=n)
