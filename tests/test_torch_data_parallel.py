"""Data-parallel training in the port (``fluid.CompiledProgram``,
``ParallelExecutor``, the collective transpiler, fleet's collective mode)
held against the JAX package on the CPU.

Each port rank is a process of a gloo world of 2 on the CPU:
``paddle_tpu_torch.testing.world`` starts them, each through a
``FileStore`` under ``tmp_path`` or, for the ``mp_dp_runner.py``
contract, through ``python -m paddle_tpu_torch.distributed.launch
--nproc_per_node 2 --device cpu`` on a free port. The rendezvous, every
collective and the whole world have timeouts, so a missing peer fails
the test instead of hanging the suite. Each rank feeds its shard of the
batch and fetches its own values.

The reference runs in this process: one device on the whole batch where
data parallel equals it (no batch norm: the mean of the shards'
gradients is the whole batch's), else its ``with_data_parallel`` over 2
of the 8 virtual CPU devices that ``conftest.py`` arms (per-shard batch
norm). The ranks start from the reference's startup values
(``load_program_scope``). Tolerances are stated at each comparison.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.models import lenet as tlenet
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.testing import world as tworld
from test_torch_cpu_math import pin_vector_math

pin_vector_math(2)  # 2 threads, vector math set up on one (see there)

HERE = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(HERE))
N = 2
MLP_BATCH = 32      # mp_dp_runner.py: global batch 32 over 4 steps
MLP_STEPS = 4
LENET_BATCH = 16
LENET_STEPS = 4
RES_BATCH = 8       # the narrow ResNet: 4 rows a rank
RES_STEPS = 3
RES_SIZE = 16


# ---------------------------------------------------------------------------
# programs, built alike by both packages
# ---------------------------------------------------------------------------
def build_mlp(fl, minimize):
    """``mp_dp_runner.py``'s model: fc(16->32, relu) -> fc(->5) ->
    softmax_with_cross_entropy mean, seed 90; ``minimize(fl, loss,
    startup)`` adds the optimizer inside the same name guard."""
    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = 90
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        x = fl.layers.data(name="x", shape=[16], dtype="float32")
        y = fl.layers.data(name="y", shape=[1], dtype="int64")
        h = fl.layers.fc(input=x, size=32, act="relu")
        logits = fl.layers.fc(input=h, size=5)
        loss = fl.layers.mean(
            fl.layers.softmax_with_cross_entropy(logits, y))
        minimize(fl, loss, startup)
    return main, startup, loss


def sgd(fl, loss, startup):
    fl.optimizer.SGD(learning_rate=0.1).minimize(
        loss, startup_program=startup)


def fleet_sgd(fl, loss, startup):
    from paddle_tpu_torch.fluid.incubate.fleet.base import role_maker
    from paddle_tpu_torch.fluid.incubate.fleet.collective import (
        CollectiveOptimizer, fleet)

    fleet.init(role_maker.PaddleCloudRoleMaker(is_collective=True))
    CollectiveOptimizer(fl.optimizer.SGD(learning_rate=0.1)).minimize(
        loss, startup_program=startup)


def mlp_batch(step):
    rs = np.random.RandomState(77 + step)
    x = rs.rand(MLP_BATCH, 16).astype("float32")
    y = rs.randint(0, 5, (MLP_BATCH, 1)).astype("int64")
    return {"x": x, "y": y}


def build_lenet(fl, lmod):
    with fl.unique_name.guard():
        main, startup, feeds, loss, acc = lmod.build_lenet_train(
            learning_rate=0.1)
    return main, startup, loss


def lenet_batch():
    rs = np.random.RandomState(7)
    return {"img": rs.rand(LENET_BATCH, 1, 28, 28).astype("float32"),
            "label": rs.randint(0, 10, (LENET_BATCH, 1)).astype("int64")}


def build_narrow_resnet(fl, rmod):
    """A narrow ResNet of the builders' own blocks: conv-bn 8, two basic
    blocks (8, then 16 at stride 2), global pool, fc 10, Momentum."""
    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = 5
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        img = fl.layers.data(name="img", shape=[3, RES_SIZE, RES_SIZE],
                             dtype="float32")
        label = fl.layers.data(name="label", shape=[1], dtype="int64")
        h = rmod._conv_bn(img, 8, 3, act="relu")
        h = rmod._basic_block(h, 8, 1, False)
        h = rmod._basic_block(h, 16, 2, False)
        h = fl.layers.pool2d(h, pool_type="avg", global_pooling=True)
        logits = fl.layers.fc(input=h, size=10)
        loss = fl.layers.mean(
            fl.layers.softmax_with_cross_entropy(logits, label))
        fl.optimizer.Momentum(learning_rate=0.05, momentum=0.9).minimize(
            loss)
    return main, startup, loss


def res_batch(step):
    rs = np.random.RandomState(30 + step)
    return {"img": rs.randn(RES_BATCH, 3, RES_SIZE, RES_SIZE).astype(
        "float32"),
        "label": rs.randint(0, 10, (RES_BATCH, 1)).astype("int64")}


def build_regression(fl):
    """``test_quantized_allreduce.py``'s regression model."""
    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = 21
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        xv = fl.layers.data(name="qx", shape=[8], dtype="float32")
        yv = fl.layers.data(name="qy", shape=[1], dtype="float32")
        h = fl.layers.fc(input=xv, size=8, act="relu")
        pred = fl.layers.fc(input=h, size=1)
        loss = fl.layers.mean(fl.layers.square_error_cost(pred, yv))
        fl.optimizer.SGD(learning_rate=0.05).minimize(
            loss, startup_program=startup)
    return main, startup, loss


def shard(feed, rank):
    return {k: v[rank * (len(v) // N):(rank + 1) * (len(v) // N)]
            for k, v in feed.items()}


def persistables(main):
    return sorted(v.name for v in main.list_vars() if v.persistable
                  and not v.name.startswith(("feed", "fetch")))


def state_of(main, scope):
    return {n: np.array(np.asarray(scope.get(n)))
            for n in persistables(main) if scope.get(n) is not None}


# ---------------------------------------------------------------------------
# the port's ranks
# ---------------------------------------------------------------------------
def _port_scope(main, startup, arrays):
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    tfluid.load_program_scope(main, scope, {
        n: arrays[n] for n in persistables(main)})
    return exe, scope


def _loss(v):
    return float(np.asarray(v).reshape(-1)[0])


def mp_dp_rank(rank, world, init):
    """``mp_dp_runner.py``'s worker: fleet's CollectiveOptimizer, then
    ``with_data_parallel``, each rank on its half of every batch."""
    arrays = dict(np.load(init))
    main, startup, loss = build_mlp(tfluid, fleet_sgd)
    exe, scope = _port_scope(main, startup, arrays)
    compiled = tfluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name)
    losses, after1 = [], None
    for s in range(MLP_STEPS):
        (lv,) = exe.run(compiled, feed=shard(mlp_batch(s), rank),
                        fetch_list=[loss], scope=scope)
        losses.append(_loss(lv))
        if s == 0:
            after1 = state_of(main, scope)
    from paddle_tpu_torch import parallel

    return {"losses": losses, "after1": after1,
            "final": state_of(main, scope),
            "env": {k: os.environ.get(k) for k in (
                "RANK", "WORLD_SIZE", "PADDLE_TRAINER_ID",
                "PADDLE_TRAINERS_NUM", "MASTER_ADDR")},
            "world": parallel.world_size(),
            "ops": [o.type for o in main.global_block().ops],
            "startup_ops": [o.type for o in startup.global_block().ops]}


def dp_rank(rank, world, init):
    """LeNet, the narrow ResNet, ParallelExecutor and the quantized flag,
    each rank on its half of every batch."""
    from paddle_tpu_torch.fluid import flags

    res = {}
    # LeNet through with_data_parallel of the plain program; rank 1
    # starts from other weights, which the first run's broadcast of rank
    # 0's persistables replaces
    arrays = dict(np.load(init + "lenet.npz"))
    main, startup, loss = build_lenet(tfluid, tlenet)
    exe, scope = _port_scope(main, startup, arrays)
    if rank == 1:
        w = scope.get("fc_0.w_0")
        w.add_(1.0)
    compiled = tfluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name)
    res["lenet"] = [_loss(exe.run(compiled, feed=shard(lenet_batch(), rank),
                                  fetch_list=[loss], scope=scope)[0])
                    for _ in range(LENET_STEPS)]
    res["lenet_ops"] = [o.type for o in main.global_block().ops]
    res["lenet_state"] = state_of(main, scope)

    # the narrow ResNet: each rank's batch norm over its own rows
    arrays = dict(np.load(init + "resnet.npz"))
    main, startup, loss = build_narrow_resnet(tfluid, tresnet)
    exe, scope = _port_scope(main, startup, arrays)
    compiled = tfluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name)
    res["resnet"] = [_loss(exe.run(compiled, feed=shard(res_batch(s), rank),
                                   fetch_list=[loss], scope=scope)[0])
                     for s in range(RES_STEPS)]
    res["resnet_state"] = state_of(main, scope)

    # ParallelExecutor over the plain SGD program
    arrays = dict(np.load(init + "mlp.npz"))
    main, startup, loss = build_mlp(tfluid, sgd)
    exe, scope = _port_scope(main, startup, arrays)
    pe = tfluid.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                 main_program=main, scope=scope)
    res["pe_device_count"] = pe.device_count
    res["pe"] = [_loss(pe.run([loss], feed=shard(mlp_batch(s), rank))[0])
                 for s in range(MLP_STEPS)]

    # a program rewritten for 2 ranks refuses another world size
    res["retarget"] = None
    try:
        main._grad_allreduce_applied = 3
        pe.run([loss], feed=shard(mlp_batch(0), rank))
    except RuntimeError as e:
        res["retarget"] = str(e)

    # the int8-wire gradient allreduce under the flag
    rs = np.random.RandomState(3)
    feed = {"qx": rs.rand(8, 8).astype("float32"),
            "qy": rs.rand(8, 1).astype("float32")}
    for flag in (False, True):
        flags.set_flags({"quantized_allreduce": flag})
        try:
            main, startup, loss = build_regression(tfluid)
            exe = tfluid.Executor(tfluid.CPUPlace())
            scope = tfluid.Scope()
            exe.run(startup, scope=scope)
            compiled = tfluid.CompiledProgram(main).with_data_parallel(
                loss_name=loss.name)
            res["quant_%s" % flag] = [
                _loss(exe.run(compiled, feed=shard(feed, rank),
                              fetch_list=[loss], scope=scope)[0])
                for _ in range(5)]
        finally:
            flags.set_flags({"quantized_allreduce": False})
    return res


# ---------------------------------------------------------------------------
# the reference, in this process
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jfluid():
    import paddle_tpu.fluid as jfluid

    return jfluid


def _ref_start(jfluid, main, startup):
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.core.Scope()
    exe.run(startup, scope=scope)
    return exe, scope


def ref_mlp(jfluid):
    """The reference's single device on the whole batch: (startup
    values, losses, state after step 1)."""
    main, startup, loss = build_mlp(jfluid, sgd)
    exe, scope = _ref_start(jfluid, main, startup)
    init = state_of(main, scope)
    losses, after1 = [], None
    for s in range(MLP_STEPS):
        (lv,) = exe.run(main, feed=mlp_batch(s), fetch_list=[loss],
                        scope=scope)
        losses.append(_loss(lv))
        if s == 0:
            after1 = state_of(main, scope)
    return init, losses, after1


@pytest.fixture(scope="module")
def reference(jfluid, tmp_path_factory):
    from paddle_tpu.models import lenet as jlenet
    from paddle_tpu.models import resnet as jresnet

    d = str(tmp_path_factory.mktemp("dp_init"))
    out = {}
    init, out["mlp"], out["mlp_after1"] = ref_mlp(jfluid)
    np.savez(os.path.join(d, "mlp.npz"), **init)

    main, startup, loss = build_lenet(jfluid, jlenet)
    exe, scope = _ref_start(jfluid, main, startup)
    np.savez(os.path.join(d, "lenet.npz"), **state_of(main, scope))
    out["lenet"] = [_loss(exe.run(main, feed=lenet_batch(),
                                  fetch_list=[loss], scope=scope)[0])
                    for _ in range(LENET_STEPS)]
    out["lenet_state"] = state_of(main, scope)

    import jax

    main, startup, loss = build_narrow_resnet(jfluid, jresnet)
    exe, scope = _ref_start(jfluid, main, startup)
    np.savez(os.path.join(d, "resnet.npz"), **state_of(main, scope))
    compiled = jfluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, places=jax.devices()[:N])
    out["resnet"] = [np.asarray(exe.run(compiled, feed=res_batch(s),
                                        fetch_list=[loss], scope=scope)[0])
                     .reshape(-1).tolist() for s in range(RES_STEPS)]
    out["resnet_state"] = state_of(main, scope)
    out["dir"] = d
    return out


@pytest.fixture(scope="module")
def dp_world(reference, tmp_path_factory):
    return tworld.run_world(
        HERE + ":dp_rank", N, str(tmp_path_factory.mktemp("dp_world")),
        kwargs={"init": os.path.join(reference["dir"], "")})


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def launched(reference, tmp_path_factory):
    """The mp_dp_runner contract through the port's launcher: 2 CPU
    workers on the env:// rendezvous of a free port."""
    out = str(tmp_path_factory.mktemp("launched"))
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", str(N), "--device", "cpu",
           "--started_port", str(port - 1000), "--log_dir", out,
           "paddle_tpu_torch/testing/world.py",
           "--target", HERE + ":mp_dp_rank", "--out", out, "--timeout", "120",
           "--kwargs", json.dumps(
               {"init": os.path.join(reference["dir"], "mlp.npz")})]
    p = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=300)
    logs = ""
    for r in range(N):
        path = os.path.join(out, "workerlog.%d" % r)
        if os.path.exists(path):
            logs += open(path).read()[-3000:]
    assert p.returncode == 0, (p.stdout[-2000:], p.stderr[-2000:], logs)
    return [tworld.read_result(out, r) for r in range(N)]


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------
def test_launcher_mp_dp_contract_reproduces_one_device(launched, reference):
    """2 ranks x 16 rows over 4 steps: the mean of the ranks' losses is
    the reference's one-device loss on the whole batch (rtol 1e-5, as
    ``test_multiprocess_dp.py``), and so are the parameters after one
    step (rtol 1e-5, atol 1e-6)."""
    got = np.mean([r["losses"] for r in launched], axis=0)
    np.testing.assert_allclose(got, reference["mlp"], rtol=1e-5, atol=1e-5)
    for r in launched:
        for n, want in reference["mlp_after1"].items():
            np.testing.assert_allclose(r["after1"][n], want, rtol=1e-5,
                                       atol=1e-6, err_msg=n)
    for n, v in launched[0]["final"].items():
        np.testing.assert_array_equal(v, launched[1]["final"][n])


def test_launcher_env_reaches_the_ranks(launched):
    for rank, r in enumerate(launched):
        assert r["world"] == N
        assert r["env"]["RANK"] == r["env"]["PADDLE_TRAINER_ID"] == str(rank)
        assert r["env"]["WORLD_SIZE"] == r["env"]["PADDLE_TRAINERS_NUM"] == \
            str(N)
        # CollectiveOptimizer wrote c_comm_init and the allreduces
        assert r["startup_ops"].count("c_comm_init") == 1
        assert r["ops"].count("c_allreduce_sum") == 4


def test_lenet_data_parallel_matches_one_device(dp_world, reference):
    """LeNet (``test_parallel_parity.py:22-62``): the ranks' mean loss is
    the reference's one-device loss on the whole batch (rtol 1e-5,
    atol 1e-6), although rank 1 started from other weights (the first
    run broadcasts rank 0's); both ranks end with the reference's
    parameters (rtol 1e-4, atol 1e-6)."""
    got = np.mean([r["lenet"] for r in dp_world], axis=0)
    np.testing.assert_allclose(got, reference["lenet"], rtol=1e-5, atol=1e-6)
    for r in dp_world:
        for n, want in reference["lenet_state"].items():
            np.testing.assert_allclose(r["lenet_state"][n], want, rtol=1e-4,
                                       atol=1e-6, err_msg=n)
    ops = dp_world[0]["lenet_ops"]
    assert ops.count("c_allreduce_sum") == 10   # 5 layers' weights, biases
    assert ops.index("c_allreduce_sum") > max(
        i for i, t in enumerate(ops) if t.endswith("_grad"))


def test_narrow_resnet_per_rank_batch_norm_matches_reference_dp(
        dp_world, reference):
    """The reference's ``with_data_parallel`` over 2 devices normalizes
    each shard alone: each rank's loss is its shard's (rtol 1e-4, atol
    1e-5 over 3 Momentum steps), the parameters after the last step are
    the reference's on both ranks (rtol 1e-4, atol 1e-5)."""
    got = np.array([r["resnet"] for r in dp_world]).T   # [steps, ranks]
    np.testing.assert_allclose(got, np.array(reference["resnet"]),
                               rtol=1e-4, atol=1e-5)
    params = [n for n in reference["resnet_state"]
              if not n.endswith(("w_1", "w_2"))]   # not the running stats
    assert len(params) > 10
    for r in dp_world:
        for n in params:
            np.testing.assert_allclose(
                r["resnet_state"][n], reference["resnet_state"][n],
                rtol=1e-4, atol=1e-5, err_msg=n)


def test_parallel_executor_runs_the_data_parallel_step(dp_world, reference):
    for r in dp_world:
        assert r["pe_device_count"] == N
    got = np.mean([r["pe"] for r in dp_world], axis=0)
    np.testing.assert_allclose(got, reference["mlp"], rtol=1e-5, atol=1e-5)


def test_transpiled_program_refuses_another_world(dp_world):
    for r in dp_world:
        assert "already transpiled for 3" in r["retarget"]


def test_quantized_allreduce_flag_trains(dp_world):
    """``test_fluid_dp_trains_with_quantized_allreduce_flag``: under the
    flag each rank's losses track the exact run's (rtol 0.05, atol 1e-3)
    and the whole batch's loss (the ranks' mean) descends."""
    for r in dp_world:
        quant, exact = r["quant_True"], r["quant_False"]
        np.testing.assert_allclose(quant, exact, rtol=0.05, atol=1e-3)
        assert quant != exact
    quant = np.mean([r["quant_True"] for r in dp_world], axis=0)
    assert quant[-1] < quant[0]


# ---------------------------------------------------------------------------
# in this process: a world of one, the surface, and the programs written
# ---------------------------------------------------------------------------
def test_world_of_one_is_a_plain_run():
    """No process group: ``with_data_parallel`` runs the program as it
    is, as the reference's one-device branch (``compiler.py:332``)."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    feed = mlp_batch(0)
    outs = []
    for compiled in (False, True):
        main, startup, loss = build_mlp(tfluid, sgd)
        exe = tfluid.Executor(tfluid.CPUPlace())
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
        prog = tfluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name) if compiled else main
        outs.append([_loss(exe.run(prog, feed=feed, fetch_list=[loss],
                                   scope=scope)[0]) for _ in range(2)])
        assert all(o.type != "c_allreduce_sum"
                   for o in main.global_block().ops)
        if compiled:
            assert prog.program is main and prog._device_count() == 1
    assert outs[0] == outs[1]


def test_more_places_than_one_process_raises():
    main, startup, loss = build_mlp(tfluid, sgd)
    with pytest.raises(ValueError, match="distributed.launch"):
        tfluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, places=tfluid.cpu_places(2))
    # one place is this process's device
    tfluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, places=tfluid.cpu_places(1))


@pytest.mark.parametrize("call", ["with_mesh", "with_spmd", "pe_spmd",
                                  "DistributeTranspiler",
                                  "DistributeTranspilerConfig"])
def test_later_parts_of_the_toolbox_raise(call):
    main, startup, loss = build_mlp(tfluid, sgd)
    with pytest.raises(NotImplementedError, match="A12"):
        if call == "pe_spmd":
            tfluid.ParallelExecutor(loss_name=loss.name, main_program=main,
                                    use_spmd=True)
        elif call.startswith("with_"):
            getattr(tfluid.CompiledProgram(main), call)(loss_name=loss.name)
        else:
            getattr(tfluid, call)()


def _desc(main):
    def attrs(o):
        return {k: v for k, v in o.attrs.items() if k != "op_callstack"}

    return [(o.type, {k: list(v) for k, v in o.inputs.items()},
             {k: list(v) for k, v in o.outputs.items()}, attrs(o))
            for o in main.global_block().ops]


def _assert_same_desc(got, want):
    assert [d[0] for d in got] == [d[0] for d in want]
    for g, w in zip(got, want):
        assert g[1:3] == w[1:3], g[0]
        assert set(g[3]) == set(w[3]), (g[0], set(g[3]) ^ set(w[3]))
        for k in w[3]:
            a, b = g[3][k], w[3][k]
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=1e-12), (g[0], k)
            else:
                assert a == b or str(a) == str(b), (g[0], k, a, b)


def _transpiled(fl, kind):
    """(main, startup) of the MLP under ``kind``'s rewrite for 2 ranks."""
    minimize = sgd
    if kind == "LocalSGD":
        def minimize(fl, loss, startup):
            fl.optimizer.Momentum(learning_rate=0.1, momentum=0.9).minimize(
                loss, startup_program=startup)
    main, startup, loss = build_mlp(fl, minimize)
    if kind == "dgc":
        # a dgc_momentum op that consumes one gradient: its allreduce is
        # skipped (sparse communication happens inside it)
        main.global_block().append_op(
            type="dgc_momentum", inputs={"Grad": ["fc_1.b_0@GRAD"]},
            outputs={}, attrs={})
    eps = ["127.0.0.1:6170", "127.0.0.1:6171"]
    if kind in ("GradAllReduce", "dgc"):
        fl.transpiler.collective.GradAllReduce(nrings=2).transpile(
            startup, main, rank=0, endpoints=eps, current_endpoint=eps[0])
    elif kind == "LocalSGD":
        fl.transpiler.collective.LocalSGD(nrings=2).transpile(
            startup, main, rank=1, endpoints=eps, current_endpoint=eps[1])
    elif kind == "pass":
        fl.ir.get_pass("collective_grad_allreduce_pass", nranks=2,
                       loss_name=loss.name).apply_program(main)
    return main, startup


@pytest.mark.parametrize("kind", ["GradAllReduce", "LocalSGD", "pass", "dgc"])
def test_transpilers_write_the_reference_program(jfluid, kind):
    """Op for op and attribute for attribute (the creation site aside):
    the 1/nranks loss-grad scale, one c_allreduce_sum a gradient before
    the first optimizer op on ring ``i % nrings``, LocalSGD's snapshot
    averaging, c_comm_init per ring in the startup program."""
    got = _transpiled(tfluid, kind)
    want = _transpiled(jfluid, kind)
    for g, w in zip(got, want):
        _assert_same_desc(_desc(g), _desc(w))
    types = [d[0] for d in _desc(got[0])]
    if kind == "dgc":
        assert types.count("c_allreduce_sum") == 3
    elif kind != "LocalSGD":
        assert types.count("c_allreduce_sum") == 4


def test_collective_optimizer_writes_the_reference_program(jfluid,
                                                           monkeypatch):
    """CollectiveOptimizer for 2 workers: the port's nranks is the role
    maker's worker count in no world; the reference's is
    ``jax.device_count()``, set to 2 here."""
    import jax

    from paddle_tpu.fluid.incubate.fleet.base import role_maker as jrm
    from paddle_tpu.fluid.incubate.fleet.collective import (
        CollectiveOptimizer as JCO, DistributedStrategy as JDS,
        fleet as jfleet)
    from paddle_tpu_torch.fluid.incubate.fleet.base import role_maker as trm
    from paddle_tpu_torch.fluid.incubate.fleet.collective import (
        CollectiveOptimizer as TCO, DistributedStrategy as TDS,
        fleet as tfleet)

    monkeypatch.setattr(jax, "device_count", lambda *a: 2)
    eps = ["127.0.0.1:6170", "127.0.0.1:6171"]
    progs = {}
    for local_sgd in (False, True):
        for fl, rm, fleet, CO, DS in ((tfluid, trm, tfleet, TCO, TDS),
                                      (jfluid, jrm, jfleet, JCO, JDS)):
            fleet.init(rm.UserDefinedCollectiveRoleMaker(1, eps))
            strategy = DS()
            strategy.use_local_sgd = local_sgd

            def minimize(fl, loss, startup, CO=CO, strategy=strategy):
                CO(fl.optimizer.SGD(learning_rate=0.1),
                   strategy).minimize(loss, startup_program=startup)

            main, startup, loss = build_mlp(fl, minimize)
            assert main._grad_allreduce_applied == 2
            assert fleet.worker_index() == 1 and fleet.worker_num() == 2
            progs[fl] = (main, startup)
        for g, w in zip(progs[tfluid], progs[jfluid]):
            _assert_same_desc(_desc(g), _desc(w))


def test_role_makers_read_the_launchers_env(jfluid, monkeypatch):
    from paddle_tpu.fluid.incubate.fleet.base import role_maker as jrm
    from paddle_tpu_torch.fluid.incubate.fleet.base import role_maker as trm

    env = {"PADDLE_TRAINER_ID": "1", "PADDLE_TRAINERS_NUM": "2",
           "PADDLE_TRAINER_ENDPOINTS": "10.0.0.1:6170,10.0.0.2:6170"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for collective in (True, False):
        got = trm.PaddleCloudRoleMaker(is_collective=collective)
        want = jrm.PaddleCloudRoleMaker(is_collective=collective)
        for rm in (got, want):
            rm.generate_role()
        assert got.worker_index() == want.worker_index() == 1
        assert got.worker_num() == want.worker_num() == 2
        assert got.get_trainer_endpoints() == want.get_trainer_endpoints()
        assert got.is_worker() and not got.is_server()
        assert got.is_first_worker() == want.is_first_worker() is False
    # torch's names alone (a launcher that sets only them)
    for k in env:
        monkeypatch.delenv(k)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "3")
    rm = trm.PaddleCloudRoleMaker(is_collective=True)
    rm.generate_role()
    assert rm.worker_index() == 0 and rm.worker_num() == 3
    assert rm.is_first_worker()


def test_pass_builder_rewrites_through_compiled_program(jfluid, capsys):
    """``test_user_pass.py`` on the port: a registered pass and a pass
    instance, appended to BuildStrategy's builder, rewrite the program
    once before ``CompiledProgram`` runs it; the rewritten program is the
    reference's op for op."""
    from paddle_tpu_torch.fluid import ir as tir
    from paddle_tpu.fluid import ir as jir

    def passes(ir):
        class StripPrint(ir.Pass):
            def apply(self, graph):
                block = graph._block
                for op_ in list(block.ops):
                    if op_.type == "print":
                        block.ops.remove(op_)

        class DoubleScale(ir.Pass):
            def apply(self, graph):
                for node in graph.all_op_nodes():
                    if node.name() == "scale":
                        o = node.op()
                        o.attrs["scale"] = float(o.attr("scale")) * 2.0

        return StripPrint(), DoubleScale()

    def build(fl):
        main, startup = fl.Program(), fl.Program()
        main.random_seed = startup.random_seed = 3
        with fl.unique_name.guard(), fl.program_guard(main, startup):
            x = fl.layers.data(name="x", shape=[4], dtype="float32")
            h = fl.layers.scale(x, scale=1.5)
            fl.layer_helper.LayerHelper("print").append_op(
                type="print", inputs={"In": [h]}, outputs={},
                attrs={"message": "debug"})
            out = fl.layers.fc(input=h, size=2)
            loss = fl.layers.mean(out)
            fl.optimizer.SGD(learning_rate=0.0).minimize(
                loss, startup_program=startup)
        return main, startup, loss

    xb = np.random.RandomState(0).rand(4, 4).astype("float32")
    losses, progs = {}, {}
    for with_passes in (False, True):
        main, startup, loss = build(tfluid)
        bs = tfluid.BuildStrategy()
        if with_passes:
            pb = bs._finalize_strategy_and_create_passes()
            for p in passes(tir):
                pb.append_pass(p)
        exe = tfluid.Executor(tfluid.CPUPlace())
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
        compiled = tfluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, build_strategy=bs)
        capsys.readouterr()
        (lv,) = exe.run(compiled, feed={"x": xb}, fetch_list=[loss],
                        scope=scope)
        exe.run(compiled, feed={"x": xb}, fetch_list=[loss], scope=scope)
        out = capsys.readouterr().out + capsys.readouterr().err
        losses[with_passes] = _loss(lv)
        progs[with_passes] = main
        assert ("debug" in out) != with_passes
    assert all(o.type != "print" for o in progs[True].global_block().ops)
    np.testing.assert_allclose(losses[True], losses[False] * 2.0, rtol=1e-5)
    # the scale doubled once: the passes ran once for both runs
    assert [o.attr("scale") for o in progs[True].global_block().ops
            if o.type == "scale"][0] == 3.0
    jmain, _s, _l = build(jfluid)
    jpb = jir.PassBuilder()
    for p in passes(jir):
        jpb.append_pass(p)
    jpb.apply(jmain)
    assert [d[:3] for d in _desc(progs[True])] == [d[:3]
                                                   for d in _desc(jmain)]
