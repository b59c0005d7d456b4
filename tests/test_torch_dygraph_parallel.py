"""Dygraph data parallel in the port (``fluid.dygraph.parallel``:
``ParallelEnv``, ``prepare_context``, ``DataParallel``) on the CPU.

Two ranks, each a process of a gloo world started by
``paddle_tpu_torch.testing.world`` through a ``FileStore`` under
``tmp_path``, train LeNet-5 (``testing.dygraph_models.make_lenet``) with
SGD, each on its half of every batch: ``scale_loss`` then
``apply_collective_grads`` (one ``torch.distributed.all_reduce`` per
dtype). One process on the whole batch from the same weights is the
oracle, as ``tests/test_torch_data_parallel.py`` holds the static path:
LeNet has no batch norm, so the mean of the halves' gradients is the
whole batch's. Tolerances are stated at each comparison.
"""

import os

import numpy as np
import pytest

from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.testing import dygraph_models as dm
from paddle_tpu_torch.testing import world as tworld
from test_torch_cpu_math import pin_vector_math

pin_vector_math(2)  # 2 threads, vector math set up on one (see there)

HERE = os.path.abspath(__file__)
N = 2
BATCH = 8
STEPS = 3
LR = 0.05


def _batches():
    rs = np.random.RandomState(12)
    return [(rs.rand(BATCH, 1, 28, 28).astype("float32"),
             rs.randint(0, 10, (BATCH, 1)).astype("int64"))
            for _ in range(STEPS)]


def _init():
    rs = np.random.RandomState(13)
    with tfluid.dygraph.guard(tfluid.CPUPlace()):
        model = dm.make_lenet(tfluid)
        return {k: (rs.standard_normal(v.shape) * 0.1).astype("float32")
                for k, v in model.state_dict().items()}


def train(rank=0, world=1, data_parallel=False):
    """LeNet on this rank's rows of every batch (all of them in one
    process): (the whole batch's loss a step, the final parameters). A
    rank's loss is its half's, unscaled; the mean over the ranks is the
    whole batch's."""
    fluid = tfluid
    env = fluid.dygraph.ParallelEnv()
    strategy = fluid.dygraph.prepare_context() if data_parallel else None
    with fluid.dygraph.guard(fluid.CPUPlace()):
        lenet = dm.make_lenet(fluid)
        lenet.set_dict(_init())
        model = fluid.dygraph.DataParallel(lenet, strategy) \
            if data_parallel else lenet
        opt = fluid.optimizer.SGD(learning_rate=LR,
                                  parameter_list=lenet.parameters())
        per = BATCH // world
        losses = []
        for img, lab in _batches():
            rows = slice(rank * per, (rank + 1) * per)
            logits = model(fluid.dygraph.to_variable(img[rows]))
            loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
                logits, fluid.dygraph.to_variable(lab[rows])))
            losses.append(float(loss.numpy().reshape(-1)[0]))
            if data_parallel:
                loss = model.scale_loss(loss)
            loss.backward()
            if data_parallel:
                model.apply_collective_grads()
            opt.minimize(loss)
            lenet.clear_gradients()
        final = {k: v.numpy() for k, v in lenet.state_dict().items()}
    return {"losses": losses, "params": final, "nranks": env.nranks,
            "rank": env.local_rank}


def rank_main(rank, world):
    """One rank of the world: the launcher's variables, then ``train``."""
    os.environ["PADDLE_TRAINERS_NUM"] = str(world)
    os.environ["PADDLE_TRAINER_ID"] = str(rank)
    return train(rank, world, data_parallel=True)


@pytest.fixture(scope="module")
def dp_world(tmp_path_factory):
    return tworld.run_world(HERE + ":rank_main", N,
                            str(tmp_path_factory.mktemp("dyg_dp")))


def test_data_parallel_reproduces_one_process_on_the_whole_batch(dp_world):
    """2 ranks × 4 images against one process on 8, 3 SGD steps: the mean
    of the ranks' losses within 1e-5 relative of the whole batch's each
    step; every final parameter within 1e-5 of the one process's (the
    same arithmetic but the all-reduce's sum of two halves)."""
    single = train()
    assert [r["rank"] for r in dp_world] == [0, 1]
    assert all(r["nranks"] == N for r in dp_world)
    joined = np.mean([r["losses"] for r in dp_world], axis=0)
    np.testing.assert_allclose(joined, single["losses"], rtol=1e-5)
    for k, want in single["params"].items():
        for r in dp_world:
            np.testing.assert_allclose(r["params"][k], want, rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_ranks_end_equal(dp_world):
    """The summed gradients leave both ranks with the same parameters,
    bit for bit."""
    for k, v in dp_world[0]["params"].items():
        np.testing.assert_array_equal(dp_world[1]["params"][k], v)


def test_one_rank_is_a_plain_run(monkeypatch):
    """Without the launcher's variables ``DataParallel`` passes the layer
    through: ``scale_loss`` returns the loss and
    ``apply_collective_grads`` leaves the gradients as they are."""
    monkeypatch.delenv("PADDLE_TRAINERS_NUM", raising=False)
    with tfluid.dygraph.guard(tfluid.CPUPlace()):
        lin = tfluid.dygraph.Linear(3, 2)
        model = tfluid.dygraph.DataParallel(lin)
        loss = tfluid.layers.mean(model(tfluid.dygraph.to_variable(
            np.ones((2, 3), np.float32))))
        assert model.scale_loss(loss) is loss
        loss.backward()
        g = lin.weight.gradient()
        model.apply_collective_grads()
        np.testing.assert_array_equal(lin.weight.gradient(), g)
        assert sorted(model.state_dict()) == ["bias", "weight"]


def test_a_world_that_misses_ranks_raises(monkeypatch):
    """``PADDLE_TRAINERS_NUM`` says 2 but no world was joined: the
    reference's ``RuntimeError``, not a silently halved gradient."""
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    with tfluid.dygraph.guard(tfluid.CPUPlace()):
        lin = tfluid.dygraph.Linear(3, 2)
        model = tfluid.dygraph.DataParallel(lin)
        env = tfluid.dygraph.ParallelEnv()
        assert (env.nranks, env.local_rank) == (2, 0)
        loss = model.scale_loss(tfluid.layers.mean(model(
            tfluid.dygraph.to_variable(np.ones((2, 3), np.float32)))))
        loss.backward()
        with pytest.raises(RuntimeError, match="prepare_context"):
            model.apply_collective_grads()
