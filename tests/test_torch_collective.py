"""The port's collective ops (``fluid/ops/collective_ops.py``), the
quantized all-reduce (``parallel/quantized_allreduce.py``) and
``sync_batch_norm`` held against the JAX package and numpy on the CPU.

The port runs one process per rank: a module-scoped world of 2 gloo
ranks (``paddle_tpu_torch.testing.world``, a ``FileStore`` under
``tmp_path``, a timeout on the rendezvous, on every collective and on
the world) runs every case once, each rank feeding its shard through
``CompiledProgram(main).with_data_parallel()``. The reference runs the
same program in this process through its ``with_data_parallel`` over 2
of the 8 virtual CPU devices that ``conftest.py`` arms, fed the joined
batch; its fetches are the shards' outputs joined on dim 0, so the
port's ranks' fetches are joined the same way before they are compared.

Both packages rewrite the program for 2 ranks the same way: the loss
gradient is scaled by 1/2 (``GradAllReduce``), so every numpy gradient
below carries that factor. The reference cannot differentiate
``c_allreduce_max`` / ``min`` (JAX has no rule for ``pmax`` / ``pmin``);
the port's gradients of those are held to numpy alone.
"""

import os

import numpy as np
import pytest
import torch

from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.testing import world as tworld
from test_torch_cpu_math import pin_vector_math

pin_vector_math(2)  # 2 threads, vector math set up on one (see there)

HERE = os.path.abspath(__file__)
N = 2        # ranks
ROWS = 2     # rows a rank feeds
COLS = 3

# op type, attrs, rows of a rank's output
OPS = {
    "c_allreduce_sum": ("c_allreduce_sum", {}, ROWS),
    "c_allreduce_max": ("c_allreduce_max", {}, ROWS),
    "c_allreduce_min": ("c_allreduce_min", {}, ROWS),
    "c_allreduce_prod": ("c_allreduce_prod", {}, ROWS),
    "allreduce": ("allreduce", {}, ROWS),
    "c_broadcast_root0": ("c_broadcast", {"root": 0}, ROWS),
    "c_broadcast_root1": ("c_broadcast", {"root": 1}, ROWS),
    "broadcast": ("broadcast", {"root": 1}, ROWS),
    "c_allgather": ("c_allgather", {"nranks": N}, N * ROWS),
    "c_reducescatter": ("c_reducescatter", {"nranks": N}, ROWS // N),
}
NO_REFERENCE_GRAD = ("c_allreduce_max", "c_allreduce_min")
BN_SHAPE = (2, 3, 2, 2)   # a rank's [N, C, H, W]
BN_EPS = 1e-5


def op_data(case):
    """(x, cw) joined over the ranks: x in [0.5, 1.5) (a product stays
    away from 0), the cotangent weights of sum(out * cw)."""
    rs = np.random.RandomState(sorted(OPS).index(case))
    x = rs.uniform(0.5, 1.5, (N * ROWS, COLS)).astype("float32")
    cw = rs.randn(N * OPS[case][2], COLS).astype("float32")
    return x, cw


def shard(a, rank):
    n = a.shape[0] // N
    return a[rank * n:(rank + 1) * n]


def build_op(fl, case, ring_id=0, grad=True):
    op_type, attrs, _rows = OPS[case]
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        x = fl.layers.data(name="x", shape=[COLS], dtype="float32")
        x.stop_gradient = False
        cw = fl.layers.data(name="cw", shape=[COLS], dtype="float32")
        helper = fl.layer_helper.LayerHelper(op_type)
        out = helper.create_variable_for_type_inference(dtype="float32")
        helper.append_op(type=op_type, inputs={"X": [x]},
                         outputs={"Out": [out]},
                         attrs=dict(attrs, ring_id=ring_id))
        loss = fl.layers.reduce_sum(fl.layers.elementwise_mul(out, cw))
        gx = fl.gradients(loss, x)[0] if grad else None
    return main, startup, out, gx


def build_sync_bn(fl):
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        x = fl.layers.data(name="x", shape=list(BN_SHAPE[1:]),
                           dtype="float32")
        x.stop_gradient = False
        cw = fl.layers.data(name="cw", shape=list(BN_SHAPE[1:]),
                            dtype="float32")
        y = fl.layers.batch_norm(input=x, epsilon=BN_EPS)
        for op_ in main.global_block().ops:
            if op_.type == "batch_norm":
                op_.type = "sync_batch_norm"
        loss = fl.layers.reduce_sum(fl.layers.elementwise_mul(y, cw))
        gx = fl.gradients(loss, x)[0]
    return main, startup, y, gx


def bn_data():
    rs = np.random.RandomState(11)
    x = (rs.randn(N * BN_SHAPE[0], *BN_SHAPE[1:]) * 2 + 0.5).astype(
        "float32")
    cw = rs.randn(*x.shape).astype("float32")
    return x, cw


BN_FETCH = ("batch_norm_0.w_0@GRAD", "batch_norm_0.b_0@GRAD")
BN_STATE = ("batch_norm_0.w_1", "batch_norm_0.w_2")


def _dp_run(fl, main, startup, feed, fetch, places=None):
    exe = fl.Executor(fl.CPUPlace())
    scope = fl.Scope() if hasattr(fl, "Scope") else fl.core.Scope()
    exe.run(startup, scope=scope)
    comp = fl.CompiledProgram(main).with_data_parallel(places=places)
    outs = exe.run(comp, feed=feed, fetch_list=list(fetch), scope=scope)
    return [np.asarray(o) for o in outs], scope


# ---------------------------------------------------------------------------
# what each rank runs
# ---------------------------------------------------------------------------
def rank_main(rank, world):
    from paddle_tpu_torch.fluid import flags
    from paddle_tpu_torch.parallel import CommContext
    from paddle_tpu_torch.parallel import quantized_allreduce as qar

    res = {"ops": {}, "world": world}
    for case in OPS:
        main, startup, out, gx = build_op(tfluid, case)
        x, cw = op_data(case)
        res["ops"][case] = _dp_run(
            tfluid, main, startup,
            {"x": shard(x, rank), "cw": shard(cw, rank)}, (out, gx))[0]
    # a second ring is its own group, with the same sums
    main, startup, out, gx = build_op(tfluid, "c_allreduce_sum", ring_id=1)
    x, cw = op_data("c_allreduce_sum")
    res["ring1"] = _dp_run(tfluid, main, startup,
                           {"x": shard(x, rank), "cw": shard(cw, rank)},
                           (out, gx))[0]
    res["ring1_is_own_group"] = (
        CommContext.instance().group(1) is not CommContext.instance().group(0))
    # the int8-wire sum through the op
    flags.set_flags({"quantized_allreduce": True})
    try:
        main, startup, out, gx = build_op(tfluid, "c_allreduce_sum")
        res["quantized_op"] = _dp_run(
            tfluid, main, startup,
            {"x": shard(x, rank), "cw": shard(cw, rank)}, (out, gx))[0]
    finally:
        flags.set_flags({"quantized_allreduce": False})

    # the stream syncs and the bootstrap ops
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        xv = tfluid.layers.data(name="x", shape=[COLS], dtype="float32")
        helper = tfluid.layer_helper.LayerHelper("sync")
        a = helper.create_variable_for_type_inference(dtype="float32")
        b = helper.create_variable_for_type_inference(dtype="float32")
        helper.append_op(type="c_sync_calc_stream", inputs={"X": [xv]},
                         outputs={"Out": [a]})
        helper.append_op(type="c_sync_comm_stream", inputs={"X": [a]},
                         outputs={"Out": [b]})
        sb = startup.global_block()
        for t in ("c_gen_nccl_id", "gen_nccl_id", "c_comm_init_all"):
            sb.append_op(type=t, inputs={}, outputs={}, attrs={})
        sb.append_op(type="c_comm_init", inputs={}, outputs={},
                     attrs={"ring_id": 2, "nranks": world, "rank": rank})
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    res["ring2_made"] = CommContext.instance().has(2)
    res["sync"] = exe.run(main, feed={"x": shard(op_data("allreduce")[0],
                                                 rank)},
                          fetch_list=[b], scope=scope)[0]

    # the quantized collective called directly
    xq = np.random.RandomState(0).randn(world, 333).astype("float32")
    res["q_sum"] = qar.quantized_psum(torch.tensor(xq[rank])).numpy()
    res["q_mean"] = qar.quantized_pmean(torch.tensor(xq[rank])).numpy()
    x3 = np.random.RandomState(1).randn(world, 5, 7).astype("float32")
    res["q_shape"] = tuple(qar.quantized_psum(torch.tensor(x3[rank])).shape)
    res["q_bf16"] = str(qar.quantized_psum(
        torch.tensor(x3[rank]).bfloat16()).dtype)
    x5 = np.random.RandomState(5).randn(world, 16).astype("float32")
    t = torch.tensor(x5[rank], requires_grad=True)
    qar.quantized_psum(t * t).sum().backward()
    res["q_grad"] = t.grad.numpy()

    # sync_batch_norm
    main, startup, y, gx = build_sync_bn(tfluid)
    xb, cwb = bn_data()
    outs, scope = _dp_run(tfluid, main, startup,
                          {"x": shard(xb, rank), "cw": shard(cwb, rank)},
                          (y, gx) + BN_FETCH)
    res["sync_bn"] = outs
    res["sync_bn_state"] = [scope.get(n).numpy().copy() for n in BN_STATE]
    res["rs_odd"] = rank_reducescatter_odd()
    return res


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return tworld.run_world(HERE + ":rank_main", N,
                            str(tmp_path_factory.mktemp("collective_world")))


@pytest.fixture(scope="module")
def jfluid():
    import paddle_tpu.fluid as jfluid

    return jfluid


@pytest.fixture(scope="module")
def two_devices():
    import jax

    return jax.devices()[:N]


def joined(world, key, i=None):
    parts = [r[key] if i is None else r[key][i] for r in world]
    return np.concatenate(parts, axis=0)


# ---------------------------------------------------------------------------
# numpy
# ---------------------------------------------------------------------------
def numpy_op(case, x, cw):
    """Each rank's (out, grad of x) for the rewritten program (the loss
    gradient scaled by 1/N), joined on dim 0."""
    xs = x.reshape(N, ROWS, COLS)
    rows = OPS[case][2]
    cws = cw.reshape(N, rows, COLS) / N
    c = cws.sum(0)
    outs, grads = [], []
    for r in range(N):
        if case in ("c_allreduce_sum", "allreduce"):
            o, g = xs.sum(0), c
        elif case in ("c_allreduce_max", "c_allreduce_min"):
            ext = xs.max(0) if case.endswith("max") else xs.min(0)
            hit = (xs == ext).astype("float32")
            o, g = ext, c * hit[r] / hit.sum(0)
        elif case == "c_allreduce_prod":
            others = np.prod(np.delete(xs, r, axis=0), axis=0)
            o, g = xs.prod(0), c * others
        elif case == "c_allgather":
            o, g = x, c[r * ROWS:(r + 1) * ROWS]
        elif case == "c_reducescatter":
            o = xs.sum(0)[r * rows:(r + 1) * rows]
            g = cws.reshape(N * rows, COLS)
        else:
            root = OPS[case][1]["root"]
            o, g = xs[root], c if r == root else np.zeros_like(c)
        outs.append(o)
        grads.append(g)
    return np.concatenate(outs), np.concatenate(grads)


@pytest.mark.parametrize("case", sorted(OPS))
def test_c_op_and_grad_match_numpy(world, case):
    x, cw = op_data(case)
    want_out, want_grad = numpy_op(case, x, cw)
    got_out = np.concatenate([r["ops"][case][0] for r in world])
    got_grad = np.concatenate([r["ops"][case][1] for r in world])
    np.testing.assert_allclose(got_out, want_out, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_grad, want_grad, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", sorted(OPS))
def test_c_op_and_grad_match_reference(world, jfluid, two_devices, case):
    """The reference's ``with_data_parallel`` on 2 devices: the same
    outputs (1e-6) and, where JAX can differentiate the op, the same
    gradients (1e-5)."""
    x, cw = op_data(case)
    main, startup, out, gx = build_op(jfluid, case,
                                      grad=case not in NO_REFERENCE_GRAD)
    fetch = (out,) if gx is None else (out, gx)
    want, _scope = _dp_run(jfluid, main, startup, {"x": x, "cw": cw}, fetch,
                           places=two_devices)
    got_out = np.concatenate([r["ops"][case][0] for r in world])
    np.testing.assert_allclose(got_out, want[0], rtol=1e-6, atol=1e-6)
    if case not in NO_REFERENCE_GRAD:
        got_grad = np.concatenate([r["ops"][case][1] for r in world])
        np.testing.assert_allclose(got_grad, want[1], rtol=1e-5, atol=1e-6)


def test_second_ring_is_its_own_group_with_the_same_sums(world):
    for r in world:
        assert r["ring1_is_own_group"]
        assert r["ring2_made"]   # c_comm_init made ring 2's group
        for a, b in zip(r["ring1"], r["ops"]["c_allreduce_sum"]):
            np.testing.assert_array_equal(a, b)


def test_stream_syncs_are_identities_and_bootstrap_ops_run(world):
    x = op_data("allreduce")[0]
    np.testing.assert_array_equal(joined(world, "sync"), x)


def test_quantized_sum_close_to_exact(world):
    """``test_quantized_allreduce.py``'s bound: each element within ~2
    quantization steps of the block absmax on each hop."""
    x = np.random.RandomState(0).randn(N, 333).astype("float32")
    exact = x.sum(0)
    bound = 4 * (np.abs(x).max() * N) / 127.0
    for r in world:
        assert np.abs(r["q_sum"] - exact).max() <= bound
        assert np.corrcoef(r["q_sum"], exact)[0, 1] > 0.999
        assert np.abs(r["q_mean"] - exact / N).max() <= bound / N
    np.testing.assert_array_equal(world[0]["q_sum"], world[1]["q_sum"])


def test_quantized_sum_keeps_shape_and_dtype(world):
    for r in world:
        assert r["q_shape"] == (5, 7)
        assert r["q_bf16"] == "torch.bfloat16"


def test_quantized_sum_gradient_is_straight_through(world):
    """d/dx sum(psum(x²)) = 2x · N, as the exact sum's."""
    x = np.random.RandomState(5).randn(N, 16).astype("float32")
    for rank, r in enumerate(world):
        np.testing.assert_allclose(r["q_grad"], 2 * x[rank] * N, rtol=1e-5)


def test_quantized_flag_routes_the_op_and_keeps_its_grad(world):
    x, cw = op_data("c_allreduce_sum")
    want_out, want_grad = numpy_op("c_allreduce_sum", x, cw)
    got_out = joined(world, "quantized_op", 0)
    bound = 4 * (np.abs(x).max() * N) / 127.0
    assert np.abs(got_out - want_out).max() <= bound
    assert not np.array_equal(got_out, want_out)   # the int8 wire ran
    np.testing.assert_allclose(joined(world, "quantized_op", 1), want_grad,
                               rtol=1e-5, atol=1e-6)


def _numpy_bn(x, cw):
    axes = (0, 2, 3)
    mean = x.mean(axes)
    var = (x.astype("float64") ** 2).mean(axes) - mean.astype("float64") ** 2
    inv = 1.0 / np.sqrt(var + BN_EPS)
    xhat = (x - mean[None, :, None, None]) * inv[None, :, None, None]
    return xhat.astype("float32"), mean, var


def test_sync_batch_norm_normalizes_the_joined_batch(world):
    """Y is batch norm over both ranks' rows (numpy on the joined batch,
    1e-5), the running stats move by the joined statistics on every
    rank, and the ranks' parameter grads agree."""
    xb, cwb = bn_data()
    y, mean, var = _numpy_bn(xb, cwb)
    np.testing.assert_allclose(joined(world, "sync_bn", 0), y, rtol=1e-5,
                               atol=1e-5)
    for r in world:
        np.testing.assert_allclose(r["sync_bn_state"][0], 0.1 * mean,
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["sync_bn_state"][1], 0.9 + 0.1 * var,
                                   rtol=1e-5, atol=1e-6)
    for i in (2, 3):
        np.testing.assert_array_equal(world[0]["sync_bn"][i],
                                      world[1]["sync_bn"][i])


def test_sync_batch_norm_matches_reference(world, jfluid, two_devices):
    """The reference's ``sync_batch_norm`` under its ``with_data_parallel``
    on 2 devices: Y, the gradient of X (1e-5), the parameter grads after
    the gradient all-reduce, and the running stats."""
    xb, cwb = bn_data()
    main, startup, y, gx = build_sync_bn(jfluid)
    want, scope = _dp_run(jfluid, main, startup, {"x": xb, "cw": cwb},
                          (y, gx) + BN_FETCH, places=two_devices)
    np.testing.assert_allclose(joined(world, "sync_bn", 0), want[0],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(joined(world, "sync_bn", 1), want[1],
                               rtol=1e-5, atol=1e-5)
    C = BN_SHAPE[1]
    for i in (2, 3):
        ref = want[i].reshape(-1, C)
        for r in world:
            np.testing.assert_allclose(r["sync_bn"][i], ref[0], rtol=1e-5,
                                       atol=1e-5)
    for k, n in enumerate(BN_STATE):
        ref = np.asarray(scope.get(n)).reshape(-1, C)[0]
        np.testing.assert_allclose(world[0]["sync_bn_state"][k], ref,
                                   rtol=1e-5, atol=1e-6)


def test_collectives_are_identities_in_no_world():
    """A process in no world: every c_* op passes X through, its
    gradient the cotangent, as the reference's outside a mesh;
    sync_batch_norm is batch_norm."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    for case in ("c_allreduce_sum", "c_broadcast_root1", "c_allgather"):
        main, startup, out, gx = build_op(tfluid, case)
        x, _cw = op_data(case)
        cw = np.random.RandomState(3).randn(*x.shape).astype("float32")
        exe = tfluid.Executor(tfluid.CPUPlace())
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
        o, g = exe.run(main, feed={"x": x, "cw": cw}, fetch_list=[out, gx],
                       scope=scope)
        np.testing.assert_array_equal(o, x)
        np.testing.assert_array_equal(g, cw)
    xb, cwb = bn_data()
    main, startup, y, gx = build_sync_bn(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    (yv,) = exe.run(main, feed={"x": xb[:2], "cw": cwb[:2]}, fetch_list=[y],
                    scope=scope)
    np.testing.assert_allclose(yv, _numpy_bn(xb[:2], cwb[:2])[0], rtol=1e-5,
                               atol=1e-5)


def test_reducescatter_of_rows_not_divisible_raises(world):
    for r in world:
        assert "not a multiple" in r["rs_odd"]


def rank_reducescatter_odd():
    main, startup, out, gx = build_op(tfluid, "c_reducescatter")
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    try:
        exe.run(main, feed={"x": np.ones((3, COLS), "float32"),
                            "cw": np.ones((1, COLS), "float32")},
                fetch_list=[out], scope=scope)
    except Exception as e:  # noqa: BLE001 - the message is the result
        return str(e)
    return "no error"
