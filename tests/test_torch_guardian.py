"""The port's training guardian (``distributed/guardian.py``) held
against the JAX package on the CPU: the robust window's verdicts, the
health partials and the state digest, the skip -> rollback -> giveup
ladder on the same poisoned stream, and the skip's restore, which in the
port copies the pre-step state back into tensors that the ``sgd``,
``momentum`` and ``adam`` ops updated in place.

Values cross as numpy arrays; tolerances are stated at each comparison.
"""

import math

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import checkpoint as jcheckpoint
from paddle_tpu.distributed import guardian as jguard
from paddle_tpu.fluid.trainer import MultiTrainer as JMultiTrainer
from paddle_tpu.testing import chaos as jchaos
from paddle_tpu_torch import checkpoint as tcheckpoint
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.distributed import guardian as tguard
from paddle_tpu_torch.fluid import trainer as ttrainer
from paddle_tpu_torch.testing import chaos as tchaos
from test_torch_cpu_math import pin_vector_math

pin_vector_math(2)  # 2 threads, vector math set up on one (see there)

_GUARD_FLAGS = ["guardian_enable", "guardian_warmup_steps",
                "guardian_max_skips", "guardian_max_rollbacks",
                "guardian_marker_dir", "guardian_spike_sigma",
                "chaos_nan_grad_at_step", "chaos_loss_spike_at_step",
                "chaos_marker_dir", "ckpt_save_interval_steps"]


@pytest.fixture()
def flags():
    """Set the same flags in both packages; restore after."""
    old = [(m, m.get_flags(_GUARD_FLAGS)) for m in (jfluid, tfluid)]

    def set_both(values):
        for m in (jfluid, tfluid):
            m.set_flags(dict(values))

    yield set_both
    for m, values in old:
        m.set_flags(values)
    jchaos.clear()
    tchaos.clear()


def _mlp(fluid_mod, optimizer="sgd"):
    with fluid_mod.unique_name.guard():
        main, startup = fluid_mod.Program(), fluid_mod.Program()
        main.random_seed = startup.random_seed = 11
        with fluid_mod.program_guard(main, startup):
            x = fluid_mod.layers.data(name="x", shape=[4], dtype="float32")
            y = fluid_mod.layers.data(name="y", shape=[1], dtype="int64")
            h = fluid_mod.layers.fc(input=x, size=8, act="relu")
            logits = fluid_mod.layers.fc(input=h, size=3)
            loss = fluid_mod.layers.mean(
                fluid_mod.layers.softmax_with_cross_entropy(logits, y))
            opt = {"sgd": lambda: fluid_mod.optimizer.SGD(0.05),
                   "momentum": lambda: fluid_mod.optimizer.Momentum(
                       0.05, momentum=0.9),
                   "adam": lambda: fluid_mod.optimizer.Adam(0.01)}[optimizer]
            opt().minimize(loss)
    return main, startup, loss


def _batch(seed=0, bad=None, scale=1.0):
    r = np.random.RandomState(seed)
    x = (r.rand(8, 4) * scale).astype("float32")
    if bad == "nan":
        x[0, 0] = np.nan
    return {"x": x, "y": r.randint(0, 3, (8, 1)).astype("int64")}


def _np(v):
    return np.array(v.numpy() if isinstance(v, torch.Tensor)
                    else np.asarray(v))


def _pair(optimizer="sgd"):
    """Both packages' program, started from the reference's startup
    scope: {pkg: (main, loss, executor, scope)}."""
    jmain, jstart, jloss = _mlp(jfluid, optimizer)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.core.Scope()
    jexe.run(jstart, scope=jscope)
    arrays = {v.name: _np(jscope.get(v.name)) for v in jmain.list_vars()
              if v.persistable and jscope.get(v.name) is not None}
    tmain, tstart, tloss = _mlp(tfluid, optimizer)
    texe = tfluid.Executor(tfluid.CPUPlace())
    tscope = tfluid.Scope()
    texe.run(tstart, scope=tscope)
    tfluid.load_program_scope(tmain, tscope, arrays)
    return {"reference": (jmain, jloss, jexe, jscope),
            "port": (tmain, tloss, texe, tscope)}


# ---------------------------------------------------------------------------
# the robust window
# ---------------------------------------------------------------------------
_SERIES = {
    "trend": [10.0 - 0.1 * i for i in range(30)] + [50.0, 7.0],
    "plateau_noise": [1.0 + 1e-4 * ((-1) ** i) for i in range(20)] + [1.3],
    "nonfinite": [1.0, 1.1, float("nan"), 1.0, float("inf")],
    "warmup_spike": [1.0, 100.0, 1.0, 1.0, 1.0, 1.02, 1e4],
}


@pytest.mark.parametrize("series", sorted(_SERIES))
def test_robust_window_verdicts_match_reference(series):
    j = jguard.RobustWindow(sigma=6.0, window=16, warmup=4)
    t = tguard.RobustWindow(sigma=6.0, window=16, warmup=4)
    want = [j.judge(x) for x in _SERIES[series]]
    got = [t.judge(x) for x in _SERIES[series]]
    assert [g[0] for g in got] == [w[0] for w in want]
    for (_, gz), (_, wz) in zip(got, want):
        assert gz == wz or (math.isinf(gz) and math.isinf(wz))
    assert any(g[0] for g in got)


# ---------------------------------------------------------------------------
# health partials and the state digest
# ---------------------------------------------------------------------------
def test_health_partials_match_reference_and_sum_the_squared_grads():
    """One partial per parameter gradient, the reference's names and
    values (1e-5 relative, one step from the same parameters); their sum
    is the summed squared gradients fetched beside them (1e-6)."""
    pair = _pair()
    out = {}
    for pkg, (main, loss, exe, scope) in pair.items():
        fluid_mod = tfluid if pkg == "port" else jfluid
        with fluid_mod.unique_name.guard():  # the same fresh names
            g = (tguard if pkg == "port" else jguard).attach_health_fetch(
                main)
        assert (tguard if pkg == "port" else jguard).attach_health_fetch(
            main) == g  # idempotent per program
        grads = [p.name + "@GRAD" for p in main.all_parameters()]
        vals = exe.run(main, feed=_batch(3), fetch_list=[loss] + g + grads,
                       scope=scope)
        out[pkg] = ([v.name for v in g], [float(np.asarray(v).sum())
                                          for v in vals[1:1 + len(g)]],
                    vals[1 + len(g):])
    assert out["port"][0] == out["reference"][0] and len(out["port"][0]) == 4
    np.testing.assert_allclose(out["port"][1], out["reference"][1],
                               rtol=1e-5)
    sq = sum(float((np.asarray(v, np.float64) ** 2).sum())
             for v in out["port"][2])
    assert abs(sum(out["port"][1]) - sq) <= 1e-6 * sq


def test_state_digest_matches_reference_and_sees_one_ulp():
    pair = _pair()
    names = sorted(p.name for p in pair["port"][0].all_parameters())
    jscope, tscope = pair["reference"][3], pair["port"][3]
    for health in (None, 1.25):
        want = jguard.state_digest(names, jscope, health=health)
        assert tguard.state_digest(names, tscope, health=health) == want
    w = tscope.get(names[0])
    w.view(torch.int32).reshape(-1)[0] ^= 1
    assert tguard.state_digest(names, tscope) != jguard.state_digest(
        names, jscope)


# ---------------------------------------------------------------------------
# the ladder
# ---------------------------------------------------------------------------
def _outs(g, loss, health):
    partials = [np.zeros(1, "float32") for _ in g.health_vars]
    partials[0] = np.array([health * health if math.isfinite(health)
                            else health], "float32")
    return [np.array([loss], "float32")] + partials


_STREAM = [(0, 1.0, 2.0), (1, 1.01, 2.0), (2, 0.99, 2.1), (3, 1.0, 2.0),
           (4, float("nan"), 1.0), (5, 1.0, 2.0), (6, 1.0, 400.0),
           (7, 1.0, 2.0), (8, 60.0, 2.0)]


def _verdicts(mod, fluid_mod, marker_dir):
    fluid_mod.set_flags({"guardian_enable": True,
                         "guardian_warmup_steps": 3,
                         "guardian_max_skips": 1,
                         "guardian_max_rollbacks": 1,
                         "guardian_marker_dir": marker_dir})
    main, _st, _loss = _mlp(fluid_mod)
    g = mod.Guardian.maybe_create(main)
    g.ckpt_manager = object()  # present: the ladder may offer rollback
    out = []
    for step, loss, health in _STREAM:
        try:
            out.append(g.post_step(step, _outs(g, loss, health))[1])
        except mod.RollbackSignal as e:
            out.append(("rollback", e.step, e.kind))
            g.rollbacks_used += 1
        except mod.GuardianGiveup as e:
            out.append(("giveup", e.report["anomaly_step"],
                        e.report["kind"]))
    return out, sorted(g.drop_steps), g.stats


def test_ladder_verdicts_match_reference_on_a_poisoned_stream(flags,
                                                              tmp_path):
    flags({})
    want = _verdicts(jguard, jfluid, str(tmp_path / "j"))
    got = _verdicts(tguard, tfluid, str(tmp_path / "t"))
    assert got == want
    assert got[0][4] == "skip" and got[0][6][0] == "rollback" and \
        got[0][8][0] == "giveup"


def test_guardian_disarmed_by_default_and_for_pipeline_programs(flags):
    main, _st, _loss = _mlp(tfluid)
    assert tguard.Guardian.maybe_create(main) is None
    flags({"guardian_enable": True})
    main._pipeline_config = {"cut": 1}
    assert tguard.Guardian.maybe_create(main) is None


# ---------------------------------------------------------------------------
# the skip under in-place optimizers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("optimizer", ["sgd", "momentum", "adam"])
def test_skip_restores_bit_for_bit_under_in_place_optimizers(flags,
                                                             optimizer):
    """``pre_step`` copies the state; the step's optimizer ops update
    parameters and accumulators in place; ``restore_skip`` puts every
    persistable back bit for bit in the same tensors, and the generator
    states with them."""
    flags({"guardian_enable": True})
    main, loss, exe, scope = _pair(optimizer)["port"]
    g = tguard.Guardian.maybe_create(main)
    exe.run(main, feed=_batch(0), fetch_list=g.wrap_fetches([loss]),
            scope=scope)
    before = {n: scope.get(n).clone() for n in g._persist_names}
    ptrs = {n: scope.get(n).data_ptr() for n in g._persist_names}
    rng = scope.rng_states()
    g.pre_step(scope)
    exe.run(main, feed=_batch(1), fetch_list=g.wrap_fetches([loss]),
            scope=scope)
    assert any(not torch.equal(scope.get(n), before[n]) for n in before)
    g.restore_skip(scope)
    for n in before:
        assert torch.equal(scope.get(n), before[n]), n
        assert scope.get(n).data_ptr() == ptrs[n], n
    after = scope.rng_states()
    assert all(torch.equal(after[k][i], rng[k][i])
               for k in rng for i in (0, 1))


# ---------------------------------------------------------------------------
# the armed trainer against the reference's
# ---------------------------------------------------------------------------
class _Dataset(object):
    def __init__(self, fluid_mod, main, n, bad):
        self.use_var = [main.global_block().var("x"),
                        main.global_block().var("y")]
        self.thread_num = 1
        self._n, self._bad = n, bad

    def _iter_batches(self):
        for i in range(self._n):
            b = _batch(i, scale=40.0 if i == self._bad else 1.0)
            yield [b["x"], b["y"]]


def test_armed_trainer_skips_and_rolls_back_as_reference(flags, tmp_path):
    """The same 12-step stream through each package's MultiTrainer with
    the guardian armed: a chaos NaN poison at step 6 is skipped, a batch
    scaled 40x at step 9 spikes and rolls back to the newest verified
    checkpoint; both packages count the same anomalies, skips and
    rollbacks, drop the same steps, and end at the same step."""
    out = {}
    for pkg, (fluid_mod, ck, trainer_cls) in {
            "reference": (jfluid, jcheckpoint, JMultiTrainer),
            "port": (tfluid, tcheckpoint, ttrainer.MultiTrainer)}.items():
        flags({"guardian_enable": True, "guardian_warmup_steps": 3,
               "guardian_max_skips": 1, "guardian_max_rollbacks": 1,
               "guardian_marker_dir": str(tmp_path / pkg / "markers"),
               "chaos_nan_grad_at_step": 6,
               "chaos_marker_dir": str(tmp_path / pkg / "chaos"),
               "ckpt_save_interval_steps": 4})
        main, startup, loss = _mlp(fluid_mod)
        exe = fluid_mod.Executor(fluid_mod.CPUPlace())
        scope = fluid_mod.Scope() if fluid_mod is tfluid else \
            fluid_mod.core.Scope()
        exe.run(startup, scope=scope)
        prof = fluid_mod.profiler
        c0 = {k: prof.get_counter(k) for k in (
            "train_anomalies", "train_skipped_steps", "train_rollbacks")}
        mgr = ck.CheckpointManager(str(tmp_path / pkg / "ck"))
        steps = trainer_cls().train(exe, main, _Dataset(fluid_mod, main, 12,
                                                        9),
                                    scope=scope, fetch_list=[loss],
                                    print_period=0, ckpt_manager=mgr)
        mgr.close()
        out[pkg] = (steps, {k: prof.get_counter(k) - v
                            for k, v in c0.items()}, mgr.all_steps())
    assert out["port"] == out["reference"]
    assert out["port"][1] == {"train_anomalies": 2,
                              "train_skipped_steps": 1,
                              "train_rollbacks": 1}
