"""The serving front of the port (``paddle_tpu_torch.serving``: bucket
ladder, micro-batcher, predictor pool, metrics, ``InferenceServer``)
and its predictor (``paddle_tpu_torch.inference``) held against the JAX
package on the CPU.

- The reference's unit scenarios of ``tests/test_serving.py`` run
  against both packages' classes (``impl``), which must give the same
  results: bucket rounding and pad/unpad, the coalescer's timeout and
  full-batch cuts, admission shedding with ``retry_after_ms``, deadline
  shedding, incompatible shapes, row split, stop, mixed-seq coalescing,
  pool plan sharing and the plan-cache counters.
- The idle-server deadline case: the gather window cuts 2 ms before the
  request's deadline, and a worker that wakes later than that sheds it.
  CPython hands the interpreter to a woken thread only after up to one
  switch interval (5 ms) while another thread runs Python, so the cut
  fails whenever the process runs other Python; both packages keep that
  behaviour (ROADMAP queue C), and a test shows it.
- A predictor clone shares the parameters and stays isolated in what it
  writes; ``InferenceServer.infer`` on a tiny GPT predictor equals solo
  runs within 1e-5 (batch composition changes the fp32 products' order);
  ``generate`` through an engine built the reference's way
  (``DecodeEngine(cfg, scope=..., param_program=...)``) is token-exact
  with the JAX engine built the same way, over the predictor's own
  parameter tensors.
"""

import contextlib
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import inference as jinference
from paddle_tpu import serving as jserving
from paddle_tpu.fluid import flags as jflags
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.serving import batcher as jbatcher
from paddle_tpu.serving import decode as jdecode
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch import inference as tinference
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.fluid import profiler as tprofiler
from paddle_tpu_torch.kernels import _build as tbuild
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.serving import batcher as tbatcher
from paddle_tpu_torch.serving import decode as tdecode
from test_torch_cpu_math import pin_vector_math

pin_vector_math(2)  # 2 threads, vector math set up on one (see there)

IMPLS = {"jax": (jserving, jfluid.profiler), "torch": (tserving, tprofiler)}
impl = pytest.mark.parametrize("impl", sorted(IMPLS))
T = 16


def _counter(prof, name):
    return prof.get_counters().get(name, 0)


# ---------------------------------------------------------------------------
# bucket ladder: the port's plans and pads are the reference's
# ---------------------------------------------------------------------------


def test_bucket_rounding_and_shapes_are_the_references():
    for kw in (dict(max_batch=8), dict(max_batch=12),
               dict(max_batch=4, seq_buckets=[16, 32])):
        j, t = jserving.BucketLadder(**kw), tserving.BucketLadder(**kw)
        assert t.batch_buckets == j.batch_buckets
        assert t.shapes() == j.shapes()
        assert [t.batch_bucket(n) for n in range(1, t.max_batch + 1)] == \
            [j.batch_bucket(n) for n in range(1, j.max_batch + 1)]
        with pytest.raises(ValueError):
            t.batch_bucket(t.max_batch + 1)
    assert tserving.BucketLadder(max_batch=8).batch_buckets == [1, 2, 4, 8]


def test_bucket_pad_unpad_are_the_references():
    ids = np.arange(3 * 3, dtype=np.int64).reshape(3, 3)
    mask = np.ones((3, 3), dtype=np.float32)
    out = np.arange(4 * 4 * 2, dtype=np.float32).reshape(4, 4, 2)
    res = {}
    for name, mod in (("jax", jserving), ("torch", tserving)):
        lad = mod.BucketLadder(max_batch=8, seq_buckets=[4, 8],
                               seq_pad_value=99)
        padded, plan = lad.pad_feeds([ids, mask])
        (stripped,) = lad.unpad_outputs([out], plan)
        (scalar,) = lad.unpad_outputs([np.float32(7.0)], plan)
        res[name] = (padded, (plan.rows, plan.padded_rows, plan.seq,
                              plan.padded_seq), stripped, scalar)
    (jp, jplan, js, jsc), (tp, tplan, ts, tsc) = res["jax"], res["torch"]
    assert tplan == jplan == (3, 4, 3, 4)
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a, b)
    assert (tp[0][:, 3] == 99).all() and (tp[1][:3, 3] == 0.0).all()
    np.testing.assert_array_equal(ts, js)
    assert ts.shape == (3, 3, 2) and tsc == jsc == np.float32(7.0)


# ---------------------------------------------------------------------------
# micro-batch coalescer: both packages' MicroBatcher, same outcomes
# ---------------------------------------------------------------------------


class _RecordingRunner(object):
    def __init__(self, delay_s=0.0):
        self.calls = []
        self.delay_s = delay_s
        self.release = None  # optional Event to block on

    def __call__(self, feeds, rows):
        self.calls.append((rows, [tuple(a.shape) for a in feeds]))
        if self.release is not None:
            assert self.release.wait(5.0), "runner never released"
        if self.delay_s:
            time.sleep(self.delay_s)
        return [feeds[0] * 2.0]


@contextlib.contextmanager
def _batcher(impl, runner, **kw):
    mb = IMPLS[impl][0].MicroBatcher(runner, **kw)
    try:
        yield mb
    finally:
        if runner.release is not None:
            runner.release.set()
        mb.stop()


def _wait_first_call(runner):
    deadline = time.monotonic() + 2.0
    while not runner.calls and time.monotonic() < deadline:
        time.sleep(0.002)
    assert runner.calls, "worker never picked up the first request"


@impl
def test_coalescer_timeout_path_dispatches_partial_batch(impl):
    r = _RecordingRunner()
    with _batcher(impl, r, max_batch_size=8, batch_timeout_ms=30,
                  queue_depth=8, num_workers=1) as mb:
        x = np.ones((1, 4), np.float32)
        t0 = time.monotonic()
        out = mb.result(mb.submit([x]), timeout=5.0)
        waited = time.monotonic() - t0
        np.testing.assert_array_equal(out[0], x * 2.0)
        assert waited >= 0.02, waited  # held ~batch_timeout for peers
        assert r.calls == [(1, [(1, 4)])]


@impl
def test_coalescer_full_batch_cuts_before_timeout(impl):
    r = _RecordingRunner()
    with _batcher(impl, r, max_batch_size=4, batch_timeout_ms=500,
                  queue_depth=16, num_workers=1) as mb:
        x = np.ones((1, 4), np.float32)
        outs = []
        barrier = threading.Barrier(4)

        def client():
            barrier.wait()
            outs.append(mb.result(mb.submit([x]), timeout=5.0))

        t0 = time.monotonic()
        ts = [threading.Thread(target=client) for _ in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(10.0)
        elapsed = time.monotonic() - t0
        assert len(outs) == 4 and not any(t.is_alive() for t in ts)
        assert elapsed < 0.45, elapsed  # cut early, not at the 500 ms
        assert sum(rows for rows, _ in r.calls) == 4
        assert len(r.calls) <= 2, r.calls


@impl
def test_admission_queue_full_sheds_with_retry_after(impl):
    mod, prof = IMPLS[impl]
    r = _RecordingRunner()
    r.release = threading.Event()
    with _batcher(impl, r, max_batch_size=1, batch_timeout_ms=1,
                  queue_depth=2, num_workers=1) as mb:
        x = np.ones((1, 2), np.float32)
        c0 = _counter(prof, "serving_shed_overload")
        r1 = mb.submit([x])  # claimed by the worker, blocked in the runner
        _wait_first_call(r)
        r2, r3 = mb.submit([x]), mb.submit([x])  # queued to the limit
        with pytest.raises(mod.ServerOverloadedError) as ei:
            mb.submit([x])
        assert ei.value.retry_after_ms >= 1
        assert _counter(prof, "serving_shed_overload") - c0 == 1
        r.release.set()
        for req in (r1, r2, r3):
            np.testing.assert_array_equal(mb.result(req, timeout=5.0)[0],
                                          x * 2.0)


@impl
def test_deadline_exceeded_sheds_distinct_error_without_stalling(impl):
    mod, prof = IMPLS[impl]
    r = _RecordingRunner()
    r.release = threading.Event()
    with _batcher(impl, r, max_batch_size=1, batch_timeout_ms=1,
                  queue_depth=8, num_workers=1) as mb:
        x = np.ones((1, 2), np.float32)
        c0 = _counter(prof, "serving_shed_deadline")
        slow = mb.submit([x])  # occupies the single worker
        _wait_first_call(r)
        doomed = mb.submit([x], deadline_ms=10)  # expires while queued
        healthy = mb.submit([x])                 # behind it, no deadline
        time.sleep(0.05)
        r.release.set()
        np.testing.assert_array_equal(mb.result(slow, timeout=5.0)[0],
                                      x * 2.0)
        with pytest.raises(mod.DeadlineExceededError):
            mb.result(doomed, timeout=5.0)
        np.testing.assert_array_equal(mb.result(healthy, timeout=5.0)[0],
                                      x * 2.0)
        assert _counter(prof, "serving_shed_deadline") - c0 == 1


@impl
def test_idle_server_cuts_the_gather_at_the_deadline(impl):
    """A 60 ms deadline on an idle batcher with a 200 ms window: the
    gather cuts at the deadline, so the request completes (served, or
    shed if the worker woke past its 2 ms margin: the next test) well
    before the window ends."""
    mod = IMPLS[impl][0]
    r = _RecordingRunner()
    with _batcher(impl, r, max_batch_size=8, batch_timeout_ms=200,
                  queue_depth=8, num_workers=1) as mb:
        x = np.ones((1, 4), np.float32)
        t0 = time.monotonic()
        req = mb.submit([x], deadline_ms=60)
        try:
            out = mb.result(req, timeout=5.0)
            np.testing.assert_array_equal(out[0], x * 2.0)
        except mod.DeadlineExceededError:
            assert r.calls == []
        elapsed = time.monotonic() - t0
        assert elapsed < 0.19, elapsed


@impl
def test_deadline_cut_margin_is_below_the_interpreter_switch(impl):
    """The cause of the reference's idle-server flake, shown: while
    another thread runs Python, a worker woken at the cut (2 ms before
    the deadline) waits up to one switch interval for the interpreter.
    With the interval at 20 ms and one busy thread, the 60 ms request of
    an idle batcher is shed at dispatch in both packages."""
    mod = IMPLS[impl][0]
    r = _RecordingRunner()
    stop = threading.Event()

    def spin():
        while not stop.is_set():
            pass

    old = sys.getswitchinterval()
    spinner = threading.Thread(target=spin, daemon=True)
    try:
        with _batcher(impl, r, max_batch_size=8, batch_timeout_ms=200,
                      queue_depth=8, num_workers=1) as mb:
            sys.setswitchinterval(0.02)
            spinner.start()
            t0 = time.monotonic()
            req = mb.submit([np.ones((1, 4), np.float32)], deadline_ms=60)
            with pytest.raises(mod.DeadlineExceededError):
                mb.result(req, timeout=5.0)
            assert time.monotonic() - t0 < 0.19
            assert r.calls == []
    finally:
        stop.set()
        sys.setswitchinterval(old)
        spinner.join(5.0)
    assert not spinner.is_alive()


@impl
def test_incompatible_shapes_never_coalesce(impl):
    r = _RecordingRunner()
    with _batcher(impl, r, max_batch_size=8, batch_timeout_ms=100,
                  queue_depth=16, num_workers=1) as mb:
        a = mb.submit([np.ones((1, 4), np.float32)])
        b = mb.submit([np.ones((1, 6), np.float32)])
        mb.result(a, timeout=5.0)
        mb.result(b, timeout=5.0)
        shapes = [feeds for _, feeds in r.calls]
        assert [(1, 4)] in shapes and [(1, 6)] in shapes
        assert len(r.calls) == 2, r.calls


@impl
def test_multi_row_requests_and_row_split(impl):
    r = _RecordingRunner()
    with _batcher(impl, r, max_batch_size=8, batch_timeout_ms=50,
                  queue_depth=16, num_workers=1) as mb:
        a = np.arange(2 * 3, dtype=np.float32).reshape(2, 3)
        b = np.arange(100, 100 + 3 * 3, dtype=np.float32).reshape(3, 3)
        ra, rb = mb.submit([a]), mb.submit([b])
        np.testing.assert_array_equal(mb.result(ra, 5.0)[0], a * 2.0)
        np.testing.assert_array_equal(mb.result(rb, 5.0)[0], b * 2.0)
        for bad in (np.ones((9, 3), np.float32), np.ones((0, 3), np.float32),
                    np.float32(1.0)):
            with pytest.raises(ValueError):
                mb.submit([bad])


@impl
def test_stop_completes_pending_requests(impl):
    mod = IMPLS[impl][0]
    r = _RecordingRunner()
    r.release = threading.Event()
    mb = mod.MicroBatcher(r, max_batch_size=1, batch_timeout_ms=1,
                          queue_depth=8, num_workers=1)
    x = np.ones((1, 2), np.float32)
    inflight = mb.submit([x])
    _wait_first_call(r)
    queued = mb.submit([x])
    r.release.set()
    mb.stop()
    mb.result(inflight, timeout=5.0)  # ran before/during stop
    with pytest.raises(mod.ServingError):
        mb.result(queued, timeout=5.0)
    with pytest.raises(mod.ServingError):
        mb.submit([x])  # a stopped batcher admits nothing


def test_port_error_classes_are_one_hierarchy():
    assert tbatcher.ServerOverloadedError.__mro__[1] is tbatcher.ServingError
    assert issubclass(tbatcher.DeadlineExceededError, RuntimeError)
    assert tdecode.ServingError is tbatcher.ServingError
    assert jbatcher.ServingError is not tbatcher.ServingError


class _EchoPredictor(object):
    """run() echoes feed 0 doubled; shape-stable for ladder tests."""

    def run(self, feeds):
        return [np.asarray(feeds[0]) * 2.0]

    def clone(self, share_plans=True):
        return self


@impl
def test_mixed_seq_lengths_coalesce_via_admission_alignment(impl):
    mod = IMPLS[impl][0]
    lad = mod.BucketLadder(max_batch=8, seq_buckets=[8], seq_pad_value=0)
    server = mod.InferenceServer(
        _EchoPredictor(), max_batch_size=8, batch_timeout_ms=100,
        queue_depth=16, num_workers=1, ladder=lad,
    ).start(warmup_inputs=[np.ones((1, 5), np.float32)])
    try:
        inputs = [np.full((1, s), float(s), np.float32) for s in (5, 6, 7, 8)]
        reqs = [server.submit([a], deadline_ms=10000) for a in inputs]
        outs = [server.result(r, timeout=5.0) for r in reqs]
        for a, (o,) in zip(inputs, outs):
            assert o.shape == a.shape, (o.shape, a.shape)
            np.testing.assert_array_equal(o, a * 2.0)
        st = server.stats()
        assert st.batches <= 2, st.as_dict()
        assert st.batched_rows == 4
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# predictors: pool sharing, the plan-cache counters, server over a model
# ---------------------------------------------------------------------------


def _save_tiny_model(mod, dirname, dim=8, classes=3):
    fl = jfluid if mod == "jax" else tfluid
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        x = fl.layers.data(name="x", shape=[dim], dtype="float32")
        out = fl.layers.softmax(fl.layers.fc(x, size=classes))
    scope = fl.core.Scope()
    exe = fl.Executor(fl.CPUPlace())
    with fl.scope_guard(scope):
        exe.run(startup, scope=scope)
        fl.io.save_inference_model(dirname, ["x"], [out], exe,
                                   main_program=main)


def _predictor(impl, d):
    if impl == "jax":
        return jinference.create_paddle_predictor(
            jinference.AnalysisConfig(d))
    cfg = tinference.AnalysisConfig(d)
    cfg.disable_gpu()
    return tinference.create_paddle_predictor(cfg)


@impl
def test_predictor_pool_shares_plans(impl, tmp_path):
    mod, prof = IMPLS[impl]
    d = str(tmp_path)
    _save_tiny_model(impl, d)
    pred = _predictor(impl, d)
    c0 = _counter(prof, "executor_plan_builds")
    pool = mod.PredictorPool(pred, size=3)
    assert pool.size == 3 and pool.free_count == 3
    assert all(m._plan_holder is pred._plan_holder for m in pool._all)
    x = np.random.RandomState(0).rand(2, 8).astype("float32")
    ref = pred.run([x])[0]
    for m in pool._all[1:]:
        np.testing.assert_allclose(m.run([x])[0], ref, rtol=1e-6)
    if impl == "torch":
        # one Executor plan serves the whole pool
        assert _counter(prof, "executor_plan_builds") - c0 == 1
    iso = pred.clone(share_plans=False)
    assert iso._plan_holder is not pred._plan_holder
    np.testing.assert_allclose(iso.run([x])[0], ref, rtol=1e-6)


@impl
def test_predictor_plan_cache_counters(impl, tmp_path):
    prof = IMPLS[impl][1]
    d = str(tmp_path)
    _save_tiny_model(impl, d)
    pred = _predictor(impl, d)
    x = np.random.RandomState(1).rand(4, 8).astype("float32")
    hits, misses = "predictor_plan_cache_hits", "predictor_plan_cache_misses"
    h0, m0 = _counter(prof, hits), _counter(prof, misses)
    pred.run([x])
    pred.run([x])
    pred.run([x[:2]])  # new shape -> miss
    pred.clone().run([x])  # the clone shares the record -> hit
    assert (_counter(prof, misses) - m0, _counter(prof, hits) - h0) == (2, 2)
    bad = np.random.RandomState(2).rand(4, 7).astype("float32")
    for _ in range(2):  # a failed run records nothing: retries stay misses
        with pytest.raises(Exception):
            pred.run([bad])
    assert (_counter(prof, misses) - m0, _counter(prof, hits) - h0) == (4, 2)


def test_config_switches_warn_once_and_name_no_tpu():
    tinference._warned_noop.clear()
    cfg = tinference.AnalysisConfig("/nonexistent")
    with pytest.warns(UserWarning, match="GPU") as rec:
        cfg.enable_tensorrt_engine(workspace_size=1 << 20)
    assert "TPU" not in str(rec[0].message)
    with pytest.warns(UserWarning, match="enable_mkldnn"):
        cfg.enable_mkldnn()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        cfg2 = tinference.AnalysisConfig("/nonexistent")
        cfg2.enable_tensorrt_engine()
        cfg2.enable_mkldnn()
    cfg2.enable_use_gpu(100, device_id=1)
    assert cfg2.use_gpu() and cfg2.place() == tfluid.CUDAPlace(1)
    cfg2.disable_gpu()
    assert not cfg2.use_gpu() and cfg2.place() == tfluid.CPUPlace()
    for name in ("save_optimized_model", "from_executable"):
        with pytest.raises(NotImplementedError, match="A5b"):
            getattr(tinference.AnalysisPredictor, name)(None)


def test_predictor_clone_shares_parameters_and_isolates_writes(tmp_path):
    d = str(tmp_path)
    _save_tiny_model("torch", d)
    pred = _predictor("torch", d)
    clone = pred.clone()
    names = pred.scope.local_var_names()
    assert names and sorted(clone.scope.local_var_names()) == sorted(names)
    for n in names:
        assert clone.scope.get(n).data_ptr() == pred.scope.get(n).data_ptr()
    x = np.random.RandomState(3).rand(2, 8).astype("float32")
    (want,) = pred.run([x])
    w = [n for n in names if n.endswith(".w_0")][0]
    clone.scope.set(w, torch.zeros_like(pred.scope.get(w)))
    (moved,) = clone.run([x])
    np.testing.assert_allclose(moved, np.full_like(want, 1.0 / 3), atol=1e-6)
    np.testing.assert_array_equal(pred.run([x])[0], want)
    # zero-copy API: inputs stay on the device, outputs read on demand
    pred.get_input_tensor("x").copy_from_cpu(x[:1])
    pred.zero_copy_run()
    out = pred.get_output_tensor(pred.get_output_names()[0]).copy_to_cpu()
    np.testing.assert_array_equal(out, want[:1])
    with pytest.raises(KeyError):
        pred.get_input_tensor("nope")


@impl
def test_server_deadline_shed_and_stats_surface(impl, tmp_path):
    mod = IMPLS[impl][0]
    d = str(tmp_path)
    _save_tiny_model(impl, d)
    pred = _predictor(impl, d)
    x = np.random.RandomState(2).rand(1, 8).astype("float32")
    server = mod.InferenceServer(pred, max_batch_size=4, batch_timeout_ms=20,
                                 queue_depth=8, num_workers=1)
    server.start(warmup_inputs=[x])
    try:
        with pytest.raises(mod.DeadlineExceededError):
            server.infer([x], deadline_ms=0.01)  # expires in the gather
        (out,) = server.infer([x], deadline_ms=5000)
        assert out.shape == (1, 3)
        st = server.stats()
        assert st.shed_deadline == 1 and st.completed >= 1
        assert st.latency_ms["count"] == st.completed
        assert st.bucket_hit_rate == 1.0 and st.plan_cache_misses == 0
    finally:
        server.stop()
    # a second server's latency percentiles start from its own samples
    server = mod.InferenceServer(pred, max_batch_size=2, batch_timeout_ms=1,
                                 queue_depth=8, num_workers=1)
    server.start(warmup_inputs=[x])
    try:
        for _ in range(2):
            server.infer([x], deadline_ms=5000)
        assert server.stats().latency_ms["count"] == 2
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# GPT through the predictor, the server and the attached engine
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _reference_decode_defaults():
    """The reference's decode/KV-tier/scheduler knobs at their defaults
    while its engine runs (other modules leave them set), then back."""
    names = ["FLAGS_" + k for k in jflags._DEFAULTS
             if k.startswith(("decode_", "spmd_decode_", "kv_tier_", "sched_"))]
    saved = jflags.get_flags(names)
    jflags.set_flags({n: jflags._DEFAULTS[n[len("FLAGS_"):]] for n in names})
    try:
        yield
    finally:
        jflags.set_flags(saved)


@pytest.fixture(scope="module")
def gpt_rig():
    """A tiny GPT (max_len 32) saved by the reference from its startup
    scope, loaded by the port's predictor; the reference's program and
    scope kept for its engine."""
    cfg = jgpt.GPTConfig.tiny(use_flash_attention=True,
                              max_position_embeddings=32,
                              hidden_dropout=0.0, attention_dropout=0.0)
    with jfluid.unique_name.guard():
        infer, startup, feeds, logits = jgpt.build_gpt_infer(cfg, 32)
    infer.random_seed = startup.random_seed = 11
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.core.Scope()
    d = tempfile.mkdtemp(prefix="torch_serving_")
    with jfluid.scope_guard(scope):
        exe.run(startup)
        jfluid.io.save_inference_model(d, feeds, [logits], exe,
                                       main_program=infer)
    tcfg = tgpt.GPTConfig.tiny(use_flash_attention=True,
                               max_position_embeddings=32)
    return {"cfg": cfg, "tcfg": tcfg, "infer": infer, "scope": scope,
            "dir": d, "pred": _predictor("torch", d)}


def _gpt_request(seq, seed):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 211, (1, seq, 1)).astype(np.int64),
            np.arange(seq).reshape(1, seq, 1).astype(np.int64),
            np.ones((1, seq, 1), np.float32)]


def test_server_infer_on_gpt_equals_solo_runs(gpt_rig):
    pred = gpt_rig["pred"]
    lad = tserving.BucketLadder(max_batch=4, seq_buckets=[8, 16])
    server = tserving.InferenceServer(pred, max_batch_size=4,
                                      batch_timeout_ms=20, num_workers=2,
                                      ladder=lad)
    server.start(warmup_inputs=[_gpt_request(16, 0)[i] for i in range(3)])
    base = dict(tprofiler.get_counters(), kernel_builds=tbuild.builds)
    try:
        reqs = [_gpt_request(seq, i)
                for i, seq in enumerate((3, 8, 5, 16, 11, 7, 13, 2))]
        handles = [server.submit(r, deadline_ms=30000) for r in reqs]
        outs = [server.result(h, timeout=30.0)[0] for h in handles]
        st = server.stats()
        after = dict(tprofiler.get_counters(), kernel_builds=tbuild.builds)
    finally:
        server.stop()
    for k in ("predictor_plan_cache_misses", "executor_plan_builds",
              "kernel_builds"):
        assert after.get(k, 0) == base.get(k, 0), k
    assert st.bucket_hit_rate == 1.0 and st.completed == len(reqs)
    for r, out in zip(reqs, outs):
        (solo,) = pred.run(r)
        assert out.shape == solo.shape == (1, r[0].shape[1], 211)
        np.testing.assert_allclose(out, solo, rtol=0, atol=1e-5)


def test_engine_reference_form_shares_the_scope_and_matches_jax(gpt_rig):
    """``DecodeEngine(cfg, place, scope, param_program=...)``: the port's
    engine over the predictor's scope, served through
    ``InferenceServer.generate``, against the JAX engine built the same
    way over the reference's scope; greedy tokens equal."""
    pred = gpt_rig["pred"]
    engine = tdecode.DecodeEngine(gpt_rig["tcfg"], place=tfluid.CPUPlace(),
                                  scope=pred.scope, param_program=pred.program,
                                  slots=2, max_len=32)
    shared = {p.data_ptr() for p in engine.model.parameters()}
    held = {pred.scope.get(n).data_ptr()
            for n in tgpt.fluid_param_shapes(gpt_rig["tcfg"])}
    assert shared == held
    server = tserving.InferenceServer(pred, decode_engine=engine).start()
    prompts = [[int(t) for t in np.random.RandomState(s).randint(0, 211, n)]
               for s, n in ((0, 5), (1, 12))]
    try:
        streams = [server.generate(p, max_new_tokens=8) for p in prompts]
        got = [s.tokens(timeout=60) for s in streams]
    finally:
        server.stop()
    assert not engine.started  # the server started it, the server stopped it
    with _reference_decode_defaults():
        jengine = jdecode.DecodeEngine(
            gpt_rig["cfg"], scope=gpt_rig["scope"],
            param_program=gpt_rig["infer"], slots=2, max_len=32).start()
        try:
            want = [jengine.generate(p, max_new_tokens=8).tokens(timeout=60)
                    for p in prompts]
        finally:
            jengine.stop()
    assert got == want
    with pytest.raises(NotImplementedError, match="A12"):
        tdecode.DecodeEngine(gpt_rig["tcfg"], place=tfluid.CPUPlace(),
                             scope=pred.scope, tp=2)
    model = tgpt.GPTLM(gpt_rig["tcfg"], device="cpu")
    with pytest.raises(ValueError):
        tdecode.DecodeEngine(model, scope=pred.scope)
    with pytest.raises(KeyError):
        tdecode.DecodeEngine(gpt_rig["tcfg"], place=tfluid.CPUPlace(),
                             scope=tfluid.Scope())
