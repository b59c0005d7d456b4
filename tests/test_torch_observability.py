"""The port's observability stack on the CPU, held against the
reference's where the reference has the same surface:

- ``observability/trace.py``: the W3C ``traceparent`` parse and format,
  ``trace_scope`` / ``current_context`` nesting, and ``chrome_trace``'s
  schema (top-level keys, event keys, args) against the reference's for
  the same recorded spans; a gateway adopting a client's
  ``traceparent``, stamping its ``gateway_request`` span and answering
  ``X-Trace-Id``; the engine re-entering a stream's context and listing
  its trace id on ``decode_tick`` spans (none for untraced streams); the
  batcher's dispatch span listing its batch's trace ids.
- ``observability/exporter.py``: ``/metrics`` through
  ``parse_prometheus`` equal to the live registry, ``/trace``,
  ``/compiles``, ``/healthz`` flipping on the preemption latch,
  ``maybe_start_from_flags`` / ``stop_global``, the final snapshot with
  its ``compiles`` roll-up and the black-box dumps.
- ``observability/flight.py``: note, dump, load, journeys, equal to the
  reference's for the same records.
- ``observability/compile_stats.py``, the strict gate: an Executor plan,
  a predictor plan and a kernel-library build inside a request window
  after arming raise ``SteadyStateRecompileError`` under the strict flag
  and count without it; ``warmup_window``, no request window, or no
  armed owner exempt; server and engine arm and disarm their counts.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from paddle_tpu.observability import flight as jflight
from paddle_tpu.observability import trace as jtrace
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch import inference as tinference
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.checkpoint import preempt as tpreempt
from paddle_tpu_torch.fluid import flags as tflags
from paddle_tpu_torch.fluid import profiler as tprofiler
from paddle_tpu_torch.kernels import _build as tbuild
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.observability import compile_stats
from paddle_tpu_torch.observability import exporter as texporter
from paddle_tpu_torch.observability import flight as tflight
from paddle_tpu_torch.observability import registry as tregistry
from paddle_tpu_torch.observability import trace as ttrace
from paddle_tpu_torch.tools.gateway_probe import _sse as sse
from test_torch_cpu_math import pin_vector_math

pin_vector_math(2)  # 2 threads, vector math set up on one (see there)

STRICT = "serving_strict_compiles"


def _flag_defaults():
    return {"FLAGS_" + k: v for k, v in tflags._DEFAULTS.items()
            if k.startswith(("serving_", "obs_", "trace_", "gateway_"))}


@pytest.fixture(autouse=True)
def _clean_process_state():
    """The gate, the latch, the exporter, the rings and the flags back
    to their defaults after every test (other files share this
    worker)."""
    compile_stats.reset()
    yield
    compile_stats.reset()
    tpreempt._reset_for_tests()
    texporter.stop_global()
    tflight.reset()
    tflags.set_flags(_flag_defaults())


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode("utf-8")
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode("utf-8")


# ---------------------------------------------------------------------------
# trace context
# ---------------------------------------------------------------------------

TRACEPARENTS = [
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
    "00-0AF7651916CD43DD8448EB211C80319C-B7AD6B7169203331-01",
    "  00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-00  ",
    "00-00000000000000000000000000000000-b7ad6b7169203331-01",
    "00-0af7651916cd43dd8448eb211c80319c-0000000000000000-01",
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b71692033-01",
    "garbage", "", None,
]


@pytest.mark.parametrize("header", TRACEPARENTS)
def test_traceparent_parse_matches_reference(header):
    assert ttrace.parse_traceparent(header) == \
        jtrace.parse_traceparent(header)


def test_traceparent_format_and_new_ids_match_reference():
    tid = ttrace.new_trace_id()
    assert len(tid) == 32 and int(tid, 16) >= 0
    assert ttrace.format_traceparent(tid, "b7ad6b7169203331") == \
        jtrace.format_traceparent(tid, "b7ad6b7169203331")
    assert ttrace.parse_traceparent(
        ttrace.format_traceparent(tid, "b7ad6b7169203331")) == \
        (tid, "b7ad6b7169203331")
    assert ttrace.TRACE_SCHEMA_VERSION == jtrace.TRACE_SCHEMA_VERSION


def test_trace_scope_chains_parents_and_hands_off_across_threads():
    ttrace.reset()
    tid = "ab" * 16
    assert ttrace.current_context() is None
    with ttrace.trace_scope(tid, "1" * 16):
        assert ttrace.current_context() == (tid, "1" * 16)
        with ttrace.span("outer") as outer:
            ctx = ttrace.current_context()
            assert ctx == (tid, outer.span_id)
            got = {}

            def worker():
                with ttrace.trace_scope(*ctx), ttrace.span("inner") as sp:
                    got["span"] = sp

            t = threading.Thread(target=worker)
            t.start()
            t.join()
        ttrace.instant("mark", cat="gateway", why="test")
    with ttrace.trace_scope(None):
        assert ttrace.current_context() is None
    spans = {s["name"]: s for s in ttrace.get_spans()}
    assert spans["outer"]["parent_span_id"] == "1" * 16
    assert spans["inner"]["parent_span_id"] == outer.span_id
    assert spans["inner"]["trace_id"] == tid and got["span"].trace_id == tid
    assert spans["mark"]["instant"] and spans["mark"]["args"] == \
        {"why": "test"}


def _record(mod):
    """The same spans in either tracer."""
    mod.reset()
    with mod.span("untraced", cat="host", rows=3):
        pass
    with mod.trace_scope("cd" * 16, "2" * 16):
        with mod.span("gateway_request", cat="gateway", endpoint="/x"):
            with mod.span("decode_tick", cat="serving", tick=1,
                          trace_ids=["cd" * 16]):
                pass
        mod.instant("splice", cat="router")
    return mod.chrome_trace()


def test_chrome_trace_schema_matches_reference():
    t, j = _record(ttrace), _record(jtrace)
    assert sorted(t) == sorted(j)
    assert t["schema_version"] == j["schema_version"] == 2
    assert sorted(t["clock_anchor"]) == sorted(j["clock_anchor"])
    tev = [e for e in t["traceEvents"] if e["ph"] != "M"]
    jev = [e for e in j["traceEvents"] if e["ph"] != "M"]
    assert [(e["name"], e["ph"], sorted(e), sorted(e["args"])) for e in tev] \
        == [(e["name"], e["ph"], sorted(e), sorted(e["args"])) for e in jev]
    for te, je in zip(tev, jev):
        for k in ("depth", "parent", "trace_id", "tick", "trace_ids", "rows",
                  "endpoint"):
            if k in je["args"]:
                assert te["args"][k] == je["args"][k], k
    assert {e["name"] for e in t["traceEvents"] if e["ph"] == "M"} == \
        {e["name"] for e in j["traceEvents"] if e["ph"] == "M"}
    one = ttrace.chrome_trace(trace_id="cd" * 16)
    assert {e["name"] for e in one["traceEvents"] if e["ph"] != "M"} == \
        {"gateway_request", "decode_tick", "splice"}


def test_tracing_off_records_nothing():
    ttrace.reset()
    tflags.set_flags({"obs_trace": False})
    with ttrace.span("quiet"):
        ttrace.instant("quiet_mark")
    assert ttrace.get_spans() == []
    tflags.set_flags({"obs_trace": True})
    with ttrace.span("loud"):
        pass
    assert [s["name"] for s in ttrace.get_spans()] == ["loud"]


def test_save_chrome_trace_writes_loadable_json(tmp_path):
    _record(ttrace)
    path = ttrace.save_chrome_trace(str(tmp_path / "t.json"))
    with open(path) as f:
        doc = json.load(f)
    assert doc["schema_version"] == 2 and doc["traceEvents"]


@pytest.fixture(scope="module")
def tiny_engine():
    model = tgpt.GPTLM(tgpt.GPTConfig.tiny(max_position_embeddings=32),
                       device="cpu")
    tgpt.load_fluid_params(model, tgpt.init_fluid_params(model.cfg, 0))
    return model


def test_engine_reenters_stream_context_and_lists_tick_trace_ids(
        tiny_engine):
    engine = tserving.DecodeEngine(tiny_engine, slots=2,
                                   max_len=32).start(loop=False)
    try:
        ttrace.reset()
        tid = "ef" * 16
        with ttrace.trace_scope(tid, "3" * 16):
            traced = engine.submit([1, 2, 3], max_new_tokens=4)
        plain = engine.submit([4, 5], max_new_tokens=6)
        assert traced.trace_ctx == (tid, "3" * 16)
        assert plain.trace_ctx is None
        while not (traced.done and plain.done):
            engine._tick()
    finally:
        engine.stop()
    spans = ttrace.get_spans()
    ticks = [s for s in spans if s["name"] == "decode_tick"]
    assert ticks and all(s["args"]["trace_ids"] == [tid] for s in ticks)
    prefills = [s for s in spans if s["name"] == "decode_prefill"]
    assert [s["trace_id"] for s in prefills].count(tid) == 1
    # the untraced stream alone after the traced one ended: no tick span
    assert len(ticks) < sum(s["name"] == "decode_step" for s in spans)


def test_batcher_dispatch_lists_the_batch_trace_ids():
    class Echo(object):
        def run(self, feeds):
            time.sleep(0.01)
            return [np.asarray(feeds[0])]

        def clone(self, share_plans=True):
            return self

    server = tserving.InferenceServer(Echo(), max_batch_size=4,
                                      batch_timeout_ms=50,
                                      num_workers=1).start()
    try:
        ttrace.reset()
        tids = ["%032x" % i for i in (1, 2)]
        reqs = []
        for tid in tids:
            with ttrace.trace_scope(tid):
                reqs.append(server.submit([np.ones((1, 2), np.float32)]))
        for r in reqs:
            server.result(r, timeout=10)
    finally:
        server.stop()
    disp = [s for s in ttrace.get_spans() if s["name"] == "serving_dispatch"]
    assert sorted(t for s in disp for t in s["args"]["trace_ids"]) == tids


def test_gateway_adopts_traceparent_and_exports_it(tiny_engine):
    tflags.set_flags({"obs_http_port": 0})
    engine = tserving.DecodeEngine(tiny_engine, slots=2, max_len=32)
    server = tserving.InferenceServer(None, decode_engine=engine)
    engine.start()
    gw = tserving.Gateway(server, port=0).start()
    try:
        ttrace.reset()
        tid, parent = "0123456789abcdef" * 2, "fedcba9876543210"
        req = urllib.request.Request(
            "http://127.0.0.1:%d/v1/generate" % gw.port,
            data=json.dumps({"prompt_ids": [1, 2, 3],
                             "max_new_tokens": 5}).encode(),
            headers={"traceparent": "00-%s-%s-01" % (tid, parent)})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.headers["X-Trace-Id"] == tid
            events = [json.loads(ln[6:]) for ln in
                      r.read().decode().splitlines()
                      if ln.startswith("data: ")]
        assert events[-1]["trace_id"] == tid and events[-1]["done"]
        toks, done = sse("http://127.0.0.1:%d/v1/generate" % gw.port,
                         {"prompt_ids": [7, 8], "max_new_tokens": 3})
        assert done["trace_id"] != tid and len(done["trace_id"]) == 32
        exp = texporter.global_exporter()
        assert exp is not None and exp.port
        st, body = _get(exp.url("/trace") + "?trace_id=" + tid)
        doc = json.loads(body)
    finally:
        gw.stop()
        engine.stop()
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] != "M"}
    assert {"gateway_request", "decode_tick", "decode_prefill"} <= names
    gr = [e for e in doc["traceEvents"] if e["name"] == "gateway_request"]
    assert len(gr) == 1 and gr[0]["args"]["parent_span_id"] == parent
    assert gr[0]["args"]["status"] == 200


# ---------------------------------------------------------------------------
# exporter
# ---------------------------------------------------------------------------


def test_exporter_serves_metrics_trace_compiles_and_health(tmp_path):
    tprofiler.bump_counter("obs_test_requests", 3)
    tprofiler.bump_histogram("obs_test_ms", 4.0)
    fn = lambda: 7.0  # noqa: E731 - a gauge
    tregistry.register_gauge("obs_test_depth", fn)
    exp = texporter.Exporter(port=0).start()
    try:
        st, text = _get(exp.url("/metrics"))
        assert st == 200
        scraped = tregistry.parse_prometheus(text)
        live = tregistry.parse_prometheus(tregistry.render_prometheus())
        assert scraped[("obs_test_requests", "")] == \
            live[("obs_test_requests", "")] == \
            tprofiler.get_counter("obs_test_requests")
        assert scraped[("obs_test_depth", "")] == 7.0
        assert ("obs_test_ms_count", "") in scraped
        st, body = _get(exp.url("/trace"))
        assert st == 200 and json.loads(body)["schema_version"] == 2
        st, body = _get(exp.url("/compiles"))
        doc = json.loads(body)
        assert st == 200 and doc["schema_version"] == 1
        assert {"builds", "compiles", "by_kind", "by_trigger",
                "steady_recompiles", "recent"} <= set(doc["summary"])
        st, body = _get(exp.url("/healthz"))
        assert st == 200 and json.loads(body)["status"] == "ok"
        tpreempt.request_preemption()
        st, body = _get(exp.url("/healthz"))
        assert st == 503 and json.loads(body)["status"] == "draining"
        assert _get(exp.url("/nope"))[0] == 404
    finally:
        exp.stop()
        tregistry.unregister_gauge("obs_test_depth", fn)
    assert exp.port is None


def test_exporter_starts_from_flags_once_and_stops(tmp_path):
    assert texporter.maybe_start_from_flags() is None  # nothing armed
    tflags.set_flags({"obs_http_port": 0,
                      "obs_dir": str(tmp_path)})
    exp = texporter.maybe_start_from_flags()
    assert exp is not None and exp.port and \
        texporter.maybe_start_from_flags() is exp
    texporter.stop_global()
    assert texporter.global_exporter() is None
    # stop() writes the final per-rank snapshot (snapshot dir armed)
    assert os.path.exists(os.path.join(str(tmp_path), "rank_0.jsonl"))


def test_final_snapshot_carries_compiles_and_the_black_box(tmp_path):
    tflags.set_flags({"obs_dir": str(tmp_path)})
    tflight.note({"request_id": "r1", "status": 200, "ms": 1.5})
    with ttrace.span("boxed"):
        pass
    path = texporter.final_snapshot()
    with open(path) as f:
        snap = json.loads(f.read().splitlines()[-1])
    assert snap["compiles"]["builds"] == 0
    assert set(snap) >= {"counters", "gauges", "histograms", "compiles"}
    assert tflight.load(tflight.flight_path(str(tmp_path)))[0][
        "request_id"] == "r1"
    with open(texporter.trace_dump_path(str(tmp_path))) as f:
        assert "boxed" in {e["name"] for e in json.load(f)["traceEvents"]}


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

RECORDS = [
    {"request_id": "a", "tenant": "t1", "priority": "batch",
     "endpoint": "/v1/generate", "status": 200, "ms": 12.5, "tokens": 8,
     "ttft_ms": 3.25, "trace_id": "ab" * 16, "admit_wait_ms": 0.1,
     "inflight_at_entry": 2, "cached_prefix_tokens": 4, "extra": [1]},
    {"request_id": "b", "status": "503", "priority": "bogus", "ms": True},
    {},
]


def test_flight_ring_dump_load_and_journeys_match_reference(tmp_path):
    for r in RECORDS:
        tflight.note(r)
    assert tflight.records() == RECORDS
    path = tflight.dump(str(tmp_path), rank=2)
    assert path.endswith("flight_rank_2.json")
    assert tflight.load(path) == RECORDS
    assert [tflight.to_journey(r) for r in RECORDS] == \
        [jflight.to_journey(r) for r in RECORDS]
    jl = str(tmp_path / "journeys.jsonl")
    assert tflight.write_journeys(jl) == 3
    assert tflight.load_journeys(jl) == jflight.load_journeys(jl) == \
        [jflight.to_journey(r) for r in RECORDS]
    assert tflight.load(str(tmp_path / "missing.json")) == []


def test_flight_ring_is_bounded_by_its_flag():
    tflags.set_flags({"trace_flight_records": 2})
    d0 = tprofiler.get_counter("trace_flight_dropped")
    for i in range(5):
        tflight.note({"request_id": str(i)})
    assert [r["request_id"] for r in tflight.records()] == ["3", "4"]
    assert tprofiler.get_counter("trace_flight_dropped") - d0 == 3


# ---------------------------------------------------------------------------
# the strict steady-state gate
# ---------------------------------------------------------------------------


def _program():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[4], dtype="float32")
        out = tfluid.layers.scale(x, scale=2.0)
    return main, out


def _executor_build():
    main, out = _program()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(main, feed={"x": np.ones((1, 4), np.float32)}, fetch_list=[out])


def _predictor_build(tmp_path):
    main, out = _program()
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        tfluid.io.save_inference_model(str(tmp_path), ["x"], [out], exe,
                                       main_program=main)
    config = tinference.AnalysisConfig(str(tmp_path))
    config.disable_gpu()
    pred = tinference.create_paddle_predictor(config)
    with compile_stats.warmup_window():
        pred.run([np.ones((1, 4), np.float32)])  # the plan, warmed
    return lambda: pred.run([np.ones((3, 4), np.float32)])  # a new shape


def _kernel_build():
    tbuild._report_builds({"flash_fwd": {"cached": False, "seconds": 0.5},
                           "flash_decode": {"cached": True, "seconds": 0.0}})


BUILDS = {
    "executor_plan": lambda tmp: _executor_build,
    "predictor_plan": _predictor_build,
    "kernel_library": lambda tmp: _kernel_build,
}


@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("kind", sorted(BUILDS))
def test_steady_build_in_a_request_window_trips_the_gate(kind, strict,
                                                         tmp_path):
    build = BUILDS[kind](tmp_path)
    tflags.set_flags({STRICT: strict})
    compile_stats.arm_serving_steady()
    c0 = tprofiler.get_counter("serving_steady_recompiles")
    b0 = tprofiler.get_counter("xla_builds")
    s0 = compile_stats.summary()
    with compile_stats.serving_request_window():
        if strict:
            with pytest.raises(compile_stats.SteadyStateRecompileError) as ei:
                build()
            assert ei.value.record["kind"] == kind
            assert ei.value.record["phase"] == "steady"
        else:
            build()
    assert tprofiler.get_counter("serving_steady_recompiles") == c0 + 1
    assert tprofiler.get_counter("xla_builds") == b0 + 1
    s1 = compile_stats.summary()
    assert s1["by_kind"][kind] - s0["by_kind"][kind] == 1
    assert s1["builds"] - s0["builds"] == 1
    assert s1["compiles"] - s0["compiles"] == int(kind == "kernel_library")


EXEMPT = {
    "warmup_window": lambda: (compile_stats.serving_request_window(),
                              compile_stats.warmup_window()),
    "no_request_window": lambda: (),
}


@pytest.mark.parametrize("case", ["warmup_window", "no_request_window",
                                  "not_armed"])
@pytest.mark.parametrize("kind", sorted(BUILDS))
def test_exempt_builds_never_trip_the_gate(kind, case, tmp_path):
    import contextlib

    build = BUILDS[kind](tmp_path)
    tflags.set_flags({STRICT: True})
    if case != "not_armed":
        compile_stats.arm_serving_steady()
    windows = EXEMPT.get(case, lambda: (
        compile_stats.serving_request_window(),))()
    c0 = tprofiler.get_counter("serving_steady_recompiles")
    with contextlib.ExitStack() as stack:
        for w in windows:
            stack.enter_context(w)
        build()
    assert tprofiler.get_counter("serving_steady_recompiles") == c0
    rec = compile_stats.get_records()[-1]
    assert rec["kind"] == kind
    assert rec["phase"] == {"warmup_window": "warmup",
                            "no_request_window": "steady",
                            "not_armed": ""}[case]


def test_gate_counts_owners_and_classifies_triggers():
    compile_stats.arm_serving_steady()
    compile_stats.arm_serving_steady()
    compile_stats.disarm_serving_steady()
    assert compile_stats.compiles_endpoint()["serving_steady"]
    compile_stats.disarm_serving_steady()
    compile_stats.disarm_serving_steady()  # never below zero
    assert not compile_stats.compiles_endpoint()["serving_steady"]
    r1 = compile_stats.on_build("predictor_plan", "P1", {"feeds": [[1, 4]]})
    r2 = compile_stats.on_build("predictor_plan", "P1", {"feeds": [[2, 4]]})
    r3 = compile_stats.on_build("executor_plan", "P1", {"version": 1})
    r4 = compile_stats.on_build("executor_plan", "P1", {"version": 2})
    r5 = compile_stats.on_build("executor_plan", "P1", {"version": 2})
    assert [r["trigger"] for r in (r1, r2, r3, r4, r5)] == [
        "cold", "shape_change", "cold", "program_mutation",
        "uncached_rebuild"]
    assert r2["diff"]["changed"] == ["feeds"]
    with pytest.raises(ValueError):
        compile_stats.on_build("xla", "P1", {})
    tflags.set_flags({"obs_compile_records": 2})
    compile_stats.on_build("kernel_library", "flash_fwd", {})
    assert len(compile_stats.get_records()) == 2


def test_server_and_engine_arm_after_warmup_and_disarm_at_stop(
        tiny_engine):
    class Echo(object):
        def run(self, feeds):
            return [np.asarray(feeds[0])]

        def clone(self, share_plans=True):
            return self

    engine = tserving.DecodeEngine(tiny_engine, slots=2, max_len=32)
    server = tserving.InferenceServer(Echo(), decode_engine=engine)
    assert not compile_stats.compiles_endpoint()["serving_steady"]
    server.start(warmup_inputs=[np.ones((1, 2), np.float32)])
    try:
        assert compile_stats._steady_count == 2  # the server and its engine
        assert any(s["name"] == "decode_warmup" for s in ttrace.get_spans())
    finally:
        server.stop()
    assert compile_stats._steady_count == 0


def test_strict_server_refuses_an_unwarmed_shape_and_serves_warm_ones(
        tmp_path):
    tflags.set_flags({STRICT: True})
    main, out = _program()
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        tfluid.io.save_inference_model(str(tmp_path), ["x"], [out], exe,
                                       main_program=main)
    config = tinference.AnalysisConfig(str(tmp_path))
    config.disable_gpu()
    server = tserving.InferenceServer(
        tinference.create_paddle_predictor(config), max_batch_size=2,
        num_workers=1).start(warmup_inputs=[np.ones((1, 4), np.float32)])
    try:
        c0 = tprofiler.get_counter("serving_steady_recompiles")
        x = np.full((1, 4), 3.0, np.float32)
        (got,) = server.infer([x])
        assert np.array_equal(got, 2 * x)
        assert tprofiler.get_counter("serving_steady_recompiles") == c0
        with pytest.raises(tserving.ServingError, match="steady-state"):
            server.infer([np.ones((1, 5), np.float32)])
        assert tprofiler.get_counter("serving_steady_recompiles") == c0 + 1
    finally:
        server.stop()
