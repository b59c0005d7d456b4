"""The port's HTTP gateway (``paddle_tpu_torch/serving/gateway.py``) held
against the reference's over real sockets on the CPU.

- Parity: both packages serve a tiny GPT with the same parameters (saved
  by the reference, loaded by the port's predictor) through their own
  ``InferenceServer`` + ``DecodeEngine`` + ``Gateway``. The SSE token
  streams are equal token for token (greedy, and seeded
  ``temperature``/``top_k``/``top_p``), the done events carry the same
  keys and values (``resume_tokens`` replay included), and status codes,
  JSON error bodies, ``Retry-After``, ``/healthz``, ``/readyz`` and the
  access-log keys are the same, all modulo timing fields and the random
  trace id.
- The reference's unit cases of ``tests/test_gateway.py`` on the port's
  classes: the JSON codec, ``_Admission``'s priority order and quota
  re-check, tenant isolation, the token bucket, the tenant table,
  keep-alive hygiene, the SIGTERM chain, in-band stream errors, drain.
- ``/v1/kv/prefill`` answers 503 on a replica without a paged prefix
  index, and 200 with the reference's chain on one that has it.
- The port's probe, ``python -m paddle_tpu_torch.tools.gateway_probe
  --fast --device cpu``, as a subprocess (it signals itself).
"""

import http.client
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu import serving as jserving
from paddle_tpu.checkpoint import preempt as jpreempt
from paddle_tpu.fluid import flags as jflags
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.observability import exporter as jexporter
from paddle_tpu.serving import gateway as jgateway
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch import inference as tinference
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.checkpoint import preempt as tpreempt
from paddle_tpu_torch.fluid import flags as tflags
from paddle_tpu_torch.fluid import profiler as tprofiler
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.observability import compile_stats as tcompile
from paddle_tpu_torch.observability import exporter as texporter
from paddle_tpu_torch.serving import gateway as tgateway
from paddle_tpu_torch.tools.gateway_probe import _post as post
from paddle_tpu_torch.tools.gateway_probe import _sse as sse
from paddle_tpu_torch.tools.gateway_probe import codec_patterns
from test_torch_cpu_math import pin_vector_math

pin_vector_math(2)  # 2 threads, vector math set up on one (see there)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_LEN = 32
X = np.arange(4, dtype=np.float32).reshape(1, 4)
# fields that carry a clock reading or a fresh random id
TIMING = {"ttft_ms", "trace_id", "ts", "ts_mono", "ms", "pid", "lease",
          "retry_after_ms", "span_id"}
PKG = {"jax": (jserving, jgateway, jpreempt),
       "torch": (tserving, tgateway, tpreempt)}


class EchoPredictor(object):
    """run() echoes feed 0 doubled; an optional per-batch delay gives
    inflight tests a service window."""

    def __init__(self, delay_s=0.0):
        self.delay_s = delay_s

    def run(self, feeds):
        if self.delay_s:
            time.sleep(self.delay_s)
        return [np.asarray(feeds[0]) * 2.0]

    def clone(self, share_plans=True):
        return self


def _echo_server(mod=tserving, delay_s=0.0, **kw):
    kw.setdefault("max_batch_size", 8)
    kw.setdefault("batch_timeout_ms", 2.0)
    kw.setdefault("queue_depth", 64)
    kw.setdefault("num_workers", 1)
    return mod.InferenceServer(EchoPredictor(delay_s), **kw).start(
        warmup_inputs=[np.ones((1, 4), np.float32)])


def _defaults(flags_mod, prefixes):
    return {"FLAGS_" + k: v for k, v in flags_mod._DEFAULTS.items()
            if k.startswith(prefixes)}


# every flag family the reference's serving stack reads (its gateway,
# server, engine, router, fleet, checkpoint latch and exporters), pinned
# to its defaults: a file run earlier on the same xdist worker may leave
# any of them set
_PREFIXES = ("decode_", "spmd_decode_", "kv_tier_", "sched_", "gateway_",
             "serving_", "obs_", "trace_", "chaos_", "router_", "fleet_",
             "ckpt_", "dist_", "sim_")


@pytest.fixture(autouse=True)
def _clean_process_state():
    """Every test leaves the process as it found it: the preemption
    latches, the global exporters, the strict gate's arm count and the
    flags a test may set (other files share this worker process)."""
    yield
    jpreempt._reset_for_tests()
    tpreempt._reset_for_tests()
    jexporter.stop_global()
    texporter.stop_global()
    tflags.set_flags(_defaults(tflags, _PREFIXES))


@pytest.fixture(scope="module")
def pair():
    """A tiny GPT served by both packages: the reference's program and
    scope (saved to disk), the port's predictor loading that model, each
    package's engine over its scope and an echo server in front."""
    saved = jflags.get_flags(list(_defaults(jflags, _PREFIXES)))
    jflags.set_flags(_defaults(jflags, _PREFIXES))
    tflags.set_flags(_defaults(tflags, _PREFIXES))
    cfg = jgpt.GPTConfig.tiny(use_flash_attention=True,
                              max_position_embeddings=MAX_LEN,
                              hidden_dropout=0.0, attention_dropout=0.0)
    with jfluid.unique_name.guard():
        infer, startup, feeds, logits = jgpt.build_gpt_infer(cfg, MAX_LEN)
    infer.random_seed = startup.random_seed = 7
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.core.Scope()
    d = tempfile.mkdtemp(prefix="torch_gateway_")
    with jfluid.scope_guard(scope):
        exe.run(startup)
        jfluid.io.save_inference_model(d, feeds, [logits], exe,
                                       main_program=infer)
    config = tinference.AnalysisConfig(d)
    config.disable_gpu()
    pred = tinference.create_paddle_predictor(config)
    tcfg = tgpt.GPTConfig.tiny(use_flash_attention=True,
                               max_position_embeddings=MAX_LEN)
    servers = {}
    engines = {
        "jax": jserving.DecodeEngine(cfg, scope=scope, slots=4,
                                     max_len=MAX_LEN,
                                     prefill_buckets=[8, MAX_LEN],
                                     param_program=infer),
        "torch": tserving.DecodeEngine(tcfg, place=tfluid.CPUPlace(),
                                       scope=pred.scope,
                                       slots=4, max_len=MAX_LEN,
                                       prefill_buckets=[8, MAX_LEN],
                                       param_program=pred.program),
    }
    for name, (mod, _gw, _pre) in PKG.items():
        servers[name] = mod.InferenceServer(
            EchoPredictor(), max_batch_size=4, batch_timeout_ms=2.0,
            num_workers=1, decode_engine=engines[name],
        ).start(warmup_inputs=[np.ones((1, 4), np.float32)])
    yield servers
    for s in servers.values():
        s.stop()
    jflags.set_flags(saved)


def _both(pair, fn, **gw_kw):
    """``fn(name, base_url, gateway)`` against each package's gateway
    over its server; returns {name: result}."""
    out = {}
    for name, (mod, _gw, _pre) in PKG.items():
        gw = mod.Gateway(pair[name], port=0, **gw_kw).start()
        try:
            out[name] = fn(name, "http://127.0.0.1:%d" % gw.port, gw)
        finally:
            gw.stop()
    return out


def _untimed(obj):
    if isinstance(obj, dict):
        return {k: _untimed(v) for k, v in obj.items() if k not in TIMING}
    return obj


# ---------------------------------------------------------------------------
# parity with the reference's gateway over HTTP
# ---------------------------------------------------------------------------

GEN_CASES = {
    "greedy_short": {"prompt_ids": [3, 7, 11], "max_new_tokens": 9},
    "greedy_long": {"prompt_ids": [int(t) for t in
                                   np.random.RandomState(4).randint(
                                       0, 211, 14)],
                    "max_new_tokens": 12},
    "greedy_eos": {"prompt_ids": [5, 2], "max_new_tokens": 10,
                   "eos_id": 0},
    "temperature_top_k": {"prompt_ids": [5, 2], "max_new_tokens": 8,
                          "temperature": 2.0, "top_k": 50, "seed": 123},
    "temperature_top_p": {"prompt_ids": [9, 1, 4], "max_new_tokens": 8,
                          "temperature": 1.5, "top_p": 0.9, "seed": 7},
    "nonstream": {"prompt_ids": [6, 6, 1], "max_new_tokens": 6,
                  "stream": False},
    "nonstream_sampled": {"prompt_ids": [6, 6, 1], "max_new_tokens": 6,
                          "stream": False, "temperature": 1.0,
                          "seed": 5},
}


@pytest.mark.parametrize("case", sorted(GEN_CASES))
def test_generate_matches_reference_over_http(pair, case):
    body = GEN_CASES[case]
    hdrs = {"X-Request-Id": "gen-%s" % case, "X-Tenant-Id": "acme"}

    def run(name, base, gw):
        if body.get("stream", True):
            return sse(base + "/v1/generate", body, headers=hdrs)
        st, got, _ = post(base + "/v1/generate", body, headers=hdrs)
        assert st == 200, got
        return got["tokens"], got

    got = _both(pair, run)
    (jt, jdone), (tt, tdone) = got["jax"], got["torch"]
    assert tt == jt and len(tt) > 0
    assert sorted(tdone) == sorted(jdone)
    assert _untimed(tdone) == _untimed(jdone)


@pytest.mark.parametrize("k", [1, 3, 7])
def test_resume_replay_matches_reference(pair, k):
    prompt = [2, 9, 4]
    full = pair["torch"].generate(prompt, max_new_tokens=8).tokens(timeout=60)

    def run(name, base, gw):
        return sse(base + "/v1/generate",
                   {"prompt_ids": prompt, "max_new_tokens": 8,
                    "resume_tokens": full[:k]},
                   headers={"X-Request-Id": "resume-%d" % k})

    got = _both(pair, run)
    assert got["torch"][0] == got["jax"][0] == full[k:]
    tdone, jdone = got["torch"][1], got["jax"][1]
    assert tdone["emitted_count"] == len(full) and \
        tdone["resumed_tokens"] == k
    assert _untimed(tdone) == _untimed(jdone)


def _raw(base, path, data, headers=None):
    """POST raw bytes; (status, body or None, headers)."""
    host, port = base[len("http://"):].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        conn.putrequest("POST", path)
        for k, v in (headers or {}).items():
            conn.putheader(k, v)
        if "Content-Length" not in (headers or {}):
            conn.putheader("Content-Length", str(len(data)))
        conn.endheaders()
        if data and int((headers or {}).get("Content-Length",
                                            len(data))) == len(data):
            conn.send(data)
        r = conn.getresponse()
        raw = r.read()
        return r.status, (json.loads(raw) if raw else None), \
            dict(r.getheaders())
    finally:
        conn.close()


ERROR_CASES = {
    "bad_json": ("/v1/infer", b"not json at all", {}),
    "not_an_object": ("/v1/infer", b"[1, 2]", {}),
    "too_large": ("/v1/infer", b"{}",
                  {"Content-Length": str(200 * 1024 * 1024)}),
    "empty_inputs": ("/v1/infer", json.dumps({"inputs": []}).encode(), {}),
    "bad_dtype": ("/v1/infer", json.dumps(
        {"inputs": [{"data": [1.0], "dtype": "bogus"}]}).encode(), {}),
    "nonnumeric_deadline": ("/v1/infer", json.dumps(
        {"inputs": [{"data": [[1.0]]}], "deadline_ms": "100"}).encode(),
        {}),
    "empty_prompt": ("/v1/generate",
                     json.dumps({"prompt_ids": []}).encode(), {}),
    "string_prompt": ("/v1/generate",
                      json.dumps({"prompt_ids": ["a"]}).encode(), {}),
    "bool_resume": ("/v1/generate", json.dumps(
        {"prompt_ids": [1], "resume_tokens": [True]}).encode(), {}),
    "unseeded_sampled_resume": ("/v1/generate", json.dumps(
        {"prompt_ids": [1], "temperature": 1.0,
         "resume_tokens": [4]}).encode(), {}),
    "hot_temperature": ("/v1/generate", json.dumps(
        {"prompt_ids": [1], "stream": False,
         "temperature": "hot"}).encode(), {}),
    "unknown_route": ("/v1/nothere", b"{}", {}),
}


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_error_status_and_body_match_reference(pair, case):
    path, data, hdrs = ERROR_CASES[case]
    hdrs = dict(hdrs, **{"X-Request-Id": "err-" + case})

    def run(name, base, gw):
        return _raw(base, path, data, hdrs)

    got = _both(pair, run)
    (jst, jbody, jh), (tst, tbody, th) = got["jax"], got["torch"]
    assert tst == jst and tst in (400, 404, 413)
    assert tbody == jbody
    assert th.get("Connection") == jh.get("Connection")


def test_rate_limit_429_matches_reference(pair):
    def run(name, base, gw):
        body = {"inputs": [tgateway.encode_tensor(X)], "deadline_ms": 10000}
        hdrs = {"X-Tenant-Id": "bursty", "X-Request-Id": "rl"}
        return [post(base + "/v1/infer", body, hdrs) for _ in range(2)]

    got = _both(pair, run, rate_limit_rps=0.5, rate_burst=1)
    (j1, j2), (t1, t2) = got["jax"], got["torch"]
    assert (t1[0], t2[0]) == (j1[0], j2[0]) == (200, 429)
    assert _untimed(t2[1]) == _untimed(j2[1])
    assert t2[1]["reason"] == "ratelimit"
    assert t2[2]["Retry-After"] == j2[2]["Retry-After"] == "2"
    assert t1[1] == j1[1]  # the echo's outputs, bit for bit


def test_deadline_504_matches_reference(pair):
    def run(name, base, gw):
        return post(base + "/v1/infer",
                    {"inputs": [tgateway.encode_tensor(X)],
                     "deadline_ms": 0.001}, {"X-Request-Id": "dl"})

    got = _both(pair, run)
    jst, jbody, _ = got["jax"]
    tst, tbody, _ = got["torch"]
    assert tst == jst == 504
    assert sorted(tbody) == sorted(jbody)
    assert tbody["reason"] == jbody["reason"] == "deadline"


def test_health_and_readiness_match_reference(pair):
    def get(base, path):
        try:
            with urllib.request.urlopen(base + path, timeout=10) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def run(name, base, gw):
        pre = PKG[name][2]
        ready = get(base, "/readyz")
        health = get(base, "/healthz")
        pre.request_preemption()
        try:
            draining = get(base, "/readyz")
        except (urllib.error.URLError, OSError):
            draining = (503, {"status": "draining"})
        finally:
            pre._reset_for_tests()
        return ready, health, draining

    got = _both(pair, run)
    (jr, jh, jd), (tr, th, td) = got["jax"], got["torch"]
    assert tr[0] == jr[0] == 200 and _untimed(tr[1]) == _untimed(jr[1])
    assert tr[1]["kv"] == {"role": "mixed"}
    assert th[0] == jh[0] == 200 and sorted(th[1]) == sorted(jh[1])
    assert td == jd == (503, {"status": "draining"})


def test_drain_503_and_stream_completion_match_reference(pair):
    def run(name, base, gw):
        first = threading.Event()
        result = {}

        def client():
            result["stream"] = sse(
                base + "/v1/generate",
                {"prompt_ids": [4, 9], "max_new_tokens": 20},
                on_token=lambda t: first.set())

        t = threading.Thread(target=client)
        t.start()
        assert first.wait(60)
        stopper = threading.Thread(target=gw.stop)
        stopper.start()
        rejected = None
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and rejected is None:
            try:
                st, body, _ = post(base + "/v1/infer",
                                   {"inputs": [tgateway.encode_tensor(X)]},
                                   {"X-Request-Id": "late"}, timeout=5)
                if st == 503:
                    rejected = body
            except (urllib.error.URLError, OSError):
                break
        t.join(60)
        stopper.join(60)
        return result["stream"], rejected, gw.port

    got = _both(pair, run)
    (jtoks, jdone), jrej, jport = got["jax"]
    (ttoks, tdone), trej, tport = got["torch"]
    assert ttoks == jtoks and len(ttoks) == 20
    assert tport is None and jport is None
    assert trej == jrej == {"error": "draining", "request_id": "late"}


def _await_log_line(path, request_id, timeout_s=30.0):
    """Wait until the access log at ``path`` holds ``request_id``'s
    line (the writer appends whole lines, one open per line)."""
    deadline = time.monotonic() + timeout_s
    while True:
        if os.path.exists(path):
            with open(path) as f:
                if any(json.loads(ln).get("request_id") == request_id
                       for ln in f if ln.strip()):
                    return
        assert time.monotonic() < deadline, (
            "no access-log line for %s in %s" % (request_id, path))
        time.sleep(0.01)


def test_access_log_keys_match_reference(pair, tmp_path):
    """Each request's access-log line carries the reference's keys and
    values (clock readings and random ids aside), in request order. A
    line is written when its request's handler ends, which for the SSE
    request comes after its last byte reaches the client: on a loaded
    host the next request's line could land first, so each request is
    sent only once the line of the one before it is in the log."""
    lines = {}
    for name, (mod, _gw, _pre) in PKG.items():
        path = str(tmp_path / ("%s.jsonl" % name))
        gw = mod.Gateway(pair[name], port=0, access_log=path).start()
        base = "http://127.0.0.1:%d" % gw.port
        try:
            post(base + "/v1/infer", {"inputs": [tgateway.encode_tensor(X)]},
                 {"X-Request-Id": "a1", "X-Tenant-Id": "t"})
            _await_log_line(path, "a1")
            sse(base + "/v1/generate",
                {"prompt_ids": [3, 4], "max_new_tokens": 4},
                {"X-Request-Id": "a2", "X-Priority": "batch"})
            _await_log_line(path, "a2")
            post(base + "/v1/infer", {"inputs": []}, {"X-Request-Id": "a3"})
            _await_log_line(path, "a3")
        finally:
            gw.stop()
        with open(path) as f:
            lines[name] = [json.loads(ln) for ln in f if ln.strip()]
    jl, tl = lines["jax"], lines["torch"]
    assert [r["request_id"] for r in tl] == ["a1", "a2", "a3"], (tl, jl)
    assert [sorted(r) for r in tl] == [sorted(r) for r in jl], (tl, jl)
    assert [_untimed(r) for r in tl] == [_untimed(r) for r in jl], (tl, jl)


def test_kv_prefill_answers_503_without_an_export_path(pair):
    """The contiguous engine has no paged prefix index: 503 as the
    reference. A paged engine with an index exports the chain: 200 with
    the reference's keys, links and tokens exactly and its K/V rows
    within 1e-5 (fp32 sums of two layers in other orders give ~1e-7; a
    wrong row or block gives O(1)), and ``/readyz`` advertises the
    block size and the chain heads, as the reference's."""
    st, body, _ = _both(pair, lambda n, b, g: post(
        b + "/v1/kv/prefill", {"prompt_ids": [1, 2, 3]},
        {"X-Request-Id": "kv"}))["torch"]
    assert st == 503 and body == {
        "error": "no paged prefix index on this replica",
        "request_id": "kv"}
    cfg = jgpt.GPTConfig.tiny(use_flash_attention=True,
                              max_position_embeddings=MAX_LEN,
                              hidden_dropout=0.0, attention_dropout=0.0)
    with jfluid.unique_name.guard():
        infer, startup, _feeds, _logits = jgpt.build_gpt_infer(cfg, MAX_LEN)
    startup.random_seed = 11
    scope = jfluid.core.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
    tcfg = tgpt.GPTConfig.tiny(use_flash_attention=True,
                               max_position_embeddings=MAX_LEN)
    model = tgpt.GPTLM(tcfg, device="cpu")
    tgpt.load_fluid_params(model, {n: np.asarray(scope.get(n))
                                   for n in tgpt.fluid_param_shapes(tcfg)})
    knobs = dict(slots=2, max_len=MAX_LEN, block_size=4,
                 prefix_cache_mb=1.0)
    engines = {"jax": jserving.DecodeEngine(cfg, scope=scope,
                                            param_program=infer, **knobs),
               "torch": tserving.DecodeEngine(model, **knobs)}
    prompt = [int(t) for t in np.random.RandomState(5).randint(0, 211, 13)]
    out = {}
    for name, (mod, _gw, _pre) in PKG.items():
        server = mod.InferenceServer(EchoPredictor(),
                                     decode_engine=engines[name]).start()
        gw = mod.Gateway(server, port=0).start()
        try:
            base = "http://127.0.0.1:%d" % gw.port
            st, body, _ = post(base + "/v1/kv/prefill",
                               {"prompt_ids": prompt},
                               {"X-Request-Id": "kv2"})
            with urllib.request.urlopen(base + "/readyz", timeout=10) as r:
                ready = json.loads(r.read().decode())
            out[name] = (st, body, ready)
        finally:
            gw.stop()
            server.stop()
    (jst, jbody, jready), (st, body, ready) = out["jax"], out["torch"]
    assert st == jst == 200
    assert body["block"] == jbody["block"] == 4
    assert body["count"] == jbody["count"] == 3  # 13 tokens: 3 blocks
    row = [tcfg.num_heads, 4, tcfg.hidden_size // tcfg.num_heads]
    got = tserving.kv_tier.decode_entries(body["blocks"], row)
    want = jserving.kv_tier.decode_entries(jbody["blocks"], row)
    assert len(got) == len(want) == 3
    for (k, p, t, pay), (jk, jp, jt, jpay) in zip(got, want):
        assert (k, p, t) == (jk, jp, jt)
        for (kr, vr), (jkr, jvr) in zip(pay, jpay):
            np.testing.assert_allclose(kr, jkr, atol=1e-5, rtol=0)
            np.testing.assert_allclose(vr, jvr, atol=1e-5, rtol=0)
    assert ready["kv"] == jready["kv"]
    assert ready["kv"]["block"] == 4
    assert ready["kv"]["heads"] == [got[2][0], got[1][0], got[0][0]]


# ---------------------------------------------------------------------------
# the reference's unit cases on the port's classes
# ---------------------------------------------------------------------------


def test_tensor_codec_roundtrip_exact():
    rs = np.random.RandomState(3)
    f32 = rs.randn(3, 5).astype("float32")
    back = tgateway.decode_tensor(json.loads(json.dumps(
        tgateway.encode_tensor(f32))))
    assert back.dtype == np.float32 and np.array_equal(back, f32)
    i64 = rs.randint(-(2 ** 40), 2 ** 40, (4,)).astype("int64")
    back = tgateway.decode_tensor(json.loads(json.dumps(
        tgateway.encode_tensor(i64))))
    assert back.dtype == np.int64 and np.array_equal(back, i64)
    t = {"data": [1.0, 2.0, 3.0, 4.0], "shape": [2, 2]}
    assert tgateway.decode_tensor(t).shape == (2, 2)
    assert tgateway.decode_tensor({"data": [1.5], "dtype": None}).dtype \
        == np.float32
    for bad in ({"dtype": "float32"}, [1.0], {"data": [1], "dtype": "bogus"},
                {"data": [[1], [2, 3]]}):
        with pytest.raises(ValueError):
            tgateway.decode_tensor(bad)


def test_codec_carries_every_float32_class_bit_for_bit():
    """Both signs, every finite exponent, mantissa extremes and seeded
    random mantissas: the port's encode read by the reference's decode
    and by its own, equal bits."""
    arr = codec_patterns()
    assert arr.size == 2 * 255 * 16 and np.isfinite(arr).all()
    wire = json.loads(json.dumps(tgateway.encode_tensor(arr)))
    assert wire == json.loads(json.dumps(jgateway.encode_tensor(arr)))
    for dec in (tgateway.decode_tensor, jgateway.decode_tensor):
        back = dec(wire)
        assert back.dtype == np.float32
        assert np.array_equal(back.view(np.uint32), arr.view(np.uint32))


def test_admission_priority_interactive_before_batch():
    adm = tgateway._Admission(rate_rps=0, burst=1, tenant_max_inflight=0,
                              max_inflight=1, admit_timeout_ms=5000)
    adm.admit("t", "interactive")
    order = []
    batch_waiting = threading.Event()

    def batch_req():
        batch_waiting.set()
        adm.admit("t", "batch")
        order.append("batch")
        adm.release("t")

    def interactive_req():
        adm.admit("t", "interactive")
        order.append("interactive")
        adm.release("t")

    tb = threading.Thread(target=batch_req)
    tb.start()
    batch_waiting.wait(5)
    time.sleep(0.05)
    ti = threading.Thread(target=interactive_req)
    ti.start()
    time.sleep(0.05)
    adm.release("t")
    ti.join(5)
    tb.join(5)
    assert order == ["interactive", "batch"], order


def test_admission_overload_sheds_with_timeout():
    adm = tgateway._Admission(rate_rps=0, burst=1, tenant_max_inflight=0,
                              max_inflight=1, admit_timeout_ms=30)
    adm.admit("t", "interactive")
    t0 = time.monotonic()
    with pytest.raises(tgateway._AdmissionDenied) as ei:
        adm.admit("t", "interactive")
    assert ei.value.reason == "overload"
    assert 0.02 <= time.monotonic() - t0 < 5.0
    adm.release("t")


def test_admission_quota_rechecked_after_global_wait():
    adm = tgateway._Admission(rate_rps=0, burst=1, tenant_max_inflight=1,
                              max_inflight=2, admit_timeout_ms=5000)
    adm.admit("other_a", "interactive")
    adm.admit("other_b", "interactive")
    results = []

    def t_req():
        try:
            adm.admit("T", "interactive")
            results.append("ok")
        except tgateway._AdmissionDenied as e:
            results.append(e.reason)

    ts = [threading.Thread(target=t_req) for _ in range(2)]
    for t in ts:
        t.start()
    time.sleep(0.1)
    adm.release("other_a")
    adm.release("other_b")
    for t in ts:
        t.join(10)
    assert sorted(results) == ["ok", "quota"], results
    adm.release("T")


def test_token_bucket_refills_at_its_rate():
    now = [100.0]
    for mod in (tgateway, jgateway):
        now[0] = 100.0
        b = mod._TokenBucket(2.0, 3, clock=lambda: now[0])
        assert [b.try_take() for _ in range(3)] == [None] * 3
        assert b.try_take() == pytest.approx(0.5)
        now[0] += 0.25
        assert b.try_take() == pytest.approx(0.25)
        now[0] += 0.25
        assert b.try_take() is None
        now[0] += 10.0
        assert [b.try_take() for _ in range(3)] == [None] * 3  # burst cap


def test_rate_buckets_raw_keyed_and_bounded():
    adm = tgateway._Admission(rate_rps=0.001, burst=1, tenant_max_inflight=0,
                              max_inflight=10 ** 6, admit_timeout_ms=100)
    adm.admit("a-b", "interactive")
    adm.admit("a.b", "interactive")
    with pytest.raises(tgateway._AdmissionDenied):
        adm.admit("a-b", "interactive")
    for i in range(tgateway._MAX_TRACKED_TENANTS):
        adm._buckets.setdefault("t%d" % i, tgateway._TokenBucket(0.001, 1))
    size_at_cap = len(adm._buckets)
    adm.admit("fresh_one", "interactive")
    with pytest.raises(tgateway._AdmissionDenied):
        adm.admit("fresh_two", "interactive")
    assert tgateway._OVERFLOW_BUCKET in adm._buckets
    assert "fresh_one" not in adm._buckets
    assert len(adm._buckets) == size_at_cap + 1


def test_tenant_table_bounds_client_controlled_cardinality():
    table = tgateway._TenantTable(cap=4)
    slugs = [table.slug("tenant-%d" % i) for i in range(10)]
    assert slugs[:4] == ["tenant_%d" % i for i in range(4)]
    assert all(s == "overflow" for s in slugs[4:])
    assert table.slug("tenant-2") == "tenant_2"


def test_tenant_quota_isolation_under_flood():
    server = _echo_server(delay_s=0.05, batch_timeout_ms=1.0)
    gw = tserving.Gateway(server, port=0, tenant_max_inflight=2,
                          max_inflight=16).start()
    try:
        base = "http://127.0.0.1:%d" % gw.port
        results = {"a": [], "b": None}
        body = {"inputs": [tgateway.encode_tensor(X)], "deadline_ms": 10000}

        def flood_one():
            st, b, _ = post(base + "/v1/infer", body,
                            {"X-Tenant-Id": "flooder"}, timeout=30)
            results["a"].append((st, b.get("reason")))

        floods = [threading.Thread(target=flood_one) for _ in range(8)]
        for t in floods:
            t.start()
        time.sleep(0.02)
        st, _, _ = post(base + "/v1/infer", body, {"X-Tenant-Id": "victim"},
                        timeout=30)
        results["b"] = st
        for t in floods:
            t.join()
        assert results["b"] == 200
        assert [r for r in results["a"] if r == (429, "quota")]
        assert [r for r in results["a"] if r[0] == 200]
    finally:
        gw.stop()
        server.stop()


def test_engine_overload_maps_429_and_counts_admission_sheds():
    class OverloadedServer(object):
        def infer(self, inputs, deadline_ms=None):
            raise tserving.ServerOverloadedError("full up",
                                                 retry_after_ms=1700)

        def generate(self, *a, **kw):
            raise tserving.ServerOverloadedError("full up",
                                                 retry_after_ms=300)

    gw = tserving.Gateway(OverloadedServer(), port=0).start()
    try:
        base = "http://127.0.0.1:%d" % gw.port
        c0 = tprofiler.get_counter("gateway_shed_admission")
        st, body, hdr = post(base + "/v1/infer",
                             {"inputs": [tgateway.encode_tensor(X)]})
        assert st == 429 and body["reason"] == "overload"
        assert body["retry_after_ms"] == 1700 and hdr["Retry-After"] == "2"
        st, body, hdr = post(base + "/v1/generate", {"prompt_ids": [1]})
        assert st == 429 and hdr["Retry-After"] == "1"
        assert tprofiler.get_counter("gateway_shed_admission") == c0 + 2
    finally:
        gw.stop()


def test_keepalive_safe_across_rejects():
    server = _echo_server()
    gw = tserving.Gateway(server, port=0, rate_limit_rps=0.5,
                          rate_burst=1).start()
    try:
        payload = json.dumps({"inputs": [tgateway.encode_tensor(X)],
                              "deadline_ms": 10000})
        conn = http.client.HTTPConnection("127.0.0.1", gw.port, timeout=10)
        statuses = []
        for tenant in ("ka", "ka", "calm_ka"):
            conn.request("POST", "/v1/infer", body=payload,
                         headers={"X-Tenant-Id": tenant})
            r = conn.getresponse()
            r.read()
            statuses.append(r.status)
        conn.close()
        assert statuses == [200, 429, 200]
        conn = http.client.HTTPConnection("127.0.0.1", gw.port, timeout=10)
        conn.request("POST", "/v1/nope", body=payload)
        r = conn.getresponse()
        r.read()
        assert r.status == 404 and r.getheader("Connection") == "close"
        conn.close()
    finally:
        gw.stop()
        server.stop()


def test_sigterm_handler_chains_previous_and_installs_once():
    server = _echo_server()
    seen = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
    gw = tserving.Gateway(server, port=0).start()
    try:
        gw.install_sigterm()
        gw.install_sigterm()  # idempotent: no recursion on the signal
        os.kill(os.getpid(), signal.SIGTERM)
        assert seen == [signal.SIGTERM]
        assert tpreempt.preemption_requested()
        deadline = time.monotonic() + 10
        while gw.port is not None and time.monotonic() < deadline:
            time.sleep(0.05)
        assert gw.port is None
    finally:
        gw.stop()
        server.stop()
        signal.signal(signal.SIGTERM, prev)


def test_midstream_failure_rides_an_inband_sse_event():
    class BrokenStream(object):
        finish_reason = None

        def stream_tokens(self, timeout=None):
            yield 7
            raise RuntimeError("device fell over")

    class BrokenServer(object):
        def generate(self, *a, **kw):
            return BrokenStream()

    gw = tserving.Gateway(BrokenServer(), port=0).start()
    try:
        req = urllib.request.Request(
            "http://127.0.0.1:%d/v1/generate" % gw.port,
            data=json.dumps({"prompt_ids": [1]}).encode())
        events = []
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.status == 200
            for line in r:
                line = line.decode().strip()
                if line.startswith("data: "):
                    events.append(json.loads(line[6:]))
        assert events[0] == {"token": 7}
        assert "device fell over" in events[1]["error"]
    finally:
        gw.stop()


def test_generate_timeout_cancels_engine_work(pair):
    engine = pair["torch"]._decode_engine
    gw = tserving.Gateway(pair["torch"], port=0).start()
    try:
        st, body, _ = post("http://127.0.0.1:%d/v1/generate" % gw.port,
                           {"prompt_ids": [6, 3], "stream": False,
                            "max_new_tokens": MAX_LEN - 3,
                            "deadline_ms": 1.0}, timeout=60)
        assert st == 504 and body["reason"] == "deadline"
        deadline = time.monotonic() + 15
        while engine.stats()["active"] > 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert engine.stats()["active"] == 0
    finally:
        gw.stop()


def test_concurrent_stop_blocks_until_drain_completes(pair):
    gw = tserving.Gateway(pair["torch"], port=0).start()
    base = "http://127.0.0.1:%d" % gw.port
    first = threading.Event()
    result = {}

    def client():
        result["toks"], result["done"] = sse(
            base + "/v1/generate", {"prompt_ids": [8, 2],
                                    "max_new_tokens": 20},
            on_token=lambda t: first.set())

    t = threading.Thread(target=client)
    t.start()
    assert first.wait(60)
    drainer = threading.Thread(target=gw.stop)
    drainer.start()
    while not gw._draining:
        time.sleep(0.002)
    gw.stop()
    assert result.get("toks") is not None and len(result["toks"]) == 20
    assert gw.port is None
    t.join(10)
    drainer.join(10)


def test_gateway_serves_the_gpt_predictor_bit_for_bit(pair, tmp_path):
    """/v1/infer through a GPT predictor: the JSON logits equal the
    in-process ``server.infer`` of the same single row, bit for bit."""
    cfg = tgpt.GPTConfig.tiny(max_position_embeddings=16)
    with tfluid.unique_name.guard():
        main, startup, feeds, logits = tgpt.build_gpt_infer(cfg, 16)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    with tfluid.scope_guard(scope):
        tfluid.io.save_inference_model(str(tmp_path), feeds, [logits], exe,
                                       main_program=main)
    config = tinference.AnalysisConfig(str(tmp_path))
    config.disable_gpu()
    server = tserving.InferenceServer(
        tinference.create_paddle_predictor(config), max_batch_size=1,
        num_workers=1)
    rs = np.random.RandomState(0)
    row = [rs.randint(0, 211, (1, 16, 1)).astype(np.int64),
           np.arange(16).reshape(1, 16, 1).astype(np.int64),
           np.ones((1, 16, 1), np.float32)]
    server.start(warmup_inputs=row)
    gw = tserving.Gateway(server, port=0).start()
    try:
        want = server.infer(row)
        st, body, _ = post("http://127.0.0.1:%d/v1/infer" % gw.port,
                           {"inputs": [tgateway.encode_tensor(a)
                                       for a in row]})
        assert st == 200
        got = [tgateway.decode_tensor(t) for t in body["outputs"]]
        assert len(got) == 1 and got[0].shape == (1, 16, 211)
        assert np.array_equal(got[0].view(np.uint32),
                              want[0].view(np.uint32))
    finally:
        gw.stop()
        server.stop()


# ---------------------------------------------------------------------------
# the port's probe, end to end
# ---------------------------------------------------------------------------


def test_gateway_probe_fast_on_the_cpu():
    """Every check of the probe, with the per-bucket bit-exact /v1/infer
    oracle and 0 steady builds (a subprocess: it signals itself)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.gateway_probe",
         "--fast", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("REPORT ")]
    assert p.returncode == 0 and lines, (p.stdout[-2000:], p.stderr[-2000:])
    report = json.loads(lines[-1][len("REPORT "):])
    assert report["pass"] and report["strict"]["steady_recompiles"] == 0
    assert report["codec"]["mismatches"] == 0
    assert report["http"]["errors"] == 0
    assert sum(report["http"]["infer_matched_bucket"].values()) == \
        report["http"]["infer_requests"]
    assert report["drain"]["streams_complete"]
    assert report["drain"]["readyz_during_drain"] in (503, "closed")


def test_strict_gate_is_armed_while_the_servers_run(pair):
    assert tcompile.compiles_endpoint()["serving_steady"]
