"""Closed-loop probe of the port's HTTP gateway (port of
``tools/gateway_probe.py``).

Drives ``paddle_tpu_torch/serving/gateway.py`` over real sockets, in
front of an ``InferenceServer`` (a small classifier through the
micro-batcher) with an attached ``DecodeEngine`` (a GPT), and checks the
reference probe's acceptance bars:

- CONCURRENCY + PARITY: 8 concurrent HTTP clients, half ``POST
  /v1/infer``, half chunked-SSE ``POST /v1/generate``. Generation is
  token for token the in-process ``server.generate``. Each ``/v1/infer``
  result equals, bit for bit, the in-process result of the same input at
  one of the batch buckets the server's ladder can form (1, 2, 4, 8 rows):
  concurrent requests coalesce, and a row's bits depend on the batch it
  rode (on the CPU a coalesced row's softmax differs from the batch-1 row
  by one float32 ulp; on the card cuBLAS picks its GEMM by M). The report
  names the bucket each response matched. The JSON codec itself is held
  bit for bit apart: every sign and exponent of the finite float32s, each
  with its mantissa's extremes and 11 seeded random mantissas, through
  ``encode_tensor`` -> ``json.dumps``/``loads`` -> ``decode_tensor``.
- ZERO BUILDS: the storm runs under the armed strict gate
  (``FLAGS_serving_strict_compiles``) with ``serving_steady_recompiles``
  unchanged.
- BACKPRESSURE MAPPING: a tenant limited to 0.5 requests a second with a
  burst of 1 sees 200 then 429 with ``Retry-After``; a 1 µs deadline
  gives 504; the two land in distinct counters.
- OBSERVABILITY: the ``gateway_*`` families on the exporter's
  ``/metrics`` (an HTTP scrape through ``parse_prometheus``),
  ``gateway_request`` spans on ``/trace``, one access-log line per
  request with unique ids.
- GRACEFUL DRAIN: a real ``SIGTERM`` while 4 streams are mid-flight flips
  ``/readyz`` to 503, every stream completes in full, and only then does
  the listener close.

It also measures the HTTP hop against the in-process calls.

    python -m paddle_tpu_torch.tools.gateway_probe --fast --device cpu
    python -m paddle_tpu_torch.tools.gateway_probe --gpt2   # on the card
    python -m paddle_tpu_torch.tools.gateway_probe --gpt2 --drain-only

``--device`` is ``cuda`` unless asked otherwise, with no fallback;
``--gpt2`` serves GPT-2 small's widths (random weights from seed 0)
instead of the tiny GPT; ``--drain-only`` runs the SIGTERM trial alone.
Prints one ``REPORT {json}`` line and ``PROBE PASS`` or ``PROBE FAIL``;
exits 0 on a pass. The probe signals itself, so run it as a process of
its own.
"""

import argparse
import json
import os
import shutil
import signal
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

REPORT_SCHEMA_VERSION = 1


def build_classifier(dirname, device, dim=32, hidden=64, classes=8, seed=0):
    """Init + save a small classifier inference model (the /v1/infer
    workload) on ``device``; returns an example single-row input."""
    from paddle_tpu_torch import fluid

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[dim], dtype="float32")
        h = fluid.layers.fc(x, size=hidden, act="relu", name="gwp_fc1")
        out = fluid.layers.softmax(
            fluid.layers.fc(h, size=classes, name="gwp_cls"))
    scope = fluid.Scope()
    exe = fluid.Executor(_place(device))
    exe.run(startup, scope=scope)
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(dirname, ["x"], [out], exe,
                                      main_program=main)
    return np.random.RandomState(seed).rand(1, dim).astype("float32")


def _place(device):
    from paddle_tpu_torch import fluid

    if device == "cpu":
        return fluid.CPUPlace()
    if device == "cuda":
        return fluid.CUDAPlace(0)
    raise ValueError("device must be cpu or cuda, got %r" % (device,))


def load_predictor(dirname, device):
    """An AnalysisPredictor on ``device``: the card unless ``cpu``."""
    from paddle_tpu_torch import inference

    config = inference.AnalysisConfig(dirname)
    if device == "cpu":
        config.disable_gpu()
    return inference.create_paddle_predictor(config)


def _post(url, body, headers=None, timeout=120):
    """(status, parsed json body, headers) — HTTPError unwrapped."""
    req = urllib.request.Request(
        url, data=json.dumps(body).encode("utf-8"),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _sse(url, body, headers=None, timeout=300, on_token=None):
    """POST and consume a chunked SSE stream: returns (tokens, done).
    ``on_token`` fires per token as it arrives."""
    req = urllib.request.Request(
        url, data=json.dumps(body).encode("utf-8"),
        headers={"Content-Type": "application/json", **(headers or {})})
    toks, done = [], None
    with urllib.request.urlopen(req, timeout=timeout) as r:
        for line in r:
            line = line.decode("utf-8").strip()
            if not line.startswith("data: "):
                continue
            obj = json.loads(line[len("data: "):])
            if "token" in obj:
                toks.append(obj["token"])
                if on_token is not None:
                    on_token(obj["token"])
            else:
                done = obj
    return toks, done


def _percentile(samples, p):
    return float(np.percentile(np.asarray(samples), p))


# -- the /v1/infer oracle ----------------------------------------------------


def bucket_oracles(pred, x, buckets):
    """{rows: outputs} of ``x`` repeated to each batch bucket, run in
    process: what a coalesced batch of identical requests gives each of
    its rows."""
    return {b: pred.run([np.repeat(x, b, axis=0)]) for b in buckets}


def matching_bucket(got, oracles):
    """The smallest bucket one of whose rows ``got`` (a list of
    single-row outputs) equals bit for bit (dtype and bytes), else
    None."""
    def same(g, o):
        g, o = np.asarray(g), np.asarray(o)
        return g.dtype == o.dtype and g.shape == o.shape and \
            g.tobytes() == o.tobytes()

    for b in sorted(oracles):
        outs = oracles[b]
        for r in range(b):
            if len(got) == len(outs) and all(
                    same(g[0], np.asarray(o)[r]) for g, o in zip(got, outs)):
                return b
    return None


def codec_patterns(seed=0):
    """Finite float32 patterns: both signs, every biased exponent 0..254
    (0 the subnormals and zeros), each with mantissas 0, 1, 2, 2**22,
    2**23 - 1 and 11 seeded random ones."""
    rs = np.random.RandomState(seed)
    mants = np.array([0, 1, 2, 1 << 22, (1 << 23) - 1]
                     + list(rs.randint(0, 1 << 23, 11)), np.uint32)
    exps = np.arange(255, dtype=np.uint32)
    bits = [(np.uint32(s) << 31) | (e << 23) | m
            for s in (0, 1) for e in exps for m in mants]
    return np.array(bits, np.uint32).view(np.float32)


def codec_roundtrip(arr):
    """Mismatched elements of ``arr`` through the gateway's JSON codec."""
    from paddle_tpu_torch.serving.gateway import decode_tensor, encode_tensor

    back = decode_tensor(json.loads(json.dumps(encode_tensor(arr))))
    a = np.asarray(arr, np.float32).view(np.uint32)
    return int((back.astype(np.float32).view(np.uint32) != a).sum()) \
        if back.shape == arr.shape else int(arr.size)


# -- the stack under test -----------------------------------------------------


def gpt_config(gpt2, max_len):
    from paddle_tpu_torch.models import gpt

    if gpt2:
        return gpt.GPTConfig(use_flash_attention=True)
    cfg = gpt.GPTConfig.tiny(hidden_dropout=0.0, attention_dropout=0.0,
                             use_flash_attention=True)
    cfg.max_position_embeddings = max_len
    return cfg


def build_stack(device, gpt2, tmp, slots=8):
    """(cfg, max_len, server, xd): the classifier's predictor behind an
    InferenceServer (8 rows, 5 ms, one worker) warmed on ``xd``, with a
    DecodeEngine over a GPT program's scope (``build_gpt_infer``; GPT-2
    small loads ``init_fluid_params(cfg, seed=0)``)."""
    from paddle_tpu_torch import fluid, serving
    from paddle_tpu_torch.models import gpt

    max_len = 1024 if gpt2 else 48
    cfg = gpt_config(gpt2, max_len)
    with fluid.unique_name.guard():
        infer_prog, startup, _f, _l = gpt.build_gpt_infer(cfg, max_len)
    exe = fluid.Executor(_place(device))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    if gpt2:
        gpt.load_fluid_scope(scope, gpt.init_fluid_params(cfg, seed=0))
    engine = serving.DecodeEngine(cfg, place=_place(device), scope=scope,
                                  slots=slots, max_len=max_len,
                                  prefill_buckets=[16, max_len],
                                  param_program=infer_prog)
    xd = build_classifier(os.path.join(tmp, "model"), device)
    pred = load_predictor(os.path.join(tmp, "model"), device)
    server = serving.InferenceServer(
        pred, max_batch_size=8, batch_timeout_ms=5.0, queue_depth=64,
        num_workers=1, decode_engine=engine).start(warmup_inputs=[xd])
    return cfg, max_len, server, xd, pred


def _prompts(cfg):
    rs = np.random.RandomState(11)
    return [list(map(int, rs.randint(0, cfg.vocab_size, n)))
            for n in (2, 5, 9, 14)]


def drain_trial(gw, base, prompts, tokens, profiler):
    """A real SIGTERM while 4 streams are mid-flight: /readyz must answer
    503, every stream complete in full, then the listener close."""
    got, errors = {}, []

    def client(i):
        try:
            got[i] = _sse(base + "/v1/generate",
                          {"prompt_ids": prompts[i % len(prompts)],
                           "max_new_tokens": tokens})
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    tok_base = profiler.get_counter("gateway_stream_tokens")
    streams = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in streams:
        t.start()
    # signal only once all 4 are admitted and tokens are on the wire:
    # a client not yet admitted would rightly get the drain's 503
    wait_deadline = time.monotonic() + 120
    while time.monotonic() < wait_deadline and (
            gw.admission.total_inflight < 4
            or profiler.get_counter("gateway_stream_tokens") <= tok_base):
        time.sleep(0.01)
    gw.install_sigterm()
    t_sig = time.perf_counter()
    os.kill(os.getpid(), signal.SIGTERM)
    readyz = None
    try:
        with urllib.request.urlopen(base + "/readyz", timeout=5) as r:
            readyz = r.status
    except urllib.error.HTTPError as e:
        readyz = e.code
    except (urllib.error.URLError, OSError):
        readyz = "closed"
    for t in streams:
        t.join(timeout=300)
    for _ in range(600):
        if gw.port is None:
            break
        time.sleep(0.05)
    drain_s = time.perf_counter() - t_sig
    closed = gw.port is None
    complete = (not errors and len(got) == 4 and all(
        len(toks) == tokens and done and done.get("done")
        for toks, done in got.values()))
    report = {"streams": 4, "tokens": tokens,
              "streams_complete": bool(complete),
              "readyz_during_drain": readyz, "listener_closed": bool(closed),
              "drain_s": drain_s, "errors": len(errors)}
    failures = []
    if not complete:
        failures.append("drain lost in-flight streams: %r" % (errors[:2],))
    if not closed:
        failures.append("listener still open after drain")
    if readyz not in (503, "closed"):
        failures.append("readyz stayed ready during drain: %r" % readyz)
    return report, failures


def run_probe(fast=True, device="cuda", gpt2=False, drain_only=False,
              verbose=False):
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.fluid import flags as _flags
    from paddle_tpu_torch.fluid import profiler
    from paddle_tpu_torch.observability import exporter as obs_exporter
    from paddle_tpu_torch.observability import registry as obs_registry
    from paddle_tpu_torch.serving.gateway import decode_tensor, encode_tensor

    # strict gate + a real /metrics listener: the whole HTTP storm must
    # hold 0 steady-state builds and be scrapeable
    _flags.set_flags({"FLAGS_serving_strict_compiles": True,
                      "FLAGS_obs_http_port": 0})
    report = {"schema_version": REPORT_SCHEMA_VERSION, "fast": bool(fast),
              "device": device, "gpt2": bool(gpt2)}
    failures = []
    clients = 8
    infer_reqs = 8 if fast else 20
    gen_max_new = 10 if fast else 16
    tmp = tempfile.mkdtemp(prefix="gateway_probe_")
    access_path = os.path.join(tmp, "access.jsonl")
    cfg, max_len, server, xd, pred = build_stack(device, gpt2, tmp,
                                                 slots=clients)
    gw = serving.Gateway(server, port=0, access_log=access_path).start()
    base = "http://127.0.0.1:%d" % gw.port
    prompts = _prompts(cfg)
    # every drained stream must fit its whole budget below max_len
    drain_tokens = min(30 if fast else 40,
                       max_len - max(len(p) for p in prompts))
    try:
        if drain_only:
            report["drain"], fails = drain_trial(
                gw, base, prompts, drain_tokens, profiler)
            failures += fails
            return _finish(report, failures, verbose)
        # ---- in-process oracles (the APIs the gateway must match) ----
        buckets = sorted({rows for rows, _ in server.ladder.shapes()})
        oracles = bucket_oracles(pred, xd, buckets)
        solo = server.infer([xd], deadline_ms=30000)
        if matching_bucket(solo, oracles) != 1:
            failures.append("in-process infer is not the batch-1 oracle")
        expect_tokens = {
            tuple(p): server.generate(p, max_new_tokens=gen_max_new)
            .tokens(timeout=300)
            for p in prompts
        }
        patterns = codec_patterns()
        report["codec"] = {
            "patterns": int(patterns.size),
            "mismatches": codec_roundtrip(patterns),
            "oracle_mismatches": sum(codec_roundtrip(np.asarray(o))
                                     for outs in oracles.values()
                                     for o in outs)}
        if report["codec"]["mismatches"] or \
                report["codec"]["oracle_mismatches"]:
            failures.append("JSON codec changed float32 bits: %r"
                            % report["codec"])
        c_warm = profiler.get_counters()

        # ---- concurrency + parity: 8 HTTP clients, mixed endpoints ----
        errors, matched = [], []

        def infer_client(tenant):
            try:
                for _ in range(infer_reqs):
                    st, body, _ = _post(
                        base + "/v1/infer",
                        {"inputs": [encode_tensor(xd)],
                         "deadline_ms": 30000},
                        headers={"X-Tenant-Id": tenant})
                    assert st == 200, (st, body)
                    got = [decode_tensor(t) for t in body["outputs"]]
                    b = matching_bucket(got, oracles)
                    assert b is not None, \
                        "result matches no bucket's bits exactly"
                    matched.append(b)
            except Exception as e:  # noqa: BLE001 - surfaced via errors
                errors.append(e)

        def gen_client(tenant, prompt):
            try:
                toks, done = _sse(
                    base + "/v1/generate",
                    {"prompt_ids": prompt, "max_new_tokens": gen_max_new},
                    headers={"X-Tenant-Id": tenant})
                assert toks == expect_tokens[tuple(prompt)], \
                    (toks, expect_tokens[tuple(prompt)])
                assert done and done.get("done") and \
                    done.get("finish_reason") in ("length", "eos"), done
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = []
        for i in range(clients // 2):
            threads.append(threading.Thread(target=infer_client,
                                            args=("tenant_a",)))
            threads.append(threading.Thread(
                target=gen_client, args=("tenant_b", prompts[i % 4])))
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        report["http"] = {
            "clients": len(threads),
            "infer_requests": (clients // 2) * infer_reqs,
            "generate_streams": clients // 2,
            "errors": len(errors),
            "wall_s": time.perf_counter() - t0,
            "infer_matched_bucket": {str(b): matched.count(b)
                                     for b in sorted(set(matched))},
        }
        if errors:
            failures.append("%d client errors: %r" % (len(errors),
                                                      errors[:3]))

        # ---- strict gate: the HTTP layer built nothing ----
        c_now = profiler.get_counters()
        steady = (c_now.get("serving_steady_recompiles", 0)
                  - c_warm.get("serving_steady_recompiles", 0))
        report["strict"] = {"steady_recompiles": int(steady),
                            "gate_armed": True}
        if steady != 0:
            failures.append("%d steady-state builds" % steady)

        # ---- the HTTP hop against the in-process APIs ----
        inproc, overhttp = [], []
        for _ in range(30):
            t1 = time.perf_counter()
            server.infer([xd], deadline_ms=30000)
            inproc.append((time.perf_counter() - t1) * 1e3)
        for _ in range(30):
            t1 = time.perf_counter()
            st, _b, _h = _post(base + "/v1/infer",
                               {"inputs": [encode_tensor(xd)],
                                "deadline_ms": 30000})
            assert st == 200
            overhttp.append((time.perf_counter() - t1) * 1e3)
        t1 = time.perf_counter()
        server.generate(prompts[1], max_new_tokens=gen_max_new) \
            .tokens(timeout=300)
        gen_inproc_ms = (time.perf_counter() - t1) * 1e3
        t1 = time.perf_counter()
        _sse(base + "/v1/generate",
             {"prompt_ids": prompts[1], "max_new_tokens": gen_max_new})
        gen_http_ms = (time.perf_counter() - t1) * 1e3
        report["overhead"] = {
            "inproc_infer_p50_ms": _percentile(inproc, 50),
            "inproc_infer_p99_ms": _percentile(inproc, 99),
            "http_infer_p50_ms": _percentile(overhttp, 50),
            "http_infer_p99_ms": _percentile(overhttp, 99),
            "inproc_generate_ms": gen_inproc_ms,
            "http_generate_ms": gen_http_ms,
            "tokens_per_stream": gen_max_new,
        }

        # ---- gauges, scraped while the main gateway owns them ----
        exp = obs_exporter.global_exporter()
        with urllib.request.urlopen(exp.url("/metrics"), timeout=10) as r:
            flat_live = {k[0] for k in obs_registry.parse_prometheus(
                r.read().decode("utf-8"))}
        gauges_ok = ("gateway_inflight" in flat_live
                     and "gateway_draining" in flat_live)

        # ---- overload: a rate-limited tenant's burst -> 429 ----
        gw_limited = serving.Gateway(server, port=0, rate_limit_rps=0.5,
                                     rate_burst=1).start()
        try:
            lim = "http://127.0.0.1:%d" % gw_limited.port
            st1, _, _ = _post(lim + "/v1/infer",
                              {"inputs": [encode_tensor(xd)]},
                              headers={"X-Tenant-Id": "bursty"})
            st2, body2, hdr2 = _post(lim + "/v1/infer",
                                     {"inputs": [encode_tensor(xd)]},
                                     headers={"X-Tenant-Id": "bursty"})
            report["overload"] = {
                "first_status": st1, "second_status": st2,
                "reason": body2.get("reason"),
                "retry_after_s": hdr2.get("Retry-After"),
                "retry_after_ms": body2.get("retry_after_ms"),
            }
            if not (st1 == 200 and st2 == 429
                    and body2.get("reason") == "ratelimit"
                    and int(hdr2.get("Retry-After", 0)) >= 1):
                failures.append("overload mapping wrong: %r"
                                % report["overload"])
        finally:
            gw_limited.stop()

        # ---- deadline: shed at dispatch -> 504 ----
        st, body, _ = _post(base + "/v1/infer",
                            {"inputs": [encode_tensor(xd)],
                             "deadline_ms": 0.001})
        report["deadline"] = {"status": st, "reason": body.get("reason")}
        if st != 504 or body.get("reason") != "deadline":
            failures.append("deadline mapping wrong: %r"
                            % report["deadline"])

        # ---- metrics + spans + access log round trip ----
        with urllib.request.urlopen(exp.url("/metrics"), timeout=10) as r:
            scraped = obs_registry.parse_prometheus(r.read().decode("utf-8"))
        flat = {k[0] for k in scraped}
        need = [
            "gateway_requests", "gateway_shed_admission",
            "gateway_shed_dispatch", "gateway_stream_tokens",
            "gateway_tenant_requests_tenant_a",
            "gateway_tenant_requests_tenant_b",
            "gateway_tenant_shed_bursty",
            "gateway_latency_ms_count", "gateway_ttft_ms_count",
            "gateway_tenant_latency_ms_tenant_a_count",
        ]
        missing = [m for m in need if m not in flat]
        if not gauges_ok:
            missing.append("gateway_inflight/gateway_draining gauges")
        sheds_distinct = (
            scraped.get(("gateway_shed_admission", ""), 0) >= 1
            and scraped.get(("gateway_shed_dispatch", ""), 0) >= 1)
        with urllib.request.urlopen(exp.url("/trace"), timeout=10) as r:
            trace = json.loads(r.read())
        gw_spans = [e for e in trace["traceEvents"]
                    if e.get("name") == "gateway_request"]
        with open(access_path) as f:
            log_lines = [json.loads(ln) for ln in f if ln.strip()]
        rids = [ln["request_id"] for ln in log_lines]
        report["observability"] = {
            "metrics_missing": missing,
            "sheds_distinct": bool(sheds_distinct),
            "gateway_request_spans": len(gw_spans),
            "access_log_lines": len(log_lines),
            "access_log_ids_unique": len(set(rids)) == len(rids),
        }
        if missing:
            failures.append("metrics missing on /metrics: %r" % missing)
        if not sheds_distinct:
            failures.append("admission/dispatch sheds not distinct")
        if not gw_spans:
            failures.append("no gateway_request spans on /trace")
        if not log_lines or len(set(rids)) != len(rids):
            failures.append("access log incomplete or ids not unique")

        # ---- SIGTERM mid-stream: drain before the listener closes ----
        report["drain"], fails = drain_trial(gw, base, prompts,
                                             drain_tokens, profiler)
        failures += fails
    finally:
        gw.stop()
        server.stop()
        obs_exporter.stop_global()
        shutil.rmtree(tmp, ignore_errors=True)
    return _finish(report, failures, verbose)


def _finish(report, failures, verbose):
    report["pass"] = not failures
    report["failures"] = failures
    if verbose:
        print(json.dumps(report, indent=1), file=sys.stderr)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fast", action="store_true",
                    help="the tier-1 budget subset")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the stack runs (no fallback)")
    ap.add_argument("--gpt2", action="store_true",
                    help="serve GPT-2 small's widths (the card)")
    ap.add_argument("--drain-only", action="store_true",
                    help="run the SIGTERM drain trial alone")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        import torch

        torch.set_num_threads(2)
    report = run_probe(fast=args.fast, device=args.device, gpt2=args.gpt2,
                       drain_only=args.drain_only, verbose=args.verbose)
    print("REPORT " + json.dumps(report, sort_keys=True), flush=True)
    print("PROBE PASS" if report["pass"]
          else "PROBE FAIL: %s" % "; ".join(report["failures"]), flush=True)
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
