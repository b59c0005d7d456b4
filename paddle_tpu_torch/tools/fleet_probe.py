"""Closed-loop probe of the port's serving fleet control plane (port of
``tools/fleet_probe.py``).

Drives ``paddle_tpu_torch/serving/fleet.py`` + ``router.py`` end to
end — a real FleetController spawning real replica processes (each an
InferenceServer + Gateway over a saved model, strict build gate armed)
behind a real Router — and checks the reference probe's bars:

- FAILOVER: a replica SIGKILLed mid-load costs ZERO failed client
  requests — the router retries the idempotent ``/v1/infer`` calls on
  the survivor — and the controller replaces the dead replica. Each
  ``/v1/infer`` answer must equal, bit for bit, the in-process result of
  its version at one of the batch sizes a replica can coalesce (1 to 4
  rows): a row's bits depend on the batch it rode;
- AUTOSCALE: induced queue-depth pressure (scraped from each replica's
  ``/metrics``) raises a scale-up event, and the measured request
  throughput is higher after the new replica joins than before; when
  the pressure stops, hysteresis scales back down to the floor with a
  live trickle of traffic seeing zero drops through the drain;
- ROLLOUT: ``deploy()`` of a second model version swaps the fleet with
  zero dropped requests and zero wrong answers — every response
  bit-matches the oracle of the version its ``X-Model-Version`` header
  claims, and post-deploy traffic is all new-version;
- STRICT GATE: every replica holds 0 steady-state builds across the
  whole storm (``FLAGS_serving_strict_compiles`` armed);
- DURABLE GENERATIONS: a second fleet of GPT decode replicas (seeded
  identical params via ``--gpt-decode``) serves concurrent SSE streams
  while the chaos harness SIGKILLs one replica after EXACTLY N stream
  tokens (``FLAGS_chaos_die_after_tokens``) — every client stream
  still completes token-exact vs the uninterrupted oracle (greedy AND
  seeded sampling), with zero in-band errors: the router resumes each
  interrupted generation on the survivor with the emitted suffix, the
  resume re-prefill rides the windowed/prefix admission
  (``admit_windows``/``cached_prefix_tokens`` on the done event), the
  failover blip is measured, and the fleet still holds 0 steady
  recompiles;
- CONTROLLER DURABILITY: the controller itself is SIGKILLed mid-load
  (the ``FLAGS_chaos_kill_controller_after_s`` fault, fired from its
  own supervision tick) over a 3-replica GPT decode fleet — the
  headless pool keeps serving token-exact streams with zero client
  failures, a replica SIGKILLed WHILE headless is detected and
  replaced under the journaled crash budget by the restarted
  controller, which ADOPTS the live survivors instead of respawning
  them; a second controller started on the held workdir fails fast
  with ``FleetLockError``; and a rollout interrupted by a controller
  kill on either side of the traffic flip lands consistent (pre-flip
  aborts to the old version, post-flip resumes the old pool's drain);
- FLEET KV TIER: three paged replicas with the host tier under an
  80%-shared-prefix load serve prefix hits through the router's cache
  affinity, and a device index squeezed to one block spills every chain
  and readmits it H2D, token-exact against an in-process engine;
- the router hop's added latency is measured, and
  ``fleet_report.json`` carries the replica timeline + scale/rollout
  events + per-replica tallies.

    python -m paddle_tpu_torch.tools.fleet_probe --fast --device cpu
    python -m paddle_tpu_torch.tools.fleet_probe --fast   # on the card

``--device`` is ``cuda`` unless asked otherwise, with no fallback: the
replicas and the in-process oracles run there. Prints one REPORT json
line + PROBE PASS/FAIL; exits 0 on a pass. Misses of a timing bar are
prefixed "throughput" (a loaded host squeezes them without touching a
result); every other miss is a wrong or missing result.
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

# one copy of the HTTP client helpers and the /v1/infer oracle across
# the probes (the port's tests import them from here too)
from paddle_tpu_torch.tools.gateway_probe import (  # noqa: F401
    _percentile,
    _place,
    _post,
    bucket_oracles,
    load_predictor,
    matching_bucket,
)

REPORT_SCHEMA_VERSION = 1
# the batch sizes a replica's micro-batcher can form (serving_max_batch_size
# 4 below): an answer must equal the in-process result at one of them
INFER_ROWS = (1, 2, 3, 4)


def build_model(dirname, seed, device, dim=24, hidden=48, classes=8):
    """Init + save one classifier version on ``device`` (weights differ
    per seed, so two exports are distinguishable models); writes
    warmup.npz beside the model so replicas can warm their bucket
    ladder. Returns an example single-row input."""
    import numpy as np

    from paddle_tpu_torch import fluid

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard():
        with fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[dim], dtype="float32")
            h = fluid.layers.fc(x, size=hidden, act="relu",
                                name="flp_fc1_s%d" % seed)
            out = fluid.layers.softmax(
                fluid.layers.fc(h, size=classes, name="flp_cls_s%d" % seed)
            )
    startup.random_seed = seed
    scope = fluid.Scope()
    exe = fluid.Executor(_place(device))
    exe.run(startup, scope=scope)
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(
            dirname, ["x"], [out], exe, main_program=main
        )
    xd = np.random.RandomState(7).rand(1, dim).astype("float32")
    np.savez(os.path.join(dirname, "warmup.npz"), xd)
    return xd


def _median(samples):
    return sorted(samples)[len(samples) // 2] if samples else None


def infer_oracles(dirname, xd, device):
    """{rows: outputs} of the model saved in ``dirname`` on ``xd``
    repeated to each of ``INFER_ROWS``, run in process."""
    return bucket_oracles(load_predictor(dirname, device), xd, INFER_ROWS)


def _sse_collect(url, body, headers=None, timeout=120):
    """POST and consume a chunked SSE stream, keeping EVERYTHING:
    (status, data_events, comment_lines, inter_event_gaps_s,
    response_headers). Comment lines (":"-prefixed — the router's
    failover seam) are invisible to the plain ``_sse`` helper, and the
    gaps measure the client-felt blip. The ONE SSE-with-comments
    parser — tests/test_fleet.py imports it (same contract as _post)."""
    req = urllib.request.Request(
        url, data=json.dumps(body).encode("utf-8"),
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    events, comments, gaps = [], [], []
    t_last = time.monotonic()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        status, hdrs = r.status, dict(r.headers)
        for line in r:
            line = line.decode("utf-8").strip()
            if line.startswith("data: "):
                now = time.monotonic()
                gaps.append(now - t_last)
                t_last = now
                events.append(json.loads(line[len("data: "):]))
            elif line.startswith(":"):
                # (comment_line, index of the NEXT data event): gaps[i]
                # then brackets the comment — the client-felt blip of a
                # failover seam, as opposed to e.g. the TTFT gap
                comments.append((line, len(events)))
    return status, events, comments, gaps, hdrs


def run_generate_failover_trial(tmp, model_dir, report, failures, fast,
                                device):
    """Durable streaming generations: chaos-kill a GPT decode replica at
    an exact stream-token boundary under concurrent streams and demand
    token-exact, zero-error completion of every stream via router
    failover + resume."""
    import numpy as np

    from paddle_tpu_torch.observability import registry as _reg
    from paddle_tpu_torch.serving import fleet as fleet_mod
    from paddle_tpu_torch.serving.fleet import FleetController
    from paddle_tpu_torch.serving.replica import build_gpt_decode_engine

    spec = {"seed": 17, "vocab_size": 97, "hidden_size": 32,
            "num_layers": 2, "num_heads": 2, "intermediate_size": 64,
            "max_len": 48, "slots": 8, "prefill_buckets": [8, 16, 48]}
    # the uninterrupted ORACLE: an in-process engine built from the same
    # seeded spec as every replica (seeded startup => bit-identical
    # params across processes), run with no chaos and no failover
    oracle_engine = build_gpt_decode_engine(spec, device=device).start()
    rs = np.random.RandomState(23)
    streams = []
    for i in range(4):
        prompt = [int(t) for t in rs.randint(0, spec["vocab_size"],
                                             10 + i)]
        knobs = ({} if i % 2 == 0 else
                 {"temperature": 1.3, "top_k": 20, "seed": 100 + i})
        streams.append({"prompt": prompt, "knobs": knobs})
    try:
        for s in streams:
            s["oracle"] = oracle_engine.generate(
                s["prompt"], max_new_tokens=10, **s["knobs"]
            ).tokens(timeout=120)
    finally:
        oracle_engine.stop()

    workdir = os.path.join(tmp, "fleet_gen")
    gen_env = {
        "FLAGS_serving_strict_compiles": "1",
        # chunked prefill + prefix store armed: a resume's re-prefill
        # must ride the windowed/prefix admission, not a monolithic
        # full prefill
        "FLAGS_decode_prefill_chunk": "8",
        "FLAGS_decode_prefix_cache_mb": "2",
        "FLAGS_decode_prefix_block": "8",
        # the deterministic mid-stream fault: replica 0 SIGKILLs itself
        # after its 6th stream token hits the wire
        "FLAGS_chaos_die_after_tokens": "6",
        "FLAGS_chaos_die_replica": "0",
        "FLAGS_obs_snapshot_interval_s": "1.0",
    }
    ctrl = FleetController(
        model_dir=model_dir, workdir=workdir, replicas=2,
        replica_env=gen_env, autoscale=False, seed=0, device=device,
        replica_args=["--gpt-decode", json.dumps(spec)],
    )
    t0 = time.monotonic()
    ctrl.start()
    results = [None] * len(streams)
    try:
        ctrl.wait_ready(timeout=180 if fast else 300)
        url = ctrl.router.url("/v1/generate")

        def client(i):
            s = streams[i]
            body = dict(prompt_ids=s["prompt"], max_new_tokens=10,
                        deadline_ms=60000, **s["knobs"])
            try:
                _st, events, comments, gaps, _h = _sse_collect(
                    url, body, timeout=90)
                results[i] = {"events": events, "comments": comments,
                              "gaps": gaps}
            except Exception as e:  # noqa: BLE001 - surfaced below
                results[i] = {"error": repr(e)}

        ths = [threading.Thread(target=client, args=(i,))
               for i in range(len(streams))]
        for t in ths:
            t.start()
        for t in ths:
            t.join()

        failed_over, resume_gaps = 0, []
        for i, (s, res) in enumerate(zip(streams, results)):
            if res is None or "error" in (res or {}):
                failures.append(
                    "gen-failover stream %d transport error: %r"
                    % (i, res)
                )
                continue
            evs = res["events"]
            toks = [e["token"] for e in evs if "token" in e]
            errs = [e for e in evs if "error" in e]
            done = [e for e in evs if e.get("done")]
            if errs:
                failures.append(
                    "gen-failover stream %d saw an in-band error: %r"
                    % (i, errs[:1])
                )
            if not done:
                failures.append(
                    "gen-failover stream %d never finished" % i
                )
            if toks != s["oracle"]:
                failures.append(
                    "gen-failover stream %d tokens diverge from the "
                    "uninterrupted oracle: %r != %r"
                    % (i, toks, s["oracle"])
                )
            if res["comments"]:
                failed_over += 1
                # the blip is the gap BRACKETING the failover comment
                # (event i-1 -> seam -> event i), not max(gaps) — the
                # first gap is TTFT (connect + admission + prefill) and
                # can dominate an otherwise fast stream
                blips = [res["gaps"][i]
                         for _c, i in res["comments"]
                         if i < len(res["gaps"])]
                if blips:
                    resume_gaps.append(max(blips) * 1e3)
                if done and not (
                    done[0].get("cached_prefix_tokens", 0) > 0
                    or done[0].get("admit_windows", 0) > 1
                ):
                    failures.append(
                        "gen-failover stream %d resume did not ride "
                        "the prefix/chunked path: %r" % (i, done[0])
                    )
        if failed_over == 0:
            failures.append(
                "gen-failover: no stream failed over (the chaos kill "
                "never hit a pinned stream)"
            )

        # the controller replaced the chaos-killed replica. Wait for
        # the crash to be DETECTED first: the streams finish (failover
        # is fast) well before the supervision tick polls the corpse,
        # and wait_ready would sail through while the dead replica
        # still counts as ready
        deadline = time.monotonic() + 60
        crashed = False
        while time.monotonic() < deadline:
            if any(e.get("event") == "replica_crash"
                   for e in fleet_mod.load_events(workdir)):
                crashed = True
                break
            time.sleep(0.1)
        if not crashed:
            failures.append(
                "gen-failover: no replica_crash event after the kill"
            )
        try:
            ctrl.wait_ready(timeout=120)
        except Exception as e:  # noqa: BLE001
            failures.append("gen-failover pool never recovered: %r" % e)

        # strict gate + resume-admission facts, fleet-wide
        steady = resumes = scraped = 0
        for info in ctrl.replica_info():
            port = info.get("metrics_port")
            if not port or info["state"] != "ready":
                continue
            try:
                with urllib.request.urlopen(
                    "http://127.0.0.1:%d/metrics" % port, timeout=5
                ) as r:
                    parsed = _reg.parse_prometheus(
                        r.read().decode("utf-8"))
                scraped += 1
                steady += int(parsed.get(
                    ("serving_steady_recompiles", ""), 0))
                resumes += int(parsed.get(
                    ("decode_resume_admissions", ""), 0))
            except Exception as e:  # noqa: BLE001
                failures.append(
                    "gen-failover metrics scrape failed: %r" % e)
        if not scraped:
            failures.append("gen-failover: no replica metrics scraped")
        if steady != 0:
            failures.append(
                "gen-failover: %d steady-state recompiles under the "
                "armed strict gate" % steady
            )
        if failed_over and resumes == 0:
            failures.append(
                "gen-failover: failovers happened but no replica "
                "counted a resume admission"
            )
        report["generate_failover"] = {
            "streams": len(streams),
            "failed_over": failed_over,
            "resume_admissions": resumes,
            "steady_recompiles": steady,
            "resume_blip_ms": (round(max(resume_gaps), 1)
                               if resume_gaps else None),
            "wall_s": round(time.monotonic() - t0, 1),
        }
    finally:
        try:
            ctrl.stop()
        except Exception as e:  # noqa: BLE001
            failures.append(
                "gen-failover controller stop failed: %r" % e)


def run_kv_tier_trial(tmp, model_dir, report, failures, fast, device):
    """Fleet KV tier, closed loop: (a) cache-affinity routing — three
    replicas under an 80%-shared-prefix load must serve hits with a
    fleet median TTFT within 1.5x of a single warmed replica's hit TTFT,
    both medians of hits taken in the same turns (the router steering
    repeats to the replica already holding the chain); (b) spill churn — a device index squeezed to one block
    spills every chain to host, and H2D re-admission must still beat
    chunked re-prefill at 48 prefix tokens (6 blocks of 8).
    Every stream stays token-exact against an in-process oracle and
    the strict build gate stays at zero fleet-wide."""
    import numpy as np

    from paddle_tpu_torch.fluid import flags as _flags
    from paddle_tpu_torch.observability import registry as _reg
    from paddle_tpu_torch.serving.fleet import FleetController
    from paddle_tpu_torch.serving.replica import build_gpt_decode_engine

    spec = {"seed": 17, "vocab_size": 97, "hidden_size": 32,
            "num_layers": 2, "num_heads": 2, "intermediate_size": 64,
            "max_len": 48, "slots": 8, "prefill_buckets": [8, 16, 48]}
    oracle_engine = build_gpt_decode_engine(spec, device=device).start()
    rs = np.random.RandomState(31)
    shared = [int(t) for t in rs.randint(0, spec["vocab_size"], 24)]
    streams = []
    for i in range(10):
        if i < 8:  # 80% share the 24-token prefix
            prompt = shared + [int(t) for t in rs.randint(0, 97, 2)]
        else:
            prompt = [int(t) for t in rs.randint(0, 97, 26)]
        streams.append({"prompt": prompt})
    try:
        for s in streams:
            s["oracle"] = oracle_engine.generate(
                s["prompt"], max_new_tokens=4).tokens(timeout=120)
    finally:
        oracle_engine.stop()

    workdir = os.path.join(tmp, "fleet_kv")
    kv_env = {
        "FLAGS_serving_strict_compiles": "1",
        "FLAGS_decode_block_size": "8",
        "FLAGS_decode_prefill_chunk": "8",
        "FLAGS_decode_prefix_cache_mb": "2",
        "FLAGS_kv_tier_host_mb": "4",
        "FLAGS_obs_snapshot_interval_s": "1.0",
    }
    ctrl = FleetController(
        model_dir=model_dir, workdir=workdir, replicas=3,
        replica_env=kv_env, autoscale=False, seed=0, device=device,
        replica_args=["--gpt-decode", json.dumps(spec)],
    )
    t0 = time.monotonic()
    ctrl.start()
    try:
        ctrl.wait_ready(count=3, timeout=180 if fast else 300)
        url = ctrl.router.url("/v1/generate")

        def one(target_url, s):
            body = dict(prompt_ids=s["prompt"], max_new_tokens=4,
                        deadline_ms=60000)
            _st, events, _c, gaps, _h = _sse_collect(
                target_url, body, timeout=90)
            toks = [e["token"] for e in events if "token" in e]
            done = next((e for e in events if e.get("done")), {})
            return toks, done, (gaps[0] * 1e3 if gaps else None)

        # warm wave: seed the caches wherever the router lands them
        for s in streams:
            toks, _d, _t = one(url, s)
            if toks != s["oracle"]:
                failures.append(
                    "kv-tier warm stream diverged: %r != %r"
                    % (toks, s["oracle"]))
        # let the router's health sweep pick up the new adverts
        time.sleep(1.2)

        hit_ttfts, hits = [], 0
        for s in streams:
            toks, done, ttft = one(url, s)
            if toks != s["oracle"]:
                failures.append(
                    "kv-tier measure stream diverged: %r != %r"
                    % (toks, s["oracle"]))
            if done.get("cached_prefix_tokens", 0) > 0:
                hits += 1
                if ttft is not None:
                    hit_ttfts.append(ttft)
        if hits < len(streams) // 2:
            failures.append(
                "kv-tier: only %d/%d measure streams hit the prefix "
                "cache" % (hits, len(streams)))

        # single-replica hit baseline: one warmed backend, direct. The
        # bar compares paired samples: each turn takes one direct hit and
        # one routed hit back to back, so the two medians share the
        # host's load of the same moments. The measure wave's routed hits
        # ran before the baseline, under another load, and stay out of
        # the bar (they gave a 10.8 ms fleet median against a 7.1 ms
        # baseline taken later on a loaded host)
        info = [i for i in ctrl.replica_info() if i["state"] == "ready"]
        base_ttft = fleet_median = None
        paired = 0
        if info:
            direct = "http://127.0.0.1:%d/v1/generate" \
                % info[0]["gateway_port"]
            s0 = streams[0]
            one(direct, s0)  # warm this exact replica
            samples, routed = [], []
            for s in streams[:8]:         # the shared-prefix streams
                _t, _d, base = one(direct, s0)
                toks, done, ttft = one(url, s)
                if toks != s["oracle"]:
                    failures.append(
                        "kv-tier measure stream diverged: %r != %r"
                        % (toks, s["oracle"]))
                if base is not None and ttft is not None \
                        and done.get("cached_prefix_tokens", 0) > 0:
                    samples.append(base)
                    routed.append(ttft)
            paired = len(routed)
            hit_ttfts.extend(routed)
            base_ttft = _median(samples)
            fleet_median = _median(routed)
        fleet_mean = (sum(hit_ttfts) / len(hit_ttfts)
                      if hit_ttfts else None)
        if fleet_median is not None and base_ttft is not None:
            if fleet_median > 1.5 * max(base_ttft, 2.0):
                failures.append(
                    "throughput: kv-tier fleet median hit TTFT %.1fms "
                    "exceeds 1.5x single-replica hit TTFT %.1fms "
                    "(%d paired turns)" % (fleet_median, base_ttft, paired))
        else:
            failures.append("kv-tier: no TTFT samples collected")

        # the router steered by affinity, and /backends says how
        aff_hits = int(_reg.snapshot()["counters"].get(
            "router_affinity_hits", 0))
        if aff_hits == 0:
            failures.append("kv-tier: router never scored an affinity "
                            "hit under a shared-prefix load")
        with urllib.request.urlopen(ctrl.router.url("/backends"),
                                    timeout=5) as r:
            backends = json.loads(r.read().decode()).get("backends", [])
        if not any(b.get("prefix_heads") for b in backends):
            failures.append("kv-tier: no backend advertises prefix "
                            "heads on /backends")
        for key in ("advert_block", "affinity_score", "role"):
            if backends and key not in backends[0]:
                failures.append("kv-tier: /backends rows missing %r"
                                % key)

        # strict gate + spill traffic, fleet-wide
        steady = spills = readmits = scraped = 0
        for i in info:
            port = i.get("metrics_port")
            if not port:
                continue
            try:
                with urllib.request.urlopen(
                    "http://127.0.0.1:%d/metrics" % port, timeout=5
                ) as r:
                    parsed = _reg.parse_prometheus(
                        r.read().decode("utf-8"))
                scraped += 1
                steady += int(parsed.get(
                    ("serving_steady_recompiles", ""), 0))
                spills += int(parsed.get(("kv_tier_spills", ""), 0))
                readmits += int(parsed.get(("kv_tier_readmits", ""), 0))
            except Exception as e:  # noqa: BLE001
                failures.append("kv-tier metrics scrape failed: %r" % e)
        if not scraped:
            failures.append("kv-tier: no replica metrics scraped")
        if steady != 0:
            failures.append(
                "kv-tier: %d steady-state recompiles under the armed "
                "strict gate" % steady)
        report["kv_tier"] = {
            "streams": len(streams),
            "measure_hits": hits,
            "fleet_mean_hit_ttft_ms": (round(fleet_mean, 1)
                                       if fleet_mean else None),
            "fleet_median_hit_ttft_ms": (round(fleet_median, 1)
                                         if fleet_median else None),
            "single_replica_hit_ttft_ms": (round(base_ttft, 1)
                                           if base_ttft else None),
            "paired_turns": paired,
            "router_affinity_hits": aff_hits,
            "fleet_spills": spills,
            "fleet_readmits": readmits,
            "steady_recompiles": steady,
            "wall_s": round(time.monotonic() - t0, 1),
        }
    finally:
        try:
            ctrl.stop()
        except Exception as e:  # noqa: BLE001
            failures.append("kv-tier controller stop failed: %r" % e)

    # ---- spill churn: re-admission vs chunked re-prefill -------------
    # device index squeezed to ONE block => every admitted chain spills
    # to host and comes back H2D on the next admission. At 48 prefix
    # tokens (6 blocks of 8) that round-trip must beat re-running
    # chunked prefill over the prefix.
    churn_spec = {"seed": 17, "vocab_size": 97, "hidden_size": 64,
                  "num_layers": 4, "num_heads": 4,
                  "intermediate_size": 128, "max_len": 96, "slots": 8,
                  "prefill_buckets": [8, 16, 48, 96]}
    saved = {k: _flags.get_flag(k) for k in
             ("decode_prefix_cache_mb", "decode_block_size",
              "decode_prefill_chunk", "kv_tier_host_mb")}
    engR = engP = None
    try:
        _flags.set_flags({
            "FLAGS_decode_prefix_cache_mb": 8.0,
            "FLAGS_decode_block_size": 8,
            "FLAGS_decode_prefill_chunk": 8,
            "FLAGS_kv_tier_host_mb": 8.0,
        })
        engR = build_gpt_decode_engine(churn_spec, device=device).start()
        engR.pindex.max_blocks = 1  # force evict->spill on every chain
        _flags.set_flags({"FLAGS_kv_tier_host_mb": 0.0})
        engP = build_gpt_decode_engine(churn_spec, device=device).start()
        engP.pindex.max_blocks = 0  # nothing cached: always re-prefill

        def ttft_ms(eng, prompt, n=5):
            ts = []
            for _ in range(n):
                t1 = time.monotonic()
                eng.generate(list(prompt),
                             max_new_tokens=1).tokens(timeout=60)
                ts.append((time.monotonic() - t1) * 1e3)
            return sorted(ts)[len(ts) // 2]

        rows = []
        for ln in ((16, 48) if fast else (8, 16, 32, 48, 64, 80)):
            prefix = [int(t) for t in rs.randint(0, 97, ln)]
            # warm: prefill once; the squeezed index spills it to host
            wa = engR.generate(prefix + [3],
                               max_new_tokens=2).tokens(timeout=60)
            wb = engP.generate(prefix + [3],
                               max_new_tokens=2).tokens(timeout=60)
            if wa != wb:
                failures.append(
                    "kv-tier churn diverged at len %d: %r != %r"
                    % (ln, wa, wb))
            rows.append({
                "prefix_tokens": ln,
                "readmit_ttft_ms": round(
                    ttft_ms(engR, prefix + [5]), 1),
                "reprefill_ttft_ms": round(
                    ttft_ms(engP, prefix + [5]), 1),
            })
        past = [r for r in rows if r["prefix_tokens"] >= 48]
        for r in past:
            if r["readmit_ttft_ms"] >= r["reprefill_ttft_ms"]:
                failures.append(
                    "throughput: kv-tier re-admission (%.1fms) did not "
                    "beat chunked re-prefill (%.1fms) at %d tokens"
                    % (r["readmit_ttft_ms"], r["reprefill_ttft_ms"],
                       r["prefix_tokens"]))
        st = engR.stats().get("kv_tier") or {}
        if not st.get("spills") or not st.get("readmits"):
            failures.append(
                "kv-tier churn moved no blocks through the host tier: "
                "%r" % st)
        report["kv_tier_churn"] = {
            "rows": rows,
            "spills": st.get("spills"),
            "readmits": st.get("readmits"),
        }
    finally:
        for eng in (engR, engP):
            try:
                if eng is not None:
                    eng.stop()
            except Exception:  # noqa: BLE001
                pass
        _flags.set_flags({"FLAGS_" + k: v for k, v in saved.items()})


# -- controller-durability trial ---------------------------------------------
#
# The controller must die by SIGKILL with no drain, so it runs in a
# RUNNER subprocess (this same script, hidden ``--runner`` mode) while
# the probe process plays the client fleet-operator: driving SSE load
# direct to the replica gateways through the headless window, killing a
# replica while nobody supervises, then restarting the runner and
# auditing the adoption from the journal + event log.

GPT_SPEC = {"seed": 29, "vocab_size": 97, "hidden_size": 32,
            "num_layers": 2, "num_heads": 2, "intermediate_size": 64,
            "max_len": 48, "slots": 8, "prefill_buckets": [8, 16, 48]}


def run_runner(args):
    """``--runner`` child: a real FleetController over ``--workdir``.
    ``serve`` supervises until the ``arm_kill`` file appears (then arms
    the chaos controller-kill fault via flags — the next supervision
    tick SIGKILLs this process; the marker dir makes it one-shot, so a
    RESTARTED runner that re-arms never re-fires) or ``stop_runner``
    appears (clean stop, exit 0). ``rollout`` deploys ``--deploy-dir``
    and SIGKILLs itself the moment the journaled rollout phase reaches
    ``--kill-at-phase``."""
    from paddle_tpu_torch.checkpoint import modeldir as _modeldir
    from paddle_tpu_torch.fluid import flags as _flags
    from paddle_tpu_torch.serving.fleet import (FleetController,
                                                read_fleet_state)

    replica_env = {
        "FLAGS_serving_strict_compiles": "1",
        "FLAGS_obs_snapshot_interval_s": "1.0",
    }
    kwargs = {}
    if args.gpt_decode:
        kwargs["replica_args"] = ["--gpt-decode", args.gpt_decode]
    ctrl = FleetController(
        model_dir=args.model_dir, workdir=args.workdir,
        replicas=args.replicas, replica_env=replica_env,
        autoscale=False, seed=0, device=args.device,
        # generous replica-lease TTL: 3 replicas + stream load on a
        # 2-core box can starve a serve loop past the 5s default, and
        # a false lease expiry would corrupt the adoption arithmetic
        lease_ttl_s=15.0,
        **kwargs,
    )
    ctrl.start()
    ctrl.wait_ready(timeout=240)
    _modeldir.commit_json(args.ready_file, {
        "pid": os.getpid(),
        "router_port": ctrl.router.port,
    })
    if args.runner == "rollout":
        dep_err = []

        def _deploy():
            try:
                ctrl.deploy(args.deploy_dir)
            except Exception as e:  # noqa: BLE001 - surfaced below
                dep_err.append(repr(e))

        th = threading.Thread(target=_deploy, daemon=True)
        th.start()
        deadline = time.monotonic() + 180
        while time.monotonic() < deadline:
            # the kill point is the JOURNALED phase: the controller sets
            # its in-memory rollout phase a moment before it commits it,
            # and a kill in that gap would test a flip that never
            # happened (recovery rightly reads the older journal)
            state = read_fleet_state(args.workdir) or {}
            meta = (state.get("intent") or {}).get("rollout")
            if (isinstance(meta, dict)
                    and meta.get("phase") == args.kill_at_phase):
                os.kill(os.getpid(), signal.SIGKILL)
            if not th.is_alive():
                print("RUNNER rollout finished before the %r kill: %r"
                      % (args.kill_at_phase, dep_err), flush=True)
                ctrl.stop()  # no kill came: leave no replica behind
                return 1
            time.sleep(0.001)
        print("RUNNER rollout never reached phase %r"
              % args.kill_at_phase, flush=True)
        ctrl.stop()
        return 1
    arm = os.path.join(args.workdir, "arm_kill")
    stop = os.path.join(args.workdir, "stop_runner")
    armed = False
    while True:
        if not armed and os.path.exists(arm):
            _flags.set_flags({
                "FLAGS_chaos_kill_controller_after_s": 0.001,
                "FLAGS_chaos_marker_dir":
                    os.path.join(args.workdir, "chaos_markers"),
            })
            armed = True
        if os.path.exists(stop):
            ctrl.stop()
            return 0
        time.sleep(0.05)


def _spawn_runner(mode, workdir, model_dir, ready_file, replicas, device,
                  gpt_decode=None, kill_at_phase=None, deploy_dir=None):
    cmd = [sys.executable, "-m", "paddle_tpu_torch.tools.fleet_probe",
           "--runner", mode, "--device", device,
           "--workdir", workdir, "--model-dir", model_dir,
           "--ready-file", ready_file, "--replicas", str(replicas)]
    if gpt_decode:
        cmd += ["--gpt-decode", gpt_decode]
    if kill_at_phase:
        cmd += ["--kill-at-phase", kill_at_phase]
    if deploy_dir:
        cmd += ["--deploy-dir", deploy_dir]
    # `python -m paddle_tpu_torch...` must resolve wherever the probe
    # was launched from
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (pkg_root, env.get("PYTHONPATH")) if p)
    return subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env,
    )


def _await_file(path, timeout, what, failures):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if os.path.exists(path):
            try:
                with open(path) as f:
                    return json.load(f)
            except (OSError, ValueError):
                pass  # torn mid-commit: stale-until-rewritten
        time.sleep(0.1)
    failures.append("controller-crash: %s never appeared (%.0fs)"
                    % (what, timeout))
    return None


def run_controller_crash_trial(tmp, report, failures, fast, device):
    """Kill the CONTROLLER (not a replica) mid-load and demand the
    durability bars: headless serving is client-invisible, restart
    adopts instead of respawning, a headless replica death is detected
    and replaced under the journaled budget, a double-start is refused,
    and an interrupted rollout lands consistent on either side of the
    flip. Failures are UNPREFIXED: every bar here is correctness — a
    squeezed box earns no retry."""
    import numpy as np

    from paddle_tpu_torch.checkpoint import modeldir
    from paddle_tpu_torch.observability import registry as _reg
    from paddle_tpu_torch.serving import fleet as fleet_mod
    from paddle_tpu_torch.serving.fleet import (FleetController, FleetLockError,
                                          read_fleet_state)
    from paddle_tpu_torch.serving.replica import build_gpt_decode_engine

    t0 = time.monotonic()
    cc = {}
    workdir = os.path.join(tmp, "fleet_ctl_crash")
    model_dir = os.path.join(tmp, "export_v1")

    # the uninterrupted oracle, same seeded spec as every replica
    oracle_engine = build_gpt_decode_engine(GPT_SPEC,
                                            device=device).start()
    rs = np.random.RandomState(41)
    streams = []
    for i in range(6):
        prompt = [int(t) for t in rs.randint(0, GPT_SPEC["vocab_size"],
                                             9 + i)]
        knobs = ({} if i % 2 == 0 else
                 {"temperature": 1.2, "top_k": 16, "seed": 300 + i})
        streams.append({"prompt": prompt, "knobs": knobs})
    try:
        for s in streams:
            s["oracle"] = oracle_engine.generate(
                s["prompt"], max_new_tokens=8, **s["knobs"]
            ).tokens(timeout=120)
    finally:
        oracle_engine.stop()

    def run_stream(s, port):
        body = dict(prompt_ids=s["prompt"], max_new_tokens=8,
                    deadline_ms=60000, **s["knobs"])
        try:
            _st, events, _c, _g, _h = _sse_collect(
                "http://127.0.0.1:%d/v1/generate" % port, body,
                timeout=90)
        except Exception as e:  # noqa: BLE001 - surfaced below
            return {"error": repr(e)}
        toks = [e["token"] for e in events if "token" in e]
        errs = [e for e in events if "error" in e]
        if errs:
            return {"error": "in-band %r" % errs[:1]}
        if toks != s["oracle"]:
            return {"error": "diverged %r != %r" % (toks, s["oracle"])}
        return {}

    def read_endpoint(rid):
        try:
            with open(os.path.join(workdir, "endpoints",
                                   "replica_%d.json" % rid)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    # ---- phase A: 3-replica GPT fleet; SIGKILL the controller --------
    ready1 = os.path.join(tmp, "ctl_ready_1.json")
    runner = _spawn_runner("serve", workdir, model_dir, ready1,
                           replicas=3, device=device,
                           gpt_decode=json.dumps(GPT_SPEC))
    runner2 = None
    try:
        if _await_file(ready1, 300, "serve runner ready", failures) is None:
            raise RuntimeError("runner never came up")
        eps = {rid: read_endpoint(rid) for rid in (0, 1, 2)}
        if not all(isinstance(e, dict) and e.get("gateway_port")
                   for e in eps.values()):
            failures.append("controller-crash: endpoint files "
                            "incomplete: %r" % eps)
            raise RuntimeError("no endpoints")
        # survivors 1 and 2 carry the client load; 0 dies headless
        survivor_ports = [eps[1]["gateway_port"], eps[2]["gateway_port"]]
        results = [None] * len(streams)

        def client(i, port):
            results[i] = run_stream(streams[i], port)

        # round 1: streams in flight WHILE the controller is killed
        ths = [threading.Thread(target=client,
                                args=(i, survivor_ports[i % 2]))
               for i in range(4)]
        for t in ths:
            t.start()
        with open(os.path.join(workdir, "arm_kill"), "w") as f:
            f.write("1")
        runner.wait(timeout=60)
        t_dead = time.monotonic()
        if runner.returncode != -signal.SIGKILL:
            failures.append(
                "controller-crash: runner exited %r, not SIGKILL"
                % runner.returncode)
        # a replica dies while NOBODY is supervising
        os.kill(eps[0]["pid"], signal.SIGKILL)
        # round 2: streams born fully headless
        for i in (4, 5):
            ths.append(threading.Thread(
                target=client, args=(i, survivor_ports[i % 2])))
            ths[-1].start()
        for t in ths:
            t.join()
        stream_errors = [(i, r["error"])
                         for i, r in enumerate(results)
                         if r and "error" in r]
        if stream_errors:
            failures.append(
                "controller-crash: %d/%d headless streams failed: %r"
                % (len(stream_errors), len(streams), stream_errors[:2]))
        cc["streams"] = len(streams)
        cc["stream_errors"] = len(stream_errors)

        # ---- phase C: restart; adopt survivors, replace the dead -----
        ready2 = os.path.join(tmp, "ctl_ready_2.json")
        runner2 = _spawn_runner("serve", workdir, model_dir, ready2,
                                replicas=3, device=device,
                                gpt_decode=json.dumps(GPT_SPEC))
        r2 = _await_file(ready2, 300, "recovery runner ready", failures)
        if r2 is None:
            raise RuntimeError("recovery runner never came up")
        cc["headless_window_s"] = round(time.monotonic() - t_dead, 1)
        ev = fleet_mod.load_events(workdir)
        rec = [e for e in ev if e.get("event") == "controller_recover"]
        cc["adopted"] = rec[-1]["adopted"] if rec else None
        cc["lost"] = rec[-1]["lost"] if rec else None
        cc["headless_ms"] = rec[-1]["headless_ms"] if rec else None
        if not rec or rec[-1]["adopted"] != 2:
            failures.append(
                "controller-crash: expected 2 adopted survivors, "
                "got %r" % (rec[-1] if rec else None))
        if not rec or rec[-1]["lost"] != 1:
            failures.append(
                "controller-crash: expected 1 journaled replica lost "
                "headless, got %r" % (rec[-1] if rec else None))
        if not rec or not rec[-1]["headless_ms"] or \
                rec[-1]["headless_ms"] <= 0:
            failures.append("controller-crash: headless_ms not "
                            "measured: %r" % (rec[-1] if rec else None))
        boots = [i for i, e in enumerate(ev)
                 if e.get("event") == "fleet_boot"]
        since_boot = ev[boots[-1]:] if boots else ev
        respawned = [e for e in since_boot
                     if e.get("event") == "replica_spawn"
                     and e.get("replacement")]
        cc["respawned"] = len(respawned)
        if len(respawned) != 1:
            failures.append(
                "controller-crash: expected exactly 1 replacement "
                "spawn after recovery, got %d" % len(respawned))

        # ---- split-brain guard: a second controller must refuse ------
        blocked = False
        try:
            dup = FleetController(
                model_dir=model_dir, workdir=workdir, replicas=3,
                autoscale=False, seed=0, device=device,
                replica_args=["--gpt-decode", json.dumps(GPT_SPEC)],
            )
            dup.start()
            dup.stop()  # should be unreachable
        except FleetLockError as e:
            blocked = True
            if e.pid != r2["pid"]:
                failures.append(
                    "controller-crash: lock error blames pid %r, the "
                    "live runner is %r" % (e.pid, r2["pid"]))
        except Exception as e:  # noqa: BLE001
            failures.append(
                "controller-crash: double start died with %r, not "
                "FleetLockError" % e)
        cc["split_brain_blocked"] = blocked
        if not blocked:
            failures.append("controller-crash: double-started "
                            "controller was NOT refused")

        # ---- the adopted pool serves through the NEW router ----------
        state = read_fleet_state(workdir)
        pool = (state or {}).get("replicas") or {}
        if len(pool) != 3:
            failures.append(
                "controller-crash: journal pool is %r, expected 3"
                % sorted(pool))
        res = run_stream(streams[0], r2["router_port"])
        if "error" in res:
            failures.append(
                "controller-crash: post-recovery routed stream "
                "failed: %r" % res["error"])

        # ---- strict gate across the adopted + respawned pool ---------
        steady = scraped = 0
        for rid in sorted(int(k) for k in pool):
            ep = read_endpoint(rid)
            port = (ep or {}).get("metrics_port")
            if not port:
                continue
            try:
                with urllib.request.urlopen(
                    "http://127.0.0.1:%d/metrics" % port, timeout=5
                ) as r:
                    parsed = _reg.parse_prometheus(
                        r.read().decode("utf-8"))
                scraped += 1
                steady += int(parsed.get(
                    ("serving_steady_recompiles", ""), 0))
            except Exception as e:  # noqa: BLE001
                failures.append(
                    "controller-crash metrics scrape failed: %r" % e)
        cc["steady_recompiles"] = steady
        if not scraped:
            failures.append("controller-crash: no replica metrics "
                            "scraped")
        if steady != 0:
            failures.append(
                "controller-crash: %d steady-state recompiles across "
                "the adopted pool" % steady)

        with open(os.path.join(workdir, "stop_runner"), "w") as f:
            f.write("1")
        if runner2.wait(timeout=120) != 0:
            failures.append(
                "controller-crash: recovery runner clean stop exited "
                "%r" % runner2.returncode)
        runner2 = None
    except RuntimeError:
        pass  # already booked a failure above
    finally:
        for p in (runner, runner2):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait(timeout=30)

    # ---- phase D: rollout interrupted on both sides of the flip ------
    xd = np.random.RandomState(7).rand(1, 24).astype("float32")
    expected = {}
    for phase, want_version in (("spawning", 1), ("flipped", 2)):
        wd = os.path.join(tmp, "fleet_roll_%s" % phase)
        repo = os.path.join(tmp, "repo_roll_%s" % phase)
        modeldir.publish(os.path.join(tmp, "export_v1"), repo)
        key = "rollout_%s_version" % (
            "preflip" if phase == "spawning" else "postflip")
        cc[key] = None
        ready_r = os.path.join(tmp, "ctl_roll_%s_ready.json" % phase)
        roller = _spawn_runner(
            "rollout", wd, repo, ready_r, replicas=2, device=device,
            kill_at_phase=phase,
            deploy_dir=os.path.join(tmp, "export_v2"))
        rec_runner = None
        try:
            if _await_file(ready_r, 240, "rollout runner (%s)" % phase,
                           failures) is None:
                raise RuntimeError("rollout runner never came up")
            roller.wait(timeout=240)
            if roller.returncode != -signal.SIGKILL:
                failures.append(
                    "controller-crash: rollout(%s) runner exited %r, "
                    "not SIGKILL:\n%s"
                    % (phase, roller.returncode,
                       (roller.stdout.read() or "")[-500:]))
                raise RuntimeError("no kill")
            ready_r2 = os.path.join(
                tmp, "ctl_roll_%s_ready2.json" % phase)
            rec_runner = _spawn_runner("serve", wd, repo, ready_r2,
                                       replicas=2, device=device)
            r2 = _await_file(ready_r2, 240,
                             "rollout(%s) recovery ready" % phase,
                             failures)
            if r2 is None:
                raise RuntimeError("no recovery")
            ev = fleet_mod.load_events(wd)
            want_ev = ("rollout_abort" if phase == "spawning"
                       else "rollout_resume")
            if not any(e.get("event") == want_ev for e in ev):
                failures.append(
                    "controller-crash: rollout(%s) recovery logged no "
                    "%s" % (phase, want_ev))
            state = read_fleet_state(wd)
            got_v = ((state or {}).get("intent") or {}).get("version")
            cc[key] = got_v
            if got_v != want_version:
                failures.append(
                    "controller-crash: rollout(%s) landed on version "
                    "%r, expected %d" % (phase, got_v, want_version))
            vers = sorted(set(
                m.get("version")
                for m in ((state or {}).get("replicas") or {}).values()
            ))
            if vers != [want_version]:
                failures.append(
                    "controller-crash: rollout(%s) pool versions %r, "
                    "expected all %d" % (phase, vers, want_version))
            # the recovered fleet serves the landed version, exactly
            # (v1 = the published export_v1, v2 = the deployed
            # export_v2 — deploy() of a plain export dir serves it in
            # place, no publish)
            if want_version not in expected:
                expected[want_version] = infer_oracles(os.path.join(
                    tmp, "export_v%d" % want_version), xd, device)
            from paddle_tpu_torch.serving.gateway import (decode_tensor,
                                                          encode_tensor)
            st, b, h = _post(
                "http://127.0.0.1:%d/v1/infer" % r2["router_port"],
                {"inputs": [encode_tensor(xd)], "deadline_ms": 10000})
            got = ([decode_tensor(x) for x in b["outputs"]]
                   if st == 200 else None)
            if (st != 200
                    or int(h.get("X-Model-Version", 0)) != want_version
                    or matching_bucket(got, expected[want_version])
                    is None):
                failures.append(
                    "controller-crash: rollout(%s) recovered fleet "
                    "served wrong answer (status %r, version header "
                    "%r)" % (phase, st, h.get("X-Model-Version")))
            with open(os.path.join(wd, "stop_runner"), "w") as f:
                f.write("1")
            if rec_runner.wait(timeout=120) != 0:
                failures.append(
                    "controller-crash: rollout(%s) recovery runner "
                    "stop exited %r" % (phase, rec_runner.returncode))
            rec_runner = None
        except RuntimeError:
            pass  # already booked a failure above
        finally:
            for p in (roller, rec_runner):
                if p is not None and p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)

    cc["wall_s"] = round(time.monotonic() - t0, 1)
    report["controller_crash"] = cc


def run_probe(fast=True, verbose=False, keep_workdir=False, device="cuda"):
    import numpy as np

    from paddle_tpu_torch.checkpoint import modeldir
    from paddle_tpu_torch.fluid import flags as _flags
    from paddle_tpu_torch.serving import fleet as fleet_mod
    from paddle_tpu_torch.serving.fleet import FleetController
    from paddle_tpu_torch.serving.gateway import decode_tensor, encode_tensor

    report = {"schema_version": REPORT_SCHEMA_VERSION, "fast": bool(fast),
              "device": device}
    failures = []
    tmp = tempfile.mkdtemp(prefix="fleet_probe_")
    workdir = os.path.join(tmp, "fleet")
    repo = os.path.join(tmp, "repo")

    # -- two model versions + in-process oracles ---------------------------
    xd = build_model(os.path.join(tmp, "export_v1"), 1, device)
    build_model(os.path.join(tmp, "export_v2"), 2, device)
    v1, v1_dir = modeldir.publish(os.path.join(tmp, "export_v1"), repo)
    oracle = {1: infer_oracles(v1_dir, xd, device)}

    # fleet policy: floor 2, ceiling 3, fast scrape cadence so the
    # closed loop fits the tier-1 budget. Each replica's capacity is
    # bounded by its per-tenant gateway rate limit (60 rps) — a
    # deliberately NON-CPU bottleneck, so on a host of 2 cores
    # adding a replica still adds real capacity: fleet throughput is
    # 60 rps x replicas per tenant, and the flood's 429 sheds are the
    # autoscaler's pressure signal (shed_delta in the scraped sample).
    # The cap is low enough that the pressure flood keeps shedding
    # even at 3 replicas — the pool must not go idle (and scale back
    # down) inside the post-scale-up measurement window.
    _flags.set_flags({
        "FLAGS_fleet_min_replicas": 2,
        "FLAGS_fleet_max_replicas": 3,
        "FLAGS_fleet_scale_interval_s": 0.4,
        "FLAGS_fleet_queue_high": 2.0,
        "FLAGS_fleet_queue_low": 0.5,
        "FLAGS_fleet_scale_up_ticks": 2,
        "FLAGS_fleet_scale_down_ticks": 6,
        "FLAGS_fleet_restart_backoff_s": 0.2,
        "FLAGS_router_health_interval_s": 0.25,
    })
    replica_env = {
        "FLAGS_serving_strict_compiles": "1",
        "FLAGS_serving_max_batch_size": "4",
        "FLAGS_serving_workers": "1",
        "FLAGS_serving_queue_depth": "64",
        "FLAGS_gateway_rate_limit_rps": "60",
        "FLAGS_gateway_rate_burst": "12",
        "FLAGS_obs_snapshot_interval_s": "1.0",
        # keep the WHOLE trial in the flight ring: the default 256 only
        # retains the tail of the flood, and a truncated recording is a
        # biased tape for the simulator to replay (--keep-workdir)
        "FLAGS_trace_flight_records": "8192",
    }
    body = {"inputs": [encode_tensor(xd)], "deadline_ms": 10000}

    ctrl = FleetController(
        model_dir=repo, workdir=workdir, replicas=2,
        replica_env=replica_env, autoscale=False, seed=0, device=device,
    )
    t_boot = time.monotonic()
    ctrl.start()
    url = None

    def check(resp_body, version):
        got = [decode_tensor(t) for t in resp_body["outputs"]]
        return matching_bucket(got, oracle[version]) is not None

    try:
        ctrl.wait_ready(timeout=120 if fast else 240)
        report["boot"] = {
            "replicas": 2,
            "ready_s": round(time.monotonic() - t_boot, 1),
        }
        url = ctrl.router.url("/v1/infer")

        # ---- router-hop overhead -------------------------------------
        # each phase uses its own tenant: the per-tenant rate buckets
        # (the capacity bound) must not couple phases to each other
        direct_port = ctrl.replica_info()[0]["gateway_port"]
        direct_url = "http://127.0.0.1:%d/v1/infer" % direct_port
        direct, routed = [], []
        for target, samples in ((direct_url, direct), (url, routed)):
            for _ in range(25):
                t0 = time.perf_counter()
                st, b, _h = _post(target, body,
                                  headers={"X-Tenant-Id": "ovh"})
                samples.append((time.perf_counter() - t0) * 1e3)
                if st != 200 or not check(b, 1):
                    failures.append("overhead phase: bad response "
                                    "(%s -> %s)" % (target, st))
                    break
                time.sleep(0.012)  # stay under the tenant rate bucket
        report["overhead"] = {
            "direct_p50_ms": _percentile(direct, 50),
            "router_p50_ms": _percentile(routed, 50),
            "hop_p50_ms": round(
                _percentile(routed, 50) - _percentile(direct, 50), 3
            ),
        }

        # ---- failover: SIGKILL a replica mid-load --------------------
        results = []
        res_lock = threading.Lock()
        stop_evt = threading.Event()

        def client(expect_versions, tag, pause=0.0):
            hdrs = {"X-Tenant-Id": tag}
            while not stop_evt.is_set():
                try:
                    st, b, h = _post(url, body, headers=hdrs, timeout=30)
                except Exception as e:  # noqa: BLE001
                    with res_lock:
                        results.append((time.monotonic(), -1, False, tag,
                                        repr(e)))
                    continue
                ok = False
                if st == 200:
                    ver = int(h.get("X-Model-Version", "0") or 0)
                    ok = ver in expect_versions and check(b, ver)
                with res_lock:
                    results.append((time.monotonic(), st, ok, tag, None))
                if pause:
                    time.sleep(pause)

        # 6 clients at ~38 rps total: comfortably under one replica's
        # 60 rps tenant bucket, so the kill window itself can never
        # manufacture a legitimate 429 — any non-200 is a DROP
        threads = [
            threading.Thread(target=client, args=((1,), "kill", 0.15))
            for _ in range(6)
        ]
        for t in threads:
            t.start()
        time.sleep(0.8)
        victim = ctrl.replica_info()[0]
        t_kill = time.monotonic()
        os.kill(victim["pid"], signal.SIGKILL)
        time.sleep(2.5)
        stop_evt.set()
        for t in threads:
            t.join()
        with res_lock:
            kill_res = [r for r in results if r[3] == "kill"]
        bad = [r for r in kill_res if r[1] != 200 or not r[2]]
        ctrl.wait_ready(timeout=120)
        recover_ms = (time.monotonic() - t_kill) * 1e3
        report["failover"] = {
            "requests": len(kill_res),
            "failed": len(bad),
            "killed_pid": victim["pid"],
            "recover_ms": round(recover_ms, 1),
        }
        if not kill_res:
            failures.append("failover phase produced no requests")
        if bad:
            failures.append(
                "replica kill dropped %d/%d client requests: %r"
                % (len(bad), len(kill_res), bad[:3])
            )
        events = fleet_mod.load_events(workdir)
        if not any(e.get("event") == "replica_crash" for e in events):
            failures.append("no replica_crash event after SIGKILL")

        # ---- autoscale up under queue pressure -----------------------
        # ~10x the 2-replica tenant capacity: sustained 429 sheds are
        # the pressure signal the autoscaler scrapes
        ctrl.autoscale = True
        results.clear()
        stop_evt.clear()
        threads = [
            threading.Thread(target=client, args=((1,), "press", 0.005))
            for _ in range(10)
        ]
        t_press = time.monotonic()
        for t in threads:
            t.start()
        t_up = None
        deadline = time.monotonic() + (60 if fast else 120)
        while time.monotonic() < deadline:
            if ctrl.ready_count() >= 3:
                t_up = time.monotonic()
                break
            time.sleep(0.05)
        if t_up is None:
            stop_evt.set()
            for t in threads:
                t.join()
            failures.append("queue pressure never scaled the pool up")
        else:
            time.sleep(2.7)  # measure with the 3rd replica serving
            stop_evt.set()
            for t in threads:
                t.join()
            with res_lock:
                press = [r for r in results if r[3] == "press"]
            errors = [r for r in press if r[1] not in (200, 429)]
            sheds = sum(1 for r in press if r[1] == 429)
            wrong = [r for r in press if r[1] == 200 and not r[2]]

            def rps(lo, hi):
                n = sum(1 for r in press
                        if r[1] == 200 and lo <= r[0] < hi)
                return n / max(1e-6, hi - lo)

            before_rps = rps(t_up - 2.2, t_up - 0.2)
            after_rps = rps(t_up + 0.5, t_up + 2.5)
            ratio = after_rps / max(1e-6, before_rps)
            report["autoscale"] = {
                "requests": len(press),
                "sheds_429": sheds,
                "errors": len(errors),
                "scale_up_ms": round((t_up - t_press) * 1e3, 1),
                "before_rps": round(before_rps, 1),
                "after_rps": round(after_rps, 1),
                "speedup": round(ratio, 3),
            }
            if errors or wrong:
                failures.append(
                    "pressure phase errors: %r" % (errors + wrong)[:3]
                )
            if not any(e.get("event") == "scale_up"
                       for e in fleet_mod.load_events(workdir)):
                failures.append("scale-up left no scale_up event")
            if ratio < 1.15:
                failures.append(
                    "throughput: scale-up did not raise throughput "
                    "(%.1f -> %.1f rps, %.2fx < 1.15x)"
                    % (before_rps, after_rps, ratio)
                )

        # ---- hysteresis scale-down with a live trickle ---------------
        results.clear()
        stop_evt.clear()
        trickle = threading.Thread(target=client,
                                   args=((1,), "down", 0.05))
        trickle.start()
        deadline = time.monotonic() + (45 if fast else 90)
        t_down0 = time.monotonic()
        while time.monotonic() < deadline:
            if ctrl.target == 2 and ctrl.ready_count() == 2:
                break
            time.sleep(0.05)
        down_ms = (time.monotonic() - t_down0) * 1e3
        stop_evt.set()
        trickle.join()
        with res_lock:
            down_res = [r for r in results if r[3] == "down"]
        bad = [r for r in down_res if r[1] != 200 or not r[2]]
        has_down = any(e.get("event") == "scale_down"
                       for e in fleet_mod.load_events(workdir))
        report["scale_down"] = {
            "happened": bool(has_down),
            "ms": round(down_ms, 1),
            "trickle_requests": len(down_res),
            "trickle_failed": len(bad),
        }
        if not has_down or ctrl.target != 2:
            failures.append("idle hysteresis never scaled back down")
        if bad:
            failures.append(
                "scale-down drain dropped %d/%d trickle requests: %r"
                % (len(bad), len(down_res), bad[:3])
            )

        # ---- zero-downtime rollout v1 -> v2 --------------------------
        v2, v2_dir = modeldir.publish(os.path.join(tmp, "export_v2"),
                                      repo)
        oracle[2] = infer_oracles(v2_dir, xd, device)
        if all(np.array_equal(a, b)
               for a, b in zip(oracle[1][1], oracle[2][1])):
            failures.append("model versions are indistinguishable")
        results.clear()
        stop_evt.clear()
        rollers = [
            threading.Thread(target=client, args=((1, 2), "roll", 0.03))
            for _ in range(2)
        ]
        for t in rollers:
            t.start()
        t_roll = time.monotonic()
        deployed = ctrl.deploy(repo)
        roll_ms = (time.monotonic() - t_roll) * 1e3
        # post-flip traffic must be new-version only
        post = []
        for _ in range(8):
            st, b, h = _post(url, body, headers={"X-Tenant-Id": "post"})
            post.append((st, int(h.get("X-Model-Version", "0") or 0),
                         st == 200 and check(b, 2)))
            time.sleep(0.02)
        stop_evt.set()
        for t in rollers:
            t.join()
        with res_lock:
            roll_res = [r for r in results if r[3] == "roll"]
        bad = [r for r in roll_res if r[1] != 200 or not r[2]]
        post_bad = [p for p in post if p[0] != 200 or p[1] != 2
                    or not p[2]]
        report["rollout"] = {
            "deployed_version": deployed,
            "ms": round(roll_ms, 1),
            "during_requests": len(roll_res),
            "during_failed": len(bad),
            "post_requests": len(post),
            "post_wrong": len(post_bad),
        }
        if deployed != 2:
            failures.append("deploy returned version %r != 2" % deployed)
        if bad:
            failures.append(
                "rollout dropped or corrupted %d/%d in-flight requests: "
                "%r" % (len(bad), len(roll_res), bad[:3])
            )
        if post_bad:
            failures.append(
                "post-rollout traffic not all v2-correct: %r"
                % post_bad[:3]
            )
        ev = fleet_mod.load_events(workdir)
        if not any(e.get("event") == "rollout_done" for e in ev):
            failures.append("rollout left no rollout_done event")

        # ---- strict gate: 0 steady-state recompiles fleet-wide -------
        steady = {}
        for info in ctrl.replica_info():
            port = info.get("metrics_port")
            if not port or info["state"] != "ready":
                continue
            try:
                with urllib.request.urlopen(
                    "http://127.0.0.1:%d/metrics" % port, timeout=5
                ) as r:
                    text = r.read().decode("utf-8")
                from paddle_tpu_torch.observability import registry as _reg

                steady[info["id"]] = int(_reg.parse_prometheus(text).get(
                    ("serving_steady_recompiles", ""), 0
                ))
            except Exception as e:  # noqa: BLE001
                failures.append("metrics scrape failed for replica %s: %r"
                                % (info["id"], e))
        report["strict"] = {
            "replicas_scraped": len(steady),
            "steady_recompiles": sum(steady.values()),
        }
        if not steady:
            failures.append("no replica metrics scraped")
        if sum(steady.values()) != 0:
            failures.append("%d steady-state recompiles across the fleet"
                            % sum(steady.values()))
    finally:
        try:
            ctrl.stop()
        except Exception as e:  # noqa: BLE001
            failures.append("controller stop failed: %r" % e)

    # ---- durable generations: mid-stream failover, token-exact -------
    _flags.set_flags({"FLAGS_router_generate_retries": 2})
    try:
        run_generate_failover_trial(
            tmp, os.path.join(tmp, "export_v1"), report, failures, fast,
            device
        )
    except Exception as e:  # noqa: BLE001 - the trial must report, not die
        failures.append("gen-failover trial crashed: %r" % e)

    # ---- fleet KV tier: affinity routing + host-spill churn ----------
    try:
        run_kv_tier_trial(
            tmp, os.path.join(tmp, "export_v1"), report, failures, fast,
            device
        )
    except Exception as e:  # noqa: BLE001 - the trial must report, not die
        failures.append("kv-tier trial crashed: %r" % e)

    # ---- controller durability: crash, adopt, reconcile --------------
    try:
        run_controller_crash_trial(tmp, report, failures, fast, device)
    except Exception as e:  # noqa: BLE001 - the trial must report, not die
        failures.append("controller-crash trial crashed: %r" % e)

    # ---- merged fleet report -----------------------------------------
    fr_path = os.path.join(workdir, "fleet_report.json")
    try:
        with open(fr_path) as f:
            fr = json.load(f)
        report["fleet_report"] = {
            "timeline_events": len(fr.get("replica_timeline", [])),
            "scale_ups": fr.get("scale_ups"),
            "scale_downs": fr.get("scale_downs"),
            "rollouts": len(fr.get("rollouts", [])),
            "crashes": fr.get("crashes"),
            "replicas_reporting": len(fr.get("per_replica", {})),
        }
        if not fr.get("replica_timeline"):
            failures.append("fleet_report has no replica timeline")
        if not fr.get("per_replica"):
            failures.append("fleet_report merged no replica snapshots")
        if not fr.get("scale_ups") or not fr.get("rollouts"):
            failures.append("fleet_report missing scale/rollout events")
    except (OSError, ValueError) as e:
        failures.append("fleet_report.json unreadable: %r" % e)

    if keep_workdir:
        # leave the flight dumps + fleet_report.json on disk so
        # ``python -m paddle_tpu_torch.tools.fleet_sim --obs-root
        # <tmp>/fleet*/obs --compare``
        # can calibrate the simulator against this live run
        report["workdir"] = tmp
        print("WORKDIR %s" % tmp, flush=True)
    else:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    report["pass"] = not failures
    report["failures"] = failures
    if verbose:
        print(json.dumps(report, indent=1), file=sys.stderr)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="tier-1 budget subset")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--keep-workdir", action="store_true",
                    help="don't delete the temp workdir; prints its "
                         "path so fleet_sim can replay the recording")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where replicas and oracles run (no fallback)")
    # hidden: the controller-durability trial's runner child
    ap.add_argument("--runner", choices=("serve", "rollout"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--workdir", help=argparse.SUPPRESS)
    ap.add_argument("--model-dir", help=argparse.SUPPRESS)
    ap.add_argument("--ready-file", help=argparse.SUPPRESS)
    ap.add_argument("--replicas", type=int, default=3,
                    help=argparse.SUPPRESS)
    ap.add_argument("--gpt-decode", help=argparse.SUPPRESS)
    ap.add_argument("--kill-at-phase", help=argparse.SUPPRESS)
    ap.add_argument("--deploy-dir", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.runner:
        return run_runner(args)
    report = run_probe(fast=args.fast, verbose=args.verbose,
                       keep_workdir=args.keep_workdir, device=args.device)
    print("REPORT " + json.dumps(report, sort_keys=True), flush=True)
    print("PROBE PASS" if report["pass"]
          else "PROBE FAIL: %s" % "; ".join(report["failures"]))
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
