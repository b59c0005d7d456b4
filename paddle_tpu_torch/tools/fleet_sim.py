"""Trace-driven fleet simulator CLI (port of ``tools/fleet_sim.py``, the
``paddle_tpu_torch/serving/sim`` front end).

Replays a workload — recorded flight-recorder journeys, a whole
controller obs tree, or a synthetic shape — through the REAL fleet
control-plane classes (autoscaler policy, gateway admission, router
pick) on a virtual clock: a full day of traffic in seconds, no
subprocesses, deterministic under ``--seed``.

Workload sources (exactly one):

    --journeys FILE        journey JSONL (observability.flight codec)
    --obs-root DIR         every flight dump under a fleet obs tree
    --synthetic KIND       flat | diurnal | skew | flash

What-if knobs: ``--scale 100`` replays the recorded day at 100x
volume; ``--policy slo`` swaps in the SLO-driven autoscaler;
``--slots/--min-replicas/--max-replicas`` reshape the simulated fleet.

``--compare WORKDIR`` calibrates the simulator against the live run
that produced the recording: it reads ``fleet_report.json`` (replica
trajectory, sheds) + the flight records under the workdir's obs tree,
replays the same journeys, and prints live vs predicted deltas — the
calibration table.

Examples::

    python -m paddle_tpu_torch.tools.fleet_sim \
        --synthetic flash --duration 600 --rps 4 --policy slo

    python -m paddle_tpu_torch.tools.fleet_sim \
        --obs-root /tmp/fleet/obs --scale 10 --out sim_report.json

Prints one REPORT json line; exit 0 unless the workload is empty or
(under ``--compare``) a calibration bar is missed.
"""

import argparse
import json
import os
import sys

# calibration bars for --compare (fractional error vs live)
CALIBRATION_TOL = 0.20


def _load_obs_journeys(obs_root):
    from paddle_tpu_torch.observability import aggregate, flight

    return [flight.to_journey(dict(rec, process=label))
            for label, rec in aggregate.read_flight_records(obs_root)]


def _completed_journeys(journeys):
    """The rows that describe a full served request (have a duration)."""
    return [j for j in journeys if j.get("ms") is not None
            and j.get("status") in (None, 200)]


def build_workload(args):
    from paddle_tpu_torch.serving import sim

    if args.synthetic:
        wl = sim.synthetic_workload(
            args.synthetic, duration_s=args.duration, rps=args.rps,
            seed=args.seed, batch_fraction=args.batch_fraction,
        )
        return wl, None
    if args.journeys:
        journeys = sim.load_journeys(args.journeys)
    else:
        journeys = _load_obs_journeys(args.obs_root)
    # the OFFERED load includes requests the live run shed (they have an
    # arrival stamp but no duration) — dropping them would make the sim
    # under-predict sheds; only the service-time FIT is completed-only.
    journeys = [j for j in journeys if j.get("ts") is not None]
    wl = sim.from_journeys(journeys, scale=args.scale, seed=args.seed)
    return wl, journeys


def run_sim(args, workload, journeys):
    from paddle_tpu_torch.serving import sim

    fit_rows = _completed_journeys(journeys or [])
    model = (sim.ServiceModel.fit(fit_rows) if fit_rows
             else sim.ServiceModel())
    policy = sim.make_policy(args.policy,
                             min_replicas=args.min_replicas,
                             max_replicas=args.max_replicas)
    fs = sim.FleetSim(
        workload, model=model, policy=policy, seed=args.seed,
        slots=args.slots, queue_depth=args.queue_depth,
        min_replicas=args.min_replicas, max_replicas=args.max_replicas,
        scale_interval_s=args.scale_interval,
        rate_rps=args.rate_rps, burst=args.burst,
    )
    return fs.run()


def _pct_err(live, pred):
    if live is None or pred is None:
        return None
    live = float(live)
    if live == 0:
        return 0.0 if float(pred) == 0 else float("inf")
    return abs(float(pred) - live) / abs(live)


def compare_live(args, report):
    """Live workdir vs sim prediction: the calibration table."""
    from paddle_tpu_torch.observability import registry

    fr_path = os.path.join(args.compare, "fleet_report.json")
    with open(fr_path) as f:
        live = json.load(f)
    obs_root = os.path.join(args.compare, "obs")
    journeys = _completed_journeys(_load_obs_journeys(obs_root))
    # TTFT of a non-streaming (tokens-free) journey IS its duration —
    # the request's single response is its first token
    live_ttft = registry.percentiles(
        [j["ttft_ms"] if j.get("ttft_ms") is not None else j["ms"]
         for j in journeys
         if j.get("ttft_ms") is not None
         or (j.get("ms") is not None and not j.get("tokens"))]
    )
    # replica trajectory: the autoscaler's own scale decisions when the
    # report has them (a blue-green rollout transiently doubles READY
    # replicas without the policy asking for it); timeline otherwise
    ev = live.get("scale_events") or []
    if ev:
        live_max = max([e.get("to_replicas") or 0 for e in ev]
                       + [e.get("from_replicas") or 0 for e in ev])
    else:
        counts = [e.get("ready_replicas")
                  for e in live.get("replica_timeline", [])]
        live_max = max([c for c in counts if c is not None] or [0])
    live_shed = sum(
        int(j.get("status") == 429 or j.get("reason") in
            ("ratelimit", "quota", "overload"))
        for j in _load_obs_journeys(obs_root)
    )
    sim_max = max([n for _t, n in report["replica_trajectory"]] or [0])
    sim_shed = report["requests"]["shed"]
    sim_ttft = None
    for cls in ("interactive", "batch"):
        p = report["classes"][cls]["ttft_ms"].get("p95")
        if p is not None:
            sim_ttft = p if sim_ttft is None else max(sim_ttft, p)
    rows = [
        ("max_replicas", live_max, sim_max),
        ("shed_requests", live_shed, sim_shed),
        ("p95_ttft_ms", live_ttft.get("p95"), sim_ttft),
    ]
    table, failures = [], []
    for name, lv, pv in rows:
        err = _pct_err(lv, pv)
        table.append({"metric": name, "live": lv, "sim": pv,
                      "err": None if err is None else round(err, 3)})
        if err is not None and err > CALIBRATION_TOL:
            failures.append("%s: live=%s sim=%s err=%.0f%%"
                            % (name, lv, pv, err * 100))
    return {"table": table, "tolerance": CALIBRATION_TOL,
            "failures": failures}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--journeys", help="journey JSONL file")
    src.add_argument("--obs-root", help="fleet obs tree with flight dumps")
    src.add_argument("--synthetic",
                     choices=["flat", "diurnal", "skew", "flash"])
    ap.add_argument("--duration", type=float, default=600.0,
                    help="synthetic duration (virtual seconds)")
    ap.add_argument("--rps", type=float, default=2.0,
                    help="synthetic nominal request rate")
    ap.add_argument("--batch-fraction", type=float, default=0.3)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="replay the recorded day at Nx volume")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--policy", default=None,
                    help="streak | slo (default FLAGS_fleet_policy)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--queue-depth", type=int, default=64)
    ap.add_argument("--rate-rps", type=float, default=0.0,
                    help="per-replica admission rate limit (0 = off); "
                         "match the live FLAGS_gateway_rate_limit_rps "
                         "when calibrating")
    ap.add_argument("--burst", type=int, default=1,
                    help="per-replica admission burst capacity")
    ap.add_argument("--min-replicas", type=int, default=1)
    ap.add_argument("--max-replicas", type=int, default=4)
    ap.add_argument("--scale-interval", type=float, default=2.0,
                    help="virtual seconds between policy ticks")
    ap.add_argument("--out", help="write the full report json here")
    ap.add_argument("--compare",
                    help="live fleet workdir to calibrate against")
    args = ap.parse_args(argv)

    workload, journeys = build_workload(args)
    if not workload:
        print("REPORT " + json.dumps({"error": "empty workload"}))
        return 1
    report = run_sim(args, workload, journeys)

    from paddle_tpu_torch.fluid import profiler as _profiler

    _profiler.bump_counter("sim_requests_replayed",
                           report["requests"]["injected"])
    _profiler.bump_counter("sim_requests_shed", report["requests"]["shed"])
    _profiler.bump_counter("sim_preemptions", report["preemptions"])

    rc = 0
    if args.compare:
        report["calibration"] = compare_live(args, report)
        if report["calibration"]["failures"]:
            rc = 1
    if args.out:
        tmp = args.out + ".tmp"
        with open(tmp, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
        os.replace(tmp, args.out)
    line = {
        "requests": report["requests"],
        "preemptions": report["preemptions"],
        "policy": report["policy"],
        "final_target": report["final_target"],
        "virtual_s": report["virtual_s"],
        "interactive_p95_ttft_ms":
            report["classes"]["interactive"]["ttft_ms"].get("p95"),
        "batch_p95_ttft_ms":
            report["classes"]["batch"]["ttft_ms"].get("p95"),
    }
    if args.compare:
        line["calibration"] = report["calibration"]
    print("REPORT " + json.dumps(line, sort_keys=True))
    print("SIM PASS" if rc == 0 else "SIM FAIL")
    return rc


if __name__ == "__main__":
    sys.exit(main())
