"""The port's fleet simulator (``paddle_tpu_torch/serving/sim``) held
against the reference's on the CPU.

- Parity: for each synthetic shape (``flat``, ``diurnal``, ``skew``,
  ``flash``) under each autoscaler policy, ``FleetSim(..., seed=N).run()``
  gives a report that is JSON-equal between the two packages; so does a
  replay of recorded journeys. The simulator runs the packages' own
  policy, admission and router classes on a virtual clock, so equal
  reports hold those classes to each other too.
- The reference's unit cases of ``tests/test_fleet_sim.py`` on the
  port's classes: the journey codec, admission wait-queue visibility,
  ``SLOPolicy`` and ``make_policy``, the simulator core. Its preemption
  cases drive the decode engine, which ``tests/test_torch_engine.py``
  holds to the reference's.
- The CLI, ``python -m paddle_tpu_torch.tools.fleet_sim``, as a smoke
  test whose written report equals the reference simulator's.
"""

import json
import os
import time

import numpy as np
import pytest

from paddle_tpu.fluid import flags as jflags
from paddle_tpu.serving import sim as jsim
from paddle_tpu_torch.fluid import flags as _flags
from paddle_tpu_torch.observability import flight as obs_flight
from paddle_tpu_torch.observability import registry as obs_registry
from paddle_tpu_torch.serving import sim
from paddle_tpu_torch.serving.fleet import (
    AutoscalerPolicy,
    SLOPolicy,
    make_policy,
)
from paddle_tpu_torch.serving.gateway import _Admission, _AdmissionDenied

SHAPES = ("flat", "diurnal", "skew", "flash")


def _report(mod, shape, policy, seed, duration_s=600.0, rps=2.0):
    wl = mod.synthetic_workload(shape, duration_s=duration_s, rps=rps,
                                seed=seed, batch_fraction=0.3)
    return mod.FleetSim(
        wl, policy=mod.make_policy(policy, min_replicas=1, max_replicas=4),
        seed=seed, slots=4, min_replicas=1, max_replicas=4).run()


def jsim_report(shape, policy, seed, **kw):
    return _report(jsim, shape, policy, seed, **kw)


@pytest.fixture(autouse=True)
def _sim_flags_at_defaults():
    """The simulator reads ``fleet_policy`` and ``sim_replica_ready_s``:
    both packages at their defaults."""
    names = ("fleet_policy", "sim_replica_ready_s")
    jsaved = jflags.get_flags(["FLAGS_" + n for n in names])
    jflags.set_flags({"FLAGS_" + n: jflags._DEFAULTS[n] for n in names})
    _flags.set_flags({"FLAGS_" + n: _flags._DEFAULTS[n] for n in names})
    yield
    jflags.set_flags(jsaved)


@pytest.mark.parametrize("policy", ["streak", "slo"])
@pytest.mark.parametrize("shape", SHAPES)
def test_synthetic_reports_equal_the_reference(shape, policy):
    seed = 11 + SHAPES.index(shape)
    got = _report(sim, shape, policy, seed)
    want = jsim_report(shape, policy, seed)
    assert got["requests"]["injected"] > 100
    assert got["requests"]["incomplete"] == 0
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)


def test_journey_replay_report_equals_the_reference():
    """Recorded journeys, replayed at 3x with a fitted service model."""
    rs = np.random.RandomState(4)
    journeys = [
        {"request_id": "r%d" % i, "ts": 100.0 + 0.7 * i,
         "ms": float(rs.uniform(30, 400)), "tokens": int(rs.randint(1, 20)),
         "ttft_ms": float(rs.uniform(5, 60)), "status": 200,
         "tenant": "t%d" % (i % 3),
         "priority": "batch" if i % 4 == 0 else "interactive"}
        for i in range(60)
    ]
    reports = []
    for mod in (sim, jsim):
        wl = mod.from_journeys(journeys, scale=3, seed=4)
        model = mod.ServiceModel.fit(journeys)
        reports.append(mod.FleetSim(wl, model=model, seed=2, slots=2,
                                    rate_rps=3.0, burst=2).run())
    assert reports[0]["requests"]["injected"] == 180
    assert json.dumps(reports[0], sort_keys=True) == json.dumps(
        reports[1], sort_keys=True)


# ---------------------------------------------------------------------------
# journey codec (flight recorder <-> simulator JSONL)
# ---------------------------------------------------------------------------
class TestJourneyCodec:
    def test_to_journey_coerces_and_stamps(self):
        j = obs_flight.to_journey({
            "request_id": "r-1", "tenant": 7, "priority": "batch",
            "ts": "12.5", "ms": 250, "tokens": "9", "status": 200,
            "ttft_ms": 40.0, "junk_field": object(),
        })
        assert j["schema_version"] == obs_flight.JOURNEY_SCHEMA_VERSION
        assert j["request_id"] == "r-1"
        assert j["tenant"] == "7"             # str field coerced
        assert j["priority"] == "batch"
        assert j["ts"] == 12.5 and j["ms"] == 250.0
        assert j["tokens"] == 9.0 and j["ttft_ms"] == 40.0
        assert "junk_field" not in j

    def test_to_journey_defaults(self):
        j = obs_flight.to_journey({"ms": 5})
        assert j["tenant"] == "anon"
        assert j["priority"] == "interactive"
        # garbage numerics dropped, never raised
        j2 = obs_flight.to_journey({"ms": "not-a-number", "tenant": None})
        assert "ms" not in j2 and j2["tenant"] == "anon"

    def test_round_trip_and_torn_line(self, tmp_path):
        path = str(tmp_path / "journeys.jsonl")
        recs = [
            {"request_id": "a", "ts": 100.0, "ms": 20.0, "tokens": 4,
             "tenant": "t1", "priority": "interactive", "ttft_ms": 6.0},
            {"request_id": "b", "ts": 101.0, "ms": 900.0, "tokens": 30,
             "tenant": "t2", "priority": "batch", "ttft_ms": 50.0},
        ]
        n = obs_flight.write_journeys(path, recs)
        assert n == 2
        with open(path, "a") as f:
            f.write('{"torn": ')       # crash-truncated final line
        loaded = obs_flight.load_journeys(path)
        assert [j["request_id"] for j in loaded] == ["a", "b"]
        for j in loaded:
            assert j["schema_version"] == obs_flight.JOURNEY_SCHEMA_VERSION
        assert obs_flight.load_journeys(str(tmp_path / "nope.jsonl")) == []


# ---------------------------------------------------------------------------
# admission wait-queue visibility (the gateway_admit_waiting gauges)
# ---------------------------------------------------------------------------
class TestAdmissionWaiting:
    def test_waiting_by_class_counts_parked(self):
        adm = _Admission(0.0, 1, 0, 1, 1000.0, clock=lambda: 0.0)
        assert adm.try_admit("t", "interactive") is None   # takes the cap
        assert adm.try_admit("t", "interactive") == "wait"
        adm.note_wait_start("interactive")
        assert adm.try_admit("u", "batch") == "wait"
        adm.note_wait_start("batch")
        assert adm.waiting_by_class() == {"interactive": 1, "batch": 1}
        # batch stays parked while ANY interactive waiter exists
        assert adm.try_grant("u", "batch") == "wait"
        adm.release("t")
        assert adm.try_grant("t", "interactive") is None
        adm.note_wait_end("interactive")
        adm.release("t")
        assert adm.try_grant("u", "batch") is None
        adm.note_wait_end("batch")
        assert adm.waiting_by_class() == {"interactive": 0, "batch": 0}

    def test_denials_raise_like_admit(self):
        adm = _Admission(0.0, 1, 1, 8, 1000.0, clock=lambda: 0.0)
        assert adm.try_admit("t", "interactive") is None
        with pytest.raises(_AdmissionDenied) as e:
            adm.try_admit("t", "interactive")    # over tenant quota
        assert e.value.reason == "quota"

    def test_labeled_gauge_renders_per_class_series(self):
        adm = _Admission(0.0, 1, 0, 1, 1000.0, clock=lambda: 0.0)
        adm.try_admit("t", "interactive")
        assert adm.try_admit("t", "batch") == "wait"
        adm.note_wait_start("batch")
        names = []
        try:
            for cls in ("interactive", "batch"):
                gname = 'gateway_admit_waiting{class="%s"}' % cls
                obs_registry.register_gauge(
                    gname,
                    lambda a=adm, c=cls: a.waiting_by_class().get(c, 0),
                )
                names.append(gname)
            text = obs_registry.render_prometheus()
            parsed = obs_registry.parse_prometheus(text)
            key_i = ("gateway_admit_waiting", 'class="interactive"')
            key_b = ("gateway_admit_waiting", 'class="batch"')
            assert parsed[key_i] == 0.0
            assert parsed[key_b] == 1.0
            # one TYPE line for the whole family, not one per series
            assert text.count("# TYPE gateway_admit_waiting gauge") == 1
        finally:
            for gname in names:
                obs_registry.unregister_gauge(gname)


# ---------------------------------------------------------------------------
# SLOPolicy + make_policy
# ---------------------------------------------------------------------------
def _slo(**kw):
    base = dict(min_replicas=1, max_replicas=4, ttft_budget_ms=100.0,
                intertoken_budget_ms=0.0, headroom=0.5, up_ticks=2,
                down_ticks=3)
    base.update(kw)
    return SLOPolicy(**base)


def _s(ttft, itl=None, shed=0, n=2):
    return [{"queue_depth": 0.0, "shed_delta": shed, "p95_ms": None,
             "ttft_p95_ms": ttft, "intertoken_p95_ms": itl}
            for _ in range(n)]


class TestSLOPolicy:
    def test_breach_needs_sustained_pressure(self):
        p = _slo()
        assert p.observe(_s(150.0), 2) == (2, None)
        assert p.observe(_s(150.0), 2) == (3, "slo_pressure")

    def test_sheds_breach_without_latency_samples(self):
        p = _slo()
        assert p.observe(_s(None, shed=1), 2) == (2, None)
        assert p.observe(_s(None, shed=1), 2) == (3, "slo_pressure")

    def test_headroom_scale_down_hysteresis(self):
        p = _slo()
        for _ in range(2):
            assert p.observe(_s(30.0), 3) == (3, None)
        assert p.observe(_s(30.0), 3) == (2, "slo_headroom")

    def test_band_between_headroom_and_budget_holds(self):
        p = _slo()
        for _ in range(6):
            # 80ms: under the 100ms budget but over 50% headroom
            assert p.observe(_s(80.0), 2) == (2, None)

    def test_intertoken_budget_armed(self):
        p = _slo(ttft_budget_ms=0.0, intertoken_budget_ms=20.0)
        assert p.observe(_s(None, itl=25.0), 1) == (1, None)
        assert p.observe(_s(None, itl=25.0), 1) == (2, "slo_pressure")

    def test_clamps_and_empty_round_resets(self):
        p = _slo()
        assert p.observe([], 7) == (4, None)       # clamp to max
        assert p.observe(_s(500.0), 2) == (2, None)
        assert p.observe([], 2) == (2, None)       # empty resets streak
        assert p.observe(_s(500.0), 2) == (2, None)

    def test_make_policy_selects_by_flag(self):
        assert isinstance(make_policy("slo"), SLOPolicy)
        assert isinstance(make_policy("streak"), AutoscalerPolicy)
        old = _flags.get_flag("fleet_policy", "streak")
        try:
            _flags.set_flags({"FLAGS_fleet_policy": "slo"})
            assert isinstance(make_policy(), SLOPolicy)
        finally:
            _flags.set_flags({"FLAGS_fleet_policy": old})
        with pytest.raises(ValueError):
            make_policy("nope")


# ---------------------------------------------------------------------------
# simulator core
# ---------------------------------------------------------------------------
def _flat_sim(seed=9, **kw):
    wl = sim.synthetic_workload("flat", duration_s=120.0, rps=3.0, seed=5)
    args = dict(seed=seed, slots=2, min_replicas=1, max_replicas=3)
    args.update(kw)
    return sim.FleetSim(wl, **args)


class TestFleetSim:
    def test_deterministic_under_fixed_seed(self):
        r1 = _flat_sim().run()
        r2 = _flat_sim().run()
        assert json.dumps(r1, sort_keys=True) == json.dumps(
            r2, sort_keys=True)

    def test_seed_changes_the_day(self):
        r1 = _flat_sim(seed=1).run()
        r2 = _flat_sim(seed=2).run()
        assert json.dumps(r1, sort_keys=True) != json.dumps(
            r2, sort_keys=True)

    def test_request_conservation(self):
        r = _flat_sim().run()
        req = r["requests"]
        assert req["injected"] == len(_flat_sim().workload)
        assert req["injected"] == req["completed"] + req["shed"]
        assert req["incomplete"] == 0
        assert req["shed"] == sum(req["shed_by_reason"].values())

    def test_replayed_journeys_conserved(self):
        journeys = [
            {"request_id": "r%d" % i, "ts": 100.0 + i, "ms": 80.0,
             "tokens": 5, "ttft_ms": 20.0, "status": 200,
             "tenant": "t%d" % (i % 2),
             "priority": "batch" if i % 3 == 0 else "interactive"}
            for i in range(20)
        ]
        wl = sim.from_journeys(journeys, scale=3, seed=4)
        assert len(wl) == 60
        model = sim.ServiceModel.fit(journeys)
        r = sim.FleetSim(wl, model=model, seed=2, slots=2).run()
        req = r["requests"]
        assert req["injected"] == 60
        assert req["injected"] == req["completed"] + req["shed"]
        assert req["incomplete"] == 0

    def test_streak_policy_parity_tick_for_tick(self):
        """The sim's policy tick IS the live policy: driving the same
        sample rounds through FleetSim.policy_tick and through a
        directly-held AutoscalerPolicy produces the same decision at
        every tick (the policy unit tests' scenario: sustained pressure
        scales up, hysteresis scales down, the middle band holds)."""
        kw = dict(min_replicas=1, max_replicas=4, queue_high=4.0,
                  queue_low=1.0, up_ticks=2, down_ticks=4,
                  latency_high_ms=0.0)
        direct = AutoscalerPolicy(**kw)
        fs = sim.FleetSim([], policy=AutoscalerPolicy(**kw), seed=0)

        def q(depth):
            return [{"queue_depth": depth, "shed_delta": 0,
                     "p95_ms": None} for _ in range(2)]

        rounds = ([q(10)] * 4 + [q(2)] * 3 + [q(0)] * 9 + [[]]
                  + [q(10)] * 2)
        target = 1
        for i, samples in enumerate(rounds):
            want_target, want_reason = direct.observe(samples, target)
            got = fs.policy_tick(samples)
            assert got == (want_target, want_reason), "tick %d" % i
            target = want_target
            assert fs._target == target

    def test_policy_tick_applies_scaling_to_the_pool(self):
        fs = sim.FleetSim([], policy=AutoscalerPolicy(
            min_replicas=1, max_replicas=4, queue_high=4.0,
            queue_low=1.0, up_ticks=1, down_ticks=2,
            latency_high_ms=0.0), seed=0, replica_ready_s=0.0)
        pressure = [{"queue_depth": 10, "shed_delta": 0, "p95_ms": None}]
        fs.policy_tick(pressure)
        assert fs._target == 2
        # two more replicas were scheduled to spawn (1 initial missing:
        # run() spawns the floor; here only the delta spawns)
        assert len(fs._handles) >= 1

    def test_slowest_requests_reads_the_same_codec(self, tmp_path):
        from paddle_tpu_torch.observability import aggregate

        obs_root = str(tmp_path)
        rec = {"request_id": "slow-1", "ts": 50.0, "ms": 1234.5,
               "tokens": 3, "tenant": "t", "priority": "interactive"}
        with open(os.path.join(obs_root, "flight_rank_0.json"),
                  "w") as f:
            json.dump({"records": [rec]}, f)
        rows = aggregate.slowest_requests(obs_root, top=5)
        assert rows and rows[0]["request_id"] == "slow-1"
        assert rows[0]["ms"] == 1234.5
        assert rows[0]["schema_version"] == \
            obs_flight.JOURNEY_SCHEMA_VERSION
        # the same row replays through the simulator's workload builder
        wl = sim.from_journeys(rows)
        assert len(wl) == 1 and wl[0]["tenant"] == "t"

    def test_mixed_slo_overload_interactive_holds(self):
        """The acceptance trial: 3x batch overload on an interactive
        baseline — interactive p95 TTFT stays within its budget while
        batch degrades, and batch streams are preempted."""
        rng = np.random.RandomState(0)
        wl = []
        t = 0.0
        i = 0
        while t < 120.0:                       # interactive baseline
            t += float(rng.exponential(1.0 / 2.0))
            wl.append({"arrival_s": t, "tenant": "live",
                       "priority": "interactive", "prompt_tokens": 8,
                       "max_new_tokens": 8,
                       "request_id": "i-%04d" % i})
            i += 1
        t = 10.0
        while t < 120.0:                       # 3x batch flood
            t += float(rng.exponential(1.0 / 6.0))
            wl.append({"arrival_s": t, "tenant": "bulk",
                       "priority": "batch", "prompt_tokens": 8,
                       "max_new_tokens": 24,
                       "request_id": "b-%04d" % i})
            i += 1
        wl.sort(key=lambda r: (r["arrival_s"], r["request_id"]))
        model = sim.ServiceModel(
            ttft_ms={"interactive": [40.0], "batch": [40.0]},
            intertoken_ms={"interactive": [15.0], "batch": [15.0]},
        )
        budget_ms = 1500.0
        policy = SLOPolicy(min_replicas=1, max_replicas=4,
                           ttft_budget_ms=budget_ms,
                           intertoken_budget_ms=0.0, headroom=0.5,
                           up_ticks=2, down_ticks=4)
        r = sim.FleetSim(wl, model=model, policy=policy, seed=3,
                         slots=2, min_replicas=1, max_replicas=4).run()
        inter = r["classes"]["interactive"]["ttft_ms"]
        batch = r["classes"]["batch"]["ttft_ms"]
        assert inter["count"] > 50 and batch["count"] > 50
        assert inter["p95"] <= budget_ms, r["classes"]
        assert batch["p95"] > inter["p95"] * 2, r["classes"]
        assert r["preemptions"] > 0
        assert any(reason == "slo_pressure"
                   for _t, _n, reason in r["target_trajectory"])
        req = r["requests"]
        assert req["injected"] == req["completed"] + req["shed"]

    def test_two_virtual_hours_replay_fast(self):
        """Hours of virtual time through the event loop cost seconds of
        wall clock (the reason the simulator exists) — fast-suite sized;
        the whole-day trial lives in ``-m slow``."""
        wl = sim.synthetic_workload("diurnal", duration_s=7200.0,
                                    rps=0.25, seed=8)
        assert len(wl) > 500
        t0 = time.monotonic()
        r = sim.FleetSim(wl, seed=8, slots=4, min_replicas=1,
                         max_replicas=4).run()
        wall = time.monotonic() - t0
        assert r["virtual_s"] > 7000.0
        assert r["requests"]["incomplete"] == 0
        assert wall < 10.0, "2h sim took %.1fs" % wall

    @pytest.mark.slow
    def test_whole_day_replays_in_seconds(self):
        """A full virtual day (86400s, ~21k requests) completes without
        losing a request and in well under real-time."""
        wl = sim.synthetic_workload("diurnal", duration_s=86400.0,
                                    rps=0.25, seed=8)
        assert len(wl) > 5000
        t0 = time.monotonic()
        r = sim.FleetSim(wl, seed=8, slots=4, min_replicas=1,
                         max_replicas=4).run()
        wall = time.monotonic() - t0
        assert r["virtual_s"] > 80000.0
        assert r["requests"]["incomplete"] == 0
        assert wall < 120.0, "whole-day sim took %.1fs" % wall


# ---------------------------------------------------------------------------
# CLI (subprocess, fast synthetic run)
# ---------------------------------------------------------------------------
def test_fleet_sim_cli_synthetic(tmp_path):
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = str(tmp_path / "report.json")
    p = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.fleet_sim",
         "--synthetic", "flash", "--duration", "120", "--rps", "2",
         "--policy", "slo", "--seed", "7", "--out", out],
        cwd=repo, capture_output=True, text=True, timeout=300,
    )
    assert p.returncode == 0, p.stdout + p.stderr
    assert "SIM PASS" in p.stdout
    line = next(ln for ln in p.stdout.splitlines()
                if ln.startswith("REPORT "))
    report = json.loads(line[len("REPORT "):])
    with open(out) as f:
        full = json.load(f)
    assert full["requests"] == report["requests"]
    assert full["requests"]["incomplete"] == 0
    assert full["schema_version"] == 1
    # the same run through the reference's simulator: the same report
    ref = jsim_report("flash", "slo", 7, duration_s=120.0, rps=2.0)
    assert json.dumps(full, sort_keys=True) == json.dumps(ref,
                                                          sort_keys=True)
