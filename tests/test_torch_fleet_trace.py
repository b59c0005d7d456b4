"""The port's fleet-wide tracing on the CPU: the reference's unit cases of
``tests/test_fleet_trace.py`` on the port's classes — W3C context
propagation, clock alignment and the span-tree merge of
``observability/fleet_trace.py`` against synthetic trace pulls, orphan
handling, the exporter's ``/trace`` filter, access-log rotation, the
flight recorder and ``observability/aggregate.py``'s slowest-requests
merge. The reference's closed-loop trace probe
(``tools/trace_probe.py``) is not ported yet (ROADMAP A10)."""

import json
import os
import threading
import urllib.request

import pytest

from paddle_tpu_torch.fluid import flags as _flags
from paddle_tpu_torch.fluid import profiler as _profiler
from paddle_tpu_torch.observability import aggregate
from paddle_tpu_torch.observability import fleet_trace
from paddle_tpu_torch.observability import flight
from paddle_tpu_torch.observability import trace
from paddle_tpu_torch.observability.exporter import Exporter
from paddle_tpu_torch.serving.access_log import AccessLog


# ---------------------------------------------------------------------------
# W3C context: traceparent, scope chaining, cross-thread hand-off
# ---------------------------------------------------------------------------
class TestTraceContext:
    def test_traceparent_round_trip(self):
        tid = trace.new_trace_id()
        assert len(tid) == 32
        tp = trace.format_traceparent(tid, "1234567890abcdef")
        assert trace.parse_traceparent(tp) == (tid, "1234567890abcdef")

    @pytest.mark.parametrize("bad", [
        None, "", "garbage", "00-xyz-abc-01",
        "00-" + "0" * 32 + "-1234567890abcdef-01",  # all-zero trace id
        "00-" + "a" * 32 + "-" + "0" * 16 + "-01",  # all-zero span id
        "00-" + "a" * 31 + "-1234567890abcdef-01",  # short trace id
    ])
    def test_traceparent_rejects_malformed(self, bad):
        assert trace.parse_traceparent(bad) is None

    def test_scope_chains_parent_ids(self):
        trace.reset()
        tid = trace.new_trace_id()
        with trace.trace_scope(tid, "f" * 16):
            with trace.span("outer") as outer:
                assert outer.trace_id == tid
                with trace.span("inner"):
                    pass
        spans = {s["name"]: s for s in trace.get_spans()}
        assert spans["outer"]["parent_span_id"] == "f" * 16
        assert spans["inner"]["parent_span_id"] == spans["outer"]["span_id"]
        assert spans["inner"]["trace_id"] == tid

    def test_none_scope_is_noop(self):
        trace.reset()
        with trace.trace_scope(None):
            with trace.span("plain"):
                assert trace.current_context() is None
        s = trace.get_spans()[-1]
        assert s["trace_id"] is None and s["span_id"] is None

    def test_context_hand_off_across_threads(self):
        """The batcher/engine pattern: capture on the handler thread,
        re-enter on a worker — the worker's spans chain to the
        handler's span as their parent."""
        trace.reset()
        tid = trace.new_trace_id()
        captured = {}

        def worker():
            with trace.trace_scope(*captured["ctx"]):
                with trace.span("engine_side"):
                    pass

        with trace.trace_scope(tid):
            with trace.span("handler") as h:
                captured["ctx"] = trace.current_context()
                t = threading.Thread(target=worker)
                t.start()
                t.join()
        spans = {s["name"]: s for s in trace.get_spans()}
        assert spans["engine_side"]["trace_id"] == tid
        assert spans["engine_side"]["parent_span_id"] == h.span_id

    def test_instant_records_inside_context(self):
        trace.reset()
        tid = trace.new_trace_id()
        with trace.trace_scope(tid):
            with trace.span("relay") as sp:
                trace.instant("generate_failover", cat="router",
                              from_backend="a", to_backend="b")
        inst = [s for s in trace.get_spans() if s["instant"]][0]
        assert inst["trace_id"] == tid
        assert inst["parent_span_id"] == sp.span_id
        assert inst["start"] == inst["end"]

    def test_newest_zero_means_none_not_all(self):
        """Regression: ``recs[-0:]`` is the WHOLE list — newest=0 must
        dump zero spans, not the full ring."""
        trace.reset()
        with trace.span("a"):
            pass
        assert trace.get_spans(newest=0) == []
        ct = trace.chrome_trace(newest=0)
        assert [e for e in ct["traceEvents"] if e["ph"] == "X"] == []
        tid = trace.new_trace_id()
        with trace.trace_scope(tid):
            with trace.span("b"):
                pass
        ct = trace.chrome_trace(trace_id=tid, newest=0)
        assert [e for e in ct["traceEvents"] if e["ph"] == "X"] == []

    def test_chrome_trace_filter_and_envelope(self):
        trace.reset()
        t1, t2 = trace.new_trace_id(), trace.new_trace_id()
        with trace.trace_scope(t1):
            with trace.span("req1"):
                pass
        with trace.trace_scope(t2):
            with trace.span("req2"):
                pass
        with trace.span("tick", trace_ids=[t1]):
            pass
        ct = trace.chrome_trace(trace_id=t1)
        names = [e["name"] for e in ct["traceEvents"]
                 if e["ph"] in ("X", "i")]
        assert "req1" in names and "tick" in names
        assert "req2" not in names
        assert ct["schema_version"] == trace.TRACE_SCHEMA_VERSION
        assert set(ct["clock_anchor"]) == {"ts", "ts_mono"}
        assert isinstance(ct["ts_base"], float)
        # absolute span times reconstruct through ts_base
        ev = [e for e in ct["traceEvents"] if e["name"] == "req1"][0]
        src = [s for s in trace.get_spans() if s["name"] == "req1"][0]
        assert ct["ts_base"] + ev["ts"] / 1e6 == pytest.approx(
            src["start"], abs=1e-6
        )


# ---------------------------------------------------------------------------
# clock alignment: the anchor-pair offset math
# ---------------------------------------------------------------------------
def _pull(label, spans, anchor, skew_s=0.0):
    """A synthetic /trace pull: ``spans`` are (name, start_mono,
    end_mono, args) tuples on the process's OWN span clock."""
    base = min(s[1] for s in spans) if spans else 0.0
    events = []
    for name, start, end, args in spans:
        events.append({
            "name": name, "cat": "t", "ph": "X",
            "ts": (start - base) * 1e6, "dur": (end - start) * 1e6,
            "pid": 0, "tid": 1, "args": args,
        })
    return {
        "label": label,
        "trace": {"traceEvents": events, "ts_base": base,
                  "clock_anchor": anchor,
                  "schema_version": trace.TRACE_SCHEMA_VERSION},
        "anchor": anchor,
        "skew_s": skew_s,
    }


def _args(tid, sid, parent=None):
    a = {"trace_id": tid, "span_id": sid}
    if parent:
        a["parent_span_id"] = parent
    return a


class TestClockAlignment:
    def test_skewed_wall_clocks_align(self):
        """Process B's wall clock is 100 s ahead; its mono epoch is
        arbitrary. With the measured skew fed in, B's child span lands
        INSIDE A's parent on the merged timeline."""
        tid = "a" * 32
        # A: mono 40 == wall 1000; router span [40.1, 41.5] -> wall
        # [1000.1, 1001.5]
        a = _pull("A", [("router", 40.1, 41.5, _args(tid, "1" * 16))],
                  anchor={"ts": 1000.0, "ts_mono": 40.0})
        # B: wall 1100.25 at mono 7.0 — its wall runs 100 s ahead of
        # A's (B's mono 7 "really" is wall 1000.25). The span
        # [7.05, 7.85] -> true wall [1000.30, 1001.10], inside A's.
        b = _pull(
            "B",
            [("gateway", 7.05, 7.85,
              _args(tid, "2" * 16, parent="1" * 16))],
            anchor={"ts": 1100.25, "ts_mono": 7.0},
            skew_s=100.0,
        )
        merged = fleet_trace.merge([a, b])
        tree = merged["trees"][tid]
        assert tree["connected"]
        assert fleet_trace.containment_violations(tree,
                                                  slack_s=0.001) == []
        gw = tree["nodes"]["2" * 16]
        assert gw["start"] == pytest.approx(1000.30, abs=1e-6)

    def test_unskewed_same_host_alignment(self):
        """Same-host processes: different mono epochs, identical wall
        clocks, zero skew — alignment through the anchors alone."""
        tid = "b" * 32
        a = _pull("A", [("router", 100.0, 102.0, _args(tid, "1" * 16))],
                  anchor={"ts": 500.0, "ts_mono": 90.0})
        b = _pull(
            "B",
            [("gateway", 3.5, 4.5,
              _args(tid, "2" * 16, parent="1" * 16))],
            anchor={"ts": 500.0, "ts_mono": -7.0},
        )
        merged = fleet_trace.merge([a, b])
        tree = merged["trees"][tid]
        assert fleet_trace.containment_violations(tree,
                                                  slack_s=0.001) == []

    def test_mono_only_process_degrades_to_identity(self):
        """An anchor without a wall ts (a foreign exporter): the merge
        maps its mono times through the REFERENCE anchor — correct
        exactly when the processes share a monotonic epoch."""
        clock = fleet_trace.ProcessClock(
            {"ts_mono": 10.0},  # no "ts"
            reference={"ts": 1000.0, "ts_mono": 40.0},
        )
        assert clock.to_wall(41.0) == pytest.approx(1001.0)

    def test_restart_changes_the_anchor(self):
        """A restarted process has a fresh mono epoch AND a fresh
        anchor riding its new /trace payload: spans from both lives
        land at the right wall times because each pull aligns through
        its OWN anchor, never a cached one."""
        tid1, tid2 = "c" * 32, "d" * 32
        ref = {"ts": 2000.0, "ts_mono": 100.0}
        a = _pull("ctrl", [
            ("router", 100.0, 101.0, _args(tid1, "1" * 16)),
            ("router", 200.0, 201.0, _args(tid2, "3" * 16)),
        ], anchor=ref)
        life1 = _pull("B", [("gateway", 50.2, 50.5,
                             _args(tid1, "2" * 16, parent="1" * 16))],
                      anchor={"ts": 2000.3, "ts_mono": 50.0})
        # restart: mono restarts near zero, wall has moved on 100 s
        life2 = _pull("B", [("gateway", 1.2, 1.5,
                             _args(tid2, "4" * 16, parent="3" * 16))],
                      anchor={"ts": 2100.3, "ts_mono": 1.0})
        merged = fleet_trace.merge([a, life1, life2])
        for tid in (tid1, tid2):
            tree = merged["trees"][tid]
            assert tree["connected"], tid
            assert fleet_trace.containment_violations(
                tree, slack_s=0.001) == [], tid

    def test_skew_estimate_tolerance(self):
        # within tolerance: indistinguishable from pull latency -> 0
        assert fleet_trace.ProcessClock.estimate_skew(
            1000.05, 1000.0, 1000.02) == 0.0
        # genuinely skewed: the estimate wins
        est = fleet_trace.ProcessClock.estimate_skew(
            1100.0, 1000.0, 1000.02)
        assert est == pytest.approx(99.99, abs=0.1)
        assert fleet_trace.ProcessClock.estimate_skew(
            None, 1000.0, 1000.02) == 0.0


# ---------------------------------------------------------------------------
# span trees: orphans, shared-work spans, connectivity
# ---------------------------------------------------------------------------
class TestSpanTrees:
    def test_orphans_attach_to_synthetic_root_never_dropped(self):
        """Regression: spans whose parent was evicted from the bounded
        ring (or died with its process mid-request) attach under a
        synthetic per-process node that hangs off the trace root — the
        tree stays connected, the orphan stays visible and counted."""
        tid = "e" * 32
        a = _pull("ctrl", [("router", 10.0, 12.0, _args(tid, "1" * 16))],
                  anchor={"ts": 0.0, "ts_mono": 0.0})
        b = _pull(
            "victim",
            [("decode_prefill", 10.5, 10.7,
              _args(tid, "5" * 16, parent="dead000000000000"))],
            anchor={"ts": 0.0, "ts_mono": 0.0},
        )
        before = _profiler.get_counters().get("trace_orphan_spans", 0)
        merged = fleet_trace.merge([a, b])
        tree = merged["trees"][tid]
        assert tree["orphans"] == 1
        assert tree["connected"]  # synthetic root keeps it one tree
        synth = "synthetic:victim"
        assert synth in tree["nodes"]
        assert tree["nodes"][synth]["synthetic"] is True
        assert "5" * 16 in tree["children"][synth]
        assert tree["nodes"]["5" * 16]["orphan"] is True
        # counted on the registry, and no timing claim on the
        # synthetic edge (containment skips it)
        after = _profiler.get_counters().get("trace_orphan_spans", 0)
        assert after == before + 1
        assert fleet_trace.containment_violations(tree) == []

    def test_shared_work_spans_join_every_listed_tree(self):
        t1, t2 = "f" * 32, "a1" + "f" * 30
        pull = _pull("r", [
            ("router", 0.0, 1.0, _args(t1, "1" * 16)),
            ("router", 0.0, 1.0, _args(t2, "2" * 16)),
            ("decode_tick", 0.2, 0.3, {"trace_ids": [t1, t2]}),
        ], anchor={"ts": 0.0, "ts_mono": 0.0})
        merged = fleet_trace.merge([pull])
        for t in (t1, t2):
            ticks = merged["trees"][t]["ticks"]
            assert len(ticks) == 1 and ticks[0]["name"] == "decode_tick"

    def test_cross_process_link_counts(self):
        tid = "9" * 32
        a = _pull("ctrl", [("router", 0.0, 1.0, _args(tid, "1" * 16))],
                  anchor={"ts": 0.0, "ts_mono": 0.0})
        b = _pull("rep", [("gateway", 0.1, 0.9,
                           _args(tid, "2" * 16, parent="1" * 16))],
                  anchor={"ts": 0.0, "ts_mono": 0.0})
        before = _profiler.get_counters().get("trace_requests_linked", 0)
        merged = fleet_trace.merge([a, b])
        assert merged["requests_linked"] == 1
        assert merged["trees"][tid]["processes"] == {"ctrl", "rep"}
        assert _profiler.get_counters().get(
            "trace_requests_linked", 0) == before + 1

    def test_adopted_traceparent_tree_promotes_fleet_root(self):
        """Regression: 'send your own traceparent and the fleet joins
        YOUR trace' — every fleet span then chains up to the CLIENT's
        remote span, which no pull contains. The fleet's topmost span
        must be promoted to root (remote parentage kept visible), not
        reported as a disconnected orphan forest."""
        tid = "b" * 32
        remote = "dead000000000000"  # the client's span, never pulled
        a = _pull("ctrl", [("router_request", 0.0, 2.0,
                            _args(tid, "1" * 16, parent=remote))],
                  anchor={"ts": 0.0, "ts_mono": 0.0})
        b = _pull("rep", [("gateway_request", 0.2, 1.8,
                           _args(tid, "2" * 16, parent="1" * 16))],
                  anchor={"ts": 0.0, "ts_mono": 0.0})
        merged = fleet_trace.merge([a, b])
        tree = merged["trees"][tid]
        assert tree["root"] == "1" * 16
        assert tree["connected"]
        assert tree["orphans"] == 0
        assert tree["nodes"]["1" * 16]["remote_parent"] is True
        assert merged["requests_linked"] == 1
        assert fleet_trace.containment_violations(tree) == []

    def test_live_pull_and_own_dump_merge_once(self):
        """Regression: a live process's snapshot loop also writes its
        black box to disk, so --endpoint + --obs-root hands merge() the
        SAME process twice (once live, once as a dump). The duplicate
        must be dropped by (rank, pid_os) identity — not merged as a
        second pid row that fakes a cross-process link."""
        tid = "c" * 32
        live = _pull("replica0",
                     [("gateway_request", 0.0, 1.0,
                       _args(tid, "3" * 16))],
                     anchor={"ts": 0.0, "ts_mono": 0.0})
        live["trace"]["rank"] = 0
        live["trace"]["pid_os"] = 4242
        dump = _pull("replica_0/trace_rank_0.json",
                     [("gateway_request", 0.0, 1.0,
                       _args(tid, "3" * 16))],
                     anchor={"ts": 0.0, "ts_mono": 0.0})
        dump["trace"]["rank"] = 0
        dump["trace"]["pid_os"] = 4242
        before = _profiler.get_counters().get("trace_requests_linked", 0)
        merged = fleet_trace.merge([live, dump])
        assert merged["duplicate_pulls"] == ["replica_0/trace_rank_0.json"]
        assert merged["requests_linked"] == 0  # one process, not two
        assert merged["trees"][tid]["processes"] == {"replica0"}
        assert _profiler.get_counters().get(
            "trace_requests_linked", 0) == before
        pids = {e["pid"] for e in merged["trace"]["traceEvents"]}
        assert pids == {0}  # a single process row in Perfetto
        # a RESTARTED replica (same rank, new pid) is a different
        # process and must still merge as its own row
        dump["trace"]["pid_os"] = 4243
        merged = fleet_trace.merge([live, dump])
        assert merged["duplicate_pulls"] == []
        assert len(merged["trace"]["merged_processes"]) == 2


# ---------------------------------------------------------------------------
# /trace endpoint: filter + schema stamp over real HTTP
# ---------------------------------------------------------------------------
def test_trace_endpoint_filters_by_trace_id():
    trace.reset()
    tid = trace.new_trace_id()
    with trace.trace_scope(tid):
        with trace.span("wanted"):
            pass
    with trace.span("unrelated"):
        pass
    exp = Exporter(port=0, snapshot_dir=None).start()
    try:
        with urllib.request.urlopen(
            exp.url("/trace?trace_id=%s" % tid), timeout=5
        ) as r:
            payload = json.loads(r.read().decode("utf-8"))
        names = [e["name"] for e in payload["traceEvents"]
                 if e["ph"] == "X"]
        assert "wanted" in names and "unrelated" not in names
        assert payload["schema_version"] == trace.TRACE_SCHEMA_VERSION
        # the healthz anchor pair the merge aligns with
        with urllib.request.urlopen(exp.url("/healthz"), timeout=5) as r:
            health = json.loads(r.read().decode("utf-8"))
        assert "ts" in health and "ts_mono" in health
    finally:
        exp.stop()


# ---------------------------------------------------------------------------
# access-log rotation (gateway + router share the writer)
# ---------------------------------------------------------------------------
class TestAccessLogRotation:
    def test_rotation_keeps_one_rollover(self, tmp_path):
        path = str(tmp_path / "access.jsonl")
        # ~1 KB cap: a handful of writes trips it repeatedly
        log = AccessLog(path, max_mb=1.0 / 1024)
        before = _profiler.get_counters().get("access_log_rotations", 0)
        for i in range(200):
            log.write({"i": i, "pad": "x" * 80})
        after = _profiler.get_counters().get("access_log_rotations", 0)
        assert after > before
        assert os.path.exists(path + ".1")
        # keep-1: no .2 ever appears, and the pair stays bounded
        assert not os.path.exists(path + ".2")
        for p in (path, path + ".1"):
            size = os.path.getsize(p)
            assert size <= 2 * 1024, "log %s grew past the cap" % p
            # whole lines survive rotation (no torn records)
            with open(p) as f:
                for line in f:
                    json.loads(line)

    def test_unbounded_by_default(self, tmp_path):
        path = str(tmp_path / "a.jsonl")
        log = AccessLog(path)  # max_mb 0 = unbounded
        for i in range(50):
            log.write({"i": i})
        assert not os.path.exists(path + ".1")
        assert len(open(path).readlines()) == 50

    def test_pathless_is_disabled(self):
        AccessLog("").write({"x": 1})  # must not raise


# ---------------------------------------------------------------------------
# flight recorder: bounded ring, dump/load, fleet merge
# ---------------------------------------------------------------------------
class TestFlightRecorder:
    def test_ring_bound_and_eviction_count(self):
        flight.reset()
        _flags.set_flags({"FLAGS_trace_flight_records": 4})
        try:
            before = _profiler.get_counters().get(
                "trace_flight_dropped", 0)
            for i in range(10):
                flight.note({"request_id": "r%d" % i, "ms": i})
            recs = flight.records()
            assert len(recs) == 4
            assert [r["request_id"] for r in recs] == \
                ["r6", "r7", "r8", "r9"]
            assert _profiler.get_counters().get(
                "trace_flight_dropped", 0) == before + 6
        finally:
            _flags.set_flags({"FLAGS_trace_flight_records": 256})
            flight.reset()

    def test_dump_and_load_round_trip(self, tmp_path):
        flight.reset()
        flight.note({"request_id": "a", "ms": 5.0, "trace_id": "t1"})
        path = flight.dump(str(tmp_path))
        assert path and os.path.basename(path).startswith("flight_rank_")
        assert flight.load(path)[0]["request_id"] == "a"
        # repeated dumps replace, never duplicate
        flight.dump(str(tmp_path))
        assert len(flight.load(path)) == 1
        flight.reset()

    def test_slowest_requests_merge(self, tmp_path):
        obs = tmp_path / "obs"
        (obs / "replica_0").mkdir(parents=True)
        flight.reset()
        flight.note({"request_id": "slow", "ms": 900.0,
                     "trace_id": "t-slow"})
        flight.note({"request_id": "fast", "ms": 1.0,
                     "trace_id": "t-fast"})
        flight.dump(str(obs / "replica_0"))
        flight.reset()
        flight.note({"request_id": "router-side", "ms": 450.0,
                     "trace_id": "t-mid"})
        flight.dump(str(obs))
        flight.reset()
        rows = aggregate.slowest_requests(str(obs), top=2)
        assert [r["request_id"] for r in rows] == ["slow", "router-side"]
        assert rows[0]["process"] == "replica_0"
        assert rows[1]["process"] == "controller"
