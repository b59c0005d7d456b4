"""Supervisor-side telemetry merge: per-rank snapshots -> gang report
(port of ``paddle_tpu/observability/aggregate.py``).

A supervised gang's telemetry is scattered by design — each rank's
process owns its counters/histograms and leaves ``rank_<r>.jsonl``
snapshot files (exporter.py), and the supervisor's ``supervisor.log``
carries the restart narrative. This module joins them into ONE
``gang_report.json`` an operator (or the crash probe) reads after the
fact: how many restarts and why, downtime per restart, and per-rank
step-time percentiles + progress counters from each rank's NEWEST
snapshot. The supervisor writes it on every restart event and again on
exit, so even a gang that dies mid-flight leaves a merged record.

Snapshots are merged last-line-wins per rank: a restarted worker appends
to the same file, and its newest snapshot reflects the life that
mattered (counters are process-local, so they restart from zero with the
process — the report keeps each life's final word, not a fake sum across
lives).

The serving fleet gets the same treatment (``fleet_report``): the
controller's ``fleet.log`` narrative (scale/rollout/crash events, the
ready-replica count over time) merges with each replica process's
snapshot dir (``obs/replica_<id>/rank_0.jsonl``) into
``fleet_report.json`` — per-replica request tallies beside the
control-plane story.
"""

from __future__ import annotations

import json
import os
import re
import time

from . import registry as _registry

__all__ = [
    "GANG_REPORT",
    "FLEET_REPORT",
    "iter_obs_dumps",
    "read_flight_records",
    "slowest_requests",
    "read_rank_snapshots",
    "read_replica_snapshots",
    "gang_report",
    "write_gang_report",
    "fleet_report",
    "write_fleet_report",
]

GANG_REPORT = "gang_report.json"
FLEET_REPORT = "fleet_report.json"
_RANK_FILE = re.compile(r"^rank_(\d+)\.jsonl$")
_REPLICA_DIR = re.compile(r"^replica_(\d+)$")

# the counters/histograms worth surfacing per rank without dumping the
# whole registry into the report (the full detail stays in the JSONL)
_RANK_COUNTERS = (
    "train_steps",
    "dist_degraded_steps",
    "ckpt_saves_committed",
    "ckpt_restore_fallbacks",
    "ckpt_resharded_restores",
    "executor_plan_cache_hits",
    "executor_plan_cache_misses",
    "pserver_rpc_conn_retries",
)
_RANK_HISTOGRAMS = ("train_step_ms", "ckpt_save_ms", "ckpt_snapshot_ms")


def read_rank_snapshots(obs_dir):
    """{rank: newest snapshot dict} from ``rank_*.jsonl`` under
    ``obs_dir``. Torn/garbage lines are skipped (the writer appends
    whole lines, but a crash can still truncate the last one)."""
    out = {}
    try:
        names = os.listdir(obs_dir)
    except OSError:
        return out
    for fn in names:
        m = _RANK_FILE.match(fn)
        if not m:
            continue
        rank = int(m.group(1))
        newest = None
        try:
            with open(os.path.join(obs_dir, fn)) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        newest = json.loads(line)
                    except ValueError:
                        continue
        except OSError:
            continue
        if newest is not None:
            out[rank] = newest
    return out


def _downtimes_ms(events):
    """[(failure detection -> next restarted gang_start) ms] from
    supervisor events, on the monotonic timestamps when present
    (schema_version >= 1), falling back to wall-clock for older logs.

    supervisor.log is append-only across supervisor RUNS (a reused
    workdir accumulates them), and each run's monotonic clock has its
    own epoch — so a detection may only pair with a gang_start from the
    SAME run. A fresh run's first gang_start carries ``restart == 0``
    and clears any detection a dead previous run left dangling; terminal
    events end a run's pairing too, and negative deltas (mixed clock
    epochs in malformed logs) are dropped rather than poisoning the
    percentiles."""
    key = "ts_mono" if any("ts_mono" in e for e in events) else "ts"
    downtimes = []
    detect = None
    for e in events:
        ev = e.get("event")
        if ev in ("crash_detected", "hang_detected", "worker_preempted"):
            detect = e.get(key)
        elif ev in ("gang_done", "giveup", "preempted"):
            detect = None
        elif ev == "gang_start":
            if e.get("restart", 0) and detect is not None \
                    and e.get(key) is not None:
                delta_ms = (e[key] - detect) * 1000.0
                if delta_ms >= 0:
                    downtimes.append(delta_ms)
            detect = None
    return downtimes


def _rank_summary(snap):
    counters = snap.get("counters", {})
    hists = snap.get("histograms", {})
    return {
        "snapshot_ts": snap.get("ts"),
        "pid": snap.get("pid"),
        "counters": {
            k: counters[k] for k in _RANK_COUNTERS if k in counters
        },
        "step_time_ms": hists.get("train_step_ms"),
        "histograms": {
            k: hists[k] for k in _RANK_HISTOGRAMS if k in hists
        },
        "compiles": snap.get("compiles"),
    }


def _gang_compiles(snaps):
    """Cross-rank roll-up of the per-rank compile summaries: totals by
    trigger plus steady-state violations — one place to see a gang
    restart's recompile storm."""
    total, steady = 0, 0
    by_trigger = {}
    for snap in snaps.values():
        c = snap.get("compiles") or {}
        total += int(c.get("compiles", 0))
        steady += int(c.get("steady_recompiles", 0))
        for trig, n in (c.get("by_trigger") or {}).items():
            by_trigger[trig] = by_trigger.get(trig, 0) + int(n)
    return {
        "compiles_total": total,
        "by_trigger": by_trigger,
        "steady_recompiles": steady,
    }


def _last_run(events):
    """The event slice belonging to the NEWEST supervisor run: the log
    appends across runs in a reused workdir, and the report must
    describe the current gang, not a sum over dead ones. A run begins
    at a ``supervisor_boot`` event; logs predating it fall back to the
    newest ``gang_start`` with ``restart == 0`` (which misses a
    pre-first-start ``gang_resize``/``giveup`` — exactly why the boot
    event exists)."""
    start = 0
    booted = any(e.get("event") == "supervisor_boot" for e in events)
    for i, e in enumerate(events):
        if booted:
            if e.get("event") == "supervisor_boot":
                start = i
        elif e.get("event") == "gang_start" and not e.get("restart", 0):
            start = i
    return events[start:]


def gang_report(workdir, obs_dir=None):
    """Merge ``workdir``'s supervisor.log + per-rank snapshots (default
    ``workdir/obs``) into one report dict. Counters, outcome, and
    downtime all describe the newest supervisor run in the log."""
    from ..distributed import supervisor as _sup

    events = _last_run(_sup.load_events(str(workdir)))
    obs_dir = obs_dir or os.path.join(str(workdir), "obs")
    snaps = read_rank_snapshots(obs_dir)
    downtimes = _downtimes_ms(events)
    terminal = None
    for e in events:  # last terminal event wins
        if e.get("event") in ("gang_done", "giveup", "preempted"):
            terminal = e["event"]
    # elastic-resize audit trail: one record per gang attempt (the
    # gang_start events carry the attempt's world size and rank->pid
    # map), so a resized run is reconstructible post-hoc
    attempts = [
        {
            "restart": e.get("restart", 0),
            "world_size": e.get("world_size"),
            "slots": e.get("slots"),
            "rank_pids": e.get("rank_pids"),
        }
        for e in events if e.get("event") == "gang_start"
    ]
    return {
        "schema_version": _registry.SCHEMA_VERSION,
        "ts": time.time(),
        "ts_mono": time.monotonic(),
        "workdir": str(workdir),
        "outcome": terminal,  # None while the gang is still running
        "restarts": sum(1 for e in events if e.get("event") == "restart"),
        "crashes": sum(
            1 for e in events if e.get("event") == "crash_detected"
        ),
        "hang_kills": sum(
            1 for e in events if e.get("event") == "hang_detected"
        ),
        "preemptions": sum(
            1 for e in events if e.get("event") == "worker_preempted"
        ),
        "sdc_quarantines": sum(
            1 for e in events if e.get("event") == "replica_quarantined"
        ),
        "resizes": sum(
            1 for e in events if e.get("event") == "gang_resize"
        ),
        "attempts": attempts,
        "world_size_final": (
            attempts[-1]["world_size"] if attempts else None
        ),
        "downtime_ms": _registry.percentiles(downtimes, points=(50, 99)),
        "compiles": _gang_compiles(snaps),
        "ranks_reporting": sorted(snaps),
        "per_rank": {str(r): _rank_summary(s) for r, s in snaps.items()},
    }


def write_gang_report(workdir, obs_dir=None, path=None):
    """Emit ``gang_report.json`` under ``workdir`` (atomic tmp+rename:
    an operator tailing the file never reads a torn report). Returns the
    path."""
    report = gang_report(workdir, obs_dir=obs_dir)
    path = path or os.path.join(str(workdir), GANG_REPORT)
    return _write_json(report, path)


def _write_json(report, path):
    # the fleet's shared atomic-commit discipline (tmp.<pid> +
    # os.replace) lives in checkpoint.modeldir; imported lazily so a
    # report-only consumer doesn't pay for it at module import
    from ..checkpoint import modeldir as _modeldir

    return _modeldir.commit_json(path, report, indent=1)


# ---------------------------------------------------------------------------
# serving-fleet merge: replica snapshots + fleet.log -> fleet_report.json
# ---------------------------------------------------------------------------

# the per-replica counters worth surfacing in the fleet roll-up (the
# request-path tallies an operator reads first; full detail stays in
# each replica's JSONL snapshots)
_REPLICA_COUNTERS = (
    "gateway_requests",
    "serving_requests",
    "serving_completed",
    "serving_batches",
    "serving_shed_overload",
    "serving_shed_deadline",
    "gateway_shed_admission",
    "gateway_shed_dispatch",
    # prefix-cache / KV-tier effectiveness (the fleet_report roll-up
    # computes hit rates and byte totals from these)
    "decode_prefix_hits",
    "decode_prefix_misses",
    "decode_prefix_cached_tokens",
    "decode_prompt_tokens",
    "kv_tier_spills",
    "kv_tier_readmits",
    "kv_tier_bytes_d2h",
    "kv_tier_bytes_h2d",
    "kv_tier_pulls",
    "kv_tier_pull_tokens",
)


def _prefix_cache_rollup(summaries):
    """Fleet-wide prefix-cache effectiveness from the per-replica
    counter summaries: hit rate over admissions, the fraction of all
    prompt tokens served from cache, and the KV-tier spill/re-admit
    byte flow. Per-replica rows keep the same shape so an operator can
    spot the one cold replica dragging the fleet rate down."""
    def one(counters):
        hits = int(counters.get("decode_prefix_hits", 0))
        misses = int(counters.get("decode_prefix_misses", 0))
        cached = int(counters.get("decode_prefix_cached_tokens", 0))
        prompt = int(counters.get("decode_prompt_tokens", 0))
        return {
            "hits": hits,
            "misses": misses,
            "hit_rate": round(hits / (hits + misses), 4)
            if hits + misses else None,
            "cached_tokens": cached,
            "prompt_tokens": prompt,
            "cached_token_fraction": round(cached / prompt, 4)
            if prompt else None,
            "spills": int(counters.get("kv_tier_spills", 0)),
            "readmits": int(counters.get("kv_tier_readmits", 0)),
            "bytes_d2h": int(counters.get("kv_tier_bytes_d2h", 0)),
            "bytes_h2d": int(counters.get("kv_tier_bytes_h2d", 0)),
        }

    per_replica = {}
    totals = {}
    for rid, s in summaries.items():
        row = one(s.get("counters", {}))
        per_replica[rid] = row
        for k, v in row.items():
            if isinstance(v, int):
                totals[k] = totals.get(k, 0) + v
    fleet = one(totals and {
        "decode_prefix_hits": totals.get("hits", 0),
        "decode_prefix_misses": totals.get("misses", 0),
        "decode_prefix_cached_tokens": totals.get("cached_tokens", 0),
        "decode_prompt_tokens": totals.get("prompt_tokens", 0),
        "kv_tier_spills": totals.get("spills", 0),
        "kv_tier_readmits": totals.get("readmits", 0),
        "kv_tier_bytes_d2h": totals.get("bytes_d2h", 0),
        "kv_tier_bytes_h2d": totals.get("bytes_h2d", 0),
    } or {})
    return {"fleet": fleet, "per_replica": per_replica}


_FLIGHT_DUMP = re.compile(r"^flight_rank_\d+\.json$")


def iter_obs_dumps(obs_root, pattern):
    """Yield ``(subdir, filename, path)`` for every dump whose filename
    fully matches ``pattern`` (a compiled regex) under ``obs_root``: the
    root itself (``subdir == ""``) plus ONE level of subdirectories —
    the fleet layout (``replica_<id>/`` dirs, and a ``controller/`` dir
    when the router keeps its obs out of the root). The single walker
    both the flight-record reader and ``fleet_trace.find_trace_dumps``
    use, so the layout knowledge cannot drift between them. Unreadable
    or concurrently-removed dirs skip — never raise; a half-dead obs
    tree is this code's NORMAL operating condition."""
    try:
        names = sorted(os.listdir(str(obs_root)))
    except OSError:
        return
    for name in names:
        p = os.path.join(str(obs_root), name)
        if pattern.match(name):
            yield "", name, p
        elif os.path.isdir(p):
            try:
                subs = sorted(os.listdir(p))
            except OSError:
                continue
            for sub in subs:
                if pattern.match(sub):
                    yield name, sub, os.path.join(p, sub)


def read_flight_records(obs_root):
    """[(source_label, record), ...] from every flight-recorder dump
    (``flight_rank_*.json``) under ``obs_root``: the root itself (the
    controller/router process, labelled ``controller``) plus one level
    of subdirectories (``replica_<id>/`` and a controller dir, labelled
    by dir name). Torn or missing dumps read as empty."""
    from . import flight as _flight

    out = []
    for subdir, _fn, path in iter_obs_dumps(obs_root, _FLIGHT_DUMP):
        for rec in _flight.load(path):
            out.append((subdir or "controller", rec))
    return out


def slowest_requests(obs_root, top=10, replicas=None):
    """The fleet's slowest requests across every process's flight
    recorder, slowest first — each row keeps its journey facts
    (trace_id, backend, retries/failovers, admission wait, windows,
    ticks) plus which process recorded it. The table an operator reads
    FIRST in a latency incident: it names the trace_id to pull from
    the merged fleet trace. ``replicas=`` scopes ``replica_<id>``
    sources to those ids (a reused workdir keeps dead runs' replica
    dirs; their dumps must not name trace_ids the current fleet never
    saw); non-replica sources (the controller) always pass. Rows are
    the stable journey schema (``flight.to_journey``) — the same codec
    the fleet simulator replays, so the report and the sim can never
    disagree about a field."""
    from . import flight as _flight

    rows = []
    for label, rec in read_flight_records(obs_root):
        m = _REPLICA_DIR.match(label)
        if replicas is not None and m and int(m.group(1)) not in replicas:
            continue
        row = _flight.to_journey(dict(rec, process=label))
        if not isinstance(row.get("ms"), (int, float)):
            continue
        rows.append(row)
    rows.sort(key=lambda r: -float(r["ms"]))
    return rows[:int(top)]


def read_replica_snapshots(obs_root):
    """{replica_id: newest snapshot dict} from ``replica_<id>/`` dirs
    under ``obs_root`` (each replica process writes the standard
    per-rank JSONL snapshots into its own directory — a replica has no
    gang rank, so its file is ``rank_0.jsonl``)."""
    out = {}
    try:
        names = os.listdir(str(obs_root))
    except OSError:
        return out
    for name in names:
        m = _REPLICA_DIR.match(name)
        if not m:
            continue
        snaps = read_rank_snapshots(os.path.join(str(obs_root), name))
        if snaps:
            # newest across whatever ranks the dir holds (normally
            # exactly rank 0)
            newest = max(snaps.values(),
                         key=lambda s: s.get("ts_mono") or 0)
            out[int(m.group(1))] = newest
    return out


def _last_fleet_run(events):
    """The slice belonging to the newest controller run — anchored on
    its ``fleet_boot`` event (fleet.log appends across runs in a reused
    workdir, like supervisor.log)."""
    start = 0
    for i, e in enumerate(events):
        if e.get("event") == "fleet_boot":
            start = i
    return events[start:]


def _replica_summary(snap):
    counters = snap.get("counters", {})
    compiles = snap.get("compiles") or {}
    hists = snap.get("histograms", {})
    return {
        "snapshot_ts": snap.get("ts"),
        "pid": snap.get("pid"),
        "counters": {
            k: counters[k] for k in _REPLICA_COUNTERS if k in counters
        },
        "latency_ms": hists.get("serving_latency_ms"),
        "steady_recompiles": int(compiles.get("steady_recompiles", 0)),
    }


def fleet_report(workdir, obs_root=None):
    """Merge ``workdir/fleet.log`` + per-replica snapshot dirs (default
    ``workdir/obs``) into one report: the ready-replica count over
    time, every scale/rollout/crash event, and per-replica request
    tallies — the serving-side twin of ``gang_report``."""
    from ..distributed import supervisor as _sup

    # the log filename is serving.fleet.FLEET_LOG; spelled literally so
    # a report-only consumer (post-mortem tooling) never pays the whole
    # serving-package import for one string constant
    all_events = _sup.load_events(str(workdir), filename="fleet.log")
    events = _last_fleet_run(all_events)
    obs_root = obs_root or os.path.join(str(workdir), "obs")
    snaps = read_replica_snapshots(obs_root)
    # scope the snapshots to THIS run, like the events: a reused
    # workdir keeps dead runs' replica_<id> dirs on disk, and replica
    # ids restart per run — without the filter a previous run's
    # replica would inflate per_replica and the fleet-wide
    # steady_recompiles sum the probes gate on. A replica ADOPTED by a
    # restarted controller belongs to this run exactly like a spawned
    # one (its ids don't restart across an adoption — the journal
    # resumes the id sequence), so adoption events join the scope set.
    spawned = {
        e.get("replica") for e in events
        if e.get("event") in ("replica_spawn", "replica_adopt")
    }
    if spawned:
        snaps = {r: s for r, s in snaps.items() if r in spawned}
    # ready-replica count over time: every lifecycle event that moves
    # the count carries ready_replicas, so the timeline is exact
    timeline = [
        {
            "ts": e.get("ts"),
            "ts_mono": e.get("ts_mono"),
            "event": e.get("event"),
            "ready_replicas": e.get("ready_replicas"),
        }
        for e in events if e.get("ready_replicas") is not None
    ]
    scale_events = [
        {
            "event": e["event"],
            "from_replicas": e.get("from_replicas"),
            "to_replicas": e.get("to_replicas"),
            "reason": e.get("reason"),
            "ts": e.get("ts"),
        }
        for e in events if e.get("event") in ("scale_up", "scale_down")
    ]
    rollouts = [
        {k: e.get(k) for k in ("event", "version", "from_version",
                               "model_dir", "ms", "error", "ts")
         if k in e}
        for e in events
        if str(e.get("event", "")).startswith("rollout_")
    ]
    boot = next((e for e in events if e.get("event") == "fleet_boot"), {})
    version = boot.get("version")
    for e in events:
        if e.get("event") == "rollout_done":
            version = e.get("version")
    ready_ms = [
        e["ready_ms"] for e in events
        if e.get("event") == "replica_ready"
        and e.get("ready_ms") is not None
    ]
    summaries = {str(r): _replica_summary(s) for r, s in snaps.items()}
    # control-plane durability audit. Counts are scoped to the newest
    # run like everything else EXCEPT controller_boots: a boot count of
    # one per run is a tautology, so restarts are counted across the
    # whole log — the one fact only the full history holds.
    boots = sum(1 for e in all_events if e.get("event") == "fleet_boot")
    recover = next(
        (e for e in events if e.get("event") == "controller_recover"),
        None,
    )
    adoption = {
        "controller_boots": boots,
        "controller_restarts": max(0, boots - 1),
        "adopted": sum(1 for e in events
                       if e.get("event") == "replica_adopt"),
        "respawned": sum(1 for e in events
                         if e.get("event") == "replica_spawn"
                         and e.get("replacement")),
        "lease_expiries": sum(
            1 for e in events
            if e.get("event") == "replica_lease_expired"
        ),
        # how long the pool served unsupervised before this run's
        # controller recovered it (None: this run adopted nothing)
        "headless_ms": recover.get("headless_ms") if recover else None,
    }
    return {
        "schema_version": _registry.SCHEMA_VERSION,
        "ts": time.time(),
        "ts_mono": time.monotonic(),
        "workdir": str(workdir),
        "version": version,
        "replicas_ready_final": (
            timeline[-1]["ready_replicas"] if timeline else 0
        ),
        "replica_timeline": timeline,
        "scale_events": scale_events,
        "scale_ups": sum(1 for e in scale_events
                         if e["event"] == "scale_up"),
        "scale_downs": sum(1 for e in scale_events
                           if e["event"] == "scale_down"),
        "rollouts": rollouts,
        "crashes": sum(1 for e in events
                       if e.get("event") == "replica_crash"),
        "hangs": sum(1 for e in events
                     if e.get("event") == "replica_hang"),
        "adoption": adoption,
        "replica_ready_ms": _registry.percentiles(ready_ms,
                                                  points=(50, 99)),
        "replicas_reporting": sorted(snaps),
        "per_replica": summaries,
        # fleet-wide prefix-cache / KV-tier effectiveness: hit rate,
        # cached-token fraction, spill/re-admit byte flow — per replica
        # and rolled up (the number the KV tier exists to move)
        "prefix_cache": _prefix_cache_rollup(summaries),
        "steady_recompiles": sum(
            s["steady_recompiles"] for s in summaries.values()
        ),
        # the flight recorders' fleet-wide slowest-requests table (the
        # journey record of each: trace_id, backend, retries, admission
        # wait, windows/ticks) — empty when no process dumped yet;
        # replica sources scoped to THIS run, like the snapshots above
        "slowest_requests": slowest_requests(
            obs_root, replicas=spawned if spawned else None
        ),
    }


def write_fleet_report(workdir, obs_root=None, path=None):
    """Emit ``fleet_report.json`` under ``workdir`` (atomic tmp+rename,
    like the gang report). Returns the path."""
    report = fleet_report(workdir, obs_root=obs_root)
    path = path or os.path.join(str(workdir), FLEET_REPORT)
    return _write_json(report, path)
