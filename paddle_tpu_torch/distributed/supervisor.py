"""Elastic gang supervisor: crash/hang detection + restart with resume
(port of ``paddle_tpu/distributed/supervisor.py``).

In the port the serving fleet uses its worker-side heartbeat protocol
(``WorkerHeartbeat``, ``worker_heartbeat``, ``read_heartbeat``,
``HEARTBEAT_ENV``) and its event log (``_Log``, ``load_events``); the
training launch that drives ``Supervisor`` comes with the training
runtime, which is not ported yet.

The Fluid-era reference kept jobs alive with ad-hoc pieces (the pserver
``HeartBeatMonitor``, ``checkpoint_notify``); the launcher itself just
spawned workers and waited. On a preemptible pool that is fatal: one
SIGKILLed or silently hung worker deadlocks every peer of the collective
and the job dies without retry. The supervisor closes the loop:

- **Liveness**: every worker writes a heartbeat file (step, timestamp,
  status, pid — atomic tmp+rename) via a runtime hook in the
  trainer; the env var ``PADDLE_TPU_HEARTBEAT_FILE`` names
  it and is injected per rank by the supervisor.
- **Detection**: a poll loop watches process exits (crash = any nonzero
  exit) and heartbeat staleness (hang = a live worker whose newest beat
  is older than ``FLAGS_dist_heartbeat_timeout_s``; before the first
  beat a separate ``startup_grace_s`` covers imports + kernel builds).
- **Teardown**: ANY failure kills the WHOLE gang — a torn collective
  cannot make progress — via the preemption path: SIGTERM (workers'
  PreemptionHandlers commit a final save when they still can), grace
  window, then SIGKILL survivors.
- **Restart**: exponential backoff with jitter
  (``FLAGS_dist_restart_backoff_s`` base, capped) under a restart budget
  (``max_restarts``); workers resume bit-exactly through
  ``CheckpointManager.restore_or_initialize`` — the supervisor
  itself is stateless about training progress. Workers that exit 143 /
  die to SIGTERM are *preempted*, not crashed: they draw from a separate
  (generous) ``max_preempt_restarts`` budget, so a preemption-churny
  pool can't eat the crash-loop budget.
- **Elastic resize** (any explicit ``min_world_size``): every restart
  re-plans the gang instead of assuming the full spec list. A
  launchability probe (``elastic.read_down_marker`` over
  ``workdir/avail/down_slot_<r>.json`` — written by the chaos
  ``lose_rank`` fault, by the supervisor itself on a spawn failure, or
  by an external scheduler) picks the available slots; the gang shrinks
  to the survivors (never below ``min_world_size``), rank ids are
  remapped contiguously, and the new topology is injected via
  ``PADDLE_TPU_WORLD_SIZE`` / ``PADDLE_TPU_RANK`` (plus remapped legacy
  ``PADDLE_TRAINER_*`` / ``JAX_*`` vars when the spec carried them).
  When a marker expires — ``down_for`` plans have observed it, or the
  file is deleted — the slot rejoins at the next restart boundary and
  the gang grows back. Resize decisions land as ``gang_resize`` events
  and the ``dist_resizes`` counter; each ``gang_start`` records the
  attempt's world size and rank->pid map so a resized run is auditable
  post-hoc. (Single-node scope: remapping cannot re-home a lost
  multi-node DCN coordinator — that needs a rendezvous service.)
- **SDC quarantine** (training guardian): workers publish a
  cross-replica state digest ring through their heartbeat files every
  ``FLAGS_guardian_digest_interval`` steps; the monitor majority-votes
  each complete round (>= 3 voters) and quarantines a diverging rank —
  open-ended down marker on its slot, ``replica_quarantined`` event,
  ``sdc_quarantines`` counter — then restarts the gang under the
  preempt budget (elastic gangs resize around the quarantined slot and
  resume from checkpoint). A worker mid checkpoint-restore beats
  ``status="rollback"`` and is judged under the startup-style
  instrumented grace, so a multi-second restore is never hang-killed.
- **Observability**: structured JSONL events in ``supervisor.log``
  (gang_start / worker_exit / crash_detected / hang_detected /
  gang_teardown / restart / gang_done / giveup / preempted; each
  carries ``schema_version``, wall-clock ``ts`` and monotonic
  ``ts_mono``) plus always-on profiler counters ``dist_restarts`` /
  ``dist_hang_kills`` and the ``dist_downtime_ms`` histogram (failure
  detection -> next gang start; the MTTR).
  The supervisor also injects ``FLAGS_obs_dir`` into every worker so
  each rank leaves JSONL telemetry snapshots, and merges them with this
  log into ``workdir/gang_report.json`` on every restart and on exit
  (``observability/aggregate.py``).
"""

from __future__ import annotations

import collections
import json
import os
import random
import signal
import subprocess
import sys
import threading
import time

from . import elastic

__all__ = [
    "HEARTBEAT_ENV",
    "RESTART_ENV",
    "WorkerHeartbeat",
    "worker_heartbeat",
    "read_heartbeat",
    "WorkerSpec",
    "Supervisor",
    "load_events",
]

HEARTBEAT_ENV = "PADDLE_TPU_HEARTBEAT_FILE"
RESTART_ENV = "PADDLE_TPU_RESTART_NUM"
SUPERVISOR_LOG = "supervisor.log"
# JSONL event schema: 1 added schema_version itself plus ts_mono (the
# monotonic-clock twin of the wall-clock ts — downtime/MTTR math must
# survive an NTP step; ts stays for humans and cross-host correlation)
LOG_SCHEMA_VERSION = 1


# ---------------------------------------------------------------------------
# worker-side heartbeat (the fluid/trainer.py runtime hook lands here)
# ---------------------------------------------------------------------------
def _flag(name, default):
    try:
        from ..fluid import flags as _flags

        return _flags.get_flag(name, default)
    except Exception:
        return default


class WorkerHeartbeat(object):
    """Throttled atomic progress file: ``{pid, step, status, time}``.

    ``beat()`` is called once per training step; writes are throttled to
    ``interval_s`` (FLAGS_dist_heartbeat_interval_s) so a fast step loop
    never turns into fs churn, and status transitions always force a
    write. Staleness detection on the supervisor side uses the file's
    mtime, so the write itself IS the beat."""

    def __init__(self, path, interval_s=None):
        self.path = str(path)
        self.interval_s = float(
            _flag("dist_heartbeat_interval_s", 0.5)
            if interval_s is None else interval_s
        )
        self._last_write = 0.0
        self._last_status = None
        # cross-replica SDC digests ride the heartbeat file as a small
        # ring of the newest (step, digest) pairs: every beat carries
        # the ring, so the supervisor's poll loop can miss individual
        # writes and still reconstruct every publish round
        self._digests = collections.deque(maxlen=8)
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)

    def publish_digest(self, step, digest):
        """Record one (step, digest) pair in the ring and force a beat
        — the worker half of the supervisor's SDC majority vote."""
        self._digests.append((int(step), str(digest)))
        return self.beat(step, force=True)

    def beat(self, step, status="step", force=False):
        now = time.monotonic()
        if (not force and status == self._last_status
                and now - self._last_write < self.interval_s):
            return False
        record = {
            "pid": os.getpid(),
            "step": int(step),
            "status": str(status),
            "time": time.time(),
        }
        if self._digests:
            record["digests"] = [[s, d] for s, d in self._digests]
        payload = json.dumps(record)
        tmp = "%s.tmp.%d" % (self.path, os.getpid())
        try:
            with open(tmp, "w") as f:
                f.write(payload)
            os.replace(tmp, self.path)
        except OSError:
            return False  # liveness reporting must never kill the worker
        self._last_write = now
        self._last_status = status
        return True


def worker_heartbeat(interval_s=None):
    """The heartbeat this process should write to, or None when not
    running under a supervisor (PADDLE_TPU_HEARTBEAT_FILE unset)."""
    path = os.environ.get(HEARTBEAT_ENV)
    if not path:
        return None
    return WorkerHeartbeat(path, interval_s=interval_s)


def read_heartbeat(path):
    """Parse one heartbeat file -> dict with an added ``mtime``, or None
    when absent/torn (a torn read loses one poll tick, nothing else)."""
    try:
        mtime = os.stat(path).st_mtime
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return None
    data["mtime"] = mtime
    return data


# ---------------------------------------------------------------------------
# supervisor side
# ---------------------------------------------------------------------------
class WorkerSpec(object):
    """One gang member: argv, env overlay, and an optional log path the
    supervisor appends stdout+stderr to (one file across restarts, with
    an attempt banner between runs)."""

    def __init__(self, cmd, env=None, log_path=None, rank=None):
        self.cmd = list(cmd)
        self.env = dict(env or {})
        self.log_path = log_path
        self.rank = rank


class _Log(object):
    """Append-only JSONL event log (workdir/supervisor.log)."""

    def __init__(self, path, echo=False):
        self.path = path
        self.echo = echo
        self._lock = threading.Lock()

    def event(self, event, **fields):
        rec = dict(fields)
        rec["event"] = event
        rec["schema_version"] = LOG_SCHEMA_VERSION
        rec["ts"] = time.time()  # wall clock, for humans
        rec["ts_mono"] = time.monotonic()  # for interval math
        line = json.dumps(rec, sort_keys=True)
        with self._lock:
            with open(self.path, "a") as f:
                f.write(line + "\n")
        if self.echo:
            print("[supervisor] %s" % line, flush=True)
        return rec


def load_events(workdir, filename=SUPERVISOR_LOG):
    """Parse workdir/supervisor.log back into a list of event dicts
    (the probe's MTTR source). ``filename`` selects another log in the
    same JSONL dialect (the serving fleet's ``fleet.log`` reuses this
    parser and the ``_Log`` writer)."""
    path = os.path.join(workdir, filename)
    events = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    events.append(json.loads(line))
                except ValueError:
                    continue
    except OSError:
        pass
    return events


class GangOutcome(object):
    DONE = "done"
    CRASH = "crash"
    HANG = "hang"
    PREEMPTED = "preempted"  # the SUPERVISOR caught SIGTERM: exit 143
    # one WORKER exited 143 / died to SIGTERM (slice preemption): restart
    # under the separate preempt budget, re-planning the world size
    WORKER_PREEMPT = "worker_preempt"
    # the cross-replica digest vote quarantined a diverging rank: its
    # slot is marked down (suspect hardware), the gang restarts under
    # the preempt budget — SDC is the pool's lifecycle, not a crash loop
    SDC = "sdc_quarantine"


class _SpawnFailed(Exception):
    """A worker could not be spawned (its slot is unlaunchable)."""

    def __init__(self, slot, error):
        super().__init__("slot %s: %s" % (slot, error))
        self.slot = slot
        self.error = error


class Supervisor(object):
    """Supervising agent over one gang of worker processes.

    ``run()`` drives start -> monitor -> (teardown -> backoff ->
    restart)* until the gang completes, the restart budget is exhausted,
    or the supervisor itself is preempted. Exit codes follow the
    launcher's conventions: 0 done, 1 budget exhausted (a structured
    ``giveup`` report is logged and returned via ``failure_report``),
    143 preempted."""

    def __init__(self, specs, workdir, max_restarts=0,
                 heartbeat_timeout_s=None, startup_grace_s=None,
                 backoff_base_s=None, backoff_max_s=None,
                 sigterm_grace_s=5.0, poll_s=0.1, seed=None,
                 echo_events=False, min_world_size=None,
                 max_preempt_restarts=None):
        self.specs = list(specs)
        self.workdir = str(workdir)
        self.max_restarts = int(max_restarts)
        # preemptions (worker exit 143 / SIGTERM death, spawn failure on
        # a downed slot) draw from their own, deliberately generous,
        # budget: on a preemptible pool they are the NORMAL lifecycle,
        # and must not eat the crash-loop budget
        self.max_preempt_restarts = int(
            _flag("dist_max_preempt_restarts", 100)
            if max_preempt_restarts is None else max_preempt_restarts
        )
        # elastic floor: a restart may shrink the gang to the launchable
        # survivors as long as at least this many remain. Unset/0 means
        # "full size only" — the fixed-gang behavior (availability
        # markers are then ignored entirely).
        mws = int(
            _flag("elastic_min_world_size", 0)
            if min_world_size is None else min_world_size
        )
        self.min_world_size = (
            min(mws, len(self.specs)) if mws > 0 else len(self.specs)
        )
        # any explicit floor arms the availability probe — even a floor
        # equal to the world size (then a downed slot means giveup, not
        # a blind full-size launch that crash-loops on the dead host)
        self._elastic = mws > 0
        self.heartbeat_timeout_s = float(
            _flag("dist_heartbeat_timeout_s", 60.0)
            if heartbeat_timeout_s is None else heartbeat_timeout_s
        )
        # the watchdog threshold must clear the worker-side beat
        # throttle (the same flag env reaches both sides): a throttle at
        # or above the timeout would hang-kill every HEALTHY worker
        # between two legitimate beats
        beat_interval = float(_flag("dist_heartbeat_interval_s", 0.5))
        self.heartbeat_timeout_s = max(
            self.heartbeat_timeout_s, 2.0 * beat_interval
        )
        # Pre-first-STEP staleness bounds. A worker that never beats at
        # all (not routed through the fluid.trainer hook) is
        # unobservable and must not be killed for its silence unless an
        # explicit grace was configured — crash detection still covers
        # it. A worker whose beat says status "start" HAS proven it is
        # instrumented, so a hang in re-init / restore / the first
        # kernel build is detectable: it gets the configured grace, or a
        # generous finite default (big models compile for minutes, but
        # not forever).
        self.startup_grace_s = (
            None if startup_grace_s is None else float(startup_grace_s)
        )
        self._instrumented_grace_s = (
            self.startup_grace_s if self.startup_grace_s is not None
            else float(_flag("dist_startup_grace_s", 600.0))
        )
        self.backoff_base_s = float(
            _flag("dist_restart_backoff_s", 1.0)
            if backoff_base_s is None else backoff_base_s
        )
        self.backoff_max_s = float(
            _flag("dist_restart_backoff_max_s", 30.0)
            if backoff_max_s is None else backoff_max_s
        )
        self.sigterm_grace_s = float(sigterm_grace_s)
        self.poll_s = float(poll_s)
        self.restarts_used = 0
        self.preempt_restarts_used = 0
        self.resizes = 0
        self.failure_report = None
        os.makedirs(self.workdir, exist_ok=True)
        self._hb_dir = os.path.join(self.workdir, "heartbeats")
        os.makedirs(self._hb_dir, exist_ok=True)
        # availability markers (elastic.read_down_marker) live here; one
        # file per SLOT (the spec's stable global rank) — written by the
        # chaos lose_rank fault, by _start_gang on a spawn failure, or
        # by an external scheduler marking a host down
        self._avail_dir = os.path.join(self.workdir, "avail")
        os.makedirs(self._avail_dir, exist_ok=True)
        # the previous attempt's plan (resize detection by MEMBERSHIP,
        # not just size: one slot returning while another goes down is a
        # resize even at constant world size); a fresh supervisor
        # measures its first plan against the full spec list, so
        # starting degraded IS a resize event
        self._plan_prev = list(range(len(self.specs)))
        # per-rank telemetry snapshots land here (FLAGS_obs_dir injected
        # into every worker env below); aggregate.py merges them + this
        # log into workdir/gang_report.json. _obs_dir is the injected
        # DEFAULT; the merge reads the EFFECTIVE dir (_spawn records it,
        # because an operator's explicit FLAGS_obs_dir wins the
        # setdefault and the snapshots land there instead)
        self._obs_dir = os.path.join(self.workdir, "obs")
        self._obs_dir_effective = self._obs_dir
        self.log = _Log(
            os.path.join(self.workdir, SUPERVISOR_LOG), echo=echo_events
        )
        # default (seed=None) draws from OS entropy: many hosts' gangs
        # crashed by one shared outage must NOT respawn in lockstep —
        # decorrelation is the whole point of the jitter. A fixed seed
        # is for tests wanting reproducible backoff.
        self._rng = random.Random(seed)
        self._procs = []  # list[(spec, Popen)]
        self._procs_lock = threading.Lock()
        self._log_files = []
        self._preempted = threading.Event()

    # -- public ------------------------------------------------------------

    def alive_pids(self):
        """{rank: pid} of currently-running workers (probe killer API)."""
        with self._procs_lock:
            return {
                (s.rank if s.rank is not None else i): p.pid
                for i, (s, p) in enumerate(self._procs)
                if p.poll() is None
            }

    def run(self):
        from ..fluid import profiler as _profiler

        prev = self._install_sigterm()
        # run boundary for log consumers (aggregate._last_run): in a
        # reused workdir the report must scope to THIS run, and the
        # first in-run event is not always a gang_start — a supervisor
        # that starts degraded emits gang_resize first, one that starts
        # below the floor emits only giveup
        self.log.event(
            "supervisor_boot", world_size=len(self.specs),
            min_world_size=self.min_world_size,
            max_restarts=self.max_restarts,
            max_preempt_restarts=self.max_preempt_restarts,
        )
        try:
            attempt = 0
            t_detect = None
            while True:
                t_plan = time.monotonic()
                plan = self._plan_gang()
                if len(plan) < self.min_world_size:
                    # fewer launchable slots than the floor: a resize
                    # cannot save this gang — structured giveup, the
                    # scheduler resubmits when capacity returns
                    self.failure_report = {
                        "reason": "insufficient_ranks",
                        "available": len(plan),
                        "min_world_size": self.min_world_size,
                        "world_size": len(self.specs),
                        "workdir": self.workdir,
                    }
                    self.log.event("giveup", **self.failure_report)
                    return 1
                if plan != self._plan_prev:
                    self.resizes += 1
                    _profiler.bump_counter("dist_resizes")
                    down = sorted(
                        set(self._slot(i) for i in range(len(self.specs)))
                        - set(self._slot(i) for i in plan)
                    )
                    self.log.event(
                        "gang_resize", restart=attempt,
                        from_world=len(self._plan_prev),
                        to_world=len(plan),
                        down_slots=down,
                        plan_ms=round(
                            (time.monotonic() - t_plan) * 1000.0, 3
                        ),
                    )
                self._plan_prev = plan
                try:
                    self._start_gang(attempt, plan)
                except _SpawnFailed as e:
                    # the slot is unlaunchable right now: mark it down
                    # for one planning round and treat the attempt as a
                    # preemption (bounded by the preempt budget). With
                    # elasticity off there is no replanning that could
                    # ever succeed differently — keep the fixed gang's fail-fast.
                    if not self._elastic:
                        raise e.error
                    elastic.write_down_marker(
                        self._down_path(e.slot), down_for=1, slot=e.slot,
                        from_attempt=attempt, reason="spawn_failed",
                    )
                    self.log.event(
                        "spawn_failed", restart=attempt, slot=e.slot,
                        error=str(e.error),
                    )
                    outcome = GangOutcome.WORKER_PREEMPT
                    detail = {"slot": e.slot, "spawn_error": str(e.error)}
                else:
                    if t_detect is not None:
                        # MTTR as documented: failure detection -> the
                        # replacement gang is SPAWNED (spawn cost
                        # included)
                        _profiler.bump_histogram(
                            "dist_downtime_ms",
                            (time.monotonic() - t_detect) * 1000.0,
                        )
                    outcome, detail = self._monitor()
                t_detect = time.monotonic()
                if outcome == GangOutcome.DONE:
                    self.log.event("gang_done", restart=attempt)
                    return 0
                if outcome == GangOutcome.PREEMPTED:
                    self._teardown("preempted", self.sigterm_grace_s)
                    self.log.event("preempted", restart=attempt)
                    return 128 + signal.SIGTERM
                # crash / hang / worker preemption: the gang is torn —
                # kill it whole
                if outcome == GangOutcome.HANG:
                    _profiler.bump_counter("dist_hang_kills")
                self._teardown(outcome, self.sigterm_grace_s)
                # SDC quarantines draw from the preempt budget: like a
                # slice preemption they are the pool's lifecycle (the
                # quarantined slot is marked down and planned around),
                # not a crash loop worth damping
                preempt = outcome in (
                    GangOutcome.WORKER_PREEMPT, GangOutcome.SDC
                )
                used = (
                    self.preempt_restarts_used if preempt
                    else self.restarts_used
                )
                budget = (
                    self.max_preempt_restarts if preempt
                    else self.max_restarts
                )
                if used >= budget:
                    self.failure_report = {
                        "restarts_used": self.restarts_used,
                        "max_restarts": self.max_restarts,
                        "preempt_restarts_used": self.preempt_restarts_used,
                        "max_preempt_restarts": self.max_preempt_restarts,
                        "last_failure": dict(detail, kind=outcome),
                        "workdir": self.workdir,
                    }
                    self.log.event("giveup", **self.failure_report)
                    return 1
                if preempt:
                    self.preempt_restarts_used += 1
                else:
                    self.restarts_used += 1
                attempt += 1
                _profiler.bump_counter("dist_restarts")
                # backoff escalates with the CRASH count only: crashes
                # look like a loop worth damping, while preemptions are
                # the pool's normal lifecycle (that's why they have
                # their own generous budget) — penalizing the 7th
                # preemption with backoff_max would inflate MTTR
                # exactly where elasticity is supposed to help
                exponent = 1 if preempt else self.restarts_used
                delay = min(
                    self.backoff_base_s * (2.0 ** (exponent - 1)),
                    self.backoff_max_s,
                ) * (0.5 + 0.5 * self._rng.random())  # decorrelating jitter
                self.log.event(
                    "restart", restart=attempt, backoff_s=delay,
                    restarts_used=self.restarts_used,
                    preempt_restarts_used=self.preempt_restarts_used,
                    cause=dict(detail, kind=outcome),
                )
                # merged telemetry checkpoint at every restart: an
                # operator watching a flapping gang reads the report
                # without waiting for the run to end
                self._write_gang_report()
                # interruptible backoff: a SIGTERM preemption landing
                # here must not wait out the sleep and then spawn (and
                # immediately kill) a whole fresh gang
                if self._preempted.wait(delay):
                    self.log.event("preempted", restart=attempt)
                    return 128 + signal.SIGTERM
        finally:
            # exception/Ctrl-C unwind: the full SIGTERM grace applies —
            # workers' preemption handlers may be mid final-save, and
            # killing that save loses up to ckpt_save_interval_steps of
            # progress. Normal returns reach here with the gang already
            # dead, making this a no-op.
            self._teardown(
                "supervisor_exit", self.sigterm_grace_s, quiet=True
            )
            # final merged gang report — after teardown, so every
            # worker's exit-time snapshot file is already on disk
            self._write_gang_report()
            self._restore_sigterm(prev)
            for f in self._log_files:
                try:
                    f.close()
                except OSError:
                    pass
            self._log_files = []

    # -- internals ---------------------------------------------------------

    def _write_gang_report(self):
        """Best-effort workdir/gang_report.json (observability
        aggregate): telemetry merge failures must never take down the
        supervision loop itself."""
        try:
            from ..observability import aggregate as _aggregate

            _aggregate.write_gang_report(
                self.workdir, obs_dir=self._obs_dir_effective
            )
        except Exception:
            pass

    def _install_sigterm(self):
        if threading.current_thread() is not threading.main_thread():
            return None
        try:
            return signal.signal(
                signal.SIGTERM, lambda *_: self._preempted.set()
            )
        except ValueError:
            return None

    def _restore_sigterm(self, prev):
        if prev is None:
            return
        try:
            signal.signal(signal.SIGTERM, prev)
        except (ValueError, TypeError):
            pass

    def _hb_path(self, rank):
        return os.path.join(self._hb_dir, "heartbeat_%d.json" % rank)

    def _slot(self, i):
        """A spec's stable identity: its global rank (or list index)."""
        spec = self.specs[i]
        return spec.rank if spec.rank is not None else i

    def _down_path(self, slot):
        return os.path.join(self._avail_dir, "down_slot_%d.json" % slot)

    def _plan_gang(self):
        """Launchability probe -> spec indices for the next attempt.

        A slot with a live down marker is excluded; attempt-counted
        markers (``down_for >= 0``) expire after that many planning
        rounds have observed them — counted in the marker itself, so
        expiry is deterministic across supervisor restarts — and
        open-ended markers (``down_for < 0``) hold until the file is
        deleted. With elasticity off the probe is skipped entirely: the
        plan is always the full spec list (the fixed gang)."""
        if not self._elastic:
            return list(range(len(self.specs)))
        plan = []
        for i in range(len(self.specs)):
            slot = self._slot(i)
            path = self._down_path(slot)
            marker = elastic.read_down_marker(path)
            if marker is None:
                plan.append(i)
                continue
            down_for = int(marker.get("down_for", -1))
            seen = int(marker.get("attempts_down", 0))
            if 0 <= down_for <= seen:
                # the spare returned: clear the marker so the slot
                # rejoins this plan (and stays launchable)
                try:
                    os.remove(path)
                except OSError:
                    pass
                plan.append(i)
                continue
            if down_for >= 0:
                elastic.write_down_marker(
                    path, down_for=down_for, slot=slot,
                    from_attempt=marker.get("from_attempt"),
                    attempts_down=seen + 1,
                    reason=marker.get("reason"),
                )
        return plan

    def _start_gang(self, attempt, plan=None):
        """Spawn the gang for this attempt: one worker per planned spec,
        ranks remapped contiguously (gang position == rank), topology
        injected via the elastic env contract. ``plan`` is the list of
        spec indices (default: all)."""
        if plan is None:
            plan = list(range(len(self.specs)))
        world = len(plan)
        resized = plan != list(range(len(self.specs)))
        # previous attempt's log handles are dead with their processes
        for f in self._log_files:
            try:
                f.close()
            except OSError:
                pass
        self._log_files = []
        # stale beats from the previous attempt must not mask a worker
        # that hangs before its first beat
        for i in range(len(self.specs)):
            try:
                os.remove(self._hb_path(i))
            except OSError:
                pass
        # register the (still empty) gang list BEFORE spawning and
        # append per worker: if a mid-loop Popen/open fails, the
        # exception unwinds into run()'s finally, whose teardown must
        # see — and reap — the workers already spawned, not the previous
        # attempt's dead list
        procs = []
        with self._procs_lock:
            self._procs = procs
        # staleness bookkeeping: {local idx: (last seen mtime, monotonic
        # time that mtime was first observed)} — ages are measured on
        # the supervisor's monotonic clock between observed CHANGES, so
        # an NTP step of the wall clock can neither forge a hang nor
        # mask one
        self._hb_seen = {}
        # SDC digest rounds for THIS attempt: {digest_step: {local idx:
        # digest}} accumulated from heartbeat digest rings; a round is
        # judged once every current gang member has voted
        self._digest_votes = {}
        for j, idx in enumerate(plan):
            spec = self.specs[idx]
            slot = self._slot(idx)
            env = dict(os.environ)
            env.update(spec.env)
            env[HEARTBEAT_ENV] = self._hb_path(j)
            env[RESTART_ENV] = str(attempt)
            # the elastic topology contract: new rank = gang position,
            # slot = the spec's stable identity (chaos faults and down
            # markers address slots, not remapped ranks)
            env[elastic.WORLD_ENV] = str(world)
            env[elastic.RANK_ENV] = str(j)
            env[elastic.BASE_WORLD_ENV] = str(len(self.specs))
            env[elastic.SLOT_ENV] = str(slot)
            env[elastic.DOWN_FILE_ENV] = self._down_path(slot)
            if resized:
                # remap the legacy contract vars the launcher baked into
                # the spec — a shrunk gang must not see the old topology
                for key, val in (
                    ("PADDLE_TRAINER_ID", str(j)),
                    ("PADDLE_TRAINERS_NUM", str(world)),
                    ("JAX_PROCESS_ID", str(j)),
                    ("JAX_NUM_PROCESSES", str(world)),
                ):
                    if key in spec.env:
                        env[key] = val
                if "PADDLE_TRAINER_ENDPOINTS" in spec.env:
                    eps = [
                        self.specs[k].env.get("PADDLE_CURRENT_ENDPOINT")
                        for k in plan
                    ]
                    if all(eps):
                        env["PADDLE_TRAINER_ENDPOINTS"] = ",".join(eps)
            # flags are env-bridged, so this arms per-rank snapshot files
            # in every worker; an operator's explicit FLAGS_obs_dir
            # (spec.env or the supervisor's own environment) wins
            env.setdefault("FLAGS_obs_dir", self._obs_dir)
            if j == 0:
                # merge wherever the snapshots actually land
                self._obs_dir_effective = env["FLAGS_obs_dir"]
            stdout = stderr = None
            if spec.log_path:
                d = os.path.dirname(spec.log_path)
                if d:
                    os.makedirs(d, exist_ok=True)
                fn = open(spec.log_path, "a")
                fn.write("--- supervisor attempt %d ---\n" % attempt)
                fn.flush()
                self._log_files.append(fn)
                stdout = stderr = fn
            try:
                p = subprocess.Popen(
                    spec.cmd, env=env, stdout=stdout, stderr=stderr
                )
            except OSError as e:
                # this slot cannot spawn a process at all — the elastic
                # caller marks it down and re-plans around it
                raise _SpawnFailed(slot, e)
            with self._procs_lock:
                procs.append((spec, p))
        self._gang_t0 = time.monotonic()
        self.log.event(
            "gang_start", restart=attempt,
            pids=[p.pid for _s, p in procs],
            world_size=world,
            slots=[self._slot(idx) for idx in plan],
            rank_pids={str(j): p.pid for j, (_s, p) in enumerate(procs)},
        )

    def _monitor(self):
        """Poll until the gang completes or a failure is detected.
        Returns (outcome, detail). Events carry the spec's GLOBAL rank
        (multi-node: node 1's workers are ranks 4..7, not 0..3) so
        operators and MTTR tooling inspect the right worker."""
        finished = set()
        while True:
            if self._preempted.is_set():
                return GangOutcome.PREEMPTED, {}
            now = time.monotonic()
            for i, (spec, p) in enumerate(self._procs):
                rank = spec.rank if spec.rank is not None else i
                rc = p.poll()
                if rc is None or i in finished:
                    continue
                if rc == 0:
                    finished.add(i)
                    self.log.event("worker_exit", rank=rank, returncode=0)
                    continue
                if rc in (128 + signal.SIGTERM, -signal.SIGTERM):
                    # exit 143 / killed by SIGTERM: the worker was
                    # preempted, not buggy — restart under the separate
                    # preempt budget (and, when elastic, re-plan the
                    # world around any slot that marked itself down)
                    self.log.event(
                        "worker_preempted", rank=rank, returncode=rc,
                        pid=p.pid,
                    )
                    return GangOutcome.WORKER_PREEMPT, {
                        "rank": rank, "returncode": rc,
                    }
                self.log.event(
                    "crash_detected", rank=rank, returncode=rc, pid=p.pid,
                )
                return GangOutcome.CRASH, {"rank": rank, "returncode": rc}
            if len(finished) == len(self._procs):
                return GangOutcome.DONE, {}
            # hang watchdog over the still-running workers
            for i, (spec, p) in enumerate(self._procs):
                if i in finished or p.poll() is not None:
                    continue
                rank = spec.rank if spec.rank is not None else i
                hb = read_heartbeat(self._hb_path(i))
                status = (hb or {}).get("status")
                if hb is not None and hb.get("digests"):
                    self._collect_digests(i, hb)
                    verdict = self._sdc_vote()
                    if verdict is not None:
                        return verdict
                if hb is None:
                    # never beat: unobservable unless an explicit grace
                    # was configured
                    if self.startup_grace_s is None:
                        continue
                    age = now - self._gang_t0
                    limit = self.startup_grace_s
                elif status == "start":
                    # instrumented but pre-first-step (restore + first
                    # kernel build): laxer, but FINITE, bound
                    age = now - self._gang_t0
                    limit = self._instrumented_grace_s
                elif status == "rollback":
                    # mid-run checkpoint restore (the training
                    # guardian's rollback): a multi-second restore
                    # inside a live worker must not be hang-killed by
                    # the per-step staleness bound — it gets the
                    # startup-style instrumented grace, measured from
                    # when this beat was first observed (the rollback
                    # may start late in a long run)
                    seen = self._hb_seen.get(i)
                    if seen is None or seen[0] != hb["mtime"]:
                        self._hb_seen[i] = (hb["mtime"], now)
                        continue
                    age = now - seen[1]
                    limit = self._instrumented_grace_s
                elif status == "done":
                    # Training progress is complete; what follows (final
                    # save teardown, then whatever post-train work the
                    # user script runs — eval, export) is unbeatable and
                    # of unknowable duration, so NO staleness bound
                    # applies: killing a healthy 20-minute export to
                    # guard against the rarer wedged-final-save would
                    # turn succeeding jobs into restart loops. The
                    # accepted tradeoff: a truly wedged post-'done'
                    # worker stalls the gang until the operator (or the
                    # fleet scheduler's own job timeout) intervenes —
                    # process exit is the remaining signal.
                    continue
                else:
                    seen = self._hb_seen.get(i)
                    if seen is None or seen[0] != hb["mtime"]:
                        self._hb_seen[i] = (hb["mtime"], now)
                        continue  # fresh beat observed this poll
                    age = now - seen[1]
                    limit = self.heartbeat_timeout_s
                if age > limit:
                    self.log.event(
                        "hang_detected", rank=rank, pid=p.pid,
                        stale_s=round(age, 3),
                        last_step=(hb or {}).get("step"),
                    )
                    return GangOutcome.HANG, {
                        "rank": rank, "stale_s": round(age, 3),
                    }
            time.sleep(self.poll_s)

    def _collect_digests(self, i, hb):
        """Accumulate one worker's heartbeat digest ring into the
        per-attempt vote table (the ring carries the newest 8 publishes,
        so a poll that missed individual beats still sees every
        round)."""
        for pair in hb.get("digests") or []:
            try:
                ds, dg = int(pair[0]), str(pair[1])
            except (TypeError, ValueError, IndexError):
                continue
            self._digest_votes.setdefault(ds, {})[i] = dg

    def _sdc_vote(self):
        """Majority-vote every COMPLETE digest round (all current gang
        members reported for the same step). A diverging minority rank
        is quarantined: its slot gets a down marker (open-ended — SDC
        means suspect hardware, an operator or scheduler clears it),
        a ``replica_quarantined`` event lands in the log, and the gang
        restarts under the preempt budget. Returns (outcome, detail) or
        None. Needs >= 3 voters: a 2-way disagreement cannot attribute
        blame (logged as ``sdc_vote_inconclusive``)."""
        from ..fluid import profiler as _profiler

        world = len(self._procs)
        for ds in sorted(self._digest_votes):
            votes = self._digest_votes.get(ds)
            if votes is None or len(votes) < world:
                continue
            # judged exactly once; older incomplete rounds are
            # superseded (a rank that never completes round K but
            # completes K+1 is healthy — the ring just rolled)
            del self._digest_votes[ds]
            for old in [s for s in self._digest_votes if s < ds]:
                del self._digest_votes[old]
            counts = {}
            for dg in votes.values():
                counts[dg] = counts.get(dg, 0) + 1
            if len(counts) == 1:
                continue  # unanimous round
            majority, n = max(counts.items(), key=lambda kv: kv[1])
            if world < 3 or n <= world // 2:
                self.log.event(
                    "sdc_vote_inconclusive", step=ds, world=world,
                    votes={str(k): v for k, v in votes.items()},
                )
                continue
            quarantined = []
            for i, dg in sorted(votes.items()):
                if dg == majority:
                    continue
                spec = self._procs[i][0]
                rank = spec.rank if spec.rank is not None else i
                # the down marker must land on the spec's STABLE slot
                # (the identity _plan_gang probes) — after a resize the
                # attempt-local index and the spec-list index differ,
                # and marking the wrong slot would bench a healthy
                # worker while re-planning the corrupt one back in
                try:
                    slot = (
                        spec.rank if spec.rank is not None
                        else self.specs.index(spec)
                    )
                except ValueError:
                    slot = rank
                if self._elastic:
                    elastic.write_down_marker(
                        self._down_path(slot), down_for=-1, slot=slot,
                        reason="sdc_quarantine",
                    )
                _profiler.bump_counter("sdc_quarantines")
                self.log.event(
                    "replica_quarantined", rank=rank, slot=slot,
                    step=ds, digest=dg, majority=majority,
                    pid=self._procs[i][1].pid,
                    marker_written=self._elastic,
                )
                quarantined.append(rank)
            return GangOutcome.SDC, {"ranks": quarantined, "step": ds}
        return None

    def _teardown(self, reason, grace_s, quiet=False):
        """SIGTERM the gang (the preemption path: workers' handlers
        get a chance to commit a final save), then SIGKILL survivors
        after ``grace_s``."""
        with self._procs_lock:
            procs = list(self._procs)
        alive = [p for _s, p in procs if p.poll() is None]
        if not alive:
            return
        for p in alive:
            try:
                p.send_signal(signal.SIGTERM)
            except OSError:
                pass
        deadline = time.monotonic() + grace_s
        killed = []
        while any(p.poll() is None for p in alive):
            if time.monotonic() > deadline:
                for p in alive:
                    if p.poll() is None:
                        try:
                            p.kill()
                        except OSError:
                            pass
                        killed.append(p.pid)
                break
            time.sleep(0.05)
        for p in alive:
            try:
                p.wait(timeout=10)
            except Exception:
                pass
        if not quiet:
            self.log.event(
                "gang_teardown", reason=reason, sigkilled=killed,
            )
