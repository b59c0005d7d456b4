"""Serving fleet control plane: replica pool + autoscaler + rollout (port
of ``paddle_tpu/serving/fleet.py``).

The server and gateway serve one process well; "millions of users" is a
*pool* of replicas behind one address. This module is the control loop
that composes the existing primitives — the supervisor's
heartbeat/backoff/spawn machinery, the gateway's ``/readyz``-flip
graceful drain, the metrics registry's Prometheus surface, and the
strict build gate — into a fleet:

- **FleetController** spawns and supervises N replica processes (each
  ``python -m paddle_tpu_torch.serving.replica``: an InferenceServer +
  Gateway with its own metrics exporter port), watching process exits,
  heartbeat staleness (``distributed.supervisor`` heartbeat files) and
  a per-replica ready timeout. Crashed replicas are replaced with
  exponential backoff under ``FLAGS_fleet_max_replica_restarts``;
  drains (scale-down, rollout) SIGTERM the replica so its gateway
  completes every in-flight request before the process exits.
- A **Router** (serving/router.py) fronts the pool: the controller
  adds a replica the moment its ``/readyz`` first answers 200 and
  removes it before draining, so clients never see a dead pick beyond
  one transparent retry.
- The **autoscaler** scrapes every ready replica's ``/metrics``
  (admission queue depth ``serving_queue_depth`` +
  ``decode_queue_depth``, shed counters, ``serving_latency_ms`` p95)
  each ``FLAGS_fleet_scale_interval_s`` and feeds
  ``AutoscalerPolicy``: sustained pressure adds a replica, sustained
  idle (longer streak — hysteresis) drains one, clamped to
  ``[FLAGS_fleet_min_replicas, FLAGS_fleet_max_replicas]``.
- ``deploy(model_dir)`` is a **zero-downtime versioned rollout**:
  spawn the new version's replicas beside the old ones, wait until
  every one is warm (the replica warms its bucket ladder before its
  gateway starts, under the armed strict compile gate), atomically
  flip the router's active version, then gracefully drain the old
  version. ``model_dir`` may be a ``checkpoint.modeldir`` repository
  (the ``LATEST`` pointer resolves) or a plain export dir.

Structured JSONL events land in ``workdir/fleet.log`` (the supervisor
log dialect: ``schema_version``/``ts``/``ts_mono``), and
``observability.aggregate.write_fleet_report`` merges them with the
per-replica snapshot files into ``workdir/fleet_report.json``.

**Durability.** The controller itself is a process that can
die. Its intent — replica target, serving version, roles, rollout
phase, crash-budget ledger — is journaled to ``workdir/
fleet_state.json`` on every mutation (atomic two-phase commit via
``checkpoint.modeldir.commit_json``, the one write discipline for
every fleet shared file), with a heartbeat-refreshed controller lease.
A (re)started controller reads the journal, scans the replicas'
endpoint files (each lease-stamped by the replica's own serve loop),
probes ``/readyz`` as ground truth, and ADOPTS live warm replicas in
place instead of respawning them; journaled replicas that died while
the fleet was headless are replaced under the restored crash budget;
a rollout interrupted pre-flip aborts cleanly (old version keeps
serving) and one interrupted post-flip resumes the old pool's drain.
Supervision is a declarative reconcile of observed state against the
journaled intent, so a controller restart, an adoption, and an
ordinary crash replacement are one code path. The router's breaker /
affinity state is deliberately NOT journaled: breakers are a load
signal the rebuilt router re-learns in a few probe rounds, not intent
— journaling them would pin stale verdicts on a pool that kept moving
while the controller was down. A second controller started on a
workdir whose journal holds a live, fresh lease fails fast with
``FleetLockError`` (the split-brain guard).
"""

from __future__ import annotations

import json
import os
import random
import signal
import subprocess
import sys
import threading
import time
import urllib.request

from ..distributed import supervisor as _supervisor
from ..fluid import flags as _flags
from ..fluid import profiler as _profiler
from ..observability import registry as _obs_registry
from ..testing import chaos as _chaos

__all__ = [
    "FLEET_LOG",
    "FLEET_STATE",
    "AutoscalerPolicy",
    "SLOPolicy",
    "make_policy",
    "FleetController",
    "FleetLockError",
    "load_events",
    "read_fleet_state",
]

FLEET_LOG = "fleet.log"
FLEET_STATE = "fleet_state.json"

# workdirs with a started FleetController in THIS process — the
# in-process arm of the split-brain guard (the journal lease can't
# distinguish two controllers sharing one pid)
_LIVE_CONTROLLERS = set()


def _flag(name, override):
    return override if override is not None else _flags.get_flag(name)


def load_events(workdir):
    """Parse ``workdir/fleet.log`` back into a list of event dicts."""
    return _supervisor.load_events(workdir, filename=FLEET_LOG)


def read_fleet_state(workdir):
    """The durable controller journal (``workdir/fleet_state.json``),
    or None when absent, torn, or not a JSON object — a bad journal is
    stale-until-rewritten, never an error (the restarted controller
    boots fresh and re-journals)."""
    state = _read_json(os.path.join(str(workdir), FLEET_STATE))
    return state if isinstance(state, dict) else None


class FleetLockError(RuntimeError):
    """A second controller refused to start on a workdir whose journal
    holds a live, fresh controller lease (split-brain guard). Carries
    the structured facts: ``pid`` (the holder) and ``lease_age_s``."""

    def __init__(self, workdir, pid, lease_age_s):
        self.workdir = str(workdir)
        self.pid = pid
        self.lease_age_s = float(lease_age_s)
        super(FleetLockError, self).__init__(
            "fleet workdir %r is held by a live controller (pid %s, "
            "lease %.1fs old): refusing split-brain start"
            % (self.workdir, pid, self.lease_age_s)
        )


def _pid_alive(pid):
    """True when ``pid`` names a live, non-zombie process (EPERM counts
    as alive — it exists, it just isn't ours)."""
    return _AdoptedProc(pid).poll() is None


class _AdoptedProc(object):
    """A Popen-shaped handle over an ADOPTED replica — a live process
    the restarted controller did not spawn and cannot ``wait()`` on.
    ``poll()`` is signal-0 liveness plus a ``/proc/<pid>/stat`` zombie
    check: a zombie of some OTHER parent still answers signal 0, and
    without the 'Z' check a kill-then-wait on one would stall the
    drain path for its full timeout. The exit code of a non-child is
    unknowable, so a vanished process reports -1."""

    def __init__(self, pid):
        self.pid = int(pid)
        self.returncode = None

    def _alive(self):
        try:
            os.kill(self.pid, 0)
        except ProcessLookupError:
            return False
        except OSError:
            pass  # EPERM etc.: the pid exists
        try:
            with open("/proc/%d/stat" % self.pid) as f:
                # comm may contain spaces/parens: state is the field
                # after the LAST ") "
                tail = f.read().rsplit(") ", 1)
            if len(tail) == 2 and tail[1][:1] == "Z":
                return False
        except OSError:
            pass  # no procfs: signal-0 liveness is the best we have
        return True

    def poll(self):
        if self.returncode is None and not self._alive():
            self.returncode = -1
        return self.returncode

    def wait(self, timeout=None):
        deadline = (None if timeout is None
                    else time.monotonic() + float(timeout))
        while self.poll() is None:
            if deadline is not None and time.monotonic() > deadline:
                raise subprocess.TimeoutExpired(
                    "adopted pid %d" % self.pid, timeout
                )
            time.sleep(0.05)
        return self.returncode

    def send_signal(self, sig):
        try:
            os.kill(self.pid, sig)
        except OSError:
            pass

    def terminate(self):
        self.send_signal(signal.SIGTERM)

    def kill(self):
        self.send_signal(signal.SIGKILL)


# ---------------------------------------------------------------------------
# autoscaler policy (pure decision logic — unit-testable against a fake
# metrics source, independent of processes and sockets)
# ---------------------------------------------------------------------------
class AutoscalerPolicy(object):
    """Streak-based scaling decisions with hysteresis.

    ``observe(samples, target)`` consumes one scrape round — a list of
    per-replica dicts ``{"queue_depth", "shed_delta", "p95_ms"}`` — and
    returns ``(new_target, reason|None)``:

    - mean queue depth >= ``queue_high``, ANY admission shed since the
      last round, or (when ``latency_high_ms`` > 0) mean p95 latency
      over it, counts as a *pressured* round; ``up_ticks`` consecutive
      pressured rounds scale up by one.
    - mean queue depth <= ``queue_low`` with zero sheds counts as an
      *idle* round; ``down_ticks`` consecutive idle rounds scale down
      by one. ``down_ticks`` should be the larger streak — that
      asymmetry IS the anti-flap hysteresis, and the band between
      ``queue_low`` and ``queue_high`` resets neither streak.
    - the returned target is always clamped to ``[min, max]``; an
      empty sample round (no ready replicas — nothing trustworthy to
      decide on) resets both streaks.
    """

    def __init__(self, min_replicas=None, max_replicas=None,
                 queue_high=None, queue_low=None, up_ticks=None,
                 down_ticks=None, latency_high_ms=None):
        self.min_replicas = max(1, int(_flag("fleet_min_replicas",
                                             min_replicas)))
        self.max_replicas = max(self.min_replicas,
                                int(_flag("fleet_max_replicas",
                                          max_replicas)))
        self.queue_high = float(_flag("fleet_queue_high", queue_high))
        self.queue_low = float(_flag("fleet_queue_low", queue_low))
        self.up_ticks = max(1, int(_flag("fleet_scale_up_ticks", up_ticks)))
        self.down_ticks = max(1, int(_flag("fleet_scale_down_ticks",
                                           down_ticks)))
        self.latency_high_ms = float(_flag("fleet_latency_high_ms",
                                           latency_high_ms))
        self._high_streak = 0
        self._low_streak = 0

    def _clamp(self, n):
        return max(self.min_replicas, min(self.max_replicas, int(n)))

    def observe(self, samples, target):
        target = self._clamp(target)
        if not samples:
            self._high_streak = self._low_streak = 0
            return target, None
        qs = [float(s.get("queue_depth") or 0.0) for s in samples]
        mean_q = sum(qs) / len(qs)
        sheds = sum(float(s.get("shed_delta") or 0.0) for s in samples)
        p95s = [float(s["p95_ms"]) for s in samples
                if s.get("p95_ms") is not None]
        mean_p95 = (sum(p95s) / len(p95s)) if p95s else 0.0
        pressured = (
            mean_q >= self.queue_high
            or sheds > 0
            or (self.latency_high_ms > 0 and mean_p95 >= self.latency_high_ms)
        )
        idle = mean_q <= self.queue_low and sheds == 0
        if pressured:
            self._high_streak += 1
            self._low_streak = 0
        elif idle:
            self._low_streak += 1
            self._high_streak = 0
        # the middle band holds both streaks where they are: a noisy
        # sample between the thresholds neither arms nor disarms
        if self._high_streak >= self.up_ticks and target < self.max_replicas:
            self._high_streak = self._low_streak = 0
            return target + 1, "queue_pressure"
        if self._low_streak >= self.down_ticks and target > self.min_replicas:
            self._low_streak = 0
            return target - 1, "idle"
        return target, None


class SLOPolicy(object):
    """SLO-driven scaling: pressure is a LATENCY budget breach, not a
    queue length. ``observe(samples, target)`` has the exact
    AutoscalerPolicy contract (same streak/hysteresis shape, same
    clamping, same empty-round reset) but reads the decode engine's
    latency histograms — ``ttft_p95_ms`` (p95 of ``decode_ttft_ms``)
    and ``intertoken_p95_ms`` (p95 of ``decode_intertoken_ms``) — which
    ``_scrape_samples`` now carries alongside the queue fields:

    - a round is *pressured* when ANY shed happened, the fleet-mean
      TTFT p95 is at/over ``FLAGS_fleet_slo_ttft_ms``, or (budget
      armed, > 0) the inter-token p95 is at/over
      ``FLAGS_fleet_slo_intertoken_ms``;
    - a round is *idle* when shed-free AND every armed budget sits
      under ``FLAGS_fleet_slo_headroom`` of itself (scale-down needs
      real headroom, not a hair under the line); replicas with no
      latency samples yet (no traffic) count as idle.

    The simulator won this policy its promotion: against recorded
    journeys it holds interactive TTFT through load the queue-depth
    policy reacts to one streak late."""

    def __init__(self, min_replicas=None, max_replicas=None,
                 ttft_budget_ms=None, intertoken_budget_ms=None,
                 headroom=None, up_ticks=None, down_ticks=None):
        self.min_replicas = max(1, int(_flag("fleet_min_replicas",
                                             min_replicas)))
        self.max_replicas = max(self.min_replicas,
                                int(_flag("fleet_max_replicas",
                                          max_replicas)))
        self.ttft_budget_ms = float(_flag("fleet_slo_ttft_ms",
                                          ttft_budget_ms))
        self.intertoken_budget_ms = float(_flag("fleet_slo_intertoken_ms",
                                                intertoken_budget_ms))
        self.headroom = min(1.0, max(0.0, float(_flag("fleet_slo_headroom",
                                                      headroom))))
        self.up_ticks = max(1, int(_flag("fleet_scale_up_ticks", up_ticks)))
        self.down_ticks = max(1, int(_flag("fleet_scale_down_ticks",
                                           down_ticks)))
        self._high_streak = 0
        self._low_streak = 0

    def _clamp(self, n):
        return max(self.min_replicas, min(self.max_replicas, int(n)))

    @staticmethod
    def _mean(samples, key):
        vals = [float(s[key]) for s in samples if s.get(key) is not None]
        return (sum(vals) / len(vals)) if vals else None

    def observe(self, samples, target):
        target = self._clamp(target)
        if not samples:
            self._high_streak = self._low_streak = 0
            return target, None
        sheds = sum(float(s.get("shed_delta") or 0.0) for s in samples)
        ttft = self._mean(samples, "ttft_p95_ms")
        itl = self._mean(samples, "intertoken_p95_ms")
        breached = sheds > 0
        under_headroom = sheds == 0
        if self.ttft_budget_ms > 0 and ttft is not None:
            breached = breached or ttft >= self.ttft_budget_ms
            under_headroom = (under_headroom
                              and ttft <= self.headroom * self.ttft_budget_ms)
        if self.intertoken_budget_ms > 0 and itl is not None:
            breached = breached or itl >= self.intertoken_budget_ms
            under_headroom = (
                under_headroom
                and itl <= self.headroom * self.intertoken_budget_ms
            )
        if breached:
            _profiler.bump_counter("fleet_slo_breach_ticks")
            self._high_streak += 1
            self._low_streak = 0
        elif under_headroom:
            self._low_streak += 1
            self._high_streak = 0
        # between headroom and budget: hold both streaks (hysteresis
        # band, same as AutoscalerPolicy's queue band)
        if self._high_streak >= self.up_ticks and target < self.max_replicas:
            self._high_streak = self._low_streak = 0
            return target + 1, "slo_pressure"
        if self._low_streak >= self.down_ticks and target > self.min_replicas:
            self._low_streak = 0
            return target - 1, "slo_headroom"
        return target, None


def make_policy(name=None, min_replicas=None, max_replicas=None):
    """The ``FLAGS_fleet_policy`` selector ("streak" | "slo") — one
    constructor shared by the live controller and the fleet simulator,
    so a policy promoted in the sim is the byte-identical object the
    fleet runs."""
    name = str(name if name is not None
               else _flags.get_flag("fleet_policy", "streak")).lower()
    if name == "slo":
        return SLOPolicy(min_replicas=min_replicas,
                         max_replicas=max_replicas)
    if name in ("streak", ""):
        return AutoscalerPolicy(min_replicas=min_replicas,
                                max_replicas=max_replicas)
    raise ValueError("unknown fleet policy %r (want 'streak' or 'slo')"
                     % name)


# ---------------------------------------------------------------------------
# replica bookkeeping
# ---------------------------------------------------------------------------
class _Replica(object):
    __slots__ = (
        "id", "version", "model_dir", "proc", "endpoint_file", "hb_file",
        "obs_dir", "state", "endpoint", "spawn_t", "drain_t", "shed_seen",
        "hb_seen", "role", "adopted",
    )

    def __init__(self, rid, version, model_dir, proc, endpoint_file,
                 hb_file, obs_dir, role="mixed", adopted=False):
        self.id = int(rid)
        self.version = int(version)
        self.model_dir = str(model_dir)
        self.proc = proc
        self.endpoint_file = endpoint_file
        self.hb_file = hb_file
        self.obs_dir = obs_dir
        self.state = "starting"  # starting|ready|draining|exited
        self.endpoint = None     # {"gateway_port", "metrics_port", ...}
        self.spawn_t = time.monotonic()
        self.drain_t = None
        self.shed_seen = 0.0     # autoscaler shed-delta bookkeeping
        self.hb_seen = None      # (mtime, first-observed monotonic time)
        self.role = str(role)    # prefill|decode|mixed (KV-tier split)
        self.adopted = bool(adopted)  # survivor of a crashed controller

    @property
    def pid(self):
        return self.proc.pid if self.proc is not None else None

    def info(self):
        ep = self.endpoint or {}
        return {
            "id": self.id,
            "version": self.version,
            "state": self.state,
            "pid": self.pid,
            "gateway_port": ep.get("gateway_port"),
            "metrics_port": ep.get("metrics_port"),
            "model_dir": self.model_dir,
            "role": self.role,
            "adopted": self.adopted,
        }


def _read_json(path):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _resolve_model(model_dir):
    """(model_dir, declared_version|None): a ``checkpoint.modeldir``
    repository resolves through ``modeldir.latest()``, a published
    versioned dir reads its manifest, a plain export dir is itself.
    A repo is recognized by its LATEST pointer OR by published ``v_*``
    dirs — a publish torn between the version landing and the pointer
    flip must still resolve (latest() falls back to the highest
    published version), not be mistaken for an export dir."""
    from ..checkpoint import modeldir as _modeldir

    model_dir = str(model_dir)
    if (os.path.isfile(os.path.join(model_dir, _modeldir.LATEST))
            or _modeldir.versions(model_dir)):
        version, path = _modeldir.latest(model_dir)
        if path is None:
            raise ValueError("model repo %r has no published version"
                             % model_dir)
        return path, version
    manifest = _modeldir.read_manifest(model_dir)
    if manifest is not None:
        return model_dir, int(manifest.get("version", 0)) or None
    return model_dir, None


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------
class FleetController(object):
    """Spawns, supervises, scales, and rolls a pool of serving
    replicas behind one Router.

    Usage::

        ctrl = serving.FleetController(
            model_dir="models/repo",      # modeldir repo or export dir
            workdir="fleet_work",
            replicas=2,
        ).start(wait_ready_s=120)
        print(ctrl.router.url("/readyz"))   # the one address
        ...
        ctrl.deploy("models/export_v2")     # zero-downtime rollout
        ctrl.stop()

    ``replica_cmd`` (tests) overrides the spawned argv:
    ``replica_cmd(rid, version, model_dir, endpoint_file) -> argv``.
    ``replica_env`` adds environment (e.g. ``FLAGS_serving_*`` policy
    or ``FLAGS_serving_strict_compiles`` for the hard zero-recompile
    bar) to every replica. ``device`` ("cuda" or "cpu") is passed to
    every replica as ``--device``; None leaves the replica's default,
    the card.
    """

    def __init__(self, model_dir, workdir, replicas=None,
                 min_replicas=None, max_replicas=None, policy=None,
                 autoscale=True, replica_env=None, replica_args=(),
                 replica_cmd=None, router=None, router_port=None,
                 host="127.0.0.1", scale_interval_s=None,
                 ready_timeout_s=None, drain_grace_s=None,
                 restart_backoff_s=None, max_replica_restarts=None,
                 heartbeat_timeout_s=None, poll_s=0.1, seed=None,
                 echo_events=False, roles=None, lease_interval_s=None,
                 lease_ttl_s=None, state_lease_ttl_s=None, device=None):
        self.workdir = str(workdir)
        self.device = device
        os.makedirs(self.workdir, exist_ok=True)
        # role-split topology (KV tier): {"prefill": 1, "decode": 2}.
        # Spawn order fills prefill slots first, then decode; extras
        # beyond the declared counts serve "decode" under a role spec
        # (the spec means traffic is split) and "mixed" without one.
        self.roles = {}
        for k, v in dict(roles or {}).items():
            if k not in ("prefill", "decode", "mixed"):
                raise ValueError("unknown replica role %r" % (k,))
            if int(v) > 0:
                self.roles[k] = int(v)
        self._peers_file = os.path.join(self.workdir, "kv_peers.json")
        self.model_dir, declared = _resolve_model(model_dir)
        self.version = declared if declared is not None else 1
        # policy: explicit object > FLAGS_fleet_policy selection
        # ("streak" = queue-depth AutoscalerPolicy, "slo" = SLOPolicy)
        self.policy = policy or make_policy(
            min_replicas=min_replicas, max_replicas=max_replicas
        )
        self.autoscale = bool(autoscale)
        self.target = int(
            self.policy.min_replicas if replicas is None else replicas
        )
        self.target = self.policy._clamp(self.target)
        self.scale_interval_s = float(
            _flag("fleet_scale_interval_s", scale_interval_s)
        )
        self.ready_timeout_s = float(
            _flag("fleet_replica_ready_timeout_s", ready_timeout_s)
        )
        self.drain_grace_s = float(_flag("fleet_drain_grace_s",
                                         drain_grace_s))
        self.restart_backoff_s = float(
            _flag("fleet_restart_backoff_s", restart_backoff_s)
        )
        self.max_replica_restarts = int(
            _flag("fleet_max_replica_restarts", max_replica_restarts)
        )
        # durability knobs: how often the replica serve loop and the
        # controller tick re-stamp their leases, and how stale each
        # lease may grow before it means "dead"
        self.lease_interval_s = float(
            _flag("fleet_lease_interval_s", lease_interval_s)
        )
        self.lease_ttl_s = float(_flag("fleet_lease_ttl_s", lease_ttl_s))
        self.state_lease_ttl_s = float(
            _flag("fleet_state_lease_ttl_s", state_lease_ttl_s)
        )
        # replica heartbeats ride the supervisor's worker-side protocol
        # (PADDLE_TPU_HEARTBEAT_FILE + WorkerHeartbeat): the staleness
        # bound must clear the beat throttle, same as the supervisor's
        self.heartbeat_timeout_s = max(
            float(_flag("dist_heartbeat_timeout_s", heartbeat_timeout_s)),
            2.0 * float(_flags.get_flag("dist_heartbeat_interval_s", 0.5)),
        )
        self.host = host
        self.poll_s = float(poll_s)
        self.replica_env = dict(replica_env or {})
        self.replica_args = list(replica_args)
        self._replica_cmd = replica_cmd
        self._owns_router = router is None
        from .router import Router

        self.router = router or Router(port=router_port, host=host)
        self._hb_dir = os.path.join(self.workdir, "heartbeats")
        self._ep_dir = os.path.join(self.workdir, "endpoints")
        self._log_dir = os.path.join(self.workdir, "logs")
        self._obs_root = os.path.join(self.workdir, "obs")
        for d in (self._hb_dir, self._ep_dir, self._log_dir,
                  self._obs_root):
            os.makedirs(d, exist_ok=True)
        self.log = _supervisor._Log(
            os.path.join(self.workdir, FLEET_LOG), echo=echo_events
        )
        self._rng = random.Random(seed)
        self._replicas = {}  # rid -> _Replica
        self._next_rid = 0
        self._lock = threading.RLock()
        self._stop_evt = threading.Event()
        self._tick_thread = None
        self._started = False
        self._rollout = False
        self.crashes = 0
        self._gaveup = False
        self._backoff_until = 0.0
        self._next_scale_t = 0.0
        self._crash_deficit = 0
        self._pool_crashes = 0  # serving-version crashes (budget/backoff)
        self._last_report_t = 0.0
        self._last_tick_err = 0.0
        self._ready_gauge = None
        self._target_gauge = None
        # durable control-plane state
        self._state_file = os.path.join(self.workdir, FLEET_STATE)
        self._boot_id = "%d.%d" % (os.getpid(), int(time.time() * 1e3))
        self._boot_mono = time.monotonic()
        self._rollout_meta = None   # journaled rollout phase (or None)
        self._last_journal_t = 0.0

    # -- public ------------------------------------------------------------
    def start(self, wait_ready_s=None):
        if self._started:
            raise RuntimeError("fleet controller already started")
        wd_key = os.path.realpath(self.workdir)
        state = read_fleet_state(self.workdir)
        self._check_split_brain(wd_key, state)
        recovered = self._restore_intent(state)
        _LIVE_CONTROLLERS.add(wd_key)
        try:
            if self._owns_router:
                self.router.start()
            # pin routing to the serving version from the FIRST moment:
            # a router left on "route all" (None) would serve live
            # traffic from still-warming new-version replicas the
            # instant _check_ready adds them during the first deploy()
            # — before the atomic flip, violating the rollout contract
            self.router.set_active_version(self.version)
            self.log.event(
                "fleet_boot", target=self.target,
                min_replicas=self.policy.min_replicas,
                max_replicas=self.policy.max_replicas,
                version=self.version, model_dir=self.model_dir,
                router_port=self.router.port,
                recovered=bool(recovered),
            )
            self._stop_evt.clear()
            self._boot_mono = time.monotonic()
            if recovered:
                self._recover(recovered)
            # a fresh boot and a recovery converge on the SAME path an
            # ordinary crash replacement takes: reconcile observed
            # state against the journaled intent (fresh: zero adopted,
            # deficit == target, ungated growth spawns)
            self._reconcile(time.monotonic())
            self._journal()
            self._started = True
            self._ready_gauge = lambda c=self: c.ready_count()
            _obs_registry.register_gauge("fleet_replicas_ready",
                                         self._ready_gauge)
            self._target_gauge = lambda c=self: c.target
            _obs_registry.register_gauge("fleet_replicas_target",
                                         self._target_gauge)
            self._tick_thread = threading.Thread(
                target=self._run, name="fleet_control", daemon=True
            )
            self._tick_thread.start()
        except BaseException:
            _LIVE_CONTROLLERS.discard(wd_key)
            raise
        if wait_ready_s:
            self.wait_ready(timeout=float(wait_ready_s))
        return self

    # -- durable state / recovery -------------------------------------------
    def _check_split_brain(self, wd_key, state):
        """Refuse to start over a live controller: one already started
        in this process on the same workdir, or a journal lease that is
        fresh (< state_lease_ttl_s) AND whose holder pid is alive. A
        fresh lease with a DEAD holder is the common crash-then-restart
        window — proceed; a stale lease means the holder stopped
        supervising — proceed regardless of its pid."""
        if wd_key in _LIVE_CONTROLLERS:
            raise FleetLockError(self.workdir, os.getpid(), 0.0)
        ctl = (state or {}).get("controller")
        if not isinstance(ctl, dict):
            return
        try:
            pid = int(ctl.get("pid") or 0)
            age = time.time() - float(ctl.get("lease_ts") or 0.0)
        except (TypeError, ValueError):
            return
        if pid <= 0 or age >= self.state_lease_ttl_s:
            return
        if pid != os.getpid() and _pid_alive(pid):
            raise FleetLockError(self.workdir, pid, age)

    def _restore_intent(self, state):
        """Adopt the journaled INTENT (target, version, model dir,
        roles, rollout phase) and crash-budget ledger as this
        controller's own. Tolerates partial/odd journals field by
        field — adoption probes reality afterwards anyway. Returns the
        state when there is one to recover from, else None."""
        if not state:
            return None
        ctl = state.get("controller")
        pool = state.get("replicas")
        if not isinstance(ctl, dict) and not (
            isinstance(pool, dict) and pool
        ):
            # a cleanly-released journal (stop() wrote the lease away
            # and the pool drained empty): nothing to recover — this
            # boot's OWN configuration is the intent
            return None
        intent = state.get("intent")
        intent = intent if isinstance(intent, dict) else {}
        ledger = state.get("ledger")
        ledger = ledger if isinstance(ledger, dict) else {}
        try:
            self.target = self.policy._clamp(
                int(intent.get("target", self.target))
            )
        except (TypeError, ValueError):
            pass
        try:
            if intent.get("version") is not None:
                self.version = int(intent["version"])
        except (TypeError, ValueError):
            pass
        if intent.get("model_dir"):
            self.model_dir = str(intent["model_dir"])
        if isinstance(intent.get("roles"), dict):
            try:
                self.roles = {
                    str(k): int(v) for k, v in intent["roles"].items()
                    if k in ("prefill", "decode", "mixed") and int(v) > 0
                }
            except (TypeError, ValueError):
                pass
        ro = intent.get("rollout")
        self._rollout_meta = ro if isinstance(ro, dict) else None
        try:
            self.crashes = int(ledger.get("crashes", 0))
            self._pool_crashes = int(ledger.get("pool_crashes", 0))
            self._gaveup = bool(ledger.get("gaveup", False))
        except (TypeError, ValueError):
            pass
        return state

    def _recover(self, state):
        """The adoption scan: walk the journaled pool and the endpoint
        dir, probe ``/readyz`` as ground truth, adopt live warm
        replicas in place, book headless deaths as crash deficit under
        the restored budget, and land an interrupted rollout (pre-flip
        abort / post-flip drain resume)."""
        prev = state.get("controller")
        prev = prev if isinstance(prev, dict) else {}
        journal = state.get("replicas")
        journal = journal if isinstance(journal, dict) else {}
        ro = self._rollout_meta
        abort_version = None
        resume_from = None
        if ro and ro.get("phase") == "spawning":
            # died before the traffic flip: the new version never
            # served — kill its half-born replicas, v_old keeps serving
            try:
                abort_version = int(ro.get("version"))
            except (TypeError, ValueError):
                pass
        elif ro and ro.get("phase") == "flipped":
            # died after the flip: the new version IS the pool (intent
            # version was journaled atomically with the flip); what
            # remains of the old pool resumes its drain
            try:
                resume_from = int(ro.get("from_version"))
            except (TypeError, ValueError):
                pass
        # every replica the journal believes in, plus any endpoint file
        # on disk (a spawn journaled late still gets considered)
        rids = set()
        for key in journal:
            try:
                rids.add(int(key))
            except (TypeError, ValueError):
                pass
        try:
            import re as _re
            for name in os.listdir(self._ep_dir):
                m = _re.match(r"^replica_(\d+)\.json$", name)
                if m:
                    rids.add(int(m.group(1)))
        except OSError:
            pass
        adopted, drained, killed, lost = [], [], [], []
        with self._lock:
            self._next_rid = max([self._next_rid] +
                                 [i + 1 for i in rids])
            for rid in sorted(rids):
                meta = journal.get(str(rid))
                meta = meta if isinstance(meta, dict) else {}
                epf = os.path.join(self._ep_dir,
                                   "replica_%d.json" % rid)
                ep = _read_json(epf)
                ep = ep if isinstance(ep, dict) else None
                try:
                    rver = int(meta.get("version",
                                        (ep or {}).get("version")))
                except (TypeError, ValueError):
                    rver = self.version
                pid = (ep or {}).get("pid") or meta.get("pid")
                port = (ep or {}).get("gateway_port")
                alive = bool(pid) and _pid_alive(pid)
                if rver == abort_version:
                    if alive:
                        _AdoptedProc(pid).kill()
                    killed.append(rid)
                    continue
                # /readyz is the adoption ground truth: a live pid
                # whose gateway won't answer (draining, wedged, or
                # torn endpoint) is not a survivor worth adopting
                if not (alive and port and self._probe_readyz(port)):
                    if str(rid) in journal:
                        lost.append((rid, rver))
                    continue
                role = str(meta.get("role") or "mixed")
                r = _Replica(
                    rid, rver,
                    meta.get("model_dir") or self.model_dir,
                    _AdoptedProc(pid), epf,
                    os.path.join(self._hb_dir, "replica_%d.json" % rid),
                    os.path.join(self._obs_root, "replica_%d" % rid),
                    role=role, adopted=True,
                )
                r.state = "ready"
                r.endpoint = ep
                self._replicas[rid] = r
                if role != "prefill" and rver != resume_from:
                    self.router.add_backend(
                        r.id, self.host, port, version=rver,
                        ready=True, adopted=True, journal_version=rver,
                    )
                _profiler.bump_counter("fleet_adoptions")
                self.log.event(
                    "replica_adopt", replica=rid, version=rver,
                    pid=pid, role=role,
                    ready_replicas=self._ready_locked(),
                )
                adopted.append(r)
                if rver == resume_from:
                    drained.append(r)
            if any(r.role == "prefill" for r in adopted):
                self._update_peers_locked()
            # journaled-live replicas that did not survive the
            # headless window: real crashes against the restored
            # budget; only current-pool holes gate as replacements
            for rid, rver in lost:
                self.crashes += 1
                _profiler.bump_counter("fleet_replica_crashes")
                self.log.event("replica_lost", replica=rid,
                               version=rver)
                if rver == self.version:
                    self._pool_crashes += 1
                    self._crash_deficit += 1
            for r in drained:
                self._begin_drain(r, reason="rollout")
        if abort_version is not None:
            self.log.event(
                "rollout_abort", version=abort_version, flipped=False,
                error="controller died before the flip; "
                      "aborted on recovery", killed=killed,
            )
        if resume_from is not None:
            self.log.event(
                "rollout_resume", version=self.version,
                from_version=resume_from, draining=len(drained),
            )
        self._rollout_meta = None
        headless_ms = None
        try:
            headless_ms = max(
                0.0, (time.time() - float(prev["lease_ts"])) * 1e3
            )
            _profiler.bump_histogram("fleet_headless_ms", headless_ms)
        except (KeyError, TypeError, ValueError):
            pass
        self.log.event(
            "controller_recover", adopted=len(adopted),
            lost=len(lost),
            headless_ms=(round(headless_ms, 1)
                         if headless_ms is not None else None),
        )

    def _state_locked(self, controller):
        return {
            "schema_version": 1,
            "controller": controller,
            "intent": {
                "target": self.target,
                "version": self.version,
                "model_dir": self.model_dir,
                "roles": self.roles,
                "rollout": self._rollout_meta,
            },
            "ledger": {
                "pool_crashes": self._pool_crashes,
                "crashes": self.crashes,
                "gaveup": self._gaveup,
            },
            "replicas": {
                str(r.id): {"version": r.version,
                            "model_dir": r.model_dir,
                            "role": r.role, "pid": r.pid}
                for r in self._replicas.values()
                if r.state in ("starting", "ready")
            },
        }

    def _journal(self, release=False):
        """Atomically commit intent + ledger + pool to the journal,
        re-stamping the controller lease (``release`` writes the lease
        away — a clean stop leaves no holder). Best-effort: a full
        disk must not take down supervision; the state catches up on
        the next successful commit."""
        from ..checkpoint import modeldir as _modeldir

        with self._lock:
            controller = None if release else {
                "pid": os.getpid(),
                "lease_ts": time.time(),
                "boot_id": self._boot_id,
            }
            state = self._state_locked(controller)
        try:
            _modeldir.commit_json(self._state_file, state, indent=1)
        except OSError:
            pass
        self._last_journal_t = time.monotonic()

    def ready_count(self, version=None):
        with self._lock:
            return sum(
                1 for r in self._replicas.values()
                if r.state == "ready"
                and (version is None or r.version == version)
            )

    def replica_info(self):
        with self._lock:
            return [r.info() for r in self._replicas.values()
                    if r.state != "exited"]

    def wait_ready(self, count=None, timeout=120.0):
        """Block until ``count`` (default: the current target) replicas
        of the serving version are ready; raises TimeoutError."""
        deadline = time.monotonic() + float(timeout)
        while True:
            want = self.target if count is None else int(count)
            if self.ready_count(version=self.version) >= want:
                return self
            if time.monotonic() > deadline:
                raise TimeoutError(
                    "fleet: %d/%d replicas ready after %.0fs"
                    % (self.ready_count(version=self.version), want,
                       timeout)
                )
            if self._gaveup:
                raise RuntimeError(
                    "fleet gave up replacing crashed replicas "
                    "(%d crashes; see %s)"
                    % (self.crashes,
                       os.path.join(self.workdir, FLEET_LOG))
                )
            time.sleep(0.05)

    def scale_to(self, n, reason="manual"):
        """Set the replica target; the control loop reconciles (spawn
        up, or graceful-drain down). Clamped to the policy bounds."""
        with self._lock:
            n = self.policy._clamp(n)
            if n == self.target:
                return self.target
            old, self.target = self.target, n
            event = "scale_up" if n > old else "scale_down"
            _profiler.bump_counter(
                "fleet_scale_ups" if n > old else "fleet_scale_downs"
            )
            self.log.event(
                event, from_replicas=old, to_replicas=n, reason=reason,
                ready_replicas=self._ready_locked(),
            )
        self._journal()
        self._write_report()
        return n

    def deploy(self, model_dir, ready_timeout_s=None):
        """Zero-downtime rollout to ``model_dir`` (repo or export dir):
        spawn the new version beside the old, wait warm, flip the
        router, drain the old. Returns the new version number."""
        new_dir, declared = _resolve_model(model_dir)
        with self._lock:
            if not self._started:
                raise RuntimeError("fleet controller is not started")
            if self._rollout:
                raise RuntimeError("a rollout is already in progress")
            self._rollout = True
            old_version = self.version
            new_version = (
                declared if declared is not None and declared > old_version
                else old_version + 1
            )
            count = self.target
        t0 = time.monotonic()
        self.log.event(
            "rollout_start", version=new_version, from_version=old_version,
            model_dir=new_dir, replicas=count,
        )
        timeout = float(ready_timeout_s if ready_timeout_s is not None
                        else self.ready_timeout_s)
        new_ids = []
        flipped = False
        try:
            with self._lock:
                for _ in range(count):
                    new_ids.append(self._spawn(new_version, new_dir).id)
                self._rollout_meta = {
                    "phase": "spawning", "version": new_version,
                    "model_dir": new_dir, "from_version": old_version,
                    "new_ids": list(new_ids),
                }
            # journal the in-flight rollout BEFORE any new replica can
            # go ready: a controller that dies from here until the flip
            # aborts the rollout on recovery (v_old never stopped
            # serving)
            self._journal()
            deadline = time.monotonic() + timeout
            while True:
                with self._lock:
                    states = [
                        self._replicas[i].state for i in new_ids
                        if i in self._replicas
                    ]
                ready = sum(1 for s in states if s == "ready")
                if ready >= count:
                    break
                if len(states) < len(new_ids) or "exited" in states:
                    raise RuntimeError(
                        "a new-version replica died during rollout "
                        "warmup (version %d)" % new_version
                    )
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        "rollout: %d/%d new replicas ready after %.0fs"
                        % (ready, count, timeout)
                    )
                time.sleep(0.05)
            self.log.event(
                "rollout_ready", version=new_version,
                ready_ms=round((time.monotonic() - t0) * 1e3, 1),
            )
            # the traffic flip: atomic in the router — new requests only
            # ever see the new version from here on
            self.router.set_active_version(new_version)
            flipped = True
            with self._lock:
                self.version = new_version
                self.model_dir = new_dir
                self._rollout_meta = {
                    "phase": "flipped", "version": new_version,
                    "model_dir": new_dir, "from_version": old_version,
                    "new_ids": list(new_ids),
                }
                old = [r for r in self._replicas.values()
                       if r.version == old_version
                       and r.state in ("starting", "ready")]
            # ONE commit records the flip: intent.version advances to
            # the new version in the same atomic write that marks the
            # phase "flipped" — a recovery sees either pre-flip (abort
            # to old) or post-flip (resume old-pool drain), never a
            # half-state
            self._journal()
            with self._lock:
                for r in old:
                    self._begin_drain(r, reason="rollout")
            drained = self._await_exits([r.id for r in old],
                                        timeout=self.drain_grace_s + 30.0)
            ms = (time.monotonic() - t0) * 1e3
            _profiler.bump_counter("fleet_rollouts")
            _profiler.bump_histogram("fleet_rollout_ms", ms)
            self.log.event(
                "rollout_done", version=new_version, ms=round(ms, 1),
                drained=drained,
                ready_replicas=self.ready_count(version=new_version),
            )
            self._write_report(force=True)
            return new_version
        except Exception as e:
            if not flipped:
                # abort: the old version keeps serving; kill the
                # half-born new replicas outright (pre-flip, they
                # never took traffic)
                with self._lock:
                    doomed = [
                        self._replicas[i] for i in new_ids
                        if i in self._replicas
                        and self._replicas[i].state != "exited"
                    ]
                    for r in doomed:
                        # expected exits: the still-running tick
                        # thread must not book these kills as crashes
                        # (backoff, restart budget), and they must
                        # stop routing now
                        self.router.remove_backend(r.id)
                        r.state = "draining"
                        r.drain_t = time.monotonic()
                self._kill_and_reap(doomed)
            # POST-flip failures (old-drain hiccup, a full disk under
            # the event log) must NOT roll the new version back: the
            # router is already pinned to it and the old pool is
            # draining — killing the new replicas would be a full
            # outage. The new version stays; leftovers reconcile.
            try:
                self.log.event("rollout_abort", version=new_version,
                               flipped=flipped, error=str(e))
            except Exception:
                pass
            raise
        finally:
            with self._lock:
                self._rollout = False
                self._rollout_meta = None
            self._journal()

    def stop(self):
        """Drain every replica gracefully, stop the control loop and
        (owned) router, and leave a final fleet report."""
        if not self._started:
            return
        self._started = False
        self._stop_evt.set()
        if self._tick_thread is not None:
            self._tick_thread.join(timeout=10.0)
            self._tick_thread = None
        with self._lock:
            live = [r for r in self._replicas.values()
                    if r.state in ("starting", "ready", "draining")]
            for r in live:
                if r.state != "draining":
                    self._begin_drain(r, reason="fleet_stop")
        self._await_exits([r.id for r in live],
                          timeout=self.drain_grace_s + 30.0,
                          reap=True)
        # stragglers past the grace: the drain watchdog is dead with
        # the tick thread, so finish its job here
        with self._lock:
            stragglers = [r for r in self._replicas.values()
                          if r.state != "exited"]
        self._kill_and_reap(stragglers)
        if self._owns_router:
            self.router.stop()
        if self._ready_gauge is not None:
            _obs_registry.unregister_gauge("fleet_replicas_ready",
                                           self._ready_gauge)
            self._ready_gauge = None
        if self._target_gauge is not None:
            _obs_registry.unregister_gauge("fleet_replicas_target",
                                           self._target_gauge)
            self._target_gauge = None
        self.log.event("fleet_stop", crashes=self.crashes)
        # clean release: journal with no controller lease (and an empty
        # live pool) so the next start on this workdir boots fresh
        # instead of recovering
        self._journal(release=True)
        _LIVE_CONTROLLERS.discard(os.path.realpath(self.workdir))
        self._write_report(force=True)

    def __enter__(self):
        return self if self._started else self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- spawn / drain / kill ----------------------------------------------
    def _cmd(self, rid, version, model_dir, endpoint_file, role="mixed"):
        if self._replica_cmd is not None:
            # custom argv (tests): the role rides the environment only
            return list(self._replica_cmd(rid, version, model_dir,
                                          endpoint_file))
        return [
            sys.executable, "-m", "paddle_tpu_torch.serving.replica",
            "--model-dir", model_dir,
            "--endpoint-file", endpoint_file,
            "--replica-id", str(rid),
            "--version", str(version),
            "--host", self.host,
            "--role", role,
        ] + (["--device", self.device] if self.device else []) \
            + self.replica_args

    def _role_for_next(self):
        """Role for the next spawn (caller holds the lock): refill the
        declared prefill pool first — decode replicas degrade to local
        prefill while it's short, so a prefill hole hurts the whole
        fleet's TTFT — then decode; extras are decode under a role
        spec, mixed without one."""
        if not self.roles:
            return "mixed"
        live = [r for r in self._replicas.values()
                if r.state in ("starting", "ready")]
        for role in ("prefill", "decode", "mixed"):
            want = self.roles.get(role, 0)
            if want and sum(1 for r in live if r.role == role) < want:
                return role
        return "decode" if self.roles.get("prefill") else "mixed"

    def _spawn(self, version, model_dir, replacement=False):
        """Start one replica process (caller holds the lock)."""
        rid = self._next_rid
        self._next_rid += 1
        role = self._role_for_next()
        epf = os.path.join(self._ep_dir, "replica_%d.json" % rid)
        hbf = os.path.join(self._hb_dir, "replica_%d.json" % rid)
        obs = os.path.join(self._obs_root, "replica_%d" % rid)
        for stale in (epf, hbf):
            try:
                os.remove(stale)
            except OSError:
                pass
        env = dict(os.environ)
        env.update(self.replica_env)
        env[_supervisor.HEARTBEAT_ENV] = hbf
        # stable replica identity in the environment: chaos faults
        # (FLAGS_chaos_die_replica) and any per-replica tooling address
        # one member of a pool spawned with a SHARED replica_env
        env["PADDLE_TPU_REPLICA_ID"] = str(rid)
        # the replica's own telemetry surface: metrics on an ephemeral
        # port (reported back via the endpoint file — the autoscaler's
        # scrape target) + periodic JSONL snapshots the fleet report
        # merges. An operator's explicit choice wins the setdefault.
        env.setdefault("FLAGS_obs_http_port", "0")
        env["FLAGS_obs_dir"] = obs
        env.setdefault("FLAGS_obs_snapshot_interval_s", "2.0")
        if self.roles.get("prefill"):
            # role-split fleet: every replica learns where the prefill
            # pool publishes KV blocks (the controller maintains the
            # file as prefill members come and go)
            env.setdefault("FLAGS_kv_tier_peers_file", self._peers_file)
        # `python -m paddle_tpu_torch...` must resolve no matter where the
        # controller process was launched from
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))
        ))
        env["PYTHONPATH"] = (
            pkg_root + os.pathsep + env["PYTHONPATH"]
            if env.get("PYTHONPATH") else pkg_root
        )
        log_path = os.path.join(self._log_dir, "replica_%d.log" % rid)
        fn = open(log_path, "a")
        try:
            proc = subprocess.Popen(
                self._cmd(rid, version, model_dir, epf, role=role),
                env=env, stdout=fn, stderr=fn,
            )
        finally:
            # the child holds its own dup of the descriptor; keeping
            # the parent's copy open per spawn would leak one fd per
            # replica for the controller's lifetime (autoscale/restart
            # churn is unbounded)
            fn.close()
        r = _Replica(rid, version, model_dir, proc, epf, hbf, obs,
                     role=role)
        self._replicas[rid] = r
        if replacement:
            _profiler.bump_counter("fleet_replica_restarts")
        self.log.event(
            "replica_spawn", replica=rid, version=version, pid=proc.pid,
            replacement=bool(replacement), role=role,
        )
        return r

    def _begin_drain(self, r, reason):
        """Graceful scale-down of one replica (caller holds the lock):
        stop routing to it FIRST, then SIGTERM — the gateway flips
        /readyz, completes every in-flight request (bounded by its
        drain timeout), and the process exits 0."""
        self.router.remove_backend(r.id)
        r.state = "draining"
        r.drain_t = time.monotonic()
        if r.role == "prefill":
            self._update_peers_locked()
        try:
            r.proc.send_signal(signal.SIGTERM)
        except OSError:
            pass
        self.log.event("replica_drain", replica=r.id, reason=reason,
                       ready_replicas=self._ready_locked())

    def _kill(self, r):
        try:
            r.proc.kill()
        except OSError:
            pass

    def _kill_and_reap(self, replicas):
        """SIGKILL, then actually wait() each child before the exit
        bookkeeping: a killed-but-never-waited Popen is a zombie for
        the controller's whole lifetime, and reaping BEFORE the wait
        would log returncode=None (poll() right after kill() still
        races the kernel)."""
        for r in replicas:
            self._kill(r)
        for r in replicas:
            try:
                r.proc.wait(timeout=10)
            except Exception:
                pass
        with self._lock:
            for r in replicas:
                if r.state != "exited":
                    self._reap_locked(r)

    def _await_exits(self, rids, timeout, reap=False):
        """Wait (bounded) for the given replicas to exit; returns how
        many did. With ``reap`` the exit bookkeeping runs here (used
        once the tick thread is down)."""
        deadline = time.monotonic() + float(timeout)
        while time.monotonic() < deadline:
            with self._lock:
                live = [
                    self._replicas[i] for i in rids
                    if i in self._replicas
                    and self._replicas[i].state != "exited"
                ]
                if reap:
                    for r in live:
                        if r.proc.poll() is not None:
                            self._reap_locked(r)
                    live = [r for r in live if r.state != "exited"]
            if not live:
                break
            time.sleep(0.05)
        with self._lock:
            return sum(
                1 for i in rids
                if i in self._replicas
                and self._replicas[i].state == "exited"
            )

    def _ready_locked(self):
        return sum(1 for x in self._replicas.values()
                   if x.state == "ready")

    # -- the control loop ----------------------------------------------------
    def _run(self):
        while not self._stop_evt.wait(self.poll_s):
            try:
                self._tick()
            except Exception as e:
                # supervision must outlive any one bad tick (a torn
                # endpoint file, a scrape hiccup); the next tick
                # retries — but a PERSISTENT fault must not leave the
                # fleet silently unsupervised, so it surfaces in
                # fleet.log (rate-limited, and itself guarded)
                _profiler.bump_counter("fleet_reconcile_errors")
                now = time.monotonic()
                if now - self._last_tick_err > 5.0:
                    self._last_tick_err = now
                    try:
                        self.log.event("tick_error", error=repr(e))
                    except Exception:
                        pass
                continue

    def _tick(self):
        now = time.monotonic()
        _chaos.maybe_kill_controller(now - self._boot_mono)
        with self._lock:
            replicas = list(self._replicas.values())
        for r in replicas:
            if r.state == "exited":
                continue
            rc = r.proc.poll()
            if rc is not None:
                self._on_exit(r, rc)
                continue
            if r.state == "starting":
                self._check_ready(r, now)
            elif r.state == "ready":
                self._check_hang(r, now)
            elif r.state == "draining":
                if now - r.drain_t > self.drain_grace_s:
                    # the gateway's drain never ended: stop waiting
                    self._kill(r)
        self._reconcile(now)
        if self.autoscale and not self._rollout and now >= self._next_scale_t:
            self._next_scale_t = now + self.scale_interval_s
            self._autoscale_tick()
        # refresh the controller lease (and let the journal absorb any
        # pool churn the transitions above didn't force out)
        if now - self._last_journal_t >= self.lease_interval_s:
            self._journal()

    def _on_exit(self, r, rc):
        with self._lock:
            if r.state == "exited":
                return
            was = r.state
            self._reap_locked(r, rc=rc)
            if was != "draining" and r.version == self.version:
                # the hole this crash tore in the CURRENT pool: only
                # spawns that fill it are "replacements" subject to the
                # crash backoff/budget — scale-up growth is not
                self._crash_deficit += 1
        if was != "draining":
            _profiler.bump_counter("fleet_replica_crashes")
            self.crashes += 1
            self.log.event("replica_crash", replica=r.id, returncode=rc,
                           version=r.version)
            if r.version != self.version:
                # a rollout-version replica dying during warmup is
                # deploy()'s failure, surfaced to ITS caller — it must
                # not escalate the serving pool's backoff or burn the
                # budget that gates replacing the STABLE version
                # (repeated bad deploys would otherwise latch _gaveup
                # on a pool that was never unstable)
                return
            self._pool_crashes += 1
            # exponential backoff before the replacement spawn, jittered
            # so a fleet-wide outage doesn't respawn in lockstep
            delay = min(
                self.restart_backoff_s
                * (2.0 ** min(self._pool_crashes - 1, 5)),
                30.0,
            ) * (0.5 + 0.5 * self._rng.random())
            self._backoff_until = max(self._backoff_until,
                                      time.monotonic() + delay)
        # the pool and the crash ledger both changed: a controller that
        # dies right after must not re-adopt a replica it reaped (or
        # forget the budget this crash burned)
        self._journal()

    def _update_peers_locked(self):
        """Atomically rewrite the KV peers file from the ready prefill
        pool (caller holds the lock). Decode replicas re-read it per
        pull, so a prefill member joining or dying propagates without
        restarting anyone."""
        peers = [
            {"id": r.id, "host": self.host,
             "port": (r.endpoint or {}).get("gateway_port")}
            for r in self._replicas.values()
            if r.role == "prefill" and r.state == "ready"
            and (r.endpoint or {}).get("gateway_port")
        ]
        tmp = "%s.tmp.%d" % (self._peers_file, os.getpid())
        try:
            with open(tmp, "w") as f:
                json.dump({"peers": peers}, f, sort_keys=True)
            os.replace(tmp, self._peers_file)
        except OSError:
            pass

    def _reap_locked(self, r, rc=None):
        self.router.remove_backend(r.id)
        r.state = "exited"
        if r.role == "prefill":
            self._update_peers_locked()
        self.log.event(
            "replica_exit", replica=r.id,
            returncode=r.proc.poll() if rc is None else rc,
            ready_replicas=self._ready_locked(),
        )

    def _check_ready(self, r, now):
        if r.endpoint is None:
            r.endpoint = _read_json(r.endpoint_file)
        ep = r.endpoint
        if ep and ep.get("gateway_port"):
            if self._probe_readyz(ep["gateway_port"]):
                ready_ms = (now - r.spawn_t) * 1e3
                with self._lock:
                    if r.state != "starting":
                        return
                    r.state = "ready"
                    if r.role == "prefill":
                        # prefill replicas serve the fleet-internal
                        # /v1/kv/prefill endpoint only — never client
                        # traffic through the router
                        self._update_peers_locked()
                    else:
                        self.router.add_backend(
                            r.id, self.host, ep["gateway_port"],
                            version=r.version, ready=True,
                        )
                _profiler.bump_histogram("fleet_replica_ready_ms",
                                         ready_ms)
                self.log.event(
                    "replica_ready", replica=r.id, version=r.version,
                    ready_ms=round(ready_ms, 1),
                    gateway_port=ep["gateway_port"],
                    metrics_port=ep.get("metrics_port"),
                    ready_replicas=self._ready_locked(),
                )
                self._write_report()
                return
        if now - r.spawn_t > self.ready_timeout_s:
            self.log.event("replica_hang", replica=r.id,
                           phase="startup",
                           stale_s=round(now - r.spawn_t, 1))
            _profiler.bump_counter("fleet_replica_hangs")
            self._kill(r)  # the exit reaper turns this into a crash

    def _probe_readyz(self, port):
        # the router's shared probe (one definition of "ready"); short
        # timeout — this runs serially per STARTING replica on the
        # supervision tick, and an accepting-but-wedged gateway must
        # not stall crash detection for the rest of the pool
        from .router import probe_readyz

        return probe_readyz(self.host, port, timeout=0.5)

    def _lease_expired(self, r):
        """Replica-lease watch: a serving replica re-stamps
        ``lease_ts`` in its endpoint file every lease interval; a stamp
        older than ``lease_ttl_s`` means the process is alive but its
        serve loop stopped turning — kill it so reconcile replaces it.
        Replicas that never stamped a lease (custom replica_cmd) are
        exempt; a torn/unreadable endpoint file is stale-until-
        rewritten, never an expiry verdict."""
        if self.lease_ttl_s <= 0:
            return False
        ep = _read_json(r.endpoint_file)
        if isinstance(ep, dict):
            r.endpoint = ep
        ep = r.endpoint
        if not isinstance(ep, dict) or "lease_ts" not in ep:
            return False
        try:
            age = time.time() - float(ep["lease_ts"])
        except (TypeError, ValueError):
            return False
        if age <= self.lease_ttl_s:
            return False
        _profiler.bump_counter("fleet_lease_expiries")
        self.log.event("replica_lease_expired", replica=r.id,
                       age_s=round(age, 2))
        self._kill(r)  # the exit reaper turns this into a crash
        return True

    def _check_hang(self, r, now):
        """Supervisor-style staleness watch over the replica heartbeat
        file. A replica that never beats (a custom replica_cmd without
        the hook) is unobservable — exit/ready checks still cover it."""
        if self._lease_expired(r):
            return
        hb = _supervisor.read_heartbeat(r.hb_file)
        if hb is None:
            return
        seen = r.hb_seen
        if seen is None or seen[0] != hb["mtime"]:
            r.hb_seen = (hb["mtime"], now)
            return
        if now - seen[1] > self.heartbeat_timeout_s:
            self.log.event(
                "replica_hang", replica=r.id, phase="serve",
                stale_s=round(now - seen[1], 1),
            )
            _profiler.bump_counter("fleet_replica_hangs")
            self._kill(r)

    def _reconcile(self, now):
        """Drive the pool of the SERVING version toward the target.
        Rollout-version replicas are deploy()'s to manage; old-version
        stragglers mid-rollout are already draining. A deficit is
        split into crash REPLACEMENTS (throttled by the crash
        backoff/budget) and scale-up GROWTH (a healthy fleet's target
        raise must never be gated — or permanently blocked after a
        giveup — by an old crash streak)."""
        with self._lock:
            live = [r for r in self._replicas.values()
                    if r.version == self.version
                    and r.state in ("starting", "ready")]
            deficit = self.target - len(live)
            # a target lowered past a pending crash hole absorbs it
            self._crash_deficit = min(self._crash_deficit,
                                      max(0, deficit))
            if deficit > 0:
                growth = deficit - self._crash_deficit
                for _ in range(growth):
                    self._spawn(self.version, self.model_dir)
                if not self._crash_deficit:
                    return
                if self._gaveup or now < self._backoff_until:
                    return
                # the budget counts SERVING-pool crashes only (rollout
                # warmup failures are deploy()'s to report)
                if self._pool_crashes > self.max_replica_restarts:
                    self._gaveup = True
                    self.log.event(
                        "giveup", crashes=self._pool_crashes,
                        max_replica_restarts=self.max_replica_restarts,
                    )
                    # journal the latched giveup: a restart must not
                    # grant a crash-looping pool a fresh budget
                    self._journal()
                    return
                for _ in range(self._crash_deficit):
                    self._spawn(self.version, self.model_dir,
                                replacement=True)
                self._crash_deficit = 0
            elif deficit < 0:
                # drain the newest first: the oldest replicas have the
                # warmest caches and the longest uptime record
                ready = sorted(
                    (r for r in live if r.state == "ready"),
                    key=lambda r: -r.id,
                )
                for r in ready[:-deficit]:
                    self._begin_drain(r, reason="scale_down")

    # -- autoscaler ----------------------------------------------------------
    def _autoscale_tick(self):
        samples = self._scrape_samples()
        new_target, reason = self.policy.observe(samples, self.target)
        if new_target != self.target:
            self.scale_to(new_target, reason=reason or "autoscale")

    def _scrape_samples(self):
        with self._lock:
            targets = [
                (r, (r.endpoint or {}).get("metrics_port"))
                for r in self._replicas.values()
                if r.state == "ready" and r.version == self.version
            ]
        # scrape CONCURRENTLY (same reasoning as the router's health
        # sweep): one wedged replica burning its scrape timeout on the
        # single supervision thread would delay crash detection and
        # drain-grace kills for the whole pool
        samples = []
        s_lock = threading.Lock()

        def one(r, port):
            parsed = self._scrape(port)
            if parsed is None:
                return
            queue = (
                parsed.get(("serving_queue_depth", ""), 0.0)
                + parsed.get(("decode_queue_depth", ""), 0.0)
            )
            shed_total = (
                parsed.get(("serving_shed_overload", ""), 0.0)
                + parsed.get(("gateway_shed_admission", ""), 0.0)
            )
            shed_delta = max(0.0, shed_total - r.shed_seen)
            r.shed_seen = shed_total
            p95 = parsed.get(("serving_latency_ms", 'quantile="0.95"'))
            with s_lock:
                samples.append({
                    "replica": r.id,
                    "queue_depth": queue,
                    "shed_delta": shed_delta,
                    "p95_ms": p95,
                    # decode-engine latency SLIs (None until the replica
                    # has served traffic) — what SLOPolicy budgets
                    # against; AutoscalerPolicy ignores the extra keys
                    "ttft_p95_ms": parsed.get(
                        ("decode_ttft_ms", 'quantile="0.95"')),
                    "intertoken_p95_ms": parsed.get(
                        ("decode_intertoken_ms", 'quantile="0.95"')),
                })

        scrapers = []
        for r, port in targets:
            if not port:
                continue
            t = threading.Thread(target=one, args=(r, port), daemon=True)
            t.start()
            scrapers.append(t)
        for t in scrapers:
            t.join(timeout=2.0)
        with s_lock:
            # a copy: a straggler past the join appends into the
            # discarded original, never into a consumed round
            return list(samples)

    def _scrape(self, port):
        try:
            with urllib.request.urlopen(
                "http://%s:%d/metrics" % (self.host, port), timeout=1.5
            ) as resp:
                return _obs_registry.parse_prometheus(
                    resp.read().decode("utf-8")
                )
        except Exception:
            return None

    # -- reporting -----------------------------------------------------------
    def _write_report(self, force=False):
        """Best-effort fleet_report.json — reporting failures must
        never take down supervision, and the rebuild (a full fleet.log
        + snapshot re-parse) is throttled so event bursts on the tick
        thread don't delay crash detection; ``force`` (stop, rollout
        boundaries) always writes."""
        now = time.monotonic()
        if not force and now - self._last_report_t < 5.0:
            return
        self._last_report_t = now
        try:
            from ..observability import aggregate as _aggregate

            _aggregate.write_fleet_report(
                self.workdir, obs_root=self._obs_root
            )
        except Exception:
            pass
