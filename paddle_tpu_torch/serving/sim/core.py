"""FleetSim — discrete-event replay of a fleet day on a virtual clock.

The simulator is the promotion gate for control-plane changes: it feeds
a recorded (or synthetic) request tape through the REAL policy classes
— ``AutoscalerPolicy`` / ``SLOPolicy`` via ``make_policy``, the
gateway's ``_Admission`` (rate limits, quotas, priority-ordered
waiting), and the ``Router``'s least-inflight/breaker ``_pick`` — all
constructed with the sim's virtual clock injected, against
``SimReplica`` service models fit from the same flight recordings.  No
subprocesses, no sockets, no wall-clock reads: a whole recorded day
replays in seconds and two runs with the same seed produce identical
reports byte-for-byte.

Event loop: a single heap of ``(time, seq, kind, payload)`` tuples —
``seq`` breaks ties deterministically.  Kinds:

- ``arrival``  a request enters: route (Router._pick) → admission
  (try_admit) → replica queue, or shed / virtual park.
- ``kick``     try binding pending jobs to free slots (with batch
  preemption when interactive waits).
- ``token``    a slot emits one token (TTFT on the first).
- ``deadline`` a parked admission times out → shed "overload".
- ``policy``   one autoscaler tick over scraped samples.
- ``ready``    a scaled-up replica turns ready and joins the router.
"""

from __future__ import annotations

import heapq

import numpy as np

from ...fluid import flags as _flags
from ...observability import registry as _registry
from ..fleet import make_policy
from ..gateway import _Admission, _AdmissionDenied
from ..router import Router
from .replica import ServiceModel, SimReplica

__all__ = ["FleetSim"]

REPORT_SCHEMA_VERSION = 1


class _SimReplicaHandle(object):
    """One replica's sim-side bundle: the queueing model, its own
    admission controller (per-replica gateway front door), the parked
    virtual waiters, and scrape bookkeeping."""

    __slots__ = ("id", "replica", "admission", "waiters", "shed_seen",
                 "draining", "backend", "granting")

    def __init__(self, rid, replica, admission):
        self.id = str(rid)
        self.replica = replica
        self.admission = admission
        self.waiters = []   # [(deadline_t, seq, req, backend)] parked
        self.shed_seen = 0
        self.draining = False
        self.backend = None
        self.granting = False   # _grant_waiters reentrancy guard


class FleetSim(object):
    def __init__(self, workload, model=None, policy=None, seed=0,
                 slots=4, queue_depth=64, min_replicas=None,
                 max_replicas=None, scale_interval_s=None,
                 rate_rps=0.0, burst=1, tenant_max_inflight=0,
                 max_inflight=None, admit_timeout_ms=2000.0,
                 replica_ready_s=None):
        self.workload = sorted(workload or [],
                               key=lambda r: (r["arrival_s"],
                                              r["request_id"]))
        self.model = model or ServiceModel()
        self.policy = policy or make_policy(min_replicas=min_replicas,
                                            max_replicas=max_replicas)
        self.seed = int(seed)
        self.rng = np.random.RandomState(self.seed)
        self.slots = int(slots)
        self.queue_depth = int(queue_depth)
        self.scale_interval_s = float(
            scale_interval_s
            if scale_interval_s is not None
            else _flags.get_flag("fleet_scale_interval_s", 2.0))
        self.replica_ready_s = float(
            replica_ready_s
            if replica_ready_s is not None
            else _flags.get_flag("sim_replica_ready_s", 5.0))
        # per-replica admission knobs (a replica gateway's front door);
        # max_inflight defaults to slots + queue_depth — the engine can
        # actually hold that many
        self._admit_args = (float(rate_rps), int(burst),
                            int(tenant_max_inflight),
                            int(max_inflight if max_inflight is not None
                                else self.slots + self.queue_depth),
                            float(admit_timeout_ms))
        # virtual clock — everything (router breakers, admission
        # deadlines/buckets, service events) reads THIS
        self.now = 0.0
        self._clock = lambda: self.now
        self.router = Router(port=0, clock=self._clock)
        self._heap = []
        self._seq = 0
        self._handles = {}
        self._next_rid = 0
        self._target = self.policy.min_replicas
        self._pending_ready = 0    # replicas scaled up but not ready yet
        # accounting
        self.injected = 0
        self.completed = 0
        self.shed = {}
        self._arrivals = []        # run() fills this from the workload
        self._inflight = {}        # request_id -> (handle, backend, req)
        self._done_rows = []       # per-request completion facts
        self.replica_trajectory = []   # [(t, ready_count)]
        self.target_trajectory = []    # [(t, target, reason)]

    # -- event plumbing ----------------------------------------------

    def _push(self, t, kind, payload):
        self._seq += 1
        heapq.heappush(self._heap, (float(t), self._seq, kind, payload))

    def _shed(self, reason):
        self.shed[reason] = self.shed.get(reason, 0) + 1

    # -- replica lifecycle -------------------------------------------

    def _spawn_replica(self, ready_at):
        rid = "sim-%d" % self._next_rid
        self._next_rid += 1
        h = _SimReplicaHandle(
            rid,
            SimReplica(rid, self.model, slots=self.slots,
                       queue_depth=self.queue_depth),
            _Admission(*self._admit_args, clock=self._clock),
        )
        self._handles[rid] = h
        self._push(ready_at, "ready", rid)
        return h

    def _ready_count(self):
        return sum(1 for h in self._handles.values() if not h.draining
                   and h.backend is not None)

    def _on_ready(self, rid):
        h = self._handles.get(rid)
        if h is None or h.draining:
            return
        self._pending_ready = max(0, self._pending_ready - 1)
        h.backend = self.router.add_backend(rid, "sim", 0, ready=True)

    def _drain_replica(self):
        """Scale-down: newest ready replica stops taking new work; it
        disappears once its queue and slots empty."""
        ready = [h for h in self._handles.values()
                 if h.backend is not None and not h.draining]
        if not ready:
            return
        h = max(ready, key=lambda x: int(x.id.rsplit("-", 1)[1]))
        h.draining = True
        self.router.remove_backend(h.id)
        self._maybe_reap(h)

    def _maybe_reap(self, h):
        if (h.draining and not h.replica.active and not h.replica.pending
                and not h.waiters):
            self._handles.pop(h.id, None)

    # -- request flow ------------------------------------------------

    def _on_arrival(self, req):
        self.injected += 1
        b = self.router._pick()
        if b is None:
            self._shed("no_backend")
            return
        h = self._handles.get(b.id)
        if h is None or h.draining:
            self.router._release(b)
            self._shed("no_backend")
            return
        try:
            verdict = h.admission.try_admit(req["tenant"], req["priority"])
        except _AdmissionDenied as e:
            self.router._note_success(b)   # the replica answered (429)
            self.router._release(b)
            self._shed(e.reason)
            # the live gateway's 429 counter feeds THIS replica's scrape
            # (shed_delta is what arms the autoscaler) — mirror it
            h.replica.shed_total += 1
            return
        if verdict == "wait":
            h.admission.note_wait_start(req["priority"])
            deadline = self.now + h.admission.admit_timeout_s
            self._seq += 1
            h.waiters.append((deadline, self._seq, req, b))
            self._push(deadline, "deadline", (h.id, req["request_id"]))
            return
        self._admitted(h, b, req)

    def _admitted(self, h, b, req):
        job = h.replica.enqueue(req, self.now)
        if job is None:             # engine queue full → shed at entry
            h.admission.release(req["tenant"])
            self.router._note_success(b)
            self.router._release(b)
            self._shed("overload")
            self._grant_waiters(h)
            return
        self._inflight[req["request_id"]] = (h, b, req)
        self._push(self.now, "kick", h.id)

    def _grant_waiters(self, h):
        """Capacity freed on ``h``: retry parked admissions, interactive
        class first, FIFO within a class — the class ordering the real
        ``_Admission`` wake path enforces (its cap check parks batch
        while any interactive waiter exists, so the first "wait" verdict
        means every later waiter would wait too)."""
        if h.granting:
            return          # _admitted below can recurse via a shed
        h.granting = True
        try:
            while h.waiters:
                h.waiters.sort(key=lambda w: (
                    0 if w[2]["priority"] != "batch" else 1, w[1]))
                _deadline, _seq, req, b = h.waiters[0]
                try:
                    verdict = h.admission.try_grant(req["tenant"],
                                                    req["priority"])
                except _AdmissionDenied as e:
                    h.waiters.pop(0)
                    h.admission.note_wait_end(req["priority"])
                    self.router._note_success(b)
                    self.router._release(b)
                    self._shed(e.reason)
                    h.replica.shed_total += 1
                    continue
                if verdict == "wait":
                    break
                h.waiters.pop(0)
                h.admission.note_wait_end(req["priority"])
                self._admitted(h, b, req)
        finally:
            h.granting = False

    def _on_deadline(self, hid, request_id):
        h = self._handles.get(hid)
        if h is None:
            return
        for i, (deadline, _seq, req, b) in enumerate(h.waiters):
            if req["request_id"] == request_id:
                if deadline > self.now + 1e-9:
                    return          # was re-parked later (not possible
                                    # today, but keep the guard cheap)
                del h.waiters[i]
                h.admission.note_wait_end(req["priority"])
                self.router._note_success(b)
                self.router._release(b)
                self._shed("overload")
                h.replica.shed_total += 1
                self._maybe_reap(h)
                return

    def _on_kick(self, hid):
        h = self._handles.get(hid)
        if h is None:
            return
        r = h.replica
        # priority preemption, mirroring the engine: interactive parked
        # in the replica queue with no free slot evicts a batch slot
        if _flags.get_flag("sched_preempt", True):
            r.preempt_for_interactive(self.now)
        while True:
            bound = r.start_next(self.now, self.rng)
            if bound is None:
                break
            slot, job, dt = bound
            self._push(self.now + dt, "token", (hid, slot, id(job)))

    def _on_token(self, hid, slot, job_tag):
        h = self._handles.get(hid)
        if h is None:
            return
        job = h.replica.active.get(slot)
        if job is None or id(job) != job_tag:
            return                  # slot was preempted/rebound — the
                                    # new binding scheduled its own event
        out = h.replica.on_token(slot, self.now)
        if out is None:
            return
        kind, dt = out
        if kind == "token":
            self._push(self.now + dt, "token", (hid, slot, job_tag))
            return
        # done: full completion accounting + capacity handback
        req = job.req
        row = self._inflight.pop(req["request_id"], None)
        if row is not None:
            rh, b, _ = row
            rh.admission.release(req["tenant"])
            self.router._note_success(b)
            self.router._release(b)
        self.completed += 1
        self._done_rows.append({
            "priority": req["priority"],
            "tenant": req["tenant"],
            "ttft_ms": ((job.first_token_t - job.enq_t) * 1e3
                        if job.first_token_t is not None else None),
            "ms": (self.now - job.enq_t) * 1e3,
            "preempted": bool(job.preempted),
        })
        self._grant_waiters(h)
        self._push(self.now, "kick", hid)
        self._maybe_reap(h)

    # -- autoscaling -------------------------------------------------

    def policy_tick(self, samples):
        """One policy round over ``samples`` — the SINGLE code path the
        parity tests drive directly: observe → clamp → apply."""
        target, reason = self.policy.observe(samples, self._target)
        if target != self._target or reason is not None:
            self.target_trajectory.append(
                (round(self.now, 6), int(target), reason))
        self._target = target
        live = self._ready_count() + self._pending_ready
        while live < self._target:
            self._spawn_replica(self.now + self.replica_ready_s)
            self._pending_ready += 1
            live += 1
        while live > self._target and self._ready_count() > 0:
            self._drain_replica()
            live -= 1
        return target, reason

    def _on_policy(self):
        samples = []
        for h in sorted(self._handles.values(), key=lambda x: x.id):
            if h.backend is None or h.draining:
                continue
            sample, h.shed_seen = h.replica.scrape_sample(h.shed_seen)
            samples.append(sample)
        self.policy_tick(samples)
        self.replica_trajectory.append(
            (round(self.now, 6), self._ready_count()))
        if self._work_remains():
            self._push(self.now + self.scale_interval_s, "policy", None)

    def _work_remains(self):
        if self._inflight or self._arrivals:
            return True
        return any(h.waiters or h.replica.pending or h.replica.active
                   for h in self._handles.values())

    # -- run ---------------------------------------------------------

    def run(self, max_events=2_000_000):
        """Replay the tape to completion; returns the report dict."""
        self._arrivals = list(self.workload)
        self._arrivals.reverse()    # pop() from the front, cheaply
        for _ in range(self.policy.min_replicas):
            self._spawn_replica(self.now)   # initial pool: ready at t=0
            self._pending_ready += 1
        self._push(0.0, "policy", None)
        events = 0
        while self._heap or self._arrivals:
            # feed arrivals into the heap lazily so a 100x tape does
            # not balloon the heap up front
            while self._arrivals and (
                    not self._heap
                    or self._arrivals[-1]["arrival_s"] <= self._heap[0][0]):
                req = self._arrivals.pop()
                self._push(req["arrival_s"], "arrival", req)
            if not self._heap:
                break
            t, _seq, kind, payload = heapq.heappop(self._heap)
            self.now = max(self.now, t)
            if kind == "arrival":
                self._on_arrival(payload)
            elif kind == "kick":
                self._on_kick(payload)
            elif kind == "token":
                self._on_token(*payload)
            elif kind == "deadline":
                self._on_deadline(*payload)
            elif kind == "ready":
                self._on_ready(payload)
                self._push(self.now, "kick", payload)
            elif kind == "policy":
                self._on_policy()
            events += 1
            if events >= int(max_events):
                break
        return self.report()

    # -- report ------------------------------------------------------

    def report(self):
        shed_total = sum(self.shed.values())
        by_class = {"interactive": {"ttft_ms": [], "ms": []},
                    "batch": {"ttft_ms": [], "ms": []}}
        preempted_done = 0
        for row in self._done_rows:
            c = by_class[row["priority"]]
            if row["ttft_ms"] is not None:
                c["ttft_ms"].append(row["ttft_ms"])
            c["ms"].append(row["ms"])
            preempted_done += 1 if row["preempted"] else 0
        classes = {}
        for cls, pools in sorted(by_class.items()):
            classes[cls] = {
                "ttft_ms": _registry.percentiles(pools["ttft_ms"]),
                "latency_ms": _registry.percentiles(pools["ms"]),
            }
        return {
            "schema_version": REPORT_SCHEMA_VERSION,
            "seed": self.seed,
            "policy": type(self.policy).__name__,
            "virtual_s": round(self.now, 6),
            "requests": {
                "injected": self.injected,
                "completed": self.completed,
                "shed": shed_total,
                "shed_by_reason": dict(sorted(self.shed.items())),
                "incomplete": self.injected - self.completed - shed_total,
            },
            "preemptions": sum(h.replica.preemptions
                               for h in self._handles.values()),
            "completed_after_preemption": preempted_done,
            "classes": classes,
            "replica_trajectory": list(self.replica_trajectory),
            "target_trajectory": list(self.target_trajectory),
            "final_target": int(self._target),
        }
