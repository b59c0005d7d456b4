"""Simulated replica: empirical service-time model + slot occupancy.

``ServiceModel.fit`` distils recorded journeys into per-priority-class
empirical pools of TTFT and inter-token latencies; the simulator then
*resamples* those pools (bootstrap-style) instead of assuming a
parametric distribution — the simulated day inherits the real day's
tail shape.  ``SimReplica`` is the queueing model the virtual clock
drives: a fixed slot pool with interactive-first, preempted-first
dequeue order mirroring the real engine's scheduler, plus the rolling
SLI windows that feed ``scrape_sample`` — the SAME dict shape
``FleetController._scrape_samples`` produces, so the real
AutoscalerPolicy / SLOPolicy run against it unmodified.
"""

from __future__ import annotations

import collections

import numpy as np

from ...observability import registry as _registry

__all__ = ["ServiceModel", "SimReplica"]

_CLASSES = ("interactive", "batch")

# conservative fixed defaults when no recording (or an empty class pool)
# is available to fit against: ~60ms to first token, ~25ms/token after.
_DEFAULT_TTFT_MS = 60.0
_DEFAULT_INTERTOKEN_MS = 25.0


class ServiceModel(object):
    """Per-class empirical (TTFT, inter-token) latency pools."""

    def __init__(self, ttft_ms=None, intertoken_ms=None):
        # {cls: [samples...]} — missing/empty classes fall back to the
        # pooled samples, then to the fixed defaults.
        self.ttft_ms = dict(ttft_ms or {})
        self.intertoken_ms = dict(intertoken_ms or {})

    @classmethod
    def fit(cls, journeys):
        """Fit from journey records: ``ttft_ms`` is recorded directly;
        inter-token is ``(ms - ttft_ms) / max(tokens - 1, 1)`` — the
        stream's mean decode cadence.  A journey with a duration but no
        ``ttft_ms`` (a non-streaming /v1/infer request) is a single-shot
        service: its whole ``ms`` joins the TTFT pool — replayed as
        one token, its service time is exactly the recorded one."""
        ttft = {c: [] for c in _CLASSES}
        inter = {c: [] for c in _CLASSES}
        for j in journeys or []:
            c = "batch" if j.get("priority") == "batch" else "interactive"
            try:
                t = j.get("ttft_ms")
                ms = j.get("ms")
                toks = j.get("tokens")
            except AttributeError:
                continue
            if t is not None and float(t) > 0:
                ttft[c].append(float(t))
                if ms is not None and toks and float(ms) >= float(t):
                    inter[c].append(
                        (float(ms) - float(t)) / max(float(toks) - 1.0, 1.0)
                    )
            elif ms is not None and float(ms) > 0 and not toks:
                ttft[c].append(float(ms))
        return cls(ttft, inter)

    def _pool(self, table, cls):
        pool = table.get(cls)
        if pool:
            return pool
        merged = [v for vs in table.values() for v in vs]
        return merged or None

    def sample_ttft_ms(self, cls, rng):
        pool = self._pool(self.ttft_ms, cls)
        if pool is None:
            return _DEFAULT_TTFT_MS
        return float(pool[int(rng.randint(0, len(pool)))])

    def sample_intertoken_ms(self, cls, rng):
        pool = self._pool(self.intertoken_ms, cls)
        if pool is None:
            return _DEFAULT_INTERTOKEN_MS
        return float(pool[int(rng.randint(0, len(pool)))])

    def as_dict(self):
        out = {}
        for label, table in (("ttft_ms", self.ttft_ms),
                             ("intertoken_ms", self.intertoken_ms)):
            for c in _CLASSES:
                out["%s_%s" % (label, c)] = _registry.percentiles(
                    table.get(c) or [])
        return out


class _SimJob(object):
    __slots__ = ("req", "remaining", "preempted", "enq_t", "start_t",
                 "first_token_t", "intertoken_s")

    def __init__(self, req, now):
        self.req = req
        self.remaining = int(req["max_new_tokens"])
        self.preempted = False
        self.enq_t = float(now)
        self.start_t = None
        self.first_token_t = None
        self.intertoken_s = None


class SimReplica(object):
    """One simulated replica: slot pool + pending queue + SLI windows.

    The simulator owns the clock; the replica only answers "which job
    runs next" and "when does this slot produce its next token", and
    accumulates the rolling windows ``scrape_sample`` summarises.
    """

    def __init__(self, replica_id, model, slots=4, queue_depth=64,
                 window=256):
        self.id = str(replica_id)
        self.model = model
        self.slots = int(slots)
        self.queue_depth = int(queue_depth)
        self.pending = []          # [_SimJob] — dequeue via _dequeue()
        self.active = {}           # slot_idx -> _SimJob
        self.free = list(range(self.slots))
        self.shed_total = 0
        self.completed = 0
        self.preemptions = 0
        self._ttft_win = collections.deque(maxlen=int(window))
        self._inter_win = collections.deque(maxlen=int(window))
        self._lat_win = collections.deque(maxlen=int(window))

    # -- queueing ----------------------------------------------------

    def enqueue(self, req, now):
        """Admit a request to the pending queue; False = shed (full)."""
        if len(self.pending) >= self.queue_depth:
            self.shed_total += 1
            return None
        job = _SimJob(req, now)
        self.pending.append(job)
        return job

    def _dequeue(self):
        """Interactive before batch, preempted replays first within a
        class, FIFO within a tenant — the real engine's dequeue order."""
        if not self.pending:
            return None
        best_i = 0
        best_key = None
        for i, job in enumerate(self.pending):
            key = (0 if job.req["priority"] != "batch" else 1,
                   0 if job.preempted else 1, i)
            if best_key is None or key < best_key:
                best_key, best_i = key, i
        return self.pending.pop(best_i)

    def start_next(self, now, rng):
        """Bind the next pending job to a free slot; returns
        ``(slot_idx, job, first_event_dt_s)`` or None."""
        if not self.free or not self.pending:
            return None
        job = self._dequeue()
        if job is None:
            return None
        slot = self.free.pop()
        self.active[slot] = job
        job.start_t = now
        cls = job.req["priority"]
        if job.preempted:
            # re-prefill of prompt+emitted: charge a fresh TTFT-shaped
            # delay but do NOT re-stamp first_token_t (SLI stays honest,
            # same as the real engine's ttft_ms guard).
            dt = self.model.sample_ttft_ms(cls, rng) / 1e3
        else:
            dt = self.model.sample_ttft_ms(cls, rng) / 1e3
        job.intertoken_s = max(
            1e-4, self.model.sample_intertoken_ms(cls, rng) / 1e3)
        return slot, job, max(1e-4, dt)

    def preempt_for_interactive(self, now):
        """If interactive waits with no free slot, evict the cheapest
        active batch job back to pending; returns the evicted slot."""
        if self.free:
            return None
        if not any(j.req["priority"] != "batch" for j in self.pending):
            return None
        victims = [(j.remaining, s) for s, j in self.active.items()
                   if j.req["priority"] == "batch"]
        if not victims:
            return None
        _, slot = min(victims)
        job = self.active.pop(slot)
        job.preempted = True
        self.preemptions += 1
        self.free.append(slot)
        self.pending.insert(0, job)
        return slot

    def on_token(self, slot, now):
        """Advance the job in ``slot`` by one emitted token; returns
        ``('token', dt)`` or ``('done', None)``."""
        job = self.active.get(slot)
        if job is None:
            return None
        if job.first_token_t is None:
            job.first_token_t = now
            self._ttft_win.append((now - job.enq_t) * 1e3)
        else:
            self._inter_win.append(job.intertoken_s * 1e3)
        job.remaining -= 1
        if job.remaining <= 0:
            self.active.pop(slot)
            self.free.append(slot)
            self.completed += 1
            self._lat_win.append((now - job.enq_t) * 1e3)
            return ("done", None)
        return ("token", job.intertoken_s)

    # -- SLI scrape --------------------------------------------------

    def queue_len(self):
        return len(self.pending)

    def scrape_sample(self, shed_seen):
        """The dict shape FleetController._scrape_samples emits — the
        real policies consume this unmodified.  ``shed_seen`` is the
        caller-held previous shed total (delta semantics preserved);
        returns ``(sample, new_shed_seen)``."""
        shed_delta = max(0, self.shed_total - int(shed_seen))
        ttft = _registry.percentiles(list(self._ttft_win))
        inter = _registry.percentiles(list(self._inter_win))
        lat = _registry.percentiles(list(self._lat_win))
        sample = {
            "replica": self.id,
            "queue_depth": float(len(self.pending)),
            "shed_delta": float(shed_delta),
            "p95_ms": lat.get("p95"),
            "ttft_p95_ms": ttft.get("p95"),
            "intertoken_p95_ms": inter.get("p95"),
        }
        return sample, self.shed_total
