"""Workload sources for the fleet simulator.

Two ways to produce the request tape the simulator replays:

- ``from_journeys`` turns recorded flight-recorder journeys (the JSONL
  schema from ``observability.flight.to_journey``) back into arrival
  events, optionally scale-replicated (10x/100x the recorded day) with
  seeded arrival jitter so the copies don't land on one virtual instant.
- ``synthetic_workload`` fabricates a day from shape parameters:
  a flat/diurnal/flash-crowd rate curve, tenant skew, and an
  interactive/batch mix — for what-if trials no recording covers.

Every request is a plain dict (a "request record"), sortable by arrival
time; all randomness flows through one ``numpy.random.RandomState`` so
a fed seed makes the whole tape — and therefore the whole simulation —
deterministic.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["from_journeys", "synthetic_workload"]


def _request(arrival_s, tenant, priority, prompt_tokens, max_new_tokens,
             request_id):
    return {
        "arrival_s": float(max(0.0, arrival_s)),
        "tenant": str(tenant or "anon"),
        "priority": "batch" if priority == "batch" else "interactive",
        "prompt_tokens": int(max(1, prompt_tokens)),
        "max_new_tokens": int(max(1, max_new_tokens)),
        "request_id": str(request_id),
    }


def from_journeys(journeys, scale=1.0, seed=0):
    """Convert journey records into a sorted request tape.

    Arrival time is reconstructed as ``ts - ms/1e3`` (the journey stamps
    completion) and normalised so the earliest arrival is t=0.  With
    ``scale`` > 1 each journey is replicated ``round(scale)`` times with
    seeded jitter of up to one recorded-span second, modelling "the same
    day at Nx volume" without N identical simultaneous arrivals.
    """
    rng = np.random.RandomState(int(seed))
    copies = max(1, int(round(float(scale))))
    raw = []
    for j in journeys:
        try:
            ts = float(j.get("ts") or 0.0)
            ms = float(j.get("ms") or 0.0)
        except (TypeError, ValueError):
            continue
        tokens = j.get("tokens")
        raw.append((ts - ms / 1e3, j, tokens))
    if not raw:
        return []
    t0 = min(r[0] for r in raw)
    span = max(1.0, max(r[0] for r in raw) - t0)
    out = []
    for arrival, j, tokens in raw:
        base = arrival - t0
        # a journey that never counted tokens is a single-response
        # request (/v1/infer): one "token" whose service time is the
        # recorded duration — NOT a default-length generation
        n_new = int(tokens) if tokens else 1
        n_prompt = int(j.get("prompt_tokens") or 0) or max(
            1, int(j.get("cached_prefix_tokens") or 0)) or 8
        for c in range(copies):
            jitter = 0.0 if c == 0 else float(rng.uniform(0.0, span))
            out.append(_request(
                base + jitter, j.get("tenant"), j.get("priority"),
                n_prompt, n_new,
                "%s/%d" % (j.get("request_id") or "rec", c)))
    out.sort(key=lambda r: (r["arrival_s"], r["request_id"]))
    return out


def _rate_at(kind, t, duration_s, rps):
    """Requests/second of the shaped curve at virtual time ``t``."""
    if kind == "diurnal":
        # one full day-shaped sine over the duration: trough at the
        # edges, peak in the middle, never below 10% of nominal.
        phase = math.sin(math.pi * (t / max(1.0, duration_s)))
        return rps * max(0.1, phase)
    if kind == "flash":
        # flat baseline with a 10x flash crowd for the middle tenth.
        lo, hi = 0.45 * duration_s, 0.55 * duration_s
        return rps * (10.0 if lo <= t < hi else 1.0)
    # "skew" and "flat" keep a constant rate; skew shapes tenants below.
    return rps


def synthetic_workload(kind="flat", duration_s=600.0, rps=2.0, seed=0,
                       tenants=("tenant-a", "tenant-b", "tenant-c"),
                       batch_fraction=0.3, prompt_tokens=8,
                       max_new_tokens=12):
    """Fabricate a request tape: ``kind`` in flat|diurnal|skew|flash.

    Arrivals are a thinned Poisson process against the shaped rate
    curve; ``skew`` sends 80% of traffic to the first tenant (Zipf-ish
    hot tenant) while the others split the rest uniformly.
    """
    kind = str(kind or "flat")
    if kind not in ("flat", "diurnal", "skew", "flash"):
        raise ValueError("unknown synthetic workload kind: %r" % kind)
    rng = np.random.RandomState(int(seed))
    duration_s = float(duration_s)
    rps = float(rps)
    tenants = list(tenants) or ["anon"]
    if kind == "skew" and len(tenants) > 1:
        hot = [0.8] + [0.2 / (len(tenants) - 1)] * (len(tenants) - 1)
    else:
        hot = [1.0 / len(tenants)] * len(tenants)
    peak = rps * (10.0 if kind == "flash" else 1.0)
    out = []
    t = 0.0
    i = 0
    while True:
        # thinning: candidate arrivals at the peak rate, accepted with
        # probability rate(t)/peak — an exact non-homogeneous Poisson.
        t += float(rng.exponential(1.0 / max(1e-9, peak)))
        if t >= duration_s:
            break
        if rng.uniform() * peak > _rate_at(kind, t, duration_s, rps):
            continue
        tenant = tenants[int(rng.choice(len(tenants), p=hot))]
        prio = "batch" if rng.uniform() < batch_fraction else "interactive"
        n_p = max(1, int(rng.poisson(prompt_tokens)))
        n_new = max(1, int(rng.poisson(max_new_tokens)))
        out.append(_request(t, tenant, prio, n_p, n_new, "syn-%06d" % i))
        i += 1
    return out
