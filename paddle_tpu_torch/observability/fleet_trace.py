"""Fleet trace merge: N processes' /trace pulls -> ONE aligned timeline
(port of ``paddle_tpu/observability/fleet_trace.py``).

The reference's ``device_tracer`` correlated host and device events
inside one process via correlation ids; this module is that idea at
fleet scale. Each process (router/controller, every replica gateway +
engine) exports spans stamped with W3C ``trace_id``/``span_id``/
``parent_span_id`` (observability/trace.py) on its OWN monotonic clock.
The merge:

1. **pulls** every process's ``/trace`` payload (schema_version >= 2:
   carries a ``clock_anchor`` ``(ts, ts_mono)`` pair and the ``ts_base``
   its event timestamps are relative to) — over HTTP for live
   processes, from the on-disk black-box dump (``trace_rank_<r>.json``,
   written by the exporter's snapshot loop and teardown paths) for
   processes that died;
2. **aligns** clocks: each process's span times map through its anchor
   onto its wall clock, an NTP-style skew estimate (the process's
   reported wall time against the puller's request midpoint) corrects
   genuinely skewed wall clocks, and everything lands on the reference
   (controller) process's timeline;
3. **merges** into one Perfetto-loadable trace — one ``pid`` row per
   process, instants (the failover seam) preserved — and
4. **links** each trace_id's spans into a single tree: children chain
   to parents by span id ACROSS processes; spans whose parent never
   recorded (evicted from the bounded ring, or died with a SIGKILLed
   process mid-request) attach to a synthetic per-process root that
   itself hangs off the tree — orphans are marked and counted
   (``trace_orphan_spans``), never dropped. Shared-work spans (a
   batched dispatch / fused decode tick carrying a ``trace_ids`` list)
   join every tree they served. Requests whose tree connects spans
   from 2+ processes count ``trace_requests_linked``.

CLI::

    python -m paddle_tpu_torch.observability.fleet_trace \
        --endpoint controller=http://127.0.0.1:9100 \
        --endpoint replica0=http://127.0.0.1:9101 \
        --out fleet_trace.json

Load ``fleet_trace.json`` in https://ui.perfetto.dev — a request's
router span time-contains its gateway and engine spans across process
rows.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import time
import urllib.error
import urllib.request

from ..fluid import profiler as _profiler
from . import trace as _trace

__all__ = [
    "ProcessClock",
    "pull_trace",
    "load_trace_dump",
    "spans_of",
    "merge",
    "span_trees",
    "containment_violations",
    "write_merged",
]

_TRACE_DUMP = re.compile(r"^trace_rank_(\d+)\.json$")

# wall-clock skew below this is indistinguishable from pull latency on
# one host — applying it would ADD noise, not remove skew; above it the
# clock is genuinely off and the estimate wins
SKEW_TOLERANCE_S = 0.25


class ProcessClock(object):
    """Maps one process's span timestamps (its ``perf_counter`` clock)
    onto a shared wall timeline.

    ``anchor`` is the process's ``(ts, ts_mono)`` pair; ``skew_s`` is
    its wall clock's measured offset from the reference clock (0 for a
    same-host process). A MONO-ONLY process (anchor without ``ts`` —
    a foreign exporter that can't sample wall time) degrades to
    identity mapping against the reference anchor: correct exactly when
    the two processes share a monotonic epoch (same host), which is the
    only case a mono-only anchor can support at all."""

    def __init__(self, anchor, skew_s=0.0, reference=None):
        anchor = anchor or {}
        self.ts = anchor.get("ts")
        self.ts_mono = anchor.get("ts_mono")
        self.skew_s = float(skew_s or 0.0)
        self._ref = reference or {}

    def to_wall(self, mono):
        """Reference wall time of one span timestamp."""
        if self.ts is None or self.ts_mono is None:
            ref_ts = self._ref.get("ts")
            ref_mono = self._ref.get("ts_mono")
            if ref_ts is None or ref_mono is None:
                return float(mono)  # nothing to align against
            return ref_ts + (float(mono) - ref_mono)
        return self.ts + (float(mono) - self.ts_mono) - self.skew_s

    @staticmethod
    def estimate_skew(reported_ts, t_request_0, t_request_1,
                      tolerance_s=SKEW_TOLERANCE_S):
        """NTP-style one-shot skew estimate: the process reported its
        wall time ``reported_ts`` somewhere inside the puller's
        [t0, t1] request window, so ``reported - midpoint`` bounds the
        clock offset to within half the round trip. Below
        ``tolerance_s`` the estimate is indistinguishable from pull
        latency and is ignored (same-host clocks are identical; noise
        must not smear an already-aligned timeline)."""
        if reported_ts is None:
            return 0.0
        skew = float(reported_ts) - (float(t_request_0)
                                     + float(t_request_1)) / 2.0
        return skew if abs(skew) > float(tolerance_s) else 0.0


def _http_json(url, timeout):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read().decode("utf-8"))


def pull_trace(base_url, label=None, trace_id=None, timeout=5.0):
    """Pull one live process: ``{label, trace, anchor, skew_s}`` from
    its ``/trace`` (+ optional ``?trace_id=`` narrowing) and
    ``/healthz`` (the anchor + the skew sample). Raises on an
    unreachable process — the caller decides whether a black-box dump
    can stand in."""
    url = base_url.rstrip("/")
    q = "?trace_id=%s" % trace_id if trace_id else ""
    trace = _http_json(url + "/trace" + q, timeout)
    t0 = time.time()
    try:
        health = _http_json(url + "/healthz", timeout)
    except urllib.error.HTTPError as e:  # draining answers 503 + body
        health = json.loads(e.read().decode("utf-8"))
    t1 = time.time()
    anchor = trace.get("clock_anchor") or {
        "ts": health.get("ts"), "ts_mono": health.get("ts_mono"),
    }
    skew = ProcessClock.estimate_skew(health.get("ts"), t0, t1)
    return {
        "label": label or url,
        "trace": trace,
        "anchor": anchor,
        "skew_s": skew,
    }


def load_trace_dump(path, label=None):
    """A dead process's black-box span dump as a pull-shaped dict (its
    anchor rides inside the payload; skew is unknowable post-mortem —
    same-host 0 is the only defensible estimate)."""
    with open(path) as f:
        trace = json.load(f)
    return {
        "label": label or os.path.basename(path),
        "trace": trace,
        "anchor": trace.get("clock_anchor"),
        "skew_s": 0.0,
    }


def find_trace_dumps(obs_root):
    """[(label, path)] for every ``trace_rank_*.json`` black box under
    ``obs_root`` (one level of subdirs + the root itself — the fleet
    layout, via the walker shared with the flight-record reader)."""
    from . import aggregate as _aggregate

    return [
        ("%s/%s" % (subdir, fn) if subdir else fn, path)
        for subdir, fn, path in _aggregate.iter_obs_dumps(
            obs_root, _TRACE_DUMP)
    ]


def _dedup_pulls(pulls):
    """Drop later pulls that are the SAME process as an earlier one
    (payload ``(rank, pid_os)`` identity): a live process's snapshot
    loop also writes its black box to disk, so ``--endpoint`` +
    ``--obs-root`` would otherwise merge each survivor twice — a
    duplicate pid row, and single-process traces miscounted as
    cross-process. First pull wins (live endpoints are pulled before
    dumps, and a merge-time pull is fresher than any snapshot).
    Payloads without both identity fields (foreign exporters, synthetic
    fixtures) are never deduped. Returns (kept, dropped_labels)."""
    seen = set()
    kept, dropped = [], []
    for pull in pulls:
        trace = pull.get("trace") or {}
        rank, pid_os = trace.get("rank"), trace.get("pid_os")
        if rank is not None and pid_os is not None:
            key = (rank, pid_os)
            if key in seen:
                dropped.append(str(pull.get("label")))
                continue
            seen.add(key)
        kept.append(pull)
    return kept, dropped


def spans_of(pull):
    """Span dicts reconstructed from one pull's trace events, with
    ABSOLUTE mono times (``ts_base`` re-added) and the distributed ids
    lifted out of args. Metadata events are skipped; instants keep
    ``instant: True``."""
    trace = pull["trace"]
    base = float(trace.get("ts_base") or 0.0)
    out = []
    for ev in trace.get("traceEvents", ()):
        ph = ev.get("ph")
        if ph not in ("X", "i"):
            continue
        args = ev.get("args") or {}
        start = base + float(ev.get("ts", 0.0)) / 1e6
        dur = float(ev.get("dur", 0.0)) / 1e6 if ph == "X" else 0.0
        out.append({
            "name": ev.get("name"),
            "cat": ev.get("cat"),
            "start": start,
            "end": start + dur,
            "tid": ev.get("tid"),
            "instant": ph == "i",
            "trace_id": args.get("trace_id"),
            "span_id": args.get("span_id"),
            "parent_span_id": args.get("parent_span_id"),
            "trace_ids": args.get("trace_ids"),
            "args": args,
            "process": pull["label"],
        })
    return out


def merge(pulls, reference=None):
    """Merge N pulls into one report dict:

    - ``trace``: a single Perfetto-loadable chrome trace — one ``pid``
      per process (named rows), every event's ``ts`` on the reference
      wall timeline;
    - ``spans``: the aligned span dicts (``start``/``end`` now wall
      seconds on the reference clock);
    - ``trees``: per-trace_id span trees (see ``span_trees``);
    - counters: ``requests_linked`` (trees connecting 2+ processes,
      also bumped onto the metrics registry as
      ``trace_requests_linked``) and ``orphan_spans``
      (``trace_orphan_spans``).

    ``reference`` defaults to the FIRST pull's anchor — pull the
    controller first and the merged timeline is the controller's.
    """
    if not pulls:
        return {"trace": {"traceEvents": []}, "spans": [], "trees": {},
                "requests_linked": 0, "orphan_spans": 0,
                "duplicate_pulls": []}
    pulls, dropped = _dedup_pulls(pulls)
    reference = reference or pulls[0].get("anchor") or {}
    events = []
    all_spans = []
    t0 = None
    per_pull = []
    for i, pull in enumerate(pulls):
        clock = ProcessClock(pull.get("anchor"),
                             skew_s=pull.get("skew_s", 0.0),
                             reference=reference)
        spans = spans_of(pull)
        for s in spans:
            s["start"] = clock.to_wall(s["start"])
            s["end"] = clock.to_wall(s["end"])
            if t0 is None or s["start"] < t0:
                t0 = s["start"]
        per_pull.append((i, pull, spans))
        all_spans.extend(spans)
    t0 = t0 or 0.0
    for i, pull, spans in per_pull:
        events.append({
            "name": "process_name", "ph": "M", "pid": i, "tid": 0,
            "args": {"name": str(pull["label"])},
        })
        for s in spans:
            ev = {
                "name": s["name"], "cat": s["cat"],
                "ts": (s["start"] - t0) * 1e6,
                "pid": i, "tid": s["tid"] or 0, "args": s["args"],
            }
            if s["instant"]:
                ev["ph"] = "i"
                ev["s"] = "p"
            else:
                ev["ph"] = "X"
                ev["dur"] = (s["end"] - s["start"]) * 1e6
            events.append(ev)
    trees = span_trees(all_spans)
    linked = sum(1 for t in trees.values()
                 if t["connected"] and len(t["processes"]) >= 2)
    orphans = sum(t["orphans"] for t in trees.values())
    if linked:
        _profiler.bump_counter("trace_requests_linked", linked)
    if orphans:
        _profiler.bump_counter("trace_orphan_spans", orphans)
    return {
        "trace": {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "schema_version": _trace.TRACE_SCHEMA_VERSION,
            "merged_processes": [str(p["label"]) for p in pulls],
            "t0_wall": t0,
        },
        "spans": all_spans,
        "trees": trees,
        "requests_linked": linked,
        "orphan_spans": orphans,
        "duplicate_pulls": dropped,
    }


def span_trees(spans):
    """{trace_id: tree} over aligned span dicts.

    Each tree: ``nodes`` ({span_id: span}), ``children``
    ({span_id: [span_id]}), ``root`` (the unique parentless span's id,
    or None), ``connected`` (exactly one real root and every node
    reachable from it), ``orphans`` (spans whose named parent never
    recorded — ring eviction, or a process that died mid-request: they
    attach under a synthetic ``synthetic:<process>`` node that hangs
    off the root, marked, NEVER dropped), ``instants``, ``ticks``
    (shared-work spans listing this trace in ``trace_ids``), and
    ``processes`` (every process contributing a span)."""
    by_trace = {}
    shared_by_trace = {}
    for s in spans:
        if s.get("trace_id") and s.get("span_id"):
            by_trace.setdefault(s["trace_id"], []).append(s)
        tids = s.get("trace_ids")
        if isinstance(tids, (list, tuple)):
            for t in tids:
                by_trace.setdefault(t, [])
                shared_by_trace.setdefault(t, []).append(s)
    trees = {}
    for trace_id, members in by_trace.items():
        nodes = {s["span_id"]: s for s in members if not s["instant"]}
        instants = [s for s in members if s["instant"]]
        shared = shared_by_trace.get(trace_id, [])
        children = {}
        roots, orphan_spans = [], []
        for sid, s in nodes.items():
            parent = s.get("parent_span_id")
            if parent is None:
                roots.append(sid)
            elif parent in nodes:
                children.setdefault(parent, []).append(sid)
            else:
                orphan_spans.append(s)
        root = roots[0] if len(roots) == 1 else None
        if root is None and not roots and orphan_spans:
            # a trace ADOPTED from a client's traceparent has no local
            # root: the fleet's topmost span (router_request) chains to
            # the client's remote span, which no pull can ever contain.
            # Promote the earliest such span — it IS the fleet-side
            # root; its remote parentage stays visible on the span —
            # so "send your own traceparent" still yields one
            # connected tree.
            top = min(orphan_spans, key=lambda s: s["start"])
            orphan_spans.remove(top)
            top["remote_parent"] = True
            root = top["span_id"]
        processes = {s["process"] for s in members} | {
            s["process"] for s in shared
        }
        # orphans hang from a synthetic per-process node under the root
        # (or stand alone when the trace has no root at all): the tree
        # stays connected and the orphan is visibly marked synthetic
        synth = {}
        for s in orphan_spans:
            key = "synthetic:%s" % s["process"]
            if key not in synth:
                synth[key] = {
                    "name": key, "span_id": key, "synthetic": True,
                    "process": s["process"], "instant": False,
                    "trace_id": trace_id,
                }
                nodes[key] = synth[key]
                if root is not None:
                    children.setdefault(root, []).append(key)
            s["orphan"] = True
            children.setdefault(key, []).append(s["span_id"])
        # connectivity: every non-synthetic node reachable from the root
        connected = root is not None
        if connected:
            seen = set()
            stack = [root]
            while stack:
                cur = stack.pop()
                if cur in seen:
                    continue
                seen.add(cur)
                stack.extend(children.get(cur, ()))
            connected = all(sid in seen for sid in nodes)
        trees[trace_id] = {
            "nodes": nodes,
            "children": children,
            "root": root,
            "connected": connected,
            "orphans": len(orphan_spans),
            "instants": instants,
            "ticks": shared,
            "processes": processes,
        }
    return trees


def containment_violations(tree, slack_s=0.05):
    """Parent/child time-containment violations in one aligned tree:
    [(parent_name, child_name, overhang_s)] where a REAL child starts
    before or ends after its REAL parent by more than ``slack_s``.
    Zero violations is the cross-process alignment bar: the router
    span contains the gateway span contains the engine spans, on wall
    time, across processes. Synthetic edges (orphan attachment) carry
    no timing claim and are skipped."""
    out = []
    nodes, children = tree["nodes"], tree["children"]
    for pid, kids in children.items():
        p = nodes.get(pid)
        if p is None or p.get("synthetic"):
            continue
        for cid in kids:
            c = nodes.get(cid)
            if c is None or c.get("synthetic"):
                continue
            over = max(p["start"] - c["start"], c["end"] - p["end"])
            if over > slack_s:
                out.append((p["name"], c["name"], round(over, 6)))
    return out


def write_merged(path, merged):
    """Write the merged Perfetto trace (atomic tmp+rename)."""
    tmp = "%s.tmp.%d" % (path, os.getpid())
    with open(tmp, "w") as f:
        json.dump(merged["trace"], f)
    os.replace(tmp, path)
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="merge a serving fleet's /trace exports into one "
                    "Perfetto timeline"
    )
    ap.add_argument("--endpoint", action="append", default=[],
                    metavar="LABEL=URL",
                    help="live process to pull (repeatable); the FIRST "
                         "one is the reference clock")
    ap.add_argument("--dump", action="append", default=[],
                    metavar="LABEL=PATH",
                    help="black-box trace_rank_*.json of a dead process")
    ap.add_argument("--obs-root", default="",
                    help="fleet obs/ dir: every trace_rank_*.json "
                         "below it merges as a dump")
    ap.add_argument("--trace-id", default="",
                    help="narrow live pulls to one request")
    ap.add_argument("--out", default="fleet_trace.json")
    args = ap.parse_args(argv)

    pulls = []
    for spec in args.endpoint:
        label, _, url = spec.partition("=")
        if not url:
            label, url = url or spec, spec
        pulls.append(pull_trace(url, label=label or None,
                                trace_id=args.trace_id or None))
    for spec in args.dump:
        label, _, path = spec.partition("=")
        if not path:
            label, path = "", spec
        pulls.append(load_trace_dump(path, label=label or None))
    if args.obs_root:
        for label, path in find_trace_dumps(args.obs_root):
            pulls.append(load_trace_dump(path, label=label))
    merged = merge(pulls)
    write_merged(args.out, merged)
    linked = merged["requests_linked"]
    dropped = merged["duplicate_pulls"]
    print(
        "fleet_trace: %d processes, %d spans, %d traces "
        "(%d cross-process, %d orphan spans) -> %s"
        % (len(pulls) - len(dropped), len(merged["spans"]),
           len(merged["trees"]), linked, merged["orphan_spans"],
           args.out)
    )
    if dropped:
        print("fleet_trace: skipped %d duplicate pull(s) of already-"
              "merged processes: %s" % (len(dropped), ", ".join(dropped)))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main(sys.argv[1:]))
