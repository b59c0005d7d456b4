"""Admission queue + micro-batch coalescer (port of
``paddle_tpu/serving/batcher.py``).

Bounded queueing with explicit overload behaviour instead of unbounded
buildup. Concurrent requests coalesce into one device batch under a
(max_batch_size, batch_timeout_ms) policy:

- admission is BOUNDED: when the queue is full the request is shed
  immediately with ServerOverloadedError carrying a retry_after_ms hint;
- a dispatch worker takes the oldest request and holds it at most
  batch_timeout_ms while compatible requests (same per-feed non-batch
  shape/dtype) accumulate, cutting early the moment the batch is full,
  or at the earliest deadline in the batch (less a dispatch margin);
- requests whose deadline passed while queued are shed AT DISPATCH with
  DeadlineExceededError — a distinct, retriable error — rather than
  occupying device time or stalling the queue behind them.

All coalescer metrics ride the always-on ``fluid.profiler`` counters;
the live queue length is the ``serving_queue_depth`` gauge of
``observability.registry``. A request carries the distributed-trace
context of the thread that submitted it, and the dispatch span lists the
trace ids of its batch.
"""

import threading
import time
from collections import deque

import numpy as np

from ..fluid import profiler as _profiler
from ..observability import registry as _obs_registry
from ..observability import trace as _trace

__all__ = [
    "ServingError",
    "ServerOverloadedError",
    "DeadlineExceededError",
    "MicroBatcher",
]


class ServingError(RuntimeError):
    """Base class for serving-runtime request failures."""


class ServerOverloadedError(ServingError):
    """Admission queue full: request shed at submit. ``retry_after_ms``
    estimates when capacity frees up (queue drain time at the current
    batch cadence)."""

    def __init__(self, msg, retry_after_ms=1):
        super().__init__(msg)
        self.retry_after_ms = retry_after_ms


class DeadlineExceededError(ServingError):
    """The request's deadline passed before it reached the device; it was
    shed without being executed."""


# how far BEFORE a request's deadline the gather window cuts: the batch
# must still be stacked and reach the dispatch-time deadline check, so
# cutting exactly at the deadline would shed a request the server had
# every chance to serve
_DISPATCH_MARGIN_S = 0.002


class _Request(object):
    __slots__ = ("inputs", "rows", "sig", "enqueue_t", "deadline_t",
                 "event", "result", "error", "seq_plan", "trace_ctx")

    def __init__(self, inputs, rows, sig, deadline_t):
        self.seq_plan = None  # set by the server's seq-bucket alignment
        self.inputs = inputs
        self.rows = rows
        self.sig = sig
        self.enqueue_t = time.monotonic()
        self.deadline_t = deadline_t
        self.event = threading.Event()
        self.result = None
        self.error = None
        # distributed-trace hand-off: captured on the submitting thread
        # (the gateway handler's ambient trace_scope), read by the
        # dispatch worker so the coalesced batch's span can name every
        # request it served; None outside a scope
        self.trace_ctx = _trace.current_context()

    def complete(self, result=None, error=None):
        self.result = result
        self.error = error
        if error is None:
            # the latency histogram records SERVED requests only: shed
            # requests would mix queue residency of rejected work into
            # the service percentiles
            _profiler.bump_counter("serving_completed")
            _profiler.bump_histogram(
                "serving_latency_ms",
                (time.monotonic() - self.enqueue_t) * 1e3)
        self.event.set()


class MicroBatcher(object):
    """Coalesces submitted requests into device batches and runs them
    through ``runner(stacked_feeds, rows) -> per-row outputs``.

    ``runner`` receives one np array per feed (requests concatenated on
    axis 0, ``rows`` total) and returns a list of outputs whose axis 0 is
    the row axis; the batcher splits them back per request. Outputs are
    split by SHAPE MATCH: anything whose leading dim equals the batch's
    row count is row-sliced, everything else passes through whole to
    every request. Serve row-major outputs — a non-batched output whose
    leading dim coincidentally equals the row count would be mis-sliced.
    """

    def __init__(self, runner, max_batch_size=8, batch_timeout_ms=5.0,
                 queue_depth=64, num_workers=1, default_deadline_ms=0.0):
        if max_batch_size < 1 or queue_depth < 1 or num_workers < 1:
            raise ValueError("max_batch_size, queue_depth and num_workers "
                             "must be >= 1")
        self._runner = runner
        self.max_batch_size = int(max_batch_size)
        self.batch_timeout_s = float(batch_timeout_ms) / 1e3
        self.queue_depth = int(queue_depth)
        self.default_deadline_ms = float(default_deadline_ms)
        self._q = deque()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._stop = False
        # observed batch service time (s), seeded pessimistically; feeds
        # the retry_after_ms hint
        self._service_s = 0.05
        self._workers = [
            threading.Thread(target=self._worker_loop,
                             name="serving_batcher_%d" % i, daemon=True)
            for i in range(int(num_workers))
        ]
        for t in self._workers:
            t.start()
        # the batcher owns the queue, so it owns the depth gauge;
        # stop() unregisters only its own registration
        self._queue_gauge = lambda b=self: b.queue_len
        _obs_registry.register_gauge("serving_queue_depth",
                                     self._queue_gauge)

    # -- client side ---------------------------------------------------------
    def submit(self, inputs, deadline_ms=None):
        """Enqueue one request (list of np arrays, axis 0 = rows; rows must
        agree across feeds and fit one batch). Returns the request handle;
        wait on it with ``result(handle)``. Raises ServerOverloadedError
        when the admission queue is full."""
        arrs = [np.asarray(a) for a in inputs]
        if not arrs:
            raise ValueError("empty request")
        if any(a.ndim == 0 for a in arrs):
            raise ValueError(
                "request feeds must carry a row axis (axis 0); got %r"
                % [tuple(np.shape(x)) for x in arrs])
        rows = arrs[0].shape[0]
        if rows < 1:
            raise ValueError("request carries no rows")
        for a in arrs:
            if a.shape[0] != rows:
                raise ValueError(
                    "request feeds disagree on the row count: %r"
                    % [tuple(np.shape(x)) for x in arrs])
        if rows > self.max_batch_size:
            raise ValueError(
                "request carries %d rows > max_batch_size %d; split it"
                % (rows, self.max_batch_size))
        sig = tuple((a.shape[1:], a.dtype.str) for a in arrs)
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        deadline_t = (time.monotonic() + float(deadline_ms) / 1e3
                      if deadline_ms and deadline_ms > 0 else None)
        req = _Request(arrs, rows, sig, deadline_t)
        _profiler.bump_counter("serving_requests")
        with self._cond:
            if self._stop:
                raise ServingError("serving batcher is stopped")
            if len(self._q) >= self.queue_depth:
                _profiler.bump_counter("serving_shed_overload")
                batches_ahead = ((len(self._q) + self.max_batch_size - 1)
                                 // self.max_batch_size)
                retry = max(1, int(batches_ahead * self._service_s * 1e3))
                raise ServerOverloadedError(
                    "admission queue full (%d queued); retry in ~%dms"
                    % (len(self._q), retry), retry_after_ms=retry)
            self._q.append(req)
            self._cond.notify()
        return req

    def result(self, req, timeout=None):
        """Block until the request completes; returns the per-request
        output list or raises the request's error."""
        if not req.event.wait(timeout):
            raise ServingError("timed out waiting for the request result")
        if req.error is not None:
            raise req.error
        return req.result

    @property
    def queue_len(self):
        with self._lock:
            return len(self._q)

    # -- worker side ---------------------------------------------------------
    def _gather(self):
        """One coalesced batch: the oldest request plus compatible
        followers, cut at max_batch_size rows, at batch_timeout after the
        first request was picked up, at the first incompatible request
        at the head of the queue, or at the EARLIEST deadline in the
        batch less ``_DISPATCH_MARGIN_S``, whichever comes first. Returns
        [] on stop."""
        with self._cond:
            while not self._q and not self._stop:
                self._cond.wait(0.1)
            if not self._q:
                return []
            first = self._q.popleft()
            batch, rows = [first], first.rows
            cut_t = time.monotonic() + self.batch_timeout_s
            if first.deadline_t is not None:
                cut_t = min(cut_t, first.deadline_t - _DISPATCH_MARGIN_S)
            while rows < self.max_batch_size:
                if self._q:
                    nxt = self._q[0]
                    if (nxt.sig != first.sig
                            or rows + nxt.rows > self.max_batch_size):
                        break  # incompatible head: dispatch what we have
                    self._q.popleft()
                    batch.append(nxt)
                    rows += nxt.rows
                    if nxt.deadline_t is not None:
                        cut_t = min(cut_t,
                                    nxt.deadline_t - _DISPATCH_MARGIN_S)
                    continue
                remaining = cut_t - time.monotonic()
                if remaining <= 0 or self._stop:
                    break
                self._cond.wait(remaining)
        return batch

    def _worker_loop(self):
        while True:
            batch = self._gather()
            if not batch:
                if self._stop:
                    return
                continue
            now = time.monotonic()
            live = []
            for r in batch:
                if r.deadline_t is not None and now > r.deadline_t:
                    _profiler.bump_counter("serving_shed_deadline")
                    r.complete(error=DeadlineExceededError(
                        "deadline passed while queued (%.1fms late)"
                        % ((now - r.deadline_t) * 1e3)))
                else:
                    live.append(r)
            if not live:
                continue
            rows = sum(r.rows for r in live)
            # the dispatch span covers stacking and the runner (whose
            # predictor_run span nests inside), so queue time and device
            # time separate. A coalesced batch serves several requests'
            # traces at once, so it lists every member's trace id rather
            # than adopting one request's context (skipped when tracing
            # is off)
            tids = (sorted({r.trace_ctx[0] for r in live if r.trace_ctx})
                    if _trace.enabled() else [])
            with _trace.span("serving_dispatch", cat="serving", rows=rows,
                             requests=len(live),
                             **({"trace_ids": tids} if tids else {})):
                stacked = [
                    np.concatenate([r.inputs[i] for r in live], axis=0)
                    if len(live) > 1 else live[0].inputs[i]
                    for i in range(len(live[0].inputs))
                ]
                t0 = time.monotonic()
                try:
                    outs = self._runner(stacked, rows)
                except BaseException as e:  # surface to every waiting caller
                    for r in live:
                        r.complete(error=ServingError(
                            "batch execution failed: %r" % (e,)))
                    continue
            self._service_s = 0.8 * self._service_s + 0.2 * (
                time.monotonic() - t0)
            _profiler.bump_counter("serving_batches")
            _profiler.bump_counter("serving_batched_rows", rows)
            off = 0
            for r in live:
                r.complete(result=[
                    o[off:off + r.rows] if (
                        hasattr(o, "ndim") and o.ndim >= 1
                        and o.shape[0] == rows) else o
                    for o in outs
                ])
                off += r.rows

    def stop(self, join_timeout=5.0):
        """Stop workers; queued-but-undispatched requests complete with
        ServingError so no caller blocks forever."""
        if self._queue_gauge is not None:
            _obs_registry.unregister_gauge("serving_queue_depth",
                                           self._queue_gauge)
            self._queue_gauge = None
        with self._cond:
            self._stop = True
            pending = list(self._q)
            self._q.clear()
            self._cond.notify_all()
        for r in pending:
            r.complete(error=ServingError("server stopped before dispatch"))
        for t in self._workers:
            t.join(timeout=join_timeout)
