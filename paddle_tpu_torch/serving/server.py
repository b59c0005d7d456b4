"""InferenceServer — the dynamic-batching serving runtime (port of
``paddle_tpu/serving/server.py``).

Ties the subsystem together on top of AnalysisPredictor:

  client threads --submit--> [admission queue | MicroBatcher]
        --coalesced batch--> BucketLadder.pad_feeds (round to bucket)
        --padded batch-----> PredictorPool predictor.run (shared plans)
        --outputs----------> unpad_outputs --split--> per-request results

Defaults come from the serving_* flags (``fluid/flags.py``), so a
deployment tunes the policy through ``FLAGS_`` environment variables.
``start(warmup_inputs=...)`` runs every bucket-ladder shape once through
the pool, so steady-state traffic builds nothing on the request path: no
Executor plan (``executor_plan_builds``), no kernel library
(``kernels/_build.py``'s ``builds``), no new predictor signature
(``predictor_plan_cache_misses``). After warmup the server arms the
strict gate (``observability.compile_stats``): a build inside a
dispatch then bumps ``serving_steady_recompiles`` and, under
``FLAGS_serving_strict_compiles``, fails its batch. ``start()`` starts
the exporter when the ``FLAGS_obs_*`` knobs ask for one; ``stop()``
writes the final snapshot. ``stats()`` returns the ServingStats
snapshot. Generation rides an attached ``DecodeEngine``
(``decode_engine=``, ``generate``); ``serving.Gateway`` puts both on
HTTP.
"""

import threading

import numpy as np

from ..fluid import flags as _flags
from ..fluid import profiler as _profiler
from ..observability import compile_stats as _compile_stats
from ..observability import exporter as _obs_exporter
from ..observability import registry as _obs_registry
from ..observability import trace as _trace
from .batcher import MicroBatcher, ServingError
from .buckets import BucketLadder
from .metrics import snapshot_stats
from .pool import PredictorPool

__all__ = ["InferenceServer"]


def _flag(name, override):
    return override if override is not None else _flags.get_flag(name)


class InferenceServer(object):
    """Dynamic-batching server over an AnalysisPredictor (or anything
    with ``run(list_of_arrays) -> list_of_arrays`` and ``clone()``).

    Parameters default to the serving_* flags; ``ladder`` overrides the
    default power-of-two batch-bucket ladder (e.g. to add seq buckets).
    """

    def __init__(self, predictor, max_batch_size=None, batch_timeout_ms=None,
                 queue_depth=None, num_workers=None, default_deadline_ms=None,
                 ladder=None, decode_engine=None):
        self.max_batch_size = int(_flag("serving_max_batch_size",
                                        max_batch_size))
        self.batch_timeout_ms = float(_flag("serving_batch_timeout_ms",
                                            batch_timeout_ms))
        self.queue_depth = int(_flag("serving_queue_depth", queue_depth))
        self.num_workers = int(_flag("serving_workers", num_workers))
        self.default_deadline_ms = float(_flag("serving_default_deadline_ms",
                                               default_deadline_ms))
        self.ladder = ladder or BucketLadder(max_batch=self.max_batch_size)
        if self.ladder.max_batch < self.max_batch_size:
            raise ValueError(
                "bucket ladder tops out at %d rows but max_batch_size is %d"
                % (self.ladder.max_batch, self.max_batch_size))
        self._predictor = predictor
        self._pool = None
        self._batcher = None
        self._warm_sigs = set()
        self._warm_lock = threading.Lock()
        self._baseline = {}
        self._lat_base = 0
        self._pool_gauge = None
        self._steady_armed = False
        self._started = False
        # autoregressive generation rides a DecodeEngine; whole-forward
        # traffic keeps the micro-batcher path
        self._decode_engine = decode_engine
        self._engine_started_here = False

    # -- lifecycle -----------------------------------------------------------
    def start(self, warmup_inputs=None):
        """Build the pool and dispatch workers. ``warmup_inputs`` (one
        example request: list of arrays, axis 0 = rows) runs every
        bucket-ladder shape BEFORE traffic arrives. An attached decode
        engine that is not started yet starts here (and stops with the
        server)."""
        if self._started:
            raise RuntimeError("server already started")
        self._pool = PredictorPool(self._predictor, size=self.num_workers)
        if warmup_inputs is not None:
            self.warmup(warmup_inputs)
        # baseline AFTER warmup: stats() reports steady-state traffic only
        self._baseline = _profiler.get_counters()
        self._lat_base = len(_profiler.get_histogram("serving_latency_ms"))
        self._batcher = MicroBatcher(
            self._run_batch,
            max_batch_size=self.max_batch_size,
            batch_timeout_ms=self.batch_timeout_ms,
            queue_depth=self.queue_depth,
            num_workers=self.num_workers,
            default_deadline_ms=self.default_deadline_ms,
        )
        self._started = True
        # telemetry: FLAGS_obs_* light up /metrics /healthz /trace
        # /compiles and JSONL snapshots (a no-op when disarmed)
        _obs_exporter.maybe_start_from_flags()
        self._pool_gauge = lambda p=self._pool: p.free_count
        _obs_registry.register_gauge("serving_pool_free", self._pool_gauge)
        # warmup is over: from here a build inside a dispatch is a
        # steady-state build, counted and (strict) fatal to its batch.
        # Counted per owner: stopping an older server must not disarm
        # the gate under a live successor
        _compile_stats.arm_serving_steady()
        self._steady_armed = True
        if self._decode_engine is not None and \
                not self._decode_engine.started:
            # a failed engine start unwinds the whole server: the caller
            # has no handle to stop it with
            try:
                self._decode_engine.start()
                self._engine_started_here = True
            except Exception:
                self.stop()
                raise
        return self

    def warmup(self, example_inputs):
        """Run every bucket shape once through the pool's shared plans.
        On a live server a predictor is checked out of the pool per shape,
        so live traffic interleaves with the warmup."""
        example = [np.asarray(a) for a in example_inputs]
        c_before = _profiler.get_counters()
        with _compile_stats.warmup_window(), _trace.span(
                "serving_warmup", cat="serving"):
            self._warm_ladder(example)
        if self._started:
            # warmup on a live server: fold its plan-cache activity into
            # the baseline, so stats() keeps counting request-path misses
            c_after = _profiler.get_counters()
            for k in ("predictor_plan_cache_misses",
                      "predictor_plan_cache_hits"):
                self._baseline[k] = self._baseline.get(k, 0) + (
                    c_after.get(k, 0) - c_before.get(k, 0))

    def _warm_ladder(self, example):
        for rows, seq in self.ladder.shapes():
            feeds = []
            for a in example:
                one = a[:1] if a.ndim else a.reshape(1)
                if (seq is not None and one.ndim > self.ladder.seq_axis
                        and one.shape[self.ladder.seq_axis] > seq):
                    idx = [slice(None)] * one.ndim
                    idx[self.ladder.seq_axis] = slice(0, seq)
                    one = one[tuple(idx)]
                feeds.append(one)
            plan = self.ladder.plan(feeds)
            plan.padded_rows, plan.padded_seq = rows, seq
            padded, _ = self.ladder.pad_feeds(feeds, plan)
            self._record_bucket(padded, warm=True)
            if self._pool is not None:
                with self._pool.acquire() as pred:
                    pred.run(padded)
            else:
                self._predictor.run(padded)

    def stop(self):
        # a serving process with FLAGS_obs_dir armed leaves its per-rank
        # snapshot (a no-op otherwise)
        _obs_exporter.final_snapshot()
        if self._steady_armed:
            _compile_stats.disarm_serving_steady()
            self._steady_armed = False
        if self._pool_gauge is not None:
            # only this server's registration: a later server that
            # re-registered the gauge keeps it
            _obs_registry.unregister_gauge("serving_pool_free",
                                           self._pool_gauge)
            self._pool_gauge = None
        if self._batcher is not None:
            self._batcher.stop()
        if self._decode_engine is not None and self._engine_started_here:
            self._decode_engine.stop()
            self._engine_started_here = False
        self._started = False

    def __enter__(self):
        return self if self._started else self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- request path --------------------------------------------------------
    def infer(self, inputs, deadline_ms=None, timeout=None):
        """Blocking request: list of arrays (axis 0 = rows, usually 1).
        Returns the per-request output list. Raises
        ServerOverloadedError (shed at admission, carries retry_after_ms)
        or DeadlineExceededError (shed at dispatch) — both retriable —
        or ServingError for execution failures."""
        return self.result(self.submit(inputs, deadline_ms=deadline_ms),
                           timeout=timeout)

    def submit(self, inputs, deadline_ms=None):
        """Non-blocking admission; pair with ``result()``."""
        if not self._started:
            raise ServingError("server not started")
        aligned, seq_plan = self._seq_align(inputs)
        req = self._batcher.submit(aligned, deadline_ms=deadline_ms)
        req.seq_plan = seq_plan
        return req

    def result(self, req, timeout=None):
        outs = self._batcher.result(req, timeout=timeout)
        if req.seq_plan is not None:
            # strip the admission-time seq padding (rows untouched)
            outs = self.ladder.unpad_outputs(outs, req.seq_plan)
        return outs

    def generate(self, prompt_ids, max_new_tokens=None, eos_id=None,
                 temperature=0.0, top_k=0, top_p=0.0, seed=None,
                 resume_tokens=None, priority=None, tenant=None):
        """Autoregressive completion through the attached DecodeEngine:
        returns a ``GenerationStream`` — iterate it for tokens as they are
        generated, or block on ``.tokens()`` / ``.result()``. The request
        joins the engine's continuous decode batch. Sampling is
        per-request on the host (greedy by default)."""
        if self._decode_engine is None:
            raise ServingError(
                "no decode engine attached: construct the server with "
                "decode_engine=DecodeEngine(cfg, ...) to serve generation")
        return self._decode_engine.generate(
            prompt_ids, max_new_tokens=max_new_tokens, eos_id=eos_id,
            temperature=temperature, top_k=top_k, top_p=top_p, seed=seed,
            resume_tokens=resume_tokens, priority=priority, tenant=tenant)

    def _seq_align(self, inputs):
        """(aligned_inputs, request_plan|None). With seq buckets each
        request's seq axis pads to its bucket AT ADMISSION, so requests
        of one bucket share a coalescing signature (on raw lengths,
        mixed-length traffic would never coalesce). Rows stay untouched;
        the row pad happens per coalesced batch."""
        if self.ladder.seq_buckets is None:
            return inputs, None
        feeds = [np.asarray(a) for a in inputs]
        plan = self.ladder.plan(feeds)
        if plan.padded_seq is None:
            return feeds, None
        plan.padded_rows = plan.rows  # seq-only pad at admission
        padded, plan = self.ladder.pad_feeds(feeds, plan)
        return padded, plan

    # -- internals -----------------------------------------------------------
    def _record_bucket(self, padded_feeds, warm=False):
        sig = tuple((a.shape, a.dtype.str) for a in padded_feeds)
        with self._warm_lock:  # dispatch workers record concurrently
            hit = sig in self._warm_sigs
            if not hit:
                self._warm_sigs.add(sig)
        if not warm:
            _profiler.bump_counter(
                "serving_bucket_hits" if hit else "serving_bucket_misses")

    def _run_batch(self, stacked, rows):
        padded, plan = self.ladder.pad_feeds(stacked)
        _profiler.bump_counter("serving_pad_rows",
                               plan.padded_rows - plan.rows)
        self._record_bucket(padded)
        # nests inside the batcher's serving_dispatch span: pool wait +
        # device time vs stacking/padding overhead. The request window
        # scopes the steady-state gate to this thread's builds
        with _compile_stats.serving_request_window(), _trace.span(
                "predictor_run", cat="serving", rows=rows,
                padded_rows=plan.padded_rows):
            # a blocking acquire: while warmup (or a slow batch) holds the
            # pool, batches wait rather than fail; per-request deadlines
            # bound what the caller sees
            with self._pool.acquire() as pred:
                outs = pred.run(padded)
        return self.ladder.unpad_outputs(outs, plan)

    def stats(self):
        """ServingStats snapshot (deltas since start; latency percentiles
        over the histogram window)."""
        return snapshot_stats(
            baseline=self._baseline,
            queue_depth=self._batcher.queue_len if self._batcher else 0,
            max_batch_size=self.max_batch_size,
            latency_baseline_count=self._lat_base,
        )
