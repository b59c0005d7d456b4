"""Predictor pool: N AnalysisPredictor clones sharing plans (a copy of
``paddle_tpu/serving/pool.py``).

``AnalysisPredictor.clone()`` gives each worker thread its own scope and
input/output staging (the mutable per-request state), while the
Executor and its plan of the program ride the shared plan holder — so
the pool plans the program once, and the warmup run on one member warms
every member (reference: analysis_predictor.cc Clone, which shares the
optimized program between per-thread predictors).
"""

from __future__ import annotations

import contextlib
import queue

__all__ = ["PredictorPool"]


class PredictorPool(object):
    def __init__(self, predictor, size=2):
        if size < 1:
            raise ValueError("pool size must be >= 1")
        self.primary = predictor
        self._all = [predictor]
        for _ in range(int(size) - 1):
            self._all.append(predictor.clone())  # share_plans=True default
        self._free = queue.Queue()
        for p in self._all:
            self._free.put(p)

    @property
    def size(self):
        return len(self._all)

    @property
    def free_count(self):
        """Currently checked-in predictors (approximate under races —
        queue length is a snapshot). Published as the
        ``serving_pool_free`` gauge so a scrape shows pool saturation
        next to queue depth."""
        return self._free.qsize()

    @contextlib.contextmanager
    def acquire(self, timeout=None):
        """Check a predictor out for one batch; always returned."""
        try:
            p = self._free.get(timeout=timeout)
        except queue.Empty:
            raise RuntimeError(
                "no free predictor within %.1fs (pool size %d)"
                % (timeout or 0.0, len(self._all))
            )
        try:
            yield p
        finally:
            self._free.put(p)
