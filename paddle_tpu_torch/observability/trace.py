"""Span tracer (port of the ``span`` core of
``paddle_tpu/observability/trace.py``).

``with span("decode_step", cat="serving", active=3): ...`` records one
timed span into a bounded ring buffer with its thread, nesting depth and
parent. The serving slice opens ``decode_prefill`` and ``decode_step``;
the GPT train step opens ``train_step`` (cat ``train``, arg ``step``).
Spans time the host: a span around device work measures device time
only where the work ends in a synchronisation (the decode session's
spans do, since they fetch the logits to the host). ``gang_rank`` names
the rank of per-rank artifacts (``observability.registry`` snapshots).
Distributed trace context and Chrome export come with the observability
slice.
"""

import os
import threading
import time
from collections import deque

__all__ = ["span", "get_spans", "reset", "gang_rank"]

_lock = threading.Lock()
_buf = deque(maxlen=65536)
_tls = threading.local()


class span(object):
    """Context manager recording one timed span; kwargs land in the
    record's ``args``. Nesting is tracked per thread."""

    __slots__ = ("name", "cat", "args", "_t0", "_parent")

    def __init__(self, name, cat="host", **args):
        self.name = name
        self.cat = cat
        self.args = args or None

    def __enter__(self):
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        self._parent = stack[-1] if stack else None
        stack.append(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        stack = _tls.stack
        stack.pop()
        rec = {
            "name": self.name, "cat": self.cat, "start": self._t0,
            "end": t1, "tid": threading.get_ident(), "depth": len(stack),
            "parent": self._parent, "args": self.args,
        }
        with _lock:
            _buf.append(rec)
        return False


def get_spans():
    """Snapshot of the recorded spans, oldest first."""
    with _lock:
        return list(_buf)


def reset():
    with _lock:
        _buf.clear()


def gang_rank(rank=None):
    """The rank labelling per-rank artifacts: an explicit value wins,
    else ``PADDLE_TRAINER_ID``, else 0 (a non-numeric value counts as
    unset)."""
    if rank is not None:
        return int(rank)
    try:
        return int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    except ValueError:
        return 0
