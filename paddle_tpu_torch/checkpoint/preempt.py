"""Preemption handling (port of ``paddle_tpu/checkpoint/preempt.py``):
the process-wide preemption latch, and one final synchronous checkpoint
on SIGTERM.

Preemptible machines get a SIGTERM with a short grace window before the
SIGKILL. The serving front reads the latch: the gateway's ``/readyz``
and drain, the exporter's ``/healthz``. The contract here: ``distributed/launch.py`` forwards the
signal to every worker; each worker's installed ``PreemptionHandler``
runs ONE synchronous save of the current training state (async queue
drained first so the final save is the newest committed step), then
optionally exits with the conventional 128+SIGTERM status so the
launcher can tell a clean preemption from a crash.

Trainer loops that prefer to finish the in-flight step poll
``preemption_requested()`` instead of saving from the handler; the
handler supports both (``save_in_handler=False`` only sets the flag).
"""

from __future__ import annotations

import signal
import threading

_lock = threading.Lock()
_requested = threading.Event()


def preemption_requested():
    """True once any installed handler has seen its signal — loops poll
    this to stop cleanly at the next step boundary. STICKY for the life
    of the process (a preemption notice is a process-level fact); code
    that deliberately continues past one (e.g. a multi-epoch driver
    re-entering the trainer) should poll its own handler's per-install
    ``requested`` event instead, which each ``install()`` starts clear."""
    return _requested.is_set()


def request_preemption():
    """Set the process-wide preemption latch programmatically — the same
    sticky flag an installed ``PreemptionHandler`` sets on SIGTERM.
    Transports that own their own signal hook (the HTTP gateway's
    ``install_sigterm``) call this so every reader of the one latch —
    the exporter's ``/healthz``, the gateway's ``/readyz``, trainer
    step-boundary polls — flips to draining together."""
    _requested.set()


def _reset_for_tests():
    _requested.clear()


class PreemptionHandler(object):
    """Install with a state callback returning ``(step, program)`` (or
    ``(step, program, scope)``); on SIGTERM the handler drains the
    manager's async queue and commits one final synchronous save.

    Usage::

        handler = checkpoint.PreemptionHandler(
            mgr, lambda: (state.step, main_program)
        ).install()
        ...training loop...
        handler.uninstall()

    Consistency caveat for the in-handler save: Python runs the handler
    on the main thread between bytecodes, so the signal can land while
    ``executor.run`` is mid way through writing step N+1's results back
    to the scope — the snapshot would then interleave two steps and NOT
    be bit-exact (it still commits atomically and restores cleanly).
    Loops that need a guaranteed-consistent final checkpoint should pass
    ``save_in_handler=False`` and poll ``preemption_requested()`` at the
    step boundary (the fluid.trainer integration installs exactly that),
    or have ``state_fn`` return None while a step is in flight to skip
    the in-handler save."""

    def __init__(self, manager, state_fn, signals=(signal.SIGTERM,),
                 exit_after=True, save_in_handler=True):
        self.manager = manager
        self.state_fn = state_fn
        self.signals = tuple(signals)
        self.exit_after = exit_after
        self.save_in_handler = save_in_handler
        self._previous = {}
        self._installed = False
        self.final_step = None
        # per-install latch (cleared by install()), unlike the sticky
        # module-level flag: "did THIS handler see a signal"
        self.requested = threading.Event()

    def install(self):
        # signal handlers only install from the main thread; a trainer
        # driving from a worker thread falls back to the polling contract
        if threading.current_thread() is not threading.main_thread():
            return self
        self.requested.clear()
        for sig in self.signals:
            self._previous[sig] = signal.signal(sig, self._on_signal)
        self._installed = True
        return self

    def uninstall(self):
        if not self._installed:
            return self
        for sig, prev in self._previous.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, TypeError):
                pass
        self._previous.clear()
        self._installed = False
        return self

    def _on_signal(self, signum, frame):
        _requested.set()
        self.requested.set()
        if self.save_in_handler:
            with _lock:  # coalesce a SIGTERM burst into one final save
                self._final_save()
        if self.exit_after:
            raise SystemExit(128 + signum)

    def _final_save(self):
        state = self.state_fn()
        if state is None:
            return
        step, program = state[0], state[1]
        scope = state[2] if len(state) > 2 else None
        try:
            self.manager.wait()
        except Exception:
            pass  # a failed async save must not block the final sync one
        self.manager.save(step, program, scope=scope, async_=False)
        self.final_step = int(step)

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False
