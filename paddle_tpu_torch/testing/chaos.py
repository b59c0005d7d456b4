"""Deterministic fault injection (port of
``paddle_tpu/testing/chaos.py``) for elastic-training and serving tests.

The serving front's hook, ``on_stream_token``, and the fleet's
controller kill are live in the port. The training hooks come as they
are, for the trainer still to be ported; the ``lose_rank`` fault writes
its down marker through ``distributed.elastic``, as the reference's.

Every injection point is a pure function of configuration + observable
state (step index, call count) — no randomness lives here, so a failing
chaos trial replays bit-exactly. Faults come from two sources, resolved
per call site:

1. **In-process**: ``install(FaultPlan(...))`` — unit tests inject and
   ``clear()`` in teardown.
2. **Flags/env**: ``FLAGS_chaos_*`` (env-bridged like every other flag:
   ``FLAGS_chaos_crash_at_step=7`` in a worker's environment arms the
   fault in that subprocess). ``FLAGS_chaos_target_rank`` scopes a fault
   to one worker of a gang (matched against ``PADDLE_TRAINER_ID``);
   -1 targets every rank.

One-shot semantics across restarts: a supervised gang re-spawns workers
with the SAME environment, so an armed crash/hang would re-fire on every
attempt and no trial could ever converge. ``FLAGS_chaos_marker_dir``
fixes that deterministically: firing a fault first touches
``fired_<point>`` in that directory, and any later process that sees the
marker skips the injection. An empty marker dir (the default) means
faults fire unconditionally — what a restart-budget-exhaustion test
wants.

Injection points and their hosts:

- ``crash_at_step`` / ``hang_at_step`` — ``fluid/trainer.py`` calls
  ``on_step(step)`` at each step boundary (right after the interval
  checkpoint save is enqueued, the worst moment to die).
- ``lose_rank`` (+ ``lose_rank_at_step`` / ``lose_rank_for``) — slice
  preemption, the elastic-resize fault: the worker occupying gang SLOT
  ``lose_rank`` (its stable ``PADDLE_TPU_GANG_SLOT`` identity, not the
  per-attempt remapped rank) writes its availability down-marker
  (``PADDLE_TPU_DOWN_FILE``, unlaunchable for ``lose_rank_for``
  supervisor planning rounds; -1 = until deleted) at the armed step and
  exits 143 — so the supervisor's next plan must shrink the gang around
  the slot and grow back when the marker expires, deterministically.
- ``slow_feed_ms`` — ``fluid/io_pipeline.py``'s producer thread calls
  ``maybe_slow_feed()`` per batch (models a degraded input host).
- ``nan_grad_at_step`` / ``loss_spike_at_step`` — data-plane faults for
  the training guardian: ``fluid/trainer.py`` routes each step's feed
  through ``poison_feed(step, feed)`` before the executor runs (NaN
  poisons the whole loss/grad chain; the spike scales the batch so the
  loss jumps while staying finite).
- ``bitflip_grad_at_step`` — silent data corruption:
  ``maybe_bitflip_state(step, program, scope)`` flips one parameter
  sign bit AFTER the armed step's update on the ``target_rank`` worker,
  invisible to that rank's own health fetch — the fault only the
  supervisor's cross-replica digest vote can catch.
- ``corrupt_ckpt`` — the checkpoint writer routes serialized tensor
  bytes through ``corrupt_ckpt_bytes()`` AFTER the manifest crc32 is
  computed, producing exactly the torn-file signature the restore
  fallback must survive.
- ``rpc_fail_n`` — the pserver client's retry wrapper raises
  ``ConnectionError`` for the first N calls via ``maybe_rpc_error()``
  (models a pserver that is still restarting).
- ``die_after_tokens`` (+ ``die_replica``) — the mid-stream serving
  fault: the gateway's SSE writer calls ``on_stream_token()`` after
  each token it puts on the wire, and the process SIGKILLs itself the
  moment its process-wide count reaches the armed N — so a router
  failover trial kills the replica at a token boundary
  deterministically instead of racing a SIGKILL against the engine's
  tick loop. ``die_replica`` scopes it to the replica whose
  ``PADDLE_TPU_REPLICA_ID`` (injected by the fleet controller) matches
  (-1 = any process with the fault armed), the serving-side analogue of
  ``lose_rank``'s slot addressing.
- ``kill_controller_after_s`` — the CONTROL-PLANE fault:
  ``serving/fleet.py``'s supervision tick calls
  ``maybe_kill_controller(elapsed_s)`` with the seconds since the
  control loop started, and the controller process SIGKILLs itself the
  first tick past the armed bound — its replicas keep serving
  headless, which is exactly the window the adoption/reconcile probe
  trial measures. One-shot under ``marker_dir`` like every fault, so
  the restarted controller of the same trial (same environment) does
  not re-fire it.
"""

from __future__ import annotations

import os
import signal
import threading
import time

__all__ = [
    "FaultPlan",
    "install",
    "clear",
    "active_plan",
    "on_step",
    "on_stream_token",
    "maybe_kill_controller",
    "maybe_slow_feed",
    "corrupt_ckpt_bytes",
    "maybe_rpc_error",
    "poison_feed",
    "maybe_bitflip_state",
]

# loss_spike feed scaling: big enough that any training loss jumps far
# outside a robust rolling window, small enough to stay finite in fp32
_SPIKE_FACTOR = 1024.0

_lock = threading.Lock()
_plan = None  # in-process FaultPlan (overrides flags when installed)
_rpc_faults_raised = 0  # process-local count for rpc_fail_n
_stream_tokens_emitted = 0  # process-local count for die_after_tokens
# flags-derived plan cache keyed on the flags version: the injection
# points sit on per-step / per-batch / per-tensor hot paths and the
# common (disarmed) case must cost one lock + one integer compare, not
# seven flag lookups and an allocation per call
_flag_plan_cache = (None, None)  # (flags.version(), plan_or_None)


class FaultPlan(object):
    """One process's fault configuration. ``None``/0/False fields are
    disarmed. ``target_rank`` scopes step faults to one gang member
    (None = every rank); ``marker_dir`` makes each fault one-shot across
    process restarts (see module docstring)."""

    def __init__(self, crash_at_step=None, hang_at_step=None,
                 corrupt_ckpt=False, slow_feed_ms=0.0, rpc_fail_n=0,
                 target_rank=None, marker_dir=None, lose_rank=None,
                 lose_rank_at_step=None, lose_rank_for=-1,
                 die_after_tokens=None, die_replica=None,
                 nan_grad_at_step=None, loss_spike_at_step=None,
                 bitflip_grad_at_step=None,
                 kill_controller_after_s=None):
        self.crash_at_step = crash_at_step
        self.hang_at_step = hang_at_step
        # data-plane faults (the training guardian's closed loop):
        # nan_grad poisons the armed step's feed batch with a NaN,
        # loss_spike scales it so the loss jumps while staying finite,
        # bitflip_grad flips one parameter sign bit AFTER the armed
        # step's update (silent corruption — only a cross-replica
        # digest can see it). All three honor target_rank + marker_dir.
        self.nan_grad_at_step = nan_grad_at_step
        self.loss_spike_at_step = loss_spike_at_step
        self.bitflip_grad_at_step = bitflip_grad_at_step
        self.corrupt_ckpt = bool(corrupt_ckpt)
        self.slow_feed_ms = float(slow_feed_ms)
        self.rpc_fail_n = int(rpc_fail_n)
        self.target_rank = target_rank
        self.marker_dir = marker_dir
        # slice-preemption fault: addressed by stable gang SLOT (so it
        # stays aimed at the same worker across rank remaps), own knob —
        # target_rank scopes the OTHER step faults, not this one
        self.lose_rank = lose_rank
        self.lose_rank_at_step = lose_rank_at_step
        self.lose_rank_for = int(lose_rank_for)
        # mid-stream serving fault: SIGKILL after exactly N stream
        # tokens hit the wire, addressed by replica id (the serving-side
        # analogue of lose_rank's slot addressing; None/-1 = any)
        self.die_after_tokens = die_after_tokens
        self.die_replica = die_replica
        # control-plane fault: the fleet controller SIGKILLs itself N
        # seconds into its supervision loop (replicas keep serving
        # headless) — the adoption/reconcile trial's deterministic kill
        self.kill_controller_after_s = kill_controller_after_s

    @classmethod
    def from_flags(cls):
        """The env/flag-driven plan (armed in subprocess workers by
        exporting ``FLAGS_chaos_*``). Returns None when every chaos flag
        sits at its disarmed default."""
        from ..fluid import flags as _flags

        crash = int(_flags.get_flag("chaos_crash_at_step", -1))
        hang = int(_flags.get_flag("chaos_hang_at_step", -1))
        corrupt = bool(_flags.get_flag("chaos_corrupt_ckpt", False))
        slow = float(_flags.get_flag("chaos_slow_feed_ms", 0.0))
        rpc_n = int(_flags.get_flag("chaos_rpc_fail_n", 0))
        rank = int(_flags.get_flag("chaos_target_rank", -1))
        marker = str(_flags.get_flag("chaos_marker_dir", "") or "")
        lose = int(_flags.get_flag("chaos_lose_rank", -1))
        lose_at = int(_flags.get_flag("chaos_lose_rank_at_step", -1))
        lose_for = int(_flags.get_flag("chaos_lose_rank_for", -1))
        die_after = int(_flags.get_flag("chaos_die_after_tokens", -1))
        die_replica = int(_flags.get_flag("chaos_die_replica", -1))
        nan_at = int(_flags.get_flag("chaos_nan_grad_at_step", -1))
        spike_at = int(_flags.get_flag("chaos_loss_spike_at_step", -1))
        bitflip_at = int(_flags.get_flag("chaos_bitflip_grad_at_step", -1))
        kill_ctl = float(
            _flags.get_flag("chaos_kill_controller_after_s", -1.0)
        )
        if (crash < 0 and hang < 0 and not corrupt and slow <= 0
                and rpc_n <= 0 and (lose < 0 or lose_at < 0)
                and die_after <= 0 and nan_at < 0 and spike_at < 0
                and bitflip_at < 0 and kill_ctl <= 0):
            return None
        return cls(
            crash_at_step=crash if crash >= 0 else None,
            hang_at_step=hang if hang >= 0 else None,
            corrupt_ckpt=corrupt,
            slow_feed_ms=slow,
            rpc_fail_n=rpc_n,
            target_rank=rank if rank >= 0 else None,
            marker_dir=marker or None,
            lose_rank=lose if lose >= 0 and lose_at >= 0 else None,
            lose_rank_at_step=lose_at if lose_at >= 0 else None,
            lose_rank_for=lose_for,
            die_after_tokens=die_after if die_after > 0 else None,
            die_replica=die_replica if die_replica >= 0 else None,
            nan_grad_at_step=nan_at if nan_at >= 0 else None,
            loss_spike_at_step=spike_at if spike_at >= 0 else None,
            bitflip_grad_at_step=bitflip_at if bitflip_at >= 0 else None,
            kill_controller_after_s=kill_ctl if kill_ctl > 0 else None,
        )

    def targets_me(self):
        if self.target_rank is None:
            return True
        return int(os.environ.get("PADDLE_TRAINER_ID", "0")) == int(
            self.target_rank
        )

    def loses_me(self):
        """lose_rank is armed and aimed at THIS worker's stable slot."""
        if self.lose_rank is None or self.lose_rank_at_step is None:
            return False
        return _my_slot() == int(self.lose_rank)

    def dies_me(self):
        """die_after_tokens is armed and aimed at THIS serving replica
        (its PADDLE_TPU_REPLICA_ID, injected by the fleet controller;
        an unaddressed fault targets any process it is armed in)."""
        if self.die_after_tokens is None:
            return False
        if self.die_replica is None:
            return True
        raw = os.environ.get("PADDLE_TPU_REPLICA_ID", "")
        try:
            return int(raw) == int(self.die_replica)
        except ValueError:
            return False


def _my_slot():
    """This worker's stable gang slot: the elastic contract's
    PADDLE_TPU_GANG_SLOT when the supervisor injected it, else the
    legacy trainer id (fixed-size gangs: slot == rank)."""
    from ..distributed import elastic as _elastic

    raw = os.environ.get(_elastic.SLOT_ENV)
    if raw is None:
        raw = os.environ.get("PADDLE_TRAINER_ID", "0")
    try:
        return int(raw)
    except ValueError:
        return 0


def install(plan):
    """Arm an in-process plan (unit tests); overrides the flag plan."""
    global _plan
    with _lock:
        _plan = plan
    return plan


def clear():
    global _plan, _rpc_faults_raised, _stream_tokens_emitted
    with _lock:
        _plan = None
        _rpc_faults_raised = 0
        _stream_tokens_emitted = 0


def active_plan():
    """The plan governing this process: the installed one, else the
    flag/env one (cached per flags-version), else None."""
    global _flag_plan_cache
    from ..fluid import flags as _flags

    with _lock:
        if _plan is not None:
            return _plan
        ver = _flags.version()
        cached_ver, cached = _flag_plan_cache
        if cached_ver == ver:
            return cached
    plan = FaultPlan.from_flags()
    with _lock:
        _flag_plan_cache = (ver, plan)
    return plan


def _fire_once(plan, point):
    """True when `point` should fire now; with a marker_dir, atomically
    claims the ``fired_<point>`` marker so exactly one process in the
    trial's lineage ever fires it."""
    if plan.marker_dir is None:
        return True
    os.makedirs(plan.marker_dir, exist_ok=True)
    marker = os.path.join(plan.marker_dir, "fired_%s" % point)
    try:
        fd = os.open(marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        return False
    os.close(fd)
    return True


def on_step(step):
    """Trainer step-boundary hook: SIGKILL this process or hang it
    forever when the armed step is reached. The hang deliberately keeps
    the process alive and silent — heartbeats stop, the collective
    stalls — which is exactly what the supervisor's watchdog exists to
    catch (a SIGTERM-able sleep, so teardown escalation is exercised
    too)."""
    plan = active_plan()
    if plan is None:
        return
    # slice preemption first (slot-addressed, independent of
    # target_rank): write the down marker, THEN exit 143 — the
    # supervisor must find the marker when it re-plans the gang
    if (plan.loses_me()
            and step == int(plan.lose_rank_at_step)
            and _fire_once(plan, "lose_rank")):
        from ..distributed import elastic as _elastic

        down_file = os.environ.get(_elastic.DOWN_FILE_ENV)
        if down_file:
            _elastic.write_down_marker(
                down_file, down_for=plan.lose_rank_for,
                slot=plan.lose_rank, reason="chaos_lose_rank",
            )
        print(
            "CHAOS lose_rank slot=%d step=%d down_for=%d pid=%d"
            % (int(plan.lose_rank), step, plan.lose_rank_for,
               os.getpid()),
            flush=True,
        )
        # exit 143 like a SIGTERMed (preempted) worker, abruptly —
        # no atexit / finally cleanup, as a real slice loss gives none
        os._exit(143)
    if not plan.targets_me():
        return
    if plan.crash_at_step is not None and step == int(plan.crash_at_step):
        if _fire_once(plan, "crash_at_step"):
            print("CHAOS crash_at_step=%d pid=%d" % (step, os.getpid()),
                  flush=True)
            os.kill(os.getpid(), signal.SIGKILL)
    if plan.hang_at_step is not None and step == int(plan.hang_at_step):
        if _fire_once(plan, "hang_at_step"):
            print("CHAOS hang_at_step=%d pid=%d" % (step, os.getpid()),
                  flush=True)
            while True:
                time.sleep(0.25)


def on_stream_token():
    """Serving-gateway hook, called after each SSE stream token is
    written to the wire: SIGKILL this process the moment its
    process-wide emitted-token count reaches the armed
    ``die_after_tokens`` — a replica death pinned to a token boundary,
    so failover trials replay deterministically. SIGKILL (not exit):
    like ``crash_at_step``, a real replica loss gives no atexit /
    drain, and the router must detect it at the socket."""
    global _stream_tokens_emitted
    plan = active_plan()
    if plan is None or not plan.dies_me():
        return
    with _lock:
        _stream_tokens_emitted += 1
        n = _stream_tokens_emitted
    if n == int(plan.die_after_tokens) and _fire_once(plan,
                                                      "die_after_tokens"):
        print(
            "CHAOS die_after_tokens=%d replica=%s pid=%d"
            % (n, os.environ.get("PADDLE_TPU_REPLICA_ID", "?"),
               os.getpid()),
            flush=True,
        )
        # flush the observability black box (flight ring + bounded span
        # dump) before dying: a REAL SIGKILL loses at most one snapshot
        # interval of telemetry, but a staged death must replay
        # deterministically — the failover trial asserts on the
        # victim's trace segment, so the harness closes that interval
        # gap itself. Best-effort; the kill happens regardless.
        try:
            from ..observability import exporter as _obs_exporter

            _obs_exporter.dump_blackbox()
        except Exception:
            pass
        os.kill(os.getpid(), signal.SIGKILL)


def maybe_kill_controller(elapsed_s):
    """Fleet-controller supervision-tick hook: SIGKILL this process the
    first tick at/past the armed ``kill_controller_after_s`` bound
    (``elapsed_s`` = seconds since the control loop started). SIGKILL,
    not exit: a real controller OOM-kill runs no drain and signals no
    replica — the surviving pool keeps serving headless, which is the
    window the adoption trial measures. ``target_rank`` does not apply
    (there is one controller); ``marker_dir`` one-shot applies, so the
    trial's RESTARTED controller (same environment) never re-fires."""
    plan = active_plan()
    if plan is None or plan.kill_controller_after_s is None:
        return
    if float(elapsed_s) < float(plan.kill_controller_after_s):
        return
    if not _fire_once(plan, "kill_controller"):
        return
    print(
        "CHAOS kill_controller_after_s=%.3f elapsed=%.3f pid=%d"
        % (float(plan.kill_controller_after_s), float(elapsed_s),
           os.getpid()),
        flush=True,
    )
    # same black-box flush as die_after_tokens: the staged death must
    # leave a deterministic telemetry trail for the trial to assert on.
    # Best-effort; the kill happens regardless.
    try:
        from ..observability import exporter as _obs_exporter

        _obs_exporter.dump_blackbox()
    except Exception:
        pass
    os.kill(os.getpid(), signal.SIGKILL)


def maybe_slow_feed():
    """Input-pipeline producer hook: per-batch host-side delay."""
    plan = active_plan()
    if plan is None or plan.slow_feed_ms <= 0 or not plan.targets_me():
        return
    time.sleep(plan.slow_feed_ms / 1000.0)


def corrupt_ckpt_bytes(blob):
    """Checkpoint-writer hook: return `blob` with its last byte flipped
    (called after the manifest crc32 was computed from the clean bytes,
    so the committed checkpoint fails its integrity check on restore).
    Length is preserved — offsets in the concatenated data file stay
    valid, making the corruption visible ONLY to the crc."""
    plan = active_plan()
    if plan is None or not plan.corrupt_ckpt or not plan.targets_me():
        return blob
    if not blob or not _fire_once(plan, "corrupt_ckpt"):
        return blob
    return blob[:-1] + bytes([blob[-1] ^ 0xFF])


def poison_feed(step, feed):
    """Trainer hook BEFORE the executor runs a step: return ``feed``
    (untouched on the common disarmed path), or a poisoned copy when
    ``nan_grad_at_step`` / ``loss_spike_at_step`` is armed for this
    step+rank. The first float entry of the feed dict is hit — NaN at
    flat index 0 for ``nan_grad`` (the whole loss/grad chain goes
    non-finite), a x%g scale for ``loss_spike`` (the loss jumps but
    stays finite; ``_SPIKE_FACTOR``). Returns a plain host dict for the
    poisoned step, so the io_pipeline's committed device batch is simply
    bypassed for that one step."""
    plan = active_plan()
    if plan is None or not plan.targets_me():
        return feed
    mode = None
    if (plan.nan_grad_at_step is not None
            and step == int(plan.nan_grad_at_step)):
        mode = "nan_grad"
    elif (plan.loss_spike_at_step is not None
            and step == int(plan.loss_spike_at_step)):
        mode = "loss_spike"
    if mode is None or not _fire_once(plan, mode):
        return feed
    import numpy as np

    out = {}
    poisoned = None
    for name, val in feed.items():
        if poisoned is None and not hasattr(val, "lod"):
            arr = np.array(np.asarray(val))  # writable host copy
            if np.issubdtype(arr.dtype, np.floating):
                if mode == "nan_grad":
                    arr.reshape(-1)[0] = np.nan
                else:
                    arr *= _SPIKE_FACTOR
                out[name] = arr
                poisoned = name
                continue
        out[name] = val
    print(
        "CHAOS %s step=%d var=%s pid=%d"
        % (mode, step, poisoned, os.getpid()),
        flush=True,
    )
    return out


def maybe_bitflip_state(step, program, scope):
    """Trainer hook AFTER a step's update landed in the scope: flip the
    LOWEST mantissa bit of element 0 of the alphabetically-first
    parameter on the targeted rank — a deterministic stand-in for
    silent data corruption (SDC) in one replica's weight update. One
    ulp is invisible to the rank's own loss/grad-norm anomaly policy BY
    DESIGN (that is what makes SDC silent — a loud corruption would
    trip the local detector as a spike); only the supervisor's
    cross-replica digest vote, which compares exact bytes, can see it.
    Returns the corrupted var name, or None."""
    plan = active_plan()
    if (plan is None or plan.bitflip_grad_at_step is None
            or step != int(plan.bitflip_grad_at_step)
            or not plan.targets_me()
            or not _fire_once(plan, "bitflip_grad")):
        return None
    import numpy as np

    if scope is None:
        from ..fluid import core as _core

        scope = _core.global_scope()
    for name in sorted(p.name for p in program.all_parameters()):
        val = scope.get(name)
        if val is None:
            continue
        arr = np.array(np.asarray(
            val.numpy() if hasattr(val, "numpy") else val
        ))
        flat = arr.reshape(-1)
        if flat.size == 0 or flat.dtype not in (np.float32, np.float64):
            continue
        bits = flat.view(np.uint32 if flat.dtype == np.float32
                         else np.uint64)
        bits[0] ^= np.array(1, bits.dtype)
        scope.set(name, arr)
        print(
            "CHAOS bitflip_grad step=%d var=%s pid=%d"
            % (step, name, os.getpid()),
            flush=True,
        )
        return name
    return None


def maybe_rpc_error(what):
    """Pserver-client hook: raise ConnectionError for the first
    ``rpc_fail_n`` guarded calls in this process (then heal), modeling a
    pserver that is mid-restart."""
    global _rpc_faults_raised
    plan = active_plan()
    if plan is None or plan.rpc_fail_n <= 0 or not plan.targets_me():
        return
    with _lock:
        if _rpc_faults_raised >= plan.rpc_fail_n:
            return
        _rpc_faults_raised += 1
        n = _rpc_faults_raised
    raise ConnectionError(
        "chaos: injected rpc failure %d/%d (%s)" % (n, plan.rpc_fail_n, what)
    )
