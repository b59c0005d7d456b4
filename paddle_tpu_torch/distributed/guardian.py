"""Training guardian — data-plane fault tolerance for long runs (port of
``paddle_tpu/distributed/guardian.py``).

The supervisor restarts crashed or hung gangs; what kills a long run at
scale is a data failure — a NaN-poisoned batch, a loss spike, a gradient
explosion, or silent data corruption (SDC) in one replica's update —
which propagates into every checkpoint. The guardian has four pieces:

1. **In-graph health signal** — ``attach_health_fetch`` appends one
   ``reduce_sum(square(cast(g, fp32)))`` partial per parameter gradient
   to the step program; the guardian sums the partials on the host into
   the global grad norm, which is also the NaN/Inf detector (a
   non-finite gradient makes its partial non-finite). The fetch list is
   the same every step, so the Executor builds its plan once.

2. **Host anomaly policy** — NaN/Inf (``fluid.debugger.nonfinite_kind``)
   is an anomaly at once; loss spikes and grad-norm explosions are
   judged by a robust rolling window (EWMA center, MAD scale,
   ``guardian_spike_sigma``). AMP dynamic-loss-scaling backoff steps are
   exempt, within a bound (``_AMP_BACKOFF_RUN_LIMIT``), and the health
   series is normalized by the loss scale the grads were computed under.

3. **Response ladder** — skip the step, then roll back to the newest
   *verified* checkpoint (``CheckpointManager.newest_verified_step``)
   and replay the stream without the poisoned batches, then a
   structured ``GuardianGiveup``. Poisoned steps persist as marker files
   (``guardian_marker_dir``), so a bad batch never rollback-loops.

   The port's optimizer ops (``sgd``, ``momentum``, ``adam``) update
   parameters and moments in place, so the skip shadow is a copy:
   ``pre_step`` clones every persistable on its device and records the
   scope's generator states; ``restore_skip`` copies the clones back in
   place and sets the generators back (the reference keeps references
   to immutable arrays and decrements a run counter).

4. **Cross-replica SDC digest** — every ``guardian_digest_interval``
   steps a rank publishes a crc32 over its health scalar and a strided
   sample of every parameter through its heartbeat file; the supervisor
   majority-votes and quarantines a diverging rank."""

import collections
import json
import math
import os
import re
import time
import zlib

import numpy as np
import torch

__all__ = [
    "GuardianGiveup",
    "RollbackSignal",
    "RobustWindow",
    "Guardian",
    "attach_health_fetch",
    "state_digest",
]

# persisted poisoned-step markers (FLAGS_guardian_marker_dir): chaos-style
# one-shot files — `poisoned_step_<N>` exists means batch N is dropped
# from every (re)play in this run's lineage
_MARKER_RE = re.compile(r"^poisoned_step_(\d+)$")

# digest sampling bound: at most this many elements per tensor feed the
# crc32 (strided), so the per-publish D2H stays O(KB) on big models
_DIGEST_SAMPLE = 4096

# AMP backoff exemption bound: a LEGITIMATE found_inf episode resolves
# in a handful of steps (each backoff shrinks the scale by decr_ratio);
# this many CONSECUTIVE backoffs means the grads are non-finite at any
# scale — a NaN weight or corrupted state, not overflow — and the
# ladder takes over (skip restores nothing useful, but rollback does)
_AMP_BACKOFF_RUN_LIMIT = 50


class GuardianGiveup(RuntimeError):
    """The response ladder is exhausted (skips spent, rollbacks spent —
    or no verified checkpoint to roll back to). Carries a structured
    ``report`` dict so the supervisor log / operator sees what was
    tried, not just a traceback."""

    def __init__(self, report):
        self.report = dict(report)
        super().__init__(
            "guardian giveup: %s" % json.dumps(self.report, sort_keys=True)
        )


class RollbackSignal(Exception):
    """Control flow, not an error: the trainer unwinds its step loop to
    restore the newest verified checkpoint and replay the stream."""

    def __init__(self, step, kind):
        super().__init__("guardian rollback from step %d (%s)" % (step, kind))
        self.step = int(step)
        self.kind = str(kind)


class RobustWindow(object):
    """Spike detector over one scalar series: EWMA center + MAD scale.

    ``judge(x)`` returns ``(is_spike, z)``. The center is an EWMA (so a
    trending loss curve is followed, not flagged); the scale is the
    median absolute residual from the center over a bounded window,
    made Gaussian-consistent by the 1.4826 factor, with a floor of
    ``1e-3 + 1%% of |center|`` so a plateaued series (MAD -> 0) does not
    flag every fluctuation. Spikes are NOT admitted into the window —
    one outlier must not inflate the scale that judges the next."""

    def __init__(self, sigma, window, warmup, alpha=0.2):
        self.sigma = float(sigma)
        self.warmup = max(int(warmup), 1)
        self.alpha = float(alpha)
        self._ewma = None
        self._resid = collections.deque(maxlen=max(int(window), 4))
        self._n = 0

    def _admit(self, x):
        if self._ewma is None:
            self._ewma = x
        else:
            self._resid.append(abs(x - self._ewma))
            self._ewma += self.alpha * (x - self._ewma)
        self._n += 1

    def judge(self, x):
        x = float(x)
        if not math.isfinite(x):
            return True, float("inf")
        if self._n < self.warmup or len(self._resid) < 2:
            self._admit(x)
            return False, 0.0
        resid = sorted(self._resid)
        mad = resid[len(resid) // 2]
        scale = max(1.4826 * mad, 1e-3 + 0.01 * abs(self._ewma))
        z = abs(x - self._ewma) / scale
        if z > self.sigma:
            return True, z
        self._admit(x)
        return False, z

    def reset(self):
        self._ewma = None
        self._resid.clear()
        self._n = 0


# ---------------------------------------------------------------------------
# in-graph health fetch
# ---------------------------------------------------------------------------
def attach_health_fetch(program):
    """Append per-gradient partial reductions to ``program``: one
    ``sum(cast(g_p, fp32)^2)`` scalar PER parameter gradient. Returns
    the list of partial Variables (fetch them alongside the loss; the
    guardian host-sums the scalars and takes the sqrt — the global grad
    norm), or an empty list when the program has no parameter gradients
    (inference / forward-only programs).

    The ops ride the same step program, and the fetch set is the same
    every step, so the Executor plans it once. Grads are cast to fp32
    before squaring so a low-precision build cannot overflow inside the
    detector; a NaN/Inf in any grad propagates into its partial and from
    there into the host sum.

    Deliberately not one fused in-graph scalar: each partial's only
    input is its own gradient, so no single op joins every grad (the
    reference measured a joined form serializing the backward). The host
    pays len(grads) tiny scalar reads instead."""
    from ..fluid import core
    from ..fluid.framework import program_guard
    from ..fluid.layers import nn as _lnn
    from ..fluid.layers import ops as _lops
    from ..fluid.layers import tensor as _ltensor
    from ..fluid.ops.registry import GRAD_SUFFIX

    # idempotent per program: train() is legitimately re-entered on the
    # same Program (a training loop surviving SIGTERM), and a second set
    # of appended reductions would run every step without ever being
    # fetched
    cached = program.__dict__.get("_guardian_health_partials")
    if cached is not None:
        return list(cached)
    block = program.global_block()
    grads = []
    for p in program.all_parameters():
        g = block._find_var_recursive(p.name + GRAD_SUFFIX)
        if g is not None:
            grads.append(g)
    partials = []
    with program_guard(program):
        for g in grads:
            if g.dtype != core.VarDesc.VarType.FP32:
                g = _ltensor.cast(g, "float32")
            partials.append(_lnn.reduce_sum(_lops.square(g)))
    program._guardian_health_partials = list(partials)
    return partials


# ---------------------------------------------------------------------------
# cross-replica state digest
# ---------------------------------------------------------------------------
def state_digest(param_names, scope, health=None):
    """Cheap deterministic digest of one replica's post-update state:
    crc32 over the health scalar's bits plus a strided sample (at most
    ``_DIGEST_SAMPLE`` elements) of every parameter. Identical replicas
    produce identical digests bit-for-bit; a single flipped parameter
    bit (SDC) diverges it. Returns an 8-hex-digit string."""
    crc = 0
    if health is not None and math.isfinite(float(health)):
        crc = zlib.crc32(np.float64(health).tobytes(), crc)
    for name in param_names:
        val = scope.get(name)
        if val is None:
            continue
        crc = zlib.crc32(_sample_bytes(val), crc)
    return "%08x" % (crc & 0xFFFFFFFF)


def _sample_bytes(val):
    """The bytes of a strided sample (at most ``_DIGEST_SAMPLE``
    elements) of one value, taken where the value lives (only the
    sample crosses to the host): the reference's bytes for the same
    values."""
    if isinstance(val, torch.Tensor):
        flat = val.detach().reshape(-1)
        if flat.numel() > _DIGEST_SAMPLE:
            flat = flat[:: max(1, flat.numel() // _DIGEST_SAMPLE)]
        flat = flat.cpu().contiguous()
        if flat.dtype == torch.bfloat16:
            flat = flat.view(torch.int16)
        return flat.numpy().tobytes()
    arr = np.asarray(val.numpy() if hasattr(val, "numpy") else val)
    flat = np.ascontiguousarray(arr).reshape(-1)
    if flat.size > _DIGEST_SAMPLE:
        flat = flat[:: max(1, flat.size // _DIGEST_SAMPLE)]
    return np.ascontiguousarray(flat).tobytes()


# ---------------------------------------------------------------------------
# the guardian
# ---------------------------------------------------------------------------
class Guardian(object):
    """One training run's health guardian (created per ``train()`` call
    by ``fluid/trainer.py`` when ``FLAGS_guardian_enable``)."""

    VERDICT_OK = "ok"
    VERDICT_SKIP = "skip"

    @classmethod
    def maybe_create(cls, program, ckpt_manager=None):
        from ..fluid import flags as _flags

        if not bool(_flags.get_flag("guardian_enable", False)):
            return None
        if getattr(program, "_pipeline_config", None):
            # a stage-partitioned pipeline program owns its op layout;
            # reductions appended after the cut would straddle stages
            return None
        return cls(program, ckpt_manager=ckpt_manager)

    def __init__(self, program, ckpt_manager=None):
        from ..fluid import flags as _flags
        from ..fluid.io import is_persistable

        self.program = program
        self.ckpt_manager = ckpt_manager
        self.sigma = float(_flags.get_flag("guardian_spike_sigma", 6.0))
        window = int(_flags.get_flag("guardian_spike_window", 64))
        warmup = int(_flags.get_flag("guardian_warmup_steps", 8))
        self.max_skips = int(_flags.get_flag("guardian_max_skips", 2))
        self.max_rollbacks = int(
            _flags.get_flag("guardian_max_rollbacks", 1)
        )
        self.digest_interval = int(
            _flags.get_flag("guardian_digest_interval", 0)
        )
        self.marker_dir = str(
            _flags.get_flag("guardian_marker_dir", "") or ""
        ) or None
        self._loss_window = RobustWindow(self.sigma, window, warmup)
        self._health_window = RobustWindow(self.sigma, window, warmup)
        self.health_vars = attach_health_fetch(program)
        # AMP dynamic loss scaling present? fetch the scale so backoff
        # steps (scale shrinks, grads masked) are exempt, not anomalies
        # (name-prefix match: create_global_var may uniquify the
        # decorator's "loss_scaling"; the good-steps counter is not it)
        self.loss_scale_var = None
        for v in program.list_vars():
            if (getattr(v, "persistable", False)
                    and v.name.startswith("loss_scaling")
                    and "good_steps" not in v.name):
                self.loss_scale_var = v
                break
        self.extra_fetches = list(self.health_vars) + (
            [self.loss_scale_var] if self.loss_scale_var is not None else []
        )
        self._persist_names = sorted(
            v.name for v in program.list_vars() if is_persistable(v)
        )
        self._param_names = sorted(
            p.name for p in program.all_parameters()
        )
        self._shadow = None
        self._shadow_rng = None
        self._prev_scale = None
        self._shadow_prev_scale = None
        self._amp_backoff_run = 0
        self._last_health = None
        self.skips_used = 0
        self.rollbacks_used = 0
        self.drop_steps = set(self._read_markers())
        self.stats = {
            "anomalies": 0,
            "skips": 0,
            "rollbacks": 0,
            "amp_backoff_steps": 0,
            "dropped_steps": 0,
            "kinds": {},
        }

    # -- fetch plumbing -----------------------------------------------------

    def wrap_fetches(self, fetch_list):
        """The trainer's real fetch list: user fetches + the guardian's
        health/scale extras (constant across steps — same compiled
        program every step)."""
        return list(fetch_list or []) + self.extra_fetches

    def split_outs(self, outs):
        """(user_outs, extra_outs) from one run's fetched values."""
        n = len(self.extra_fetches)
        if n == 0:
            return outs, []
        return outs[:-n], outs[-n:]

    # -- markers (poisoned-batch persistence) --------------------------------

    def _read_markers(self):
        if not self.marker_dir:
            return []
        try:
            names = os.listdir(self.marker_dir)
        except OSError:
            return []
        steps = []
        for n in names:
            m = _MARKER_RE.match(n)
            if m:
                steps.append(int(m.group(1)))
        return steps

    def _write_marker(self, step, kind):
        if not self.marker_dir:
            return
        os.makedirs(self.marker_dir, exist_ok=True)
        path = os.path.join(self.marker_dir, "poisoned_step_%d" % step)
        tmp = "%s.tmp.%d" % (path, os.getpid())
        try:
            with open(tmp, "w") as f:
                f.write(json.dumps(
                    {"step": int(step), "kind": kind, "ts": time.time()}
                ))
            os.replace(tmp, path)
        except OSError:
            pass  # marker persistence is best-effort; in-memory set rules

    # -- per-step protocol ---------------------------------------------------

    def should_drop(self, step):
        """True when this batch was identified as poisoned by an earlier
        anomaly (this life or, via markers, a previous one): consume it
        from the stream without running — the surviving data schedule."""
        return step in self.drop_steps

    def note_dropped(self, step):
        self.stats["dropped_steps"] += 1

    def pre_step(self, scope):
        """Copy the pre-step state: a clone of every persistable on its
        device (the step's optimizer ops update the originals in place)
        and the scope's generator states, so a skip verdict restores
        both bit for bit."""
        from ..fluid import core

        scope = scope if scope is not None else core.global_scope()
        shadow = {}
        with torch.no_grad():
            for n in self._persist_names:
                v = scope.get(n)
                shadow[n] = v.detach().clone() if isinstance(
                    v, torch.Tensor) else v
        self._shadow = shadow
        self._shadow_rng = scope.rng_states()
        # a skip restores the loss_scaling var too — the host-side
        # mirror must revert with it or the next AMP normalization
        # divides by a scale the grads were never computed under
        self._shadow_prev_scale = self._prev_scale

    def digest_due(self, step):
        return (self.digest_interval > 0
                and step % self.digest_interval == 0)

    def state_digest(self, scope):
        from ..fluid import core

        scope = scope if scope is not None else core.global_scope()
        return state_digest(
            self._param_names, scope, health=self._last_health
        )

    def post_step(self, step, outs):
        """Judge one completed step from its fetched values. Returns
        ``(user_outs, verdict)`` — verdict ``"ok"`` or ``"skip"`` — or
        raises RollbackSignal / GuardianGiveup per the response
        ladder.

        Contract: ``user_outs[0]`` is treated as the training loss
        (the fluid trainer's loss-first fetch_list convention — every
        probe and print_period consumer shares it); a non-scalar or
        non-float first fetch is simply not judged by the loss
        policies (grad-norm health still is)."""
        from ..fluid.debugger import nonfinite_kind

        user_outs, extra = self.split_outs(outs)
        health = None
        scale = None
        n = len(self.health_vars)
        if n:
            # host-side join of the per-grad partials (see
            # attach_health_fetch for why the join is NOT in-graph):
            # sum of squares is >= 0 or non-finite, so sqrt never
            # domain-errors; NaN/Inf in any partial propagates
            ssq = math.fsum(
                float(np.asarray(extra[j]).ravel()[0]) for j in range(n)
            )
            health = math.sqrt(ssq) if math.isfinite(ssq) else ssq
        if self.loss_scale_var is not None:
            scale = float(np.asarray(extra[n]).ravel()[0])
            # under AMP the @GRAD vars hold grads of the SCALED loss,
            # so the raw series would step 2x on every routine
            # loss-scale increase — a fake "grad explosion" to the
            # spike window. Normalize by the scale the grads were
            # actually computed under: the value fetched LAST step
            # (update_loss_scaling rewrites the var in-graph before
            # this step's fetch sees it), making the health series the
            # UNSCALED global grad norm, invariant to scaler moves.
            norm_by = (
                self._prev_scale if self._prev_scale is not None
                else scale
            )
            if (health is not None and math.isfinite(health)
                    and math.isfinite(norm_by) and norm_by > 0):
                health /= norm_by
        loss = None
        if user_outs and user_outs[0] is not None:
            arr = np.asarray(user_outs[0])
            if arr.size and np.issubdtype(arr.dtype, np.floating):
                loss = float(arr.ravel()[0])
        self._last_health = health

        loss_bad = loss is not None and nonfinite_kind(
            np.float64(loss)
        ) is not None
        health_bad = health is not None and not math.isfinite(health)

        kind = None
        if loss_bad:
            kind = "nan_inf_loss"
        elif health_bad:
            # AMP dynamic loss scaling: non-finite grads under a
            # finite loss are the scaler WORKING (found_inf masks the
            # update and shrinks the scale) — exempt, keeping the
            # spike windows untouched (a backoff step is not a sample
            # of the healthy series). But only while the scaler's
            # story holds: the scale must not have GROWN (growth means
            # found_inf did not fire — the non-finite grads came from
            # somewhere else), and the consecutive-backoff run is
            # bounded (persistent non-finite grads at ever-shrinking
            # scale are corruption, not overflow).
            backed_off = (
                scale is not None
                and (self._prev_scale is None
                     or scale <= self._prev_scale)
            )
            if (backed_off
                    and self._amp_backoff_run < _AMP_BACKOFF_RUN_LIMIT):
                self._amp_backoff_run += 1
                self.stats["amp_backoff_steps"] += 1
                self._prev_scale = scale
                return user_outs, self.VERDICT_OK
            kind = "nan_inf_grad"
        else:
            self._amp_backoff_run = 0
            if loss is not None:
                spike, z = self._loss_window.judge(loss)
                if spike:
                    kind = "loss_spike"
            if kind is None and health is not None:
                spike, z = self._health_window.judge(health)
                if spike:
                    kind = "grad_explosion"
        self._prev_scale = scale
        if kind is None:
            return user_outs, self.VERDICT_OK
        return user_outs, self._anomaly(step, kind, loss, health)

    def on_nan_error(self, step, err):
        """The FLAGS_check_nan_inf post-run scan raised before the
        trainer saw any fetched values: same immediate-anomaly path,
        attributed to the offending fetch var."""
        return self._anomaly(
            step, "nan_inf_fetch:%s" % getattr(err, "var_name", "?"),
            None, None,
        )

    def _anomaly(self, step, kind, loss, health):
        """Walk the response ladder for one anomalous step. Returns
        VERDICT_SKIP, or raises RollbackSignal / GuardianGiveup."""
        from ..fluid import profiler as _profiler

        _profiler.bump_counter("train_anomalies")
        self.stats["anomalies"] += 1
        self.stats["kinds"][kind] = self.stats["kinds"].get(kind, 0) + 1
        self.drop_steps.add(step)
        self._write_marker(step, kind)
        print(
            "guardian: ANOMALY step=%d kind=%s loss=%s health=%s"
            % (step, kind, loss, health),
            flush=True,
        )
        if self.skips_used < self.max_skips:
            self.skips_used += 1
            self.stats["skips"] += 1
            _profiler.bump_counter("train_skipped_steps")
            return self.VERDICT_SKIP
        if (self.ckpt_manager is not None
                and self.rollbacks_used < self.max_rollbacks):
            raise RollbackSignal(step, kind)
        raise GuardianGiveup({
            "anomaly_step": step,
            "kind": kind,
            "loss": loss,
            "health": health,
            "skips_used": self.skips_used,
            "rollbacks_used": self.rollbacks_used,
            "max_skips": self.max_skips,
            "max_rollbacks": self.max_rollbacks,
            "has_ckpt_manager": self.ckpt_manager is not None,
        })

    # -- responses -----------------------------------------------------------

    def restore_skip(self, scope, program=None):
        """Discard the just-applied update: copy the ``pre_step`` clones
        back into the scope's tensors in place, and set the generators
        back to their pre-step states (so dropout masks line up with a
        clean run on the surviving schedule)."""
        from ..fluid import core

        scope = scope if scope is not None else core.global_scope()
        if self._shadow is None:
            raise RuntimeError("restore_skip without a pre_step shadow")
        with torch.no_grad():
            for n, v in self._shadow.items():
                if v is None:
                    continue
                held = scope.get(n)
                if (isinstance(v, torch.Tensor)
                        and isinstance(held, torch.Tensor)
                        and held.shape == v.shape
                        and held.dtype == v.dtype):
                    held.copy_(v)
                else:
                    scope.set(n, v)
        if self._shadow_rng is not None:
            scope.set_rng_states(self._shadow_rng)
        self._prev_scale = self._shadow_prev_scale

    def execute_rollback(self, signal, scope, hb=None):
        """Restore the newest VERIFIED checkpoint, discard now-stale
        newer step dirs, and return the restored step (the trainer
        resumes the stream at restored+1 with the poisoned batch
        dropped). A multi-second restore beats ``status="rollback"``
        so the supervisor judges it under the startup-style grace."""
        from ..fluid import core
        from ..fluid import profiler as _profiler

        mgr = self.ckpt_manager
        t0 = time.perf_counter()
        if hb is not None:
            hb.beat(signal.step, status="rollback", force=True)
        try:
            mgr.wait()  # drain in-flight saves; a stale writer error
        except Exception:  # must not mask the rollback itself
            pass
        target = mgr.newest_verified_step()
        if target is None:
            raise GuardianGiveup({
                "anomaly_step": signal.step,
                "kind": signal.kind,
                "reason": "no_verified_checkpoint",
                "skips_used": self.skips_used,
                "rollbacks_used": self.rollbacks_used,
            })
        mgr.discard_steps_after(target)
        scope = scope if scope is not None else core.global_scope()
        restored = mgr.restore(self.program, scope=scope, step=target)
        self.rollbacks_used += 1
        self.stats["rollbacks"] += 1
        # replayed steps re-enter the spike windows; judging them
        # against pre-rollback statistics would double-count the series
        self._loss_window.reset()
        self._health_window.reset()
        self._prev_scale = None
        self._shadow_prev_scale = None
        self._amp_backoff_run = 0
        self._shadow = None
        self._shadow_rng = None
        _profiler.bump_counter("train_rollbacks")
        _profiler.bump_histogram(
            "guardian_rollback_ms", (time.perf_counter() - t0) * 1000.0
        )
        print(
            "guardian: ROLLBACK anomaly_step=%d -> restored step %d "
            "(%.0f ms), dropping %s on replay"
            % (signal.step, restored,
               (time.perf_counter() - t0) * 1000.0,
               sorted(self.drop_steps)),
            flush=True,
        )
        return restored
