"""Elastic world-size contract: env vars, availability markers, batch math
(port of ``paddle_tpu/distributed/elastic.py``).

A fixed-size supervisor can only restore a gang at its original size — a
preempted host stranded the job until every worker returned. True
elasticity needs three pieces that live here because FOUR layers share
them (supervisor, trainer, chaos harness, checkpoint manager):

1. **Env contract** — the supervisor injects the CURRENT topology into
   every worker on each (re)start: ``PADDLE_TPU_WORLD_SIZE`` /
   ``PADDLE_TPU_RANK`` (contiguously remapped per attempt),
   ``PADDLE_TPU_BASE_WORLD_SIZE`` (the full gang the job was submitted
   with — degradation is measured against it), and
   ``PADDLE_TPU_GANG_SLOT`` (the worker's STABLE identity: its original
   spec rank, unchanged by remapping, so per-slot faults and
   availability stay addressable across resizes). ``world_info()``
   reads the contract back with legacy ``PADDLE_TRAINER_*`` fallbacks.

2. **Availability (down) markers** — the supervisor's launchability
   probe. A slot with a live marker file is excluded from the next gang
   plan; expiry is counted in *planning events* (``down_for`` plans
   observe it down, then the slot is launchable again — deterministic
   across supervisor restarts, which wall-clock TTLs are not), or
   ``down_for < 0`` keeps the slot down until the marker is deleted
   (operator / resource manager says the host is back). Markers are
   written by whoever knows the slot is gone: the chaos ``lose_rank``
   fault (worker self-reports then exits 143), the supervisor itself on
   a spawn failure, or an external scheduler via plain ``echo >file``.
   Each worker learns its own marker path via ``PADDLE_TPU_DOWN_FILE``.

3. **Global-batch / LR math** — a shrunk gang must converge like the
   fixed gang. ``batch_plan()`` computes the gradient-accumulation
   factor that preserves the global batch (arXiv:2004.13336's
   per-replica weight update survives because step index == global
   batch index stays true); ``maybe_rescale_lr()`` is the alternative
   strategy (keep per-rank batch, linearly rescale LR to the shrunk
   global batch, opt-in via ``FLAGS_elastic_lr_rescale``) applied
   relative to the world size the checkpoint was SAVED at, so repeated
   resumes never compound the factor.
"""

from __future__ import annotations

import collections
import json
import math
import os

__all__ = [
    "WORLD_ENV",
    "RANK_ENV",
    "BASE_WORLD_ENV",
    "SLOT_ENV",
    "DOWN_FILE_ENV",
    "WorldInfo",
    "world_info",
    "write_down_marker",
    "read_down_marker",
    "BatchPlan",
    "batch_plan",
    "maybe_rescale_lr",
]

WORLD_ENV = "PADDLE_TPU_WORLD_SIZE"
RANK_ENV = "PADDLE_TPU_RANK"
BASE_WORLD_ENV = "PADDLE_TPU_BASE_WORLD_SIZE"
SLOT_ENV = "PADDLE_TPU_GANG_SLOT"
DOWN_FILE_ENV = "PADDLE_TPU_DOWN_FILE"


WorldInfo = collections.namedtuple(
    "WorldInfo", ["rank", "world_size", "base_world_size", "slot"]
)


def _env_int(env, name, default):
    try:
        return int(env.get(name, ""))
    except (TypeError, ValueError):
        return default


def world_info(environ=None):
    """The topology this process runs under. Prefers the elastic
    ``PADDLE_TPU_*`` contract (remapped per restart attempt), falls back
    to the legacy launcher vars, then to a single-process default.
    ``base_world_size`` is the submitted gang size; ``world_size <
    base_world_size`` means this attempt runs degraded."""
    env = os.environ if environ is None else environ
    world = _env_int(env, WORLD_ENV, None)
    if world is None:
        world = _env_int(env, "PADDLE_TRAINERS_NUM", 1)
    rank = _env_int(env, RANK_ENV, None)
    if rank is None:
        rank = _env_int(env, "PADDLE_TRAINER_ID", 0)
    base = _env_int(env, BASE_WORLD_ENV, world)
    slot = _env_int(env, SLOT_ENV, rank)
    return WorldInfo(rank=rank, world_size=max(world, 1),
                     base_world_size=max(base, 1), slot=slot)


# ---------------------------------------------------------------------------
# availability markers (the supervisor's launchability probe)
# ---------------------------------------------------------------------------
def write_down_marker(path, down_for=-1, slot=None, from_attempt=None,
                      attempts_down=0, reason=None):
    """Atomically write a down marker: this slot is unlaunchable for the
    next ``down_for`` gang plans (< 0 = until the file is deleted)."""
    import time

    payload = {
        "down_for": int(down_for),
        "attempts_down": int(attempts_down),
        "ts": time.time(),
    }
    if slot is not None:
        payload["slot"] = int(slot)
    if from_attempt is not None:
        payload["from_attempt"] = int(from_attempt)
    if reason is not None:
        payload["reason"] = str(reason)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = "%s.tmp.%d" % (path, os.getpid())
    with open(tmp, "w") as f:
        f.write(json.dumps(payload, sort_keys=True))
    os.replace(tmp, path)
    return payload


def read_down_marker(path):
    """Parse a down marker -> dict, or None when absent. A torn/garbage
    marker reads as ``down_for=-1`` (down until deleted): an unreadable
    availability claim must fail SAFE — never launch onto a slot whose
    state is unknown."""
    try:
        with open(path) as f:
            text = f.read()
    except OSError as e:
        import errno

        if e.errno in (errno.ENOENT, errno.ENOTDIR):
            return None
        # the marker EXISTS but cannot be read (EACCES, EIO, ...): same
        # fail-safe as a torn payload — the slot stays down until the
        # claim becomes readable or the file is deleted
        return {
            "down_for": -1, "attempts_down": 0, "torn": True,
            "read_error": str(e),
        }
    try:
        data = json.loads(text)
        if not isinstance(data, dict):
            raise ValueError(text)
    except ValueError:
        data = {"down_for": -1, "attempts_down": 0, "torn": True}
    data.setdefault("down_for", -1)
    data.setdefault("attempts_down", 0)
    return data


# ---------------------------------------------------------------------------
# global-batch preservation / LR rescaling math
# ---------------------------------------------------------------------------
BatchPlan = collections.namedtuple(
    "BatchPlan",
    [
        "world_size",            # ranks this attempt runs with
        "base_world_size",       # ranks the job was submitted with
        "per_rank_batch",        # unchanged per-rank micro-batch
        "accum_steps",           # grad-accumulation factor preserving G
        "global_batch",          # target G = base * per_rank_batch
        "effective_global_batch",  # world * per_rank_batch * accum
        "lr_scale",              # linear-scaling correction for the
                                 # (rounded-up) effective batch; 1.0
                                 # when base % world == 0
    ],
)


def batch_plan(base_world_size, world_size, per_rank_batch=1):
    """How a ``world_size``-rank attempt preserves the global batch of a
    ``base_world_size``-rank job: keep the per-rank batch, accumulate
    ``accum_steps`` micro-batches per optimizer update. When the shrink
    doesn't divide evenly the effective batch rounds UP (never silently
    train on a smaller batch than submitted) and ``lr_scale`` carries
    the linear-scaling correction for the overshoot. With this plan one
    optimizer step consumes >= one submitted global batch, so a
    step-indexed LR schedule stays in global-sample space across
    shrink/regrow — the convergence property dist_crash_probe asserts."""
    base = max(int(base_world_size), 1)
    world = max(int(world_size), 1)
    b = max(int(per_rank_batch), 1)
    accum = max(int(math.ceil(base / float(world))), 1)
    global_batch = base * b
    effective = world * b * accum
    return BatchPlan(
        world_size=world,
        base_world_size=base,
        per_rank_batch=b,
        accum_steps=accum,
        global_batch=global_batch,
        effective_global_batch=effective,
        lr_scale=effective / float(global_batch),
    )


def _scope_or_global(scope):
    from ..fluid import core

    return scope if scope is not None else core.global_scope()


def maybe_rescale_lr(program, scope=None, restore_info=None):
    """Opt-in (``FLAGS_elastic_lr_rescale``) alternative to gradient
    accumulation: per-rank batch stays fixed, so a shrunk gang's global
    batch shrinks by ``world/base`` — apply the linear-scaling rule to
    the program's global learning-rate variable(s) by the same factor.

    The factor is computed against the world size the restored
    checkpoint was SAVED at (``restore_info['world_size_saved']``,
    stamped by CheckpointManager) — the LR variable is itself a
    persistable that round-trips through checkpoints, so scaling
    against the BASE each life would compound the correction on every
    resume at the same degraded size. A fresh start scales against the
    base. Returns the factor applied, or None when disarmed / at parity.
    """
    import numpy as np

    from ..fluid import flags as _flags
    from ..fluid import profiler as _profiler

    if not bool(_flags.get_flag("elastic_lr_rescale", False)):
        return None
    info = world_info()
    saved_world = None
    if restore_info:
        saved_world = restore_info.get("world_size_saved")
    if not saved_world:
        saved_world = info.base_world_size
    factor = info.world_size / float(saved_world)
    if factor == 1.0:
        return None
    scope = _scope_or_global(scope)
    scaled = 0
    for v in program.list_vars():
        if not getattr(v, "persistable", False):
            continue
        if not v.name.startswith("learning_rate"):
            continue
        val = scope.get(v.name)
        if val is None:
            continue
        arr = np.asarray(val.numpy() if hasattr(val, "numpy") else val)
        scope.set(v.name, (arr * factor).astype(arr.dtype))
        scaled += 1
    if scaled:
        _profiler.bump_counter("elastic_lr_rescales")
        print(
            "elastic: rescaled %d learning-rate var(s) by %.4f "
            "(world %d, checkpoint saved at world %d)"
            % (scaled, factor, info.world_size, saved_world),
            flush=True,
        )
        return factor
    return None
