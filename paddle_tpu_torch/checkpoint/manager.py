"""CheckpointManager — fault-tolerant async checkpointing (port of
``paddle_tpu/checkpoint/manager.py``).

A checkpoint must be (a) atomic — fully committed or invisible, (b) off
the step's critical path — serialization and disk I/O on a background
thread while the card keeps stepping, and (c) resumable bit for bit —
parameters, optimizer accumulators, the step counter, AND the scope's
random generators all round-trip.

Commit protocol (Orbax-style two-phase):

    1. snapshot  — a copy of every persistable at save() time on the
                   caller thread: a device clone for a tensor on the
                   card (queued on the caller's stream, so it is taken
                   before the next step's in-place optimizer updates),
                   a host copy for a CPU tensor. The port's optimizer
                   ops update parameters and moments in place, so a
                   reference (the reference's immutable jax arrays) is
                   not a snapshot. The writer thread copies the clones
                   to pinned host memory on a stream of its own after
                   an event recorded behind them, then frees them.
    2. stage     — the writer serializes tensors in the reference's
                   LoDTensor stream format into ``tmp.step_<N>/`` next
                   to the final location, with a ``manifest.json``
                   recording per-tensor shape/dtype/offset/crc32.
    3. fsync     — data file, manifest, and the staging dir itself.
    4. publish   — ``os.replace(tmp.step_<N>, step_<N>)`` + fsync of the
                   parent dir. A rename is atomic on POSIX, so
                   ``latest_step()`` (which requires ``step_*/
                   manifest.json``) can never observe a torn state.

Random generators: the port's runs draw from the scope's generator pair
(``core.Scope.rng``: the device's and the CPU's, the latter giving the
flash kernels their dropout seeds). A manifest carries their states
under ``torch_generators``, and a restore sets them. The reference's
``rng_run_index`` stays null in a port manifest; a reference checkpoint
has no generator states, so its restore leaves the generators as they
are.

Sharded saves (multi-process DP/TP) keep the same protocol with one
twist: every rank stages ``tmp.step_<N>/shard_<rank>/`` independently
(its own data + ``shard_manifest.json``, renamed into place inside the
staging dir as the per-shard commit marker), and rank 0 alone performs
the publish once all shard manifests exist — mirroring the sharded
inference export's manifest conventions (inference SHARD_MANIFEST).

Elastic N->M restore (the resize contract, per arXiv:2112.01075's
redistribution framing — ours is filesystem-mediated, not collective):
``restore`` accepts a checkpoint written by N ranks into a manager with
M ranks. TP vars (``dist_attrs``) are concatenated along their saved
axis and re-sliced into M contiguous ``np.array_split`` pieces (exact
concat: the M pieces joined along the axis reproduce the N pieces
joined, bit for bit); replicated params and optimizer accumulators
(arXiv:2004.13336's per-replica weight-update state) pass through
bit-exactly — every rank reads all shards, so the round-robin write
partition at N is invisible at M. The N=1 edge replicates-and-partitions:
a var saved unsharded but listed in the restoring manager's
``dist_attrs`` is sliced to this rank's piece. Each manifest stamps the
gang ``world_size`` at save time and every restore records
``last_restore_info`` (step, world_size_saved, resharded, reshard_ms) —
``distributed/elastic.maybe_rescale_lr`` keys off it so LR corrections
never compound across repeated degraded resumes.
"""

import json
import os
import queue
import re
import shutil
import threading
import time
import zlib

import numpy as np
import torch

MANIFEST = "manifest.json"
SHARD_MANIFEST = "shard_manifest.json"
DATA_FILE = "state.pdckpt"
_STEP_RE = re.compile(r"^step_(\d+)$")
_TMP_PREFIX = "tmp.step_"
_FORMAT = 1


class CheckpointError(RuntimeError):
    pass


class ChecksumError(CheckpointError):
    """A committed tensor's bytes no longer match the manifest crc32."""


def _fsync_dir(path):
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_atomic(path, data):
    """Write bytes to ``path`` via same-dir tmp + fsync + os.replace
    (shared helper: ops/io_ops.py owns the one implementation)."""
    from ..fluid.ops.io_ops import _atomic_write

    _atomic_write(path, data)


def _step_dirname(step):
    return "step_%08d" % int(step)


def _shard_dirname(rank):
    return "shard_%05d" % int(rank)


def list_steps(dirname):
    """Committed steps (ascending). A step is committed iff its dir
    matched ``step_<N>`` AND contains a manifest — a crashed writer's
    ``tmp.step_*`` staging dir or a half-deleted GC victim is invisible."""
    steps = []
    try:
        entries = os.listdir(dirname)
    except OSError:
        return steps
    for name in entries:
        m = _STEP_RE.match(name)
        if not m:
            continue
        if os.path.isfile(os.path.join(dirname, name, MANIFEST)):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(dirname):
    steps = list_steps(dirname)
    return steps[-1] if steps else None


def _snapshot_value(value):
    """A copy of one scope value at snapshot time, as a tensor (a
    LoDTensor keeps its wrapper: the stream carries its offsets). A
    tensor on the card is cloned there, on the caller's stream; anything
    else is copied to a host tensor now."""
    from ..fluid import core

    if isinstance(value, core.LoDTensor):
        return core.LoDTensor(_snapshot_value(value.tensor()),
                              lod=value.lod())
    if isinstance(value, torch.Tensor):
        t = value.detach()
        return t.clone() if t.device.type == "cuda" else \
            t.to("cpu", copy=True)
    return torch.from_numpy(np.array(value))


def _tensor_of(value):
    from ..fluid import core

    return value.tensor() if isinstance(value, core.LoDTensor) else value


def _dtype_name(t):
    """The numpy spelling of a tensor's dtype ("bfloat16" for bf16), as
    the reference's manifests write it."""
    if t.dtype == torch.bfloat16:
        return "bfloat16"
    return str(torch.empty((), dtype=t.dtype).numpy().dtype)


def _nbytes(value):
    t = _tensor_of(value)
    return int(t.numel() * t.element_size())


def _to_host(snap):
    """The snapshot's tensors on the host. Clones on the card are copied
    to pinned memory on a stream of this thread's own, after the event
    the snapshot recorded behind them, and are dropped once the copies
    completed."""
    from ..fluid import core

    event = snap.pop("event", None)
    tensors = snap["tensors"]
    if event is None:
        return tensors
    stream = torch.cuda.Stream(device=snap.pop("device"))
    out = []
    with torch.cuda.stream(stream):
        stream.wait_event(event)
        for name, val in tensors:
            t = _tensor_of(val)
            if t.device.type == "cuda":
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=True)
                val = core.LoDTensor(host, lod=val.lod()) if isinstance(
                    val, core.LoDTensor) else host
            out.append((name, val))
    stream.synchronize()
    snap["tensors"] = out
    return out


def _encode_states(states):
    return {k: [bytes(d.numpy()).hex(), bytes(c.numpy()).hex()]
            for k, (d, c) in states.items()}


def _decode_states(enc):
    def t(h):
        return torch.frombuffer(bytearray(bytes.fromhex(h)),
                                dtype=torch.uint8)

    return {k: (t(d), t(c)) for k, (d, c) in enc.items()}


def _scope_device(scope):
    """The device of some tensor the scope holds, else the default."""
    from ..fluid import core

    s = scope
    while s is not None:
        for v in s._vars.values():
            t = _tensor_of(v.value)
            if isinstance(t, torch.Tensor):
                return t.device
        s = s._parent
    return core.resolve_device(None)


def _restore_value(scope, name, val, device):
    """Put one restored value in the scope: copied in place into the
    tensor it holds when shape and dtype agree (so whoever shares that
    tensor sees the restore), else set as a new tensor on ``device``."""
    from ..fluid import core

    held = scope.get(name)
    t = _tensor_of(val)
    if (isinstance(held, torch.Tensor) and not isinstance(val, core.LoDTensor)
            and held.shape == t.shape and held.dtype == t.dtype):
        with torch.no_grad():
            held.copy_(t)
        return
    if isinstance(val, core.LoDTensor):
        scope.set(name, core.LoDTensor(t.to(device), lod=val.lod()))
    else:
        scope.set(name, t.to(device))


class CheckpointManager(object):
    """Step-tagged atomic checkpoints with an async background writer.

    Args:
        dirname: root directory; step dirs are created under it.
        keep_max: newest K committed steps survive GC (None -> FLAGS_
            ckpt_keep_max; 0 = unbounded).
        keep_every_n_steps: steps divisible by N are additionally kept
            forever (None -> FLAGS_ckpt_keep_every_n_steps; 0 = off).
        async_depth: bounded writer-queue depth — at most this many
            snapshots in flight; a full queue back-pressures save()
            (None -> FLAGS_ckpt_async_depth).
        rank / nranks: sharded mode when nranks > 1 — this process
            writes ``shard_<rank>/`` and only rank 0 publishes.
        dist_attrs: {var_name: axis} for vars whose LOCAL shard each
            rank holds (TP); restore concatenates shards along ``axis``.
            Vars not listed are treated as replicated and partitioned
            round-robin across ranks for writing.
    """

    def __init__(self, dirname, keep_max=None, keep_every_n_steps=None,
                 async_depth=None, rank=0, nranks=1, dist_attrs=None,
                 commit_timeout_s=None):
        from ..fluid import flags as _flags

        self.dirname = str(dirname)
        self.keep_max = int(
            _flags.get_flag("ckpt_keep_max", 5) if keep_max is None
            else keep_max
        )
        self.keep_every_n_steps = int(
            _flags.get_flag("ckpt_keep_every_n_steps", 0)
            if keep_every_n_steps is None else keep_every_n_steps
        )
        depth = int(
            _flags.get_flag("ckpt_async_depth", 2)
            if async_depth is None else async_depth
        )
        self.commit_timeout_s = float(
            _flags.get_flag("ckpt_commit_timeout_s", 120.0)
            if commit_timeout_s is None else commit_timeout_s
        )
        self.rank = int(rank)
        self.nranks = int(nranks)
        self.dist_attrs = dict(dist_attrs or {})
        # stamped by every successful restore(): {step, world_size_saved,
        # nranks_saved, resharded, reshard_ms}. Elasticity-aware callers
        # (trainer LR rescale) read the world size the checkpoint was
        # SAVED at from here rather than assuming the submitted topology.
        self.last_restore_info = None
        # background scrubbing (FLAGS_ckpt_scrub): after each commit the
        # writer thread re-verifies committed steps' checksums off the
        # critical path, so rollback consumers (the training guardian)
        # can ask for the newest KNOWN-GOOD step instead of merely the
        # newest one. {step: bool} of scrub outcomes, lock-guarded —
        # the writer thread records, the trainer thread reads.
        self._auto_scrub = bool(_flags.get_flag("ckpt_scrub", False))
        self._scrub_state = {}
        self._scrub_lock = threading.Lock()
        os.makedirs(self.dirname, exist_ok=True)
        # resume-time hygiene: a crashed run's staging dirs are garbage.
        # Only rank 0 sweeps (peers may be slower to start, but no save
        # can be in flight before training begins, so this cannot race a
        # live writer).
        if self.rank == 0:
            self._sweep_stale_tmp()
        self._queue = queue.Queue(maxsize=max(depth, 1))
        self._error = None
        self._error_lock = threading.Lock()
        self._closed = False
        self._writer = threading.Thread(
            target=self._writer_loop, name="ckpt-writer", daemon=True
        )
        self._writer.start()

    # -- public API ---------------------------------------------------------

    def latest_step(self):
        return latest_step(self.dirname)

    def all_steps(self):
        return list_steps(self.dirname)

    def save(self, step, program=None, scope=None, async_=True):
        """Snapshot persistables from ``scope`` and commit them as
        ``step_<step>``. With ``async_`` the serialization + write + GC
        happen on the writer thread (bounded queue; a full queue blocks
        — back-pressure, never an unbounded host-memory pileup) and this
        returns after the snapshot (clones queued on the card);
        ``wait()`` barriers."""
        from ..fluid import profiler as _profiler
        from ..fluid.framework import default_main_program
        from ..observability import trace as _trace

        self._raise_pending()
        if self._closed:
            raise CheckpointError("save() on a closed CheckpointManager")
        program = program or default_main_program()
        t0 = time.perf_counter()
        # the snapshot is the only critical-path work of an async save —
        # its span sits on the caller's (step loop's) thread row
        with _trace.span("ckpt_snapshot", cat="ckpt", step=int(step)):
            snap = self._snapshot(program, scope)
        _profiler.bump_histogram(
            "ckpt_snapshot_ms", (time.perf_counter() - t0) * 1000.0
        )
        _profiler.bump_histogram(
            "ckpt_snapshot_bytes",
            float(sum(_nbytes(v) for _n, v in snap["tensors"])),
        )
        if async_:
            self._queue.put((int(step), snap))
        else:
            # serialize with in-flight async saves FIRST: the staging dir
            # name is deterministic per step (sharded peers must agree on
            # it), so a sync save racing the writer on the same step
            # would tear each other's tmp files; draining also keeps
            # commits arriving in step order for retention
            self._queue.join()
            self._raise_pending()
            self._write_checkpoint(int(step), snap)
            self._raise_pending()
        return self

    def wait(self):
        """Barrier: returns when every queued save has committed (or
        re-raises the writer's failure)."""
        self._queue.join()
        self._raise_pending()
        return self

    def close(self):
        """wait() then stop the writer thread. Idempotent."""
        if self._closed:
            return
        try:
            self._queue.join()
        finally:
            self._closed = True
            self._queue.put(None)  # sentinel
            self._writer.join(timeout=30)
        self._raise_pending()

    def restore(self, program=None, scope=None, step=None, executor=None):
        """Load ``step`` (default: latest committed) into the scope,
        verifying every tensor's crc32 against the manifest. Accepts a
        checkpoint written at any shard count (see module docstring:
        N->M resharding). Returns the restored step. Raises
        CheckpointError when nothing is committed and ChecksumError on
        corruption."""
        from ..fluid import core
        from ..fluid import profiler as _profiler
        from ..fluid.framework import default_main_program

        program = program or default_main_program()
        scope = scope or core.global_scope()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise CheckpointError(
                    "no committed checkpoint under %r" % self.dirname
                )
        step_dir = os.path.join(self.dirname, _step_dirname(step))
        manifest_path = os.path.join(step_dir, MANIFEST)
        if not os.path.isfile(manifest_path):
            raise CheckpointError(
                "step %d is not committed under %r" % (step, self.dirname)
            )
        with open(manifest_path) as f:
            manifest = json.load(f)
        nranks_saved = int(manifest.get("nranks", 1))
        state = {}
        if nranks_saved > 1:
            for shard in manifest["shards"]:
                self._read_shard(
                    os.path.join(step_dir, shard["dir"]), state
                )
        else:
            self._read_shard(step_dir, state)
        t0 = time.perf_counter()
        state, resliced = self._reassemble(state)
        reshard_ms = (time.perf_counter() - t0) * 1000.0
        resharded = nranks_saved != self.nranks and resliced > 0
        if resharded:
            _profiler.bump_counter("ckpt_resharded_restores")
            _profiler.bump_histogram("ckpt_reshard_ms", reshard_ms)
        device = executor.device if executor is not None else \
            _scope_device(scope)
        for name, val in state.items():
            _restore_value(scope, name, val, device)
        self._restore_rng(manifest, program, scope)
        self.last_restore_info = {
            "step": int(manifest["step"]),
            "nranks_saved": nranks_saved,
            # the gang size the writing job ran at. Manifests predating
            # the stamp report None — NOT the shard count, which is 1
            # for per-rank managers regardless of gang size, and a wrong
            # "saved at world 1" claim would make maybe_rescale_lr
            # multiply the LR by the full world. Unknown provenance must
            # read as "assume the submitted topology" (the rescaler's
            # None fallback), i.e. no correction.
            "world_size_saved": (
                int(manifest["world_size"])
                if manifest.get("world_size") else None
            ),
            "resharded": resharded,
            "resliced_vars": resliced,
            "reshard_ms": reshard_ms,
        }
        return int(manifest["step"])

    def restore_or_initialize(self, program=None, executor=None,
                              startup_program=None, scope=None):
        """Resume path for trainers: restore the latest committed step
        and return it, or run ``startup_program`` (when given) for a
        fresh start and return -1.

        Resilience (FLAGS_ckpt_restore_fallback, default on): when the
        newest step fails its crc32 manifest check (bit rot, a torn
        write that slipped past the atomic-commit protocol's
        assumptions, a half-synced remote mount), log the ChecksumError
        and fall back to the next-newest valid step — losing a few
        steps of progress beats losing the job. Only when EVERY
        committed step is damaged does the resume hard-fail (silently
        fresh-starting would discard the whole run's progress)."""
        import logging

        from ..fluid import flags as _flags
        from ..fluid import profiler as _profiler

        steps = self.all_steps()
        if not steps:
            if startup_program is not None:
                if executor is None:
                    raise CheckpointError(
                        "restore_or_initialize needs an executor to run "
                        "the startup program on a fresh start"
                    )
                executor.run(startup_program, scope=scope)
            return -1
        fallback = bool(_flags.get_flag("ckpt_restore_fallback", True))
        # Gang safety: ranks restore independently, so one rank falling
        # back to an older step while its peers load the newest would
        # silently train divergent replicas / misaligned collectives.
        # Inside a multi-worker gang the fallback therefore requires the
        # operator's EXPLICIT opt-in (identical-replica workloads, or
        # checkpoint storage shared by all ranks) — the default-on
        # behavior is for single-process training only.
        in_gang = self.nranks > 1 or int(
            os.environ.get("PADDLE_TRAINERS_NUM", "1")
        ) > 1
        if fallback and in_gang and not _flags.is_explicit(
            "ckpt_restore_fallback"
        ):
            fallback = False
        log = logging.getLogger("paddle_tpu_torch.checkpoint")
        newest_err = None
        # fallback is scoped to ON-DISK damage (failed crc, torn/missing
        # manifest or data file): a ValueError from e.g. restoring into a
        # mismatched program is a caller bug and must surface on the
        # first (newest) step, not walk the history mislabeled as bit rot
        for s in reversed(steps):
            try:
                return self.restore(
                    program, scope=scope, step=s, executor=executor
                )
            except (ChecksumError, CheckpointError, OSError,
                    json.JSONDecodeError) as e:
                if not fallback:
                    raise
                if newest_err is None:
                    newest_err = e
                _profiler.bump_counter("ckpt_restore_fallbacks")
                log.warning(
                    "restore_or_initialize: step %d under %r is damaged "
                    "(%s: %s); falling back to the next-newest "
                    "checkpoint", s, self.dirname, type(e).__name__, e,
                )
        raise CheckpointError(
            "every committed checkpoint under %r failed to restore "
            "(newest step's error: %s)" % (self.dirname, newest_err)
        )

    def verify(self, step=None):
        """Re-checksum a committed step without touching any scope (the
        crash probe's torn-checkpoint detector): every tensor's bytes
        against its manifest crc32, without decoding them. Returns the
        tensor count; raises ChecksumError/CheckpointError on any
        damage."""
        count = 0
        for _name, _val in self._iter_step_tensors(step, decode=False):
            count += 1
        return count

    # -- scrubbing (known-good rollback targets) ----------------------------

    def _scrub_one(self, step):
        """Verify one committed step, record the outcome, bump the
        ckpt_scrub_ok/_corrupt counters. Returns the bool outcome."""
        import logging

        from ..fluid import profiler as _profiler

        try:
            self.verify(step)
            ok = True
            _profiler.bump_counter("ckpt_scrub_ok")
        except (ChecksumError, CheckpointError, OSError, ValueError,
                KeyError) as e:
            ok = False
            _profiler.bump_counter("ckpt_scrub_corrupt")
            logging.getLogger("paddle_tpu_torch.checkpoint").warning(
                "scrub: step %d under %r is damaged (%s: %s)",
                step, self.dirname, type(e).__name__, e,
            )
        with self._scrub_lock:
            self._scrub_state[step] = ok
        return ok

    def scrub(self, recheck=False):
        """Re-verify committed steps' checksums (off the critical path
        when called from the writer thread — FLAGS_ckpt_scrub arms that
        automatically after every commit). Incremental by default: each
        committed step is verified once, newest first; ``recheck=True``
        forgets prior outcomes and re-reads everything (bit-rot after a
        first pass). Returns {step: ok}."""
        if recheck:
            with self._scrub_lock:
                self._scrub_state.clear()
        results = {}
        for s in reversed(self.all_steps()):
            with self._scrub_lock:
                known = self._scrub_state.get(s)
            results[s] = self._scrub_one(s) if known is None else known
        return results

    def newest_verified_step(self):
        """The newest committed step that passed a scrub — the training
        guardian's rollback target. Steps the scrubber has not covered
        yet are verified on demand, newest first. Returns None when no
        committed step verifies."""
        for s in reversed(self.all_steps()):
            with self._scrub_lock:
                ok = self._scrub_state.get(s)
            if ok is None:
                ok = self._scrub_one(s)
            if ok:
                return s
        return None

    def discard_steps_after(self, step):
        """Delete committed steps NEWER than ``step`` (guardian
        rollback: checkpoints from the rolled-past window must not
        shadow the replay's fresh saves through the already-committed
        early return, and a corrupt newest step must not survive the
        rollback that routed around it). Manifest-first deletion, like
        GC, so a racing reader never sees a half-deleted dir as
        committed. Returns the discarded steps."""
        doomed = [s for s in list_steps(self.dirname) if s > int(step)]
        for s in doomed:
            victim = os.path.join(self.dirname, _step_dirname(s))
            try:
                os.unlink(os.path.join(victim, MANIFEST))
            except OSError:
                pass
            shutil.rmtree(victim, ignore_errors=True)
            with self._scrub_lock:
                self._scrub_state.pop(s, None)
        return doomed

    # -- snapshot -----------------------------------------------------------

    def _snapshot(self, program, scope):
        from ..fluid import core
        from ..fluid.io import is_persistable

        scope = scope or core.global_scope()
        names = sorted(
            v.name for v in program.list_vars() if is_persistable(v)
        )
        owned = self._owned_names(names)
        tensors = []
        for name in names:
            if name not in owned:
                continue
            val = scope.get(name)
            if val is None:
                continue  # e.g. pruned/unused accumulator never ran
            tensors.append((name, _snapshot_value(val)))
        snap = {"tensors": tensors,
                # the scope's generator states: restoring them makes
                # dropout masks and flash dropout seeds replay across a
                # resume, the last piece of a bit-exact resume
                "generators": _encode_states(scope.rng_states())}
        cuda = [_tensor_of(v).device for _n, v in tensors
                if _tensor_of(v).device.type == "cuda"]
        if cuda:
            # the clones are queued on this stream; the writer's copies
            # wait on this event
            snap["device"] = cuda[0]
            snap["event"] = torch.cuda.Event()
            snap["event"].record(torch.cuda.current_stream(cuda[0]))
        return snap

    def _owned_names(self, names):
        """Which vars THIS rank writes. TP-sharded vars (dist_attrs) are
        written by every rank (each holds a distinct shard); replicated
        vars are partitioned round-robin so a big DP save spreads its
        write bandwidth across hosts."""
        if self.nranks <= 1:
            return set(names)
        owned = set()
        i = 0
        for name in names:  # names arrive sorted -> same partition on all ranks
            if name in self.dist_attrs:
                owned.add(name)
            else:
                if i % self.nranks == self.rank:
                    owned.add(name)
                i += 1
        return owned

    # -- writer -------------------------------------------------------------

    def _writer_loop(self):
        while True:
            item = self._queue.get()
            if item is None:
                self._queue.task_done()
                return
            step, snap = item
            try:
                self._write_checkpoint(step, snap)
            except BaseException as e:  # surfaced via wait()/next save()
                with self._error_lock:
                    if self._error is None:
                        self._error = e
            finally:
                self._queue.task_done()

    def _write_checkpoint(self, step, snap):
        from ..observability import trace as _trace

        # serialize + fsync + commit, on the writer thread's trace row
        # (or the caller's for a sync save)
        with _trace.span("ckpt_write", cat="ckpt", step=int(step)):
            self._write_checkpoint_traced(step, snap)

    def _write_checkpoint_traced(self, step, snap):
        from ..fluid import profiler as _profiler

        t0 = time.perf_counter()
        final_dir = os.path.join(self.dirname, _step_dirname(step))
        if os.path.isfile(os.path.join(final_dir, MANIFEST)):
            return  # already committed (e.g. preempt save after interval save)
        if os.path.isdir(final_dir):
            # manifest-less husk (GC crashed between unlink and rmtree):
            # invisible to list_steps, and it must not block a re-save
            shutil.rmtree(final_dir, ignore_errors=True)
        # the staging name is deterministic (no pid/uuid) because sharded
        # peers must agree on it; a stale one from a crashed run was swept
        # at init
        tmp_dir = os.path.join(self.dirname, _TMP_PREFIX + "%d" % step)
        shard_dir = (
            os.path.join(tmp_dir, _shard_dirname(self.rank))
            if self.nranks > 1 else tmp_dir
        )
        os.makedirs(shard_dir, exist_ok=True)
        nbytes = self._write_shard(shard_dir, step, snap)
        if self.nranks > 1:
            _fsync_dir(tmp_dir)
            if self.rank == 0:
                shards = self._await_peer_shards(tmp_dir, step)
                self._publish(tmp_dir, final_dir, step, snap, shards)
            else:
                self._await_publish(final_dir, step)
        else:
            self._publish(tmp_dir, final_dir, step, snap, shards=None)
        _profiler.bump_histogram(
            "ckpt_save_ms", (time.perf_counter() - t0) * 1000.0
        )
        _profiler.bump_histogram("ckpt_save_bytes", float(nbytes))
        _profiler.bump_counter("ckpt_saves_committed")
        if (self._auto_scrub and (self.nranks <= 1 or self.rank == 0)
                and threading.current_thread() is self._writer):
            # FLAGS_ckpt_scrub: verify the just-committed step (and any
            # step the scrubber hasn't covered) right here on the
            # writer thread — off the step critical path, so the
            # guardian's newest_verified_step() answer is usually
            # already warm when a rollback needs it. Sync saves (the
            # preemption final save inside the supervisor's SIGTERM
            # grace) run this method on the CALLER thread and must not
            # pay a full read-back there; their steps stay uncovered
            # until newest_verified_step() verifies on demand.
            self.scrub()

    def _write_shard(self, shard_dir, step, snap):
        """Serialize the snapshot into ``shard_dir`` (reference LoDTensor
        stream format, one concatenated file) + a shard manifest with
        per-tensor shape/dtype/offset/crc32. The manifest lands via
        same-dir rename so its presence IS the per-shard commit marker.
        The crc32 and the fsync each add to a histogram of their own
        (``ckpt_crc32_ms``, ``ckpt_fsync_ms``), the parts of
        ``ckpt_save_ms``."""
        from ..fluid import profiler as _profiler
        from ..fluid.ops.io_ops import lod_tensor_stream_parts

        from ..testing import chaos as _chaos

        plan = _chaos.active_plan()
        corrupting = plan is not None and plan.corrupt_ckpt
        data_path = os.path.join(shard_dir, DATA_FILE)
        catalog = {}
        offset = 0
        crc_s = 0.0
        with open(data_path, "wb") as f:
            for name, val in _to_host(snap):
                # the stream's header and its raw data go down as they
                # are, crc32 over both, with no joined copy of the data
                header, raw = lod_tensor_stream_parts(val)
                t0 = time.perf_counter()
                crc = zlib.crc32(raw, zlib.crc32(header)) & 0xFFFFFFFF
                crc_s += time.perf_counter() - t0
                nbytes = len(header) + raw.nbytes
                if corrupting:
                    # fault-injection point: chaos corrupt_ckpt flips a
                    # data byte AFTER the crc32 above came from the clean
                    # bytes — the torn-file signature the restore
                    # fallback must survive
                    f.write(_chaos.corrupt_ckpt_bytes(
                        header + raw.tobytes()))
                else:
                    f.write(header)
                    f.write(raw)
                entry = {
                    "shape": [int(d) for d in _tensor_of(val).shape],
                    "dtype": _dtype_name(_tensor_of(val)),
                    "offset": offset,
                    "nbytes": nbytes,
                    "crc32": crc,
                }
                if name in self.dist_attrs:
                    entry["dist"] = {
                        "axis": int(self.dist_attrs[name]),
                        "rank": self.rank,
                        "nranks": self.nranks,
                    }
                catalog[name] = entry
                offset += nbytes
            t0 = time.perf_counter()
            f.flush()
            os.fsync(f.fileno())
        _profiler.bump_histogram("ckpt_fsync_ms",
                                 (time.perf_counter() - t0) * 1000.0)
        _profiler.bump_histogram("ckpt_crc32_ms", crc_s * 1000.0)
        shard_manifest = {
            "format": _FORMAT,
            "step": int(step),
            "rank": self.rank,
            "nranks": self.nranks,
            "data_file": DATA_FILE,
            "tensors": catalog,
        }
        _write_atomic(
            os.path.join(shard_dir, SHARD_MANIFEST),
            json.dumps(shard_manifest, indent=1, sort_keys=True).encode(),
        )
        _fsync_dir(shard_dir)
        return offset

    def _publish(self, tmp_dir, final_dir, step, snap, shards):
        from ..distributed import elastic as _elastic

        manifest = {
            "format": _FORMAT,
            "step": int(step),
            "nranks": self.nranks,
            # the gang size the writing JOB ran at (>= nranks when each
            # rank keeps its own checkpoint dir): a later restore reads
            # it back as world_size_saved so elasticity-aware LR math is
            # relative to the topology that produced these tensors
            "world_size": _elastic.world_info().world_size,
            "rng_run_index": None,
            "torch_generators": snap.get("generators"),
        }
        if shards is not None:
            manifest["shards"] = [
                {"rank": r, "dir": _shard_dirname(r)} for r in shards
            ]
        _write_atomic(
            os.path.join(tmp_dir, MANIFEST),
            json.dumps(manifest, indent=1, sort_keys=True).encode(),
        )
        _fsync_dir(tmp_dir)
        try:
            os.replace(tmp_dir, final_dir)  # THE commit point
        except OSError:
            if os.path.isfile(os.path.join(final_dir, MANIFEST)):
                # lost a benign same-step race to another committer
                shutil.rmtree(tmp_dir, ignore_errors=True)
            else:
                raise
        _fsync_dir(self.dirname)
        self._gc()

    def _await_peer_shards(self, tmp_dir, step):
        deadline = time.monotonic() + self.commit_timeout_s
        want = set(range(self.nranks))
        while True:
            have = {
                r for r in want
                if os.path.isfile(os.path.join(
                    tmp_dir, _shard_dirname(r), SHARD_MANIFEST
                ))
            }
            if have == want:
                return sorted(want)
            if time.monotonic() > deadline:
                raise CheckpointError(
                    "step %d: shards %s missing after %.0fs"
                    % (step, sorted(want - have), self.commit_timeout_s)
                )
            time.sleep(0.02)

    def _await_publish(self, final_dir, step):
        deadline = time.monotonic() + self.commit_timeout_s
        while not os.path.isfile(os.path.join(final_dir, MANIFEST)):
            if time.monotonic() > deadline:
                raise CheckpointError(
                    "step %d: rank 0 did not publish within %.0fs"
                    % (step, self.commit_timeout_s)
                )
            time.sleep(0.02)

    # -- restore ------------------------------------------------------------

    def _read_shard(self, shard_dir, state, decode=True):
        """state[name] = (tensor or LoDTensor on the host, dist_or_None)
        for every tensor in the shard, crc-verified. For sharded manifests dist-sharded entries
        accumulate as {rank: piece} dicts for reassembly."""
        from ..fluid.ops.io_ops import deserialize_lod_tensor

        manifest_path = os.path.join(shard_dir, SHARD_MANIFEST)
        if not os.path.isfile(manifest_path):
            manifest_path = os.path.join(shard_dir, MANIFEST)
        with open(manifest_path) as f:
            shard = json.load(f)
        data_path = os.path.join(shard_dir, shard.get("data_file", DATA_FILE))
        # one read into a writable buffer; the tensors share its memory
        buf = bytearray(os.path.getsize(data_path))
        with open(data_path, "rb") as f:
            f.readinto(buf)
        view = memoryview(buf)
        for name, entry in shard["tensors"].items():
            blob = view[entry["offset"]: entry["offset"] + entry["nbytes"]]
            if len(blob) != entry["nbytes"] or (
                zlib.crc32(blob) & 0xFFFFFFFF
            ) != entry["crc32"]:
                raise ChecksumError(
                    "checkpoint tensor %r in %s fails its manifest crc32 "
                    "(torn or corrupted data file)" % (name, data_path)
                )
            if not decode:
                state[name] = (None, entry.get("dist"))
                continue
            t, _ = deserialize_lod_tensor(buf, entry["offset"], copy=False)
            val = t if t.lod() else t.tensor()
            dist = entry.get("dist")
            if dist is None:
                state[name] = (val, None)
            else:
                pieces = state.setdefault(name, ({}, dist))[0]
                pieces[int(dist["rank"])] = _tensor_of(val)

    def _reassemble(self, state):
        """-> (out, resliced_count). Replicated vars pass through
        bit-exactly. Dist-sharded vars: a single-rank restore
        (gather/export) concatenates all shards to the full value; a
        sharded restore (this manager has nranks > 1 and the var in its
        dist_attrs) yields THIS rank's local shard — picked up directly
        when the topology matches, re-sliced from the concatenated full
        value when restoring into a different nranks (N->M resharding).
        The N=1 edge (saved unsharded, restored sharded) replicates the
        full value and partitions it. ``resliced_count`` counts vars
        whose bytes had to be regrouped (concat and/or re-split) —
        topology-matched pickups and pass-throughs are free."""
        out = {}
        resliced = 0
        for name, (val, dist) in state.items():
            if dist is None:
                if self.nranks > 1 and name in self.dist_attrs:
                    # replicate-and-partition: the checkpoint holds the
                    # full (unsharded) value but THIS manager wants a
                    # TP shard of it
                    out[name] = torch.tensor_split(
                        _tensor_of(val), self.nranks,
                        dim=int(self.dist_attrs[name]),
                    )[self.rank].contiguous()
                    resliced += 1
                else:
                    out[name] = val
                continue
            pieces = [val[r] for r in sorted(val)]
            if len(pieces) != int(dist["nranks"]):
                raise CheckpointError(
                    "sharded tensor %r: have %d of %d shards"
                    % (name, len(pieces), dist["nranks"])
                )
            saved_axis = int(dist["axis"])
            if self.nranks > 1 and name in self.dist_attrs:
                axis = int(self.dist_attrs[name])
                if int(dist["nranks"]) == self.nranks and axis == saved_axis:
                    out[name] = pieces[self.rank]
                else:
                    full = torch.cat(pieces, dim=saved_axis)
                    out[name] = torch.tensor_split(
                        full, self.nranks, dim=axis
                    )[self.rank].contiguous()
                    resliced += 1
            else:
                out[name] = torch.cat(pieces, dim=saved_axis)
                resliced += 1
        return out, resliced

    def _iter_step_tensors(self, step=None, decode=True):
        if step is None:
            step = self.latest_step()
            if step is None:
                raise CheckpointError(
                    "no committed checkpoint under %r" % self.dirname
                )
        step_dir = os.path.join(self.dirname, _step_dirname(step))
        with open(os.path.join(step_dir, MANIFEST)) as f:
            manifest = json.load(f)
        state = {}
        if manifest.get("nranks", 1) > 1:
            for shard in manifest["shards"]:
                self._read_shard(os.path.join(step_dir, shard["dir"]),
                                 state, decode)
        else:
            self._read_shard(step_dir, state, decode)
        for name, (val, _dist) in state.items():
            yield name, val

    def _restore_rng(self, manifest, program, scope):
        """Set the scope's generators to the manifest's states. A
        reference manifest has none (its ``rng_run_index`` counts jax
        key folds, which the port does not draw from): the generators
        stay as they are."""
        enc = manifest.get("torch_generators")
        if enc:
            scope.set_rng_states(_decode_states(enc))

    # -- retention / hygiene ------------------------------------------------

    def _gc(self):
        """Retention after each commit (rank 0 / single-rank only — it
        runs on the publishing side): newest ``keep_max`` steps survive;
        steps divisible by ``keep_every_n_steps`` are pinned forever."""
        if self.keep_max <= 0:
            return
        steps = list_steps(self.dirname)
        doomed = steps[:-self.keep_max] if len(steps) > self.keep_max else []
        for s in doomed:
            if self.keep_every_n_steps > 0 and s % self.keep_every_n_steps == 0:
                continue
            victim = os.path.join(self.dirname, _step_dirname(s))
            # delete the manifest FIRST so a reader that races the rmtree
            # can never see a half-deleted dir as committed
            try:
                os.unlink(os.path.join(victim, MANIFEST))
            except OSError:
                pass
            shutil.rmtree(victim, ignore_errors=True)

    def _sweep_stale_tmp(self):
        """Remove a crashed run's staging dirs. Sharded mode sweeps only
        dirs older than the commit timeout: a faster-starting peer may
        already be staging its shard of a live save while this rank is
        still constructing its manager, and its fresh mtime spares it."""
        for name in os.listdir(self.dirname):
            if not name.startswith(_TMP_PREFIX):
                continue
            path = os.path.join(self.dirname, name)
            if self.nranks > 1:
                try:
                    age = time.time() - os.stat(path).st_mtime
                except OSError:
                    continue
                if age < self.commit_timeout_s:
                    continue
            shutil.rmtree(path, ignore_errors=True)

    def _raise_pending(self):
        with self._error_lock:
            err, self._error = self._error, None
        if err is not None:
            raise err

    # -- context manager ----------------------------------------------------

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
