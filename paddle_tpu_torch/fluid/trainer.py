"""Trainer / DeviceWorker stack for file-dataset training (port of
``paddle_tpu/fluid/trainer.py``).

Reference: framework/trainer.h:38-114 (TrainerBase, MultiTrainer,
DistMultiTrainer, PipelineTrainer), device workers hogwild_worker.cc:163,
downpour_worker.cc and section_worker.cc, configured by
trainer_desc.proto and entered through Executor::RunFromDataset
(executor.cc:157).

One card runs one program at a time, so no hogwild threads: what the
trainer keeps is the pipeline. The dataset's batches stream through the
double-buffered ``io_pipeline.DeviceFeeder``, whose thread parses the
next batch and copies it to the card while the current step runs; the
Executor takes the staged ``DeviceFeedBatch`` through its fast lane.
Around the step loop: the supervisor's heartbeat and elastic world
info, checkpoint restore, interval and preemption saves, the training
guardian, the chaos hooks, ``train_step`` spans and the
``train_step_ms`` histogram, as in the reference.

``DistMultiTrainer`` and ``DownpourTrainer`` raise where the
reference's raise (no ``distributed_lookup_table`` ops), and
``PipelineTrainer`` without a ``_pipeline_config``; their communicator
and the pipeline executor are not ported yet.
"""

import numpy as np


class TrainerBase(object):
    """reference: trainer.h:38 TrainerBase."""

    def __init__(self, thread_num=1):
        self.thread_num = max(int(thread_num), 1)

    def train(self, executor, program, dataset, scope=None, fetch_list=None,
              fetch_info=None, print_period=100):
        raise NotImplementedError


class MultiTrainer(TrainerBase):
    """reference: trainer.h:64 MultiTrainer + HogwildWorker loop
    (hogwild_worker.cc:163). The dataset's batches stream through the
    double-buffered io_pipeline feeder: its thread parses the next batch
    and copies it to the Executor's device while the current step runs,
    so the Executor's feed fast lane sees staged device tensors (dense
    slots; LoD slots keep their host form and take the normal path)."""

    def train(self, executor, program, dataset, scope=None, fetch_list=None,
              fetch_info=None, print_period=100, on_step=None,
              ckpt_manager=None, startup_program=None):
        import time as _time

        from . import debugger as _debugger
        from . import flags as _flags
        from . import io_pipeline as _io_pipeline
        from . import profiler as _profiler
        from ..distributed import elastic as _elastic
        from ..distributed import guardian as _guardian
        from ..distributed import supervisor as _sup
        from ..observability import exporter as _obs_exporter
        from ..observability import trace as _trace
        from ..testing import chaos as _chaos

        # FLAGS_obs_* light up the telemetry endpoint / snapshot files
        # for this worker with env flags alone (no-op when disarmed); the
        # supervisor injects FLAGS_obs_dir so every gang member leaves a
        # per-rank snapshot the gang report merges
        _obs_exporter.maybe_start_from_flags()

        feed_names = [
            v.name if hasattr(v, "name") else str(v)
            for v in dataset.use_var
        ]

        # elastic-training liveness hook: when launched under the
        # supervising agent (PADDLE_TPU_HEARTBEAT_FILE in the env), write
        # a progress beat per step so the hang watchdog can tell a slow
        # step from a stalled worker. No-op (hb is None) otherwise.
        hb = _sup.worker_heartbeat()

        # elastic topology: the supervisor re-plans the gang per restart
        # and injects PADDLE_TPU_WORLD_SIZE/_RANK; running with fewer
        # ranks than the job was submitted with is a DEGRADED attempt.
        # This trainer's feed is identical-replica (every rank consumes
        # the full stream, the dist_crash_probe shape), so each
        # replica's math is world-size independent and needs NO batch
        # correction — which is what makes the shrink/regrow digest
        # check exact. Sharded-stream callers own their micro-batching:
        # batch_plan() tells them the accumulation factor that would
        # preserve the global batch (logged here as advisory), and
        # FLAGS_elastic_lr_rescale is the alternative correction
        # (applied after restore, relative to the saved world size).
        winfo = _elastic.world_info()
        degraded = winfo.world_size < winfo.base_world_size
        if degraded:
            plan = _elastic.batch_plan(
                winfo.base_world_size, winfo.world_size
            )
            print(
                "elastic: DEGRADED attempt — world %d/%d (slot %d -> "
                "rank %d); identical-replica stream, no batch "
                "correction applied (a sharded stream would need x%d "
                "accumulation or FLAGS_elastic_lr_rescale to preserve "
                "the global batch)"
                % (winfo.world_size, winfo.base_world_size, winfo.slot,
                   winfo.rank, plan.accum_steps),
                flush=True,
            )

        # preemption-safe checkpointing (paddle_tpu_torch/checkpoint):
        # resume at the last committed step (replaying the dataset stream past the
        # already-trained batches — file datasets must iterate
        # deterministically for bit-exact resume), save every
        # FLAGS_ckpt_save_interval_steps on the background writer, and on
        # SIGTERM stop at the next step boundary with one final sync save.
        start_step = 0
        ckpt_interval = 0
        preempt_mod = None
        handler = None
        if hb is not None:
            hb.beat(-1, status="start", force=True)
        if ckpt_manager is not None:
            from ..checkpoint import preempt as preempt_mod

            start_step = ckpt_manager.restore_or_initialize(
                program, executor, startup_program=startup_program,
                scope=scope,
            ) + 1
            # opt-in LR correction for degraded/regrown attempts, keyed
            # to the world size the restored checkpoint was SAVED at so
            # repeated resumes never compound the factor (no-op unless
            # FLAGS_elastic_lr_rescale)
            _elastic.maybe_rescale_lr(
                program, scope=scope,
                restore_info=getattr(
                    ckpt_manager, "last_restore_info", None
                ),
            )
            ckpt_interval = int(
                _flags.get_flag("ckpt_save_interval_steps", 0) or 0
            )
            # flag-only handler: the loop below commits the final save at
            # the next STEP BOUNDARY, so it can never snapshot a scope
            # that executor.run is halfway through writing back (the
            # in-handler save path can — see preempt.py)
            handler = preempt_mod.PreemptionHandler(
                ckpt_manager, lambda: None, save_in_handler=False,
                exit_after=False,
            ).install()

        # training guardian (FLAGS_guardian_enable): in-graph health
        # fetch + host anomaly policy + skip/rollback/giveup ladder +
        # cross-replica SDC digests (distributed/guardian.py). The
        # extra fetches are constant across steps, so the Executor's
        # plan for the step is built once with it armed.
        guardian = _guardian.Guardian.maybe_create(
            program, ckpt_manager=ckpt_manager
        )
        user_fetches = list(fetch_list or [])
        run_fetches = (
            guardian.wrap_fetches(user_fetches)
            if guardian is not None else user_fetches
        )

        def _feeds(start):
            for i, batch in enumerate(dataset._iter_batches()):
                if i < start:
                    continue  # replayed prefix: drop BEFORE the H2D copy
                yield dict(zip(feed_names, batch))

        pipe = None
        step = start_step
        preempted_break = False

        def _account_step():
            # one definition for BOTH exits of a completed step (normal
            # fall-through and preempted break) so the metric name/unit
            # can never diverge between them; reads the current
            # iteration's t_step from the enclosing scope
            _profiler.bump_histogram(
                "train_step_ms", (_time.perf_counter() - t_step) * 1e3
            )
            _profiler.bump_counter("train_steps")
            if degraded:
                # steps trained below the submitted world size: the gang
                # report surfaces this per rank so an operator can see
                # how much of a run happened degraded
                _profiler.bump_counter("dist_degraded_steps")

        try:
            # guardian-rollback retry loop: a RollbackSignal unwinds the
            # stream, restores the newest verified checkpoint, and
            # replays the (deterministic) dataset from there with the
            # poisoned batch window dropped. Without a guardian the
            # loop body runs exactly once.
            while True:
                pipe = _io_pipeline.DeviceFeeder(
                    _feeds(start_step), place=executor.device,
                )
                try:
                    for feed in pipe:
                        t_step = _time.perf_counter()
                        if (guardian is not None
                                and guardian.should_drop(step)):
                            # a batch an earlier anomaly identified as
                            # poisoned: consume it from the stream
                            # WITHOUT running — the rollback replay's
                            # surviving data schedule
                            guardian.note_dropped(step)
                            if hb is not None:
                                hb.beat(step)
                            step += 1
                            continue
                        # the per-step umbrella span: executor_run,
                        # ckpt_snapshot and any RecordEvents nest under
                        # it, so the exported timeline answers "where
                        # did this step's ms go"
                        with _trace.span("train_step", cat="train",
                                         step=step):
                            # data-plane fault injection BEFORE the run
                            # (no-op when disarmed): NaN/spike poisons
                            # the batch the guardian must catch
                            feed = _chaos.poison_feed(step, feed)
                            if guardian is not None:
                                guardian.pre_step(scope)
                            try:
                                outs = executor.run(
                                    program, feed=feed,
                                    fetch_list=run_fetches, scope=scope,
                                )
                            except _debugger.NanInfError as e:
                                # FLAGS_check_nan_inf post-run scan
                                # fired under an armed guardian: same
                                # anomaly, structured attribution
                                if guardian is None:
                                    raise
                                outs = None
                                verdict = guardian.on_nan_error(step, e)
                            if outs is not None:
                                if guardian is not None:
                                    outs, verdict = guardian.post_step(
                                        step, outs
                                    )
                                else:
                                    verdict = None
                            skipped = (
                                verdict
                                == _guardian.Guardian.VERDICT_SKIP
                            )
                            if skipped:
                                # discard the update (pre-step copies
                                # restored in place), keep the stream
                                # advanced; the step still counts in
                                # progress telemetry — work happened —
                                # and control falls through to the
                                # shared preemption / interval-save
                                # tail: a SIGTERM or a checkpoint
                                # boundary landing on a skipped step
                                # must not be missed (the saved state
                                # is the restored pre-step state — a
                                # valid checkpoint)
                                guardian.restore_skip(scope, program)
                            else:
                                # silent-corruption fault injection
                                # AFTER the update landed (no-op when
                                # disarmed): invisible to this rank's
                                # health fetch by construction — only
                                # the cross-replica digest vote can
                                # see it
                                _chaos.maybe_bitflip_state(
                                    step, program, scope
                                )
                                if (guardian is not None
                                        and hb is not None
                                        and guardian.digest_due(step)):
                                    hb.publish_digest(
                                        step,
                                        guardian.state_digest(scope),
                                    )
                                if (user_fetches and print_period
                                        and step % print_period == 0):
                                    info = fetch_info or [
                                        getattr(f, "name", str(f))
                                        for f in user_fetches
                                    ]
                                    msg = ", ".join(
                                        "%s=%s"
                                        % (n, np.asarray(o).ravel()[:4])
                                        for n, o in zip(info, outs)
                                    )
                                    print("step %d: %s" % (step, msg))
                            if on_step is not None:
                                on_step(step)
                            if hb is not None:
                                hb.beat(step)
                            if ckpt_manager is not None:
                                # per-install latch, not the sticky
                                # module flag: a loop that
                                # deliberately re-enters train() after
                                # a survived SIGTERM gets a full run,
                                # not 1-step stops
                                requested = (
                                    handler.requested.is_set()
                                    if handler is not None
                                    and handler._installed
                                    else preempt_mod.preemption_requested()
                                )
                                if requested:
                                    preempted_break = True
                                    # the final save must not be
                                    # skipped because an EARLIER
                                    # interval save failed on the
                                    # writer — drain + swallow the
                                    # stale error first (same contract
                                    # as PreemptionHandler._final_save)
                                    try:
                                        ckpt_manager.wait()
                                    except Exception:
                                        pass
                                    ckpt_manager.save(
                                        step, program, scope=scope,
                                        async_=False,
                                    )
                                    # the final preempted step ran in
                                    # full (plus its terminal save) —
                                    # it must count in the
                                    # progress/step-time telemetry the
                                    # gang report compares across ranks
                                    _account_step()
                                    step += 1
                                    break
                                if (ckpt_interval
                                        and (step + 1) % ckpt_interval
                                        == 0):
                                    ckpt_manager.save(
                                        step, program, scope=scope
                                    )
                            # fault-injection point AFTER the interval
                            # save was enqueued: a crash here lands
                            # while the async writer may be mid-commit
                            # — the worst case the chaos harness exists
                            # to make reproducible
                            _chaos.on_step(step)
                        _account_step()
                        step += 1
                except _guardian.RollbackSignal as rb:
                    pipe.close()
                    pipe = None
                    restored = guardian.execute_rollback(
                        rb, scope, hb=hb
                    )
                    start_step = restored + 1
                    step = start_step
                    continue
                break
            if hb is not None:
                # a preempted stop is NOT completion: "done" would exempt
                # this worker from the supervisor's hang watchdog while
                # it may still wedge in teardown; "preempted" keeps the
                # per-step staleness bound active for the wrap-up
                hb.beat(
                    step - 1,
                    status="preempted" if preempted_break else "done",
                    force=True,
                )
        finally:
            if pipe is not None:
                pipe.close()
            if handler is not None:
                handler.uninstall()
            if ckpt_manager is not None:
                ckpt_manager.wait()
            # leave the per-rank telemetry record (FLAGS_obs_dir armed):
            # this is what the supervisor's gang report merges, and it
            # must land even on a preempted/raising exit
            _obs_exporter.final_snapshot()
        return step


class DistMultiTrainer(MultiTrainer):
    """reference: trainer.h:84 DistMultiTrainer — MultiTrainer plus the
    pserver communicator; the send/recv ops in the transpiled program do
    the push/pull, and an async communicator (fluid/communicator.py) can
    batch them in the background."""

    def __init__(self, thread_num=1, communicator=None):
        super().__init__(thread_num)
        self.communicator = communicator

    def train(self, *args, **kwargs):
        comm = self.communicator
        started_here = comm is not None and not comm.is_running()
        if started_here:
            comm.start()
        try:
            return super().train(*args, **kwargs)
        finally:
            if started_here:
                comm.stop()


class DownpourTrainer(DistMultiTrainer):
    """reference: trainer.h:84 DistMultiTrainer + downpour_worker.cc — the
    sparse-CTR device worker: per batch, PULL the touched rows of the
    row-sharded embedding tables from the pservers (FillSparseValue),
    compute forward/backward locally, PUSH the SelectedRows grads back to
    the owning shards (push_sparse) and dense grads via the async
    communicator (push_dense).

    Pull and push are ops of the sparse-transpiled program
    (distributed_lookup_table prefetches over kPrefetch; the send op
    row-shards the SelectedRows grad), so the worker loop is the
    Hogwild-style batch stream. Those ops are not in the port yet: a
    program without them raises here, as in the reference."""

    def train(self, executor, program, dataset, scope=None, fetch_list=None,
              fetch_info=None, print_period=100, on_step=None):
        sparse_pulls = [
            op_
            for op_ in program.global_block().ops
            if op_.type == "distributed_lookup_table"
        ]
        if not sparse_pulls:
            raise ValueError(
                "DownpourTrainer needs a sparse-transpiled program "
                "(embedding(is_sparse=True) + DistributeTranspiler): no "
                "distributed_lookup_table ops found"
            )
        return super().train(
            executor, program, dataset, scope, fetch_list, fetch_info,
            print_period, on_step=on_step,
        )


class PipelineTrainer(TrainerBase):
    """reference: trainer.h:114 PipelineTrainer + SectionWorker — the
    program must be marked by PipelineOptimizer(cut_list=...); a program
    without a ``_pipeline_config`` raises, as in the reference."""

    def train(self, executor, program, dataset, scope=None, fetch_list=None,
              fetch_info=None, print_period=100):
        if not getattr(program, "_pipeline_config", None):
            raise ValueError(
                "PipelineTrainer needs a program built with "
                "PipelineOptimizer(cut_list=...)"
            )
        return MultiTrainer(self.thread_num).train(
            executor, program, dataset, scope, fetch_list, fetch_info,
            print_period,
        )


class TrainerFactory(object):
    """reference: trainer_factory.py — trainer class by name."""

    _TRAINERS = {
        "MultiTrainer": MultiTrainer,
        "DistMultiTrainer": DistMultiTrainer,
        "DownpourTrainer": DownpourTrainer,
        "PipelineTrainer": PipelineTrainer,
    }

    def create_trainer(self, opt_info=None):
        opt_info = opt_info or {}
        name = opt_info.get("trainer", "MultiTrainer")
        cls = self._TRAINERS.get(name, MultiTrainer)
        return cls(thread_num=opt_info.get("thread_num", 1))


def train_from_dataset(
    executor, program, dataset, scope=None, fetch_list=None, fetch_info=None,
    print_period=100, ckpt_manager=None, startup_program=None,
):
    """Entry point behind Executor.train_from_dataset (reference:
    Executor::RunFromDataset executor.cc:157). ``ckpt_manager`` (a
    paddle_tpu_torch.checkpoint.CheckpointManager) turns on preemption-safe
    periodic checkpointing + resume, paced by
    FLAGS_ckpt_save_interval_steps."""
    if dataset is None:
        raise ValueError("dataset must be provided")
    trainer_name = "MultiTrainer"
    if getattr(program, "_pipeline_config", None):
        trainer_name = "PipelineTrainer"
    trainer = TrainerFactory().create_trainer(
        {"trainer": trainer_name, "thread_num": getattr(
            dataset, "thread_num", 1
        )}
    )
    kwargs = {}
    if ckpt_manager is not None and trainer_name == "MultiTrainer":
        kwargs = dict(
            ckpt_manager=ckpt_manager, startup_program=startup_program
        )
    return trainer.train(
        executor, program, dataset, scope, fetch_list, fetch_info,
        print_period, **kwargs,
    )
