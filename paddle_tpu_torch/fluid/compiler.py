"""CompiledProgram: data-parallel training over ``torch.distributed``
(port of ``paddle_tpu/fluid/compiler.py``).

Reference: python/paddle/fluid/compiler.py (CompiledProgram:65,
with_data_parallel:138) driving the C++ ParallelExecutor
(parallel_executor.cc:398), which inserts an AllReduceOpHandle per
gradient and scales the loss gradient by 1/nranks.

The JAX package runs one controller over a mesh and traces the block
under ``shard_map``. The port runs one process per device, as PyTorch
does: each rank is a process of a ``torch.distributed`` world that the
port's launcher starts (``python -m paddle_tpu_torch.distributed.launch
--nproc_per_node N``; ``parallel.initialize_distributed`` joins it).
``with_data_parallel`` rewrites the program once, through the registered
``collective_grad_allreduce_pass`` (``GradAllReduce``: the 1/nranks
loss-grad scale and a ``c_allreduce_sum`` on every gradient), broadcasts
the persistables the scope holds from rank 0 on the first run (the
ParallelExecutor's ``BCastParamsToDevices``), and then runs the program
through the plain Executor. Each rank feeds its own shard of the batch
and fetches its own values: the reference's single controller
concatenates the shards' fetches on dim 0 instead.

A process in no world, or in a world of one, runs the program as it is
(the reference's ``_device_count() == 1`` branch). ``places`` naming
more than one device raises: one process drives one device here.

BuildStrategy / ExecutionStrategy keep the reference's fields; the pass
builder's passes rewrite the program once before the first run.
"""

import weakref

from . import core
from .framework import OP_ROLE_KEY, OP_ROLE_VAR_KEY, OpRole

_MESH_PART = (
    "%s is not ported yet: the GSPMD mesh (tensor parallel, FSDP) comes "
    "with ROADMAP A12b; train data-parallel with with_data_parallel() "
    "under python -m paddle_tpu_torch.distributed.launch")


class ExecutionStrategy(object):
    """reference: framework/details/execution_strategy.h:25-38."""

    def __init__(self):
        self.num_threads = 0
        self.num_iteration_per_drop_scope = 1
        self.num_iteration_per_run = 1
        self.use_thread_barrier = False
        self.allow_op_delay = False


class BuildStrategy(object):
    """reference: framework/details/build_strategy.h."""

    class ReduceStrategy(object):
        AllReduce = 0
        Reduce = 1

    class GradientScaleStrategy(object):
        CoeffNumDevice = 0
        One = 1
        Customized = 2

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = (
            BuildStrategy.GradientScaleStrategy.CoeffNumDevice
        )
        self.debug_graphviz_path = ""
        self.enable_sequential_execution = False
        self.fuse_elewise_add_act_ops = False
        self.fuse_bn_act_ops = False
        self.fuse_relu_depthwise_conv = False
        self.fuse_broadcast_ops = False
        self.fuse_all_optimizer_ops = False
        self.fuse_all_reduce_ops = False
        self.sync_batch_norm = False
        self.memory_optimize = True
        self.enable_inplace = True
        self.cache_runtime_context = False
        self.num_trainers = 1
        self.trainer_id = 0
        self.trainers_endpoints = []
        self.collective = None
        self.nccl_comm_num = 1
        self.use_hierarchical_allreduce = False
        self.hierarchical_allreduce_inter_nranks = 0
        self._pass_builder = None

    def _finalize_strategy_and_create_passes(self):
        """reference: pybind.cc BuildStrategy binding — returns the pass
        builder so scripts can inject custom passes; strategy toggles
        that map to passes are materialized here."""
        from .ir import PassBuilder

        if self._pass_builder is None:
            self._pass_builder = PassBuilder()
            if self.fuse_elewise_add_act_ops:
                self._pass_builder.append_pass("fuse_elewise_add_act_pass")
        return self._pass_builder


class CompiledProgram(object):
    def __init__(self, program_or_graph, build_strategy=None):
        self._program = program_or_graph
        self._build_strategy = build_strategy or BuildStrategy()
        self._is_data_parallel = False
        self._loss_name = None
        self._exec_strategy = None
        self._places = None
        self._share_vars_from = None
        self._passes_applied = False
        self._synced_scopes = weakref.WeakSet()

    def with_data_parallel(
        self,
        loss_name=None,
        build_strategy=None,
        exec_strategy=None,
        share_vars_from=None,
        places=None,
    ):
        if places is not None and len(places) > 1:
            raise ValueError(
                "with_data_parallel: %d places given, but one process "
                "drives one device here; start one process per device "
                "with python -m paddle_tpu_torch.distributed.launch "
                "--nproc_per_node %d" % (len(places), len(places)))
        self._is_data_parallel = True
        self._loss_name = loss_name
        if build_strategy is not None:
            self._build_strategy = build_strategy
        self._exec_strategy = exec_strategy or ExecutionStrategy()
        self._share_vars_from = share_vars_from
        self._places = places
        return self

    def with_spmd(self, *args, **kwargs):
        raise NotImplementedError(_MESH_PART % "with_spmd")

    def with_mesh(self, *args, **kwargs):
        raise NotImplementedError(_MESH_PART % "with_mesh")

    def with_inference_optimize(self, config):
        return self

    @property
    def program(self):
        return self._program

    # -- execution ---------------------------------------------------------
    def _device_count(self):
        """The data-parallel ranks: the world's size (1 in no world)."""
        from ..parallel import world_size

        return world_size()

    def _apply_grad_allreduce(self):
        """Insert c_allreduce_sum on every parameter gradient and the
        1/nranks loss-grad scale, once (reference: multi_devices_graph_
        pass.cc:454 CreateAllReduceOp, ScaleLossGrad at :292, :514,
        through transpiler/collective.py:178 GradAllReduce)."""
        nranks = self._device_count()
        applied = getattr(self._program, "_grad_allreduce_applied", None)
        if applied is not None:
            if applied != nranks:
                raise RuntimeError(
                    "program was already transpiled for %d data-parallel "
                    "ranks and cannot be re-targeted to %d (the 1/nranks "
                    "loss scale is baked in); rebuild the program"
                    % (applied, nranks)
                )
            return
        from ..observability import trace as _obs_trace
        from .ir import get_pass

        with _obs_trace.span("spmd_program_prepare", cat="compile",
                             stage="grad_allreduce"):
            get_pass(
                "collective_grad_allreduce_pass",
                nranks=nranks,
                loss_name=self._loss_name,
                nrings=1,
            ).apply_program(self._program)
            self._program._grad_allreduce_applied = nranks

    def _sync_persistables(self, scope):
        """Rank 0's persistables to every rank, once a scope (the
        ParallelExecutor's BCastParamsToDevices): every rank then starts
        from the same parameters and optimizer state."""
        if scope in self._synced_scopes:
            return
        import torch
        import torch.distributed as dist

        from ..observability import trace as _obs_trace

        names = sorted(
            v.name for v in self._program.list_vars()
            if v.persistable and isinstance(scope.get(v.name), torch.Tensor))
        with _obs_trace.span("spmd_program_prepare", cat="compile",
                             stage="broadcast_persistables"):
            root = [names]
            dist.broadcast_object_list(root, src=0)
            if root[0] != names:
                raise RuntimeError(
                    "with_data_parallel: rank %d's scope holds other "
                    "persistables than rank 0's (%d against %d); run the "
                    "same startup program on every rank"
                    % (dist.get_rank(), len(names), len(root[0])))
            for n in names:
                t = scope.get(n)
                if not t.is_contiguous():
                    t = t.contiguous()
                    scope.set(n, t)
                dist.broadcast(t, src=0)
        self._synced_scopes.add(scope)

    def _run(self, executor, feed=None, fetch_list=None, scope=None,
             return_numpy=True):
        from ..observability import trace as _obs_trace

        # the user's pass pipeline (BuildStrategy's pass builder,
        # pybind.cc:1547) rewrites the program once, before the first run
        pb = getattr(self._build_strategy, "_pass_builder", None)
        if pb is not None and not self._passes_applied:
            with _obs_trace.span("spmd_program_prepare", cat="compile",
                                 stage="pass_builder"):
                pb.apply(self._program)
            self._passes_applied = True
        scope = scope if scope is not None else core.global_scope()
        if self._is_data_parallel and self._device_count() > 1:
            self._apply_grad_allreduce()
            self._sync_persistables(scope)
        return executor.run(self._program, feed=feed, fetch_list=fetch_list,
                            scope=scope, return_numpy=return_numpy)


_ = (OP_ROLE_KEY, OP_ROLE_VAR_KEY, OpRole)  # re-exported for transpilers
