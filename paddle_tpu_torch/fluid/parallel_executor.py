"""ParallelExecutor — the legacy data-parallel wrapper (port of
``paddle_tpu/fluid/parallel_executor.py``; reference:
python/paddle/fluid/parallel_executor.py:28, wrapping the C++ PE at
framework/parallel_executor.cc:398). It is
``CompiledProgram.with_data_parallel`` run by an Executor: one process a
device, each rank feeding its shard and fetching its own values."""

from . import core
from .compiler import BuildStrategy, CompiledProgram, ExecutionStrategy
from .executor import Executor
from .framework import default_main_program


class ParallelExecutor(object):
    def __init__(
        self,
        use_cuda=False,
        loss_name=None,
        main_program=None,
        share_vars_from=None,
        exec_strategy=None,
        build_strategy=None,
        num_trainers=1,
        trainer_id=0,
        scope=None,
        use_spmd=False,
        mesh_axes=None,
        fsdp=False,
        dist_attrs=None,
    ):
        self._main_program = main_program or default_main_program()
        self._scope = scope or core.global_scope()
        place = core.CUDAPlace(0) if use_cuda else core.CPUPlace()
        self._exe = Executor(place)
        self._compiled = CompiledProgram(
            self._main_program, build_strategy=build_strategy)
        if use_spmd:
            # the GSPMD form raises until the mesh part lands
            self._compiled.with_mesh(loss_name=loss_name,
                                     mesh_axes=mesh_axes, fsdp=fsdp,
                                     dist_attrs=dist_attrs)
        self._compiled.with_data_parallel(
            loss_name=loss_name,
            exec_strategy=exec_strategy or ExecutionStrategy(),
            share_vars_from=(
                share_vars_from._compiled if share_vars_from else None
            ),
        )

    def run(self, fetch_list, feed=None, feed_dict=None, return_numpy=True):
        feed = feed if feed is not None else feed_dict
        return self._exe.run(
            self._compiled,
            feed=feed,
            fetch_list=fetch_list,
            scope=self._scope,
            return_numpy=return_numpy,
        )

    @property
    def device_count(self):
        return self._compiled._device_count()

    def compile_report(self):
        """This process's build telemetry (Executor plans, predictor
        plans, kernel libraries; ``observability.compile_stats``), the
        legacy PE surface of the reference's ``compile_report``."""
        from ..observability import compile_stats as _compile_stats

        return _compile_stats.summary()

    def drop_local_exe_scopes(self):
        pass


_ = BuildStrategy
