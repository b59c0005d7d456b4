"""Collective fleet (port of
``paddle_tpu/fluid/incubate/fleet/collective``; reference:
incubate/fleet/collective/__init__.py — CollectiveOptimizer:142 wraps any
optimizer into distributed training via the collective transpiler +
DistributedStrategy:94). Each worker is one rank of a
``torch.distributed`` world (``init_worker`` joins the one the launcher
describes); nranks is that world's size, else the role maker's worker
count."""

from __future__ import annotations

from .... import core
from ....executor import Executor
from ....framework import default_main_program, default_startup_program
from .... import io as fluid_io
from ..base.fleet_base import DistributedOptimizer, Fleet, Mode


class DistributedStrategy(object):
    """reference: collective/__init__.py:94 DistributedStrategy."""

    def __init__(self):
        self.use_local_sgd = False
        self.local_sgd_k_steps = 1
        self.use_dgc = False
        self.use_dist_fc = False
        self.nccl_comm_num = 1
        self.use_hierarchical_allreduce = False
        self.hierarchical_allreduce_inter_nranks = 0
        self.mode = "nccl2"
        self.collective_mode = "grad_allreduce"
        self.exec_strategy = None
        self.forward_recompute = False
        self.recompute_checkpoints = []


class DistFCConfig(object):
    pass


class Collective(Fleet):
    def __init__(self):
        super().__init__(Mode.COLLECTIVE)
        self._local_ip = 0
        self.startup_program = None
        self.main_program = None

    def init_worker(self):
        from .....parallel import initialize_distributed

        initialize_distributed()

    def run_worker(self, main_programs=None, scopes=None):
        pass

    def init_server(self, model_dir=None):
        raise NotImplementedError(
            "Collective fleet has no servers; use parameter_server fleet"
        )

    def run_server(self):
        raise NotImplementedError(
            "Collective fleet has no servers; use parameter_server fleet"
        )

    def stop_worker(self):
        pass

    def distributed_optimizer(self, optimizer, strategy=None):
        self._optimizer = CollectiveOptimizer(optimizer, strategy)
        return self._optimizer

    def save_inference_model(self, executor, dirname, feeded_var_names=None,
                             target_vars=None, main_program=None,
                             export_for_deployment=True):
        fluid_io.save_inference_model(
            dirname, feeded_var_names, target_vars, executor,
            main_program or self.main_program, None, None,
            export_for_deployment,
        )

    def save_persistables(self, executor, dirname, main_program=None,
                          filename=None):
        fluid_io.save_persistables(
            executor, dirname, main_program or self.main_program, filename
        )


fleet = Collective()


class CollectiveOptimizer(DistributedOptimizer):
    """reference: collective/__init__.py:142 — rewrites the program with the
    collective transpiler so each worker all-reduces the gradients."""

    def __init__(self, optimizer, strategy=None):
        super().__init__(optimizer, strategy or DistributedStrategy())

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        main_program = loss.block.program
        startup_program = startup_program or default_startup_program()
        optimize_ops, params_grads = self._optimizer.minimize(
            loss, startup_program, parameter_list, no_grad_set
        )
        worker_endpoints = fleet.worker_endpoints()
        trainer_id = fleet.worker_index()
        current_endpoint = (
            worker_endpoints[trainer_id] if worker_endpoints else "local"
        )
        from ....transpiler.collective import GradAllReduce, LocalSGD

        strategy = self._strategy
        if strategy.use_local_sgd:
            t = LocalSGD(nrings=strategy.nccl_comm_num,
                         k_steps=strategy.local_sgd_k_steps)
        else:
            t = GradAllReduce(nrings=strategy.nccl_comm_num)
        from ..... import parallel

        # one rank a process and a device: the world's size (the
        # reference's nranks = num_trainers x ndev,
        # parallel_executor.cc:407, with ndev 1)
        nranks = (parallel.world_size() if parallel.is_initialized()
                  else max(fleet.worker_num(), 1))
        t.transpile(
            startup_program=startup_program,
            main_program=main_program,
            rank=trainer_id,
            endpoints=worker_endpoints or [current_endpoint],
            current_endpoint=current_endpoint,
            nranks=nranks,
        )
        main_program._grad_allreduce_applied = nranks
        fleet.main_program = main_program
        fleet.startup_program = startup_program
        return optimize_ops, params_grads


_ = (core, Executor, default_main_program)
