"""Fleet abstraction (port of
``paddle_tpu/fluid/incubate/fleet/base/fleet_base.py``; reference:
incubate/fleet/base/fleet_base.py)."""

from __future__ import annotations

import abc


class Mode(object):
    TRANSPILER = 1
    PSLIB = 2
    COLLECTIVE = 3


class Fleet(object, metaclass=abc.ABCMeta):
    def __init__(self, mode):
        self._is_initialized = False
        self._mode = mode
        self._optimizer = None
        self._role_maker = None
        self._executor = None

    def is_first_worker(self):
        return self._role_maker.is_first_worker()

    def worker_index(self):
        return self._role_maker.worker_index()

    def worker_num(self):
        return self._role_maker.worker_num()

    def is_worker(self):
        return self._role_maker.is_worker()

    def worker_endpoints(self, to_string=False):
        eps = self._role_maker.get_trainer_endpoints()
        return ",".join(eps) if to_string else eps

    def server_num(self):
        return self._role_maker.server_num()

    def server_index(self):
        return self._role_maker.server_index()

    def server_endpoints(self, to_string=False):
        eps = self._role_maker.get_pserver_endpoints()
        return ",".join(eps) if to_string else eps

    def is_server(self):
        return self._role_maker.is_server()

    def split_files(self, files):
        """Shard a file list across workers (reference: fleet_base.py
        split_files)."""
        trainer_id = self.worker_index()
        trainers = self.worker_num()
        return files[trainer_id::trainers]

    def init(self, role_maker=None):
        from .role_maker import PaddleCloudRoleMaker

        self._role_maker = role_maker or PaddleCloudRoleMaker(
            is_collective=(self._mode == Mode.COLLECTIVE)
        )
        self._role_maker.generate_role()
        self._is_initialized = True

    @abc.abstractmethod
    def init_worker(self):
        pass

    @abc.abstractmethod
    def init_server(self, model_dir=None):
        pass

    @abc.abstractmethod
    def run_server(self):
        pass

    @abc.abstractmethod
    def stop_worker(self):
        pass

    @abc.abstractmethod
    def distributed_optimizer(self, optimizer, strategy=None):
        pass

    @abc.abstractmethod
    def save_inference_model(self, executor, dirname, feeded_var_names,
                             target_vars, main_program=None,
                             export_for_deployment=True):
        pass

    @abc.abstractmethod
    def save_persistables(self, executor, dirname, main_program=None):
        pass


class DistributedOptimizer(object, metaclass=abc.ABCMeta):
    def __init__(self, optimizer, strategy=None):
        self._optimizer = optimizer
        self._strategy = strategy

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return self._optimizer.backward(
            loss, startup_program, parameter_list, no_grad_set, callbacks
        )

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    @abc.abstractmethod
    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        pass
