"""Dygraph data parallel (port of ``paddle_tpu/fluid/dygraph/parallel.py``;
reference: python/paddle/fluid/dygraph/parallel.py:84 DataParallel —
``scale_loss``:150, ``_coalesce_tensors``:171, ``apply_collective_grads``:201
over imperative NCCLParallelContext, imperative/nccl_context.h:61).

One process a rank, in the world ``parallel.initialize_distributed``
joins (gloo on the CPU, NCCL on the card; ``distributed.launch`` sets
``PADDLE_TRAINERS_NUM`` / ``PADDLE_TRAINER_ID``). ``DataParallel`` runs
its layer as it is; ``scale_loss`` divides the loss by the ranks and
``apply_collective_grads`` sums every gradient over the world group with
``torch.distributed.all_reduce``, one call per dtype on the gradients
packed side by side (the reference gathers them to every process and
sums)."""

import os

import torch

from .layers import Layer

__all__ = ["ParallelEnv", "Env", "prepare_context", "DataParallel"]


class ParallelEnv(object):
    """Rank and endpoint discovery from the ``PADDLE_*`` variables
    ``paddle_tpu_torch.distributed.launch`` sets (reference:
    dygraph/parallel.py Env)."""

    def __init__(self):
        self._nranks = int(os.getenv("PADDLE_TRAINERS_NUM", "1"))
        self._local_rank = int(os.getenv("PADDLE_TRAINER_ID", "0"))
        self._dev_id = int(os.getenv("FLAGS_selected_gpus", "0"))
        self._trainer_endpoints = os.getenv(
            "PADDLE_TRAINER_ENDPOINTS", "").split(",")
        self._current_endpoint = os.getenv("PADDLE_CURRENT_ENDPOINT", "")

    @property
    def nranks(self):
        return self._nranks

    @property
    def local_rank(self):
        return self._local_rank

    @property
    def dev_id(self):
        return self._dev_id

    @property
    def current_endpoint(self):
        return self._current_endpoint

    @property
    def trainer_endpoints(self):
        return self._trainer_endpoints


Env = ParallelEnv


def prepare_context(strategy=None):
    """Join the launcher's world (reference: dygraph/parallel.py
    ``prepare_context``, which boots the NCCL ring)."""
    from ...parallel.mesh import initialize_distributed

    env = ParallelEnv()
    if env.nranks > 1:
        initialize_distributed(world_size=env.nranks, rank=env.local_rank)
    return strategy


class DataParallel(Layer):
    def __init__(self, layers, strategy=None):
        super().__init__("data_parallel")
        self._layers = layers
        self._strategy = strategy
        self._env = ParallelEnv()

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        """loss / nranks before backward (reference: parallel.py:150)."""
        if self._env.nranks <= 1:
            return loss
        return loss * (1.0 / self._env.nranks)

    def apply_collective_grads(self):
        """Sum every gradient over the ranks (reference: parallel.py:201);
        after ``scale_loss`` that is the mean gradient of the whole batch."""
        if self._env.nranks <= 1:
            return
        import torch.distributed as dist

        params = [p for p in self._layers.parameters()
                  if p._grad is not None]
        if not params:
            return
        # scale_loss divided; a world that does not hold every rank would
        # train on a fraction of the gradient: fail loudly instead
        size = dist.get_world_size() if dist.is_initialized() else 1
        if size != self._env.nranks:
            raise RuntimeError(
                "DataParallel: PADDLE_TRAINERS_NUM=%d but the "
                "torch.distributed world spans %d process(es) — call "
                "dygraph.parallel.prepare_context() before the first "
                "computation" % (self._env.nranks, size))
        by_dtype = {}
        for p in params:
            by_dtype.setdefault(p._grad.dtype, []).append(p)
        for group in by_dtype.values():
            # packed into a buffer of their own: a gradient tensor may be
            # shared by two VarBases, and the sum must land once in each
            flat = torch.cat([p._grad.reshape(-1) for p in group])
            dist.all_reduce(flat)
            for p, g in zip(group, torch.split(
                    flat, [p._grad.numel() for p in group])):
                p._grad = g.view(p._grad.shape)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_dict(self, *args, **kwargs):
        return self._layers.set_dict(*args, **kwargs)

    def parameters(self, include_sublayers=True):
        return self._layers.parameters(include_sublayers)
