"""Process groups and the collective context (port of
``paddle_tpu/parallel/mesh.py``).

The reference runs one controller over a mesh of devices: a ``ring_id``
names a mesh axis, and ``jax.distributed.initialize`` plus a ``Mesh``
replace the reference's ``c_gen_nccl_id`` / ``c_comm_init`` bootstrap.
The port runs one process per device instead, as PyTorch does: each rank
joins a ``torch.distributed`` world that the port's launcher describes
(``python -m paddle_tpu_torch.distributed.launch --nproc_per_node N``
exports ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and
``LOCAL_RANK``), and ``CommContext`` maps each ring id to a
``ProcessGroup``: ring 0 is the world, another ring a ``new_group`` over
the same ranks, made the first time a rank asks for it. Every rank runs
the same program, so every rank asks for its rings in the same order, as
``new_group`` needs.

The backend is chosen once, when the world starts: NCCL for CUDA
tensors, gloo on the CPU, or the one the caller names (gloo also carries
CUDA tensors, which two ranks on one card need: NCCL refuses two ranks
on one GPU). Nothing here switches backend after a failure.

The mesh itself (``build_mesh``, ``shard_map``) comes with the GSPMD
part of the parallel toolbox.
"""

import datetime
import os

import torch

DEFAULT_TIMEOUT_S = 300.0


def _dist():
    import torch.distributed as dist

    return dist


def is_initialized():
    """Whether this process belongs to a ``torch.distributed`` world."""
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def world_size():
    """The ranks of the world (1 when no process group is up)."""
    return _dist().get_world_size() if is_initialized() else 1


def rank():
    """This process's rank in the world (0 when no process group is up)."""
    return _dist().get_rank() if is_initialized() else 0


def default_backend(device):
    """NCCL for a CUDA device, gloo otherwise."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _env_int(names, default):
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return int(v)
    return default


def initialize_distributed(backend=None, init_method=None, world_size=None,
                           rank=None, timeout_s=None, device=None):
    """Join the world the launcher describes (reference:
    ``initialize_distributed``; Paddle's ``c_gen_nccl_id_op.cc`` +
    ``c_comm_init_op.cc``). ``world_size`` and ``rank`` default to
    ``WORLD_SIZE`` / ``RANK`` (else ``PADDLE_TRAINERS_NUM`` /
    ``PADDLE_TRAINER_ID``); ``init_method`` to ``env://``, which reads
    ``MASTER_ADDR`` / ``MASTER_PORT``; ``backend`` to NCCL for a CUDA
    ``device`` (default: the launcher's ``PADDLE_LAUNCH_DEVICE``, else
    the card) and gloo for the CPU. ``timeout_s`` bounds the rendezvous
    and every collective, so a missing peer fails instead of hanging.

    A world of one starts no process group: the collectives are then
    identities, as the reference's are outside a mesh. Returns whether
    this process is in a world of more than one rank."""
    dist = _dist()
    if is_initialized():
        return dist.get_world_size() > 1
    n = world_size if world_size is not None else _env_int(
        ("WORLD_SIZE", "PADDLE_TRAINERS_NUM"), 1)
    r = rank if rank is not None else _env_int(
        ("RANK", "PADDLE_TRAINER_ID"), 0)
    if n <= 1:
        return False
    if backend is None:
        if device is None:
            device = os.environ.get("PADDLE_LAUNCH_DEVICE") or "cuda"
        backend = default_backend(device)
    if backend == "nccl":
        local = _env_int(("LOCAL_RANK",), 0)
        torch.cuda.set_device(local % max(torch.cuda.device_count(), 1))
    timeout = datetime.timedelta(
        seconds=DEFAULT_TIMEOUT_S if timeout_s is None else float(timeout_s))
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=n, rank=r, timeout=timeout)
    CommContext.instance().reset()
    return True


def shutdown():
    """Leave the world and forget its rings."""
    if is_initialized():
        _dist().destroy_process_group()
    CommContext.instance().reset()


class CommContext(object):
    """ring_id -> ProcessGroup (reference: NCCLCommContext keyed by
    ring_id, ``platform/collective_helper.h:62``; the reference's maps a
    ring to a mesh axis). Ring 0 is the world; ``register`` names another
    group (a subset, or another backend) under a ring id; any other ring
    becomes a ``new_group`` of every rank on first use."""

    _instance = None

    def __init__(self):
        self._groups = {}

    @classmethod
    def instance(cls):
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def reset(self):
        self._groups = {}

    def register(self, ring_id, group):
        self._groups[int(ring_id)] = group

    def has(self, ring_id=0):
        return int(ring_id) == 0 or int(ring_id) in self._groups

    def group(self, ring_id=0):
        """The ProcessGroup of ``ring_id``; None when this process is in
        no world (the collectives are then identities)."""
        if not is_initialized():
            return None
        ring_id = int(ring_id)
        g = self._groups.get(ring_id)
        if g is None:
            dist = _dist()
            g = dist.group.WORLD if ring_id == 0 else dist.new_group(
                list(range(dist.get_world_size())))
            self._groups[ring_id] = g
        return g


def pad_to_multiple(flat, n):
    """Zero-pad a 1-D tensor to a multiple of ``n`` (the collective tiling
    helper of ``quantized_allreduce``) -> (padded, original size)."""
    size = flat.shape[0]
    pad = (-size) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat, size
