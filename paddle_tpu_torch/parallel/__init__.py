"""Process groups and collectives over ``torch.distributed`` (port of
``paddle_tpu/parallel``): one process per device, each a rank of a world
that the port's launcher describes. The GSPMD mesh (``spmd``,
``build_mesh``, ``shard_map``) comes with a later part of the parallel
toolbox."""

from .mesh import (  # noqa: F401
    CommContext,
    default_backend,
    initialize_distributed,
    is_initialized,
    pad_to_multiple,
    rank,
    shutdown,
    world_size,
)
from . import quantized_allreduce  # noqa: F401
