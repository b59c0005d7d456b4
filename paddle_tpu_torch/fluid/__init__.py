"""The slice of ``paddle_tpu.fluid`` the serving and training paths
need: places, flags, the always-on profiler tallies, the op lowerings as
plain functions on tensors, and the Adam optimizer. The Program/Executor
IR is not ported yet."""

from . import core, flags, ops, optimizer, profiler
from .core import CPUPlace, CUDAPlace, resolve_device

__all__ = ["core", "flags", "ops", "optimizer", "profiler", "CPUPlace",
           "CUDAPlace", "resolve_device"]
