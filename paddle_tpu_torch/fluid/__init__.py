"""The slice of ``paddle_tpu.fluid`` the serving and training paths need:
places, flags, the always-on profiler tallies, the Program IR
(``framework``) with its pass registry (``ir``) and its framework.proto
serialization (``proto``), persistence (``io``), the Executor, desc-level
autodiff (``backward``), the layers of the GPT train program,
initializers, the optimizers (Adam also in its eager form, and
activation recompute), LoD feeds (``DataFeeder``, ``create_lod_tensor``),
automatic mixed precision (``contrib.mixed_precision``), and the op
lowerings, which the eager models also call as plain functions on
tensors."""

from . import core, flags, ops, profiler, unique_name  # noqa: F401
from . import framework, initializer, param_attr  # noqa: F401
from . import backward, clip, executor, layers, optimizer, regularizer  # noqa: F401
from . import contrib, io, ir, proto  # noqa: F401
from . import data_feeder, lod_tensor, nets  # noqa: F401
from .backward import append_backward, gradients
from .core import CPUPlace, CUDAPlace, LoDTensor, Scope, resolve_device
from .data_feeder import DataFeeder
from .lod_tensor import create_lod_tensor, create_random_int_lodtensor
from .executor import Executor, global_scope, scope_guard
from .flags import get_flags, set_flags
from .io import (
    load,
    load_inference_model,
    load_params,
    load_persistables,
    load_program_scope,
    load_program_state,
    load_vars,
    save,
    save_inference_model,
    save_params,
    save_persistables,
    save_vars,
    set_program_state,
)
from .framework import (
    Parameter,
    Program,
    Variable,
    default_main_program,
    default_startup_program,
    name_scope,
    program_guard,
)
from .param_attr import ParamAttr

__all__ = [
    "core", "flags", "ops", "profiler", "unique_name", "framework",
    "initializer", "param_attr", "backward", "clip", "executor", "layers",
    "optimizer", "regularizer", "contrib", "io", "ir", "proto",
    "append_backward", "gradients", "CPUPlace", "CUDAPlace", "LoDTensor", "Scope", "resolve_device", "Executor",
    "global_scope", "scope_guard", "Parameter", "Program", "Variable",
    "default_main_program", "default_startup_program", "name_scope",
    "program_guard", "ParamAttr", "get_flags", "set_flags", "save_vars",
    "save_params", "save_persistables", "load_vars", "load_params",
    "load_persistables", "load_program_scope", "save_inference_model",
    "load_inference_model",
    "save", "load", "load_program_state", "set_program_state",
    "data_feeder", "lod_tensor", "nets", "DataFeeder", "create_lod_tensor",
    "create_random_int_lodtensor",
]
