"""The slice of ``paddle_tpu.fluid`` the serving and training paths need:
places, flags, the always-on profiler tallies, NaN/Inf checking
(``debugger``), the input pipeline (``DataLoader``, ``PyReader``, the
file ``dataset``s over the native host library, staged to the card by
``io_pipeline``), the dataset trainers (``Executor.train_from_dataset``), the Program IR
(``framework``) with its pass registry (``ir``) and its framework.proto
serialization (``proto``), persistence (``io``), the Executor, desc-level
autodiff (``backward``), the layers of the GPT train program,
initializers, the optimizers (Adam also in its eager form, and
activation recompute), LoD feeds (``DataFeeder``, ``create_lod_tensor``),
automatic mixed precision (``contrib.mixed_precision``), data-parallel
training over ``torch.distributed`` (``CompiledProgram``,
``ParallelExecutor``, the collective ``transpiler`` and fleet's
collective mode under ``incubate``), dygraph (``fluid.dygraph``: the
tracer, ``Layer``s, eager optimizers, ``save_dygraph`` / ``load_dygraph``
and ``DataParallel``), and the op lowerings, which the eager models also
call as plain functions on tensors."""

from . import core, flags, ops, profiler, unique_name  # noqa: F401
from . import framework, initializer, param_attr  # noqa: F401
from . import backward, clip, executor, layers, optimizer, regularizer  # noqa: F401
from . import contrib, io, ir, proto  # noqa: F401
from . import data_feeder, lod_tensor, nets  # noqa: F401
from . import debugger, io_pipeline, native, reader  # noqa: F401
from . import data_feed_desc, dataset, trainer  # noqa: F401
from . import device_worker, trainer_desc, trainer_factory  # noqa: F401
from . import compiler, parallel_executor, transpiler, incubate  # noqa: F401
from . import dygraph  # noqa: F401
from .dygraph.checkpoint import save_dygraph, load_dygraph
from .backward import append_backward, gradients
from .compiler import BuildStrategy, CompiledProgram, ExecutionStrategy
from .parallel_executor import ParallelExecutor
from .transpiler import (DistributeTranspiler, DistributeTranspilerConfig,
                         memory_optimize, release_memory)
from .incubate import fleet
from .core import CPUPlace, CUDAPlace, LoDTensor, Scope, resolve_device
from .data_feeder import DataFeeder
from .data_feed_desc import DataFeedDesc
from .dataset import DatasetFactory
from .debugger import set_check_nan_inf
from .reader import DataLoader, PyReader
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
    cpu_places,
    cuda_places,
    default_startup_program,
    in_dygraph_mode,
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
    "debugger", "io_pipeline", "native", "reader", "data_feed_desc",
    "dataset", "trainer", "device_worker", "trainer_desc",
    "trainer_factory", "DataFeedDesc", "DatasetFactory", "DataLoader",
    "PyReader", "set_check_nan_inf", "cpu_places", "cuda_places",
    "compiler", "parallel_executor", "transpiler", "incubate",
    "CompiledProgram", "ExecutionStrategy", "BuildStrategy",
    "ParallelExecutor", "DistributeTranspiler",
    "DistributeTranspilerConfig", "memory_optimize", "release_memory",
    "fleet", "dygraph", "in_dygraph_mode", "save_dygraph", "load_dygraph",
]
