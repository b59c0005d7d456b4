"""Program transpilers (port of ``paddle_tpu/fluid/transpiler/``;
reference: python/paddle/fluid/transpiler/). The collective ones
(``GradAllReduce``, ``LocalSGD``) are here; the parameter-server
``DistributeTranspiler`` comes with the parameter-server part of the
parallel toolbox (ROADMAP A12c) and raises until then."""

from . import collective  # noqa: F401
from .collective import GradAllReduce, LocalSGD  # noqa: F401

_PSERVER_PART = (
    "the parameter-server transpiler is not ported yet (ROADMAP A12c: "
    "DistributeTranspiler, the distributed ops, the communicator); "
    "train data-parallel with fluid.CompiledProgram(...)"
    ".with_data_parallel() or fleet's collective mode")


class DistributeTranspilerConfig(object):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_PSERVER_PART)


class DistributeTranspiler(object):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_PSERVER_PART)


class HashName(object):
    def __init__(self, pserver_endpoints):
        self.pserver_endpoints = pserver_endpoints

    def dispatch(self, varlist):
        eplist = []
        for var in varlist:
            server_id = hash(var.name) % len(self.pserver_endpoints)
            eplist.append(self.pserver_endpoints[server_id])
        return eplist


class RoundRobin(object):
    def __init__(self, pserver_endpoints):
        self.pserver_endpoints = pserver_endpoints
        self.pserver_idx = 0

    def dispatch(self, varlist):
        eplist = []
        for _ in varlist:
            eplist.append(self.pserver_endpoints[self.pserver_idx])
            self.pserver_idx = (self.pserver_idx + 1) % len(
                self.pserver_endpoints
            )
        return eplist


def memory_optimize(*args, **kwargs):
    """Deprecated in the reference (memory_optimization_transpiler.py
    shim); the Executor already drops each value after its last read."""
    return None


def release_memory(*args, **kwargs):
    return None
