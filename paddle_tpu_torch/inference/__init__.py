"""Inference stack: ``AnalysisConfig``, ``AnalysisPredictor`` and
``create_paddle_predictor`` (port of ``paddle_tpu/inference``; Paddle's
paddle/fluid/inference/api: AnalysisConfig in paddle_analysis_config.h,
AnalysisPredictor in analysis_predictor.cc, ZeroCopyRun at :636,
CreatePaddlePredictor at :911).

A predictor loads a model saved by ``fluid.io.save_inference_model`` (by
this package or by the reference: the files are the same) into a scope
of its own and runs the pruned program through one ``fluid.Executor`` on
the card, op by op, through the port's kernels. Inputs set on a
``ZeroCopyTensor`` stay on the device until the next run; outputs are
copied to the host when read.

Device: the default, and ``enable_use_gpu(memory_pool_init_size_mb,
device_id)``, mean ``cuda:device_id``; ``disable_gpu()`` means the CPU.
On a machine without a GPU anything but ``disable_gpu()`` raises when
the predictor is built: there is no quiet fallback to the CPU.

Clones (``clone()``, the serving pool) share the loaded program, the
parameter tensors (each clone's own scope references them; a
persistable write replaces the reference in that clone's scope only) and
one Executor, whose per-program plan is built once for all of them.

Left for a later slice (ROADMAP queue A, item A5b): the reference's
exported-executable bundle (``save_optimized_model``,
``from_executable``) and its sharded predictor; here they raise.
"""

import os
import threading
import warnings

import numpy as np
import torch

from ..fluid import core
from ..fluid import io as _io
from ..fluid import profiler as _profiler
from ..fluid.executor import Executor, _to_numpy, scope_guard
from ..observability import compile_stats as _compile_stats

__all__ = [
    "AnalysisConfig",
    "AnalysisPredictor",
    "ZeroCopyTensor",
    "create_paddle_predictor",
]

_A5B = ("the exported-executable bundle is not ported yet (ROADMAP queue "
        "A, item A5b)")

_warned_noop = set()
_warned_lock = threading.Lock()


def _warn_noop(knob):
    """One-time (per knob, per process) warning: the reference's
    engine-specific accelerators do nothing here, and a user carrying a
    Paddle config over should know what runs instead."""
    with _warned_lock:
        if knob in _warned_noop:
            return
        _warned_noop.add(knob)
    warnings.warn(
        "AnalysisConfig.%s has no effect here: the predictor runs the "
        "pruned program on the GPU op by op, its attention through the "
        "port's own CUDA kernels; to keep request shapes to a fixed set, "
        "serve through paddle_tpu_torch.serving's padding-bucket ladder, "
        "warmed at server start." % knob,
        stacklevel=3,
    )


class AnalysisConfig(object):
    """Where the model is and which device runs it (reference:
    paddle_analysis_config.h). The MKLDNN and TensorRT switches are
    accepted for script compatibility and warn once."""

    def __init__(self, model_dir=None, params_file=None):
        self.set_model(model_dir, params_file)
        self._use_gpu = True
        self._device_id = 0

    def set_model(self, model_dir, params_file=None):
        """Only the paths change; device and switches set earlier stay.
        With ``params_file`` the first argument is the program file."""
        if params_file is not None:
            self._model_dir = os.path.dirname(model_dir)
            self._model_filename = os.path.basename(model_dir)
            self._params_filename = os.path.basename(params_file)
        else:
            self._model_dir = model_dir
            self._model_filename = None
            self._params_filename = None

    def model_dir(self):
        return self._model_dir

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        """Run on ``cuda:device_id`` (the default is device 0). The memory
        pool size is PyTorch's caching allocator's business here."""
        self._use_gpu = True
        self._device_id = int(device_id)

    def disable_gpu(self):
        """Run on the CPU, through every kernel's plain version."""
        self._use_gpu = False

    def use_gpu(self):
        return self._use_gpu

    def place(self):
        return (core.CUDAPlace(self._device_id) if self._use_gpu
                else core.CPUPlace())

    # the program runs as saved: these switches are accepted and change
    # nothing
    def switch_ir_optim(self, x=True):
        pass

    def enable_memory_optim(self):
        pass

    def switch_use_feed_fetch_ops(self, x=True):
        pass

    def switch_specify_input_names(self, x=True):
        pass

    def enable_mkldnn(self):
        _warn_noop("enable_mkldnn")

    def enable_tensorrt_engine(self, *args, **kwargs):
        _warn_noop("enable_tensorrt_engine")

    def set_cpu_math_library_num_threads(self, n):
        pass


class ZeroCopyTensor(object):
    """An input or output handle (reference: paddle_api.h ZeroCopyTensor:
    copy_from_cpu / copy_to_cpu). An input is copied to the predictor's
    device when set and stays there."""

    def __init__(self, predictor, name, is_input):
        self._predictor = predictor
        self._name = name
        self._is_input = is_input

    @property
    def name(self):
        return self._name

    def copy_from_cpu(self, arr):
        if not self._is_input:
            raise ValueError("copy_from_cpu on output tensor %r" % self._name)
        self._predictor._inputs[self._name] = torch.from_numpy(
            np.ascontiguousarray(arr)).to(self._predictor._device)

    def reshape(self, shape):
        pass  # shapes come from the array set in copy_from_cpu

    def copy_to_cpu(self):
        out = self._predictor._outputs.get(self._name)
        if out is None:
            raise RuntimeError(
                "no output for %r; call zero_copy_run first" % self._name)
        return _to_numpy(out)


class _SharedPlans(object):
    """What a predictor and its clones share: one Executor (its plan of
    the program is built once, under the Executor's lock, and serves
    every clone; parameters are read from each predictor's own scope at
    run time) and the set of input signatures that have run.

    The signature set is never trimmed: a signature is a tuple of shapes
    and dtype strings, and forgetting one would count a repeat shape as
    a ``predictor_plan_cache_misses`` again although nothing is built."""

    def __init__(self, exe):
        self.lock = threading.Lock()
        self.exe = exe
        self._seen_sigs = set()

    def check_feed_plan(self, sig):
        """True (a hit) when this signature has run before."""
        with self.lock:
            return sig in self._seen_sigs

    def record_feed_plan(self, sig):
        with self.lock:
            self._seen_sigs.add(sig)


class AnalysisPredictor(object):
    """Runs a saved inference model (reference: analysis_predictor.cc
    AnalysisPredictor). Raises ``RuntimeError`` on a machine without a
    GPU unless the config called ``disable_gpu()``."""

    def __init__(self, config):
        self._config = config
        self._place = config.place()
        self._device = core.resolve_device(self._place)
        self._scope = core.Scope()
        self._plan_holder = _SharedPlans(Executor(self._place))
        with scope_guard(self._scope):
            self._program, self._feed_names, fetch_vars = \
                _io.load_inference_model(
                    config._model_dir, self._plan_holder.exe,
                    model_filename=config._model_filename,
                    params_filename=config._params_filename)
        self._fetch_names = [v.name for v in fetch_vars]
        self._inputs = {}
        self._outputs = {}

    # -- ZeroCopy API --------------------------------------------------------
    def get_input_names(self):
        return list(self._feed_names)

    def get_output_names(self):
        return list(self._fetch_names)

    def get_input_tensor(self, name):
        if name not in self._feed_names:
            raise KeyError("%r is not an input (%s)" % (name,
                                                       self._feed_names))
        return ZeroCopyTensor(self, name, True)

    def get_output_tensor(self, name):
        if name not in self._fetch_names:
            raise KeyError("%r is not an output (%s)" % (name,
                                                        self._fetch_names))
        return ZeroCopyTensor(self, name, False)

    def zero_copy_run(self):
        """reference: analysis_predictor.cc:636 ZeroCopyRun — the inputs
        are on the device already (``copy_from_cpu``); the outputs stay
        there until read."""
        outs = self._plan_holder.exe.run(
            self._program, feed=dict(self._inputs),
            fetch_list=self._fetch_names, scope=self._scope,
            return_numpy=False)
        self._outputs = dict(zip(self._fetch_names, outs))

    # -- classic run() API ---------------------------------------------------
    def run(self, inputs):
        """``inputs``: numpy arrays in feed order; returns the outputs as
        numpy arrays (bf16 as fp32).

        The first successful run at a shape signature counts a
        ``predictor_plan_cache_misses``, every later one a
        ``predictor_plan_cache_hits`` (shared by the clones). A failed
        run records nothing, so its retries stay misses."""
        if len(inputs) != len(self._feed_names):
            raise ValueError(
                "expected %d inputs (%s), got %d"
                % (len(self._feed_names), self._feed_names, len(inputs)))
        arrs = [np.ascontiguousarray(a) for a in inputs]
        sig = tuple((a.shape, a.dtype.str) for a in arrs)
        holder = self._plan_holder
        hit = holder.check_feed_plan(sig)
        _profiler.bump_counter("predictor_plan_cache_hits" if hit
                               else "predictor_plan_cache_misses")
        if not hit:
            # a new shape signature on a served path is a build the
            # strict gate counts (and, strict, refuses before the run)
            _compile_stats.on_build(
                "predictor_plan",
                _compile_stats.program_label(self._program),
                {"feeds": [[list(s), d] for s, d in sig]})
        for name, arr in zip(self._feed_names, arrs):
            self._inputs[name] = torch.from_numpy(arr).to(self._device)
        self.zero_copy_run()
        if not hit:
            holder.record_feed_plan(sig)
        return [_to_numpy(self._outputs[n]) for n in self._fetch_names]

    def clone(self, share_plans=True):
        """A predictor with its own scope, inputs and outputs (reference:
        analysis_predictor.cc Clone). By default it shares the program,
        the Executor and its plans, and the parameter tensors: they enter
        the clone's fresh scope as references, with no reload and no copy,
        and a persistable write replaces the reference in that one scope
        only. ``share_plans=False`` reloads the model from disk into a
        fully separate predictor."""
        if not share_plans:
            return AnalysisPredictor(self._config)
        c = AnalysisPredictor.__new__(AnalysisPredictor)
        c._config = self._config
        c._place = self._place
        c._device = self._device
        c._scope = core.Scope()
        for n in self._scope.local_var_names():
            c._scope.set(n, self._scope.get(n))
        c._plan_holder = self._plan_holder
        c._program = self._program
        c._feed_names = list(self._feed_names)
        c._fetch_names = list(self._fetch_names)
        c._inputs = {}
        c._outputs = {}
        return c

    @property
    def program(self):
        return self._program

    @property
    def scope(self):
        """The predictor's scope: its parameters, on its device."""
        return self._scope

    def save_optimized_model(self, *args, **kwargs):
        raise NotImplementedError(_A5B)

    @classmethod
    def from_executable(cls, *args, **kwargs):
        raise NotImplementedError(_A5B)


def create_paddle_predictor(config):
    """reference: analysis_predictor.cc:911 CreatePaddlePredictor."""
    return AnalysisPredictor(config)
