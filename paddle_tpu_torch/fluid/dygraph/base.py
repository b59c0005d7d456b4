"""Dygraph mode switches (port of ``paddle_tpu/fluid/dygraph/base.py``;
reference: python/paddle/fluid/dygraph/base.py:100 ``guard``,
``to_variable``).

``guard(place=None)`` runs on the card, as every entry point of the port
does, and raises on a machine without one; ``guard(fluid.CPUPlace())``
runs the plain path on the CPU. (The reference's default place is the
CPU.) Parameters are drawn by the initializers' own ops through the
tracer, from its generators seeded with the default main program's
``random_seed``; the reference draws them from JAX keys, so parity tests
copy parameters across."""

import contextlib
import functools

import torch

from .. import core
from .. import framework
from .. import unique_name
from .tracer import Tracer, VarBase, _as_list, _expected_device

__all__ = ["guard", "enabled", "enable_dygraph", "disable_dygraph",
           "to_variable", "no_grad", "grad"]


def _current_tracer():
    return framework._dygraph_tracer()


def enabled():
    return framework.in_dygraph_mode()


def _new_tracer(place):
    return Tracer(core.resolve_device(place),
                  seed=framework.default_main_program().random_seed)


def enable_dygraph(place=None):
    """Enter dygraph mode until ``disable_dygraph`` (the guard, without a
    ``with``)."""
    place = core.CUDAPlace(0) if place is None else place
    framework._dygraph_tracer_ = _new_tracer(place)
    framework._dygraph_current_expected_place_ = place


def disable_dygraph():
    framework._dygraph_tracer_ = None
    framework._dygraph_current_expected_place_ = None


@contextlib.contextmanager
def guard(place=None):
    """Dygraph mode on ``place`` (default ``CUDAPlace(0)``)."""
    place = core.CUDAPlace(0) if place is None else place
    tracer = _new_tracer(place)
    with framework._dygraph_guard(tracer):
        with framework._dygraph_place_guard(place):
            yield


def to_variable(value, name=None, zero_copy=None):
    """A copy of the array ``value`` on the guard's device, as a
    ``VarBase`` that stops the gradient."""
    if isinstance(value, VarBase):
        return value
    t = value.detach() if isinstance(value, torch.Tensor) else \
        torch.as_tensor(value)
    return VarBase(t.to(_expected_device(), copy=True), name=name,
                   stop_gradient=True)


@contextlib.contextmanager
def _no_grad_ctx():
    tracer = _current_tracer()
    if tracer is None:
        yield
        return
    old = tracer._no_grad
    tracer._no_grad = True
    try:
        yield
    finally:
        tracer._no_grad = old


def no_grad(fn=None):
    """Trace nothing for the backward: as a context manager, or as a
    decorator of ``fn``."""
    if fn is None:
        return _no_grad_ctx()

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with _no_grad_ctx():
            return fn(*args, **kwargs)

    return wrapper


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """The gradients of ``outputs`` with respect to ``inputs``, as
    ``VarBase``s, from the tape's pullbacks (each a
    ``torch.autograd.grad`` call or a grad op); ``grad_outputs`` are the
    outputs' cotangents (default ones). The ``_grad`` slots are left as
    they are and the tape is cleared. An input that no output reaches
    gives None with ``allow_unused``, else it raises. The reference
    returns its inputs' accumulated ``_grad`` after a ``backward()``;
    keeping the tape for a second pass (``retain_graph``) and
    differentiating the result (``create_graph``) are not ported."""
    tracer = _current_tracer()
    if tracer is None:
        raise RuntimeError("dygraph.grad outside the dygraph guard")
    if retain_graph or create_graph:
        raise NotImplementedError(
            "dygraph.grad: retain_graph and create_graph are not ported")
    outputs, inputs = _as_list(outputs), _as_list(inputs)
    cots = [None] * len(outputs) if grad_outputs is None else \
        _as_list(grad_outputs)
    seeds = [(o, torch.ones_like(o._value) if c is None else c._value)
             for o, c in zip(outputs, cots)]
    try:
        grads, _holders = tracer.backward_grads(seeds)
    finally:
        tracer._tape = []
    result = []
    for v in inputs:
        g = grads.get(v._uid)
        if g is None and not allow_unused:
            raise ValueError("dygraph.grad: %r is not reached from the "
                             "outputs (pass allow_unused=True)" % v.name)
        result.append(None if g is None else VarBase(g, stop_gradient=True))
    return result


class _InitTarget(object):
    """What an initializer reads of the variable it initializes."""

    def __init__(self, name, shape, dtype):
        self.name = name
        self.shape = tuple(shape)
        self.dtype = dtype


class _InitBlock(object):
    """The block an initializer appends its op to: the op is traced at
    once into ``param`` (no startup program under the guard)."""

    def __init__(self, tracer, param):
        self._tracer = tracer
        self._param = param
        self.vars = {param.name: param}

    def has_var(self, name):
        return name in self.vars

    def append_op(self, type=None, inputs=None, outputs=None, attrs=None):
        return self._tracer.trace_op(type, {}, {"Out": [self._param]},
                                     attrs or {}, stop_gradient=True)


def _create_parameter_eager(attr, shape, dtype, initializer):
    """``LayerHelper.create_parameter`` under the guard: the initializer's
    op runs through the tracer on the guard's device, from its
    generators."""
    tracer = _current_tracer()
    if tracer is None:
        raise RuntimeError("dygraph parameters are made under "
                           "fluid.dygraph.guard()")
    name = attr.name or unique_name.generate("eager_param")
    dtype = dtype if isinstance(dtype, int) else core.np_to_dtype(dtype)
    p = VarBase(name=name, persistable=True, is_parameter=True)
    initializer(_InitTarget(name, [int(s) for s in shape], dtype),
                _InitBlock(tracer, p))
    p.stop_gradient = not attr.trainable
    p.trainable = attr.trainable
    p.optimize_attr = {"learning_rate": attr.learning_rate}
    p.regularizer = attr.regularizer
    p.gradient_clip_attr = attr.gradient_clip
    return p
