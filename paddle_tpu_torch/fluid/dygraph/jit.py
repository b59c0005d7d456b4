"""Dygraph-to-static capture (port of ``paddle_tpu/fluid/dygraph/jit.py``;
reference: python/paddle/fluid/dygraph/jit.py TracedLayer over
imperative/jit/program_desc_tracer.cc).

The reference jit-compiles the layer's forward with jax. Here a
``TracedLayer`` runs the layer eagerly under ``no_grad`` and returns
detached ``VarBase``s: the same values, with no compiled program behind
them (a CUDA-graph capture is ROADMAP A3's)."""

from .. import framework
from .base import guard, no_grad, to_variable
from .tracer import VarBase

__all__ = ["TracedLayer"]


class TracedLayer(object):
    def __init__(self, layer, feed_vars=None):
        self._layer = layer

    @staticmethod
    def trace(layer, inputs):
        """(the layer's outputs on ``inputs``, a ``TracedLayer`` of it)."""
        tl = TracedLayer(layer)
        outs = layer(*inputs)
        return outs, tl

    def __call__(self, *inputs):
        if framework.in_dygraph_mode():
            return self._run(inputs)
        # outside a guard: one on the device of the layer's parameters
        params = self._layer.parameters()
        place = None
        if params and params[0].value.device.type == "cpu":
            from ..core import CPUPlace

            place = CPUPlace()
        with guard(place):
            return self._run(inputs)

    def _run(self, inputs):
        with no_grad():
            out = self._layer(*[i if isinstance(i, VarBase)
                                else to_variable(i) for i in inputs])
        if isinstance(out, (list, tuple)):
            return [o.detach() for o in out]
        return out.detach()

    def save_inference_model(self, dirname, feed=None, fetch=None):
        raise NotImplementedError(
            "export via fluid.io.save_inference_model on a static build"
        )
