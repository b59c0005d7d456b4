"""Optimizers (port of ``AdamOptimizer`` / ``Adam`` in
``paddle_tpu/fluid/optimizer.py``) over ``nn.Module`` parameters.

The reference appends update ops to a static program; the port's train
step runs eagerly, so ``minimize(loss)`` runs the backward and the
update at once.
"""

import torch

from .ops import optimizer_ops

__all__ = ["AdamOptimizer", "Adam"]


class AdamOptimizer(object):
    """Adam with the reference's update rule (``optimizer_ops.adam``):
    per-parameter moments, created at zero, and β-pow accumulators that
    start at β₁ and β₂ (``optimizer.py:454``). Every parameter is updated
    every step, as the reference's dense update does: a parameter whose
    gradient is None is updated with zeros.

    ``parameter_list``: the parameters to train (an iterable of tensors,
    e.g. ``model.parameters()``), given here or to ``minimize``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameter_list=None):
        self._learning_rate = float(learning_rate)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._params = None
        if parameter_list is not None:
            self._bind(parameter_list)

    def _bind(self, parameter_list):
        self._params = [p for p in parameter_list]
        self._moment1 = [torch.zeros_like(p) for p in self._params]
        self._moment2 = [torch.zeros_like(p) for p in self._params]
        n = len(self._params)
        self._beta1_pow = torch.full((n,), self._beta1, dtype=torch.float32)
        self._beta2_pow = torch.full((n,), self._beta2, dtype=torch.float32)

    def state(self):
        """{"moment1", "moment2": lists of tensors, "beta1_pow",
        "beta2_pow": fp32 CPU tensors [n]} in parameter order."""
        return {"moment1": self._moment1, "moment2": self._moment2,
                "beta1_pow": self._beta1_pow, "beta2_pow": self._beta2_pow}

    def step(self):
        """One update from the parameters' ``.grad``."""
        if self._params is None:
            raise ValueError("AdamOptimizer needs parameter_list (pass it to "
                             "the constructor or minimize)")
        with torch.no_grad():
            optimizer_ops.adam(
                self._params, [p.grad for p in self._params], self._moment1,
                self._moment2, self._beta1_pow, self._beta2_pow,
                self._learning_rate, self._beta1, self._beta2, self._epsilon)

    def clear_grad(self):
        for p in self._params:
            p.grad = None

    def minimize(self, loss, parameter_list=None):
        """Backward from ``loss``, one update, then the grads are cleared
        (set to None). Binds ``parameter_list`` on first use."""
        if self._params is None and parameter_list is not None:
            self._bind(parameter_list)
        loss.backward()
        self.step()
        self.clear_grad()


Adam = AdamOptimizer
