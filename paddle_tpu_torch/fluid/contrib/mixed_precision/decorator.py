"""OptimizerWithMixedPrecision (port of
``paddle_tpu/fluid/contrib/mixed_precision/decorator.py``; reference:
contrib/mixed_precision/decorator.py:27).

Usage is identical to the reference::

    mp_opt = fluid.contrib.mixed_precision.decorate(optimizer)
    mp_opt.minimize(loss)

The default low dtype is bf16, where loss scaling is a mathematical no-op
— the dynamic-scaling machinery is still wired for fp16 and for tests."""

from __future__ import annotations

from ...framework import default_startup_program
from ...layers import tensor as ltensor
from .fp16_lists import AutoMixedPrecisionLists
from . import fp16_utils


class OptimizerWithMixedPrecision(object):
    def __init__(
        self,
        optimizer,
        amp_lists,
        init_loss_scaling,
        use_dynamic_loss_scaling,
        incr_every_n_steps,
        decr_every_n_nan_or_inf,
        incr_ratio,
        decr_ratio,
        use_bf16=True,
    ):
        self._optimizer = optimizer
        self._amp_lists = amp_lists or AutoMixedPrecisionLists()
        self._init_loss_scaling = init_loss_scaling
        self._use_dynamic_loss_scaling = use_dynamic_loss_scaling
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._use_bf16 = use_bf16
        self._loss_scaling = None
        self._good_steps = None
        self._params_grads = None

    def get_loss_scaling(self):
        return self._loss_scaling

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        # routed through the Pass registry so PassBuilder pipelines can
        # inspect/reorder/disable the AMP rewrite (ir.py amp_rewrite_pass)
        from ...ir import get_pass

        get_pass(
            "amp_rewrite_pass",
            amp_lists=self._amp_lists,
            use_bf16=self._use_bf16,
        ).apply_program(loss.block.program)
        self._loss_scaling = ltensor.create_global_var(
            name="loss_scaling",
            shape=[1],
            value=self._init_loss_scaling,
            dtype="float32",
            persistable=True,
        )
        scaled_loss = fp16_utils.scale_loss(loss, self._loss_scaling)
        params_grads = self._optimizer.backward(
            scaled_loss, startup_program, parameter_list, no_grad_set, callbacks
        )
        return params_grads

    def apply_gradients(self, params_grads):
        params_grads = fp16_utils.unscale_grads(params_grads, self._loss_scaling)
        if self._use_dynamic_loss_scaling:
            self._good_steps = ltensor.create_global_var(
                name="loss_scaling_good_steps",
                shape=[1],
                value=0.0,
                dtype="float32",
                persistable=True,
            )
            finite = fp16_utils.update_loss_scaling(
                params_grads,
                self._loss_scaling,
                self._good_steps,
                self._incr_every_n_steps,
                self._decr_every_n_nan_or_inf,
                self._incr_ratio,
                self._decr_ratio,
            )
            if finite is not None:
                # zero non-finite grads via where-select — the
                # in-graph "skip step" (NOT g * finite: inf * 0 is
                # NaN, which would poison the very update the scaler is
                # trying to skip)
                params_grads = fp16_utils.mask_nonfinite_grads(
                    params_grads, finite
                )
        return self._optimizer.apply_gradients(params_grads)

    def apply_optimize(self, loss, startup_program, params_grads):
        return self.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(
            loss, startup_program or default_startup_program(),
            parameter_list, no_grad_set,
        )
        self._params_grads = params_grads
        optimize_ops = self.apply_gradients(params_grads)
        return optimize_ops, params_grads


def decorate(
    optimizer,
    amp_lists=None,
    init_loss_scaling=1.0,
    incr_every_n_steps=1000,
    decr_every_n_nan_or_inf=2,
    incr_ratio=2.0,
    decr_ratio=0.8,
    use_dynamic_loss_scaling=False,
    use_bf16=True,
):
    """reference: decorator.py decorate (its defaults: init scale 2**15,
    dynamic scaling on — tuned for fp16; bf16 defaults here are scale 1.0,
    dynamic off, because bf16 has fp32's exponent range)."""
    return OptimizerWithMixedPrecision(
        optimizer,
        amp_lists,
        init_loss_scaling,
        use_dynamic_loss_scaling,
        incr_every_n_steps,
        decr_every_n_nan_or_inf,
        incr_ratio,
        decr_ratio,
        use_bf16=use_bf16,
    )
