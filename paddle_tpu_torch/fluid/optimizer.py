"""Optimizers (port of ``paddle_tpu/fluid/optimizer.py``: every class
but ``PipelineOptimizer``, with the short aliases ``SGD`` … ``Lamb``).

As in the reference, one class serves both uses:

- static: ``minimize(loss_var)`` on a Program appends the backward
  (``append_backward``), gradient clip and regularization ops, then one
  update op per parameter, with the accumulators created in the startup
  program (reference: optimizer.py ``_create_optimization_pass``);
- eager: given ``parameter_list`` tensors, ``minimize(loss_tensor)`` runs
  autograd's backward and the update at once over every parameter
  (``optimizer_ops.adam``, the reference's rule; Adam only);
- dygraph (under ``fluid.dygraph.guard``): given ``parameter_list``
  ``VarBase``s, ``minimize(loss)`` after ``loss.backward()`` traces one
  update op per parameter that has a gradient, with the regularization
  and clip ops before it (reference: optimizer.py:259-313). The ops
  update the parameters' tensors in place, outside autograd. The
  learning rate is a float, a ``VarBase`` [1] or a dygraph
  ``LearningRateDecay``, called once a ``minimize``.
"""

from collections import defaultdict

import torch

from . import core, unique_name
from .backward import append_backward
from .framework import (
    OP_ROLE_KEY,
    OpRole,
    Variable,
    default_main_program,
    default_startup_program,
    in_dygraph_mode,
    op_role_guard,
    program_guard,
)
from .initializer import Constant
from .layer_helper import LayerHelper
from .ops import optimizer_ops

__all__ = ["Optimizer", "SGDOptimizer", "SGD", "MomentumOptimizer",
           "Momentum", "AdagradOptimizer", "Adagrad", "AdamOptimizer",
           "Adam", "RecomputeOptimizer", "LarsMomentumOptimizer",
           "AdamaxOptimizer", "Adamax", "DpsgdOptimizer", "Dpsgd",
           "DecayedAdagradOptimizer", "DecayedAdagrad", "AdadeltaOptimizer",
           "Adadelta", "RMSPropOptimizer", "RMSProp", "FtrlOptimizer",
           "Ftrl", "LambOptimizer", "Lamb", "DGCMomentumOptimizer",
           "ModelAverage", "LookaheadOptimizer", "ExponentialMovingAverage",
           "GradientMergeOptimizer"]


class Optimizer(object):
    """The program form of the reference's ``Optimizer``: learning-rate
    var, per-parameter accumulators, and ``minimize`` = backward + clip +
    regularization + one update op per parameter."""

    def __init__(self, learning_rate, regularization=None, name=None,
                 grad_clip=None, parameter_list=None):
        self._learning_rate = learning_rate
        self.regularization = regularization
        self._name = name
        self._learning_rate_map = {}
        self._accumulators = defaultdict(dict)
        self.helper = None
        self._grad_clip = grad_clip
        # dygraph: the VarBases bound at construction
        self._parameter_list = parameter_list
        self._dygraph_lr = None

    # -- learning rate --
    def _create_global_learning_rate(self):
        if in_dygraph_mode():
            self._dygraph_lr = self._dygraph_learning_rate()
            return
        program = default_main_program()
        if self._learning_rate_map.get(program) is not None:
            return
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_map[program] = self._learning_rate
            return
        lr_var = program.global_block().create_var(
            name=unique_name.generate("learning_rate"), shape=[1],
            dtype="float32", persistable=True)
        lr_var.stop_gradient = True
        self.helper.set_variable_initializer(
            lr_var, Constant(value=float(self._learning_rate)))
        self._learning_rate_map[program] = lr_var

    def _dygraph_learning_rate(self):
        """This step's learning rate as a VarBase [1]: a VarBase as it
        is, a ``LearningRateDecay`` called (one step), a float made once."""
        from .dygraph.learning_rate_scheduler import LearningRateDecay
        from .dygraph.tracer import VarBase, _expected_device

        lr = self._learning_rate
        if isinstance(lr, VarBase):
            return lr
        if isinstance(lr, LearningRateDecay):
            lr = lr()
        elif self._dygraph_lr is not None:
            return self._dygraph_lr
        return VarBase(torch.full((1,), float(lr), dtype=torch.float32,
                                  device=_expected_device()),
                       stop_gradient=True)

    def _global_learning_rate(self, program=None):
        if in_dygraph_mode():
            return self._dygraph_lr
        return self._learning_rate_map.get(program or default_main_program())

    def _create_param_lr(self, param_and_grad):
        param = param_and_grad[0]
        param_lr = (param.optimize_attr or {}).get("learning_rate", 1.0)
        base = self._global_learning_rate()
        if param_lr == 1.0:
            return base
        if in_dygraph_mode():
            from .dygraph.tracer import VarBase

            return VarBase(base.value * float(param_lr), stop_gradient=True)
        helper = LayerHelper("param_lr")
        out = helper.create_variable_for_type_inference("float32")
        helper.append_op(
            type="scale", inputs={"X": [base]}, outputs={"Out": [out]},
            attrs={"scale": float(param_lr), OP_ROLE_KEY: OpRole.Optimize})
        return out

    # -- accumulators (reference: Optimizer._add_accumulator) --
    def _add_accumulator(self, name, param, dtype=None, fill_value=0.0,
                         shape=None):
        if param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        if in_dygraph_mode():
            from .dygraph.tracer import VarBase

            acc = VarBase(
                torch.full(tuple(param.shape if shape is None else shape),
                           float(fill_value), dtype=param.value.dtype
                           if dtype is None else core.dtype_to_torch(dtype),
                           device=param.value.device),
                name=unique_name.generate(param.name + "_" + name),
                stop_gradient=True)
            self._accumulators[name][param.name] = acc
            return acc
        var = default_main_program().global_block().create_var(
            name=unique_name.generate(param.name + "_" + name),
            shape=shape if shape is not None else param.shape,
            dtype=dtype or param.dtype, persistable=True)
        var.stop_gradient = True
        var.belong_to_optimizer = True
        self.helper.set_variable_initializer(
            var, Constant(value=float(fill_value)))
        self._accumulators[name][param.name] = var
        return var

    def _get_accumulator(self, name, param):
        if param.name not in self._accumulators[name]:
            raise LookupError("accumulator %s for parameter %s not created"
                              % (name, param.name))
        return self._accumulators[name][param.name]

    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def _finish_update(self, block, parameters_and_grads):
        pass

    # -- main passes (reference: _create_optimization_pass at :385) --
    def _create_optimization_pass(self, parameters_and_grads):
        block = default_main_program().current_block()
        self.helper = LayerHelper(self.__class__.__name__)
        with op_role_guard(OpRole.Optimize):
            self._create_global_learning_rate()
            self._create_accumulators(
                block, [p for p, g in parameters_and_grads if g is not None])
            optimize_ops = []
            for param_and_grad in parameters_and_grads:
                if param_and_grad[1] is None:
                    continue
                if param_and_grad[0].trainable:
                    optimize_ops.append(
                        self._append_optimize_op(block, param_and_grad))
            self._finish_update(block, parameters_and_grads)
        return optimize_ops

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return append_backward(loss, parameter_list, no_grad_set, callbacks)

    def apply_gradients(self, params_grads):
        from . import clip as _clip
        from . import regularizer as _regularizer

        params_grads = sorted(params_grads, key=lambda x: x[0].name)
        params_grads = _clip.append_gradient_clip_ops(params_grads)
        params_grads = _regularizer.append_regularization_ops(
            params_grads, self.regularization)
        return self._create_optimization_pass(params_grads)

    def apply_optimize(self, loss, startup_program, params_grads):
        with program_guard(default_main_program(),
                           startup_program or default_startup_program()):
            return self.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, grad_clip=None):
        """Append the backward and the update ops for the program
        variable ``loss``; returns (optimize ops, [(param, grad)]). Under
        the dygraph guard: the update of ``parameter_list`` (or the
        constructor's) from the gradients ``loss.backward()`` left."""
        if in_dygraph_mode():
            return self._dygraph_minimize(
                loss, parameter_list or self._parameter_list)
        params_grads = self.backward(loss, startup_program=startup_program,
                                     parameter_list=parameter_list,
                                     no_grad_set=no_grad_set)
        if grad_clip is not None:
            from . import clip as _clip

            params_grads = _clip.append_clip_with(params_grads, grad_clip)
        optimize_ops = self.apply_optimize(loss, startup_program,
                                           params_grads)
        return optimize_ops, params_grads


    def _dygraph_minimize(self, loss, parameter_list):
        """Trace, outside autograd, the regularization and clip ops and one
        update op per parameter with a gradient, each updating its
        tensors in place (reference: optimizer.py:276)."""
        if not parameter_list:
            raise ValueError("dygraph optimizer needs parameter_list "
                             "(pass it to the constructor or minimize)")
        from . import clip as _clip
        from . import regularizer as _regularizer
        from .dygraph.base import no_grad
        from .dygraph.tracer import VarBase

        with no_grad(), torch.no_grad():
            params_grads = [(p, VarBase(p.grad, stop_gradient=True))
                            for p in parameter_list if p.grad is not None]
            params_grads = _regularizer.append_regularization_ops(
                params_grads, self.regularization)
            if self._grad_clip is not None:
                params_grads = _clip.append_clip_with(params_grads,
                                                      self._grad_clip)
            self.helper = LayerHelper(self.__class__.__name__)
            self._create_global_learning_rate()
            block = default_main_program().global_block()
            self._create_accumulators(block, [p for p, _g in params_grads])
            ops = [self._append_optimize_op(block, pg)
                   for pg in params_grads]
            self._finish_update(block, params_grads)
        return ops, params_grads


class SGDOptimizer(Optimizer):
    """Plain SGD (``optimizer.py:315``): one ``sgd`` op per parameter,
    p −= lr·g."""

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        return block.append_op(
            type="sgd",
            inputs={"Param": [param], "Grad": [grad],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param]},
            attrs={OP_ROLE_KEY: OpRole.Optimize},
        )


class MomentumOptimizer(Optimizer):
    """SGD with momentum (``optimizer.py:332``): one ``momentum`` op per
    parameter with a ``velocity`` accumulator created at zero;
    ``use_nesterov`` takes the Nesterov step."""

    _velocity_acc_str = "velocity"

    def __init__(self, learning_rate, momentum, use_nesterov=False,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._velocity_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        velocity = self._get_accumulator(self._velocity_acc_str, param)
        return block.append_op(
            type="momentum",
            inputs={"Param": [param], "Grad": [grad], "Velocity": [velocity],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param], "VelocityOut": [velocity]},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov,
                   OP_ROLE_KEY: OpRole.Optimize},
        )


class AdagradOptimizer(Optimizer):
    """Adagrad (``optimizer.py:398``): one ``adagrad`` op per parameter
    with a ``moment`` accumulator created at
    ``initial_accumulator_value``."""

    _moment_acc_str = "moment"

    def __init__(self, learning_rate, epsilon=1e-6,
                 initial_accumulator_value=0.0, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._epsilon = epsilon
        self.initial_accumulator_value = initial_accumulator_value

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p,
                                  fill_value=self.initial_accumulator_value)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        moment = self._get_accumulator(self._moment_acc_str, param)
        return block.append_op(
            type="adagrad",
            inputs={"Param": [param], "Grad": [grad], "Moment": [moment],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param], "MomentOut": [moment]},
            attrs={"epsilon": self._epsilon, OP_ROLE_KEY: OpRole.Optimize},
        )


class AdamOptimizer(Optimizer):
    """Adam with the reference's update rule (``optimizer_ops.adam``, ε
    not bias-corrected): per-parameter moments created at zero and β-pow
    accumulators that start at β₁ and β₂ (``optimizer.py:454``).

    Static: ``minimize(loss_var)`` appends one ``adam`` op per parameter.
    Eager: ``parameter_list`` (an iterable of tensors, e.g.
    ``model.parameters()``, given here or to ``minimize``) and
    ``minimize(loss_tensor)``; every parameter is updated every step, as
    the reference's dense update does: a parameter whose gradient is None
    is updated with zeros."""

    _moment1_acc_str = "moment1"
    _moment2_acc_str = "moment2"
    _beta1_pow_acc_str = "beta1_pow_acc"
    _beta2_pow_acc_str = "beta2_pow_acc"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, parameter_list=None,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._lazy_mode = lazy_mode
        self._params = None
        if in_dygraph_mode():
            self._parameter_list = parameter_list
        elif parameter_list is not None:
            self._bind(parameter_list)

    # -- static (program) form --
    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment1_acc_str, p)
            self._add_accumulator(self._moment2_acc_str, p)
            self._add_accumulator(self._beta1_pow_acc_str, p,
                                  fill_value=self._beta1, shape=[1])
            self._add_accumulator(self._beta2_pow_acc_str, p,
                                  fill_value=self._beta2, shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        moment1 = self._get_accumulator(self._moment1_acc_str, param)
        moment2 = self._get_accumulator(self._moment2_acc_str, param)
        beta1_pow = self._get_accumulator(self._beta1_pow_acc_str, param)
        beta2_pow = self._get_accumulator(self._beta2_pow_acc_str, param)
        return block.append_op(
            type="adam",
            inputs={"Param": [param], "Grad": [grad], "Moment1": [moment1],
                    "Moment2": [moment2], "Beta1Pow": [beta1_pow],
                    "Beta2Pow": [beta2_pow],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param], "Moment1Out": [moment1],
                     "Moment2Out": [moment2], "Beta1PowOut": [beta1_pow],
                     "Beta2PowOut": [beta2_pow]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon, "lazy_mode": self._lazy_mode,
                   OP_ROLE_KEY: OpRole.Optimize},
        )

    # -- eager form --
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
        """One eager update from the parameters' ``.grad``."""
        if self._params is None:
            raise ValueError("AdamOptimizer needs parameter_list (pass it to "
                             "the constructor or minimize)")
        with torch.no_grad():
            optimizer_ops.adam(
                self._params, [p.grad for p in self._params], self._moment1,
                self._moment2, self._beta1_pow, self._beta2_pow,
                float(self._learning_rate), self._beta1, self._beta2,
                self._epsilon)

    def clear_grad(self):
        for p in self._params:
            p.grad = None

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, grad_clip=None):
        """A program variable ``loss``: the static form (see
        ``Optimizer.minimize``). A tensor ``loss``: backward, one update,
        then the grads are cleared (set to None); binds
        ``parameter_list`` on first use."""
        if isinstance(loss, Variable) or in_dygraph_mode():
            return super().minimize(loss, startup_program, parameter_list,
                                    no_grad_set, grad_clip)
        if self._params is None and parameter_list is not None:
            self._bind(parameter_list)
        loss.backward()
        self.step()
        self.clear_grad()


class RecomputeOptimizer(Optimizer):
    """Activation recompute around another optimizer
    (``optimizer.py:970``): its backward is ``append_backward`` with the
    checkpoints set by ``_set_checkpoints``, and the update is the
    wrapped optimizer's."""

    def __init__(self, optimizer):
        self._optimizer = optimizer
        self._checkpoints = None

    def _set_checkpoints(self, checkpoints):
        self._checkpoints = checkpoints

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        ckpts = [c.name if isinstance(c, Variable) else c
                 for c in (self._checkpoints or [])]
        return append_backward(loss, parameter_list, no_grad_set, callbacks,
                               checkpoints=ckpts)

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def apply_optimize(self, loss, startup_program, params_grads):
        return self._optimizer.apply_optimize(loss, startup_program,
                                              params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, grad_clip=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        optimize_ops = self.apply_optimize(loss, startup_program,
                                           params_grads)
        return optimize_ops, params_grads


class LarsMomentumOptimizer(MomentumOptimizer):
    """Momentum with LARS's layer-wise learning rate
    (``optimizer.py:364``): one ``lars_momentum`` op per parameter."""

    def __init__(self, learning_rate, momentum, lars_coeff=0.001,
                 lars_weight_decay=0.0005, **kwargs):
        super().__init__(learning_rate, momentum, **kwargs)
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        velocity = self._get_accumulator(self._velocity_acc_str, param)
        return block.append_op(
            type="lars_momentum",
            inputs={"Param": [param], "Grad": [grad], "Velocity": [velocity],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param], "VelocityOut": [velocity]},
            attrs={"mu": self._momentum, "lars_coeff": self._lars_coeff,
                   "lars_weight_decay": self._lars_weight_decay,
                   OP_ROLE_KEY: OpRole.Optimize},
        )


class AdamaxOptimizer(Optimizer):
    """Adamax (``optimizer.py:494``): ``moment`` and ``inf_norm``
    accumulators and a β₁-pow one advanced by a ``scale`` op after the
    updates."""

    _moment_acc_str = "moment"
    _inf_norm_acc_str = "inf_norm"
    _beta1_pow_acc_str = "beta1_pow_acc"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)
            self._add_accumulator(self._inf_norm_acc_str, p)
            self._add_accumulator(self._beta1_pow_acc_str, p,
                                  fill_value=self._beta1, shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        moment = self._get_accumulator(self._moment_acc_str, param)
        inf_norm = self._get_accumulator(self._inf_norm_acc_str, param)
        beta1_pow = self._get_accumulator(self._beta1_pow_acc_str, param)
        return block.append_op(
            type="adamax",
            inputs={"Param": [param], "Grad": [grad], "Moment": [moment],
                    "InfNorm": [inf_norm], "Beta1Pow": [beta1_pow],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param], "MomentOut": [moment],
                     "InfNormOut": [inf_norm]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon, OP_ROLE_KEY: OpRole.Optimize},
        )

    def _finish_update(self, block, parameters_and_grads):
        for param, grad in parameters_and_grads:
            if grad is None:
                continue
            beta1_pow = self._get_accumulator(self._beta1_pow_acc_str, param)
            block.append_op(
                type="scale", inputs={"X": [beta1_pow]},
                outputs={"Out": [beta1_pow]},
                attrs={"scale": self._beta1, OP_ROLE_KEY: OpRole.Optimize})


class DpsgdOptimizer(Optimizer):
    """Differentially private SGD (``optimizer.py:558``): one ``dpsgd``
    op per parameter; its noise comes from the run's generator (or the
    op's ``seed``). The constructor takes no other argument, as the
    reference's."""

    def __init__(self, learning_rate=0.001, clip=0.9, batch_size=0.999,
                 sigma=1e-8):
        super().__init__(learning_rate)
        self._clip = clip
        self._batch_size = batch_size
        self._sigma = sigma

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        return block.append_op(
            type="dpsgd",
            inputs={"Param": [param], "Grad": [grad],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param]},
            attrs={"clip": self._clip, "batch_size": self._batch_size,
                   "sigma": self._sigma, OP_ROLE_KEY: OpRole.Optimize},
        )


class DecayedAdagradOptimizer(Optimizer):
    """Adagrad with a decaying sum (``optimizer.py:584``)."""

    _moment_acc_str = "moment"

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._decay = decay
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        moment = self._get_accumulator(self._moment_acc_str, param)
        return block.append_op(
            type="decayed_adagrad",
            inputs={"Param": [param], "Grad": [grad], "Moment": [moment],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param], "MomentOut": [moment]},
            attrs={"decay": self._decay, "epsilon": self._epsilon,
                   OP_ROLE_KEY: OpRole.Optimize},
        )


class AdadeltaOptimizer(Optimizer):
    """Adadelta (``optimizer.py:616``); its op takes no learning rate."""

    _avg_squared_grad_acc_str = "_avg_squared_grad"
    _avg_squared_update_acc_str = "_avg_squared_update"

    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon = epsilon
        self._rho = rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._avg_squared_grad_acc_str, p)
            self._add_accumulator(self._avg_squared_update_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        avg_g = self._get_accumulator(self._avg_squared_grad_acc_str, param)
        avg_u = self._get_accumulator(self._avg_squared_update_acc_str,
                                      param)
        return block.append_op(
            type="adadelta",
            inputs={"Param": [param], "Grad": [grad],
                    "AvgSquaredGrad": [avg_g], "AvgSquaredUpdate": [avg_u]},
            outputs={"ParamOut": [param], "AvgSquaredGradOut": [avg_g],
                     "AvgSquaredUpdateOut": [avg_u]},
            attrs={"epsilon": self._epsilon, "rho": self._rho,
                   OP_ROLE_KEY: OpRole.Optimize},
        )


class RMSPropOptimizer(Optimizer):
    """RMSProp (``optimizer.py:655``), centered or not, with momentum."""

    _momentum_acc_str = "momentum"
    _mean_square_acc_str = "mean_square"
    _mean_grad_acc_str = "mean_grad"

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, **kw):
        super().__init__(learning_rate, **kw)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._momentum_acc_str, p)
            self._add_accumulator(self._mean_square_acc_str, p)
            self._add_accumulator(self._mean_grad_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        momentum = self._get_accumulator(self._momentum_acc_str, param)
        mean_square = self._get_accumulator(self._mean_square_acc_str, param)
        mean_grad = self._get_accumulator(self._mean_grad_acc_str, param)
        return block.append_op(
            type="rmsprop",
            inputs={"Param": [param], "Grad": [grad], "Moment": [momentum],
                    "MeanSquare": [mean_square], "MeanGrad": [mean_grad],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param], "MomentOut": [momentum],
                     "MeanSquareOut": [mean_square],
                     "MeanGradOut": [mean_grad]},
            attrs={"epsilon": self._epsilon, "decay": self._rho,
                   "momentum": self._momentum, "centered": self._centered,
                   OP_ROLE_KEY: OpRole.Optimize},
        )


class FtrlOptimizer(Optimizer):
    """FTRL-proximal (``optimizer.py:712``)."""

    _squared_acc_str = "squared"
    _linear_acc_str = "linear"

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kw):
        super().__init__(learning_rate, **kw)
        self._l1 = l1
        self._l2 = l2
        self._lr_power = lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._squared_acc_str, p)
            self._add_accumulator(self._linear_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        squared = self._get_accumulator(self._squared_acc_str, param)
        linear = self._get_accumulator(self._linear_acc_str, param)
        return block.append_op(
            type="ftrl",
            inputs={"Param": [param], "Grad": [grad],
                    "SquaredAccumulator": [squared],
                    "LinearAccumulator": [linear],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param], "SquaredAccumOut": [squared],
                     "LinearAccumOut": [linear]},
            attrs={"l1": self._l1, "l2": self._l2,
                   "lr_power": self._lr_power, OP_ROLE_KEY: OpRole.Optimize},
        )


class LambOptimizer(AdamOptimizer):
    """LAMB (``optimizer.py:754``; You et al., 2019): Adam's accumulators,
    one ``lamb`` op per parameter; ``exclude_from_weight_decay_fn(param)``
    true gives that parameter's op a weight decay of 0. Program and
    dygraph forms only (no eager tensor form)."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6,
                 exclude_from_weight_decay_fn=None, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, **kw)
        self._weight_decay = lamb_weight_decay
        self._exclude_from_weight_decay_fn = exclude_from_weight_decay_fn

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, grad_clip=None):
        return Optimizer.minimize(self, loss, startup_program,
                                  parameter_list, no_grad_set, grad_clip)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        wd = self._weight_decay
        if self._exclude_from_weight_decay_fn is not None and \
                self._exclude_from_weight_decay_fn(param):
            wd = 0.0
        moment1 = self._get_accumulator(self._moment1_acc_str, param)
        moment2 = self._get_accumulator(self._moment2_acc_str, param)
        beta1_pow = self._get_accumulator(self._beta1_pow_acc_str, param)
        beta2_pow = self._get_accumulator(self._beta2_pow_acc_str, param)
        return block.append_op(
            type="lamb",
            inputs={"Param": [param], "Grad": [grad], "Moment1": [moment1],
                    "Moment2": [moment2], "Beta1Pow": [beta1_pow],
                    "Beta2Pow": [beta2_pow],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param], "Moment1Out": [moment1],
                     "Moment2Out": [moment2], "Beta1PowOut": [beta1_pow],
                     "Beta2PowOut": [beta2_pow]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon, "weight_decay": wd,
                   OP_ROLE_KEY: OpRole.Optimize},
        )


class DGCMomentumOptimizer(MomentumOptimizer):
    """Deep Gradient Compression momentum (``optimizer.py:807``): one
    ``dgc_momentum`` op per parameter with U (momentum correction) and V
    (error accumulation) accumulators; in a program, a step counter
    (``CurrentStep``) selects plain momentum before
    ``rampup_begin_step``. The ``sparsity`` schedule is taken at its last
    value, as the reference does."""

    _u_acc_str = "dgc_u"
    _v_acc_str = "dgc_v"

    def __init__(self, learning_rate, momentum, rampup_begin_step=0,
                 rampup_step=1, sparsity=(0.999,), use_nesterov=False,
                 local_grad_clip_norm=None, num_trainers=None, **kw):
        super().__init__(learning_rate, momentum, use_nesterov, **kw)
        self._rampup_begin_step = rampup_begin_step
        self._rampup_step = rampup_step
        self._sparsity = list(sparsity)
        self._local_grad_clip_norm = local_grad_clip_norm
        self._num_trainers = num_trainers
        self._step_var = None

    def _create_accumulators(self, block, parameters):
        super()._create_accumulators(block, parameters)
        for p in parameters:
            self._add_accumulator(self._u_acc_str, p)
            self._add_accumulator(self._v_acc_str, p)
        if self._step_var is None and not in_dygraph_mode():
            self._step_var = self._add_accumulator(
                "dgc_step", parameters[0], dtype="float32", shape=(1,))

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        inputs = {
            "Param": [param], "Grad": [grad],
            "Velocity": [self._get_accumulator(self._velocity_acc_str,
                                               param)],
            "U": [self._get_accumulator(self._u_acc_str, param)],
            "V": [self._get_accumulator(self._v_acc_str, param)],
            "LearningRate": [self._create_param_lr(param_and_grad)],
        }
        if self._step_var is not None:
            inputs["CurrentStep"] = [self._step_var]
        return block.append_op(
            type="dgc_momentum",
            inputs=inputs,
            outputs={"ParamOut": [param],
                     "VelocityOut": inputs["Velocity"],
                     "UOut": inputs["U"], "VOut": inputs["V"]},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov,
                   "sparsity_ratio": float(self._sparsity[-1]),
                   "rampup_begin_step": float(self._rampup_begin_step),
                   "local_grad_clip_norm": self._local_grad_clip_norm,
                   OP_ROLE_KEY: OpRole.Optimize},
        )

    def _finish_update(self, block, parameters_and_grads):
        if self._step_var is not None:
            block.append_op(
                type="increment", inputs={"X": [self._step_var]},
                outputs={"Out": [self._step_var]},
                attrs={"step": 1.0, OP_ROLE_KEY: OpRole.Optimize})


class ModelAverage(Optimizer):
    """``optimizer.py:896``, as far as the reference goes: it takes the
    window settings, appends no update op of its own (``minimize`` raises
    as an ``Optimizer`` without ``_append_optimize_op`` does) and
    ``apply`` raises ``NotImplementedError``."""

    def __init__(self, average_window_rate, min_average_window=10000,
                 max_average_window=10000, **kwargs):
        super().__init__(0.0, **kwargs)
        self.average_window = average_window_rate
        self.min_average_window = min_average_window
        self.max_average_window = max_average_window

    def apply(self, executor, need_restore=True):
        raise NotImplementedError(
            "ModelAverage.apply requires the trainer loop integration")


class LookaheadOptimizer(object):
    """Lookahead (``optimizer.py:928``; Zhang et al., 2019): the inner
    optimizer's update, then a step counter and one
    ``lookahead_update`` op per trainable parameter against a slow copy
    created at zero."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        self.inner_optimizer = inner_optimizer
        self.alpha = alpha
        self.k = k

    def minimize(self, loss, startup_program=None):
        mini_out = self.inner_optimizer.minimize(
            loss, startup_program=startup_program)
        block = default_main_program().global_block()
        helper = LayerHelper("lookahead")
        with op_role_guard(OpRole.Optimize):
            step = block.create_var(
                name=unique_name.generate("lookahead_step"), shape=[1],
                dtype="int64", persistable=True)
            helper.set_variable_initializer(step, Constant(0.0))
            block.append_op(type="increment", inputs={"X": [step]},
                            outputs={"Out": [step]}, attrs={"step": 1.0})
            for param in block.all_parameters():
                if not param.trainable:
                    continue
                slow = block.create_var(
                    name=unique_name.generate(param.name + "_slow"),
                    shape=param.shape, dtype=param.dtype, persistable=True)
                helper.set_variable_initializer(slow, Constant(0.0))
                block.append_op(
                    type="lookahead_update",
                    inputs={"Param": [param], "SlowParam": [slow],
                            "Step": [step]},
                    outputs={"ParamOut": [param], "SlowParamOut": [slow]},
                    attrs={"alpha": self.alpha, "k": self.k})
        return mini_out


class ExponentialMovingAverage(object):
    """``optimizer.py:1012``: ``update()`` (after ``minimize``) appends,
    for each trainable parameter, ``shadow = decay·shadow +
    (1 − decay)·param`` as two ``scale`` ops and an ``elementwise_add``,
    and a step counter. ``apply(executor)`` is a context in which the
    global scope's parameters hold the bias-corrected shadows
    (shadow/(1 − decayˢᵗᵉᵖ), written into their tensors); ``restore``
    writes the training values back. Before any update step, ``apply``
    changes nothing."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = float(decay)
        self._name = name or ""
        self._shadows = {}
        self._step = None
        self._backup = {}

    def update(self):
        block = default_main_program().global_block()
        helper = LayerHelper(self._name or "ema")
        with op_role_guard(OpRole.Optimize):
            self._step = block.create_var(
                name=unique_name.generate("ema_step"), shape=[1],
                dtype="int64", persistable=True)
            self._step.stop_gradient = True
            helper.set_variable_initializer(self._step, Constant(0.0))
            block.append_op(type="increment", inputs={"X": [self._step]},
                            outputs={"Out": [self._step]},
                            attrs={"step": 1.0})
            for param in block.all_parameters():
                if not param.trainable:
                    continue
                shadow = block.create_var(
                    name=unique_name.generate(param.name + ".ema"),
                    shape=param.shape, dtype=param.dtype, persistable=True)
                shadow.stop_gradient = True
                helper.set_variable_initializer(shadow, Constant(0.0))
                tmp = helper.create_variable_for_type_inference(param.dtype)
                block.append_op(type="scale", inputs={"X": [shadow]},
                                outputs={"Out": [tmp]},
                                attrs={"scale": self._decay})
                tmp2 = helper.create_variable_for_type_inference(param.dtype)
                block.append_op(type="scale", inputs={"X": [param]},
                                outputs={"Out": [tmp2]},
                                attrs={"scale": 1.0 - self._decay})
                block.append_op(type="elementwise_add",
                                inputs={"X": [tmp], "Y": [tmp2]},
                                outputs={"Out": [shadow]})
                self._shadows[param.name] = shadow

    def apply(self, executor, need_restore=True):
        import contextlib

        @contextlib.contextmanager
        def _ctx():
            scope = core.global_scope()
            step = float(scope.get(self._step.name).reshape(-1)[0])
            if step < 1.0:
                yield
                return
            corr = 1.0 - self._decay ** step
            self._backup = {}
            with torch.no_grad():
                for pname, shadow in self._shadows.items():
                    param = scope.get(pname)
                    self._backup[pname] = param.clone()
                    param.copy_(scope.get(shadow.name) / corr)
            try:
                yield
            finally:
                if need_restore:
                    self.restore(executor)

        return _ctx()

    def restore(self, executor):
        scope = core.global_scope()
        with torch.no_grad():
            for pname, val in self._backup.items():
                scope.get(pname).copy_(val)
        self._backup = {}


class GradientMergeOptimizer(object):
    """Gradient merge over ``k_steps`` (``optimizer.py:1284``): each
    step adds the gradients into persistable buffers; every k-th step a
    ``Switch`` case applies the inner optimizer to their mean and zeroes
    them (the reference's ``PipelineOptimizer`` without cut points;
    ``avg=False`` raises as the reference's does)."""

    def __init__(self, inner_optimizer, k_steps=1, avg=True):
        self._inner = inner_optimizer
        self._k = max(int(k_steps), 1)
        self._avg = bool(avg)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        if not self._avg:
            raise NotImplementedError(
                "GradientMergeOptimizer(avg=False) (summed merged grads) is "
                "not supported: the in-graph merge averages; scale the "
                "learning rate by k_steps for equivalent SGD-family updates")
        from .layers import control_flow as _cf
        from .layers import tensor as _tensor

        k = self._k
        program = loss.block.program
        startup = startup_program or default_startup_program()
        with program_guard(program, startup):
            params_grads = self._inner.backward(
                loss, startup_program=startup_program,
                parameter_list=parameter_list, no_grad_set=no_grad_set)
            if k <= 1:
                return (self._inner.apply_optimize(loss, startup_program,
                                                   params_grads),
                        params_grads)
        block = program.global_block()
        helper = LayerHelper("pipeline")
        with program_guard(program, startup), op_role_guard(OpRole.Optimize):
            step = block.create_var(
                name=unique_name.generate("pipe_step"), shape=[1],
                dtype="int64", persistable=True)
            step.stop_gradient = True
            helper.set_variable_initializer(step, Constant(0.0))
            block.append_op(type="increment", inputs={"X": [step]},
                            outputs={"Out": [step]}, attrs={"step": 1.0})
            accums = []
            for p, g in params_grads:
                if g is None:
                    continue
                acc = block.create_var(
                    name=unique_name.generate(p.name + ".grad_merge"),
                    shape=p.shape, dtype=p.dtype, persistable=True)
                acc.stop_gradient = True
                helper.set_variable_initializer(acc, Constant(0.0))
                block.append_op(type="elementwise_add",
                                inputs={"X": [acc], "Y": [g]},
                                outputs={"Out": [acc]})
                accums.append((p, acc))
            kvar = _tensor.fill_constant(shape=[1], dtype="int64",
                                         value=float(k))
            rem = block.create_var(name=unique_name.generate("pipe_rem"),
                                   shape=[1], dtype="int64")
            block.append_op(type="elementwise_mod",
                            inputs={"X": [step], "Y": [kvar]},
                            outputs={"Out": [rem]})
            zero = _tensor.fill_constant(shape=[1], dtype="int64", value=0.0)
            boundary = _cf.equal(rem, zero)
            with _cf.Switch() as switch:
                with switch.case(boundary):
                    merged = []
                    for p, acc in accums:
                        avg = helper.create_variable_for_type_inference(
                            p.dtype)
                        program.current_block().append_op(
                            type="scale", inputs={"X": [acc]},
                            outputs={"Out": [avg]},
                            attrs={"scale": 1.0 / k})
                        merged.append((p, avg))
                    self._inner.apply_gradients(merged)
                    for _p, acc in accums:
                        program.current_block().append_op(
                            type="scale", inputs={"X": [acc]},
                            outputs={"Out": [acc]}, attrs={"scale": 0.0})
        return [], params_grads


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
Dpsgd = DpsgdOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
Lamb = LambOptimizer
