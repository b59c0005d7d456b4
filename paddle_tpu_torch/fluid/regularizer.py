"""Weight-decay regularizers appended as grad ops (copy of
``paddle_tpu/fluid/regularizer.py``; reference:
python/paddle/fluid/regularizer.py). L2 decay lowers through ``scale``
and ``elementwise_add``; L1's ``sign`` op is not lowered in the port
yet."""

from .framework import OP_ROLE_KEY, OpRole, default_main_program
from .layer_helper import LayerHelper

__all__ = ["L1Decay", "L2Decay", "L1DecayRegularizer", "L2DecayRegularizer"]


class WeightDecayRegularizer(object):
    def __call__(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._regularization_coeff = regularization_coeff

    def __call__(self, param, grad, block):
        helper = LayerHelper("l2_decay")
        decay = helper.create_variable_for_type_inference(dtype=param.dtype)
        block.append_op(
            type="scale",
            inputs={"X": [param]},
            outputs={"Out": [decay]},
            attrs={
                "scale": self._regularization_coeff,
                OP_ROLE_KEY: OpRole.Backward,
            },
        )
        return decay


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._regularization_coeff = regularization_coeff

    def __call__(self, param, grad, block):
        helper = LayerHelper("l1_decay")
        sign = helper.create_variable_for_type_inference(dtype=param.dtype)
        decay = helper.create_variable_for_type_inference(dtype=param.dtype)
        block.append_op(
            type="sign",
            inputs={"X": [param]},
            outputs={"Out": [sign]},
            attrs={OP_ROLE_KEY: OpRole.Backward},
        )
        block.append_op(
            type="scale",
            inputs={"X": [sign]},
            outputs={"Out": [decay]},
            attrs={
                "scale": self._regularization_coeff,
                OP_ROLE_KEY: OpRole.Backward,
            },
        )
        return decay


def append_regularization_ops(parameters_and_grads, regularization=None):
    """reference: regularizer.py append_regularization_ops — grad = grad +
    regularizer(param); per-param regularizer overrides the global one."""
    params_and_grads = []
    helper = LayerHelper("regularization")
    for param, grad in parameters_and_grads:
        if grad is None:
            params_and_grads.append((param, grad))
            continue
        regularization_term = None
        # a dygraph VarBase has no block; the global block's append_op
        # traces the op there, so one code path serves both modes
        block = getattr(grad, "block", None) or \
            default_main_program().global_block()
        if getattr(param, "regularizer", None) is not None:
            regularization_term = param.regularizer(param, grad, block)
        elif regularization is not None:
            regularization_term = regularization(param, grad, block)
        if regularization_term is None:
            params_and_grads.append((param, grad))
            continue
        new_grad = helper.create_variable_for_type_inference(dtype=param.dtype)
        block.append_op(
            type="elementwise_add",
            inputs={"X": [grad], "Y": [regularization_term]},
            outputs={"Out": [new_grad]},
            attrs={OP_ROLE_KEY: OpRole.Backward},
        )
        params_and_grads.append((param, new_grad))
    return params_and_grads


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
