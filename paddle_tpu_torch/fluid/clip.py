"""Gradient clipping (copy of ``paddle_tpu/fluid/clip.py``; reference:
python/paddle/fluid/clip.py — ErrorClipByValue, GradientClipByValue,
GradientClipByNorm, GradientClipByGlobalNorm; set via
fluid.clip.set_gradient_clip or per-param). ``Optimizer.minimize`` calls
``append_gradient_clip_ops``; the clip ops themselves (``clip``,
``clip_by_norm``, ``squared_l2_norm``, ``sqrt``, ``elementwise_max``) are
not lowered in the port yet, so a program that sets a clip fails at run
time with the op named."""

from .framework import OP_ROLE_KEY, OpRole, default_main_program
from .layer_helper import LayerHelper

__all__ = [
    "ErrorClipByValue",
    "GradientClipByValue",
    "GradientClipByNorm",
    "GradientClipByGlobalNorm",
    "set_gradient_clip",
]


class BaseErrorClipAttr(object):
    def _append_clip_op(self, block, grad_name):
        raise NotImplementedError


class ErrorClipByValue(BaseErrorClipAttr):
    def __init__(self, max, min=None):
        max = float(max)
        self.max = max
        self.min = float(min) if min is not None else -max

    def _append_clip_op(self, block, grad_name):
        block.append_op(
            type="clip",
            inputs={"X": [grad_name]},
            outputs={"Out": [grad_name]},
            attrs={"min": self.min, "max": self.max, OP_ROLE_KEY: OpRole.Backward},
        )


class BaseGradientClipAttr(object):
    def _process_context(self, context, param, grad):
        pass

    def _create_operators(self, param, grad):
        raise NotImplementedError


class NullGradientClipAttr(BaseGradientClipAttr):
    def _create_operators(self, param, grad):
        return param, grad


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        max = float(max)
        self.max = max
        self.min = float(min) if min is not None else -max

    def _create_operators(self, param, grad):
        helper = LayerHelper("clip_by_value")
        out = helper.create_variable_for_type_inference(dtype=grad.dtype)
        _grad_block(grad).append_op(
            type="clip",
            inputs={"X": [grad]},
            outputs={"Out": [out]},
            attrs={"min": self.min, "max": self.max, OP_ROLE_KEY: OpRole.Backward},
        )
        return param, out


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _create_operators(self, param, grad):
        helper = LayerHelper("clip_by_norm")
        out = helper.create_variable_for_type_inference(dtype=grad.dtype)
        _grad_block(grad).append_op(
            type="clip_by_norm",
            inputs={"X": [grad]},
            outputs={"Out": [out]},
            attrs={"max_norm": self.clip_norm, OP_ROLE_KEY: OpRole.Backward},
        )
        return param, out


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """scale = clip_norm / max(global_norm, clip_norm); one global norm over
    all grads (reference: clip.py GradientClipByGlobalNorm)."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name
        self._norms = []
        self._pairs = []

    def _process_context(self, context, param, grad):
        helper = LayerHelper("global_norm")
        sq = helper.create_variable_for_type_inference(dtype=grad.dtype)
        _grad_block(grad).append_op(
            type="squared_l2_norm",
            inputs={"X": [grad]},
            outputs={"Out": [sq]},
            attrs={OP_ROLE_KEY: OpRole.Backward},
        )
        self._norms.append(sq)
        self._pairs.append((param, grad))

    def _create_scale_var(self):
        from .layers import nn as lnn
        from .layers import tensor as ltensor

        helper = LayerHelper("global_norm_scale")
        total = helper.create_variable_for_type_inference(dtype="float32")
        helper.append_op(
            type="sum",
            inputs={"X": self._norms},
            outputs={"Out": [total]},
            attrs={OP_ROLE_KEY: OpRole.Backward},
        )
        global_norm = helper.create_variable_for_type_inference("float32")
        helper.append_op(type="sqrt", inputs={"X": [total]},
                         outputs={"Out": [global_norm]})
        clip_var = ltensor.fill_constant([1], "float32", self.clip_norm)
        denom = helper.create_variable_for_type_inference("float32")
        helper.append_op(type="elementwise_max",
                         inputs={"X": [global_norm], "Y": [clip_var]},
                         outputs={"Out": [denom]}, attrs={"axis": -1})
        return lnn.elementwise_div(clip_var, denom)

    def _create_operators(self, param, grad):
        if not hasattr(self, "_scale_var") or self._scale_var is None:
            self._scale_var = self._create_scale_var()
        helper = LayerHelper("clip_scale")
        out = helper.create_variable_for_type_inference(dtype=grad.dtype)
        _grad_block(grad).append_op(
            type="elementwise_mul",
            inputs={"X": [grad], "Y": [self._scale_var]},
            outputs={"Out": [out]},
            attrs={OP_ROLE_KEY: OpRole.Backward},
        )
        return param, out


def _grad_block(grad):
    """The block a clip op on ``grad`` goes to: the grad's own, or for a
    dygraph ``VarBase`` (which has none) the global block, whose
    ``append_op`` traces the op at once."""
    return getattr(grad, "block", None) or \
        default_main_program().global_block()


_gradient_clip_attr = None


def set_gradient_clip(clip, param_list=None, program=None):
    global _gradient_clip_attr
    _gradient_clip_attr = clip
    if param_list is not None:
        program = program or default_main_program()
        for p in param_list:
            if isinstance(p, str):
                p = program.global_block().var(p)
            p.gradient_clip_attr = clip


def append_clip_with(params_grads, clip):
    res = []
    for p, g in params_grads:
        if g is not None:
            clip._process_context(None, p, g)
    for p, g in params_grads:
        if g is None:
            res.append((p, g))
        else:
            res.append(clip._create_operators(p, g))
    return res


def append_gradient_clip_ops(params_grads):
    clip = _gradient_clip_attr
    per_param = any(
        getattr(p, "gradient_clip_attr", None) is not None for p, _ in params_grads
    )
    if clip is None and not per_param:
        return params_grads
    res = []
    if clip is not None:
        for p, g in params_grads:
            if g is not None:
                clip._process_context(None, p, g)
    for p, g in params_grads:
        c = getattr(p, "gradient_clip_attr", None) or clip
        if g is None or c is None:
            res.append((p, g))
        else:
            res.append(c._create_operators(p, g))
    return res


def error_clip_callback(block, context):
    pass
