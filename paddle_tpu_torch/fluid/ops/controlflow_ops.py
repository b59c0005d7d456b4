"""Comparison, logical and ``where`` ops (port of the matching lowerings
in ``paddle_tpu/fluid/ops/controlflow_ops.py``): the ops the dynamic loss
scaler of AMP builds its in-graph update from. Compares and logicals
give bool tensors and no gradient; ``where`` is differentiable in X and
Y. The sub-block ops (``while``, ``conditional_block``) are not ported:
the Executor runs only the global block."""

import torch

from .registry import SkipInferShape, in_var, op, register_op, set_out

__all__ = []


def _cmp_infer(op_, block):
    v = in_var(op_, block, "X")
    if v is None:
        raise SkipInferShape()
    set_out(op_, block, "Out", v.shape, 0)  # BOOL


def _register_compare(name, fn):
    def lower(ctx, op_, _fn=fn):
        ctx.out(op_, "Out", _fn(ctx.in1(op_, "X"), ctx.in1(op_, "Y")))

    register_op(name, infer_shape=_cmp_infer, lower=lower)


_register_compare("equal", torch.eq)
_register_compare("not_equal", torch.ne)
_register_compare("less_than", torch.lt)
_register_compare("less_equal", torch.le)
_register_compare("greater_than", torch.gt)
_register_compare("greater_equal", torch.ge)


def _register_logical(name, fn, unary=False):
    def lower(ctx, op_, _fn=fn, _unary=unary):
        x = ctx.in1(op_, "X")
        ctx.out(op_, "Out", _fn(x) if _unary else _fn(x, ctx.in1(op_, "Y")))

    register_op(name, infer_shape=_cmp_infer, lower=lower)


_register_logical("logical_and", torch.logical_and)
_register_logical("logical_or", torch.logical_or)
_register_logical("logical_xor", torch.logical_xor)
_register_logical("logical_not", torch.logical_not, unary=True)


@op("where", grad="generic")
def _where(ctx, op_):
    ctx.out(op_, "Out", torch.where(ctx.in1(op_, "Condition"),
                                    ctx.in1(op_, "X"), ctx.in1(op_, "Y")))
