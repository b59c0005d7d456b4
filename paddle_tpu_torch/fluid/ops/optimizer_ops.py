"""Optimizer update ops (port of ``sgd``, ``momentum``, ``adagrad`` and
``adam`` in ``paddle_tpu/fluid/ops/optimizer_ops.py``) as in-place updates of
tensors, and their registered op lowerings. Each op updates its
parameter (and accumulators) in the scope's tensors, which its outputs
name again.

The reference's update ops are XLA-fused, not Pallas kernels. The
eager Adam step runs a handful of ``torch._foreach_*`` calls over every
parameter at once (``adam``); the program runs one ``adam`` op per
parameter, as the reference's program does (``adam_one``), each 16
elementwise launches.
"""

import functools

import numpy as np
import torch

from .registry import op

__all__ = ["sgd", "momentum", "adagrad", "adam", "adam_one"]


def _fp32(x):
    """``x`` rounded to fp32, as a Python float."""
    return float(np.float32(x))


def sgd(param, grad, learning_rate):
    """The ``sgd`` op (``optimizer_ops.py:25``) in place:
    p −= lr·g, ``learning_rate`` a tensor [1] (or scalar) on the
    parameter's device."""
    param.sub_(learning_rate * grad)


def momentum(param, grad, velocity, learning_rate, mu, use_nesterov=False):
    """The ``momentum`` op (``optimizer_ops.py:33``) in place:

        v = µ·v + g
        p −= lr·v                 (plain)
        p −= (g + µ·v)·lr         (Nesterov)

    µ rounded to fp32 as the reference's constant is."""
    mu = _fp32(mu)
    velocity.mul_(mu).add_(grad)
    if use_nesterov:
        param.sub_((grad + mu * velocity) * learning_rate)
    else:
        param.sub_(learning_rate * velocity)


def adagrad(param, grad, moment, learning_rate, epsilon=1e-6):
    """The ``adagrad`` op (``optimizer_ops.py:140``) in place:

        m += g²
        p −= lr·g / (√m + ε)

    ε rounded to fp32 as the reference's constant is."""
    moment.addcmul_(grad, grad)
    param.sub_(learning_rate * grad / (moment.sqrt() + _fp32(epsilon)))


def _lr(ctx, op_, p):
    """The op's LearningRate [1] as a scalar tensor in ``p``'s type."""
    return ctx.in1(op_, "LearningRate").reshape(()).to(p.dtype)


@op("sgd")
def _sgd_op(ctx, op_):
    p = ctx.in1(op_, "Param")
    sgd(p, ctx.in1(op_, "Grad").to(p.dtype), _lr(ctx, op_, p))
    ctx.out(op_, "ParamOut", p)


@op("momentum")
def _momentum_op(ctx, op_):
    p = ctx.in1(op_, "Param")
    v = ctx.in1(op_, "Velocity")
    momentum(p, ctx.in1(op_, "Grad").to(p.dtype), v, _lr(ctx, op_, p),
             float(op_.attr("mu")), bool(op_.attr("use_nesterov", False)))
    ctx.out(op_, "ParamOut", p)
    ctx.out(op_, "VelocityOut", v)


@op("adagrad")
def _adagrad_op(ctx, op_):
    p = ctx.in1(op_, "Param")
    m = ctx.in1(op_, "Moment")
    adagrad(p, ctx.in1(op_, "Grad").to(p.dtype), m, _lr(ctx, op_, p),
            float(op_.attr("epsilon", 1e-6)))
    ctx.out(op_, "ParamOut", p)
    ctx.out(op_, "MomentOut", m)


def adam(params, grads, moment1, moment2, beta1_pow, beta2_pow,
         learning_rate, beta1=0.9, beta2=0.999, epsilon=1e-8):
    """The ``adam`` op (``optimizer_ops.py:87``) on lists, in place:

        m1 = β₁·m1 + (1 − β₁)·g
        m2 = β₂·m2 + (1 − β₂)·g²
        lr_t = lr·√(1 − β₂ᵖᵒʷ)/(1 − β₁ᵖᵒʷ)
        p -= lr_t·m1/(√m2 + ε)
        β₁ᵖᵒʷ *= β₁;  β₂ᵖᵒʷ *= β₂

    ε is not bias-corrected, unlike ``torch.optim.Adam``. ``params``,
    ``grads``, ``moment1`` and ``moment2`` are lists of tensors on one
    device (a grad of None counts as zeros); ``beta1_pow`` / ``beta2_pow``
    are fp32 CPU tensors [len(params)], one accumulator per parameter as
    the reference keeps them, updated in place. ``lr_t`` is computed on
    the host in fp32 from them, so the step needs no device read. The
    constants are rounded to fp32 as the reference's are."""
    f32 = torch.float32
    b1 = torch.tensor(beta1, dtype=f32)
    b2 = torch.tensor(beta2, dtype=f32)
    one = torch.tensor(1.0, dtype=f32)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    lr_t = torch.tensor(learning_rate, dtype=f32) * torch.sqrt(
        one - beta2_pow) / (one - beta1_pow)
    torch._foreach_mul_(moment1, float(b1))
    torch._foreach_add_(moment1, grads, alpha=float(one - b1))
    torch._foreach_mul_(moment2, float(b2))
    torch._foreach_addcmul_(moment2, grads, grads, value=float(one - b2))
    denom = torch._foreach_sqrt(moment2)
    torch._foreach_add_(denom, float(torch.tensor(epsilon, dtype=f32)))
    torch._foreach_addcdiv_(params, moment1, denom,
                            [-float(x) for x in lr_t.tolist()])
    beta1_pow.mul_(b1)
    beta2_pow.mul_(b2)


@functools.lru_cache(maxsize=None)
def _fp32_constants(beta1, beta2, epsilon):
    """(β₁, 1 − β₁, β₂, 1 − β₂, ε) rounded to fp32, as Python floats."""
    f32 = np.float32
    return (float(f32(beta1)), float(f32(1) - f32(beta1)), float(f32(beta2)),
            float(f32(1) - f32(beta2)), float(f32(epsilon)))


def adam_one(param, grad, moment1, moment2, beta1_pow, beta2_pow,
             learning_rate, beta1=0.9, beta2=0.999, epsilon=1e-8):
    """``adam`` on one parameter whose state lives on its device, as the
    program's scope holds it: ``beta1_pow`` / ``beta2_pow`` [1] and
    ``learning_rate`` are tensors there, so ``lr_t`` stays a device tensor
    and the update reads nothing back. Same rule and fp32 constants as
    ``adam``; plain tensor methods, since a one-element ``_foreach`` call
    costs the host more for the same launches."""
    b1, one_b1, b2, one_b2, eps = _fp32_constants(beta1, beta2, epsilon)
    moment1.mul_(b1).add_(grad, alpha=one_b1)
    moment2.mul_(b2).addcmul_(grad, grad, value=one_b2)
    denom = moment2.sqrt().add_(eps)
    lr_t = learning_rate * torch.sqrt(1.0 - beta2_pow) / (1.0 - beta1_pow)
    param.sub_(lr_t * moment1 / denom)
    beta1_pow.mul_(b1)
    beta2_pow.mul_(b2)


@op("adam")
def _adam_op(ctx, op_):
    """The ``adam`` op on one parameter (``optimizer_ops.py:87``): the
    parameter, its moments and β-pow accumulators are updated in place in
    the scope's tensors, which the outputs name again."""
    p = ctx.in1(op_, "Param")
    m1, m2 = ctx.in1(op_, "Moment1"), ctx.in1(op_, "Moment2")
    b1p, b2p = ctx.in1(op_, "Beta1Pow"), ctx.in1(op_, "Beta2Pow")
    adam_one(p, ctx.in1(op_, "Grad").to(p.dtype), m1, m2, b1p, b2p,
             _lr(ctx, op_, p),
             float(op_.attr("beta1", 0.9)), float(op_.attr("beta2", 0.999)),
             float(op_.attr("epsilon", 1e-8)))
    for slot, t in (("ParamOut", p), ("Moment1Out", m1), ("Moment2Out", m2),
                    ("Beta1PowOut", b1p), ("Beta2PowOut", b2p)):
        ctx.out(op_, slot, t)
