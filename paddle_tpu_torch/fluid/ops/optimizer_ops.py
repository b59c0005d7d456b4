"""Optimizer update ops (port of ``adam`` in
``paddle_tpu/fluid/ops/optimizer_ops.py``) as in-place updates of lists
of tensors.

The reference's update is one XLA-fused op, not a Pallas kernel; here it
is a handful of ``torch._foreach_*`` calls over every parameter at once,
which keeps the launches per step to a few dozen instead of several per
parameter.
"""

import torch

__all__ = ["adam"]


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
