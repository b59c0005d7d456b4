"""Optimizer update ops (port of ``paddle_tpu/fluid/ops/optimizer_ops.py``
and of ``lookahead_update`` in ``paddle_tpu/fluid/optimizer.py``) as
in-place updates of tensors, and their registered op lowerings. Each op
updates its parameter (and accumulators) in the scope's tensors, which
its outputs name again.

The reference's update ops are XLA-fused, not Pallas kernels. The
eager Adam step runs a handful of ``torch._foreach_*`` calls over every
parameter at once (``adam``); the program runs one update op per
parameter, as the reference's program does (``adam_one``: 16
elementwise launches; ``lamb`` about twice that), each choosing its
branches with ``torch.where`` on the device.
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


# ---------------------------------------------------------------------------
# the other update ops of ``optimizer_ops.py``: each computes its new
# values from the fp32-rounded constants, as the reference's do, and
# writes them into its inputs' tensors, which its outputs name again
# ---------------------------------------------------------------------------
def _f32c(*vals):
    """Each value rounded to fp32, as a Python float."""
    return [_fp32(v) for v in vals]


def _one_minus(v):
    """1 − v in fp32 from fp32 v, as the reference's ``1 - b``."""
    return float(np.float32(1) - np.float32(v))


def _write(ctx, op_, pairs):
    """Copy each new value into its input's tensor and name it as the
    op's output: [(in slot, out slot, value)]."""
    for slot, out_slot, value in pairs:
        t = ctx.in1(op_, slot)
        t.copy_(value)
        ctx.out(op_, out_slot, t)


def _grad(ctx, op_, p):
    return ctx.in1(op_, "Grad").to(p.dtype)


def _norm(x):
    return torch.sqrt((x * x).sum())


@op("lars_momentum")
def _lars_momentum_op(ctx, op_):
    """``optimizer_ops.py:51``: momentum on a layer-wise learning rate
    lr·coeff·‖p‖/(‖g‖ + wd·‖p‖ + 1e-12) (lr where a norm is 0), chosen
    on the device:  v = µ·v + lr_l·(g + wd·p);  p −= v."""
    p = ctx.in1(op_, "Param")
    g = _grad(ctx, op_, p)
    v = ctx.in1(op_, "Velocity")
    mu, coeff, wd = _f32c(op_.attr("mu"), op_.attr("lars_coeff", 0.001),
                          op_.attr("lars_weight_decay", 0.0005))
    lr = _lr(ctx, op_, p)
    p_norm, g_norm = _norm(p), _norm(g)
    local_lr = torch.where((p_norm > 0) & (g_norm > 0),
                           lr * coeff * p_norm / (g_norm + wd * p_norm
                                                  + 1e-12), lr)
    v_new = mu * v + local_lr * (g + wd * p)
    _write(ctx, op_, [("Param", "ParamOut", p - v_new),
                      ("Velocity", "VelocityOut", v_new)])


@op("adamax")
def _adamax_op(ctx, op_):
    """``optimizer_ops.py:112``:  m = β₁·m + (1 − β₁)·g;
    u = max(β₂·u, |g| + ε);  p −= lr/(1 − β₁ᵖᵒʷ)·m/u. β₁ᵖᵒʷ is advanced
    by the optimizer's ``scale`` op, not here."""
    p = ctx.in1(op_, "Param")
    g = _grad(ctx, op_, p)
    m, inf = ctx.in1(op_, "Moment"), ctx.in1(op_, "InfNorm")
    b1p = ctx.in1(op_, "Beta1Pow").reshape(()).to(p.dtype)
    b1, b2, eps = _f32c(op_.attr("beta1", 0.9), op_.attr("beta2", 0.999),
                        op_.attr("epsilon", 1e-8))
    lr = _lr(ctx, op_, p)
    m_new = b1 * m + _one_minus(b1) * g
    inf_new = torch.maximum(b2 * inf, torch.abs(g) + eps)
    _write(ctx, op_, [("Param", "ParamOut",
                       p - (lr / (1 - b1p)) * (m_new / inf_new)),
                      ("Moment", "MomentOut", m_new),
                      ("InfNorm", "InfNormOut", inf_new)])


@op("decayed_adagrad")
def _decayed_adagrad_op(ctx, op_):
    """``optimizer_ops.py:154``:  m = d·m + (1 − d)·g²;
    p −= lr·g/(√m + ε)."""
    p = ctx.in1(op_, "Param")
    g = _grad(ctx, op_, p)
    m = ctx.in1(op_, "Moment")
    decay, eps = _f32c(op_.attr("decay", 0.95), op_.attr("epsilon", 1e-6))
    lr = _lr(ctx, op_, p)
    m_new = decay * m + _one_minus(decay) * g * g
    _write(ctx, op_, [("Param", "ParamOut",
                       p - lr * g / (torch.sqrt(m_new) + eps)),
                      ("Moment", "MomentOut", m_new)])


@op("rmsprop")
def _rmsprop_op(ctx, op_):
    """``optimizer_ops.py:172``:  ms = ρ·ms + (1 − ρ)·g²; with
    ``centered`` mg = ρ·mg + (1 − ρ)·g and the denominator
    √(ms − mg² + ε), else √(ms + ε);  mom = µ·mom + lr·g/denom;
    p −= mom."""
    p = ctx.in1(op_, "Param")
    g = _grad(ctx, op_, p)
    ms, mom = ctx.in1(op_, "MeanSquare"), ctx.in1(op_, "Moment")
    rho, eps, mu = _f32c(op_.attr("decay", 0.95), op_.attr("epsilon", 1e-6),
                         op_.attr("momentum", 0.0))
    lr = _lr(ctx, op_, p)
    ms_new = rho * ms + _one_minus(rho) * g * g
    writes = []
    if op_.attr("centered", False):
        mg_new = rho * ctx.in1(op_, "MeanGrad") + _one_minus(rho) * g
        denom = torch.sqrt(ms_new - mg_new * mg_new + eps)
        writes.append(("MeanGrad", "MeanGradOut", mg_new))
    else:
        denom = torch.sqrt(ms_new + eps)
        if ctx.in1(op_, "MeanGrad", optional=True) is not None:
            ctx.out(op_, "MeanGradOut", ctx.in1(op_, "MeanGrad"))
    mom_new = mu * mom + lr * g / denom
    _write(ctx, op_, writes + [("Param", "ParamOut", p - mom_new),
                               ("MeanSquare", "MeanSquareOut", ms_new),
                               ("Moment", "MomentOut", mom_new)])


@op("adadelta")
def _adadelta_op(ctx, op_):
    """``optimizer_ops.py:209``:  E[g²] = ρ·E[g²] + (1 − ρ)·g²;
    Δ = −√((E[Δ²] + ε)/(E[g²] + ε))·g;  E[Δ²] = ρ·E[Δ²] + (1 − ρ)·Δ²;
    p += Δ (no learning rate)."""
    p = ctx.in1(op_, "Param")
    g = _grad(ctx, op_, p)
    ag = ctx.in1(op_, "AvgSquaredGrad")
    au = ctx.in1(op_, "AvgSquaredUpdate")
    rho, eps = _f32c(op_.attr("rho", 0.95), op_.attr("epsilon", 1e-6))
    ag_new = rho * ag + _one_minus(rho) * g * g
    update = -torch.sqrt((au + eps) / (ag_new + eps)) * g
    au_new = rho * au + _one_minus(rho) * update * update
    _write(ctx, op_, [("Param", "ParamOut", p + update),
                      ("AvgSquaredGrad", "AvgSquaredGradOut", ag_new),
                      ("AvgSquaredUpdate", "AvgSquaredUpdateOut", au_new)])


@op("ftrl")
def _ftrl_op(ctx, op_):
    """``optimizer_ops.py:234``: FTRL-proximal with the squared and
    linear accumulators; p = (l1·sign(lin) − lin)/(n^−power/lr + 2·l2)
    where |lin| > l1, else 0."""
    p = ctx.in1(op_, "Param")
    g = _grad(ctx, op_, p)
    sq = ctx.in1(op_, "SquaredAccumulator")
    lin = ctx.in1(op_, "LinearAccumulator")
    l1, l2, power = _f32c(op_.attr("l1", 0.0), op_.attr("l2", 0.0),
                          op_.attr("lr_power", -0.5))
    lr = _lr(ctx, op_, p)
    new_sq = sq + g * g
    sigma = (torch.pow(new_sq, -power) - torch.pow(sq, -power)) / lr
    new_lin = lin + g - sigma * p
    x = l1 * torch.sign(new_lin) - new_lin
    y = torch.pow(new_sq, -power) / lr + 2 * l2
    p_new = torch.where(torch.abs(new_lin) > l1, x / y, torch.zeros_like(p))
    _write(ctx, op_, [("Param", "ParamOut", p_new),
                      ("SquaredAccumulator", "SquaredAccumOut", new_sq),
                      ("LinearAccumulator", "LinearAccumOut", new_lin)])


@op("lamb")
def _lamb_op(ctx, op_):
    """``optimizer_ops.py:264`` (You et al., 2019):

        m1 = β₁·m1 + (1 − β₁)·g;   m2 = β₂·m2 + (1 − β₂)·g²
        r = (m1/(1 − β₁ᵖᵒʷ))/(√(m2/(1 − β₂ᵖᵒʷ)) + ε) + wd·p
        p −= lr·(‖p‖/‖r‖)·r        (trust ratio 1 where a norm is 0)
        β₁ᵖᵒʷ *= β₁;  β₂ᵖᵒʷ *= β₂

    The trust ratio is chosen with ``torch.where`` on the device: the
    step reads nothing back."""
    p = ctx.in1(op_, "Param")
    g = _grad(ctx, op_, p)
    m1, m2 = ctx.in1(op_, "Moment1"), ctx.in1(op_, "Moment2")
    b1p, b2p = ctx.in1(op_, "Beta1Pow"), ctx.in1(op_, "Beta2Pow")
    b1, b2, eps, wd = _f32c(op_.attr("beta1", 0.9), op_.attr("beta2", 0.999),
                            op_.attr("epsilon", 1e-6),
                            op_.attr("weight_decay", 0.01))
    lr = _lr(ctx, op_, p)
    m1n = b1 * m1 + _one_minus(b1) * g
    m2n = b2 * m2 + _one_minus(b2) * g * g
    m1h = m1n / (1 - b1p.reshape(()).to(p.dtype))
    m2h = m2n / (1 - b2p.reshape(()).to(p.dtype))
    r = m1h / (torch.sqrt(m2h) + eps) + wd * p
    p_norm, r_norm = _norm(p), _norm(r)
    trust = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm,
                        torch.ones_like(p_norm))
    _write(ctx, op_, [("Param", "ParamOut", p - lr * trust * r),
                      ("Moment1", "Moment1Out", m1n),
                      ("Moment2", "Moment2Out", m2n),
                      ("Beta1Pow", "Beta1PowOut", b1p * b1),
                      ("Beta2Pow", "Beta2PowOut", b2p * b2)])


@op("dpsgd")
def _dpsgd_op(ctx, op_):
    """``optimizer_ops.py:303``: differentially private SGD: g clipped
    to norm ``clip``, plus N(0, σ·clip) noise from the op's generator,
    over ``batch_size``;  p −= lr·that. At σ = 0 the update is exact."""
    p = ctx.in1(op_, "Param")
    g = _grad(ctx, op_, p)
    clip, batch, sigma = _f32c(op_.attr("clip", 10.0),
                               op_.attr("batch_size", 16.0),
                               op_.attr("sigma", 1.0))
    lr = _lr(ctx, op_, p)
    scale = torch.clamp(clip / torch.clamp(_norm(g), min=1e-12), max=1.0)
    noise = torch.empty_like(g).normal_(generator=ctx.generator(op_))
    g_priv = (g * scale + noise * sigma * clip) / batch
    _write(ctx, op_, [("Param", "ParamOut", p - lr * g_priv)])


@op("dgc_momentum")
def _dgc_momentum_op(ctx, op_):
    """``optimizer_ops.py:324``: Deep Gradient Compression momentum.

    Warm-up branch: momentum on the gradient summed over the ring.
    DGC branch: u = µ·u + g (momentum correction), v += u (error
    accumulation); the entries of v at or above its top-k magnitude
    (k = numel·(1 − ``sparsity_ratio``), at least 1) are sent, summed
    over the ring, and applied, p −= lr·sent, and u and v are reset
    there (momentum factor masking). Both branches are computed and the
    one ``CurrentStep`` selects (before ``rampup_begin_step``: warm-up)
    is chosen with ``torch.where`` on the device. The ring is ring 0's
    ``torch.distributed`` group when the process is in a world (where
    the reference sums over ``ctx.data_axis`` with ``lax.psum``); the
    collective transpiler leaves DGC gradients out of its dense
    all-reduce."""
    from .collective_ops import _sum, group_for

    p = ctx.in1(op_, "Param")
    g = ctx.in1(op_, "Grad").to(p.dtype)
    vel, u, v = (ctx.in1(op_, s) for s in ("Velocity", "U", "V"))
    lr = _lr(ctx, op_, p)
    step = ctx.in1(op_, "CurrentStep", optional=True)
    mu = _fp32(op_.attr("mu"))
    ratio = float(op_.attr("sparsity_ratio", 0.999))
    rampup_begin = float(op_.attr("rampup_begin_step", 0.0))
    clip_norm = op_.attr("local_grad_clip_norm", None)
    if clip_norm:
        g = g * torch.clamp(float(clip_norm) / (_norm(g) + 1e-10), max=1.0)
    group = group_for(ctx)
    g_sync = _sum(g, group) if group is not None else g
    vel_new = mu * vel + g_sync
    if op_.attr("use_nesterov", False):
        p_warm = p - lr * (g_sync + mu * vel_new)
    else:
        p_warm = p - lr * vel_new
    u_new = mu * u + g
    v_new = v + u_new
    k = max(1, int(round(v_new.numel() * (1.0 - ratio))))
    thr = torch.topk(torch.abs(v_new).reshape(-1), k).values[-1]
    mask = torch.abs(v_new) >= thr
    zeros = torch.zeros_like(v_new)
    sparse = torch.where(mask, v_new, zeros)
    u_dgc = torch.where(mask, zeros, u_new)
    v_dgc = torch.where(mask, zeros, v_new)
    if group is not None:
        sparse = _sum(sparse, group)
    p_dgc = p - lr * sparse
    if step is not None and rampup_begin > 0:
        warm = step.reshape(()) < rampup_begin
        writes = [("Param", "ParamOut", torch.where(warm, p_warm, p_dgc)),
                  ("Velocity", "VelocityOut", torch.where(warm, vel_new,
                                                          vel)),
                  ("U", "UOut", torch.where(warm, u, u_dgc)),
                  ("V", "VOut", torch.where(warm, v, v_dgc))]
    else:
        ctx.out(op_, "VelocityOut", vel)
        writes = [("Param", "ParamOut", p_dgc), ("U", "UOut", u_dgc),
                  ("V", "VOut", v_dgc)]
    _write(ctx, op_, writes)


@op("lookahead_update")
def _lookahead_update_op(ctx, op_):
    """The ``lookahead_update`` op (reference ``fluid/optimizer.py:1255``;
    Zhang et al., 2019): every ``k``-th ``Step`` the slow weights move
    ``alpha`` of the way to the fast ones and the fast ones take them;
    chosen on the device."""
    p = ctx.in1(op_, "Param")
    slow = ctx.in1(op_, "SlowParam")
    step = ctx.in1(op_, "Step").reshape(())
    alpha = _fp32(op_.attr("alpha", 0.5))
    sync = (step % int(op_.attr("k", 5))) == 0
    new_slow = torch.where(sync, alpha * p + _one_minus(alpha) * slow, slow)
    new_p = torch.where(sync, new_slow, p)
    _write(ctx, op_, [("Param", "ParamOut", new_p),
                      ("SlowParam", "SlowParamOut", new_slow)])
