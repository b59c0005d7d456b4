"""Loss ops (port of ``paddle_tpu/fluid/ops/loss_ops.py``): the ranking,
margin, focal, CTR and CTC losses, the hierarchical sigmoid and
noise-contrastive estimation, each a registered lowering on tensors with
the generic gradient (the vjp of its forward). ``center_loss`` updates
its centers in place when asked; ``nce`` draws its negatives from the
op's generator (its ``seed`` attr, else the run's)."""

import numpy as np
import torch
import torch.nn.functional as F

from .registry import SkipInferShape, in_var, op, set_out
from .sequence_ops import SEQ_LEN, companion

__all__ = ["ctc_loss", "nce"]


def _softplus(x):
    """log(1 + eˣ) as ``jnp.logaddexp(0, x)``: no threshold cut."""
    return torch.logaddexp(torch.zeros_like(x), x)


@op("kldiv_loss", grad="generic")
def _kldiv_loss(ctx, op_):
    """``loss_ops.py:20``: target·(log target − X) where target > 0,
    reduced by ``reduction`` (mean, sum, batchmean or none)."""
    x = ctx.in1(op_, "X")
    target = ctx.in1(op_, "Target")
    reduction = op_.attr("reduction", "mean")
    loss = torch.where(target > 0,
                       target * (torch.log(target.clamp_min(1e-30)) - x),
                       torch.zeros_like(target))
    if reduction == "mean":
        loss = loss.mean()
    elif reduction == "sum":
        loss = loss.sum()
    elif reduction == "batchmean":
        loss = loss.sum() / x.shape[0]
    ctx.out(op_, "Loss", loss)


@op("log_loss", grad="generic")
def _log_loss(ctx, op_):
    """``loss_ops.py:40``: −y·log(p + ε) − (1 − y)·log(1 − p + ε)."""
    p = ctx.in1(op_, "Predicted")
    y = ctx.in1(op_, "Labels")
    eps = float(op_.attr("epsilon", 1e-4))
    ctx.out(op_, "Loss", -y * torch.log(p + eps)
            - (1.0 - y) * torch.log(1.0 - p + eps))


@op("hinge_loss", grad="generic")
def _hinge_loss(ctx, op_):
    """``loss_ops.py:53``: max(1 − (2y − 1)·logit, 0)."""
    logits = ctx.in1(op_, "Logits")
    labels = ctx.in1(op_, "Labels")
    ctx.out(op_, "Loss", torch.clamp_min(
        1.0 - (2.0 * labels - 1.0) * logits, 0.0))


@op("bpr_loss", grad="generic")
def _bpr_loss(ctx, op_):
    """``loss_ops.py:65``: −Σ_{j≠y} log σ(x_y − x_j) / (C − 1) a row."""
    x = ctx.in1(op_, "X")
    y = ctx.in1(op_, "Label").reshape(-1, 1).long()
    C = x.shape[1]
    diff = x.gather(1, y) - x
    mask = torch.arange(C, device=x.device)[None, :] != y
    loss = torch.where(mask, _softplus(-diff), torch.zeros_like(diff)).sum(
        1) / (C - 1)
    ctx.out(op_, "Y", loss[:, None])


@op("rank_loss", grad="generic")
def _rank_loss(ctx, op_):
    """``loss_ops.py:82``: log(1 + e^o) − label·o, o = left − right."""
    label = ctx.in1(op_, "Label")
    o = ctx.in1(op_, "Left") - ctx.in1(op_, "Right")
    ctx.out(op_, "Out", _softplus(o) - label * o)


@op("margin_rank_loss", grad="generic")
def _margin_rank_loss(ctx, op_):
    """``loss_ops.py:93``: max(−label·(x1 − x2) + margin, 0), and where
    that is positive (Activated, in x1's type)."""
    label = ctx.in1(op_, "Label")
    x1 = ctx.in1(op_, "X1")
    act = -label * (x1 - ctx.in1(op_, "X2")) + float(op_.attr("margin", 0.0))
    ctx.out(op_, "Out", torch.clamp_min(act, 0.0))
    ctx.out(op_, "Activated", (act > 0).to(x1.dtype))


@op("center_loss", grad="generic")
def _center_loss(ctx, op_):
    """``loss_ops.py:107``: SampleCenterDiff = X − centers[label], Loss
    = ½‖diff‖² a row. With ``need_update`` and a CenterUpdateRate, each
    center moves by rate·Σ(its rows' diff)/(1 + its row count):
    CentersOut, in place when it names Centers."""
    x = ctx.in1(op_, "X")
    y = ctx.in1(op_, "Label").reshape(-1).long()
    centers = ctx.in1(op_, "Centers")
    rate = ctx.in1(op_, "CenterUpdateRate", optional=True)
    diff = x - centers[y]
    ctx.out(op_, "SampleCenterDiff", diff)
    ctx.out(op_, "Loss", 0.5 * (diff * diff).sum(1, keepdim=True))
    new = centers
    if bool(op_.attr("need_update", False)) and rate is not None:
        with torch.no_grad():
            counts = x.new_zeros(centers.shape[0]).index_add(
                0, y, torch.ones_like(y, dtype=x.dtype))
            sums = torch.zeros_like(centers).index_add(0, y, diff)
            new = centers - rate.reshape(()) * (sums / (1.0 + counts[:, None]))
    ctx.write_state(op_, "Centers", "CentersOut", new)


@op("sigmoid_focal_loss", grad="generic")
def _sigmoid_focal_loss(ctx, op_):
    """``loss_ops.py:133``: per class c (label c + 1; 0 the background)
    α(1 − p)^γ·(−log p) for the label's class, (1 − α)p^γ·(−log(1 − p))
    for the others, p = σ(x), over max(FgNum, 1)."""
    x = ctx.in1(op_, "X")
    y = ctx.in1(op_, "Label").reshape(-1, 1).long()
    fg = ctx.in1(op_, "FgNum")
    gamma = float(op_.attr("gamma", 2.0))
    alpha = float(op_.attr("alpha", 0.25))
    fgn = fg.to(x.dtype).reshape(()).clamp_min(1.0)
    t = (y == torch.arange(x.shape[1], device=x.device)[None, :] + 1).to(
        x.dtype)
    p = 1.0 / (1.0 + torch.exp(-x))
    ce_pos = -torch.log(p.clamp_min(1e-30))
    ce_neg = -torch.log((1.0 - p).clamp_min(1e-30))
    loss = t * alpha * (1.0 - p).pow(gamma) * ce_pos + \
        (1.0 - t) * (1.0 - alpha) * p.pow(gamma) * ce_neg
    ctx.out(op_, "Out", loss / fgn)


@op("cross_entropy2", grad="generic")
def _cross_entropy2(ctx, op_):
    """``loss_ops.py:156``: −log of X's probability at the label
    (floored at 1e-30), MatchX that probability, XShape empty."""
    x = ctx.in1(op_, "X")
    y = ctx.in1(op_, "Label").reshape(-1, 1).long()
    matched = x.gather(1, y)
    ctx.out(op_, "Y", -torch.log(matched.clamp_min(1e-30)))
    ctx.out(op_, "MatchX", matched)
    ctx.out(op_, "XShape", x.new_zeros((0,)))


@op("cvm", grad="generic")
def _cvm(ctx, op_):
    """``loss_ops.py:170``: with ``use_cvm``, columns 0 and 1 (show,
    click) become log(show + 1) and log(click + 1) − log(show + 1);
    without, they are dropped."""
    x = ctx.in1(op_, "X")
    if bool(op_.attr("use_cvm", True)):
        show = torch.log(x[:, :1] + 1.0)
        ctr = torch.log(x[:, 1:2] + 1.0) - torch.log(x[:, :1] + 1.0)
        ctx.out(op_, "Y", torch.cat([show, ctr, x[:, 2:]], 1))
    else:
        ctx.out(op_, "Y", x[:, 2:])


# the log-space "zero" of the CTC recursion: a finite floor, so an
# alignment no path reaches gives a large finite loss, as the reference's
_CTC_NEG = -1e30


def ctc_loss(logits, labels, logit_lens=None, label_lens=None, blank=0,
             norm_by_times=False):
    """``warpctc`` (``loss_ops.py:186``): the CTC negative log-likelihood
    [B, 1] of padded ``labels`` [B, L] under ``logits`` [B, T, C]
    (softmaxed here), by the forward recursion over the blank-interleaved
    label in log space with −1e30 for log 0 (``F.ctc_loss`` gives inf
    where no alignment exists; this gives ~1e30, as the reference). A row
    past its logit length keeps its last column; ``norm_by_times``
    divides the loss by the logit length (the reference's choice; Paddle
    scales only the gradient). The recursion runs in float64 and the
    loss returns in the logits' type: in fp32, 200 frames leave the
    gradient 5.6e-5 of its largest value from float64's (batch 16, 29
    classes, labels of 20-60), and two devices' exp and log round it
    apart by ~1e-5."""
    B, T, _C = logits.shape
    L = labels.shape[1]
    dev = logits.device
    if logit_lens is None:
        logit_lens = torch.full((B,), T, dtype=torch.long, device=dev)
    if label_lens is None:
        label_lens = torch.full((B,), L, dtype=torch.long, device=dev)
    logit_lens, label_lens = logit_lens.long(), label_lens.long()
    logp = torch.log_softmax(logits.double(), -1)
    S = 2 * L + 1
    ext = torch.full((B, S), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels.long()
    pos = torch.arange(S, device=dev)[None, :]
    ext_valid = pos < (2 * label_lens[:, None] + 1)
    ext_m2 = F.pad(ext, (2, 0), value=-1)[:, :S]
    can_skip = (ext != blank) & (ext != ext_m2)
    neg = logp.new_full((), _CTC_NEG)
    # padding past a row's label may hold any id: gather in range, the
    # positions are masked
    ext_at = ext.clamp(0, logp.shape[-1] - 1)
    first = logp[:, 0].gather(1, ext_at)
    alpha = torch.where(pos == 0, first, neg)
    if S > 1:
        alpha = torch.where((pos == 1) & (label_lens[:, None] > 0), first,
                            alpha)
    for t in range(1, T):
        prev1 = F.pad(alpha, (1, 0), value=_CTC_NEG)[:, :S]
        prev2 = F.pad(alpha, (2, 0), value=_CTC_NEG)[:, :S]
        acc = torch.logaddexp(alpha, prev1)
        acc = torch.where(can_skip, torch.logaddexp(acc, prev2), acc)
        new = torch.where(ext_valid, acc + logp[:, t].gather(1, ext_at), neg)
        alpha = torch.where((t < logit_lens)[:, None], new, alpha)
    end = 2 * label_lens
    a_end = alpha.gather(1, end[:, None])[:, 0]
    a_end1 = torch.where(label_lens > 0, alpha.gather(
        1, (end - 1).clamp_min(0)[:, None])[:, 0], neg)
    loss = -torch.logaddexp(a_end, a_end1)
    if norm_by_times:
        loss = loss / logit_lens.to(loss.dtype)
    return loss[:, None].to(logits.dtype)


def _lengths(ctx, op_, slot, len_slot):
    """Lengths of input ``slot``: its ``len_slot`` input when given,
    else its ``@SEQ_LEN`` companion, else None."""
    t = ctx.in1(op_, len_slot, optional=True)
    if t is not None:
        return t.reshape(-1)
    names = op_.inputs.get(slot) or []
    return companion(ctx, names[0] + SEQ_LEN) if names else None


@op("warpctc", grad="generic")
def _warpctc(ctx, op_):
    """``loss_ops.py:186``: Logits [B, T, C] (or [T, C]), Label [B, L]
    (or [B, L, 1]), their lengths from LogitsLength / LabelLength, else
    from the ``@SEQ_LEN`` companions; WarpCTCGrad zeros, as the
    reference's (its gradient is the vjp of the recursion)."""
    logits = ctx.in1(op_, "Logits")
    labels = ctx.in1(op_, "Label")
    if labels.dim() == 3:
        labels = labels[:, :, 0]
    if logits.dim() == 2:
        logits = logits[None]
    ctx.out(op_, "Loss", ctc_loss(
        logits, labels, _lengths(ctx, op_, "Logits", "LogitsLength"),
        _lengths(ctx, op_, "Label", "LabelLength"),
        int(op_.attr("blank", 0)), bool(op_.attr("norm_by_times", False))))
    ctx.out(op_, "WarpCTCGrad", torch.zeros_like(logits))


@op("modified_huber_loss", grad="generic")
def _modified_huber_loss(ctx, op_):
    """``loss_ops.py:269``: s = (2y − 1)·x; −4s where s < −1, else
    max(0, 1 − s)²; IntermediateVal max(0, 1 − s)."""
    x = ctx.in1(op_, "X")
    s = (2.0 * ctx.in1(op_, "Y") - 1.0) * x
    inter = torch.clamp_min(1.0 - s, 0.0)
    ctx.out(op_, "IntermediateVal", inter)
    ctx.out(op_, "Out", torch.where(s < -1.0, -4.0 * s, inter * inter)
            .reshape(-1, 1))


@op("teacher_student_sigmoid_loss", grad="generic")
def _teacher_student_sigmoid_loss(ctx, op_):
    """``loss_ops.py:284``: label < −1: log(1 + eˣ); −1 ≤ label < 0:
    log(1 + eˣ) − x; else log(1 + eˣ) plus the soft cross-entropy
    log(1 + e^z) − label·z, z = x clipped to the soft-max bounds."""
    x = ctx.in1(op_, "X").reshape(-1)
    label = ctx.in1(op_, "Label").reshape(-1)
    up = float(op_.attr("soft_max_up_bound", 15.0))
    lo = float(op_.attr("soft_max_lower_bound", -15.0))
    sp = _softplus(x)
    xc = x.clamp(lo, up)
    teacher = _softplus(xc) - label * xc
    loss = torch.where(label < -1.0, sp,
                       torch.where(label < 0.0, sp - x, sp + teacher))
    ctx.out(op_, "Y", loss.reshape(-1, 1))


def _hsigmoid_infer(op_, block):
    x = in_var(op_, block, "X")
    if x is None:
        raise SkipInferShape()
    set_out(op_, block, "Out", [x.shape[0], 1], x.dtype)


@op("hierarchical_sigmoid", infer_shape=_hsigmoid_infer, grad="generic")
def _hierarchical_sigmoid(ctx, op_):
    """``loss_ops.py:313``: the sum over a label's path of
    log(1 + e^z) − code·z, z = w_node·x (+ bias_node). The default tree
    is the complete binary heap over ``num_classes`` leaves (leaf
    label + num_classes; node row parent − 1, code the child's parity,
    ⌈log₂ num_classes⌉ levels, rows outside W masked); a custom tree
    gives PathTable (node rows, −1 pads) and PathCode. PreOut the z."""
    x = ctx.in1(op_, "X")
    w = ctx.in1(op_, "W")
    label = ctx.in1(op_, "Label").reshape(-1).long()
    bias = ctx.in1(op_, "Bias", optional=True)
    ptable = ctx.in1(op_, "PathTable", optional=True)
    if ptable is not None:
        nodes = ptable.long()
        codes = ctx.in1(op_, "PathCode").to(x.dtype)
        valid = (nodes >= 0).to(x.dtype)
        nodes = nodes.clamp_min(0)
    else:
        num_classes = int(op_.attr("num_classes"))
        depth = max(1, int(np.ceil(np.log2(max(2, num_classes)))))
        node = label + num_classes
        rows, code_l = [], []
        for _ in range(depth):
            parent = torch.div(node, 2, rounding_mode="floor")
            rows.append(parent - 1)
            code_l.append(torch.remainder(node, 2).to(x.dtype))
            node = parent
        nodes = torch.stack(rows[::-1], 1)
        codes = torch.stack(code_l[::-1], 1)
        valid = ((nodes >= 0) & (nodes < w.shape[0])).to(x.dtype)
        nodes = nodes.clamp(0, w.shape[0] - 1)
    logits = torch.einsum("bld,bd->bl", w[nodes], x)
    if bias is not None:
        logits = logits + bias.reshape(-1)[nodes]
    term = _softplus(logits) - codes * logits
    ctx.out(op_, "Out", (term * valid).sum(1).reshape(-1, 1))
    ctx.out(op_, "PreOut", logits)


def _nce_infer(op_, block):
    x = in_var(op_, block, "Input")
    if x is None:
        raise SkipInferShape()
    set_out(op_, block, "Cost", [x.shape[0], 1], x.dtype)


def nce_samples(generator, sampler, shape, num_classes, dist=None):
    """The negatives of ``nce`` [B, k] (int64) from ``generator``:
    sampler 0 uniform over the classes, 1 log-uniform (Zipf, by the
    inverse CDF ⌊e^{u·ln(N+1)}⌋ − 1), 2 ``dist`` (categorical)."""
    dev = generator.device
    if sampler == 2:
        return torch.multinomial(dist.reshape(-1) + 1e-20,
                                 int(np.prod(shape)), replacement=True,
                                 generator=generator).reshape(shape)
    if sampler == 1:
        u = torch.rand(shape, generator=generator, device=dev)
        return (torch.exp(u * float(np.log(num_classes + 1.0))) - 1.0).to(
            torch.int32).clamp(0, num_classes - 1).long()
    return torch.randint(0, num_classes, shape, generator=generator,
                         device=dev)


def nce(x, label, weight, samples, sampler, num_classes, bias=None,
        dist=None, sample_weight=None):
    """``nce`` (``loss_ops.py:366``) given its ``samples``: with q the
    noise probability (1/N uniform; log((k+2)/(k+1))/log(N+1)
    log-uniform; ``dist`` custom) and z = w·x + b, the cost
    Σ_true log(1 + e^{−(z − log(k·q))}) / num_true + Σ_neg
    log(1 + e^{z − log(k·q)}), times ``sample_weight``. Returns (Cost
    [B, 1], SampleLogits [B, k] the negatives' z)."""
    if label.dim() == 1:
        label = label[:, None]
    label = label.long()
    num_neg = samples.shape[1]
    if sampler == 2 or dist is not None:
        d = dist.reshape(-1)
        p_neg, p_pos = d[samples], d[label]
    elif sampler == 1:
        def zipf(ids):
            idf = ids.to(x.dtype)
            return torch.log((idf + 2.0) / (idf + 1.0)) / float(
                np.log(num_classes + 1.0))
        p_neg, p_pos = zipf(samples), zipf(label)
    else:
        q = x.new_full((), 1.0 / num_classes)
        p_neg, p_pos = q.expand(samples.shape), q.expand(label.shape)

    def logit(ids):
        z = torch.einsum("bkd,bd->bk", weight[ids], x)
        return z + bias.reshape(-1)[ids] if bias is not None else z

    z_pos, z_neg = logit(label), logit(samples)
    adj_pos = z_pos - torch.log(num_neg * p_pos.to(x.dtype))
    adj_neg = z_neg - torch.log(num_neg * p_neg.to(x.dtype))
    cost = _softplus(-adj_pos).sum(1) / label.shape[1] + \
        _softplus(adj_neg).sum(1)
    if sample_weight is not None:
        cost = cost * sample_weight.reshape(-1).to(cost.dtype)
    return cost.reshape(-1, 1), z_neg


@op("nce", infer_shape=_nce_infer, grad="generic")
def _nce(ctx, op_):
    """``loss_ops.py:366``: Input [B, D], Label [B, num_true], Weight
    [N, D] (+ Bias [N, 1]); ``num_neg_samples`` negatives a row drawn by
    ``sampler`` (``nce_samples``) from the op's generator. SampleLabels
    the negatives (int64); the gradient reuses the forward's draw."""
    x = ctx.in1(op_, "Input")
    w = ctx.in1(op_, "Weight")
    dist = ctx.in1(op_, "CustomDistProbs", optional=True)
    num_neg = int(op_.attr("num_neg_samples", 10))
    num_classes = int(op_.attr("num_total_classes", w.shape[0]))
    sampler = int(op_.attr("sampler", 0))
    if sampler == 2 and dist is None:
        raise ValueError("nce: sampler='custom_dist' requires "
                         "CustomDistProbs")
    if dist is not None:
        sampler = 2
    with torch.no_grad():
        samples = nce_samples(ctx.generator(op_), sampler,
                              (x.shape[0], num_neg), num_classes, dist)
    cost, logits = nce(x, ctx.in1(op_, "Label"), w, samples, sampler,
                       num_classes, ctx.in1(op_, "Bias", optional=True),
                       dist, ctx.in1(op_, "SampleWeight", optional=True))
    ctx.out(op_, "Cost", cost)
    ctx.out(op_, "SampleLogits", logits)
    ctx.out(op_, "SampleLabels", samples)
