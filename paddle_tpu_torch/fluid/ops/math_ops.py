"""Math-op semantics the GPT path relies on (port of the matching
lowerings in ``paddle_tpu/fluid/ops/math_ops.py``). These stay PyTorch
calls; what matters is that they mean what the reference's ops mean."""

import torch
import torch.nn.functional as F

__all__ = ["layer_norm", "gelu", "softmax", "softmax_with_cross_entropy"]


def layer_norm(x, weight=None, bias=None, begin_norm_axis=1, epsilon=1e-5):
    """Normalize over the dims from ``begin_norm_axis`` on, with the
    reference's epsilon 1e-5 and biased variance (mean of squares),
    then scale and shift."""
    return F.layer_norm(x, tuple(x.shape[begin_norm_axis:]), weight, bias,
                        epsilon)


def gelu(x, approximate=False):
    """GELU; exact (erf) by default, as the reference's ``gelu`` op."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def softmax(x, axis=-1):
    return torch.softmax(x, dim=axis)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, axis=-1,
                               return_softmax=False):
    """The ``softmax_with_cross_entropy`` op (``math_ops.py:495``): the
    loss −log softmax(logits)[label] with the class axis kept as size 1.
    Hard labels may carry a trailing dim of 1; entries equal to
    ``ignore_index`` give loss 0 (and no gradient). ``soft_label`` takes
    a distribution over the classes instead. With ``return_softmax`` it
    also returns the softmax, as the op's second output."""
    logp = F.log_softmax(logits, dim=axis)
    if soft_label:
        loss = -(label * logp).sum(dim=axis, keepdim=True)
    else:
        lab = label
        if lab.dim() and lab.shape[-1] == 1:
            lab = lab.reshape(lab.shape[:-1])
        lab = lab.long().unsqueeze(axis)
        ignored = lab == ignore_index
        loss = -logp.gather(axis, lab.masked_fill(ignored, 0))
        loss = loss.masked_fill(ignored, 0.0)
    if return_softmax:
        return loss, logp.exp()
    return loss
