"""Miscellaneous ops (port of ``paddle_tpu/fluid/ops/misc_ops.py``; so
far ``ctc_align``, which ``ctc_greedy_decoder`` runs after its argmax)."""

import torch

from .registry import op
from .sequence_ops import SEQ_LEN

__all__ = ["ctc_align"]


def ctc_align(x, blank=0, merge_repeated=True, padding_value=0):
    """``ctc_align`` (``misc_ops.py:486``) on [B, T] label ids: repeats
    merged (with ``merge_repeated``) and blanks dropped, the kept ids
    packed to the left in their order and the rest ``padding_value``;
    returns (the ids, in X's dtype, and each row's kept count, int32)."""
    prev = torch.cat([torch.full_like(x[:, :1], -1), x[:, :-1]], 1)
    keep = x != blank
    if merge_repeated:
        keep = keep & (x != prev)
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    packed = x.gather(1, order)
    count = keep.sum(1)
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    out = torch.where(pos < count[:, None], packed,
                      torch.full_like(packed, padding_value))
    return out, count.to(torch.int32)


@op("ctc_align")
def _ctc_align(ctx, op_):
    """The aligned ids in Output, their lengths in its ``@SEQ_LEN``
    companion."""
    out, count = ctc_align(ctx.in1(op_, "Input"), int(op_.attr("blank", 0)),
                           bool(op_.attr("merge_repeated", True)),
                           int(op_.attr("padding_value", 0)))
    ctx.out(op_, "Output", out)
    names = op_.outputs.get("Output") or []
    if names:
        ctx.set(names[0] + SEQ_LEN, count)
