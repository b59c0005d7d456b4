"""Quantized all-reduce (port of
``paddle_tpu/parallel/quantized_allreduce.py``; EQuARX-style,
arXiv:2506.17615).

Gradient all-reduce is bandwidth-bound on large models. The sum runs as
its reduce-scatter and all-gather halves with the payload on the wire
quantized to int8 against per-block absmax scales, dequantized around
the arithmetic so that the sum accumulates in fp32:

  1. split the flat tensor into one block per rank, take each block's
     absmax scale, quantize to int8;
  2. ``all_to_all_single`` the int8 blocks and their scales (rank k
     receives block k of every peer: the reduce-scatter's traffic at
     1/4 of the bytes for fp32 inputs);
  3. dequantize and sum over the peers in fp32;
  4. quantize the reduced block again and ``all_gather`` it with its
     scale;
  5. dequantize into the input's shape and dtype.

The only loss is the two roundings, each at most half a step of its
block's absmax / 127. The gradient is straight through: the backward is
the exact sum's (itself an all-reduce sum of the cotangent), so a round
or a clip never zeroes it. Plain torch ops over ``torch.distributed``,
as the reference's is plain ``jnp`` over ``lax`` collectives.
"""

import torch

from .mesh import pad_to_multiple


def _dist():
    import torch.distributed as dist

    return dist


def _quantize(x):
    """-> (int8 values, fp32 scales) with absmax scaling per row."""
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def _quantized_sum(x, group, postscale):
    dist = _dist()
    n = dist.get_world_size(group)
    flat, size = pad_to_multiple(x.float().reshape(-1), n)
    blocks = flat.reshape(n, -1)                       # [n, B]
    q, scale = _quantize(blocks)                       # [n, B], [n, 1]
    q_recv = torch.empty_like(q)
    s_recv = torch.empty_like(scale)
    dist.all_to_all_single(q_recv, q.contiguous(), group=group)
    dist.all_to_all_single(s_recv, scale.contiguous(), group=group)
    reduced = (q_recv.float() * s_recv).sum(0)         # [B], fp32
    if postscale != 1.0:
        reduced = reduced * postscale
    q2, s2 = _quantize(reduced[None, :])
    width = q2.shape[1]
    q_all = q2.new_empty(n * width)
    s_all = s2.new_empty(n)
    dist.all_gather_into_tensor(q_all, q2.reshape(-1), group=group)
    dist.all_gather_into_tensor(s_all, s2.reshape(-1), group=group)
    out = (q_all.reshape(n, width).float() * s_all[:, None]).reshape(-1)
    return out[:size].reshape(x.shape).to(x.dtype)


class _QuantizedSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, postscale):
        ctx.group, ctx.postscale = group, postscale
        return _quantized_sum(x, group, postscale)

    @staticmethod
    def backward(ctx, g):
        # the exact sum's vjp: the all-reduce sum of the cotangent
        out = g.contiguous().clone()
        _dist().all_reduce(out, group=ctx.group)
        if ctx.postscale != 1.0:
            out = out * ctx.postscale
        return out, None, None


def quantized_psum(x, group=None, postscale=1.0):
    """int8-wire all-reduce SUM of ``x`` over ``group`` (the world by
    default; shape and dtype kept, fp32 accumulation). ``postscale``
    folds an output factor (1/n for a mean) into the fp32 stage."""
    return _QuantizedSum.apply(x, group, float(postscale))


def quantized_pmean(x, group=None):
    """int8-wire all-reduce MEAN (the 1/n rides the fp32 stage)."""
    return quantized_psum(x, group, 1.0 / _dist().get_world_size(group))
