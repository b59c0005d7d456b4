"""Attention, dropout and KV-cache op lowerings (port of the
``flash_attention`` / ``flash_attention_grad``, ``dropout``,
``flash_decode_attention``, ``flash_decode_paged_attention``,
``kv_cache_write`` and paged KV-pool lowerings in
``paddle_tpu/fluid/ops/nn_ops.py``) as plain functions on tensors."""

import torch

from ...kernels import flash_attention as _fa

__all__ = [
    "flash_attention",
    "flash_attention_lse",
    "dropout",
    "flash_decode_attention",
    "flash_decode_paged_attention",
    "kv_cache_write",
    "kv_cache_write_paged",
    "kv_cache_gather_paged",
    "kv_cache_block_copy",
    "paged_write_index",
]


def _unbroadcast_key_bias(dkb, raw_shape, B, N, Sk):
    """[B*N, Sk] key-bias gradient summed back onto the raw key-bias
    shape (``flash_attention_grad``, :1184-1205): the forward collapses
    any accepted shape to (r0, Sk) with r0 in {1, B, B*N} before
    broadcasting, so the gradient sums the broadcast axes back."""
    r0 = 1
    for dim in raw_shape[:-1]:
        r0 *= int(dim)
    if r0 == B * N:
        d = dkb
    elif r0 == B and N > 1:
        d = dkb.reshape(B, N, Sk).sum(1)
    else:
        d = dkb.reshape(B, N, Sk).sum((0, 1))
    return d.reshape(raw_shape)


class _FlashAttention(torch.autograd.Function):
    """The ``flash_attention`` op made differentiable: the forward is the
    flash forward (kernel on the card) and saves q, k, v, the key bias,
    out, lse and the integer seed; the backward is the
    ``flash_attention_grad`` op, driven from those residuals through both
    backward kernels, so the forward never runs twice."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, causal, scale, rate, seed):
        out, lse = _fa.flash_attention_lse(
            q, k, v, key_bias=key_bias, causal=causal, scale=scale,
            dropout_rate=rate, dropout_seed=seed)
        ctx.save_for_backward(q, k, v, key_bias, out, lse)
        ctx.attrs = (causal, scale, rate, seed)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, key_bias, out, lse = ctx.saved_tensors
        causal, scale, rate, seed = ctx.attrs
        if g is None:
            g = torch.zeros_like(out)
        # autograd hands dO as the transposed view _merge_heads' backward
        # makes; the kernels read contiguous rows
        dq, dk, dv, dkb = _fa.flash_attention_bwd_from_residuals(
            q, k, v, key_bias, seed, out, lse, g.contiguous(), causal=causal,
            scale=scale, dropout_rate=rate, g_lse=g_lse)
        dkey_bias = None
        if key_bias is not None and ctx.needs_input_grad[3]:
            B, N, _Sq, _D = q.shape
            dkey_bias = _unbroadcast_key_bias(
                dkb, tuple(key_bias.shape), B, N, k.shape[2]
            ).to(key_bias.dtype)
        return dq, dk, dv, dkey_bias, None, None, None, None


def flash_attention_lse(q, k, v, key_bias=None, causal=False, scale=None,
                        dropout_rate=0.0, dropout_seed=None):
    """(out, lse [N, heads, Sq]) of the fused attention, differentiable in
    q, k, v and the key bias; a cotangent of ``lse`` folds into the
    backward's delta. When no input needs a gradient (or under
    ``no_grad`` / ``inference_mode``) autograd records nothing and this
    is one forward launch."""
    return _FlashAttention.apply(q, k, v, key_bias, causal, scale,
                                 dropout_rate, dropout_seed)


def flash_attention(q, k, v, key_bias=None, bias=None, causal=False,
                    scale=0.0, dropout_rate=0.0, is_test=False,
                    generator=None):
    """The ``flash_attention`` op on [N, heads, S, d_head] inputs,
    differentiable through the residual-driven backward kernels (the
    ``flash_attention_grad`` op).

    ``scale`` 0 means 1/sqrt(d_head), as the op attribute. Attention
    dropout applies only when ``dropout_rate > 0`` and not ``is_test``;
    its 23-bit seed is drawn from ``generator``, a CPU ``torch.Generator``
    (the reference draws it from the executor's key stream), as a Python
    int: a draw on the card would cost a host sync per layer. A general
    ``bias`` runs the plain version on CPU tensors (differentiable through
    its dense ops) and raises on the card (the Fluid-layers slice ports
    it)."""
    rate = float(dropout_rate or 0.0)
    seed = None
    if rate > 0.0 and not is_test:
        seed = int(torch.randint(0, 1 << 23, (), generator=generator))
    rate = rate if seed is not None else 0.0
    scale = float(scale) if scale else None
    if bias is not None:
        out, _lse = _fa.flash_attention_lse(
            q, k, v, key_bias=key_bias, bias=bias, causal=bool(causal),
            scale=scale, dropout_rate=rate, dropout_seed=seed)
        return out
    out, _lse = flash_attention_lse(q, k, v, key_bias=key_bias,
                                    causal=bool(causal), scale=scale,
                                    dropout_rate=rate, dropout_seed=seed)
    return out


def dropout(x, dropout_prob=0.5, is_test=False,
            dropout_implementation="downgrade_in_infer", generator=None):
    """The ``dropout`` op (``nn_ops.py:467``).

    Training: keep each element with probability 1 − p, drawn from
    ``generator`` (on ``x``'s device); ``downgrade_in_infer`` returns
    x·mask, ``upscale_in_train`` x·mask/(1 − p). Test: ``downgrade_in_infer``
    returns x·(1 − p), ``upscale_in_train`` x. The gradient is dOut·mask,
    as ``dropout_grad``. The masks come from torch's generator, not the
    reference's JAX key stream, so the two drop different elements."""
    p = float(dropout_prob)
    upscale = dropout_implementation == "upscale_in_train"
    if not upscale and dropout_implementation != "downgrade_in_infer":
        raise ValueError("unknown dropout_implementation %r"
                         % (dropout_implementation,))
    if is_test:
        return x if upscale else x * (1.0 - p)
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - p
    mask = keep.to(x.dtype)
    if upscale:
        mask = mask / max(1.0 - p, 1e-12)
    return x * mask


def flash_decode_attention(q, k, v, key_bias=None, scale=0.0):
    """The ``flash_decode_attention`` op: one live token per KV-cache
    slot against the fixed-shape cache, per-slot length masking via the
    key bias. Inference only."""
    return _fa.flash_decode_attention(
        q, k, v, key_bias=key_bias, scale=float(scale) if scale else None)


def flash_decode_paged_attention(q, k_pool, v_pool, tables, key_bias=None,
                                 scale=0.0):
    """The ``flash_decode_paged_attention`` op: one live token per slot
    against the shared paged pool read through the block tables, all
    masking in the key bias. Inference only."""
    return _fa.flash_decode_paged_attention(
        q, k_pool, v_pool, tables, key_bias=key_bias,
        scale=float(scale) if scale else None)


def paged_write_index(tables, pos, T, block):
    """Where ``kv_cache_write_paged`` puts each token: token j of slot s
    lands at logical position ``pos[s] + j``, i.e. pool block
    ``tables[s, (pos[s]+j) // block]`` at offset ``(pos[s]+j) % block``.
    Returns (pool blocks, offsets), each [slots * T] int64 in (slot,
    token) order. Every layer of a step writes the same positions, so a
    caller computes this once per step and passes it to each write."""
    tables = torch.as_tensor(tables)
    pos = torch.as_tensor(pos, device=tables.device).reshape(-1, 1).long()
    abs_pos = pos + torch.arange(T, device=tables.device).reshape(1, T)
    blk = tables.gather(1, abs_pos // block).reshape(-1).long()
    return blk, (abs_pos % block).reshape(-1)


def kv_cache_write_paged(cache, new, tables, pos, index=None):
    """Scatter each slot's token window ``new`` [slots, heads, T, d_head]
    into the shared pool ``cache`` [blocks, heads, block, d_head] IN
    PLACE through the block ``tables`` [slots, max_blocks], slot s
    starting at logical position ``pos[s]`` (see ``paged_write_index``;
    ``index`` is its result when the caller already has it). Returns
    ``cache``.

    One ``index_put_``, no per-slot loop. Duplicate targets (inactive
    slots all parked on the sink block) are garbage by contract, so the
    order the card resolves them in does not matter. Unlike the
    reference's scatter, which drops out-of-range indices, an index past
    the table raises here: the caller's tables must cover
    ``(pos + T - 1) // block`` (unused entries point at the sink)."""
    S, H, T, D = new.shape
    blk, off = index if index is not None else paged_write_index(
        tables, pos, T, cache.shape[2])
    cache[blk, :, off, :] = new.to(cache.dtype).transpose(1, 2).reshape(
        S * T, H, D)
    return cache


def kv_cache_gather_paged(cache, tables):
    """Each slot's logical cache row through its block table: [slots,
    heads, max_blocks*block, d_head]. Positions past a slot's live
    length read whatever the mapped blocks hold; the caller's key bias
    masks them."""
    return _fa.gather_paged_rows(cache, tables)


def kv_cache_block_copy(cache, src, dst):
    """``cache[dst[i]] = cache[src[i]]`` in place for each pair — the
    copy-on-write primitive; a src == dst pair is a no-op. Returns
    ``cache``."""
    src = torch.as_tensor(src, device=cache.device).reshape(-1).long()
    dst = torch.as_tensor(dst, device=cache.device).reshape(-1).long()
    cache[dst] = cache[src]
    return cache


def kv_cache_write(cache, new, pos, slot_mode=False):
    """Scatter ``new`` into ``cache`` [slots, heads, max_len, d_head]
    IN PLACE and return ``cache``.

    The reference lowers this op to ``dynamic_update_slice`` inside a
    program whose cache buffers are donated, so XLA updates the cache's
    own buffer; writing into the tensor in place is the PyTorch
    counterpart of that donation, and like the reference it costs the
    written bytes, not the cache. Start indices clamp so the update fits,
    as ``dynamic_update_slice`` clamps them.

    - ``slot_mode=True``: ``new`` is [1, heads, T, d_head] and ``pos``
      holds (slot,) or (slot, offset); the block lands in that slot's row
      at ``offset`` (0 when absent). ``pos`` is host data here.
    - otherwise ``new`` is [slots, heads, T, d_head] and ``pos`` [slots]
      (any shape with one entry per slot, on the cache's device or the
      host): slot ``s`` lands at its own position ``pos[s]``."""
    S, _H, M, _D = cache.shape
    new = new.to(cache.dtype)
    T = new.shape[2]
    if slot_mode:
        p = [int(x) for x in torch.as_tensor(pos).reshape(-1).tolist()]
        slot = min(max(p[0], 0), S - 1)
        off = min(max(p[1] if len(p) > 1 else 0, 0), M - T)
        cache[slot, :, off:off + T, :] = new[0]
        return cache
    start = torch.as_tensor(pos, device=cache.device).reshape(S, 1, 1, 1) \
        .long().clamp(0, M - T)
    idx = start if T == 1 else start + torch.arange(
        T, device=cache.device).reshape(1, 1, T, 1)
    # one scatter along the position axis: slot s, head h, token t lands
    # at position start[s] + t (a broadcast index, no per-slot loop)
    cache.scatter_(2, idx.expand(new.shape), new)
    return cache
