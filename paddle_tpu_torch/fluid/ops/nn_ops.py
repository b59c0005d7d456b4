"""Convolution, pooling, batch norm, attention, dropout and KV-cache ops
(port of the ``conv2d`` / ``depthwise_conv2d``, ``pool2d``,
``batch_norm``, ``flash_attention`` / ``flash_attention_grad``,
``dropout`` / ``dropout_grad``, ``flash_decode_attention``,
``flash_decode_paged_attention``, ``kv_cache_write``, ``kv_cache_copy``,
``kv_cache_gather``, ``kv_cache_write_paged``, ``kv_cache_gather_paged``
and ``kv_cache_block_copy`` lowerings in
``paddle_tpu/fluid/ops/nn_ops.py``, with the rest of that file: the
transposed convolutions, ``group_norm``, ``instance_norm``, ``lrn``, the
interpolations, ``fc``, max pooling with indices, ``unpool``, ``spp``
and ``relu_grad``): plain functions on tensors, which
the eager models and the serving session call, and the registered
lowerings the Executor runs, which call them."""

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ...kernels import flash_attention as _fa
from .. import core
from .registry import (EMPTY_VAR, SkipInferShape, _generic_grad_lower,
                       in_var, op, register_op, same_shape_infer, set_out,
                       unreplayed_name)

__all__ = [
    "conv2d",
    "pool2d",
    "batch_norm",
    "flash_attention",
    "flash_attention_lse",
    "flash_attention_grad",
    "flash_dropout",
    "dropout",
    "flash_decode_attention",
    "flash_decode_paged_attention",
    "kv_cache_write",
    "kv_cache_copy",
    "kv_cache_gather",
    "kv_cache_write_paged",
    "kv_cache_gather_paged",
    "kv_cache_block_copy",
    "paged_write_index",
    "interp_source",
    "interp_matrix",
    "nearest_interp",
    "bilinear_interp",
    "max_pool_with_index",
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
    the general bias, out, lse and the integer seed; the backward is the
    ``flash_attention_grad`` op, driven from those residuals through both
    backward kernels, so the forward never runs twice. ``forward`` and
    ``setup_context`` are separate, PyTorch's form for a Function that
    ``torch.func`` transforms (``vjp``, ``grad``) can go through."""

    @staticmethod
    def forward(q, k, v, key_bias, bias, causal, scale, rate, seed):
        return _fa.flash_attention_lse(
            q, k, v, key_bias=key_bias, bias=bias, causal=causal,
            scale=scale, dropout_rate=rate, dropout_seed=seed)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, key_bias, bias, causal, scale, rate, seed = inputs
        out, lse = output
        ctx.save_for_backward(q, k, v, key_bias, bias, out, lse)
        ctx.attrs = (causal, scale, rate, seed)
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, key_bias, bias, out, lse = ctx.saved_tensors
        causal, scale, rate, seed = ctx.attrs
        return flash_attention_grad(q, k, v, key_bias, bias, seed, out, lse,
                                    g, g_lse, causal, scale, rate,
                                    ctx.needs_input_grad[3:5]) + (None,) * 4


def flash_attention_grad(q, k, v, key_bias, bias, seed, out, lse, g,
                         g_lse=None, causal=False, scale=None, rate=0.0,
                         bias_grads=(True, True)):
    """The ``flash_attention_grad`` op (``nn_ops.py:1133``) from the
    forward's residuals: (dq, dk, dv, d key_bias, d bias), the last two
    on the raw shapes of ``key_bias`` and ``bias`` (None where there is
    none or ``bias_grads`` says it is not wanted). The reference replays
    the forward under its generic vjp when there is a general bias; the
    residual-driven kernels give the same gradient without a second
    forward."""
    if g is None:
        g = torch.zeros_like(out)
    # autograd hands dO as the transposed view _merge_heads' backward
    # makes; the kernels read contiguous rows
    grads = _fa.flash_attention_bwd_from_residuals(
        q, k, v, key_bias, seed, out, lse, g.contiguous(), causal=causal,
        scale=scale, dropout_rate=rate, g_lse=g_lse, bias=bias)
    dq, dk, dv, dkb = grads[:4]
    dkey_bias = dbias = None
    if key_bias is not None and bias_grads[0]:
        B, N, _Sq, _D = q.shape
        dkey_bias = _unbroadcast_key_bias(
            dkb, tuple(key_bias.shape), B, N, k.shape[2]
        ).to(key_bias.dtype)
    if bias is not None and bias_grads[1]:
        dbias = grads[4].reshape(bias.shape).to(bias.dtype)
    return dq, dk, dv, dkey_bias, dbias


def flash_attention_lse(q, k, v, key_bias=None, causal=False, scale=None,
                        dropout_rate=0.0, dropout_seed=None, bias=None):
    """(out, lse [N, heads, Sq]) of the fused attention, differentiable in
    q, k, v, the key bias and the general ``bias``; a cotangent of
    ``lse`` folds into the backward's delta. When no input needs a
    gradient (or under ``no_grad`` / ``inference_mode``) autograd records
    nothing and this is one forward launch."""
    return _FlashAttention.apply(q, k, v, key_bias, bias, causal, scale,
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
    ``bias`` is differentiable like the other inputs; its gradient comes
    from the same backward kernels."""
    out, _lse = flash_attention_lse(
        q, k, v, key_bias=key_bias, causal=bool(causal),
        scale=float(scale) if scale else None, bias=bias,
        **flash_dropout(dropout_rate, is_test, generator))
    return out


def flash_dropout(dropout_rate, is_test=False, generator=None):
    """The flash op's dropout arguments: ``{"dropout_rate", "dropout_seed"}``
    with the 23-bit seed drawn from the CPU ``generator`` as a Python int
    when dropout is live (rate > 0 and not ``is_test``), else rate 0."""
    rate = float(dropout_rate or 0.0)
    if rate <= 0.0 or is_test:
        return {"dropout_rate": 0.0, "dropout_seed": None}
    seed = int(torch.randint(0, 1 << 23, (), generator=generator))
    return {"dropout_rate": rate, "dropout_seed": seed}


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


def _host_ints(loc):
    return [int(x) for x in torch.as_tensor(loc).reshape(-1).tolist()]


def _start(i, dim, size):
    """A start index as ``lax.dynamic_slice`` / ``dynamic_update_slice``
    take it: a negative one counts from the end (``i + dim``), then it
    clamps to [0, dim - size] so the block fits."""
    if i < 0:
        i += dim
    return min(max(i, 0), dim - size)


def kv_cache_write(cache, new, pos, slot_mode=False):
    """Scatter ``new`` into ``cache`` [slots, heads, max_len, d_head]
    IN PLACE and return ``cache``.

    The reference lowers this op to ``dynamic_update_slice`` inside a
    program whose cache buffers are donated, so XLA updates the cache's
    own buffer; writing into the tensor in place is the PyTorch
    counterpart of that donation, and like the reference it costs the
    written bytes, not the cache. Start indices clamp so the update fits,
    as ``dynamic_update_slice`` clamps them (in slot mode a negative one
    counts from the end first, as there; the per-slot positions of the
    decode step are never negative and clamp at 0).

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
        p = _host_ints(pos)
        slot = _start(p[0], S, 1)
        off = _start(p[1] if len(p) > 1 else 0, M, T)
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


def kv_cache_copy(dst, src, dst_loc, src_loc, length):
    """Move one block of ``length`` tokens between two cache pools IN
    PLACE and return ``dst``: ``src[row, :, pos:pos + length]`` with
    (row, pos) = ``src_loc`` lands at ``dst_loc`` of ``dst`` (both
    [rows, heads, positions, d_head]: the prefix store and the slot
    cache, in either direction). The locations are host data (row,
    position) pairs. As the reference's ``dynamic_slice`` /
    ``dynamic_update_slice``, a negative start counts from the end and
    every start clamps so the block fits: a row to [0, rows - 1], a
    position to [0, positions - length]."""
    sr, sp = _host_ints(src_loc)[:2]
    dr, dp = _host_ints(dst_loc)[:2]
    sr, sp = _start(sr, src.shape[0], 1), _start(sp, src.shape[2], length)
    dr, dp = _start(dr, dst.shape[0], 1), _start(dp, dst.shape[2], length)
    dst[dr, :, dp:dp + length, :] = src[sr, :, sp:sp + length, :].to(
        dst.dtype)
    return dst


def kv_cache_gather(cache, slot_idx):
    """One slot's row ``cache[slot:slot + 1]`` [1, heads, max_len,
    d_head] (a view, no copy), the slot read from the first entry of
    the host data ``slot_idx``, a negative one counted from the end and
    clamped to [0, slots - 1] as the reference's ``dynamic_slice`` does."""
    s = _start(_host_ints(slot_idx)[0], cache.shape[0], 1)
    return cache[s:s + 1]


# ---------------------------------------------------------------------------
# op lowerings
# ---------------------------------------------------------------------------
def _dropout_infer(op_, block):
    x = in_var(op_, block, "X")
    if x is None:
        raise SkipInferShape()
    set_out(op_, block, "Out", x.shape, x.dtype)
    set_out(op_, block, "Mask", x.shape, x.dtype)


def _dropout_grad_maker(op_):
    return [dict(
        type="dropout_grad",
        inputs={"Mask": op_.output("Mask"),
                "Out@GRAD": [n + "@GRAD" for n in op_.output("Out")]},
        outputs={"X@GRAD": [n + "@GRAD" for n in op_.input("X")]},
        attrs=dict(op_.attrs),
    )]


@op("dropout", infer_shape=_dropout_infer, grad=_dropout_grad_maker)
def _dropout_op(ctx, op_):
    """Out = X·Mask with the Mask kept as the op's output (the keep draw
    from the run's device generator, or from the op's own ``seed``), as
    ``nn_ops.py:467``; the grad multiplies by that Mask and never draws."""
    x = ctx.in1(op_, "X")
    p = float(op_.attr("dropout_prob", 0.5))
    impl = op_.attr("dropout_implementation", "downgrade_in_infer")
    if bool(op_.attr("is_test", False)):
        ctx.out(op_, "Out", dropout(x, p, is_test=True,
                                    dropout_implementation=impl))
        ctx.out(op_, "Mask", torch.ones_like(x))
        return
    keep = torch.rand(x.shape, generator=ctx.generator(op_),
                      device=x.device) < 1.0 - p
    mask = keep.to(x.dtype)
    if impl == "upscale_in_train":
        mask = mask / max(1.0 - p, 1e-12)
    ctx.out(op_, "Out", x * mask)
    ctx.out(op_, "Mask", mask)


@op("dropout_grad")
def _dropout_grad(ctx, op_):
    ctx.out(op_, "X@GRAD", ctx.in1(op_, "Out@GRAD") * ctx.in1(op_, "Mask"))


def _flash_attention_infer(op_, block):
    q = in_var(op_, block, "Q")
    if q is None:
        raise SkipInferShape()
    set_out(op_, block, "Out", list(q.shape), q.dtype)


_LSE, _SEED = "@FLASH_LSE", "@FLASH_SEED"


@op("flash_attention", infer_shape=_flash_attention_infer, grad="generic")
def _flash_attention_op(ctx, op_):
    """Fused attention on [N, heads, S, d_head] through the flash kernels
    (the plain versions on the CPU). The softmax statistics and the
    dropout seed are kept as companions of the output var, from which
    ``flash_attention_grad`` drives the backward kernels; the seed is
    drawn from the run's CPU generator as a Python int, so no draw waits
    on the card. A recompute replay (output ``o@RECOMPUTE@k``) takes the
    forward's seed (``o@FLASH_SEED``) and draws none, so its mask, and
    the backward's, is the one the forward applied; a replay without that
    seed raises, since a fresh draw would give wrong gradients."""
    q, k, v = (ctx.in1(op_, s).contiguous() for s in ("Q", "K", "V"))
    # the contiguous copies replace the transposed views in the run's
    # environment: the grad op reads them without copying again
    for slot, t in (("Q", q), ("K", k), ("V", v)):
        ctx.set(op_.input(slot)[0], t)
    key_bias = ctx.in1(op_, "KeyBias", optional=True)
    bias = ctx.in1(op_, "Bias", optional=True)
    scale = op_.attr("scale", 0.0)
    oname = op_.output("Out")[0]
    base = unreplayed_name(oname)
    if base != oname:
        if base + _SEED not in ctx.env:
            raise RuntimeError(
                "flash_attention replay %r: its forward's seed %r is not "
                "in the run" % (oname, base + _SEED))
        seed = ctx.env[base + _SEED]
        drop = {"dropout_rate": 0.0 if seed is None else float(
            op_.attr("dropout_rate", 0.0)), "dropout_seed": seed}
    else:
        drop = flash_dropout(op_.attr("dropout_rate", 0.0),
                             bool(op_.attr("is_test", False)),
                             ctx.host_generator() if ctx.rng else None)
    out, lse = flash_attention_lse(
        q, k, v, key_bias=key_bias, bias=bias,
        causal=bool(op_.attr("causal", False)),
        scale=float(scale) if scale else None, **drop)
    ctx.out(op_, "Out", out)
    ctx.set(oname + _LSE, lse)
    ctx.set(oname + _SEED, drop["dropout_seed"])


@op("flash_attention_grad")
def _flash_attention_grad_op(ctx, op_):
    """The backward kernels from the forward's residuals (Out and the
    lse/seed companions), a general bias included: the forward never
    runs twice. Without the companions (a grad op run apart from its
    forward) it falls back to the counted generic replay."""
    oname = op_.input("Out")[0]
    lse = ctx.get_opt(oname + _LSE)
    if lse is None:
        return _generic_grad_lower(ctx, op_)
    rate = float(op_.attr("dropout_rate", 0.0))
    live = rate > 0.0 and not bool(op_.attr("is_test", False))
    seed = ctx.get_opt(oname + _SEED)
    key_bias = ctx.in1(op_, "KeyBias", optional=True)
    bias = ctx.in1(op_, "Bias", optional=True)
    wants = [any(n != EMPTY_VAR for n in op_.output(slot))
             for slot in ("KeyBias@GRAD", "Bias@GRAD")]
    scale = op_.attr("scale", 0.0)
    q, k, v = (ctx.in1(op_, s).contiguous() for s in ("Q", "K", "V"))
    dq, dk, dv, dkb, dbias = flash_attention_grad(
        q, k, v, key_bias, bias, seed if live else None, ctx.in1(op_, "Out"),
        lse, ctx.in1(op_, "Out@GRAD"), causal=bool(op_.attr("causal", False)),
        scale=float(scale) if scale else None, rate=rate if live else 0.0,
        bias_grads=wants)
    ctx.out(op_, "Q@GRAD", dq)
    ctx.out(op_, "K@GRAD", dk)
    ctx.out(op_, "V@GRAD", dv)
    if dkb is not None:
        ctx.out(op_, "KeyBias@GRAD", dkb)
    if dbias is not None:
        ctx.out(op_, "Bias@GRAD", dbias)


# ---------------------------------------------------------------------------
# the KV-cache serving ops (inference only: no grad is registered, as in
# the reference). The write ops name their ``Cache`` input as their
# ``Out`` and update the scope's tensor in place, the counterpart of the
# reference's donated buffers; a location the op reads on the host comes
# from the feed's host array (``LowerCtx.host_ints``), and what every
# layer derives alike from one step's feeds is computed once a run
# (``LowerCtx.memo``).
# ---------------------------------------------------------------------------
def _scale_attr(op_):
    scale = op_.attr("scale", 0.0)
    return float(scale) if scale else None


@op("flash_decode_attention", infer_shape=same_shape_infer("Q"))
def _flash_decode_attention_op(ctx, op_):
    """One query token a slot against the contiguous cache under the fed
    key bias: the ``flash_decode`` kernel on the card. The ``interpret``
    attr is the reference's switch for its Pallas interpreter, recorded
    and unused here."""
    q = ctx.in1(op_, "Q").contiguous()
    ctx.out(op_, "Out", _fa.flash_decode_attention(
        q, ctx.in1(op_, "K"), ctx.in1(op_, "V"),
        key_bias=ctx.in1(op_, "KeyBias", optional=True),
        scale=_scale_attr(op_)))


@op("flash_decode_paged_attention", infer_shape=same_shape_infer("Q"))
def _flash_decode_paged_attention_op(ctx, op_):
    """One query token a slot reading the shared pool through the fed
    block tables: the ``flash_decode_paged`` kernel on the card, which
    takes int32 tables (cast once a run for every layer)."""
    q = ctx.in1(op_, "Q").contiguous()
    tables = ctx.in1(op_, "Tables")
    t32 = ctx.memo(("tables_i32", op_.input("Tables")[0]), (tables,),
                   lambda: tables.to(torch.int32).contiguous())
    ctx.out(op_, "Out", _fa.flash_decode_paged_attention(
        q, ctx.in1(op_, "K"), ctx.in1(op_, "V"), t32,
        key_bias=ctx.in1(op_, "KeyBias", optional=True),
        scale=_scale_attr(op_)))


@op("kv_cache_write", infer_shape=same_shape_infer("Cache"))
def _kv_cache_write_op(ctx, op_):
    """``kv_cache_write`` in place: in slot mode the (slot[, offset])
    location is read on the host, otherwise each slot's position is a
    device index."""
    cache = ctx.in1(op_, "Cache")
    slot_mode = bool(op_.attr("slot_mode", False))
    pos = ctx.host_ints(op_, "Pos") if slot_mode else ctx.in1(op_, "Pos")
    ctx.out(op_, "Out", kv_cache_write(cache, ctx.in1(op_, "New"), pos,
                                       slot_mode=slot_mode))


@op("kv_cache_copy", infer_shape=same_shape_infer("Dst"))
def _kv_cache_copy_op(ctx, op_):
    """``kv_cache_copy`` in place, both (row, position) locations read
    on the host."""
    ctx.out(op_, "Out", kv_cache_copy(
        ctx.in1(op_, "Dst"), ctx.in1(op_, "Src"),
        ctx.host_ints(op_, "DstLoc"), ctx.host_ints(op_, "SrcLoc"),
        int(op_.attr("length", 0))))


def _kv_cache_gather_infer(op_, block):
    c = in_var(op_, block, "Cache")
    if c is None:
        raise SkipInferShape()
    set_out(op_, block, "Out", [1] + list(c.shape)[1:], c.dtype)


@op("kv_cache_gather", infer_shape=_kv_cache_gather_infer)
def _kv_cache_gather_op(ctx, op_):
    """One slot's row of the cache (a view), the slot read on the
    host."""
    ctx.out(op_, "Out", kv_cache_gather(ctx.in1(op_, "Cache"),
                                        ctx.host_ints(op_, "Pos")))


@op("kv_cache_write_paged", infer_shape=same_shape_infer("Cache"))
def _kv_cache_write_paged_op(ctx, op_):
    """``kv_cache_write_paged`` in place; the write index is computed
    once a run from the tables and positions every layer shares."""
    cache = ctx.in1(op_, "Cache")
    new = ctx.in1(op_, "New")
    tables = ctx.in1(op_, "Tables")
    pos = ctx.in1(op_, "Pos")
    T, block = int(new.shape[2]), int(cache.shape[2])
    index = ctx.memo(
        ("paged_write_index", op_.input("Tables")[0], op_.input("Pos")[0],
         T, block), (tables, pos),
        lambda: paged_write_index(tables, pos, T, block))
    ctx.out(op_, "Out", kv_cache_write_paged(cache, new, tables, None,
                                             index=index))


def _kv_cache_gather_paged_infer(op_, block):
    c = in_var(op_, block, "Cache")
    t = in_var(op_, block, "Tables")
    if c is None or t is None:
        raise SkipInferShape()
    S, max_blocks = int(t.shape[0]), int(t.shape[1])
    set_out(op_, block, "Out",
            [S, int(c.shape[1]), max_blocks * int(c.shape[2]),
             int(c.shape[3])], c.dtype)


@op("kv_cache_gather_paged", infer_shape=_kv_cache_gather_paged_infer)
def _kv_cache_gather_paged_op(ctx, op_):
    """Each slot's logical row gathered through its block table."""
    ctx.out(op_, "Out", kv_cache_gather_paged(ctx.in1(op_, "Cache"),
                                              ctx.in1(op_, "Tables")))


@op("kv_cache_block_copy", infer_shape=same_shape_infer("Cache"))
def _kv_cache_block_copy_op(ctx, op_):
    """``cache[dst[i]] = cache[src[i]]`` in place, the pairs device
    indices."""
    ctx.out(op_, "Out", kv_cache_block_copy(
        ctx.in1(op_, "Cache"), ctx.in1(op_, "Src"), ctx.in1(op_, "Dst")))


# ---------------------------------------------------------------------------
# convolution, pooling and batch norm (``nn_ops.py:41-336``). The
# reference leaves these to XLA, outside any Pallas kernel; here the
# convolutions are cuDNN's and the rest PyTorch's own kernels. The
# reference's ``_use_nhwc`` switch (an NHWC layout inside the TPU
# lowering) changes no value, so the port computes in NCHW throughout.
# ---------------------------------------------------------------------------
def _pair(v):
    if isinstance(v, (list, tuple)):
        return [int(x) for x in v]
    return [int(v), int(v)]


def _conv_out_dim(size, k, pad, stride, dilation=1):
    if size < 0:
        return -1
    return (size + 2 * pad - (dilation * (k - 1) + 1)) // stride + 1


def conv2d(x, w, strides=1, paddings=0, dilations=1, groups=1):
    """The ``conv2d`` op on NCHW ``x`` and OIHW ``w`` (no bias: the layer
    adds it with its own op), symmetric padding, in ``x``'s type."""
    return F.conv2d(x, w, None, _pair(strides), _pair(paddings),
                    _pair(dilations), int(groups or 1))


def _conv2d_infer(op_, block):
    x = in_var(op_, block, "Input")
    w = in_var(op_, block, "Filter")
    if x is None or w is None or len(x.shape) != 4:
        raise SkipInferShape()
    strides = _pair(op_.attr("strides", [1, 1]))
    pads = _pair(op_.attr("paddings", [0, 0]))
    dil = _pair(op_.attr("dilations", [1, 1]))
    n, _, h, wd = x.shape
    oc, _, kh, kw = w.shape
    set_out(op_, block, "Output",
            (n, oc, _conv_out_dim(h, kh, pads[0], strides[0], dil[0]),
             _conv_out_dim(wd, kw, pads[1], strides[1], dil[1])), x.dtype)


def _conv2d_vjp(ctx, op_, slots):
    """``conv2d`` / ``depthwise_conv2d`` (whose groups are the input's
    channels, ``nn_ops.py:89-90``) with its pullback: one
    ``convolution_backward`` for the input and filter grads asked for."""
    x = ctx.in1(op_, "Input")
    w = ctx.in1(op_, "Filter")
    strides = _pair(op_.attr("strides", [1, 1]))
    pads = _pair(op_.attr("paddings", [0, 0]))
    dil = _pair(op_.attr("dilations", [1, 1]))
    groups = int(op_.attr("groups", 1) or 1)
    if op_.type == "depthwise_conv2d":
        groups = int(x.shape[1])
    ctx.out(op_, "Output", conv2d(x, w, strides, pads, dil, groups))
    mask = ["Input" in slots, "Filter" in slots, False]

    def pullback(g):
        dx, dw, _db = torch.ops.aten.convolution_backward(
            g, x, w, None, strides, pads, dil, False, [0, 0], groups, mask)
        return {"Input": dx, "Filter": dw}

    return pullback


for _conv in ("conv2d", "depthwise_conv2d"):
    register_op(_conv, infer_shape=_conv2d_infer,
                lower=lambda ctx, op_: _conv2d_vjp(ctx, op_, ()),
                grad="generic", vjp=_conv2d_vjp)


def _conv_t_out_dim(size, k, pad, stride, dilation=1):
    if size < 0:
        return -1
    return (size - 1) * stride - 2 * pad + dilation * (k - 1) + 1


def _conv2d_transpose_infer(op_, block):
    """The reference's infer (``nn_ops.py:123-138``): (H − 1)·stride −
    2·pad + dilation·(k − 1) + 1, channels Filter's dim 1 times
    ``groups``; ``output_size`` is the layer's (it sets the filter
    size), not the op's."""
    x = in_var(op_, block, "Input")
    w = in_var(op_, block, "Filter")
    if x is None or w is None or len(x.shape) != 4:
        raise SkipInferShape()
    strides = _pair(op_.attr("strides", [1, 1]))
    pads = _pair(op_.attr("paddings", [0, 0]))
    dil = _pair(op_.attr("dilations", [1, 1]))
    n, c, h, wd = x.shape
    _ic, oc_g, kh, kw = w.shape
    groups = c if op_.type == "depthwise_conv2d_transpose" else int(
        op_.attr("groups", 1) or 1)
    set_out(op_, block, "Output",
            (n, oc_g * groups,
             _conv_t_out_dim(h, kh, pads[0], strides[0], dil[0]),
             _conv_t_out_dim(wd, kw, pads[1], strides[1], dil[1])), x.dtype)


def _conv2d_transpose_vjp(ctx, op_, slots):
    """``conv2d_transpose`` (``nn_ops.py:139``) and
    ``depthwise_conv2d_transpose`` (``:790``, groups = the input's
    channels): the transpose of ``conv2d`` on NCHW X with Filter
    [C_in, C_out/groups, kh, kw], with its pullback (one
    ``convolution_backward``)."""
    x = ctx.in1(op_, "Input")
    w = ctx.in1(op_, "Filter")
    strides = _pair(op_.attr("strides", [1, 1]))
    pads = _pair(op_.attr("paddings", [0, 0]))
    dil = _pair(op_.attr("dilations", [1, 1]))
    groups = int(op_.attr("groups", 1) or 1)
    if op_.type == "depthwise_conv2d_transpose":
        groups = int(x.shape[1])
    ctx.out(op_, "Output", F.conv_transpose2d(x, w, None, strides, pads, 0,
                                              groups, dil))
    mask = ["Input" in slots, "Filter" in slots, False]

    def pullback(g):
        dx, dw, _db = torch.ops.aten.convolution_backward(
            g, x, w, None, strides, pads, dil, True, [0, 0], groups, mask)
        return {"Input": dx, "Filter": dw}

    return pullback


for _conv in ("conv2d_transpose", "depthwise_conv2d_transpose"):
    register_op(_conv, infer_shape=_conv2d_transpose_infer,
                lower=lambda ctx, op_: _conv2d_transpose_vjp(ctx, op_, ()),
                grad="generic", vjp=_conv2d_transpose_vjp)


def _group_norm_infer(op_, block):
    x = in_var(op_, block, "X")
    if x is None or len(x.shape) < 2:
        raise SkipInferShape()
    groups = int(op_.attr("groups", 1))
    set_out(op_, block, "Y", x.shape, x.dtype)
    for slot in ("Mean", "Variance"):
        set_out(op_, block, slot, (x.shape[0], groups), x.dtype)


@op("group_norm", infer_shape=_group_norm_infer, grad="generic")
def _group_norm(ctx, op_):
    """``nn_ops.py:417``: X [N, C, ...] normalized over each group of
    C/``groups`` channels and the spatial dims (biased variance), then
    scaled and shifted by channel; Mean and Variance [N, groups]."""
    x = ctx.in1(op_, "X")
    groups = int(op_.attr("groups", 1))
    eps = float(op_.attr("epsilon", 1e-5))
    n, c = x.shape[0], x.shape[1]
    xr = x.reshape(n, groups, -1)
    mean = xr.mean(-1, keepdim=True)
    var = (xr - mean).square().mean(-1, keepdim=True)
    y = ((xr - mean) / torch.sqrt(var + eps)).reshape(x.shape)
    bshape = (1, c) + (1,) * (x.dim() - 2)
    scale = ctx.in1(op_, "Scale", optional=True)
    bias = ctx.in1(op_, "Bias", optional=True)
    if scale is not None:
        y = y * scale.reshape(bshape)
    if bias is not None:
        y = y + bias.reshape(bshape)
    ctx.out(op_, "Y", y)
    ctx.out(op_, "Mean", mean.reshape(n, groups))
    ctx.out(op_, "Variance", var.reshape(n, groups))


def pool2d(x, pooling_type="max", ksize=1, strides=1, paddings=0,
           global_pooling=False, adaptive=False, ceil_mode=False,
           exclusive=True):
    """The ``pool2d`` op (``nn_ops.py:180``) on NCHW ``x``.

    Global pooling takes the max or mean over H and W; ``adaptive`` needs
    H and W divisible by ``ksize`` and pools each block. Otherwise
    windows of ``ksize`` at ``strides`` over ``x`` padded by ``paddings``
    on both sides: max pads with −inf; avg sums over zero padding and
    divides by the window's count of real elements (``exclusive``) or by
    the whole window. ``ceil_mode`` adds padding on the bottom and right
    until the last partial window fits, as the reference does (not
    torch's ceil rule, which drops a window that starts in the padding)."""
    is_max = pooling_type == "max"
    if global_pooling:
        return x.amax((2, 3), keepdim=True) if is_max else x.mean(
            (2, 3), keepdim=True)
    kh, kw = _pair(ksize)
    if adaptive:
        n, c, h, w = x.shape
        if h % kh or w % kw:
            raise ValueError("adaptive pool2d needs dims divisible by ksize "
                             "(%d, %d) %% (%d, %d)" % (h, w, kh, kw))
        xr = x.reshape(n, c, kh, h // kh, kw, w // kw)
        return xr.amax((3, 5)) if is_max else xr.mean((3, 5))
    sh, sw = _pair(strides)
    ph, pw = _pair(paddings)
    h, w = int(x.shape[2]), int(x.shape[3])
    eh = ew = 0
    if ceil_mode:
        oh = -(-(h + 2 * ph - kh) // sh) + 1
        ow = -(-(w + 2 * pw - kw) // sw) + 1
        eh = max((oh - 1) * sh + kh - h - 2 * ph, 0)
        ew = max((ow - 1) * sw + kw - w - 2 * pw, 0)
    pad = (pw, pw + ew, ph, ph + eh)
    if is_max:
        if not (eh or ew) and 2 * ph <= kh and 2 * pw <= kw:
            # torch's own padding is −inf and fits here
            return F.max_pool2d(x, (kh, kw), (sh, sw), (ph, pw))
        return F.max_pool2d(F.pad(x, pad, value=float("-inf")), (kh, kw),
                            (sh, sw))
    sums = F.avg_pool2d(F.pad(x, pad) if any(pad) else x, (kh, kw), (sh, sw),
                        divisor_override=1)
    if not exclusive or not any(pad):
        return sums / float(kh * kw)
    ones = torch.ones((1, 1, h, w), dtype=x.dtype, device=x.device)
    count = F.avg_pool2d(F.pad(ones, pad), (kh, kw), (sh, sw),
                         divisor_override=1)
    return sums / count


def _pool2d_infer(op_, block):
    x = in_var(op_, block, "X")
    if x is None or len(x.shape) != 4:
        raise SkipInferShape()
    n, c, h, w = x.shape
    if op_.attr("global_pooling", False):
        set_out(op_, block, "Out", (n, c, 1, 1), x.dtype)
        return
    kh, kw = _pair(op_.attr("ksize"))
    if op_.attr("adaptive", False):
        set_out(op_, block, "Out", (n, c, kh, kw), x.dtype)
        return
    sh, sw = _pair(op_.attr("strides", [1, 1]))
    ph, pw = _pair(op_.attr("paddings", [0, 0]))
    if op_.attr("ceil_mode", False):
        oh = -(-(h + 2 * ph - kh) // sh) + 1 if h > 0 else -1
        ow = -(-(w + 2 * pw - kw) // sw) + 1 if w > 0 else -1
    else:
        oh = (h + 2 * ph - kh) // sh + 1 if h > 0 else -1
        ow = (w + 2 * pw - kw) // sw + 1 if w > 0 else -1
    set_out(op_, block, "Out", (n, c, oh, ow), x.dtype)


@op("pool2d", infer_shape=_pool2d_infer, grad="generic")
def _pool2d(ctx, op_):
    ctx.out(op_, "Out", pool2d(
        ctx.in1(op_, "X"), op_.attr("pooling_type", "max"),
        op_.attr("ksize", 1), op_.attr("strides", [1, 1]),
        op_.attr("paddings", [0, 0]),
        bool(op_.attr("global_pooling", False)),
        bool(op_.attr("adaptive", False)), bool(op_.attr("ceil_mode", False)),
        bool(op_.attr("exclusive", True))))


def batch_norm(x, scale, bias, mean, variance, epsilon=1e-5, momentum=0.9,
               is_test=False, use_global_stats=False, data_layout="NCHW"):
    """The ``batch_norm`` op (``nn_ops.py:289``): (Y, MeanOut,
    VarianceOut, SavedMean, SavedVariance), nothing written in place.

    Training: the batch mean and the biased variance E[x²] − mean² over
    every axis but the channel one, in fp32 for a bf16, fp16 or fp32
    ``x`` (in fp64 for an fp64 one);
    running stats ``old·momentum + batch·(1 − momentum)``; SavedVariance
    is 1/√(var + ε). ``is_test`` or ``use_global_stats``: the running
    stats normalize and come back unchanged, the saved ones are zeros.
    The per-channel affine is folded and applied in that type and only Y
    is cast back to ``x``'s; the running stats keep their own type.
    (``F.batch_norm``'s update would keep the unbiased variance, with the
    opposite momentum convention.)"""
    f32 = torch.promote_types(x.dtype, torch.float32)
    ch = 1 if data_layout == "NCHW" else x.dim() - 1
    axes = tuple(i for i in range(x.dim()) if i != ch)
    bshape = tuple(x.shape[i] if i == ch else 1 for i in range(x.dim()))
    mean32, var32 = mean.to(f32), variance.to(f32)
    if is_test or use_global_stats:
        use_mean, use_var = mean32, var32
        new_mean, new_var = mean32, var32
        saved_mean, saved_var = torch.zeros_like(mean32), torch.zeros_like(
            var32)
    else:
        x32 = x.to(f32)
        bmean = x32.mean(axes)
        bvar = x32.square().mean(axes) - bmean.square()
        use_mean, use_var = bmean, bvar
        new_mean = mean32 * momentum + bmean * (1.0 - momentum)
        new_var = var32 * momentum + bvar * (1.0 - momentum)
        saved_mean, saved_var = bmean, 1.0 / torch.sqrt(bvar + epsilon)
    inv = 1.0 / torch.sqrt(use_var + epsilon)
    s32 = scale.to(f32)
    g = (s32 * inv).reshape(bshape)
    b = (bias.to(f32) - s32 * use_mean * inv).reshape(bshape)
    y = (x.to(f32) * g + b).to(x.dtype)
    return (y, new_mean.to(mean.dtype), new_var.to(variance.dtype),
            saved_mean, saved_var)


def _batch_norm_infer(op_, block):
    x = in_var(op_, block, "X")
    if x is None:
        raise SkipInferShape()
    set_out(op_, block, "Y", x.shape, x.dtype)
    c = x.shape[1] if len(x.shape) > 1 else x.shape[0]
    for slot in ("MeanOut", "VarianceOut", "SavedMean", "SavedVariance"):
        set_out(op_, block, slot, (c,), x.dtype)


def _batch_norm_vjp(ctx, op_, slots):
    """``batch_norm`` with the running stats written IN PLACE into the
    scope's Mean and Variance tensors where the outputs name them again
    (a recompute replay's renamed outputs get new tensors), and
    its pullback: ``native_batch_norm_backward`` in fp32 from the saved
    mean and 1/√(var + ε) (training) or the running stats (test), the
    gradient of the same function the forward computes."""
    x = ctx.in1(op_, "X")
    scale = ctx.in1(op_, "Scale")
    bias = ctx.in1(op_, "Bias")
    mean = ctx.in1(op_, "Mean")
    var = ctx.in1(op_, "Variance")
    eps = float(op_.attr("epsilon", 1e-5))
    use_global = bool(op_.attr("is_test", False)) or bool(
        op_.attr("use_global_stats", False))
    layout = op_.attr("data_layout", "NCHW")
    y, new_mean, new_var, saved_mean, saved_var = batch_norm(
        x, scale, bias, mean, var, eps, float(op_.attr("momentum", 0.9)),
        use_global, False, layout)
    mean_out, var_out = mean, var
    if not use_global:
        # a recompute replay names its MeanOut / VarianceOut apart
        # (``v@RECOMPUTE@k``): only the forward updates the scope's stats
        if op_.output("MeanOut") == op_.input("Mean"):
            mean.copy_(new_mean.detach())
        else:
            mean_out = new_mean.detach()
        if op_.output("VarianceOut") == op_.input("Variance"):
            var.copy_(new_var.detach())
        else:
            var_out = new_var.detach()
    ctx.out(op_, "Y", y)
    ctx.out(op_, "MeanOut", mean_out)
    ctx.out(op_, "VarianceOut", var_out)
    ctx.out(op_, "SavedMean", saved_mean)
    ctx.out(op_, "SavedVariance", saved_var)
    if not slots:
        return None
    if layout != "NCHW":
        raise NotImplementedError("batch_norm grad: NCHW only")
    mask = ["X" in slots, "Scale" in slots, "Bias" in slots]
    # test mode normalizes by the running stats, which the op left as
    # they were
    f32 = saved_mean.dtype
    run_mean, run_var = (mean.to(f32), var.to(f32)) if use_global else (
        None, None)

    def pullback(g):
        dx, ds, db = torch.ops.aten.native_batch_norm_backward(
            g.to(f32), x.to(f32), scale.to(f32), run_mean, run_var,
            None if use_global else saved_mean,
            None if use_global else saved_var, not use_global, eps, mask)
        return {"X": None if dx is None else dx.to(x.dtype),
                "Scale": None if ds is None else ds.to(scale.dtype),
                "Bias": None if db is None else db.to(bias.dtype)}

    return pullback


register_op("batch_norm", infer_shape=_batch_norm_infer,
            lower=lambda ctx, op_: _batch_norm_vjp(ctx, op_, ()),
            grad="generic", vjp=_batch_norm_vjp)


@op("sync_batch_norm", infer_shape=_batch_norm_infer, grad="generic")
def _sync_batch_norm(ctx, op_):
    """Cross-rank batch norm (``nn_ops.py:338``; Paddle's
    ``sync_batch_norm_op.cu``): the per-channel batch mean and mean of
    squares, in fp32, averaged over ring 0's ranks (equal shards) by a
    differentiable all-reduce, so its generic grad's tape carries the
    sums' transposes too. The running stats are written in place as
    ``batch_norm``'s are. In no world it is ``batch_norm``."""
    from .collective_ops import allreduce_sum, group_for

    group = group_for(ctx, 0)
    if group is None:
        _batch_norm_vjp(ctx, op_, ())
        return
    import torch.distributed as dist

    x = ctx.in1(op_, "X")
    scale = ctx.in1(op_, "Scale")
    bias = ctx.in1(op_, "Bias")
    mean = ctx.in1(op_, "Mean")
    var = ctx.in1(op_, "Variance")
    eps = float(op_.attr("epsilon", 1e-5))
    momentum = float(op_.attr("momentum", 0.9))
    f32 = torch.promote_types(x.dtype, torch.float32)
    axes = tuple(i for i in range(x.dim()) if i != 1)
    bshape = tuple(x.shape[i] if i == 1 else 1 for i in range(x.dim()))
    mean32, var32 = mean.to(f32), var.to(f32)
    if bool(op_.attr("is_test", False)):
        use_mean, use_var = mean32, var32
        new_mean, new_var = mean32, var32
        saved_mean = torch.zeros_like(mean32)
        saved_var = torch.zeros_like(var32)
    else:
        n = dist.get_world_size(group)
        x32 = x.to(f32)
        stats = allreduce_sum(
            torch.stack([x32.mean(axes), x32.square().mean(axes)]), group) / n
        bmean, bsq = stats[0], stats[1]
        bvar = bsq - bmean.square()
        use_mean, use_var = bmean, bvar
        new_mean = mean32 * momentum + bmean * (1.0 - momentum)
        new_var = var32 * momentum + bvar * (1.0 - momentum)
        saved_mean, saved_var = bmean, 1.0 / torch.sqrt(bvar + eps)
        if op_.output("MeanOut") == op_.input("Mean"):
            mean.copy_(new_mean.detach())
            new_mean = mean
        if op_.output("VarianceOut") == op_.input("Variance"):
            var.copy_(new_var.detach())
            new_var = var
    inv = 1.0 / torch.sqrt(use_var + eps)
    s32 = scale.to(f32)
    g = (s32 * inv).reshape(bshape)
    b = (bias.to(f32) - s32 * use_mean * inv).reshape(bshape)
    ctx.out(op_, "Y", (x.to(f32) * g + b).to(x.dtype))
    ctx.out(op_, "MeanOut", new_mean.detach().to(mean.dtype))
    ctx.out(op_, "VarianceOut", new_var.detach().to(var.dtype))
    ctx.out(op_, "SavedMean", saved_mean)
    ctx.out(op_, "SavedVariance", saved_var)


# ---------------------------------------------------------------------------
# the rest of ``nn_ops.py``: instance norm, local response norm, the
# interpolations, ``fc``, max pooling with its indices, unpooling, spatial
# pyramid pooling and the standalone ``relu_grad``
# ---------------------------------------------------------------------------
@op("instance_norm", infer_shape=same_shape_infer("X", "Y"), grad="generic")
def _instance_norm(ctx, op_):
    """``nn_ops.py:412``: each (sample, channel) plane of X [N, C, ...]
    normalized over its spatial dims (biased variance), then scaled and
    shifted by channel; SavedMean and SavedVariance [N, C] are the
    plane's mean and variance (``nn_ops.py:408-409``)."""
    x = ctx.in1(op_, "X")
    eps = float(op_.attr("epsilon", 1e-5))
    axes = tuple(range(2, x.dim()))
    mean = x.mean(axes, keepdim=True)
    var = (x - mean).square().mean(axes, keepdim=True)
    y = (x - mean) / torch.sqrt(var + eps)
    bshape = (1, x.shape[1]) + (1,) * (x.dim() - 2)
    scale = ctx.in1(op_, "Scale", optional=True)
    bias = ctx.in1(op_, "Bias", optional=True)
    if scale is not None:
        y = y * scale.reshape(bshape)
    if bias is not None:
        y = y + bias.reshape(bshape)
    ctx.out(op_, "Y", y)
    ctx.out(op_, "SavedMean", mean.reshape(x.shape[:2]))
    ctx.out(op_, "SavedVariance", var.reshape(x.shape[:2]))


@op("lrn", infer_shape=same_shape_infer("X"), grad="generic")
def _lrn(ctx, op_):
    """``nn_ops.py:509``: Out = X / (k + α·Σx²)^β, the sum over a window
    of ``n`` channels padded n//2 before and n−1−n//2 after (α is not
    divided by n, as ``F.local_response_norm`` divides it); MidOut the
    denominator's base k + α·Σx²."""
    x = ctx.in1(op_, "X")
    n = int(op_.attr("n", 5))
    k = float(op_.attr("k", 2.0))
    alpha = float(op_.attr("alpha", 1e-4))
    beta = float(op_.attr("beta", 0.75))
    half = n // 2
    c = x.shape[1]
    sq = F.pad(x.square(), (0, 0) * (x.dim() - 2) + (half, n - 1 - half))
    acc = sq[:, 0:c]
    for i in range(1, n):
        acc = acc + sq[:, i:i + c]
    mid = k + alpha * acc
    ctx.out(op_, "MidOut", mid)
    ctx.out(op_, "Out", x / mid.pow(beta))


def _interp_out_hw(op_, x):
    """(out_h, out_w) of an interpolation (``nn_ops.py:534``): the attrs,
    else ``scale`` times the input's."""
    oh = int(op_.attr("out_h", 0))
    ow = int(op_.attr("out_w", 0))
    scale = op_.attr("scale", 0.0)
    if (not oh or not ow) and scale:
        oh, ow = int(x.shape[2] * scale), int(x.shape[3] * scale)
    return oh, ow


def interp_source(out_n, in_n, align_corners, align_mode):
    """The fp32 source coordinate of each of ``out_n`` output positions
    (``_src_coords``, ``nn_ops.py:543``), in numpy's fp32 arithmetic as
    the reference's: corner-anchored (in−1)/(out−1) under
    ``align_corners``, else dst·in/out (``align_mode`` 1) or the
    half-pixel (dst + ½)·in/out − ½ clamped at 0 (``align_mode`` 0)."""
    d = np.arange(out_n, dtype=np.float32)
    if align_corners:
        return d * np.float32((in_n - 1.0) / (out_n - 1.0)
                              if out_n > 1 else 0.0)
    ratio = np.float32(in_n / float(out_n))
    if int(align_mode) == 1:
        return d * ratio
    return np.maximum((d + np.float32(0.5)) * ratio - np.float32(0.5),
                      np.float32(0.0))


@functools.lru_cache(maxsize=64)
def _nearest_index(out_n, in_n, align_corners, device):
    s = interp_source(out_n, in_n, align_corners, 1)
    i = np.round(s) if align_corners else np.floor(s)
    return torch.from_numpy(np.clip(i.astype(np.int64), 0, in_n - 1)).to(
        device)


@functools.lru_cache(maxsize=64)
def interp_matrix(out_n, in_n, align_corners, align_mode, dtype, device):
    """The [out_n, in_n] bilinear weights along one axis: row i holds
    1 − w at floor(s_i) and w at floor(s_i) + 1 (both clamped into the
    input), w = s_i − floor(s_i), as ``nn_ops.py:576-596`` weighs its
    four gathers."""
    s = interp_source(out_n, in_n, align_corners, align_mode)
    i0 = np.clip(np.floor(s).astype(np.int64), 0, in_n - 1)
    i1 = np.clip(i0 + 1, 0, in_n - 1)
    w = s - i0.astype(np.float32)
    m = np.zeros((out_n, in_n), np.float32)
    rows = np.arange(out_n)
    np.add.at(m, (rows, i0), np.float32(1) - w)
    np.add.at(m, (rows, i1), w)
    return torch.from_numpy(m).to(device=device, dtype=dtype)


def nearest_interp(x, out_h, out_w, align_corners=True):
    """``nearest_interp`` (``nn_ops.py:559``) on NCHW ``x``: the source
    index rounds under ``align_corners`` and floors otherwise."""
    iy = _nearest_index(out_h, x.shape[2], bool(align_corners), x.device)
    ix = _nearest_index(out_w, x.shape[3], bool(align_corners), x.device)
    return x.index_select(2, iy).index_select(3, ix)


def bilinear_interp(x, out_h, out_w, align_corners=True, align_mode=1):
    """``bilinear_interp`` (``nn_ops.py:576``) on NCHW ``x`` as two
    products with the axes' weight matrices (``interp_matrix``): the
    reference's four weighted gathers, summed in a product's order, with
    a product's pullback."""
    ac, am = bool(align_corners), int(align_mode)
    my = interp_matrix(out_h, x.shape[2], ac, am, x.dtype, x.device)
    mx = interp_matrix(out_w, x.shape[3], ac, am, x.dtype, x.device)
    return torch.matmul(my, torch.matmul(x, mx.t()))


def _interp_lower(fn):
    def lower(ctx, op_):
        x = ctx.in1(op_, "X")
        oh, ow = _interp_out_hw(op_, x)
        kw = {"align_corners": bool(op_.attr("align_corners", True))}
        if fn is bilinear_interp:
            kw["align_mode"] = int(op_.attr("align_mode", 1))
        ctx.out(op_, "Out", fn(x, oh, ow, **kw))

    return lower


register_op("nearest_interp", lower=_interp_lower(nearest_interp),
            grad="generic")
register_op("interp_nearest", lower=_interp_lower(nearest_interp),
            grad="generic")
register_op("bilinear_interp", lower=_interp_lower(bilinear_interp),
            grad="generic")


def _fc_infer(op_, block):
    x = in_var(op_, block, "Input")
    w = in_var(op_, block, "W")
    if x is None or w is None:
        raise SkipInferShape()
    ncd = int(op_.attr("in_num_col_dims", 1))
    set_out(op_, block, "Out", list(x.shape[:ncd]) + [w.shape[-1]], x.dtype)


@op("fc", infer_shape=_fc_infer, grad="generic")
def _fc(ctx, op_):
    """``nn_ops.py:610``: Input flattened to 2-D at ``in_num_col_dims``,
    times W, plus Bias, through relu when ``activation_type`` says so."""
    x = ctx.in1(op_, "Input")
    w = ctx.in1(op_, "W")
    ncd = int(op_.attr("in_num_col_dims", 1))
    lead = tuple(x.shape[:ncd])
    x2 = x.reshape(int(np.prod(lead)) if lead else 1, -1)
    out = x2 @ w.reshape(x2.shape[1], -1)
    b = ctx.in1(op_, "Bias", optional=True)
    if b is not None:
        out = out + b.reshape(1, -1)
    if op_.attr("activation_type", "") == "relu":
        out = torch.relu(out)
    ctx.out(op_, "Out", out.reshape(lead + (w.shape[-1],)))


def _pool_with_index_infer(op_, block):
    x = in_var(op_, block, "X")
    if x is None:
        raise SkipInferShape()
    k = len(x.shape) - 2
    ksize = [int(v) for v in op_.attr("ksize")]
    if op_.attr("global_pooling", False):
        shape = list(x.shape[:2]) + [1] * k
    elif op_.attr("adaptive", False):
        shape = list(x.shape[:2]) + ksize
    else:
        strides = [int(v) for v in op_.attr("strides", [1] * k)]
        pads = [int(v) for v in op_.attr("paddings", [0] * k)]
        shape = list(x.shape[:2]) + [
            _conv_out_dim(x.shape[2 + i], ksize[i], pads[i], strides[i])
            for i in range(k)]
    set_out(op_, block, "Out", shape, x.dtype)
    set_out(op_, block, "Mask", shape, core.VarDesc.VarType.INT32)


@functools.lru_cache(maxsize=64)
def _window_coords(spatial, k, strides, pads, device):
    """[output positions, window offsets] int32: the flat index, within
    the unpadded plane, of each window element (row-major over both)."""
    nd = len(spatial)
    out = [(spatial[i] + 2 * pads[i] - k[i]) // strides[i] + 1
           for i in range(nd)]
    flat = np.zeros((int(np.prod(out)), int(np.prod(k))), np.int64)
    for p, o in enumerate(np.ndindex(*out)):
        for q, off in enumerate(np.ndindex(*k)):
            f = 0
            for i in range(nd):
                f = f * spatial[i] + o[i] * strides[i] + off[i] - pads[i]
            flat[p, q] = f
    return torch.from_numpy(flat.astype(np.int32)).to(device)


def max_pool_with_index(x, ksize, strides, paddings, global_pooling=False,
                        adaptive=False):
    """``max_pool{2,3}d_with_index`` (``nn_ops.py:651``) on [N, C,
    *spatial] ``x``: (Out, Mask), Mask the int32 flat index within the
    unpadded plane of each window's first largest element (row-major
    over the window); padding takes fp32's lowest value, as the
    reference's. ``adaptive`` needs dims the bins divide."""
    nd = x.dim() - 2
    spatial = tuple(int(s) for s in x.shape[2:])
    k = [int(v) for v in ksize]
    if adaptive and not global_pooling:
        if any(spatial[i] % k[i] for i in range(nd)):
            raise ValueError("adaptive max_pool_with_index needs divisible "
                             "dims")
        k = [spatial[i] // k[i] for i in range(nd)]
        strides, pads = list(k), [0] * nd
    elif global_pooling:
        k, strides, pads = list(spatial), [1] * nd, [0] * nd
    else:
        strides = [int(v) for v in strides]
        pads = [int(v) for v in paddings]
    n, c = x.shape[:2]
    xp = x
    if any(pads):
        xp = F.pad(x, [p for p in reversed(pads) for _ in (0, 1)],
                   value=float(np.finfo(np.float32).min))
    for i in range(nd):
        xp = xp.unfold(2 + i, k[i], strides[i])
    out_dims = tuple(xp.shape[2:2 + nd])
    patches = xp.reshape(n, c, -1, int(np.prod(k)))
    amax = patches.argmax(-1, keepdim=True)
    out = patches.gather(-1, amax).reshape((n, c) + out_dims)
    coords = _window_coords(spatial, tuple(k), tuple(strides), tuple(pads),
                            x.device)
    mask = coords.expand(n, c, -1, -1).gather(-1, amax)
    return out, mask.reshape((n, c) + out_dims)


def _max_pool_with_index_op(ctx, op_):
    x = ctx.in1(op_, "X")
    nd = x.dim() - 2
    out, mask = max_pool_with_index(
        x, op_.attr("ksize"), op_.attr("strides", [1] * nd),
        op_.attr("paddings", [0] * nd),
        bool(op_.attr("global_pooling", False)),
        bool(op_.attr("adaptive", False)))
    ctx.out(op_, "Out", out)
    ctx.out(op_, "Mask", mask)


register_op("max_pool2d_with_index", infer_shape=_pool_with_index_infer,
            lower=_max_pool_with_index_op, grad="generic")
register_op("max_pool3d_with_index", infer_shape=_pool_with_index_infer,
            lower=_max_pool_with_index_op, grad="generic")


@op("unpool", grad="generic")
def _unpool(ctx, op_):
    """``nn_ops.py:741``: each X [N, C, H, W] value put at its Indices
    entry (flat within the output plane). The plane is ``unpooled_size``,
    else ``ksize``, as the reference sizes it; an index outside it is
    dropped (a negative one counts from the end), as the reference's
    scatter drops it."""
    x = ctx.in1(op_, "X")
    idx = ctx.in1(op_, "Indices").long()
    out_hw = [int(v) for v in op_.attr("unpooled_size",
                                       op_.attr("ksize", []))]
    n, c = x.shape[:2]
    oh, ow = out_hw[-2], out_hw[-1]
    size = oh * ow
    idx = idx.reshape(n, c, -1)
    idx = torch.where(idx < 0, idx + size, idx)
    idx = torch.where((idx >= 0) & (idx < size), idx, size)
    flat = x.new_zeros((n, c, size + 1)).scatter(2, idx, x.reshape(n, c, -1))
    ctx.out(op_, "Out", flat[:, :, :size].reshape(n, c, oh, ow))


@op("spp", grad="generic")
def _spp(ctx, op_):
    """``nn_ops.py:761``: ``pyramid_height`` levels of 2^l × 2^l bins
    (bin i of a level spans [⌊h·i/b⌋, max(⌊h·(i+1)/b⌋, ⌊h·i/b⌋ + 1))),
    each max or mean pooled, flattened channel-major and concatenated."""
    x = ctx.in1(op_, "X")
    levels = int(op_.attr("pyramid_height", 1))
    ptype = op_.attr("pooling_type", "max")
    n, _c, h, w = x.shape
    outs = []
    for lv in range(levels):
        bins = 2 ** lv
        hb = [h * i // bins for i in range(bins + 1)]
        wb = [w * i // bins for i in range(bins + 1)]
        cells = []
        for i in range(bins):
            for j in range(bins):
                cell = x[:, :, hb[i]:max(hb[i + 1], hb[i] + 1),
                         wb[j]:max(wb[j + 1], wb[j] + 1)]
                cells.append(cell.amax((2, 3)) if ptype == "max"
                             else cell.mean((2, 3)))
        outs.append(torch.stack(cells, -1).reshape(n, -1))
    ctx.out(op_, "Out", torch.cat(outs, 1))


@op("relu_grad")
def _relu_grad(ctx, op_):
    """``nn_ops.py:500``: the standalone grad op of ``relu``, Out@GRAD
    where Out is positive, else 0, read from the forward's Out (no
    forward closure kept)."""
    out = ctx.in1(op_, "Out")
    dout = ctx.in1(op_, "Out@GRAD")
    ctx.out(op_, "X@GRAD", torch.where(out > 0, dout, torch.zeros_like(dout)))
