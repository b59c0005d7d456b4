"""Flash attention for the port: plain PyTorch versions beside the
hand-written CUDA kernels (port of ``paddle_tpu/kernels/flash_attention.py``).

Layout [B, N, S, D] (batch, heads, seq, head_dim), heads flattened to
B·N inside the kernels, fp32 accumulation, masked scores at ``_NEG``
(-1e30) and ``l`` clamped at 1e-30 — the reference's conventions.

Five kernels, each behind a wrapper with a plain integer launch count:

- ``flash_attention_lse`` launches ``flash_fwd`` (``csrc/flash_fwd.cu``),
  which replaces the Pallas ``_fwd_kernel``: a key-only bias, the general
  additive bias [G, Sq, Sk] in every broadcast form, the causal flag and
  the in-kernel hash dropout — the GPT prefill (rate 0), the GPT train
  step and ``fluid.layers.flash_attention(bias=...)``. It returns (out,
  lse); ``flash_attention`` drops the lse.
- ``flash_bwd_dq`` and ``flash_bwd_dkv`` launch ``flash_bwd_dq``
  (``csrc/flash_bwd_dq.cu``) and ``flash_bwd_dkv``
  (``csrc/flash_bwd_dkv.cu``), which replace the Pallas
  ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` (key bias, general bias
  with its gradient dbias, causal, dropout).
  ``flash_attention_bwd_from_residuals`` drives both from the forward's
  saved out, lse and seed, as the reference's ``flash_attention_grad``
  op does.
- ``flash_decode_attention`` launches ``flash_decode``
  (``csrc/flash_decode.cu``), which replaces the Pallas
  ``_decode_kernel``: one query token per (slot, head) against the
  contiguous KV cache, all masking in the key bias.
- ``flash_decode_paged_attention`` launches ``flash_decode_paged``
  (``csrc/flash_decode_paged.cu``), which replaces the Pallas
  ``_decode_paged_kernel``: the same math with K/V read from the shared
  paged pool through each slot's block table — the paged engine's
  width-1 step.

A wrapper given CPU tensors runs its plain version (the functions named
``*_plain`` here), which the CPU tests hold against the JAX package;
given CUDA tensors it launches its kernel or raises. There is no
fallback from one to the other. Where a general ``bias`` is given, the
backward entry points return its gradient dbias after their other
outputs.

Element types: every kernel takes fp32, bf16 or fp16 (one type for
q/k/v, dO and the pools; lse, delta and the biases fp32). The training
kernels take any head dim up to 256 (zero-padded to 32, 64, 128 or 256)
and all three run on the tensor cores (``mma.sync``): bf16 and fp16 as
they are, fp32 in split TF32 (three TF32 products for each fp32 one).
The decode kernels take any head dim from 1 to 256 as it is (a pad
would copy the cache every step). They split each (slot, head) row's keys
over the blocks of a thread-block cluster (split-K): ``_decode_splits``
picks the count from the shape alone, ``_decode_ranges`` says which keys
each block takes.
"""

import functools
import math
import threading
import warnings

import torch

from . import _build

__all__ = [
    "reference_attention",
    "flash_attention_lse",
    "flash_attention",
    "flash_bwd_dq",
    "flash_bwd_dkv",
    "flash_attention_bwd_from_residuals",
    "flash_decode_attention",
    "flash_decode_paged_attention",
    "flash_attention_lse_plain",
    "flash_bwd_dq_plain",
    "flash_bwd_dkv_plain",
    "flash_attention_bwd_plain",
    "flash_decode_attention_plain",
    "flash_decode_paged_attention_plain",
    "gather_paged_rows",
]

_NEG = -1e30
# head dims the training kernels are instantiated for: any other D up to
# 256 is zero-padded to the next one (``_pad_head_dim``). Past 256 they
# raise: no model of either package goes there (GPT-2 and BERT-base use
# 64), and the kernels' shared-memory tiles end there. The decode
# kernels take every D up to ``_MAX_DECODE_HEAD_DIM`` as it is.
_TRAIN_HEAD_DIMS = (32, 64, 128, 256)
_MAX_DECODE_HEAD_DIM = 256
# element types of q/k/v (and dO): the C entry point's suffix
_KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16",
                  torch.float16: "f16"}

# splitmix32-style avalanche constants for the stateless dropout hash
_H1, _H2, _H3 = 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D
_M1, _M2 = 0x2C1B3C6D, 0x297A2D39
_U32 = 0xFFFFFFFF


def reference_attention(q, k, v, bias=None, causal=False, scale=None):
    """Dense oracle, [B, N, S, D]; bias broadcastable to [B, N, S, S]."""
    d = q.shape[-1]
    s = torch.einsum("bnqd,bnkd->bnqk", q, k).float()
    s = s * (scale if scale is not None else 1.0 / math.sqrt(d))
    if bias is not None:
        s = s + bias.float()
    if causal:
        S = q.shape[2]
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, _NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bnqk,bnkd->bnqd", p.to(q.dtype), v)


# --------------------------------------------------------------------------
# dropout hash (the kernels compute the same in uint32, flash_common.cuh)
# --------------------------------------------------------------------------


def _hash_keep(rows, cols, head, seed_u32, rate):
    """Keep-mask from absolute (row, col), the flat head index and a
    seed: the reference's splitmix32-style hash, computed in int64 with
    explicit 32-bit wrap-around so it is bit-identical to the uint32
    arithmetic of the JAX version."""
    n = (rows * _H1 + cols * _H2 + (seed_u32 + head * _H3)) & _U32
    n = n ^ (n >> 15)
    n = (n * _M1) & _U32
    n = n ^ (n >> 12)
    n = (n * _M2) & _U32
    n = n ^ (n >> 15)
    return n < _keep_threshold(rate)


def _keep_threshold(rate):
    """keep iff hash < this: (1 - rate) * 2^32 in double precision, as
    the reference computes it (fp32 would round it to another integer)."""
    return min(int((1.0 - float(rate)) * 4294967296.0), _U32)


def _norm_seed(dropout_seed):
    """Any user seed -> a 23-bit int, avalanche-mixed the reference's way
    (``_norm_seed``: a plain modulus would alias seeds). A tensor seed is
    read with ``.item()``, a host sync on the card: the training path
    hands Python ints."""
    s = 0 if dropout_seed is None else dropout_seed
    if isinstance(s, torch.Tensor):
        s = s.reshape(()).item()
    if isinstance(s, float):
        s = int(s)
    s = int(s)
    u = (s ^ (s >> 32) ^ (s >> 64)) & _U32
    u ^= u >> 16
    u = (u * 0x7FEB352D) & _U32
    u ^= u >> 15
    u = (u * 0x846CA68B) & _U32
    u ^= u >> 16
    return u >> 9


def _fallback_keep(B, N, Sq, Sk, seed, rate, device):
    heads = torch.arange(B * N, dtype=torch.int64, device=device).reshape(B, N, 1, 1)
    rows = torch.arange(Sq, dtype=torch.int64, device=device).reshape(1, 1, Sq, 1)
    cols = torch.arange(Sk, dtype=torch.int64, device=device).reshape(1, 1, 1, Sk)
    return _hash_keep(rows, cols, heads, seed, rate)


# --------------------------------------------------------------------------
# bias normalization
# --------------------------------------------------------------------------


def _normalize_key_bias(key_bias, B, N, Sk):
    """Raw key bias ([Sk] / [1, Sk] / [B, Sk] / [B*N, Sk] / broadcastable)
    -> the kernels' canonical [B*N, Sk] fp32 layout (a broadcast view)."""
    if key_bias is None:
        return None
    kb = key_bias.float()
    if kb.dim() == 1:
        kb = kb[None]
    kb = kb.reshape(-1, Sk)
    if kb.shape[0] == B and N > 1:
        kb = kb[:, None, :].expand(B, N, Sk).reshape(-1, Sk)
    return kb.expand(B * N, Sk)


def _normalize_bias(bias, B, N, Sq, Sk):
    """-> (bias [G, Sq, Sk] with G in {1, B, B*N}, head_major_swap)."""
    b = bias.float()
    if b.dim() == 2:
        return b[None], False
    if b.dim() == 3:
        if b.shape[0] in (1, B * N) or (b.shape[0] == B and N == 1):
            return b, False
        raise ValueError(
            "3-D flash-attention bias must have leading dim 1 or B*N, got %r"
            % (tuple(b.shape),))
    if b.dim() == 4:
        b0, b1 = b.shape[:2]
        if (b0, b1) == (1, 1):
            return b.reshape(1, Sq, Sk), False
        if b1 == 1 and b0 == B:
            return b.reshape(B, Sq, Sk), False
        if b0 == 1 and b1 == N:
            return b.reshape(N, Sq, Sk), True
        if (b0, b1) == (B, N):
            return b.reshape(B * N, Sq, Sk), False
        raise ValueError(
            "4-D flash-attention bias must broadcast from (1|B, 1|N, Sq, Sk),"
            " got %r" % (tuple(b.shape),))
    raise ValueError("flash-attention bias must be 2-/3-/4-D, got %r"
                     % (tuple(b.shape),))


def _bias_layout(bias, B, N, Sq, Sk):
    """The general bias as the kernels read it: (bias [G, Sq, Sk] fp32,
    contiguous; div; rows), head h = b·N + n reading row (h // div) %
    rows. Every broadcast form maps straight onto the caller's heads —
    [Sq, Sk] and [1, 1, ..] row 0, [B, 1, ..] row h // N, [B, N, ..] row
    h, [1, N, ..] row h % N — so nothing is transposed; the reference's
    B↔N swap only orders its sequential grid."""
    nb, swap = _normalize_bias(bias, B, N, Sq, Sk)
    G = nb.shape[0]
    if swap:
        div, rows = 1, N
    elif G == B * N:
        div, rows = 1, G
    elif G == 1:
        div, rows = 1, 1
    else:
        div, rows = N, B
    return nb.contiguous(), div, rows


def _bias_axes(div, rows, B, N):
    """(b, n), b·n = G: the [B, N] shape a bias row broadcasts from."""
    if rows == 1:
        return 1, 1
    if div == 1 and rows == B * N:
        return B, N
    if div == 1:
        return 1, N
    return B, 1


def _add_bias(s, bias, B, N, Sq, Sk):
    """Scores [B, N, Sq, Sk] plus the general bias broadcast onto the
    heads that read each of its rows (``s`` itself when there is none)."""
    if bias is None:
        return s
    nb, div, rows = _bias_layout(bias, B, N, Sq, Sk)
    b, n = _bias_axes(div, rows, B, N)
    return s + nb.reshape(b, n, Sq, Sk)


def _sum_bias_grad(ds, bias, B, N, Sq, Sk):
    """dbias [G, Sq, Sk] fp32: ds [B, N, Sq, Sk] summed over the heads
    that read each bias row."""
    _nb, div, rows = _bias_layout(bias, B, N, Sq, Sk)
    b, n = _bias_axes(div, rows, B, N)
    dims = [axis for axis, m in ((0, b), (1, n)) if m == 1]
    if dims:
        ds = ds.sum(dims, keepdim=True)
    return ds.reshape(b * n, Sq, Sk)


def _check_args(q, k, causal, dropout_rate, dropout_seed, warn=True):
    Sq, Sk = q.shape[2], k.shape[2]
    if causal and Sq != Sk:
        raise ValueError("causal flash attention needs Sq == Sk")
    rate = float(dropout_rate or 0.0)
    if not 0.0 <= rate < 1.0:
        raise ValueError("dropout_rate must be in [0, 1), got %r" % rate)
    if warn and rate > 0.0 and dropout_seed is None:
        warnings.warn(
            "flash_attention: dropout_rate > 0 with dropout_seed=None "
            "reuses ONE fixed dropout mask on every call; pass a "
            "per-step seed for real dropout", stacklevel=3)
    return rate


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def flash_attention_lse_plain(q, k, v, key_bias=None, bias=None,
                              causal=False, scale=None, dropout_rate=0.0,
                              dropout_seed=None):
    """Plain PyTorch version of the forward kernel: the reference's dense
    fallback, returning (out [B, N, Sq, D], lse [B, N, Sq]). Covers
    everything the Pallas kernel does, general ``bias`` and hash dropout
    included."""
    B, N, Sq, d = q.shape
    Sk = k.shape[2]
    rate = _check_args(q, k, causal, dropout_rate, dropout_seed)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kb = _normalize_key_bias(key_bias, B, N, Sk)
    s = _scores(q, k, scale)
    if kb is not None:
        s = s + kb.reshape(B, N, 1, Sk)
    s = _add_bias(s, bias, B, N, Sq, Sk)
    if causal:
        mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, _NEG)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    if rate > 0.0:
        keep = _fallback_keep(B, N, Sq, Sk, _norm_seed(dropout_seed), rate,
                              q.device)
        p = torch.where(keep, p / (1.0 - rate), torch.zeros_like(p))
    out = _dot(p, v, "bnqk,bnkd->bnqd").to(q.dtype)
    return out, lse


def _scores(q, k, scale):
    """Masked-score input Q·Kᵀ·scale [B, N, Sq, Sk] in fp32 from operands
    of any float type: products of bf16 or fp16 values are exact in fp32,
    so this is the kernels' (and the reference kernel's) low x low -> fp32
    dot, up to the order of the sum."""
    return torch.einsum("bnqd,bnkd->bnqk", q.float(), k.float()) * scale


def _dot(a, b, spec):
    """``einsum(spec)`` of ``a`` rounded to ``b``'s type and ``b``, summed
    in fp32: the reference kernel's ``a.astype(b.dtype)`` before a dot
    with fp32 accumulation. The identity casts in fp32."""
    return torch.einsum(spec, a.to(b.dtype).float(), b.float())


def _bwd_delta(out, g, g_lse=None):
    """delta = rowsum(dO∘O) [B, N, Sq] fp32, less the lse cotangent where
    there is one (``_flash_bwd_core``, :748-751): ds_ij gains p_ij·g_lse_i,
    which folds into delta."""
    delta = (g.float() * out.float()).sum(-1)
    if g_lse is not None:
        delta = delta - g_lse.float().reshape(delta.shape)
    return delta


def _bwd_terms(q, k, v, key_bias, g, lse, delta, causal, scale, rate,
               dropout_seed, bias=None):
    """The backward kernels' math on dense tensors: (ds, pv), each
    [B, N, Sq, Sk] fp32, with p = exp(s − lse) from the forward's masked
    scores, dp = keep∘(dO·Vᵀ)/(1−rate) (V rounded to dO's type, summed in
    fp32), ds = p∘(dp − delta) and pv = keep∘p/(1−rate) (p itself without
    dropout). The products that use ds and pv round them to their other
    operand's type (``_bwd_dq``, ``_bwd_dkv``), where the kernels do."""
    B, N, Sq, _D = q.shape
    Sk = k.shape[2]
    kb = _normalize_key_bias(key_bias, B, N, Sk)
    s = _scores(q, k, scale)
    if kb is not None:
        s = s + kb.reshape(B, N, 1, Sk)
    s = _add_bias(s, bias, B, N, Sq, Sk)
    if causal:
        mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, _NEG)
    p = torch.exp(s - lse.float().reshape(B, N, Sq, 1))
    dp = torch.einsum("bnqd,bnkd->bnqk", g.float(), v.to(g.dtype).float())
    pv = p
    if rate > 0.0:
        keep = _fallback_keep(B, N, Sq, Sk, _norm_seed(dropout_seed), rate,
                              q.device)
        inv_keep = 1.0 / (1.0 - rate)
        zero = torch.zeros((), dtype=p.dtype, device=p.device)
        dp = torch.where(keep, dp * inv_keep, zero)
        pv = torch.where(keep, p * inv_keep, zero)
    ds = p * (dp - delta.float().reshape(B, N, Sq, 1))
    return ds, pv


def _bwd_dq(q, k, ds, scale):
    """dq = scale · ds·K, ds rounded to K's type, in q's type."""
    return (_dot(ds, k, "bnqk,bnkd->bnqd") * scale).to(q.dtype)


def _bwd_dkv(q, k, v, g, ds, pv, scale, bias=None):
    """dk = scale · dsᵀ·Q (ds rounded to Q's type) and dv = pvᵀ·dO (pv
    rounded to dO's type) in k's and v's types; dkey_bias and dbias sum
    the fp32 ds."""
    B, N, Sq, _D = q.shape
    Sk = k.shape[2]
    dk = _dot(ds, q, "bnqk,bnqd->bnkd") * scale
    dv = _dot(pv, g, "bnqk,bnqd->bnkd")
    out = (dk.to(k.dtype), dv.to(v.dtype), ds.sum(2).reshape(B * N, Sk))
    if bias is None:
        return out
    return out + (_sum_bias_grad(ds, bias, B, N, Sq, Sk),)


def flash_bwd_dq_plain(q, k, v, key_bias, g, lse, delta, causal=False,
                       scale=None, dropout_rate=0.0, dropout_seed=None,
                       bias=None):
    """Plain PyTorch version of the dq kernel: dq = scale · ds·K, ds as
    in ``_bwd_dq_kernel``. ``g`` is dO [B, N, Sq, D]; ``lse`` and
    ``delta`` are [B, N, Sq] (or [B·N, Sq]); ``dropout_seed`` is the raw
    seed the forward was given; ``bias`` the forward's general bias."""
    rate = _check_args(q, k, causal, dropout_rate, dropout_seed, warn=False)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    ds, _pv = _bwd_terms(q, k, v, key_bias, g, lse, delta, causal, scale,
                         rate, dropout_seed, bias)
    return _bwd_dq(q, k, ds, scale)


def flash_bwd_dkv_plain(q, k, v, key_bias, g, lse, delta, causal=False,
                        scale=None, dropout_rate=0.0, dropout_seed=None,
                        bias=None):
    """Plain PyTorch version of the dk/dv kernel: (dk, dv, dkey_bias
    [B·N, Sk] fp32) as ``_bwd_dkv_kernel`` computes them, and dbias
    [G, Sq, Sk] fp32 (summed over the heads sharing a bias row) after
    them when ``bias`` is given; arguments as ``flash_bwd_dq_plain``."""
    rate = _check_args(q, k, causal, dropout_rate, dropout_seed, warn=False)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    ds, pv = _bwd_terms(q, k, v, key_bias, g, lse, delta, causal, scale,
                        rate, dropout_seed, bias)
    return _bwd_dkv(q, k, v, g, ds, pv, scale, bias)


def flash_attention_bwd_plain(q, k, v, key_bias, seed, out, lse, g,
                              causal=False, scale=None, dropout_rate=0.0,
                              g_lse=None, bias=None):
    """Plain PyTorch version of both backward kernels: the explicit math
    of ``_flash_bwd_core`` on dense tensors, driven from the forward's
    residuals (``out``, ``lse`` and the raw dropout ``seed``). ``g`` is
    dO; ``g_lse`` an optional lse cotangent [B, N, Sq]; ``bias`` the
    forward's general bias. Returns (dq, dk, dv, dkey_bias [B·N, Sk]
    fp32), and dbias [G, Sq, Sk] fp32 after them when ``bias`` is given;
    the keep mask is regenerated from the seed with the forward's hash."""
    rate = _check_args(q, k, causal, dropout_rate, seed, warn=False)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    delta = _bwd_delta(out, g, g_lse)
    ds, pv = _bwd_terms(q, k, v, key_bias, g, lse, delta, causal, scale,
                        rate, seed, bias)
    dkv = _bwd_dkv(q, k, v, g, ds, pv, scale, bias)
    return (_bwd_dq(q, k, ds, scale),) + dkv


def flash_decode_attention_plain(q, k, v, key_bias=None, scale=None):
    """Plain PyTorch version of the decode kernel: q [B, N, 1, D] against
    the cache k/v [B, N, S, D], out in q's type. Scores are fp32 from the
    operands of any float type and P·V sums in fp32 on p rounded to v's
    type, as the training plain versions do; in fp32 this is the
    reference's dense fallback. In bf16 and fp16 the kernels (as the
    reference's) round the running, unnormalised p, this version the
    normalised one: outs differ within ``tools/lowp_limits.out_bound`` at
    rate 0."""
    B, N, Sq, D = q.shape
    Sk = k.shape[2]
    if Sq != 1:
        raise ValueError(
            "flash_decode_attention is the single-query path, got Sq=%d" % Sq)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    kb = _normalize_key_bias(key_bias, B, N, Sk)
    s = _scores(q, k, scale)
    if kb is not None:
        s = s + kb.reshape(B, N, 1, Sk)
    p = torch.softmax(s, dim=-1)
    return _dot(p, v, "bnqk,bnkd->bnqd").to(q.dtype)


def gather_paged_rows(pool, tables):
    """Each slot's logical KV row read through its block table: pool
    [blocks, N, blk, D] and tables [B, MB] (int32 or int64) -> [B, N,
    MB·blk, D], row ``b`` the concatenation of ``pool[tables[b, i]]``
    over its logical blocks ``i`` (a copy)."""
    B, MB = tables.shape
    _blocks, N, blk, D = pool.shape
    rows = pool.index_select(0, tables.reshape(-1))
    return rows.view(B, MB, N, blk, D).transpose(1, 2).reshape(
        B, N, MB * blk, D)


def _check_paged(q, k_pool, tables):
    B, N, Sq, D = q.shape
    _blocks, Np, blk, Dp = k_pool.shape
    if Sq != 1:
        raise ValueError("flash_decode_paged_attention is the single-query "
                         "path, got Sq=%d" % Sq)
    if (Np, Dp) != (N, D):
        raise ValueError("pool geometry %r does not match q heads/depth "
                         "(%d, %d)" % (tuple(k_pool.shape), N, D))
    if tables.dim() != 2 or tables.shape[0] != B:
        raise ValueError("tables must be [B, max_blocks] with B = %d, got %r"
                         % (B, tuple(tables.shape)))
    return B, N, D, blk, tables.shape[1]


def flash_decode_paged_attention_plain(q, k_pool, v_pool, tables,
                                       key_bias=None, scale=None):
    """Plain PyTorch version of the paged decode kernel (the reference's
    dense fallback): gather each slot's logical rows through ``tables``,
    then the decode math of ``flash_decode_attention_plain``."""
    _check_paged(q, k_pool, tables)
    return flash_decode_attention_plain(
        q, gather_paged_rows(k_pool, tables), gather_paged_rows(v_pool, tables),
        key_bias=key_bias, scale=scale)


# --------------------------------------------------------------------------
# kernel wrappers: the public entry points, in the reference's signatures
# --------------------------------------------------------------------------


def _kernel_key_bias(key_bias, B, N, Sk):
    """The key bias as the kernels read it: ([G, Sk] fp32, heads per row)
    with G in {1, B, B*N}, head ``bh`` reading row ``bh // heads``. A
    contiguous fp32 [B, Sk] bias (the engine's and the model's) passes
    through as it is: no per-head copy, no launch. (None, 1) for none."""
    if key_bias is None:
        return None, 1
    kb = key_bias.float().reshape(-1, Sk).contiguous()
    if kb.shape[0] not in (1, B, B * N):
        raise ValueError("key_bias must broadcast from [1|B|B*N, Sk], got %r"
                         % (tuple(key_bias.shape),))
    return kb, B * N // kb.shape[0]


def _kernel_bias(bias, B, N, Sq, Sk):
    """(bias [G, Sq, Sk] fp32 contiguous, div, rows) for the kernels (see
    ``_bias_layout``), or (None, 1, 1) for none."""
    if bias is None:
        return None, 1, 1
    return _bias_layout(bias, B, N, Sq, Sk)


def _cuda_operands(name, data, fp32=(), align=16):
    """Validate what the kernel takes, raise on anything else, and return
    the entry point's element-type suffix. ``data`` (q/k/v, dO; the
    pools) must share one of fp32, bf16 and fp16; ``fp32`` (lse, delta,
    the biases; None entries skipped) must be fp32. All contiguous and
    on one CUDA device; ``data`` aligned to ``align`` bytes (the training
    kernels copy 16 bytes at a time; the decode kernels read four
    elements at a time, or one where D is not a multiple of 8)."""
    dev = data[0].device
    if dev.type != "cuda":
        raise ValueError("%s kernel runs on CUDA tensors, got %s" % (name, dev))
    dtype = data[0].dtype
    if dtype not in _KERNEL_DTYPES:
        raise TypeError("%s kernel takes fp32, bf16 or fp16, got %s"
                        % (name, dtype))
    for t in data:
        if t.dtype != dtype:
            raise TypeError("%s kernel takes one element type for q/k/v/dO, "
                            "got %s and %s" % (name, dtype, t.dtype))
    for t in fp32:
        if t is not None and t.dtype != torch.float32:
            raise TypeError("%s kernel takes fp32 lse, delta and biases, "
                            "got %s" % (name, t.dtype))
    for t in list(data) + [t for t in fp32 if t is not None]:
        if t.device != dev:
            raise ValueError("%s: operands on different devices (%s, %s)"
                             % (name, dev, t.device))
        if not t.is_contiguous():
            raise ValueError("%s kernel needs contiguous operands" % name)
    for t in data:
        if t.data_ptr() % align:
            raise ValueError("%s kernel needs q/k/v/dO aligned to %d bytes"
                             % (name, align))
    return _KERNEL_DTYPES[dtype]


def _train_head_dim(name, D):
    """The instantiated head dim a training kernel runs D at: D itself or
    the next of ``_TRAIN_HEAD_DIMS``; raises past 256."""
    for width in _TRAIN_HEAD_DIMS:
        if 1 <= D <= width:
            return width
    raise ValueError("%s kernel supports head_dim 1..%d, got %d"
                     % (name, _TRAIN_HEAD_DIMS[-1], D))


def _pad_head_dim(width, *tensors):
    """Each [.., D] tensor zero-padded to [.., width] (itself when D is
    the width). Zero columns leave every score, probability and delta as
    they are, and come out as zero columns of out, dq, dk and dv."""
    return [t if t.shape[-1] == width
            else torch.nn.functional.pad(t, (0, width - t.shape[-1]))
            for t in tensors]


def _decode_align(name, D, size):
    """Bytes the decode kernels need q and the cache aligned to at head
    dim D (four elements of ``size`` bytes where D is a multiple of 8,
    one otherwise); raises outside 1..256."""
    if not 1 <= D <= _MAX_DECODE_HEAD_DIM:
        raise ValueError("%s kernel supports head_dim 1..%d, got %d"
                         % (name, _MAX_DECODE_HEAD_DIM, D))
    return size * (4 if D % 8 == 0 else 1)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(name, dtype, device, *args):
    fn = _build.load(name, dtype)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError("%s launch failed: CUDA error %d (%s)"
                           % (name, err, fn.error_string(err).decode()))


_count_lock = threading.Lock()


def _count(wrapper):
    """One more launch on ``wrapper.launches``, under a lock: a server's
    pool workers launch from threads of their own."""
    with _count_lock:
        wrapper.launches += 1


def _dropout_args(rate, dropout_seed):
    """The kernels' dropout arguments: (on, 23-bit seed, keep threshold,
    1 − rate, 1 / (1 − rate)). The threshold is computed here in double
    precision as the reference does; ctypes rounds the two rates to fp32,
    the type the reference multiplies in."""
    if rate <= 0.0:
        return 0, 0, 0, 1.0, 1.0
    return (1, _norm_seed(dropout_seed), _keep_threshold(rate), 1.0 - rate,
            1.0 / (1.0 - rate))


def flash_attention_lse(q, k, v, key_bias=None, bias=None, causal=False,
                        scale=None, dropout_rate=0.0, dropout_seed=None):
    """(out [B, N, Sq, D], lse [B, N, Sq]) — see ``flash_attention``.

    The wrapper of the ``flash_fwd`` CUDA kernel. CPU tensors run the
    plain version (``flash_attention_lse_plain``). CUDA tensors launch
    the kernel on the current stream (q/k/v contiguous and 16-byte
    aligned, all fp32, bf16 or fp16; out in their type, lse fp32; any
    head_dim up to 256, zero-padded to 32, 64, 128 or 256 with ``scale``
    from the real one; on the tensor cores, fp32 in split TF32) or
    raise: the
    kernel takes a key bias, the general ``bias`` in every broadcast
    form, the causal flag and the hash dropout.
    ``flash_attention_lse.launches`` counts kernel launches."""
    if q.device.type == "cpu":
        return flash_attention_lse_plain(
            q, k, v, key_bias=key_bias, bias=bias, causal=causal,
            scale=scale, dropout_rate=dropout_rate, dropout_seed=dropout_seed)
    rate = _check_args(q, k, causal, dropout_rate, dropout_seed)
    B, N, Sq, D = q.shape
    Sk = k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    kb, bias_heads = _kernel_key_bias(key_bias, B, N, Sk)
    nb, div, rows = _kernel_bias(bias, B, N, Sq, Sk)
    width = _train_head_dim("flash_fwd", D)
    et = _cuda_operands("flash_fwd", (q, k, v), (kb, nb))
    q, k, v = _pad_head_dim(width, q, k, v)
    on, seed, thresh, keep_prob, _inv = _dropout_args(rate, dropout_seed)
    out = torch.empty_like(q)
    lse = torch.empty(B, N, Sq, dtype=torch.float32, device=q.device)
    _launch("flash_fwd", et, q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), _ptr(kb), _ptr(nb), out.data_ptr(), lse.data_ptr(),
            B * N, bias_heads, div, rows, Sq, Sk, width, float(scale),
            int(bool(causal)), on, seed, thresh, keep_prob)
    _count(flash_attention_lse)
    if width != D:
        out = out[..., :D].contiguous()
    return out, lse


flash_attention_lse.launches = 0


def flash_attention(q, k, v, key_bias=None, bias=None, causal=False,
                    scale=None, dropout_rate=0.0, dropout_seed=None):
    """Fused attention, [B, N, S, D] -> [B, N, S, D].

    ``key_bias``: additive mask over keys, [B*N, S] or broadcastable
    (padding masks as (mask-1)*1e4). ``bias``: general additive bias
    broadcastable to [B, N, Sq, Sk]. ``dropout_rate``/``dropout_seed``:
    attention-probability dropout from the stateless hash. This is
    ``flash_attention_lse`` with the lse dropped."""
    out, _lse = flash_attention_lse(
        q, k, v, key_bias=key_bias, bias=bias, causal=causal, scale=scale,
        dropout_rate=dropout_rate, dropout_seed=dropout_seed)
    return out


def _bwd_operands(name, q, k, v, key_bias, g, lse, delta, causal,
                  dropout_rate, dropout_seed, bias):
    """Shared checks of the two backward wrappers on CUDA tensors; returns
    (rate, key-bias rows, heads per row, (bias rows, div, rows), the
    instantiated head dim, the element-type suffix)."""
    rate = _check_args(q, k, causal, dropout_rate, dropout_seed, warn=False)
    B, N, Sq, D = q.shape
    Sk = k.shape[2]
    if tuple(g.shape) != tuple(q.shape):
        raise ValueError("%s: dO %r does not match q %r"
                         % (name, tuple(g.shape), tuple(q.shape)))
    for t in (lse, delta):
        if t.numel() != B * N * Sq:
            raise ValueError("%s: lse/delta need B*N*Sq = %d entries, got %r"
                             % (name, B * N * Sq, tuple(t.shape)))
    kb, bias_heads = _kernel_key_bias(key_bias, B, N, Sk)
    gbias = _kernel_bias(bias, B, N, Sq, Sk)
    width = _train_head_dim(name, D)
    et = _cuda_operands(name, (q, k, v, g), (kb, gbias[0], lse, delta))
    return rate, kb, bias_heads, gbias, width, et


def flash_bwd_dq(q, k, v, key_bias, g, lse, delta, causal=False, scale=None,
                 dropout_rate=0.0, dropout_seed=None, bias=None):
    """dq [B, N, Sq, D] of flash attention, from dO ``g``, the forward's
    ``lse`` and ``delta`` = rowsum(dO∘O) (both [B, N, Sq]), the raw
    dropout seed the forward was given and its general ``bias``.

    The wrapper of the ``flash_bwd_dq`` CUDA kernel. CPU tensors run the
    plain version (``flash_bwd_dq_plain``); CUDA tensors launch the
    kernel on the current stream (q/k/v/dO contiguous in one of fp32,
    bf16 and fp16, dq in their type; lse and delta fp32; any head_dim up
    to 256, zero-padded as in ``flash_attention_lse``; on the tensor
    cores, fp32 in split TF32) or raise.
    ``flash_bwd_dq.launches`` counts kernel launches."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, key_bias, g, lse, delta,
                                  causal=causal, scale=scale,
                                  dropout_rate=dropout_rate,
                                  dropout_seed=dropout_seed, bias=bias)
    rate, kb, bias_heads, (nb, div, rows), width, et = _bwd_operands(
        "flash_bwd_dq", q, k, v, key_bias, g, lse, delta, causal,
        dropout_rate, dropout_seed, bias)
    B, N, Sq, D = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    q, k, v, g = _pad_head_dim(width, q, k, v, g)
    on, seed, thresh, _keep, inv_keep = _dropout_args(rate, dropout_seed)
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq", et, q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), _ptr(kb), _ptr(nb), g.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), B * N, bias_heads, div, rows,
            Sq, k.shape[2], width, float(scale), int(bool(causal)), on, seed,
            thresh, inv_keep)
    _count(flash_bwd_dq)
    return dq if width == D else dq[..., :D].contiguous()


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, key_bias, g, lse, delta, causal=False,
                  scale=None, dropout_rate=0.0, dropout_seed=None, bias=None):
    """(dk, dv [B, N, Sk, D], dkey_bias [B·N, Sk] fp32) of flash
    attention, and dbias [G, Sq, Sk] fp32 after them when a general
    ``bias`` is given (summed over the heads that share a bias row);
    arguments as ``flash_bwd_dq``.

    The wrapper of the ``flash_bwd_dkv`` CUDA kernel. CPU tensors run the
    plain version (``flash_bwd_dkv_plain``); CUDA tensors launch the
    kernel on the current stream (q/k/v/dO contiguous in one of fp32,
    bf16 and fp16, dk and dv in their type; lse, delta, dkey_bias and
    dbias fp32; any head_dim up to 256, zero-padded as in
    ``flash_attention_lse``; on the tensor cores, fp32 in split TF32) or
    raise.
    dbias is zeroed first, then stored per head (G = B·N) or added
    atomically (shared rows, in no fixed order).
    ``flash_bwd_dkv.launches`` counts kernel launches."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, key_bias, g, lse, delta,
                                   causal=causal, scale=scale,
                                   dropout_rate=dropout_rate,
                                   dropout_seed=dropout_seed, bias=bias)
    rate, kb, bias_heads, (nb, div, rows), width, et = _bwd_operands(
        "flash_bwd_dkv", q, k, v, key_bias, g, lse, delta, causal,
        dropout_rate, dropout_seed, bias)
    B, N, Sq, D = q.shape
    Sk = k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    q, k, v, g = _pad_head_dim(width, q, k, v, g)
    on, seed, thresh, _keep, inv_keep = _dropout_args(rate, dropout_seed)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    dkb = torch.empty(B * N, Sk, dtype=torch.float32, device=q.device)
    dbias = None if nb is None else torch.zeros_like(nb)
    _launch("flash_bwd_dkv", et, q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), _ptr(kb), _ptr(nb), g.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), dkb.data_ptr(),
            _ptr(dbias), B * N, bias_heads, div, rows, Sq, Sk, width,
            float(scale), int(bool(causal)), on, seed, thresh, inv_keep)
    _count(flash_bwd_dkv)
    if width != D:
        dk, dv = dk[..., :D].contiguous(), dv[..., :D].contiguous()
    if dbias is None:
        return dk, dv, dkb
    return dk, dv, dkb, dbias


flash_bwd_dkv.launches = 0


def flash_attention_bwd_from_residuals(q, k, v, key_bias, seed, out, lse, g,
                                       causal=False, scale=None,
                                       dropout_rate=0.0, g_lse=None,
                                       bias=None):
    """Backward of flash attention driven by the forward's SAVED
    residuals (``out``, ``lse`` [B, N, Sq] and the raw dropout ``seed``,
    None when dropout was off) instead of a forward replay — the
    reference's entry of the same name (:991), which its
    ``flash_attention_grad`` op calls. ``g`` is dO; ``g_lse`` an optional
    lse cotangent (the reference's custom VJP folds it into delta; it
    has no interpreter flag here); ``bias`` the forward's general bias,
    which the reference's entry does not take (its op replays the forward
    for it). Returns (dq, dk, dv, dkey_bias [B·N, Sk] fp32), and dbias
    [G, Sq, Sk] fp32 after them when ``bias`` is given.

    CPU tensors run the plain version (``flash_attention_bwd_plain``).
    CUDA tensors compute delta = rowsum(dO∘O) with a torch op, as the
    reference leaves it to XLA, then launch ``flash_bwd_dq`` and
    ``flash_bwd_dkv``, or raise."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(
            q, k, v, key_bias, seed, out, lse, g, causal=causal, scale=scale,
            dropout_rate=dropout_rate, g_lse=g_lse, bias=bias)
    delta = _bwd_delta(out, g, g_lse)
    lse = lse.reshape(delta.shape)
    kw = dict(causal=causal, scale=scale, dropout_rate=dropout_rate,
              dropout_seed=seed, bias=bias)
    dq = flash_bwd_dq(q, k, v, key_bias, g, lse, delta, **kw)
    return (dq,) + flash_bwd_dkv(q, k, v, key_bias, g, lse, delta, **kw)


# Split-K of the decode kernels: the blocks of one (slot, head) row form
# one thread-block cluster, at most 8 (the portable cluster size), none
# shorter than _DECODE_MIN_SPLIT_KEYS keys (a few KB of K a block). The
# count is what the card measured fastest (PERF.md;
# ``tools/decode_variants.py``): the contiguous kernel's 256-thread
# blocks keep enough bytes in flight at one block an SM, so it takes no
# more blocks than the card has SMs; the paged kernel's 128-thread blocks
# want about three an SM, so it fills two waves. The wrappers read the
# SM count from the device; _DECODE_SMS (an H100 SXM's) is the default
# the CPU tests emulate.
_DECODE_MAX_SPLITS = 8
_DECODE_SMS = 132
_DECODE_MIN_SPLIT_KEYS = 64
# Each decode kernel's blocks as its source builds them: threads a block,
# key rows a thread group takes a tile (``kThreads``, ``kRowsPerGroup``
# in csrc/flash_decode.cu and flash_decode_paged.cu; the card tests hold
# them against each library's ``paddle_flash_decode_design``).
_DECODE_DESIGN = {"flash_decode": (256, 4), "flash_decode_paged": (128, 4)}


def _decode_splits(bh, s_len, blk=None, sms=_DECODE_SMS):
    """The decode kernels' split count for ``bh`` (slot, head) rows of
    ``s_len`` keys on a card of ``sms`` SMs: for the contiguous kernel the
    most splits with ``bh * splits`` <= ``sms`` blocks, for the paged one
    (``blk``: its pool's block size, whose splits take whole blocks) the
    fewest with ``bh * splits`` >= 2 ``sms``; at most 8, and cut until
    every split is at least ``_DECODE_MIN_SPLIT_KEYS`` keys long (1 where
    the row is shorter). A function of the shape alone, never of the
    data."""
    unit = blk or 1
    units = -(-s_len // unit)
    if blk is None:
        splits = sms // bh
    else:
        splits = -(-2 * sms // bh)
    splits = max(1, min(_DECODE_MAX_SPLITS, splits))
    while splits > 1 and -(-units // splits) * unit < _DECODE_MIN_SPLIT_KEYS:
        splits -= 1
    return splits


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _decode_ranges(s_len, splits, blk=None):
    """The key range [lo, hi) each split of a row takes, in split (cluster
    rank) order: ceil(s_len / splits) keys each, or for a paged row
    (``blk``) ceil(s_len / blk / splits) whole pool blocks each. A split
    past the row's end is empty (lo >= hi) and adds weight 0."""
    unit = blk or 1
    units = -(-s_len // unit)
    per = -(-units // splits)
    out = []
    for i in range(splits):
        lo = min(i * per, units)
        out.append((lo * unit, min(lo + per, units) * unit))
    return out


def _check_splits(name, splits):
    if not 1 <= splits <= _DECODE_MAX_SPLITS:
        raise ValueError("%s: splits must be 1..%d, got %d"
                         % (name, _DECODE_MAX_SPLITS, splits))


def flash_decode_attention(q, k, v, key_bias=None, scale=None):
    """Decode-mode attention: one query token per (slot, head), q
    [B, N, 1, D], against the fixed-shape cache k/v [B, N, S, D].
    ``key_bias`` ([B, S] / [B*N, S] / broadcastable) carries all masking
    (-1e4 at positions at or past each slot's live length). Forward only,
    fp32 accumulation, out in q's type.

    The wrapper of the ``flash_decode`` CUDA kernel. CPU tensors run the
    plain version (``flash_decode_attention_plain``); CUDA tensors launch
    the kernel on the current stream (q/k/v contiguous in one of fp32,
    bf16 and fp16, any head_dim from 1 to 256) or raise, with the split
    count ``_decode_splits`` gives. ``flash_decode_attention.launches``
    counts kernel launches."""
    return _flash_decode(q, k, v, key_bias, scale)


def _flash_decode(q, k, v, key_bias=None, scale=None, splits=None):
    """``flash_decode_attention`` at the kernel's split-K count
    ``splits`` (1..8; None: ``_decode_splits``), which the card tests
    force."""
    if q.device.type == "cpu":
        return flash_decode_attention_plain(q, k, v, key_bias=key_bias,
                                            scale=scale)
    B, N, Sq, D = q.shape
    Sk = k.shape[2]
    if Sq != 1:
        raise ValueError(
            "flash_decode_attention is the single-query path, got Sq=%d" % Sq)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    kb, bias_heads = _kernel_key_bias(key_bias, B, N, Sk)
    align = _decode_align("flash_decode", D, q.element_size())
    et = _cuda_operands("flash_decode", (q, k, v), (kb,), align)
    if splits is None:
        splits = _decode_splits(B * N, Sk, sms=_sm_count(q.device.index))
    _check_splits("flash_decode", splits)
    out = torch.empty_like(q)
    _launch("flash_decode", et, q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), _ptr(kb), out.data_ptr(), B * N, bias_heads, Sk, D,
            float(scale), splits)
    _count(flash_decode_attention)
    return out


flash_decode_attention.launches = 0

# a block stages its split's table entries in shared memory (4 bytes an
# entry: at most 32 KB beside the ring)
_MAX_TABLE_BLOCKS = 8192


def flash_decode_paged_attention(q, k_pool, v_pool, tables, key_bias=None,
                                 scale=None):
    """Decode-mode attention reading K/V through a block table: q
    [B, N, 1, D] (one live token per slot) against the shared pool
    ``k_pool``/``v_pool`` [blocks, N, blk, D], ``tables`` [B, MB] mapping
    slot ``b``'s logical block ``i`` to pool block ``tables[b, i]``.
    ``key_bias`` ([B, MB·blk] / [B*N, MB·blk] / broadcastable) carries
    all masking, sink-block garbage past the live length included.
    Forward only, fp32 accumulation, out in q's type.

    The wrapper of the ``flash_decode_paged`` CUDA kernel. CPU tensors
    run the plain version (``flash_decode_paged_attention_plain``); CUDA
    tensors launch the kernel on the current stream (q and pools
    contiguous in one of fp32, bf16 and fp16, an fp32 bias, int32
    contiguous tables — the caller builds them once per step, so nothing
    is cast here — any head_dim from 1 to 256) or raise, with the split
    count (in whole pool blocks) ``_decode_splits`` gives.
    ``flash_decode_paged_attention.launches`` counts kernel launches."""
    return _flash_decode_paged(q, k_pool, v_pool, tables, key_bias, scale)


def _flash_decode_paged(q, k_pool, v_pool, tables, key_bias=None,
                        scale=None, splits=None):
    """``flash_decode_paged_attention`` at the kernel's split-K count
    ``splits`` (1..8 whole-block ranges; None: ``_decode_splits``), which
    the card tests force."""
    if q.device.type == "cpu":
        return flash_decode_paged_attention_plain(
            q, k_pool, v_pool, tables, key_bias=key_bias, scale=scale)
    B, N, D, blk, MB = _check_paged(q, k_pool, tables)
    if tuple(v_pool.shape) != tuple(k_pool.shape):
        raise ValueError("k_pool %r and v_pool %r differ"
                         % (tuple(k_pool.shape), tuple(v_pool.shape)))
    if tables.dtype != torch.int32 or not tables.is_contiguous():
        raise TypeError("flash_decode_paged kernel needs contiguous int32 "
                        "tables, got %s" % tables.dtype)
    if tables.device != q.device:
        raise ValueError("flash_decode_paged: tables on %s, q on %s"
                         % (tables.device, q.device))
    if MB > _MAX_TABLE_BLOCKS:
        raise ValueError("flash_decode_paged kernel takes at most %d "
                         "logical blocks per slot, got %d"
                         % (_MAX_TABLE_BLOCKS, MB))
    S = MB * blk
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    kb, bias_heads = _kernel_key_bias(key_bias, B, N, S)
    align = _decode_align("flash_decode_paged", D, q.element_size())
    et = _cuda_operands("flash_decode_paged", (q, k_pool, v_pool), (kb,),
                        align)
    if splits is None:
        splits = _decode_splits(B * N, S, blk, _sm_count(q.device.index))
    _check_splits("flash_decode_paged", splits)
    out = torch.empty_like(q)
    _launch("flash_decode_paged", et, q.device, q.data_ptr(),
            k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(),
            _ptr(kb), out.data_ptr(), B * N, N, bias_heads, MB, blk,
            k_pool.shape[0], D, float(scale), splits)
    _count(flash_decode_paged_attention)
    return out


flash_decode_paged_attention.launches = 0
