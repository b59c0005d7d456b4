"""The plain versions of the port's flash kernels at the element types and
head dims the kernels take beyond fp32 at D <= 128, held against the JAX
package's Pallas kernels in interpret mode on the CPU:

- the decode kernels (contiguous and paged) in bf16 and fp16. Both sides
  form scores in fp32 from the same low-precision operands; the Pallas
  kernel (as the CUDA kernels) rounds the running, unnormalised p before
  P·V, the plain version the normalised one, so out is held to
  ``tools/lowp_limits.out_bound`` at rate 0: per element, eps times the
  sum of p·|v| plus eps·|out|, the worst case of the two sides'
  roundings;
- the decode kernels in fp32 at head dims off the multiples of 8 and past
  128 (20, 200): atol 1e-5, as the fp32 decode test (sums of a few dozen
  fp32 terms of magnitude ~1);
- the training forward and both backward kernels in fp32 at D = 200,
  which the CUDA wrappers zero-pad to 256: atol 1e-5, as the other fp32
  training tests;
- the training wrappers' head-dim rule: any D up to 256 runs at the next
  instantiated width, past 256 they raise;
- the fp32 forward's split-TF32 arithmetic (``csrc/flash_fwd.cu``),
  emulated in numpy: each fp32 operand rounded to nearest (ties away) at
  TF32's 10 mantissa bits as ``big`` and its remainder as ``small``, three
  products with ``small·small`` dropped, fp32 sums, through the kernel's
  tiled online softmax. It must stay within the card's forward limit
  (atol 2e-5 / rtol 1e-4) of the Pallas forward, and a single TF32
  product must not: the limit tells the two designs apart;
- the fp32 backward's split-TF32 arithmetic (``csrc/flash_bwd_dq.cu``,
  ``csrc/flash_bwd_dkv.cu``), emulated the same way over the kernels'
  key and query tiles: dq, dk and dv within the card's backward limit
  (atol 1e-4 / rtol 1e-4) of the Pallas backward, a single TF32 product
  outside it, and Σ over keys of dk (exactly 0) as near zero as the fp32
  plain version's;
- the split-K decode kernels' arithmetic (``csrc/flash_decode.cuh``),
  emulated in numpy at the split counts the card runs
  (``_decode_splits``) and at edge counts: each split's tiles, its thread
  groups' online softmax with p rounded to the element type against the
  group's running max, the groups' merge and the splits' merge in
  order, held against the Pallas kernels (or, at the serving shapes,
  the JAX package's jnp fallback) in fp32 and bf16; and the split rule
  itself (shapes only, pool-block boundaries, the serving counts).

Inputs are made with numpy from a seed.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.tools import lowp_limits as lowp
from test_torch_cpu_math import pin_vector_math

jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")

pin_vector_math(2)  # 2 threads, vector math set up on one (see there)

ATOL = RTOL = 1e-5
_DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16),
           "fp16": (torch.float16, jnp.float16)}


def _randn(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def _decode_inputs(rs, B, N, S, D):
    """q [B, N, 1, D], k/v [B, N, S, D] and a bias with mixed live
    lengths and one fully masked slot."""
    q, k, v = _randn(rs, B, N, 1, D), _randn(rs, B, N, S, D), \
        _randn(rs, B, N, S, D)
    kb = np.zeros((B, S), np.float32)
    for b, n in enumerate((1, S // 2 + 1, S, 0)[:B]):
        kb[b, n:] = -1e4
    return q, k, v, kb


def _paged_inputs(rs, B, N, D, blk, MB):
    """q, pools [B·MB + 1, N, blk, D], a permuted table (two slots
    sharing their first block, one all-sink slot) and its bias."""
    q = _randn(rs, B, N, 1, D)
    k_pool, v_pool = (_randn(rs, B * MB + 1, N, blk, D) for _ in range(2))
    tables = (rs.permutation(B * MB) + 1).reshape(B, MB).astype(np.int32)
    tables[1, 0] = tables[0, 0]
    tables[-1] = 0
    kb = np.zeros((B, MB * blk), np.float32)
    for b, n in enumerate((3, MB * blk // 2, MB * blk, 0)[:B]):
        kb[b, n:] = -1e4
    return q, k_pool, v_pool, tables, kb


def _low(arrays, jdt, tdt):
    """The arrays rounded to the low type, as JAX and torch tensors."""
    j = [jnp.asarray(a, jdt) for a in arrays]
    t = [torch.from_numpy(np.asarray(a, np.float32)).to(tdt) for a in j]
    return j, t


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("D", [8, 20, 64, 200])
def test_flash_decode_plain_low_precision_matches_jax_kernel(dtype, D):
    tdt, jdt = _DTYPES[dtype]
    rs = np.random.RandomState(D + len(dtype))
    q, k, v, kb = _decode_inputs(rs, 4, 2, 40, D)
    (jq, jk, jv), (tq, tk, tv) = _low((q, k, v), jdt, tdt)
    want = jfa.flash_decode_attention(jq, jk, jv, key_bias=jnp.asarray(kb),
                                      interpret=True)
    assert want.dtype == jdt
    tkb = torch.from_numpy(kb)
    got = tfa.flash_decode_attention(tq, tk, tv, key_bias=tkb)
    assert got.dtype == tdt and got.shape == tq.shape
    want_t = torch.from_numpy(np.asarray(want, np.float32))
    bound = lowp.out_bound(tdt, tq, tk, tv, want_t, key_bias=tkb)
    lowp.check("decode out", {
        "elem": lowp.out_ratios(tdt, got, want_t, bound)["elem"]})


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("D,blk", [(8, 4), (20, 16), (64, 16), (200, 8)])
def test_flash_decode_paged_plain_low_precision_matches_jax_kernel(dtype, D,
                                                                   blk):
    tdt, jdt = _DTYPES[dtype]
    rs = np.random.RandomState(D * 3 + blk)
    B, N, MB = 4, 2, 5
    q, k_pool, v_pool, tables, kb = _paged_inputs(rs, B, N, D, blk, MB)
    (jq, jk, jv), (tq, tk, tv) = _low((q, k_pool, v_pool), jdt, tdt)
    want = jfa.flash_decode_paged_attention(
        jq, jk, jv, jnp.asarray(tables), key_bias=jnp.asarray(kb),
        interpret=True)
    tt, tkb = torch.from_numpy(tables), torch.from_numpy(kb)
    got = tfa.flash_decode_paged_attention(tq, tk, tv, tt, key_bias=tkb)
    assert got.dtype == tdt and got.shape == tq.shape
    want_t = torch.from_numpy(np.asarray(want, np.float32))
    rows_k, rows_v = (tfa.gather_paged_rows(p, tt.long()) for p in (tk, tv))
    bound = lowp.out_bound(tdt, tq, rows_k, rows_v, want_t, key_bias=tkb)
    lowp.check("paged decode out", {
        "elem": lowp.out_ratios(tdt, got, want_t, bound)["elem"]})


@pytest.mark.parametrize("D", [20, 200])
def test_flash_decode_plain_fp32_any_head_dim_matches_jax_kernel(D):
    rs = np.random.RandomState(D)
    q, k, v, kb = _decode_inputs(rs, 4, 3, 24, D)
    want = jfa.flash_decode_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), key_bias=jnp.asarray(kb),
                                      interpret=True)
    tq, tk, tv, tkb = (torch.from_numpy(a) for a in (q, k, v, kb))
    _close(tfa.flash_decode_attention(tq, tk, tv, key_bias=tkb), want)
    _close(tfa.flash_decode_attention_plain(tq, tk, tv, key_bias=tkb), want)


@pytest.mark.parametrize("D", [20, 200])
def test_flash_decode_paged_plain_fp32_any_head_dim_matches_jax_kernel(D):
    rs = np.random.RandomState(D + 1)
    q, k_pool, v_pool, tables, kb = _paged_inputs(rs, 4, 2, D, 4, 6)
    want = jfa.flash_decode_paged_attention(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(tables), key_bias=jnp.asarray(kb), interpret=True)
    tq, tk, tv, tt, tkb = (torch.from_numpy(a)
                           for a in (q, k_pool, v_pool, tables, kb))
    _close(tfa.flash_decode_paged_attention(tq, tk, tv, tt, key_bias=tkb),
           want)


@pytest.mark.parametrize("causal,Sq,Sk,rate", [(True, 24, 24, 0.0),
                                               (True, 20, 20, 0.1),
                                               (False, 13, 30, 0.0)])
def test_flash_training_plain_d200_matches_jax_kernels(causal, Sq, Sk, rate):
    """D = 200 (the CUDA wrappers pad it to 256): the plain forward
    against the Pallas forward, and the plain backward against the
    Pallas backward kernels from the JAX forward's residuals."""
    B, N, D = 1, 2, 200
    rs = np.random.RandomState(Sq + Sk)
    q, k, v = _randn(rs, B, N, Sq, D), _randn(rs, B, N, Sk, D), \
        _randn(rs, B, N, Sk, D)
    g = _randn(rs, B, N, Sq, D)
    kb = np.zeros((B, Sk), np.float32)
    kb[0, Sk - 5:] = -1e4
    seed = 9191 if rate else None
    jq, jk, jv, jkb = (jnp.asarray(a) for a in (q, k, v, kb))
    j_out, j_lse = jfa.flash_attention_lse(
        jq, jk, jv, key_bias=jkb, causal=causal, dropout_rate=rate,
        dropout_seed=seed, interpret=True)
    want = jfa.flash_attention_bwd_from_residuals(
        jq, jk, jv, jkb, seed, j_out, j_lse, jnp.asarray(g), causal=causal,
        dropout_rate=rate, interpret=True)
    tq, tk, tv, tg, tkb = (torch.from_numpy(a) for a in (q, k, v, g, kb))
    kw = dict(causal=causal, dropout_rate=rate)
    out, lse = tfa.flash_attention_lse(tq, tk, tv, key_bias=tkb,
                                       dropout_seed=seed, **kw)
    _close(out, j_out)
    _close(lse, j_lse)
    got = tfa.flash_attention_bwd_from_residuals(
        tq, tk, tv, tkb, seed, torch.from_numpy(np.array(j_out)),
        torch.from_numpy(np.array(j_lse)), tg, **kw)
    for name, a, w in zip(("dq", "dk", "dv", "dkey_bias"), got, want):
        assert tuple(a.shape) == tuple(np.shape(w)), name
        _close(a, w)


@pytest.mark.parametrize("D,width", [(1, 32), (16, 32), (48, 64), (64, 64),
                                     (136, 256), (200, 256), (256, 256)])
def test_train_head_dim_pads_up_to_256(D, width):
    assert tfa._train_head_dim("flash_fwd", D) == width


@pytest.mark.parametrize("D", [0, 264, 512])
def test_train_head_dim_raises_past_256(D):
    with pytest.raises(ValueError):
        tfa._train_head_dim("flash_fwd", D)


@pytest.mark.parametrize("D,size,align", [(8, 2, 8), (20, 2, 2), (64, 4, 16),
                                          (200, 2, 8), (3, 4, 4),
                                          (256, 2, 8)])
def test_decode_alignment_by_head_dim(D, size, align):
    """Multiples of 8 read four elements at a time; any other D reads
    element by element."""
    assert tfa._decode_align("flash_decode", D, size) == align


@pytest.mark.parametrize("D", [0, 264])
def test_decode_head_dim_raises_outside_1_to_256(D):
    with pytest.raises(ValueError):
        tfa._decode_align("flash_decode", D, 4)


def _tf32(x):
    """fp32 -> TF32 as ``cvt.rna.tf32.f32``: round to nearest, ties away
    from zero, at 10 mantissa bits (the low 13 bits cleared)."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _mm_tf32(a, b, split):
    """a @ b (fp32, [.., m, k] x [.., k, n]) as the tensor cores take it:
    with ``split``, a_small·b_big + a_big·b_small + a_big·b_big summed in
    fp32 in that order (a product of two TF32 values is exact in fp32);
    without, one product of the TF32-rounded operands."""
    ab, bb = _tf32(a), _tf32(b)
    if not split:
        return np.matmul(ab, bb)
    asm, bsm = _tf32(a - ab), _tf32(b - bb)
    out = np.matmul(asm, bb)
    out += np.matmul(ab, bsm)
    out += np.matmul(ab, bb)
    return out


def _tf32_forward(q, k, v, kb, causal, split, tile=16):
    """The fp32 forward kernel's math in numpy: S = Q·Kᵀ and O += P·V on
    the tensor cores (``_mm_tf32``), the reference's online softmax over
    key tiles (masked scores -1e30, ``l`` of the undropped p clamped at
    1e-30); returns (out, lse)."""
    B, N, Sq, D = q.shape
    Sk = k.shape[2]
    scale = np.float32(1.0 / np.sqrt(D))
    m = np.full((B, N, Sq, 1), -1e30, np.float32)
    l = np.zeros((B, N, Sq, 1), np.float32)
    acc = np.zeros((B, N, Sq, D), np.float32)
    rows = np.arange(Sq)[:, None]
    for k0 in range(0, Sk, tile):
        cols = np.arange(k0, min(k0 + tile, Sk))[None, :]
        s = _mm_tf32(q, np.swapaxes(k[:, :, k0:k0 + tile], -1, -2), split)
        s = s * scale + kb[:, None, None, k0:k0 + tile]
        if causal:
            s = np.where(cols > rows, np.float32(-1e30), s)
        m_new = np.maximum(m, s.max(-1, keepdims=True))
        alpha = np.exp(m - m_new)
        p = np.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdims=True)
        acc = acc * alpha + _mm_tf32(p, v[:, :, k0:k0 + tile], split)
        m = m_new
    l = np.maximum(l, np.float32(1e-30))
    return acc / l, (m + np.log(l))[..., 0]


@pytest.mark.parametrize("D", [32, 64])
def test_split_tf32_forward_emulation_matches_jax_kernel(D):
    B, N, S = 2, 2, 40
    rs = np.random.RandomState(D + 3)
    q, k, v = (_randn(rs, B, N, S, D) for _ in range(3))
    kb = np.zeros((B, S), np.float32)
    kb[1, 29:] = -1e4
    want_out, want_lse = jfa.flash_attention_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        key_bias=jnp.asarray(kb), causal=True, interpret=True)
    want_out, want_lse = np.asarray(want_out), np.asarray(want_lse)
    out, lse = _tf32_forward(q, k, v, kb, True, split=True)
    _close(out, want_out, atol=2e-5, rtol=1e-4)
    _close(lse, want_lse, atol=2e-5, rtol=1e-4)
    one_out, one_lse = _tf32_forward(q, k, v, kb, True, split=False)
    assert not np.allclose(one_out, want_out, atol=2e-5, rtol=1e-4)


def _tf32_backward(q, k, v, g, kb, lse, delta, causal, split, tile=8):
    """The fp32 backward kernels' math in numpy (``csrc/flash_bwd_dq.cu``,
    ``csrc/flash_bwd_dkv.cu``): S, dP and each tile's contribution to dq,
    dk and dv on the tensor cores (``_mm_tf32``), p = exp(s − lse) and
    ds = p∘(dp − delta) in fp32. The dq pass sweeps key tiles and the dk/dv
    pass query tiles of ``tile`` rows, one k-step of the kernels' ds·K,
    dsᵀ·Q and Pᵀ·dO products; each tile's split product is summed from
    zero and added to the running sum in fp32. Returns (dq, dk, dv)."""
    B, N, Sq, D = q.shape
    Sk = k.shape[2]
    scale = np.float32(1.0 / np.sqrt(D))
    lse, delta = lse[..., None], delta[..., None]
    mm = lambda a, b: _mm_tf32(a, b, split)  # noqa: E731
    kT = lambda x: np.swapaxes(x, -1, -2)    # noqa: E731

    def p_ds(s, dp, q0, k0, bias, lse_t, delta_t):
        """p and ds of queries q0.. by keys k0.. from scores and dP."""
        s = s * scale + bias
        if causal:
            rows = np.arange(q0, q0 + s.shape[-2])[:, None]
            cols = np.arange(k0, k0 + s.shape[-1])[None, :]
            s = np.where(cols > rows, np.float32(-1e30), s)
        p = np.exp(s - lse_t).astype(np.float32)
        return p, p * (dp - delta_t)

    dq = np.zeros_like(q)
    for k0 in range(0, Sk, tile):
        kt, vt = k[:, :, k0:k0 + tile], v[:, :, k0:k0 + tile]
        _p, ds = p_ds(mm(q, kT(kt)), mm(g, kT(vt)), 0, k0,
                      kb[:, None, None, k0:k0 + tile], lse, delta)
        dq += mm(ds, kt)
    dk, dv = np.zeros_like(k), np.zeros_like(v)
    for q0 in range(0, Sq, tile):
        qt, gt = q[:, :, q0:q0 + tile], g[:, :, q0:q0 + tile]
        p, ds = p_ds(mm(qt, kT(k)), mm(gt, kT(v)), q0, 0,
                     kb[:, None, None, :], lse[:, :, q0:q0 + tile],
                     delta[:, :, q0:q0 + tile])
        dv += mm(kT(p), gt)
        dk += mm(kT(ds), qt)
    return dq * scale, dk * scale, dv


# Σ over keys of dk is exactly 0 (softmax ignores a shift shared by all
# keys, so the k-projection biases' gradient is 0): the emulated split
# kernels' sum must stay within this factor of the fp32 plain version's
# rounding noise (both read 2e-7 to 4e-7 of dk's norm here, the emulation
# 0.7-0.8 of the plain version's).
_ZERO_SUM_FACTOR = 4.0


@pytest.mark.parametrize("D", [32, 64])
def test_split_tf32_backward_emulation_matches_jax_kernel(D):
    """The fp32 backward's split-TF32 arithmetic, emulated in numpy
    (``_tf32_backward``), against the Pallas backward kernels in
    interpret mode from the JAX forward's residuals, at the card's
    backward limit (atol 1e-4 / rtol 1e-4); a single TF32 product must
    miss that limit. Causal, a ragged key bias."""
    B, N, S = 2, 2, 40
    rs = np.random.RandomState(D + 7)
    q, k, v, g = (_randn(rs, B, N, S, D) for _ in range(4))
    kb = np.zeros((B, S), np.float32)
    kb[1, 29:] = -1e4
    jq, jk, jv, jkb = (jnp.asarray(a) for a in (q, k, v, kb))
    j_out, j_lse = jfa.flash_attention_lse(jq, jk, jv, key_bias=jkb,
                                           causal=True, interpret=True)
    want = jfa.flash_attention_bwd_from_residuals(
        jq, jk, jv, jkb, None, j_out, j_lse, jnp.asarray(g), causal=True,
        interpret=True)
    out, lse = np.asarray(j_out), np.asarray(j_lse)
    delta = (g * out).sum(-1)
    got = _tf32_backward(q, k, v, g, kb, lse, delta, True, split=True)
    for a, w in zip(got, want):          # dq, dk, dv (dkey_bias unused)
        _close(a, w, atol=1e-4, rtol=1e-4)
    one = _tf32_backward(q, k, v, g, kb, lse, delta, True, split=False)
    assert not all(np.allclose(a, w, atol=1e-4, rtol=1e-4)
                   for a, w in zip(one, want))
    plain_dk = tfa.flash_bwd_dkv_plain(
        *(torch.from_numpy(np.array(a, np.float32))
          for a in (q, k, v, kb, g, lse, delta)), causal=True)[0].numpy()
    zero_sum = lambda dk: np.linalg.norm(dk.astype(np.float64).sum(2))  # noqa
    assert zero_sum(got[1]) <= _ZERO_SUM_FACTOR * zero_sum(plain_dk)


# --- the split-K decode kernels (csrc/flash_decode.cuh) ---
#
# The kernels cut each (slot, head) row's keys into ``_decode_splits``
# ranges (``_decode_ranges``), one block of a thread-block cluster each.
# A block reads its range in tiles; its threads (``_DECODE_DESIGN``: 256
# for the contiguous kernel, 128 for the paged one) work in groups of
# ``lanes`` threads, a group taking rows g, g + groups, ... of a tile (as
# many as the kernel's rows a group) and keeping an online-softmax state
# over the tiles; the groups' states merge in group order, then the
# splits' in rank order. ``_split_decode`` repeats that arithmetic in
# numpy; p rounds to the element type against the group's running max.


def _decode_tile(kernel, D, itemsize):
    """(groups, rows a group, tile rows) of ``kernel`` at head dim D:
    16-byte pieces where a row is whole pieces (else four elements a
    piece), one piece a lane (two for fp32 past D = 128 and on the
    element path), lanes the next power of two of the pieces, the
    kernel's threads and rows a group (``_DECODE_DESIGN``)."""
    threads, rows = tfa._DECODE_DESIGN[kernel]
    vec = D * itemsize % 16 == 0
    chunks = -(-D // (16 // itemsize if vec else 4))
    pieces = 2 if not vec or (itemsize == 4 and D > 128) else 1
    lanes = 1
    while lanes < -(-chunks // pieces):
        lanes *= 2
    groups = threads // lanes
    return groups, rows, rows * groups


def _split_tiles(lo, hi, tile, blk):
    """(first key, rows) of each tile of the split [lo, hi): ``tile``
    keys each, or for a paged row whole pool blocks that fit a tile (a
    piece of one when a block is longer)."""
    if hi <= lo:
        return []
    if not blk:
        return [(j, min(tile, hi - j)) for j in range(lo, hi, tile)]
    if blk <= tile:
        per = (tile // blk) * blk
        return [(j, min(per, hi - j)) for j in range(lo, hi, per)]
    return [(b + j, min(tile, blk - j)) for b in range(lo, hi, blk)
            for j in range(0, blk, tile)]


def _round(x, dtype):
    return x if dtype is None else x.astype(dtype).astype(np.float32)


def _merge(m, l, acc, axis):
    """States (m, l, acc) merged along ``axis`` in index order."""
    m_all = m.max(axis)
    w = np.exp(m - np.expand_dims(m_all, axis))
    l_all = np.zeros_like(m_all)
    out = np.zeros_like(np.take(acc, 0, axis))
    for i in range(m.shape[axis]):
        l_all = l_all + np.take(l * w, i, axis)
        out = out + np.take(acc, i, axis) * np.take(w, i, axis)[..., None]
    return m_all, l_all, out


def _split_decode(q, k, v, kb, splits, blk=None, dtype=None):
    """The split-K kernels' arithmetic in numpy: q [B, N, 1, D], k/v the
    logical rows [B, N, S, D] (gathered through the tables for a paged
    row), kb [B, S]; ``dtype`` (a numpy low-precision type, None for
    fp32) is what q/k/v hold and what p rounds to before P·V."""
    B, N, _, D = q.shape
    S = k.shape[2]
    groups, rpg, tile = _decode_tile(
        "flash_decode" if blk is None else "flash_decode_paged", D,
        4 if dtype is None else 2)
    scale = np.float32(1.0 / np.sqrt(D))
    s_all = np.einsum("bnd,bnsd->bns", q[:, :, 0], k).astype(np.float32)
    s_all = s_all * scale + kb[:, None, :]
    states = []
    for lo, hi in tfa._decode_ranges(S, splits, blk):
        m = np.full((B, N, groups), -1e30, np.float32)
        l = np.zeros((B, N, groups), np.float32)
        acc = np.zeros((B, N, groups, D), np.float32)
        for j0, rows in _split_tiles(lo, hi, tile, blk):
            r = np.arange(rpg)[:, None] * groups + np.arange(groups)[None]
            ok = r < rows
            key = np.where(ok, j0 + r, 0)                 # [rpg, groups]
            sc = np.where(ok, s_all[:, :, key], np.float32(-1e30))
            mx = np.maximum(m, sc.max(2))
            alpha = np.exp(m - mx)
            p = np.where(ok, np.exp(sc - mx[:, :, None]), np.float32(0))
            psum = np.zeros_like(l)
            for i in range(rpg):
                psum = psum + p[:, :, i]
            l = l * alpha + psum
            acc = acc * alpha[..., None]
            pr = _round(p, dtype)
            for i in range(rpg):
                acc = acc + pr[:, :, i, :, None] * v[:, :, key[i]]
            m = mx
        states.append(_merge(m, l, acc, 2))
    m, l, acc = (np.stack(x, 2) for x in zip(*states))
    _m, l, out = _merge(m, l, acc, 2)
    out = out / np.maximum(l, np.float32(1e-30))[..., None]
    return _round(out, dtype)[:, :, None]


# A fully masked slot's scores sit near -1e4, where fp32 values are 2^-10
# apart: a last-bit difference in q·k (numpy's summation order against
# XLA's) can round a score the other way and move its weight by ~0.1%.
# The largest such difference these cases read is 4.5e-5 (``blk64``: one
# heavy key's score rounded the other way); such a slot is held to atol
# 1e-4 / rtol 1e-4, every other slot to atol 1e-5 / rtol 1e-5.
def _close_fp32_by_slot(got, want, kb):
    masked = (kb < -1e3).all(1)
    want = np.asarray(want, np.float32)
    _close(got[~masked], want[~masked], atol=1e-5, rtol=1e-5)
    _close(got[masked], want[masked], atol=1e-4, rtol=1e-4)


def _decode_bias(B, S, live):
    kb = np.zeros((B, S), np.float32)
    for b in range(B):
        kb[b, live[b % len(live)]:] = -1e4
    return kb


# (name, B, N, S, D, split count or None for ``_decode_splits``, live
# lengths (0: a fully masked slot), run the Pallas kernel in interpret
# mode or (serving shapes) the JAX package's jnp fallback)
_SPLIT_CASES = [
    ("serving", 8, 12, 1024, 64, None, (1, 17, 512, 1024, 100, 333, 1000, 0),
     False),
    ("s1", 4, 3, 1, 64, None, (1, 1, 1, 0), True),
    ("s1_forced_splits", 4, 3, 1, 16, 4, (1, 1, 1, 0), True),
    ("ragged", 4, 3, 300, 64, None, (1, 151, 300, 0), True),
    ("ragged_7", 2, 3, 300, 20, 7, (299, 0), True),
    ("past_end", 4, 3, 5, 64, 4, (5, 3, 1, 0), True),
    ("d200", 2, 2, 70, 200, 8, (70, 1), True),
]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", _SPLIT_CASES, ids=[c[0] for c in
                                                    _SPLIT_CASES])
def test_split_decode_emulation_matches_jax_kernel(case, dtype):
    """The contiguous kernel's split arithmetic (``_split_decode``) at the
    split counts the card runs: the serving shape and edge shapes (one
    key, 300 keys in 4 and 7 splits, splits wholly past the end, a fully
    masked slot). fp32 within atol 1e-5 / rtol 1e-5 of the JAX kernel
    (sums of at most 1024 fp32 terms of magnitude ~1, merged in another
    order), a fully masked slot within atol 1e-4 / rtol 1e-4; bf16 within
    ``lowp_limits.out_bound``."""
    _name, B, N, S, D, splits, live, interpret = case
    rs = np.random.RandomState(S + D)
    q, k, v = _randn(rs, B, N, 1, D), _randn(rs, B, N, S, D), \
        _randn(rs, B, N, S, D)
    kb = _decode_bias(B, S, live)
    splits = splits or tfa._decode_splits(B * N, S)
    low = dtype == "bf16"
    jdt = jnp.bfloat16 if low else jnp.float32
    j = [jnp.asarray(a, jdt) for a in (q, k, v)]
    want = jfa.flash_decode_attention(*j, key_bias=jnp.asarray(kb),
                                      interpret=True if interpret else None)
    a = [np.asarray(x, np.float32) for x in j]
    got = _split_decode(*a, kb, splits, dtype=jnp.bfloat16 if low else None)
    if not low:
        _close_fp32_by_slot(got, want, kb)
        return
    t = [torch.from_numpy(x).to(torch.bfloat16) for x in a]
    want_t = torch.from_numpy(np.asarray(want, np.float32))
    bound = lowp.out_bound(torch.bfloat16, *t, want_t,
                           key_bias=torch.from_numpy(kb))
    lowp.check("split decode", {"elem": lowp.out_ratios(
        torch.bfloat16, torch.from_numpy(got).to(torch.bfloat16), want_t,
        bound)["elem"]})


# (name, B, N, MB, blk, D, split count or None, run interpret mode)
_PAGED_SPLIT_CASES = [
    ("serving", 8, 12, 64, 16, 64, None, False),
    ("blk64", 4, 3, 6, 64, 64, None, True),
    ("blk4_8", 4, 3, 6, 4, 16, 8, True),
    ("blk1", 4, 2, 40, 1, 64, 3, True),
]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", _PAGED_SPLIT_CASES,
                         ids=[c[0] for c in _PAGED_SPLIT_CASES])
def test_paged_split_decode_emulation_matches_jax_kernel(case, dtype):
    """The paged kernel's split arithmetic on the logical rows, split on
    pool-block boundaries: a permuted table with two slots sharing a
    prefix block and an all-sink, fully masked slot; the serving shape
    (64 blocks of 16), blocks longer than a tile (64), 8 splits of 4-key
    blocks and 3 splits of 1-key blocks. Limits as the contiguous
    test's."""
    _name, B, N, MB, blk, D, splits, interpret = case
    rs = np.random.RandomState(MB * 3 + blk + D)
    q, k_pool, v_pool, tables, _kb = _paged_inputs(rs, B, N, D, blk, MB)
    S = MB * blk
    kb = _decode_bias(B, S, (S, 17, S // 2 + 1, 0)[:B - 1] + (0,))
    splits = splits or tfa._decode_splits(B * N, S, blk)
    for lo, hi in tfa._decode_ranges(S, splits, blk):
        assert lo % blk == 0 and hi % blk == 0
    low = dtype == "bf16"
    jdt = jnp.bfloat16 if low else jnp.float32
    j = [jnp.asarray(a, jdt) for a in (q, k_pool, v_pool)]
    want = jfa.flash_decode_paged_attention(
        *j, jnp.asarray(tables), key_bias=jnp.asarray(kb),
        interpret=True if interpret else None)
    a = [np.asarray(x, np.float32) for x in j]
    tt = torch.from_numpy(tables).long()
    rows = [tfa.gather_paged_rows(torch.from_numpy(p.copy()), tt).numpy()
            for p in a[1:]]
    got = _split_decode(a[0], *rows, kb, splits, blk,
                        dtype=jnp.bfloat16 if low else None)
    if not low:
        _close_fp32_by_slot(got, want, kb)
        return
    t = [torch.from_numpy(x).to(torch.bfloat16) for x in [a[0]] + rows]
    want_t = torch.from_numpy(np.asarray(want, np.float32))
    bound = lowp.out_bound(torch.bfloat16, *t, want_t,
                           key_bias=torch.from_numpy(kb))
    lowp.check("paged split decode", {"elem": lowp.out_ratios(
        torch.bfloat16, torch.from_numpy(got).to(torch.bfloat16), want_t,
        bound)["elem"]})


@pytest.mark.parametrize("bh,s_len,blk", [(96, 1024, None), (96, 1024, 16),
                                          (12, 300, None), (12, 20, 4),
                                          (1000, 1024, None), (4, 1, None),
                                          (12, 1024, 64), (3, 8192, 16)])
def test_decode_splits_are_shape_functions_on_block_boundaries(bh, s_len,
                                                               blk):
    """``_decode_splits`` takes shapes only (the same count on every
    call), stays within one portable cluster (1..8), never cuts a split
    below 64 keys unless the row has one split, and ``_decode_ranges``
    covers the row in order, on pool-block boundaries for a paged row."""
    splits = tfa._decode_splits(bh, s_len, blk)
    assert splits == tfa._decode_splits(bh, s_len, blk)
    assert 1 <= splits <= tfa._DECODE_MAX_SPLITS
    ranges = tfa._decode_ranges(s_len, splits, blk)
    unit = blk or 1
    assert len(ranges) == splits and ranges[0][0] == 0
    assert ranges[-1][1] == -(-s_len // unit) * unit
    for (lo, hi), (lo2, _hi2) in zip(ranges, ranges[1:]):
        assert hi == lo2
    for lo, hi in ranges:
        assert lo % unit == 0 and hi % unit == 0
        assert splits == 1 or hi - lo >= tfa._DECODE_MIN_SPLIT_KEYS \
            or hi == ranges[-1][1]


def test_decode_splits_at_the_serving_shapes():
    """At the serving shapes (96 (slot, head) rows of 1024 keys, and 64
    blocks of 16) the contiguous kernel takes no more blocks than an
    H100's 132 SMs (one a row), and the paged kernel at least two waves
    of them, the counts the card measured fastest."""
    assert 96 * tfa._decode_splits(96, 1024) <= 132
    assert 96 * tfa._decode_splits(96, 1024, 16) >= 2 * 132
    # a short batch spreads its rows over the SMs
    assert tfa._decode_splits(12, 1024) == 8
