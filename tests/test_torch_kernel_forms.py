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
  plain version's.

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
