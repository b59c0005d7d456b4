"""The port's attention kernels' plain versions and op lowerings
(``paddle_tpu_torch``) held against the JAX package on the CPU.

Same inputs, made with numpy from a seed, go through the JAX function —
the Pallas kernel in interpret mode where the reference has one — and
through the port's counterpart, which on CPU tensors runs its plain
PyTorch version. fp32 throughout; atol 1e-5 (both sides sum over at most
a few dozen fp32 terms of magnitude ~1, so honest differences are
~1e-6 while a masking or indexing error is O(0.1)).
"""

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as fluid
from paddle_tpu_torch.fluid.ops import math_ops as tmath
from paddle_tpu_torch.fluid.ops import nn_ops as tnn
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.tools import lowp_limits as lowp
from test_torch_cpu_math import pin_vector_math

# the reference package re-exports the function under the module's name
jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")

pin_vector_math(2)  # 2 threads, vector math set up on one (see there)

ATOL = RTOL = 1e-5


def _randn(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=rtol)


# (B, N, Sq, Sk, D, causal, live key lengths per batch row or None)
_FWD_CASES = {
    "plain": (2, 2, 32, 32, 16, False, None),
    "causal": (2, 2, 32, 32, 16, True, None),
    "key_padding": (2, 3, 24, 24, 16, False, (24, 9)),
    "causal_ragged_padded": (2, 2, 37, 37, 16, True, (37, 20)),
    "cross_ragged": (1, 2, 13, 40, 32, False, (31,)),
}


@pytest.mark.parametrize("case", sorted(_FWD_CASES))
def test_flash_attention_lse_plain_matches_jax_kernel(case):
    B, N, Sq, Sk, D, causal, live = _FWD_CASES[case]
    rs = np.random.RandomState(len(case))
    q, k, v = _randn(rs, B, N, Sq, D), _randn(rs, B, N, Sk, D), \
        _randn(rs, B, N, Sk, D)
    kb = None
    if live is not None:
        kb = np.zeros((B, Sk), np.float32)
        for b, n in enumerate(live):
            kb[b, n:] = -1e4
    j_out, j_lse = jfa.flash_attention_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        key_bias=None if kb is None else jnp.asarray(kb), causal=causal,
        interpret=True)
    t_kb = None if kb is None else torch.from_numpy(kb)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    # the kernel wrapper on CPU tensors runs the plain version
    n0 = tfa.flash_attention_lse.launches
    t_out, t_lse = tfa.flash_attention_lse(tq, tk, tv, key_bias=t_kb,
                                           causal=causal)
    assert tfa.flash_attention_lse.launches == n0
    _close(t_out, j_out)
    _close(t_lse, j_lse)
    p_out, p_lse = tfa.flash_attention_lse_plain(tq, tk, tv, key_bias=t_kb,
                                                 causal=causal)
    _close(p_out, j_out)
    _close(p_lse, j_lse)
    _close(tfa.flash_attention(tq, tk, tv, key_bias=t_kb, causal=causal),
           j_out)


def test_flash_decode_plain_matches_jax_kernel():
    """Mixed live lengths and one fully masked slot (all keys at -1e4,
    as an inactive engine slot feeds)."""
    rs = np.random.RandomState(0)
    B, N, S, D = 4, 3, 24, 16
    q, k, v = _randn(rs, B, N, 1, D), _randn(rs, B, N, S, D), \
        _randn(rs, B, N, S, D)
    kb = np.zeros((B, S), np.float32)
    for b, n in enumerate((1, 17, 24, 0)):
        kb[b, n:] = -1e4
    want = jfa.flash_decode_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), key_bias=jnp.asarray(kb),
                                      interpret=True)
    tq, tk, tv, tkb = (torch.from_numpy(a) for a in (q, k, v, kb))
    n0 = tfa.flash_decode_attention.launches
    _close(tfa.flash_decode_attention(tq, tk, tv, key_bias=tkb), want)
    assert tfa.flash_decode_attention.launches == n0
    _close(tfa.flash_decode_attention_plain(tq, tk, tv, key_bias=tkb), want)
    _close(tnn.flash_decode_attention(tq, tk, tv, key_bias=tkb), want)
    with pytest.raises(ValueError):
        tfa.flash_decode_attention(tk, tk, tv, key_bias=tkb)  # Sq != 1


@pytest.mark.parametrize("form", ["vector", "one_row", "per_batch",
                                  "per_head", "broadcast_4d"])
def test_kernel_key_bias_rows_match_jax_normalization(form):
    """The kernels read key-bias row ``bh // heads`` of what the wrapper
    hands them, without a per-head copy; expanded that way it must be the
    reference's canonical [B*N, Sk] bias."""
    B, N, Sk = 3, 4, 10
    rows = {"vector": (Sk,), "one_row": (1, Sk), "per_batch": (B, Sk),
            "per_head": (B * N, Sk), "broadcast_4d": (B, 1, 1, Sk)}[form]
    raw = _randn(np.random.RandomState(8), *rows)
    want = np.asarray(jfa._normalize_key_bias(jnp.asarray(raw), B, N, Sk))
    t_raw = torch.from_numpy(raw)
    kb, heads = tfa._kernel_key_bias(t_raw, B, N, Sk)
    assert kb.data_ptr() == t_raw.data_ptr()   # the caller's own rows
    got = kb.repeat_interleave(heads, dim=0)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tfa._normalize_key_bias(t_raw, B, N, Sk).numpy(), want)


@pytest.mark.parametrize("bias_shape", [None, (1, 1, 20, 20), (2, 1, 20, 20),
                                        (1, 3, 20, 20), (2, 3, 20, 20)])
def test_flash_attention_bias_and_dropout_plain_matches_jax(bias_shape):
    """The plain version covers what the CUDA kernel does not take yet:
    a general bias (every broadcast form) and the stateless hash dropout,
    whose keep-mask must be bit-identical to the reference's."""
    rs = np.random.RandomState(7)
    B, N, S, D = 2, 3, 20, 16
    q, k, v = (_randn(rs, B, N, S, D) for _ in range(3))
    bias = None if bias_shape is None else _randn(rs, *bias_shape)
    kw = dict(causal=True, dropout_rate=0.25, dropout_seed=123456789)
    j_out, j_lse = jfa.flash_attention_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        bias=None if bias is None else jnp.asarray(bias), **kw)
    t_out, t_lse = tfa.flash_attention_lse(
        *(torch.from_numpy(a) for a in (q, k, v)),
        bias=None if bias is None else torch.from_numpy(bias), **kw)
    _close(t_out, j_out)
    _close(t_lse, j_lse)


def test_dropout_hash_and_seed_bit_identical():
    rows = np.arange(64).reshape(64, 1)
    cols = np.arange(48).reshape(1, 48)
    for seed in (0, 1, 2 ** 23 + 5, 2 ** 40 + 3):
        js = np.asarray(jfa._norm_seed(seed)).reshape(())
        ts = tfa._norm_seed(seed)
        assert int(js) == ts
        want = np.asarray(jfa._hash_keep(
            jnp.asarray(rows, jnp.int32), jnp.asarray(cols, jnp.int32), 5,
            jnp.uint32(ts), 0.3))
        got = tfa._hash_keep(torch.from_numpy(rows), torch.from_numpy(cols),
                             5, ts, 0.3).numpy()
        np.testing.assert_array_equal(got, want)


# (B, N, Sq, Sk, D, causal, key-bias form, dropout rate)
_BWD_CASES = {
    "causal": (2, 2, 32, 32, 16, True, None, 0.0),
    "causal_per_batch_bias": (2, 3, 24, 24, 16, True, "per_batch", 0.0),
    "per_head_bias_dropout": (2, 2, 24, 24, 16, False, "per_head", 0.1),
    "ragged_causal_dropout": (2, 2, 20, 20, 16, True, "per_batch", 0.1),
    "cross_ragged": (1, 2, 13, 40, 32, False, "per_batch", 0.0),
}


def _kb(rs, form, B, N, Sk):
    if form is None:
        return None
    if form == "per_batch":            # the model's padding bias
        kb = np.zeros((B, Sk), np.float32)
        kb[-1, Sk // 2:] = -1e4
        return kb
    return _randn(rs, *((Sk,) if form == "vector" else (B * N, Sk)))


@pytest.mark.parametrize("case", sorted(_BWD_CASES))
def test_flash_attention_bwd_plain_matches_jax_kernels(case):
    """The plain version of both backward kernels against the Pallas
    backward kernels in interpret mode, from the same residuals (the JAX
    forward's out and lse) and the same raw seed: the keep mask must be
    regenerated bit for bit. Gradients are sums of a few dozen fp32
    products of magnitude ~1, so honest differences are ~1e-6; a wrong
    mask entry moves them by O(0.1)."""
    B, N, Sq, Sk, D, causal, form, rate = _BWD_CASES[case]
    rs = np.random.RandomState(len(case) + 20)
    q, k, v = _randn(rs, B, N, Sq, D), _randn(rs, B, N, Sk, D), \
        _randn(rs, B, N, Sk, D)
    g = _randn(rs, B, N, Sq, D)
    kb = _kb(rs, form, B, N, Sk)
    seed = 424242 if rate else None
    j_kb = None if kb is None else jnp.asarray(kb)
    j_out, j_lse = jfa.flash_attention_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), key_bias=j_kb,
        causal=causal, dropout_rate=rate, dropout_seed=seed, interpret=True)
    want = jfa.flash_attention_bwd_from_residuals(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), j_kb, seed, j_out,
        j_lse, jnp.asarray(g), causal=causal, dropout_rate=rate,
        interpret=True)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    t_kb = None if kb is None else torch.from_numpy(kb)
    out = torch.from_numpy(np.array(j_out))
    lse = torch.from_numpy(np.array(j_lse))
    kw = dict(causal=causal, dropout_rate=rate)
    launches = (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches)
    got = tfa.flash_attention_bwd_from_residuals(tq, tk, tv, t_kb, seed, out,
                                                 lse, tg, **kw)
    assert (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches) == launches
    plain = tfa.flash_attention_bwd_plain(tq, tk, tv, t_kb, seed, out, lse,
                                          tg, **kw)
    # each kernel's own wrapper (CPU: its plain version) from delta
    delta = (tg * out).sum(-1)
    dq = tfa.flash_bwd_dq(tq, tk, tv, t_kb, tg, lse, delta, dropout_seed=seed,
                          **kw)
    dkv = tfa.flash_bwd_dkv(tq, tk, tv, t_kb, tg, lse, delta,
                            dropout_seed=seed, **kw)
    for name, w, a, b, c in zip(("dq", "dk", "dv", "dkey_bias"), want, got,
                                plain, (dq,) + tuple(dkv)):
        assert tuple(a.shape) == tuple(np.shape(w)), name
        for x in (a, b, c):
            _close(x, w)


@pytest.mark.parametrize("form,rate", [("per_batch", 0.0), ("per_head", 0.0),
                                       ("vector", 0.1)])
def test_flash_attention_autograd_matches_jax_grad(form, rate):
    """The differentiable op (autograd through the residual-driven
    backward) against ``jax.grad`` through the reference's custom VJP and
    its Pallas kernels in interpret mode: a loss reading both out and lse
    (the lse cotangent folds into delta), gradients for q, k, v and the
    key bias in its raw shape. Same tolerance reasoning as above."""
    import jax

    rs = np.random.RandomState(31 + len(form))
    B, N, S, D = 2, 2, 20, 16
    q, k, v = (_randn(rs, B, N, S, D) for _ in range(3))
    w_out, w_lse = _randn(rs, B, N, S, D), _randn(rs, B, N, S)
    kb = _kb(rs, form, B, N, S)
    seed = 77 if rate else None

    def jloss(q, k, v, kb):
        out, lse = jfa.flash_attention_lse(
            q, k, v, key_bias=kb, causal=True, dropout_rate=rate,
            dropout_seed=seed, interpret=True)
        return (out * w_out).sum() + (lse * w_lse).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (q, k, v, kb)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, kb)]
    out, lse = tnn.flash_attention_lse(*leaves, causal=True,
                                       dropout_rate=rate, dropout_seed=seed)
    ((out * torch.from_numpy(w_out)).sum()
     + (lse * torch.from_numpy(w_lse)).sum()).backward()
    for leaf, w in zip(leaves, want):
        assert tuple(leaf.grad.shape) == tuple(w.shape)
        _close(leaf.grad, w)
    if rate == 0.0:
        # the op itself (out only; is_test off, rate 0: no seed drawn)
        leaves2 = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        (tnn.flash_attention(*leaves2, key_bias=torch.from_numpy(kb),
                             causal=True) * torch.from_numpy(w_out)
         ).sum().backward()
        want2 = jax.grad(lambda q, k, v: (jfa.flash_attention(
            q, k, v, key_bias=jnp.asarray(kb), causal=True, interpret=True)
            * w_out).sum(), argnums=(0, 1, 2))(
            *(jnp.asarray(a) for a in (q, k, v)))
        for leaf, w in zip(leaves2, want2):
            _close(leaf.grad, w)


def test_reference_attention_matches_jax():
    rs = np.random.RandomState(3)
    q, k, v = (_randn(rs, 2, 2, 12, 8) for _ in range(3))
    bias = _randn(rs, 2, 1, 12, 12)
    want = jfa.reference_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                   bias=jnp.asarray(bias), causal=True)
    got = tfa.reference_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                  bias=torch.from_numpy(bias), causal=True)
    _close(got, want)


def test_flash_attention_op_matches_jax_lowering_inference():
    """The op lowering at inference (is_test: dropout off) equals the
    JAX kernel entry, scale attribute 0 meaning 1/sqrt(d_head)."""
    rs = np.random.RandomState(4)
    q, k, v = (_randn(rs, 2, 2, 16, 16) for _ in range(3))
    kb = np.zeros((2, 16), np.float32)
    kb[1, 11:] = -1e4
    want = jfa.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                               key_bias=jnp.asarray(kb), causal=True,
                               interpret=True)
    got = tnn.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              key_bias=torch.from_numpy(kb), causal=True,
                              scale=0.0, dropout_rate=0.1, is_test=True)
    _close(got, want)


def _run_jax_kv_cache_write(base, new, pos, slot_mode):
    """The reference op through a one-op fluid program, as its own tests
    run it."""
    S, H, M, D = base.shape
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        cache = main.global_block().create_var(
            name="c", shape=[S, H, M, D], dtype="float32", persistable=True)
        new_v = fluid.layers.data(name="new", shape=list(new.shape[1:]),
                                  dtype="float32")
        pos_v = fluid.layers.data(name="pos", shape=list(pos.shape[1:]),
                                  dtype="int64")
        out = fluid.layers.kv_cache_write(cache, new_v, pos_v,
                                          slot_mode=slot_mode)
    scope = fluid.core.Scope()
    scope.set("c", base.copy())
    (got,) = fluid.Executor(fluid.CPUPlace()).run(
        main, feed={"new": new, "pos": pos}, fetch_list=[out], scope=scope)
    return np.asarray(got)


_KV_CASES = {
    # per-slot form: one token per slot at its own position; the last
    # slot's position is past the row end and clamps like the reference
    "per_slot": (False, (3, 1), np.array([1, 0, 9], "int64").reshape(3, 1, 1)),
    "per_slot_two_tokens": (False, (3, 2),
                            np.array([5, 0, 6], "int64").reshape(3, 1, 1)),
    "slot": (True, (1, 3), np.array([[2]], "int64")),
    "slot_offset": (True, (1, 3), np.array([[1, 4]], "int64")),
    "slot_offset_clamped": (True, (1, 3), np.array([[0, 7]], "int64")),
}


@pytest.mark.parametrize("case", sorted(_KV_CASES))
def test_kv_cache_write_matches_jax_op(case):
    slot_mode, (rows, T), pos = _KV_CASES[case]
    S, H, M, D = 3, 2, 8, 4
    base = np.arange(S * H * M * D, dtype=np.float32).reshape(S, H, M, D)
    new = -1.0 - np.arange(rows * H * T * D, dtype=np.float32) \
        .reshape(rows, H, T, D)
    want = _run_jax_kv_cache_write(base, new, pos, slot_mode)
    cache = torch.from_numpy(base.copy())
    out = tnn.kv_cache_write(cache, torch.from_numpy(new),
                             torch.from_numpy(pos), slot_mode=slot_mode)
    assert out is cache  # written in place
    np.testing.assert_array_equal(cache.numpy(), want)


def test_math_ops_match_jax_semantics():
    import jax

    rs = np.random.RandomState(5)
    x = _randn(rs, 3, 5, 16) * 3
    w, b = _randn(rs, 16), _randn(rs, 16)
    mean = x.mean(-1, keepdims=True)
    var = ((x - mean) ** 2).mean(-1, keepdims=True)
    ln_want = (x - mean) / np.sqrt(var + 1e-5) * w + b
    _close(tmath.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(b), begin_norm_axis=2), ln_want,
           atol=1e-5, rtol=1e-5)
    _close(tmath.gelu(torch.from_numpy(x)),
           jax.nn.gelu(jnp.asarray(x), approximate=False))
    _close(tmath.softmax(torch.from_numpy(x)), jax.nn.softmax(jnp.asarray(x)))


# the reference's general-bias forms (``test_flash_grad_general_bias``)
_BIAS_SHAPES = {
    "2d": lambda B, N, S: (S, S),
    "full": lambda B, N, S: (B, N, S, S),
    "batch": lambda B, N, S: (B, 1, S, S),
    "head": lambda B, N, S: (1, N, S, S),
}


def _bias_case_grads(q, k, v, kb, bias, w_out, w_lse, causal, rate, seed):
    """(JAX out, lse, grads of q, k, v, bias through the Pallas kernels in
    interpret mode) and the port's (out, lse, grads through the op's
    autograd Function, whose backward is the plain version on the CPU),
    for a loss reading both out and lse."""
    import jax

    j_kb = None if kb is None else jnp.asarray(kb)

    def jloss(q, k, v, b):
        out, lse = jfa.flash_attention_lse(
            q, k, v, key_bias=j_kb, bias=b, causal=causal, dropout_rate=rate,
            dropout_seed=seed, interpret=True)
        return (out * w_out).sum() + (lse * w_lse).sum(), (out, lse)

    (_l, (j_out, j_lse)), j_grads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True)(
            *(jnp.asarray(a) for a in (q, k, v, bias)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
    out, lse = tnn.flash_attention_lse(
        *leaves[:3], key_bias=None if kb is None else torch.from_numpy(kb),
        bias=leaves[3], causal=causal, dropout_rate=rate, dropout_seed=seed)
    ((out * torch.from_numpy(w_out)).sum()
     + (lse * torch.from_numpy(w_lse)).sum()).backward()
    return (j_out, j_lse, j_grads), (out, lse, [t.grad for t in leaves])


@pytest.mark.parametrize("shape", sorted(_BIAS_SHAPES))
def test_flash_bias_plain_matches_jax_kernels(shape):
    """The plain forward with a general bias in each broadcast form
    against the Pallas forward in interpret mode (rtol 2e-5 / atol 2e-6,
    the reference test's forward tolerance), and its backward — dq, dk,
    dv and dbias summed over the heads sharing a bias row, in the bias's
    raw shape — against ``jax.grad`` through the Pallas backward kernels
    (atol/rtol 1e-5: sums of a few dozen fp32 products of size ~1)."""
    rs = np.random.RandomState(11 + len(shape))
    B, N, S, D = 2, 3, 32, 8
    q, k, v = (_randn(rs, B, N, S, D) * 0.5 for _ in range(3))
    bias = _randn(rs, *_BIAS_SHAPES[shape](B, N, S)) * 0.3
    w_out, w_lse = _randn(rs, B, N, S, D), _randn(rs, B, N, S)
    (j_out, j_lse, j_grads), (out, lse, grads) = _bias_case_grads(
        q, k, v, None, bias, w_out, w_lse, False, 0.0, None)
    _close(out.detach(), j_out, atol=2e-6, rtol=2e-5)
    _close(lse.detach(), j_lse, atol=2e-6, rtol=2e-5)
    for name, got, want in zip(("dq", "dk", "dv", "dbias"), grads, j_grads):
        assert tuple(got.shape) == tuple(want.shape), name
        _close(got, want)
    # the plain backward entry returns dbias [G, Sq, Sk] after the rest
    tq, tk, tv, tb = (torch.from_numpy(a) for a in (q, k, v, bias))
    t_out, t_lse = tfa.flash_attention_lse_plain(tq, tk, tv, bias=tb)
    plain = tfa.flash_attention_bwd_plain(
        tq, tk, tv, None, None, t_out, t_lse, torch.from_numpy(w_out),
        g_lse=torch.from_numpy(w_lse), bias=tb)
    assert len(plain) == 5
    _close(plain[4].reshape(bias.shape), j_grads[3])


def test_flash_bias_causal_key_bias_odd_length_dropout_per_head_swap():
    """All masking paths at once (the reference's
    ``test_flash_grad_causal_with_bias_and_key_bias`` and
    ``test_flash_dropout_per_head_bias_swap_parity`` cases): causal, a
    per-head bias shared across the batch ([1, N, S, S], which the TPU
    kernels run head-major with B and N swapped), a key padding bias, an
    odd length S = 37 and dropout 0.3. The port maps heads to bias rows
    without a swap, and the dropout hash keeps the caller's head index,
    so the masks and gradients agree with the Pallas kernels in interpret
    mode (atol/rtol 1e-5)."""
    rs = np.random.RandomState(16)
    B, N, S, D = 3, 2, 37, 8
    q, k, v = (_randn(rs, B, N, S, D) * 0.5 for _ in range(3))
    bias = _randn(rs, 1, N, S, S) * 0.2
    kb = np.zeros((B, S), np.float32)
    kb[1, 30:] = -1e4
    w_out, w_lse = _randn(rs, B, N, S, D), _randn(rs, B, N, S)
    (j_out, j_lse, j_grads), (out, lse, grads) = _bias_case_grads(
        q, k, v, kb, bias, w_out, w_lse, True, 0.3, 21)
    _close(out.detach(), j_out)
    _close(lse.detach(), j_lse)
    for name, got, want in zip(("dq", "dk", "dv", "dbias"), grads, j_grads):
        assert tuple(got.shape) == tuple(want.shape), name
        _close(got, want)


def test_flash_attention_op_vjp_matches_autograd():
    """``torch.func.vjp`` through the op (general bias, key bias, causal,
    dropout) gives the gradients ``torch.autograd.grad`` gives: the
    Function splits ``forward`` and ``setup_context``, so the program's
    generic grad lowering can differentiate through it. Same Function,
    same backward: the two agree exactly."""
    rs = np.random.RandomState(41)
    B, N, S, D = 2, 2, 19, 8
    q, k, v = (torch.from_numpy(_randn(rs, B, N, S, D)) for _ in range(3))
    bias = torch.from_numpy(_randn(rs, 1, N, S, S))
    kb = torch.from_numpy(_randn(rs, B, S))
    g = torch.from_numpy(_randn(rs, B, N, S, D))
    gen_seed = 5

    def f(q, k, v, bias):
        gen = torch.Generator().manual_seed(gen_seed)
        return tnn.flash_attention(q, k, v, key_bias=kb, bias=bias,
                                   causal=True, dropout_rate=0.2,
                                   generator=gen)

    out, vjp_fn = torch.func.vjp(f, q, k, v, bias)
    got = vjp_fn(g)
    leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    out2 = f(*leaves)
    want = torch.autograd.grad(out2, leaves, g)
    torch.testing.assert_close(out, out2.detach(), atol=0, rtol=0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


# (B, N, S, D, causal, key bias, per-head general bias, dropout rate)
_LOW_CASES = {
    "d16_causal_key_bias": (2, 2, 32, 16, True, True, False, 0.0),
    "d48_causal_key_bias_dropout": (2, 2, 40, 48, True, True, False, 0.1),
    "d64_key_bias_general_bias": (2, 2, 32, 64, False, True, True, 0.0),
    "d48_causal_general_bias_dropout": (1, 2, 24, 48, True, False, True, 0.1),
}


@pytest.mark.parametrize("case", sorted(_LOW_CASES))
def test_flash_plain_bf16_matches_jax_kernels(case):
    """The plain versions on bf16 inputs against the Pallas kernels in
    interpret mode on the same bf16 inputs: the forward, then both
    backward kernels (``jax.vjp`` through the custom VJP) against the
    port's residual backward driven by the JAX forward's out and lse.

    lse, dkey_bias and dbias are fp32: within 1e-4. dq, dk and dv round
    ds and p at the kernels' points and sum exact bf16 products in fp32,
    as XLA's CPU dots do in the same order: equal bit for bit. out: the
    Pallas kernel rounds the running, unnormalised p to bf16 before P·V,
    the plain version the normalised softmax (as the reference's dense
    fallback does), so out is held to the limits of
    ``tools/lowp_limits.py``: per element the bound of those roundings,
    per 64-row block 1 eps of relative norm (read: ~0.41 eps). The
    dropout hash is the same bit for bit
    (``test_dropout_hash_and_seed_bit_identical``)."""
    import jax

    B, N, S, D, causal, with_kb, with_bias, rate = _LOW_CASES[case]
    rs = np.random.RandomState(D + S)
    q, k, v, g = (_randn(rs, B, N, S, D) for _ in range(4))
    kb = None
    if with_kb:
        kb = np.zeros((B, S), np.float32)
        kb[-1, S // 2:] = -1e4
    bias = _randn(rs, 1, N, S, S) * 0.3 if with_bias else None
    seed = 77 if rate else None
    jq, jk, jv, jg = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, g))
    j_kb = None if kb is None else jnp.asarray(kb)

    def fwd(a, b, c, *bias_arg):
        return jfa.flash_attention_lse(
            a, b, c, key_bias=j_kb, bias=bias_arg[0] if bias_arg else None,
            causal=causal, dropout_rate=rate, dropout_seed=seed,
            interpret=True)

    args = (jq, jk, jv) + ((jnp.asarray(bias),) if with_bias else ())
    (j_out, j_lse), vjp = jax.vjp(fwd, *args)
    j_grads = vjp((jg, jnp.zeros_like(j_lse)))
    tq, tk, tv, tg = (torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
                      for a in (jq, jk, jv, jg))
    t_kb = None if kb is None else torch.from_numpy(kb)
    t_bias = None if bias is None else torch.from_numpy(bias)
    kw = dict(causal=causal, dropout_rate=rate, bias=t_bias)
    out, lse = tfa.flash_attention_lse(tq, tk, tv, key_bias=t_kb,
                                       dropout_seed=seed, **kw)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    want_out = torch.from_numpy(np.asarray(j_out, np.float32))
    bound = lowp.out_bound(torch.bfloat16, tq, tk, tv, want_out,
                           key_bias=t_kb, dropout_seed=seed, **kw)
    lowp.check("out", lowp.out_ratios(torch.bfloat16, out, want_out, bound))
    _close(lse, j_lse, atol=1e-4, rtol=1e-4)
    res_out = want_out.bfloat16()
    res_lse = torch.from_numpy(np.array(j_lse))
    got = tfa.flash_attention_bwd_from_residuals(tq, tk, tv, t_kb, seed,
                                                 res_out, res_lse, tg, **kw)
    for name, a, w in zip(("dq", "dk", "dv"), got[:3], j_grads[:3]):
        assert a.dtype == torch.bfloat16, name
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(w, np.float32), err_msg=name)
    if with_bias:
        assert got[4].dtype == torch.float32
        _close(got[4].reshape(bias.shape), j_grads[3], atol=1e-4, rtol=1e-4)
    if with_kb:
        # the key bias's gradient: [B·N, Sk] fp32, the reference's
        # dkey_bias from its residual entry (bf16 inputs, fp32 out)
        j_dkb = jfa.flash_attention_bwd_from_residuals(
            jq, jk, jv, j_kb, seed, j_out, j_lse, jg, causal=causal,
            dropout_rate=rate, interpret=True)[3] if not with_bias else None
        if j_dkb is not None:
            assert got[3].dtype == torch.float32
            _close(got[3], j_dkb, atol=1e-4, rtol=1e-4)


@functools.lru_cache(maxsize=None)
def _planted_faults():
    return lowp.planted_faults(N=2, S=256)


@pytest.mark.parametrize("fault", [
    "late_rows_2pct", "first_key_tile_skipped", "diagonal_tile_skipped",
    "one_key_dropped", "ds_p_unrounded"])
def test_lowp_limits_catch_planted_faults(fault):
    """The limits the bf16 kernels are held to (``tools/lowp_limits.py``)
    fail each planted fault on at least one output, with the plain
    version on the same inputs as the correct side (causal, a padded key
    tail, dropout 0.1, [1, 2, 256, 64] bf16). The forward's p left
    unrounded is the one fault they cannot see: it moves out by less than
    the two sides' roundings of p already do."""
    ratios = _planted_faults()[fault]
    assert max(ratios.values()) > 1.0, ratios
    assert max(_planted_faults()["p_unrounded"].values()) <= 1.0
