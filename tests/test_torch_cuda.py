"""The port's CUDA kernels against their plain PyTorch versions on the
card, and the engine end to end on the card. Needs a GPU and ``nvcc``;
skips elsewhere. Imports neither JAX nor the JAX package, so it runs on
a machine without them:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

fp32 on both sides; atol 2e-5 / rtol 1e-4 for the forward kernels (they
sum in another order than the dense plain version, the training forward
in split TF32 whose products keep ~2^-22 of fp32; a masking or indexing
error is O(0.1)); atol 1e-4 for the backward ones (split TF32 as well),
whose outputs are sums of up to a few hundred products of O(1) terms
(dkey_bias sums ds over every query row), and whose dropout mask, if it
differed by one entry, would move a gradient by O(0.1). The bf16 and fp16 forms are held to
the limits of ``paddle_tpu_torch/tools/lowp_limits.py``: the training
kernels to its per-element bounds and per-block norms, the decode
kernels to its per-element ``out_bound`` at rate 0 (a decode block is one
row of D elements).
"""

import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.serving import decode as tdecode
from paddle_tpu_torch.tools import lowp_limits as lowp

torch.set_num_threads(2)

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif("not torch.cuda.is_available()",
                       reason="needs a CUDA device (run on the GPU machine)"),
]

ATOL, RTOL = 2e-5, 1e-4
BWD_ATOL = 1e-4


def _randn(gen, *shape):
    return torch.randn(*shape, generator=gen).cuda()


@pytest.mark.parametrize("D", [16, 32, 48, 64, 128, 200, 256])
@pytest.mark.parametrize("causal,Sq,Sk", [(True, 100, 100), (False, 37, 150),
                                          (True, 1, 1), (False, 130, 77)])
def test_flash_fwd_kernel_matches_plain(D, causal, Sq, Sk):
    """The fp32 forward (split TF32 on the tensor cores) at every
    instantiated width (D 16, 48 and 200 zero-padded), Sq != Sk both ways
    with ragged tiles and a -1e4 key tail, at the fp32 limits."""
    gen = torch.Generator().manual_seed(D + Sq)
    B, N = 2, 3
    q, k, v = _randn(gen, B, N, Sq, D), _randn(gen, B, N, Sk, D), \
        _randn(gen, B, N, Sk, D)
    kb = torch.zeros(B, Sk)
    kb[1, max(Sk - 30, 1):] = -1e4
    kb = kb.cuda()
    n0 = fa.flash_attention_lse.launches
    out, lse = fa.flash_attention_lse(q, k, v, kb, causal=causal)
    assert fa.flash_attention_lse.launches == n0 + 1
    ref_out, ref_lse = fa.flash_attention_lse_plain(q, k, v, key_bias=kb,
                                                    causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref_out, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(lse, ref_lse, atol=ATOL, rtol=RTOL)


_KEY_BIAS_FORMS = [None, "vector", "per_batch", "per_head"]


def _key_bias(gen, form, B, N, S):
    if form is None:
        return None
    if form == "per_batch":        # the model's padding bias, -1e4 tails
        kb = torch.zeros(B, S)
        kb[-1, max(S - 23, 1):] = -1e4
        return kb.cuda()
    return _randn(gen, *((S,) if form == "vector" else (B * N, S)))


@pytest.mark.parametrize("D", [32, 48, 64, 128, 200, 256])
@pytest.mark.parametrize("causal,Sq,Sk", [(True, 100, 100), (False, 37, 150),
                                          (True, 64, 64), (False, 130, 77)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("form", _KEY_BIAS_FORMS)
def test_flash_training_kernels_match_plain(D, causal, Sq, Sk, rate, form):
    """The fp32 forward and both fp32 backward kernels (all three in split
    TF32 on the tensor cores) with the hash dropout, through the
    residual-driven entry the train step uses, against their plain
    versions on the same inputs, at every instantiated width (D 48 and 200
    zero-padded), Sq != Sk both ways; the lse cotangent folds into
    delta."""
    gen = torch.Generator().manual_seed(D + Sq + int(rate * 10))
    B, N = 2, 3
    q, k, v = _randn(gen, B, N, Sq, D), _randn(gen, B, N, Sk, D), \
        _randn(gen, B, N, Sk, D)
    g, g_lse = _randn(gen, B, N, Sq, D), _randn(gen, B, N, Sq)
    kb = _key_bias(gen, form, B, N, Sk)
    seed = 987654321 if rate else None
    kw = dict(causal=causal, dropout_rate=rate)
    n0 = (fa.flash_attention_lse.launches, fa.flash_bwd_dq.launches,
          fa.flash_bwd_dkv.launches)
    out, lse = fa.flash_attention_lse(q, k, v, kb, dropout_seed=seed, **kw)
    grads = fa.flash_attention_bwd_from_residuals(q, k, v, kb, seed, out, lse,
                                                  g, g_lse=g_lse, **kw)
    assert (fa.flash_attention_lse.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == tuple(n + 1 for n in n0)
    ref_out, ref_lse = fa.flash_attention_lse_plain(q, k, v, key_bias=kb,
                                                    dropout_seed=seed, **kw)
    ref = fa.flash_attention_bwd_plain(q, k, v, kb, seed, ref_out, ref_lse,
                                       g, g_lse=g_lse, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref_out, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(lse, ref_lse, atol=ATOL, rtol=RTOL)
    for name, got, want in zip(("dq", "dk", "dv", "dkey_bias"), grads, ref):
        torch.testing.assert_close(got, want, atol=BWD_ATOL, rtol=RTOL,
                                   msg=name)


def _check_low_precision(dtype, q, k, v, kb, g, gb, causal, rate, seed):
    """The three training kernels on ``dtype`` inputs through the
    residual-driven entry the train step uses, against their plain
    versions at the limits of ``tools/lowp_limits.py``: out, dq, dk and dv
    come back in the input type, lse, dkey_bias and dbias in fp32. Both
    backward kernels take the kernel forward's out and lse, and so do
    their plain versions: the same rounding points, so only summation
    order differs."""
    kw = dict(causal=causal, dropout_rate=rate, bias=gb)
    n0 = (fa.flash_attention_lse.launches, fa.flash_bwd_dq.launches,
          fa.flash_bwd_dkv.launches)
    out, lse = fa.flash_attention_lse(q, k, v, kb, dropout_seed=seed, **kw)
    grads = fa.flash_attention_bwd_from_residuals(q, k, v, kb, seed, out, lse,
                                                  g, **kw)
    assert (fa.flash_attention_lse.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == tuple(n + 1 for n in n0)
    ref_out, ref_lse = fa.flash_attention_lse_plain(q, k, v, key_bias=kb,
                                                    dropout_seed=seed, **kw)
    ref = fa.flash_attention_bwd_plain(q, k, v, kb, seed, out, lse, g, **kw)
    torch.cuda.synchronize()
    assert out.dtype == dtype and lse.dtype == torch.float32
    bound = lowp.out_bound(dtype, q, k, v, ref_out, key_bias=kb,
                           dropout_seed=seed, **kw)
    lowp.check("out", lowp.out_ratios(dtype, out, ref_out, bound))
    torch.testing.assert_close(lse, ref_lse, atol=lowp.FP32_ATOL,
                               rtol=lowp.FP32_ATOL)
    delta = (g.float() * out.float()).sum(-1)
    bounds = lowp.grad_bounds(dtype, q, k, v, kb, g, lse, delta, ref[:3],
                              dropout_seed=seed, **kw)
    names = ("dq", "dk", "dv", "dkey_bias", "dbias")
    for name, got, want, bound in zip(names, grads, ref, bounds + (None,) * 2):
        if name in ("dq", "dk", "dv"):
            assert got.dtype == dtype, name
            lowp.check(name, lowp.grad_ratios(dtype, got, want, bound))
        else:
            assert got.dtype == torch.float32, name
            torch.testing.assert_close(got, want, atol=BWD_ATOL,
                                       rtol=RTOL, msg=name)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
@pytest.mark.parametrize("D", [16, 48, 64, 128])
@pytest.mark.parametrize("causal,Sq,Sk,rate,bias", [
    (True, 100, 100, 0.1, False), (False, 37, 150, 0.0, True),
    (True, 130, 130, 0.1, True)])
def test_flash_training_kernels_low_precision_match_plain(
        dtype, D, causal, Sq, Sk, rate, bias):
    """The bf16 and fp16 forms of the three training kernels (a per-batch
    key bias, causal or not, dropout, a per-head general bias) against
    their plain versions on the same low-precision inputs, at the limits
    of ``tools/lowp_limits.py`` (``_check_low_precision``)."""
    gen = torch.Generator().manual_seed(D + Sq + int(rate * 10) + bias)
    B, N = 2, 3
    q, k, v = (_randn(gen, B, N, S, D).to(dtype) for S in (Sq, Sk, Sk))
    g = _randn(gen, B, N, Sq, D).to(dtype)
    kb = _key_bias(gen, "per_batch", B, N, Sk)
    gb = _randn(gen, 1, N, Sq, Sk) * 0.5 if bias else None
    _check_low_precision(dtype, q, k, v, kb, g, gb, causal, rate,
                         24680 if rate else None)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
@pytest.mark.parametrize("D", [16, 48, 64, 128, 200, 256])
@pytest.mark.parametrize("causal,Sq,Sk", [(True, 37, 37), (False, 37, 150),
                                          (True, 1000, 1000)])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_tensor_core_kernels_match_plain(dtype, D, causal, Sq, Sk, rate):
    """The three tensor-core kernels (bf16, fp16: the forward, dq and
    dk/dv) at every instantiated width (D 16, 48 and 200 zero-padded; dq
    with two warps sharing 16 rows at D = 256), causal or not, Sq != Sk,
    tiles ragged at both ends (S = 37, 1000), with and without dropout,
    against their plain versions at the limits of ``lowp_limits``
    (``_check_low_precision``)."""
    gen = torch.Generator().manual_seed(D * 7 + Sq + int(rate * 10))
    B, N = (1, 2) if Sq == 1000 else (2, 3)
    q, k, v = (_randn(gen, B, N, S, D).to(dtype) for S in (Sq, Sk, Sk))
    g = _randn(gen, B, N, Sq, D).to(dtype)
    kb = _key_bias(gen, "per_batch", B, N, Sk)
    _check_low_precision(dtype, q, k, v, kb, g, None, causal, rate,
                         13579 if rate else None)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
@pytest.mark.parametrize("form", _KEY_BIAS_FORMS)
@pytest.mark.parametrize("bias", [None, "per_head", "shared"])
def test_tensor_core_kernels_take_every_bias_form(dtype, form, bias):
    """Every key-bias form, and a per-head ([1, N, S, S], stored per head
    of the batch's rows with atomics) or shared ([S, S]) general bias,
    through the three tensor-core kernels (forward, dq, dk/dv) with
    dropout 0.3, causal."""
    gen = torch.Generator().manual_seed(len(str(form)) + len(str(bias)))
    B, N, S, D = 2, 3, 100, 64
    q, k, v, g = (_randn(gen, B, N, S, D).to(dtype) for _ in range(4))
    kb = _key_bias(gen, form, B, N, S)
    gb = None
    if bias is not None:
        gb = _randn(gen, *((1, N, S, S) if bias == "per_head" else (S, S)))
        gb = gb * 0.5
    _check_low_precision(dtype, q, k, v, kb, g, gb, True, 0.3, 97531)


# the general bias's broadcast forms: shape given (B, N, Sq, Sk)
_BIAS_FORMS = {
    "square": lambda B, N, Sq, Sk: (Sq, Sk),
    "shared": lambda B, N, Sq, Sk: (1, 1, Sq, Sk),
    "per_batch": lambda B, N, Sq, Sk: (B, 1, Sq, Sk),
    "per_head_of_batch": lambda B, N, Sq, Sk: (B, N, Sq, Sk),
    "per_head": lambda B, N, Sq, Sk: (1, N, Sq, Sk),
    "flat_heads": lambda B, N, Sq, Sk: (B * N, Sq, Sk),
}


@pytest.mark.parametrize("D", [32, 64, 128, 200, 256])
@pytest.mark.parametrize("causal,Sq,Sk", [(True, 100, 100), (False, 37, 150),
                                          (False, 130, 77)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("form", sorted(_BIAS_FORMS))
def test_flash_bias_kernels_match_plain(D, causal, Sq, Sk, rate, form):
    """The general-bias instantiations of the three training kernels (with
    a per-batch key bias beside the bias) against their plain versions:
    forward, dq, dk, dv, dkey_bias and dbias, per-head stores and
    shared-row atomics alike. No Sq here is a multiple of 16, so the last
    query rows of a warp run ragged in every kernel. dbias of a shared row
    is summed with atomics in no fixed order over at most B·N = 6 heads of
    O(1) entries, so it differs from the plain sum by rounding (~1e-7);
    it is held at the backward tolerance."""
    gen = torch.Generator().manual_seed(D + Sq + int(rate * 10) + len(form))
    B, N = 2, 3
    q, k, v = _randn(gen, B, N, Sq, D), _randn(gen, B, N, Sk, D), \
        _randn(gen, B, N, Sk, D)
    g, g_lse = _randn(gen, B, N, Sq, D), _randn(gen, B, N, Sq)
    kb = _key_bias(gen, "per_batch", B, N, Sk)
    bias = _randn(gen, *_BIAS_FORMS[form](B, N, Sq, Sk))
    seed = 123456789 if rate else None
    kw = dict(causal=causal, dropout_rate=rate)
    n0 = (fa.flash_attention_lse.launches, fa.flash_bwd_dq.launches,
          fa.flash_bwd_dkv.launches)
    out, lse = fa.flash_attention_lse(q, k, v, kb, bias=bias,
                                      dropout_seed=seed, **kw)
    grads = fa.flash_attention_bwd_from_residuals(
        q, k, v, kb, seed, out, lse, g, g_lse=g_lse, bias=bias, **kw)
    assert (fa.flash_attention_lse.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == tuple(n + 1 for n in n0)
    ref_out, ref_lse = fa.flash_attention_lse_plain(
        q, k, v, key_bias=kb, bias=bias, dropout_seed=seed, **kw)
    ref = fa.flash_attention_bwd_plain(q, k, v, kb, seed, ref_out, ref_lse,
                                       g, g_lse=g_lse, bias=bias, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref_out, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(lse, ref_lse, atol=ATOL, rtol=RTOL)
    assert len(grads) == len(ref) == 5
    for name, got, want in zip(("dq", "dk", "dv", "dkey_bias", "dbias"),
                               grads, ref):
        torch.testing.assert_close(got, want, atol=BWD_ATOL, rtol=RTOL,
                                   msg=name)


def _assert_decode_close(got, want, key_bias, msg=""):
    """Decode outputs [B, N, 1, D] within ATOL / RTOL of the plain
    version's, fully masked slots (``key_bias`` [B, S] all -1e4) too;
    prints the largest difference on those slots (``pytest -s``)."""
    masked = (key_bias < -1e3).all(1)
    if masked.any():
        print("decode masked-slot max abs err %s: %.3g" % (
            msg, float((got[masked] - want[masked]).abs().max())))
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL,
                               msg=msg or None)


def _decode_splits_checks(name, run, ref, splits_list, key_bias):
    """``run(splits)`` (None: the wrapper's own count) at each split count
    within the fp32 limits of ``ref``, and twice at each with equal bits
    (the cluster merges in a fixed order, so repeated calls agree)."""
    for splits in splits_list:
        out = run(splits)
        again = run(splits)
        torch.cuda.synchronize()
        _assert_decode_close(out, ref, key_bias,
                             "%s splits=%s" % (name, splits))
        assert torch.equal(out, again), "%s splits=%s: run to run" % (
            name, splits)


@pytest.mark.parametrize("D", [8, 20, 24, 32, 48, 64, 120, 128, 136, 200,
                               256])
@pytest.mark.parametrize("B,N,S", [(4, 3, 1), (4, 3, 300), (4, 3, 1024),
                                   (8, 12, 1024)])
def test_flash_decode_kernel_matches_plain(D, B, N, S):
    """Mixed live lengths and a fully masked slot, at the split count the
    wrapper picks, at 1 and at the largest (8): within the fp32 limits,
    and equal bits from call to call. (8, 12, 1024) is the serving shape."""
    gen = torch.Generator().manual_seed(D + S)
    q, k, v = _randn(gen, B, N, 1, D), _randn(gen, B, N, S, D), \
        _randn(gen, B, N, S, D)
    kb = torch.zeros(B, S)
    for b in range(B):
        kb[b, max((1, S // 2, S, 0)[b % 4], 0):] = -1e4
    kb = kb.cuda()
    n0 = fa.flash_decode_attention.launches
    out = fa.flash_decode_attention(q, k, v, kb)
    assert fa.flash_decode_attention.launches == n0 + 1
    ref = fa.flash_decode_attention_plain(q, k, v, key_bias=kb)
    torch.cuda.synchronize()
    name = "flash_decode D=%d B=%d N=%d S=%d" % (D, B, N, S)
    _assert_decode_close(out, ref, kb, name)
    _decode_splits_checks(
        name, lambda sp: fa._flash_decode(q, k, v, kb, splits=sp), ref,
        (None, 1, fa._DECODE_MAX_SPLITS), kb)


@pytest.mark.parametrize("D", [8, 20, 24, 32, 48, 64, 128, 200, 256])
@pytest.mark.parametrize("blk", [4, 16, 64])
@pytest.mark.parametrize("B,N,MB", [(4, 3, 5), (8, 12, 64)])
def test_flash_decode_paged_kernel_matches_plain(D, blk, B, N, MB):
    """A permuted table, two slots sharing their first two blocks (a
    prefix hit), one all-sink fully masked slot, mixed live lengths; at
    the wrapper's split count, at 1 and at 8 (split boundaries on pool
    blocks), repeated with equal bits. (8, 12, 64) with blk 16 is the
    serving shape."""
    gen = torch.Generator().manual_seed(D * 7 + blk)
    S, blocks = MB * blk, B * MB + 1
    q = _randn(gen, B, N, 1, D)
    k_pool, v_pool = _randn(gen, blocks, N, blk, D), \
        _randn(gen, blocks, N, blk, D)
    tables = (torch.randperm(blocks - 1, generator=gen) + 1).reshape(B, MB)
    tables[1, :2] = tables[0, :2]
    tables[3] = 0
    kb = torch.zeros(B, S)
    for b in range(B):
        kb[b, (1, S // 2 + 1, S, 0)[b % 4]:] = -1e4
    tables = tables.to(torch.int32).cuda()
    kb = kb.cuda()
    n0 = fa.flash_decode_paged_attention.launches
    out = fa.flash_decode_paged_attention(q, k_pool, v_pool, tables, kb)
    assert fa.flash_decode_paged_attention.launches == n0 + 1
    ref = fa.flash_decode_paged_attention_plain(q, k_pool, v_pool, tables,
                                                key_bias=kb)
    torch.cuda.synchronize()
    name = "flash_decode_paged D=%d blk=%d B=%d N=%d MB=%d" % (D, blk, B, N,
                                                               MB)
    _assert_decode_close(out, ref, kb, name)
    _decode_splits_checks(
        name, lambda sp: fa._flash_decode_paged(
            q, k_pool, v_pool, tables, kb, splits=sp), ref,
        (None, 1, fa._DECODE_MAX_SPLITS), kb)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
@pytest.mark.parametrize("D", [8, 20, 64, 200, 256])
@pytest.mark.parametrize("B,N,S,blk", [(4, 3, 300, 16), (8, 12, 1024, 16)])
def test_flash_decode_kernels_low_precision_match_plain(dtype, D, B, N, S,
                                                        blk):
    """Both decode kernels on bf16 or fp16 q, cache and pools against
    their plain versions, per element within ``lowp_limits.out_bound`` at
    rate 0 (the kernels round the running p, the plain version the
    normalised one); out comes back in the input type. At the wrapper's
    split count, at 1 and at 8, each repeated with equal bits; (8, 12,
    1024) is the serving shape."""
    gen = torch.Generator().manual_seed(D + 3)
    q = _randn(gen, B, N, 1, D).to(dtype)
    k, v = (_randn(gen, B, N, S, D).to(dtype) for _ in range(2))
    kb = torch.zeros(B, S)
    for b in range(B):
        kb[b, (1, S // 2, S, 0)[b % 4]:] = -1e4
    kb = kb.cuda()
    n0 = (fa.flash_decode_attention.launches,
          fa.flash_decode_paged_attention.launches)
    out = fa.flash_decode_attention(q, k, v, kb)
    ref = fa.flash_decode_attention_plain(q, k, v, key_bias=kb)
    MB = (S + blk - 1) // blk
    pools = [_randn(gen, B * MB + 1, N, blk, D).to(dtype) for _ in range(2)]
    tables = (torch.randperm(B * MB, generator=gen) + 1).reshape(B, MB)
    tables = tables.to(torch.int32).cuda()
    pkb = torch.zeros(B, MB * blk)
    pkb[:, 200:] = -1e4
    pkb = pkb.cuda()
    pout = fa.flash_decode_paged_attention(q, pools[0], pools[1], tables, pkb)
    pref = fa.flash_decode_paged_attention_plain(q, pools[0], pools[1],
                                                 tables, key_bias=pkb)
    torch.cuda.synchronize()
    assert (fa.flash_decode_attention.launches,
            fa.flash_decode_paged_attention.launches) == (n0[0] + 1,
                                                          n0[1] + 1)
    rows = [fa.gather_paged_rows(p, tables.long()) for p in pools]
    for name, run, want, kk, vv, bias in (
            ("decode", lambda sp: fa._flash_decode(
                q, k, v, kb, splits=sp), ref, k, v, kb),
            ("paged decode", lambda sp: fa._flash_decode_paged(
                q, pools[0], pools[1], tables, pkb, splits=sp), pref,
             rows[0], rows[1], pkb)):
        bound = lowp.out_bound(dtype, q, kk, vv, want, key_bias=bias)
        for splits in (None, 1, fa._DECODE_MAX_SPLITS):
            got, again = run(splits), run(splits)
            torch.cuda.synchronize()
            assert got.dtype == dtype and got.shape == q.shape, name
            assert torch.equal(got, again), "%s splits=%s" % (name, splits)
            lowp.check("%s splits=%s" % (name, splits), {
                "elem": lowp.out_ratios(dtype, got, want, bound)["elem"]})
    assert torch.equal(out, fa.flash_decode_attention(q, k, v, kb))
    assert torch.equal(pout, fa.flash_decode_paged_attention(
        q, pools[0], pools[1], tables, pkb))


def test_decode_design_is_what_the_cpu_emulation_reads():
    """The CPU tests emulate each decode kernel's thread groups from
    ``fa._DECODE_DESIGN`` (threads a block, key rows a group takes a
    tile): it must be what each library was built with."""
    import ctypes

    from paddle_tpu_torch.kernels import _build

    for kernel, design in fa._DECODE_DESIGN.items():
        out = (ctypes.c_int * 4)()
        _build.load(kernel, "f32").library.paddle_flash_decode_design(out)
        assert (out[0], out[1]) == design, kernel
        assert out[3] == fa._DECODE_MAX_SPLITS, kernel


def test_flash_decode_paged_wrapper_raises_on_what_it_does_not_take():
    gen = torch.Generator().manual_seed(5)
    q = _randn(gen, 2, 2, 1, 64)
    pool = _randn(gen, 5, 2, 4, 64)
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32).cuda()
    with pytest.raises(TypeError):
        fa.flash_decode_paged_attention(q, pool, pool, tables.long())
    with pytest.raises(ValueError):
        fa.flash_decode_paged_attention(_randn(gen, 2, 2, 3, 64), pool, pool,
                                        tables)
    with pytest.raises(ValueError):
        fa.flash_decode_paged_attention(q, _randn(gen, 5, 3, 4, 64),
                                        _randn(gen, 5, 3, 4, 64), tables)
    with pytest.raises(ValueError):
        fa.flash_decode_paged_attention(q, pool, pool, tables.cpu())
    for splits in (0, fa._DECODE_MAX_SPLITS + 1):   # one cluster: 1..8
        with pytest.raises(ValueError):
            fa._flash_decode_paged(q, pool, pool, tables, splits=splits)


def test_flash_decode_paged_raises_past_the_table_limit():
    """The paged kernel stages a split's table entries in shared memory:
    a table wider than ``_MAX_TABLE_BLOCKS`` logical blocks raises
    before any launch (the reference's kernel takes any width)."""
    gen = torch.Generator().manual_seed(6)
    q = _randn(gen, 1, 2, 1, 64)
    pool = _randn(gen, 3, 2, 1, 64)
    wide = torch.ones(1, fa._MAX_TABLE_BLOCKS + 1, dtype=torch.int32).cuda()
    n0 = fa.flash_decode_paged_attention.launches
    with pytest.raises(ValueError, match="logical blocks"):
        fa._flash_decode_paged(q, pool, pool, wide)
    at_limit = wide[:, :fa._MAX_TABLE_BLOCKS].contiguous()
    out = fa._flash_decode_paged(q, pool, pool, at_limit)
    assert fa.flash_decode_paged_attention.launches == n0 + 1
    ref = fa.flash_decode_paged_attention_plain(q, pool, pool, at_limit)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("splits", [None, 1, 4])
def test_flash_decode_paged_clamps_tables_outside_the_pool(splits):
    """Table entries below 0 or past the pool clamp to its first and
    last block, as the reference's gather clamps them; the kernel equals
    the plain version given the clamped table."""
    gen = torch.Generator().manual_seed(7)
    B, N, MB, blk, D, blocks = 4, 3, 6, 16, 64, 9
    q = _randn(gen, B, N, 1, D)
    k_pool, v_pool = _randn(gen, blocks, N, blk, D), \
        _randn(gen, blocks, N, blk, D)
    tables = torch.randint(1, blocks, (B, MB), generator=gen)
    tables[0, 1] = -5
    tables[1, 0] = blocks
    tables[2, 3:] = 1000
    tables[3] = -1
    tables = tables.to(torch.int32).cuda()
    kb = torch.zeros(B, MB * blk)
    kb[1, MB * blk // 2:] = -1e4
    kb = kb.cuda()
    out = fa._flash_decode_paged(q, k_pool, v_pool, tables, kb,
                                 splits=splits)
    ref = fa.flash_decode_paged_attention_plain(
        q, k_pool, v_pool, tables.clamp(0, blocks - 1), key_bias=kb)
    torch.cuda.synchronize()
    _assert_decode_close(out, ref, kb, "clamped table, splits=%s" % splits)


def test_contiguous_prefix_hit_and_resume_on_card():
    """A small contiguous engine with the prefix store and chunked
    windows on the card: a prompt's second admission hits the store,
    and a resume continues with the uninterrupted run's tokens; every
    whole-prompt prefill and every step went through the kernels."""
    from paddle_tpu_torch.observability import trace

    cfg = tgpt.GPTConfig.tiny(num_heads=2, use_flash_attention=True,
                              max_position_embeddings=64)
    model = tgpt.GPTLM(cfg)
    tgpt.load_fluid_params(model, tgpt.init_fluid_params(cfg, seed=2))
    prompt = [1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2, 3, 8]
    want = tgpt._reference_generate(model, prompt, len(prompt) + 12,
                                    use_flash=False)[len(prompt):]
    trace.reset()
    f0, d0 = fa.flash_attention_lse.launches, fa.flash_decode_attention.launches
    engine = tdecode.DecodeEngine(
        model, slots=2, max_len=56, prefix_block=4, prefill_chunk=8,
        prefix_cache_mb=8 * tgpt.prefix_block_bytes(cfg, 4) / 2 ** 20)
    engine.start()
    try:
        first = engine.generate(prompt, max_new_tokens=12)
        assert first.tokens(timeout=300) == want
        hit = engine.generate(prompt, max_new_tokens=12)
        assert hit.tokens(timeout=300) == want
        resumed = engine.generate(prompt, max_new_tokens=12,
                                  resume_tokens=want[:5])
        assert resumed.tokens(timeout=300) == want[5:]
        short = engine.generate([7, 7, 2], max_new_tokens=4)
        short.tokens(timeout=300)
        stats = engine.stats()
    finally:
        engine.stop()
    assert (first.cached_prefix_tokens, first.admit_windows) == (0, 2)
    assert hit.cached_prefix_tokens == 12 and hit.admit_windows == 1
    assert resumed.cached_prefix_tokens == 16
    assert stats["resume_admissions"] == 1 and stats["prefix_hits"] >= 2
    whole = sum(s["name"] == "decode_prefill" for s in trace.get_spans())
    assert whole >= 1 + len(engine.session.buckets)   # warmup + short
    assert fa.flash_attention_lse.launches - f0 == cfg.num_layers * whole
    assert fa.flash_decode_attention.launches - d0 == \
        cfg.num_layers * stats["steps"]


@pytest.mark.parametrize("rows", [None, "vector", "per_head"])
def test_kernels_take_every_key_bias_form(rows):
    gen = torch.Generator().manual_seed(11)
    B, N, S, D = 2, 3, 70, 64
    q1, q, k, v = _randn(gen, B, N, 1, D), _randn(gen, B, N, S, D), \
        _randn(gen, B, N, S, D), _randn(gen, B, N, S, D)
    kb = None
    if rows is not None:
        kb = _randn(gen, *((S,) if rows == "vector" else (B * N, S)))
    out, lse = fa.flash_attention_lse(q, k, v, kb, causal=True)
    ref_out, ref_lse = fa.flash_attention_lse_plain(q, k, v, key_bias=kb,
                                                    causal=True)
    dec = fa.flash_decode_attention(q1, k, v, kb)
    ref_dec = fa.flash_decode_attention_plain(q1, k, v, key_bias=kb)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref_out, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(lse, ref_lse, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(dec, ref_dec, atol=ATOL, rtol=RTOL)


def test_kernel_wrappers_raise_on_what_they_do_not_take():
    """bf16, fp16 and a head dim of 48 or 200 run (the training kernels
    pad D to 64 or 256); the decode kernels take bf16 and every D from 1
    to 256 (20 here); fp64, a mix of element types, a training D of 264,
    a decode D of 264 and a misaligned or strided operand raise."""
    gen = torch.Generator().manual_seed(0)
    q = _randn(gen, 1, 2, 16, 64)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q, bias=torch.zeros(3, 16, 16).cuda())
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q, bias=torch.zeros(2, 2, 16, 16).cuda(),
                           dropout_rate=0.1, dropout_seed=3)
    n0 = fa.flash_attention_lse.launches
    for t in (q.bfloat16(), q.half(), _randn(gen, 1, 2, 16, 48),
              _randn(gen, 1, 2, 16, 200).bfloat16()):
        out, lse = fa.flash_attention_lse(t, t, t)
        assert out.dtype == t.dtype and out.shape == t.shape
        assert lse.dtype == torch.float32
    assert fa.flash_attention_lse.launches == n0 + 4
    q48 = _randn(gen, 1, 2, 1, 48)
    assert fa.flash_decode_attention(q48, q48, q48).shape == q48.shape
    q1 = q[:, :, :1].contiguous()
    dec = fa.flash_decode_attention(q1.bfloat16(), q.bfloat16(), q.bfloat16())
    assert dec.dtype == torch.bfloat16 and dec.shape == q1.shape
    odd = _randn(gen, 1, 2, 16, 20)
    dec = fa.flash_decode_attention(odd[:, :, :1].contiguous(), odd, odd)
    assert dec.shape == (1, 2, 1, 20)
    with pytest.raises(TypeError):
        fa.flash_attention_lse(q.double(), q.double(), q.double())
    with pytest.raises(TypeError):
        fa.flash_attention_lse(q, q.bfloat16(), q)
    with pytest.raises(TypeError):
        fa.flash_decode_attention(q1.double(), q.double(), q.double())
    wide = _randn(gen, 1, 2, 16, 264)
    with pytest.raises(ValueError):
        fa.flash_attention_lse(wide, wide, wide)
    with pytest.raises(ValueError):
        fa.flash_decode_attention(wide[:, :, :1].contiguous(), wide, wide)
    strided = q.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        fa.flash_attention_lse(strided, strided, strided)
    shifted = q.bfloat16().reshape(-1)[4:4 + 2 * 15 * 64].reshape(
        1, 2, 15, 64)
    with pytest.raises(ValueError):  # 8 bytes past a 16-byte boundary
        fa.flash_attention_lse(shifted, shifted, shifted)
    with pytest.raises(ValueError):
        fa.flash_decode_attention(q1, q.cpu(), q.cpu())
    with pytest.raises(ValueError):
        fa._flash_decode(q1, q, q, splits=fa._DECODE_MAX_SPLITS + 1)


def test_engine_on_card_matches_plain_reference():
    # head_dim 32 (GPTConfig.tiny's 16 runs too, zero-padded to 32)
    cfg = tgpt.GPTConfig.tiny(num_heads=2, use_flash_attention=True,
                              max_position_embeddings=64)
    model = tgpt.GPTLM(cfg)                   # default device: the card
    assert model.device.type == "cuda"
    tgpt.load_fluid_params(model, tgpt.init_fluid_params(cfg, seed=0))
    prompts = [[3, 1, 4], [1, 5, 9, 2, 6, 5, 3, 5, 8, 9], [7]]
    f0, d0 = fa.flash_attention_lse.launches, fa.flash_decode_attention.launches
    engine = tdecode.DecodeEngine(model, slots=2, max_len=64).start()
    try:
        outs = [engine.generate(p, max_new_tokens=12).result(timeout=300)
                for p in prompts]
        stats = engine.stats()
    finally:
        engine.stop()
    assert fa.flash_attention_lse.launches - f0 == cfg.num_layers * stats["prefills"]
    assert fa.flash_decode_attention.launches - d0 == cfg.num_layers * stats["steps"]
    for p, got in zip(prompts, outs):
        want = tgpt._reference_generate(model, p, len(p) + 12,
                                        use_flash=False)
        assert got == want


def test_paged_engine_on_card_matches_legacy_engine():
    """The paged engine (block 4, chunked windows, prefix index) at
    width 1 — the paged kernel every step — and at width 4, greedy
    tokens equal to the contiguous engine's; a resubmitted prompt hits
    the prefix index."""
    cfg = tgpt.GPTConfig.tiny(num_heads=2, use_flash_attention=True,
                              max_position_embeddings=64)
    model = tgpt.GPTLM(cfg)
    tgpt.load_fluid_params(model, tgpt.init_fluid_params(cfg, seed=1))
    prompts = [[3, 1, 4], [1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2], [7],
               [1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2]]
    legacy = tdecode.DecodeEngine(model, slots=2, max_len=56).start()
    try:
        want = [legacy.generate(p, max_new_tokens=12).result(timeout=300)
                for p in prompts]
    finally:
        legacy.stop()
    paged = tdecode.DecodeEngine(
        model, slots=2, max_len=56, block_size=4, spec_tokens=4,
        prefill_chunk=8, prefix_cache_mb=1.0).start()
    try:
        for width in (1, 4):
            paged.set_spec_width(width)
            n0 = fa.flash_decode_paged_attention.launches
            s0 = paged.stats()["steps"]
            streams = [paged.generate(p, max_new_tokens=12) for p in prompts]
            got = [s.result(timeout=300) for s in streams]
            assert got == want, width
            launches = fa.flash_decode_paged_attention.launches - n0
            steps = paged.stats()["steps"] - s0
            assert launches == (cfg.num_layers * steps if width == 1 else 0)
        assert streams[-1].cached_prefix_tokens > 0
    finally:
        paged.stop()


def _train_feed(N, T, vocab, seed=0):
    import numpy as np

    rs = np.random.RandomState(seed)
    mask = np.ones((N, T, 1), np.float32)
    mask[-1, T // 2:] = 0.0
    return {"ids": rs.randint(0, vocab, (N, T, 1)).astype("int64"),
            "pos_ids": np.tile(np.arange(T).reshape(1, T, 1), (N, 1, 1)),
            "input_mask": mask}


def test_train_step_on_card_matches_cpu_plain_path():
    """Two Adam steps of a 12-layer narrow GPT (head_dim 32), dropout 0,
    on the card (the three flash kernels) and on the CPU (their plain
    versions) from the same weights: each kernel launches 12 times per
    step, the losses agree and so do the updated weights. fp32 both
    sides, 12 layers summed in other orders: atol 1e-4 on losses of ~5
    and on weights moved by ~lr."""
    cfg = tgpt.GPTConfig.tiny(num_heads=2, num_layers=12,
                              use_flash_attention=True,
                              max_position_embeddings=64, hidden_dropout=0.0,
                              attention_dropout=0.0)
    feed = _train_feed(3, 64, cfg.vocab_size)
    arrays = tgpt.init_fluid_params(cfg, seed=4)
    runs = {}
    for device in ("cuda", "cpu"):
        model, _opt, _names, step = tgpt.build_gpt_lm_train_eager(
            cfg, 64, learning_rate=1e-3,
            device=None if device == "cuda" else "cpu")
        assert model.device.type == device
        tgpt.load_fluid_params(model, arrays)
        n0 = [fa.flash_attention_lse.launches, fa.flash_bwd_dq.launches,
              fa.flash_bwd_dkv.launches]
        losses = [step(feed) for _ in range(2)]
        n1 = [fa.flash_attention_lse.launches, fa.flash_bwd_dq.launches,
              fa.flash_bwd_dkv.launches]
        want = 2 * cfg.num_layers if device == "cuda" else 0
        assert [b - a for a, b in zip(n0, n1)] == [want] * 3
        runs[device] = (losses, {n: p.detach().cpu()
                                 for n, p in model.named_parameters()})
    torch.testing.assert_close(torch.tensor(runs["cuda"][0]),
                               torch.tensor(runs["cpu"][0]), atol=1e-4,
                               rtol=0)
    for name, p in runs["cuda"][1].items():
        torch.testing.assert_close(p, runs["cpu"][1][name], atol=1e-4,
                                   rtol=0, msg=name)


def test_train_step_with_dropout_on_card_is_seeded_and_finite():
    cfg = tgpt.GPTConfig.tiny(num_heads=2, use_flash_attention=True,
                              max_position_embeddings=64)
    feed = _train_feed(2, 64, cfg.vocab_size, seed=1)
    runs = []
    for _ in range(2):
        _model, _opt, _names, step = tgpt.build_gpt_lm_train_eager(
            cfg, 64, learning_rate=1e-3, seed=9)
        runs.append([step(feed) for _ in range(3)])
    assert runs[0] == runs[1]
    assert all(torch.isfinite(torch.tensor(runs[0])))


def test_program_train_step_on_card_matches_cpu():
    """The GPT train program (``build_gpt_lm_train``, 12 narrow layers,
    head_dim 32, dropout 0) through ``fluid.Executor`` on the card and on
    the CPU from the same weights: each flash kernel launches 12 times a
    step on the card, no forward is replayed, and the losses of two Adam
    steps and the updated weights agree (atol 1e-4, as the eager test)."""
    import numpy as np

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import profiler
    from paddle_tpu_torch.fluid.ops import registry

    cfg = tgpt.GPTConfig.tiny(num_heads=2, num_layers=12,
                              use_flash_attention=True,
                              max_position_embeddings=64, hidden_dropout=0.0,
                              attention_dropout=0.0)
    feed = _train_feed(3, 64, cfg.vocab_size)
    arrays = tgpt.init_fluid_params(cfg, seed=4)
    runs = {}
    for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
        with fluid.unique_name.guard():
            main, startup, _f, loss = tgpt.build_gpt_lm_train(
                cfg, 64, learning_rate=1e-3)
        exe = fluid.Executor(place)
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        tgpt.load_fluid_scope(scope, arrays)
        n0 = [fa.flash_attention_lse.launches, fa.flash_bwd_dq.launches,
              fa.flash_bwd_dkv.launches]
        r0 = profiler.get_counter(registry.REPLAY_COUNTER)
        losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                scope=scope)[0].reshape(-1)[0])
                  for _ in range(2)]
        n1 = [fa.flash_attention_lse.launches, fa.flash_bwd_dq.launches,
              fa.flash_bwd_dkv.launches]
        want = 2 * cfg.num_layers if isinstance(place, fluid.CUDAPlace) else 0
        assert [b - a for a, b in zip(n0, n1)] == [want] * 3
        assert profiler.get_counter(registry.REPLAY_COUNTER) == r0
        runs[str(place)] = (losses, {n: scope.get(n).detach().cpu()
                                     for n in arrays})
    (l_cuda, p_cuda), (l_cpu, p_cpu) = runs.values()
    np.testing.assert_allclose(l_cuda, l_cpu, atol=1e-4, rtol=0)
    for name, p in p_cuda.items():
        torch.testing.assert_close(p, p_cpu[name], atol=1e-4, rtol=0,
                                   msg=name)


def test_amp_program_step_on_card_matches_cpu():
    """The AMP program (``build_gpt_lm_train(use_amp=True)``, 12 narrow
    layers, head_dim 16, zero-padded to 32 in the kernels; dropout 0) on
    the card through the bf16 flash kernels and cuBLAS bf16 products, and
    on the CPU through the plain versions, from the same weights: each
    flash kernel launches 12 times a step with bf16 operands, no forward
    is replayed, and three losses agree within 2e-2 relative (bf16
    products summed in other orders on either side) while falling."""
    import numpy as np

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import profiler
    from paddle_tpu_torch.fluid.ops import registry

    cfg = tgpt.GPTConfig.tiny(num_layers=12, use_flash_attention=True,
                              max_position_embeddings=64, hidden_dropout=0.0,
                              attention_dropout=0.0)
    feed = _train_feed(3, 64, cfg.vocab_size)
    arrays = tgpt.init_fluid_params(cfg, seed=4)
    runs = {}
    for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
        with fluid.unique_name.guard():
            main, startup, _f, loss = tgpt.build_gpt_lm_train(
                cfg, 64, learning_rate=1e-3, use_amp=True)
        exe = fluid.Executor(place)
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        tgpt.load_fluid_scope(scope, arrays)
        n0 = [fa.flash_attention_lse.launches, fa.flash_bwd_dq.launches,
              fa.flash_bwd_dkv.launches]
        r0 = profiler.get_counter(registry.REPLAY_COUNTER)
        runs[str(place)] = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                          scope=scope)[0].reshape(-1)[0])
                            for _ in range(3)]
        n1 = [fa.flash_attention_lse.launches, fa.flash_bwd_dq.launches,
              fa.flash_bwd_dkv.launches]
        want = 3 * cfg.num_layers if isinstance(place, fluid.CUDAPlace) else 0
        assert [b - a for a, b in zip(n0, n1)] == [want] * 3
        assert profiler.get_counter(registry.REPLAY_COUNTER) == r0
    card, cpu = runs["CUDAPlace(0)"], runs["CPUPlace"]
    np.testing.assert_allclose(card, cpu, rtol=2e-2)
    assert card[2] < card[0] and cpu[2] < cpu[0]


def _program_and_eager_sessions(cfg, **kw):
    """A program-form session on the card over a scope holding seeded
    weights, and an eager session over a ``GPTLM`` whose parameters are
    that scope's tensors."""
    from paddle_tpu_torch import fluid

    scope = fluid.Scope()
    for name, arr in tgpt.init_fluid_params(cfg, seed=5).items():
        scope.set(name, torch.from_numpy(arr).cuda())
    prog = tdecode.DecodeSession(cfg, place=fluid.CUDAPlace(0), scope=scope,
                                 **kw)
    model = tgpt.share_fluid_scope(tgpt.GPTLM(cfg, device="meta"), scope)
    return prog, tdecode.DecodeSession(model, **kw)


def _same_step(prog, eager, call, *args):
    got = getattr(prog, call)(*args)
    want = getattr(eager, call)(*args)
    if want is not None:
        torch.testing.assert_close(torch.as_tensor(got),
                                   torch.as_tensor(want), atol=1e-4,
                                   rtol=0, msg=call)


def test_program_decode_steps_on_card_match_eager_steps():
    """The program-form session (``build_gpt_prefill`` /
    ``build_gpt_decode_step`` through ``fluid.Executor(CUDAPlace(0))``,
    12 narrow layers, head_dim 32) against the eager session over the
    same parameter tensors, call by call: logits within 1e-4 (fp32 on
    both sides, products as other cuBLAS shapes), the caches within
    1e-5, ``flash_fwd`` 12 launches a prefill and ``flash_decode`` 12 a
    decode step."""
    cfg = tgpt.GPTConfig.tiny(num_heads=2, num_layers=12,
                              use_flash_attention=True,
                              max_position_embeddings=64, hidden_dropout=0.0,
                              attention_dropout=0.0)
    prog, eager = _program_and_eager_sessions(
        cfg, slots=3, max_len=64, prefill_buckets=[16, 64], block_size=0,
        spec_tokens=0)
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2, 3, 8]]
    for slot, p in enumerate(prompts):
        f0 = fa.flash_attention_lse.launches
        _same_step(prog, eager, "prefill", slot, p)
        # the eager prefill launches 12, the program's 12
        assert fa.flash_attention_lse.launches - f0 == 2 * cfg.num_layers
    for t in range(6):
        n0 = fa.flash_decode_attention.launches
        _same_step(prog, eager, "decode_step", [7 + t, 11, 0],
                   [5 + t, 14 + t, 0], [True, True, False])
        # 12 launches a step each, the program's and the eager one's
        assert fa.flash_decode_attention.launches - n0 == 2 * cfg.num_layers
    torch.cuda.synchronize()
    for (pk, pv), (ek, ev) in zip(prog.caches, eager.caches):
        torch.testing.assert_close(pk, ek, atol=1e-5, rtol=0)
        torch.testing.assert_close(pv, ev, atol=1e-5, rtol=0)


def test_program_paged_steps_on_card_match_eager_steps():
    """The paged program session (block 4, width 4) against the eager
    one over the same parameter tensors: windows through a table, width-1
    steps (``flash_decode_paged`` 12 launches each), a width-4 verify
    (gather + dense: no paged launch) and a block copy; logits within
    1e-4 and the pools within 1e-5."""
    cfg = tgpt.GPTConfig.tiny(num_heads=2, num_layers=12,
                              use_flash_attention=True,
                              max_position_embeddings=64, hidden_dropout=0.0,
                              attention_dropout=0.0)
    prog, eager = _program_and_eager_sessions(
        cfg, slots=2, max_len=56, prefill_buckets=[8], block_size=4,
        spec_tokens=4, window_cap=8)
    tables = [[3, 5, 6, 1], [7, 8]]
    _same_step(prog, eager, "paged_window", tables[0], list(range(1, 9)), 0)
    _same_step(prog, eager, "paged_window", tables[0], [4, 4, 2], 8)
    _same_step(prog, eager, "paged_window", tables[1], [6, 1, 6], 0)
    for t in range(4):
        n0 = fa.flash_decode_paged_attention.launches
        _same_step(prog, eager, "paged_step", [[9], [3]], [11 + t, 3 + t],
                   tables, [True, True])
        # 12 launches a step each, the program's and the eager one's
        assert fa.flash_decode_paged_attention.launches - n0 == \
            2 * cfg.num_layers
    n0 = fa.flash_decode_paged_attention.launches
    _same_step(prog, eager, "paged_step", [[1, 2, 3, 4]] * 2, [15, 7],
               tables, [True, True], 4)
    assert fa.flash_decode_paged_attention.launches == n0
    _same_step(prog, eager, "block_copy", [6], [9])
    torch.cuda.synchronize()
    for (pk, pv), (ek, ev) in zip(prog.caches, eager.caches):
        torch.testing.assert_close(pk, ek, atol=1e-5, rtol=0)
        torch.testing.assert_close(pv, ev, atol=1e-5, rtol=0)


# the Transformer NMT's three attention forms at chip_smoke.py's training
# shape (batch 64, 8 heads, head dim 64, source 64, target 48):
# (name, causal, Sq, Sk)
_NMT_FORMS = [("encoder", False, 64, 64), ("decoder_self", True, 48, 48),
              ("cross", False, 48, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("form,causal,Sq,Sk", _NMT_FORMS,
                         ids=[f[0] for f in _NMT_FORMS])
def test_flash_training_kernels_at_the_nmt_forms(form, causal, Sq, Sk,
                                                 dtype):
    """The three training kernels at the NMT path's forms, [64, 8, Sq, 64]
    queries against [64, 8, Sk, 64] keys under a ragged per-batch key
    bias (each row's real source or target length, the rest -1e4),
    dropout 0 as the parity runs: fp32 at the kernel limits above, bf16
    at ``lowp_limits``'s."""
    gen = torch.Generator().manual_seed(Sq * 3 + Sk + causal)
    B, N, D = 64, 8, 64
    lens = torch.randint(Sk // 3, Sk + 1, (B,), generator=gen)
    kb = (torch.arange(Sk)[None, :] >= lens[:, None]).float() * -1e4
    kb = kb.cuda()
    q = _randn(gen, B, N, Sq, D).to(dtype)
    k, v = (_randn(gen, B, N, Sk, D).to(dtype) for _ in range(2))
    g = _randn(gen, B, N, Sq, D).to(dtype)
    if dtype != torch.float32:
        _check_low_precision(dtype, q, k, v, kb, g, None, causal, 0.0, None)
        return
    out, lse = fa.flash_attention_lse(q, k, v, kb, causal=causal)
    grads = fa.flash_attention_bwd_from_residuals(q, k, v, kb, None, out,
                                                  lse, g, causal=causal)
    ref_out, ref_lse = fa.flash_attention_lse_plain(q, k, v, key_bias=kb,
                                                    causal=causal)
    ref = fa.flash_attention_bwd_plain(q, k, v, kb, None, ref_out, ref_lse,
                                       g, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref_out, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(lse, ref_lse, atol=ATOL, rtol=RTOL)
    for name, got, want in zip(("dq", "dk", "dv", "dkey_bias"), grads, ref):
        torch.testing.assert_close(got, want, atol=BWD_ATOL, rtol=RTOL,
                                   msg=name)


def test_nmt_program_step_on_card_matches_cpu():
    """``build_transformer_train(TransformerConfig.tiny, 12, 10)``, flash,
    label smoothing 0.1, dropout 0, on ragged masks through
    ``fluid.Executor`` on the card and on the CPU from the same weights:
    each training kernel launches 3 times a layer pair a step on the
    card, the step counter counts on both, and two Adam steps' losses
    agree within 1e-4 and their gradients within 1e-3 relative norm
    (+ 1e-7 absolute for the k-projection biases, whose exact gradient
    is 0)."""
    import numpy as np

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import transformer as tfm

    cfg = tfm.TransformerConfig.tiny(use_flash_attention=True, dropout=0.0)
    rs = np.random.RandomState(0)
    B, S, T = 4, 12, 10
    src_mask = (np.arange(S)[None, :] < np.array([[12], [7], [3], [10]])
                ).astype(np.float32)[..., None]
    tgt_mask = (np.arange(T)[None, :] < np.array([[10], [6], [4], [8]])
                ).astype(np.float32)[..., None]
    feed = {"src_ids": rs.randint(2, 1000, (B, S, 1)),
            "src_pos": np.tile(np.arange(S).reshape(1, S, 1), (B, 1, 1)),
            "src_mask": src_mask,
            "tgt_ids": rs.randint(2, 1000, (B, T, 1)),
            "tgt_pos": np.tile(np.arange(T).reshape(1, T, 1), (B, 1, 1)),
            "tgt_mask": tgt_mask, "labels": rs.randint(2, 1000, (B, T, 1))}
    arrays = None
    runs = {}
    for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
        with fluid.unique_name.guard():
            main, startup, _f, loss = tfm.build_transformer_train(cfg, S, T)
        names = sorted(p.name for p in main.all_parameters() if p.trainable)
        exe = fluid.Executor(place)
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        if arrays is None:
            arrays = {v.name: scope.get(v.name).cpu().numpy().copy()
                      for v in main.list_vars() if v.persistable}
        else:
            fluid.load_program_scope(main, scope, arrays)
        n0 = [fa.flash_attention_lse.launches, fa.flash_bwd_dq.launches,
              fa.flash_bwd_dkv.launches]
        out = [exe.run(main, feed=feed, fetch_list=[loss] + [
            n + "@GRAD" for n in names], scope=scope) for _ in range(2)]
        n1 = [fa.flash_attention_lse.launches, fa.flash_bwd_dq.launches,
              fa.flash_bwd_dkv.launches]
        want = 2 * 3 * cfg.num_layers \
            if isinstance(place, fluid.CUDAPlace) else 0
        assert [b - a for a, b in zip(n0, n1)] == [want] * 3
        assert int(scope.get("@LR_DECAY_COUNTER@").item()) == 2
        runs[str(place)] = out
    (cuda, cpu) = runs.values()
    for step in range(2):
        np.testing.assert_allclose(cuda[step][0], cpu[step][0], atol=1e-4)
        for got, want in zip(cuda[step][1:], cpu[step][1:]):
            # + 1e-7: the k-projection biases' exact gradient is 0
            d = np.linalg.norm(got - want)
            assert d <= 1e-3 * np.linalg.norm(want) + 1e-7


def test_while_and_conditional_block_on_card_match_cpu():
    """A ``While`` RNN (mem = tanh(mem @ W + x_t) over a time-major
    array, 6 steps) and a ``cond`` after it, with ``append_backward``,
    through ``fluid.Executor`` on the card and on the CPU from the same
    weights: the loss within 1e-5 relative and dloss/dW within 1e-4
    relative norm."""
    import numpy as np

    from paddle_tpu_torch import fluid

    B, T, H = 4, 6, 16
    xb = np.random.RandomState(1).randn(B, T, H).astype(np.float32)
    w0 = np.random.RandomState(2).randn(H, H).astype(np.float32) * 0.3
    out = []
    for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[T, H], dtype="float32")
            arr = fluid.layers.lod_tensor_to_array(
                x, fluid.layers.lod_rank_table(x))
            i = fluid.layers.fill_constant(shape=[1], dtype="int64", value=0)
            n = fluid.layers.fill_constant(shape=[1], dtype="int64", value=T)
            mem = fluid.layers.fill_constant(shape=[B, H], dtype="float32",
                                             value=0.0)
            mem.stop_gradient = False
            W = fluid.layers.create_parameter(shape=[H, H], dtype="float32",
                                              name="W")
            cond = fluid.layers.less_than(i, n)
            loop = fluid.layers.While(cond)
            with loop.block():
                xt = fluid.layers.array_read(arr, i)
                fluid.layers.assign(fluid.layers.tanh(
                    fluid.layers.matmul(mem, W) + xt), output=mem)
                fluid.layers.increment(i, value=1, in_place=True)
                fluid.layers.less_than(i, n, cond=cond)
            s = fluid.layers.reduce_mean(mem)
            zero = fluid.layers.fill_constant(shape=[1], dtype="float32",
                                              value=0.0)
            loss = fluid.layers.cond(fluid.layers.greater_than(s, zero),
                                     lambda: s * 2.0, lambda: s * -1.0)
            (_p, g), = fluid.backward.append_backward(loss)
        exe = fluid.Executor(place)
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        scope.set("W", torch.from_numpy(w0.copy()).to(exe.device))
        out.append(exe.run(main, feed={"x": xb}, fetch_list=[loss, g],
                           scope=scope))
    (lc, gc), (lp, gp) = out
    np.testing.assert_allclose(lc, lp, rtol=1e-5)
    assert np.linalg.norm(gc - gp) <= 1e-4 * np.linalg.norm(gp)
