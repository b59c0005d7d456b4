"""Hold the flash kernels of this tree against an older tree's on the
card: bit for bit where the arithmetic is meant to be unchanged, within
the card's limits against the plain versions where this tree redesigned
a kernel.

Each kernel form keeps its arithmetic statement for statement while
other forms grow beside it, until a PR replaces that form. This script
builds both trees' kernels, runs them on the same inputs and applies one
check to each (kernel, element type), printed beside its result:

- ``bits``: this tree's output equals the older tree's (``torch.equal``),
  on the same operands (the backward kernels on this tree's lse and
  delta): ``flash_fwd`` (out, lse), ``flash_bwd_dq`` and
  ``flash_bwd_dkv`` (dk, dv, dkey_bias; dbias of heads sharing a row is
  summed with float atomics in no fixed order and is held to 1e-5) in
  fp32, bf16 and fp16;
- ``limit``: the forms redesigned since the older tree are held to their
  plain versions instead, the largest difference from the older tree's
  output printed beside it: both decode kernels (split-K over a cluster,
  fed by a copy ring), contiguous and paged, in fp32 at the forward's
  atol 2e-5 / rtol 1e-4 and in bf16 and fp16 within
  ``lowp_limits.out_bound``.

The training kernels run at the train and prefill shapes and ragged ones
(key bias, causal, dropout 0 and 0.1, with and without a per-head
general bias). A head dim of 48 runs through this tree's wrappers, which
zero-pad it to 64, and through the older tree's D = 64 kernels on the
same padded operands with the scale of D = 48. The decode kernels run,
contiguous and paged, at the serving shape and ragged ones (head dims 8
to 128).

It prints both trees' build seconds (each kernel's ``nvcc``, all of a
tree's started together), the ``ptxas`` register and spill lines of this
tree's builds, one ``bitcheck`` line per shape and type, and ``BITCHECK PASS`` or
``BITCHECK FAIL`` last; it exits 1 on a failed check.

Usage, from the repo root on a machine with a card and ``nvcc``::

    mkdir -p _archive/parent
    git archive <older commit> paddle_tpu_torch | tar -x -C _archive/parent
    python3 -m paddle_tpu_torch.tools.flash_bitcheck _archive/parent

The older tree is the one before the redesign, ``6fa595d``: a later
one holds forms of its own that are not the older bits, an earlier one
lacks the split-TF32 backward that this tree keeps bit for bit.
"""

import argparse
import importlib.util
import os
import sys
import time

import torch

from paddle_tpu_torch.kernels import _build, flash_attention as fa

KERNELS = ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"]
DECODE_KERNELS = ["flash_decode", "flash_decode_paged"]
# (B, N, S, D, dropout rate, key-bias form, per-head general bias)
SHAPES = [(8, 12, 1024, 64, 0.1, "batch", False),
          (8, 12, 1024, 64, 0.0, "batch", False),
          (1, 12, 1024, 64, 0.0, "batch", False),
          (2, 3, 100, 128, 0.1, None, False),
          (2, 3, 37, 32, 0.0, "batch", False),
          (2, 3, 100, 64, 0.1, "batch", True),
          (2, 3, 70, 48, 0.1, "batch", False),
          (2, 3, 70, 48, 0.0, None, True)]
# the bf16 and fp16 forms: the AMP train shape and ragged ones
LOWP_SHAPES = [(8, 12, 1024, 64, 0.1, "batch", False),
               (2, 3, 100, 128, 0.1, None, False),
               (2, 3, 100, 64, 0.1, "batch", True),
               (2, 3, 70, 48, 0.0, "batch", False),
               (1, 2, 130, 256, 0.1, "batch", False)]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}
# the (kernel, element type) forms redesigned since the older tree: held
# to their plain versions (the training kernels at the backward's limit,
# the decode kernels at the forward's and ``lowp_limits.out_bound``);
# every other form is held to the older bits
LIMIT_FORMS = {(k, et) for k in ("flash_decode", "flash_decode_paged")
               for et in ("f32", "bf16", "f16")}
BWD_ATOL, BWD_RTOL = 1e-4, 1e-4
FWD_ATOL, FWD_RTOL = 2e-5, 1e-4
# decode: (slots, heads, cache length, D, block size of the paged pool)
DECODE_SHAPES = [(8, 12, 1024, 64, 16), (4, 3, 300, 48, 4), (3, 2, 77, 8, 16),
                 (2, 3, 130, 128, 64), (4, 3, 1, 24, 1)]


def load_parent_build(parent):
    path = os.path.join(parent, "paddle_tpu_torch", "kernels", "_build.py")
    spec = importlib.util.spec_from_file_location("parent_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check(pb, B, N, S, D, rate, kbform, with_bias, dev, et="f32"):
    """Run both trees' training kernels on one shape in element type
    ``et``; {output: (check, passed, max abs difference from the older
    tree)}."""
    def parent_call(name, *args):
        err = pb.load(name, et)(*args, torch.cuda.current_stream().cuda_stream)
        assert err == 0, (name, err)

    dt = DTYPES[et]
    g = torch.Generator(device=dev).manual_seed(S + D)
    q, k, v, do = (torch.randn(B, N, S, D, device=dev, generator=g).to(dt)
                   for _ in range(4))
    kb = None
    if kbform:
        kb = torch.zeros(B, S, device=dev)
        kb[-1, S // 2:] = -1e4
    bias = (torch.randn(1, N, S, S, device=dev, generator=g) * 0.5
            if with_bias else None)
    seed = 4242 if rate else None
    on, sd, th, kp, inv = fa._dropout_args(rate, seed)
    kw = dict(causal=True, dropout_rate=rate, dropout_seed=seed, bias=bias)
    out, lse = fa.flash_attention_lse(q, k, v, kb, **kw)
    delta = (do.float() * out.float()).sum(-1)
    dq = fa.flash_bwd_dq(q, k, v, kb, do, lse, delta, **kw)
    dkv = fa.flash_bwd_dkv(q, k, v, kb, do, lse, delta, **kw)
    # the older tree's kernels at the width this tree runs D at, on the
    # same operands zero-padded to it, with the scale of the real D
    width = fa._train_head_dim("bitcheck", D)
    pq, pk, pv, pdo = fa._pad_head_dim(width, q, k, v, do)
    kbp = 0 if kb is None else kb.data_ptr()
    heads = 1 if kb is None else N
    nb, div, rows = fa._kernel_bias(bias, B, N, S, S)
    bp = 0 if nb is None else nb.data_ptr()
    scale = 1.0 / D ** 0.5
    pout, plse = torch.empty_like(pq), torch.empty_like(lse)
    parent_call("flash_fwd", pq.data_ptr(), pk.data_ptr(), pv.data_ptr(),
                kbp, bp, pout.data_ptr(), plse.data_ptr(), B * N, heads, div,
                rows, S, S, width, scale, 1, on, sd, th, kp)
    pdq = torch.empty_like(pq)
    parent_call("flash_bwd_dq", pq.data_ptr(), pk.data_ptr(), pv.data_ptr(),
                kbp, bp, pdo.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                pdq.data_ptr(), B * N, heads, div, rows, S, S, width, scale,
                1, on, sd, th, inv)
    pdk, pdv = torch.empty_like(pk), torch.empty_like(pv)
    pdkb = torch.empty_like(dkv[2])
    pdbias = None if nb is None else torch.zeros_like(nb)
    parent_call("flash_bwd_dkv", pq.data_ptr(), pk.data_ptr(), pv.data_ptr(),
                kbp, bp, pdo.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                pdk.data_ptr(), pdv.data_ptr(), pdkb.data_ptr(),
                0 if pdbias is None else pdbias.data_ptr(), B * N, heads,
                div, rows, S, S, width, scale, 1, on, sd, th, inv)
    torch.cuda.synchronize()
    diff = lambda a, b: float((a.float() - b.float()).abs().max())  # noqa
    ref_dq = ref_dkv = None
    if ("flash_bwd_dq", et) in LIMIT_FORMS:
        ref_dq = fa.flash_bwd_dq_plain(q, k, v, kb, do, lse, delta, **kw)
    if ("flash_bwd_dkv", et) in LIMIT_FORMS:
        ref_dkv = fa.flash_bwd_dkv_plain(q, k, v, kb, do, lse, delta, **kw)
    # (kernel, [(output, this tree's, older tree's, plain version's)])
    dkv_names = ("dk", "dv", "dkb", "dbias")[:len(dkv)]
    dkv_older = (pdk[..., :D], pdv[..., :D], pdkb, pdbias)
    outputs = [("flash_fwd", [("out", out, pout[..., :D], None),
                              ("lse", lse, plse, None)]),
               ("flash_bwd_dq", [("dq", dq, pdq[..., :D], ref_dq)]),
               ("flash_bwd_dkv", [(n, dkv[i], dkv_older[i],
                                   ref_dkv and ref_dkv[i])
                                  for i, n in enumerate(dkv_names)])]
    res = {}
    for kname, outs in outputs:
        for n, a, p, ref in outs:
            if (kname, et) in LIMIT_FORMS:
                ok = torch.allclose(a, ref, atol=BWD_ATOL, rtol=BWD_RTOL)
                res[n] = ("limit %g/%g" % (BWD_ATOL, BWD_RTOL), ok, diff(a, p))
            elif n == "dbias":
                # per-head rows shared by the batch: float atomics in no
                # fixed order, so dbias is held to rounding, not bits (see
                # the kernel)
                err = diff(a, p)
                res[n] = ("<=1e-5", err <= 1e-5, err)
            else:
                res[n] = ("bits", torch.equal(a, p), diff(a, p))
    return res


def decode_limit(et, got, want, q, k, v, kb):
    """(check, passed) of a decode output against its plain version:
    fp32 at the forward's atol / rtol, bf16 and fp16 per element within
    ``lowp_limits.out_bound``."""
    from paddle_tpu_torch.tools import lowp_limits as lowp

    if et == "f32":
        return ("limit %g/%g" % (FWD_ATOL, FWD_RTOL),
                torch.allclose(got, want, atol=FWD_ATOL, rtol=FWD_RTOL))
    bound = lowp.out_bound(q.dtype, q, k, v, want, key_bias=kb)
    ratio = float(lowp.out_ratios(q.dtype, got, want, bound)["elem"])
    return "out_bound (%.3f)" % ratio, ratio <= 1


def check_decode(pb, B, N, S, D, blk, dev, et="f32"):
    """Both trees' decode kernels on one shape in element type ``et``;
    {output: (check, passed, max abs difference from the older tree)}."""
    dt = DTYPES[et]
    g = torch.Generator(device=dev).manual_seed(S * 3 + D)
    q = torch.randn(B, N, 1, D, device=dev, generator=g).to(dt)
    k, v = (torch.randn(B, N, S, D, device=dev, generator=g).to(dt)
            for _ in range(2))
    kb = torch.zeros(B, S, device=dev)
    for b in range(B):
        kb[b, (b * 37) % S + 1:] = -1e4
    stream = torch.cuda.current_stream().cuda_stream
    scale = 1.0 / D ** 0.5
    out = fa.flash_decode_attention(q, k, v, kb)
    pout = torch.empty_like(q)
    err = pb.load("flash_decode", et)(q.data_ptr(), k.data_ptr(),
                                      v.data_ptr(), kb.data_ptr(),
                                      pout.data_ptr(), B * N, N, S, D, scale,
                                      stream)
    assert err == 0, ("flash_decode", err)
    MB = (S + blk - 1) // blk
    pools = [torch.randn(B * MB + 1, N, blk, D, device=dev, generator=g)
             .to(dt) for _ in range(2)]
    tables = (torch.randperm(B * MB, device=dev, generator=g) + 1).reshape(
        B, MB).to(torch.int32)
    pkb = torch.zeros(B, MB * blk, device=dev)
    pkb[:, S:] = -1e4
    paged = fa.flash_decode_paged_attention(q, pools[0], pools[1], tables, pkb)
    ppaged = torch.empty_like(q)
    err = pb.load("flash_decode_paged", et)(
        q.data_ptr(), pools[0].data_ptr(), pools[1].data_ptr(),
        tables.data_ptr(), pkb.data_ptr(), ppaged.data_ptr(), B * N, N, N, MB,
        blk, pools[0].shape[0], D, scale, stream)
    assert err == 0, ("flash_decode_paged", err)
    torch.cuda.synchronize()
    diff = lambda a, b: float((a.float() - b.float()).abs().max())  # noqa
    ref = fa.flash_decode_attention_plain(q, k, v, key_bias=kb)
    rows = [fa.gather_paged_rows(p, tables.long()) for p in pools]
    pref = fa.flash_decode_attention_plain(q, *rows, key_bias=pkb)
    res = {}
    for name, kname, got, older, want, kk, vv, bias in (
            ("decode", "flash_decode", out, pout, ref, k, v, kb),
            ("decode_paged", "flash_decode_paged", paged, ppaged, pref,
             rows[0], rows[1], pkb)):
        if (kname, et) in LIMIT_FORMS:
            check, ok = decode_limit(et, got, want, q, kk, vv, bias)
            res[name] = (check, ok, diff(got, older))
        else:
            res[name] = ("bits", torch.equal(got, older), diff(got, older))
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", help="directory holding the older tree's "
                                   "paddle_tpu_torch/")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_bitcheck: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.time()
    res = _build.build(KERNELS + DECODE_KERNELS)
    print("build s", round(time.time() - t0, 1),
          {k: round(r["seconds"], 1) for k, r in res.items()})
    for name, r in res.items():
        for line in r["log"].splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry")):
                print(name, line.strip())
    pb = load_parent_build(args.parent)
    t0 = time.time()
    older = pb.build(KERNELS + DECODE_KERNELS)
    print("older tree build s", round(time.time() - t0, 1),
          {k: round(r["seconds"], 1) for k, r in older.items()})
    dev = torch.device("cuda")
    ok = True
    runs = ([(shape, "f32") for shape in SHAPES]
            + [(shape, et) for et in ("bf16", "f16") for shape in LOWP_SHAPES])
    for shape, et in runs:
        res = check(pb, *shape, dev, et)
        print("bitcheck", et, shape, res)
        ok = ok and all(r[1] for r in res.values())
    for et in ("f32", "bf16", "f16"):
        for shape in DECODE_SHAPES:
            res = check_decode(pb, *shape, dev, et)
            print("bitcheck decode", et, shape, res)
            ok = ok and all(r[1] for r in res.values())
    print("BITCHECK", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
