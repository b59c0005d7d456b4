"""Hold the no-bias flash kernels of this tree against an older tree's,
bit for bit, on the card.

The general-bias forms of ``flash_fwd``, ``flash_bwd_dq`` and
``flash_bwd_dkv`` are template instantiations beside the no-bias ones,
which must keep their arithmetic statement for statement. This script
builds both trees' three kernels, runs them on the same inputs (key
bias, causal, dropout 0 and 0.1, at the train and prefill shapes and two
ragged ones) and compares out, lse, dq, dk, dv and dkey_bias with
``torch.equal``. It prints the ``ptxas`` register and spill lines of
this tree's builds, one ``bitcheck`` line per shape, and ``BITCHECK
PASS`` or ``BITCHECK FAIL`` last; it exits 1 on a mismatch.

Usage, from the repo root on a machine with a card and ``nvcc``::

    mkdir -p _archive/parent
    git archive <older commit> paddle_tpu_torch | tar -x -C _archive/parent
    python3 -m paddle_tpu_torch.tools.flash_bitcheck _archive/parent

The older tree's kernels must take the argument list they had before the
general bias was added (as in the commit that ported the backward).
"""

import argparse
import importlib.util
import os
import sys
import time

import torch

from paddle_tpu_torch.kernels import _build, flash_attention as fa

KERNELS = ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"]
SHAPES = [(8, 12, 1024, 64, 0.1, "batch"), (8, 12, 1024, 64, 0.0, "batch"),
          (1, 12, 1024, 64, 0.0, "batch"), (2, 3, 100, 128, 0.1, None),
          (2, 3, 37, 32, 0.0, "batch")]


def load_parent_build(parent):
    path = os.path.join(parent, "paddle_tpu_torch", "kernels", "_build.py")
    spec = importlib.util.spec_from_file_location("parent_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check(pb, B, N, S, D, rate, kbform, dev):
    """Run both trees' kernels on one shape; {output: equal}."""
    def parent_call(name, *args):
        err = pb.load(name)(*args, torch.cuda.current_stream().cuda_stream)
        assert err == 0, (name, err)

    g = torch.Generator(device=dev).manual_seed(S + D)
    q, k, v, do = (torch.randn(B, N, S, D, device=dev, generator=g)
                   for _ in range(4))
    kb = None
    if kbform:
        kb = torch.zeros(B, S, device=dev)
        kb[-1, S // 2:] = -1e4
    seed = 4242 if rate else None
    on, sd, th, kp, inv = fa._dropout_args(rate, seed)
    kw = dict(causal=True, dropout_rate=rate, dropout_seed=seed)
    out, lse = fa.flash_attention_lse(q, k, v, kb, **kw)
    delta = (do * out).sum(-1)
    dq = fa.flash_bwd_dq(q, k, v, kb, do, lse, delta, **kw)
    dk, dv, dkb = fa.flash_bwd_dkv(q, k, v, kb, do, lse, delta, **kw)
    kbp = 0 if kb is None else kb.data_ptr()
    heads = 1 if kb is None else N
    scale = 1.0 / D ** 0.5
    pout, plse = torch.empty_like(q), torch.empty_like(lse)
    parent_call("flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(), kbp,
                pout.data_ptr(), plse.data_ptr(), B * N, heads, S, S, D,
                scale, 1, on, sd, th, kp)
    pdq = torch.empty_like(q)
    parent_call("flash_bwd_dq", q.data_ptr(), k.data_ptr(), v.data_ptr(), kbp,
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                pdq.data_ptr(), B * N, heads, S, S, D, scale, 1, on, sd, th,
                inv)
    pdk, pdv, pdkb = (torch.empty_like(k), torch.empty_like(v),
                      torch.empty_like(dkb))
    parent_call("flash_bwd_dkv", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                kbp, do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                pdk.data_ptr(), pdv.data_ptr(), pdkb.data_ptr(), B * N, heads,
                S, S, D, scale, 1, on, sd, th, inv)
    torch.cuda.synchronize()
    return {n: torch.equal(a, b) for n, a, b in (
        ("out", out, pout), ("lse", lse, plse), ("dq", dq, pdq),
        ("dk", dk, pdk), ("dv", dv, pdv), ("dkb", dkb, pdkb))}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", help="directory holding the older tree's "
                                   "paddle_tpu_torch/")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_bitcheck: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.time()
    res = _build.build(KERNELS)
    print("build s", round(time.time() - t0, 1))
    for name, r in res.items():
        for line in r["log"].splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry")):
                print(name, line.strip())
    pb = load_parent_build(args.parent)
    pb.build(KERNELS)
    dev = torch.device("cuda")
    ok = True
    for shape in SHAPES:
        same = check(pb, *shape, dev)
        print("bitcheck", shape, same)
        ok = ok and all(same.values())
    print("BITCHECK", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
