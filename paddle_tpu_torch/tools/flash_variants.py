"""Time edited variants of the fp32 backward kernels on the card, to see
where their time goes and what a design choice is worth.

Each variant is this tree's ``csrc/`` with named text edits (every
occurrence of each edit's text is replaced; a text that is not found
fails the run), built with ``_build``'s flags into a directory of its own,
all builds started together. ``flash_bwd_dq`` and ``flash_bwd_dkv`` of
each variant (only those its edits touch) then run in fp32 at the fp32
train shape [8, 12, 1024, 64], causal, with a key-padding bias and
dropout 0.1, from the forward's out and lse. Per variant and kernel it
prints one line: device ms per call (CUDA events over 50 calls after 5
warm-up calls, which at ~1 ms a call hide the host's per-call cost), the
largest difference from the plain version, whether the backward's limit
(atol 1e-4 / rtol 1e-4) holds, and for dk/dv the norm of the sum over
keys of dk relative to dk's norm: that sum is exactly 0 and reads ~1e-7
of rounding noise, so a sum that the tensor cores bias shows there. The
unedited tree runs first and last.

Variants:

- ``tree``: the kernels as they are;
- ``serial``: each n-tile's three split products back to back, not
  stage by stage across four n-tiles (``mma_3xtf32_n``);
- ``straight``: the three products added straight into the running
  sums, not summed from zero per k-step;
- ``straight_sdp``: the same for S and dP only (summed from zero over a
  tile's D), dq, dk and dv as in the tree;
- ``dq_bk16``, ``dq_bk64``, ``dkv_bq16``, ``dkv_bq64``: other key and
  query tile heights at D = 64 (the tree's: 32);
- ablations, whose results are wrong and whose time shows a part's cost:
  ``one_tf32`` (one TF32 product, not three), ``no_split`` (the streamed
  tiles not split), ``no_elem`` (no exp and no dropout hash).

Usage, from the repo root on a machine with a card and ``nvcc``::

    python3 -m paddle_tpu_torch.tools.flash_variants [variant ...]
"""

import argparse
import ctypes
import math
import os
import shutil
import subprocess
import sys
import tempfile

import torch

from paddle_tpu_torch.kernels import _build, flash_attention as fa

DQ, DKV, MMA = "flash_bwd_dq.cu", "flash_bwd_dkv.cu", "flash_mma.cuh"
KERNELS = {DQ: "flash_bwd_dq", DKV: "flash_bwd_dkv"}
# the body of `mma_3xtf32_n` in flash_mma.cuh, which several variants
# replace
_STAGED = """\
  float t[N][4];
#pragma unroll
  for (int i = 0; i < N; ++i) t[i][0] = t[i][1] = t[i][2] = t[i][3] = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) mma1688_tf32(t[i], as, bb[i].x, bb[i].y);
#pragma unroll
  for (int i = 0; i < N; ++i) mma1688_tf32(t[i], ab, bs[i].x, bs[i].y);
#pragma unroll
  for (int i = 0; i < N; ++i) mma1688_tf32(t[i], ab, bb[i].x, bb[i].y);
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) d[i][e] += t[i][e];
  }
"""
_SERIAL = """\
#pragma unroll
  for (int i = 0; i < N; ++i) {
    mma_3xtf32(d[i], ab, as, bb[i].x, bb[i].y, bs[i].x, bs[i].y);
  }
"""
_STRAIGHT = """\
#pragma unroll
  for (int i = 0; i < N; ++i) mma1688_tf32(d[i], as, bb[i].x, bb[i].y);
#pragma unroll
  for (int i = 0; i < N; ++i) mma1688_tf32(d[i], ab, bs[i].x, bs[i].y);
#pragma unroll
  for (int i = 0; i < N; ++i) mma1688_tf32(d[i], ab, bb[i].x, bb[i].y);
"""
_ONE = """\
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    mma1688_tf32(t, ab, bb[i].x, bb[i].y);
#pragma unroll
    for (int e = 0; e < 4; ++e) d[i][e] += t[e];
  }
"""
# a line of flash_mma.cuh before which `straight_sdp` puts its helper
_ROWS = ("// Rows [row0, row0 + ROWS) of a [n_rows, D] matrix in device memory"
         " into")
_STRAIGHT_HELPER = """\
template <int N>
__device__ __forceinline__ void mma_3xtf32_n_into(float (*d)[4],
                                                  const unsigned (&ab)[4],
                                                  const unsigned (&as)[4],
                                                  const uint2* bb,
                                                  const uint2* bs) {
%s}

""" % _STRAIGHT + _ROWS
_DQ_BK = "return D <= 64 ? 32 : D == 128 ? 16 : 8;"
_DKV_BQ = "return D <= 64 ? 32 : 16;"

# name -> [(file, text, replacement)]
VARIANTS = {
    "tree": [],
    "serial": [(MMA, _STAGED, _SERIAL)],
    "straight": [(MMA, _STAGED, _STRAIGHT)],
    "straight_sdp": [
        (MMA, _ROWS, _STRAIGHT_HELPER),
        (DQ, "mma_3xtf32_n<kNT>(s,", "mma_3xtf32_n_into<kNT>(s,"),
        (DQ, "mma_3xtf32_n<kNT>(dp,", "mma_3xtf32_n_into<kNT>(dp,"),
        (DKV, "mma_3xtf32_n<kNQ>(st,", "mma_3xtf32_n_into<kNQ>(st,"),
        (DKV, "mma_3xtf32_n<kNQ>(dpt,", "mma_3xtf32_n_into<kNQ>(dpt,")],
    "dq_bk16": [(DQ, _DQ_BK, _DQ_BK.replace("? 32", "? 16"))],
    "dq_bk64": [(DQ, _DQ_BK, _DQ_BK.replace("? 32", "? 64"))],
    "dkv_bq16": [(DKV, _DKV_BQ, _DKV_BQ.replace("? 32", "? 16"))],
    "dkv_bq64": [(DKV, _DKV_BQ, _DKV_BQ.replace("? 32", "? 64"))],
    "one_tf32": [(MMA, _STAGED, _ONE)],
    "no_split": [
        (DQ, "split_tile_tf32<D, BK, kMmaThreads>(ks + (t & 1) * BK * D, kss, "
             "tid);", ""),
        (DQ, "split_tile_tf32<D, BK, kMmaThreads>(vs + (t & 1) * BK * D, vss, "
             "tid);", ""),
        (DKV, "split_tile_tf32<D, BQ, kMmaThreads>(qs + stage * BQ * D, qss, "
              "tid);", ""),
        (DKV, "split_tile_tf32<D, BQ, kMmaThreads>(dos + stage * BQ * D, "
              "doss, tid);", "")],
    "no_elem": [
        (DQ, "exp2f((x - lse_r[r]) * kLog2e)", "((x - lse_r[r]) * kLog2e)"),
        (DQ, "hash_keep(row_h[r]", "true || (row_h[r]"),
        (DKV, "exp2f((x - ls[qr]) * kLog2e)", "((x - ls[qr]) * kLog2e)"),
        (DKV, "hash_keep(row_hash((unsigned)qi)",
         "true || (row_hash((unsigned)qi)")],
}


def build_variants(names, root):
    """{(variant, kernel): ctypes function} for the kernels each variant's
    edits touch (every kernel for ``tree`` and for header edits)."""
    nvcc = _build.nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    procs = {}
    for name in names:
        edits = VARIANTS[name]
        src = os.path.join(root, name)
        shutil.copytree(_build.SRC_DIR, src)
        for fn, text, new in edits:
            path = os.path.join(src, fn)
            with open(path) as f:
                code = f.read()
            if text not in code:
                raise ValueError("variant %s: text not found in %s: %r"
                                 % (name, fn, text[:60]))
            with open(path, "w") as f:
                f.write(code.replace(text, new))
        files = {fn for fn, _t, _n in edits}
        for fn, kernel in KERNELS.items():
            if edits and MMA not in files and fn not in files:
                continue
            lib = os.path.join(src, "lib%s.so" % kernel)
            cmd = [nvcc] + _build.NVCC_FLAGS + ["-o", lib,
                                                os.path.join(src, fn)]
            procs[(name, kernel)] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), lib)
    fns = {}
    for key, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError("%s failed to build:\n%s" % (key, log[-4000:]))
        prefix, _types, argtypes = _build.KERNELS[key[1]]
        fn = getattr(ctypes.CDLL(lib), prefix + "_f32")
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[key] = fn
    return fns


def event_ms(fn, reps=50):
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", choices=list(VARIANTS),
                    metavar="variant", help="default: all")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device", file=sys.stderr)
        return 1
    names = ["tree"] + [n for n in args.variants or VARIANTS if n != "tree"]
    root = tempfile.mkdtemp(prefix="flash_variants_")
    try:
        fns = build_variants(names, root)
        dev = torch.device("cuda")
        gen = torch.Generator().manual_seed(3)
        B, N, T, D = 8, 12, 1024, 64
        rate, seed = 0.1, 1234567
        scale = 1.0 / math.sqrt(D)
        q, k, v, g = (torch.randn(B, N, T, D, generator=gen).to(dev)
                      for _ in range(4))
        kb = torch.zeros(B, T)
        kb[1, 700:] = -1e4
        kb[5, 1000:] = -1e4
        kb = kb.to(dev)
        kw = dict(causal=True, scale=scale, dropout_rate=rate,
                  dropout_seed=seed)
        out, lse = fa.flash_attention_lse(q, k, v, kb, **kw)
        delta = (g * out).sum(-1)
        bwd = (q, k, v, kb, g, lse, delta)
        ref = {"flash_bwd_dq": (fa.flash_bwd_dq_plain(*bwd, **kw),),
               "flash_bwd_dkv": fa.flash_bwd_dkv_plain(*bwd, **kw)}
        on, sd, th, _keep, inv = fa._dropout_args(rate, seed)
        outs = {"flash_bwd_dq": (torch.empty_like(q),),
                "flash_bwd_dkv": (torch.empty_like(k), torch.empty_like(v),
                                  torch.empty(B * N, T, device=dev))}
        head = [t.data_ptr() for t in (q, k, v, kb)] + [0] + [
            t.data_ptr() for t in (g, lse, delta)]

        def launcher(key):
            ptrs = head + [t.data_ptr() for t in outs[key[1]]]
            if key[1] == "flash_bwd_dkv":
                ptrs.append(0)                       # no dbias
            tail = [B * N, N, 1, 1, T, T, D, scale, 1, on, sd, th, inv]

            def run():
                err = fns[key](*ptrs, *tail,
                               torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError("%s: CUDA error %d" % (key, err))
            return run

        print(torch.cuda.get_device_name(0), flush=True)
        for key in list(fns) + [key for key in fns if key[0] == "tree"]:
            run = launcher(key)
            ms = event_ms(run)
            run()
            torch.cuda.synchronize()
            got, want = outs[key[1]], ref[key[1]]
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            ok = all(torch.allclose(a, b, atol=1e-4, rtol=1e-4)
                     for a, b in zip(got, want))
            line = "variant %-12s %-13s %.4f ms  max abs err %.3g  limit %s" % (
                key[0], key[1], ms, err, "ok" if ok else "MISSED")
            if key[1] == "flash_bwd_dkv":
                dk = got[0].double()
                line += "  sum_keys dk / |dk| %.3g" % float(
                    dk.sum(2).norm() / dk.norm())
            print(line, flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
