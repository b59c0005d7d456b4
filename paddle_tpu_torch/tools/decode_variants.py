"""Time the decode kernels on the card across pool layouts, split counts
and edited variants of their sources, to see where their time goes.

Each source variant is a tree's ``csrc/`` with named text edits (every
occurrence of each edit's text is replaced; a text that is not found
fails the run), built with ``_build``'s flags into a directory of its own,
all builds started together. The tree is this one, or with ``--tree DIR``
an older one (a directory holding ``paddle_tpu_torch/``, as
``git archive <commit> paddle_tpu_torch`` unpacks it), whose own
``_build.py`` gives its entry points' arguments; a tree from before the
split-K design (no ``csrc/flash_decode.cuh``) has its own variants.

Every kernel reads the same bytes: 8 slots x 12 heads x 1024 keys of
K and V at D = 64 (50 MB in fp32, 25 MB in bf16), four copies cycled so
each call reads cold data. Layouts:

- ``contiguous``: ``flash_decode`` on the cache [8, 12, 1024, 64];
- ``perm16``: ``flash_decode_paged`` on a pool of 513 blocks of 16
  positions, the tables a random permutation of blocks 1..512 (the
  serving layout, without prefix sharing or sink slots);
- ``ident16``: the same pool, slot b's logical block i at pool block
  1 + 64 b + i (each block still holds all 12 heads, so a head's rows are
  4 KB runs 48 KB apart in fp32);
- ``contig16``: the pool laid out as the contiguous cache: heads folded
  into slots (pool [1 + 96 * 64, 1, 16, 64], 96 slots of one head,
  identity tables), so the kernel reads exactly the bytes
  ``contiguous`` reads, in the same order;
- ``perm32``, ``perm64``: random permutations of blocks of 32 and 64
  positions;
- ``contiguous_d16``, ``perm16_d16``: the first two at D = 16 (a
  quarter of the bytes), for the fixed-D instantiation at 16 against the
  run-time-D form;
- ``short``: ``flash_decode`` on one slot's cache [1, 12, 1024, 64] (12
  rows: a short batch, whose split count ``_decode_splits`` raises to
  fill the SMs), on the ``tree`` variant at every split count.

Per (variant, layout, element type) it prints one line: device ms per
call (a CUDA graph of 20 calls replayed over five windows of >= 50 ms
each, the median), the bytes bound at 3.35 TB/s and its share, and
whether the output is within the kernel's limit of its plain version
(fp32: atol 2e-5 / rtol 1e-4; bf16: ``lowp_limits.out_bound``). On a
split-K tree the ``tree`` variant also runs every split count from 1 to
8 on the contiguous, perm16 and short layouts. ``--layouts`` runs only
the layouts named.

A variant of a split-K tree is a "+"-joined list of edits:

- ``tree``: the kernels as they are;
- ``c_threadsN``, ``c_rowsN``, ``c_stagesN`` (``p_...``): the contiguous
  (paged) kernel's ring with N threads a block, N key rows a thread
  group a tile, N stages;
- ``contig_bulk``: the contiguous kernel's tiles by ``cp.async.bulk``
  from warp 0 (the tree: 16-byte ``cp.async`` from every thread);
  ``paged_copies``: the paged kernel's pool blocks by 16-byte
  ``cp.async`` from every thread, the table read per piece (the tree:
  one ``cp.async.bulk`` a pool block, from the lanes of warp 0);
- ``expf``: the loop's exponentials by ``expf`` (the tree: ``exp2f``);
  ``l2_128``, ``l2_256``: the 16-byte copies with an L2 prefetch hint;
- ``runtime_d``: no fixed-D instantiation: D = 64 and 16 run the form
  that takes D at run time;
- ``blk_const``: the paged kernel's block size a compile-time 16 (only
  the 16-position layouts run).

The default list is ``SPLIT_VARIANTS``. Variants of a tree before
split-K (``--tree``): ``tree``, and ``blk_const``, its paged kernel's
block size a compile-time 16.

With ``--build-seconds`` it only compiles each decode source of this tree
(and of ``--tree``'s, if given) with ``_build``'s flags, one ``nvcc`` at a
time, and prints the seconds each took.

Usage, from the repo root on a machine with a card and ``nvcc``::

    python3 -m paddle_tpu_torch.tools.decode_variants [--tree DIR] [--layouts L,...] [variant ...]
    python3 -m paddle_tpu_torch.tools.decode_variants --build-seconds [--tree DIR]
"""

import argparse
import ctypes
import importlib.util
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from paddle_tpu_torch.kernels import _build, flash_attention as fa
from paddle_tpu_torch.tools import lowp_limits as lowp

DEC, PAGED, HDR = "flash_decode.cu", "flash_decode_paged.cu", "flash_decode.cuh"
KERNELS = {DEC: "flash_decode", PAGED: "flash_decode_paged"}

# edit name -> [(file, text or compiled pattern, replacement)]; a variant
# is a "+"-joined list of edits ("tree": none)
_D64 = "  if (a.d == 64) return launch<T, 64, 1, true>(a, stream);\n"
_D16 = "  if (a.d == 16) return launch<T, 16, 1, true>(a, stream);\n"


def _set(files, name, value):
    """Edits setting a ring constant (``constexpr int|bool name``)."""
    kind = "bool" if isinstance(value, bool) else "int"
    text = str(value).lower() if isinstance(value, bool) else str(value)
    return [(fn, re.compile(r"constexpr %s %s = [^;]+;" % (kind, name)),
             "constexpr %s %s = %s;" % (kind, name, text)) for fn in files]


SPLIT_EDITS = {
    "expf": [(HDR, "  return exp2f(x * 1.4426950408889634f);\n",
              "  return expf(x);\n")],
    "contig_bulk": _set((DEC,), "kBulk", True),
    "paged_copies": _set((PAGED,), "kBulk", False),
    "runtime_d": [(fn, line, "") for fn in (DEC, PAGED)
                  for line in (_D64, _D16)],
    "blk_const": [(HDR, "    const int blk = a.blk;   // pool block size",
                   "    constexpr int blk = 16;")],
    # the 16-byte copies with an L2 prefetch-size hint
    "l2_128": [(HDR, "cp.async.cg.shared.global [%0]",
                "cp.async.cg.shared.global.L2::128B [%0]")],
    "l2_256": [(HDR, "cp.async.cg.shared.global [%0]",
                "cp.async.cg.shared.global.L2::256B [%0]")],
}
# c_ / p_: the contiguous / paged kernel's ring only
for _scope, _files in (("c_", (DEC,)), ("p_", (PAGED,))):
    for _v in (128, 256, 384, 512):
        SPLIT_EDITS["%sthreads%d" % (_scope, _v)] = _set(_files, "kThreads", _v)
    for _v in (1, 2, 4, 8):
        SPLIT_EDITS["%srows%d" % (_scope, _v)] = _set(_files, "kRowsPerGroup",
                                                     _v)
    for _v in (2, 3, 4):
        SPLIT_EDITS["%sstages%d" % (_scope, _v)] = _set(_files, "kStages", _v)
SPLIT_VARIANTS = [
    "tree", "expf", "l2_256", "c_rows2", "c_threads384",
    "c_threads512+c_rows1", "c_stages2", "c_stages4", "contig_bulk",
    "p_threads256", "p_threads256+paged_copies", "paged_copies",
    "p_stages2", "p_stages4", "runtime_d", "blk_const"]
PRESPLIT_EDITS = {
    "blk_const": [
        (PAGED, "int max_blocks, int blk,\n                          int "
                "pool_blocks, float scale, int d_rt,",
         "int max_blocks, int blk_arg,\n                          int "
         "pool_blocks, float scale, int d_rt,"),
        (PAGED, "  const int s_len = max_blocks * blk;",
         "  constexpr int blk = 16;\n  const int s_len = max_blocks * blk;")],
}
PRESPLIT_VARIANTS = ["tree", "blk_const"]
# the layouts every variant runs (with every split count on a split-K
# tree); the others run on the variants named here only
SWEEP_LAYOUTS = ("contiguous", "perm16")
ALL_LAYOUT_VARIANTS = ("tree", "paged_copies", "blk_const")
LAYOUTS = ("contiguous", "perm16", "ident16", "contig16", "perm32", "perm64",
           "contiguous_d16", "perm16_d16", "short")
# the D = 16 layouts (``GPTConfig.tiny``'s head dim): fixed D against the
# run-time-D form
D16_VARIANTS = ("tree", "runtime_d")
B, N, S, D = 8, 12, 1024, 64
COPIES = 4


def load_tree_build(tree):
    """The ``_build`` module of the tree at ``tree`` (this one if None)."""
    if tree is None:
        return _build
    path = os.path.join(tree, "paddle_tpu_torch", "kernels", "_build.py")
    spec = importlib.util.spec_from_file_location("tree_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def variant_edits(name, edits):
    """The (file, text, replacement) list of a "+"-joined variant name."""
    if name == "tree":
        return []
    out = []
    for part in name.split("+"):
        if part not in edits:
            raise ValueError("unknown edit %r (known: %s)"
                             % (part, ", ".join(edits)))
        out += edits[part]
    return out


def build_variants(names, edit_table, tb, root):
    """{(variant, kernel): {dtype: ctypes function}} for the kernels each
    variant's edits touch (both for ``tree`` and for header edits)."""
    nvcc = _build.nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    procs = {}
    for name in names:
        edits = variant_edits(name, edit_table)
        src = os.path.join(root, name)
        shutil.copytree(tb.SRC_DIR, src)
        for fn, text, new in edits:
            path = os.path.join(src, fn)
            with open(path) as f:
                code = f.read()
            if isinstance(text, str):
                found, code = text in code, code.replace(text, new)
            else:
                code, found = text.subn(new, code)
            if not found:
                raise ValueError("variant %s: text not found in %s: %r"
                                 % (name, fn, str(text)[:60]))
            with open(path, "w") as f:
                f.write(code)
        files = {fn for fn, _t, _n in edits}
        for fn, kernel in KERNELS.items():
            if edits and HDR not in files and fn not in files:
                continue
            lib = os.path.join(src, "lib%s.so" % kernel)
            cmd = [nvcc] + tb.NVCC_FLAGS + ["-o", lib, os.path.join(src, fn)]
            procs[(name, kernel)] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), lib)
    fns = {}
    for key, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError("%s failed to build:\n%s" % (key, log[-4000:]))
        prefix, _types, argtypes = tb.KERNELS[key[1]]
        cdll = ctypes.CDLL(lib)
        fns[key] = {}
        for dt in ("f32", "bf16"):
            fn = getattr(cdll, "%s_%s" % (prefix, dt))
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            fns[key][dt] = fn
    return fns


def build_seconds(trees):
    """Seconds of one ``nvcc`` of each decode source of each tree
    ({label: build module}), one at a time."""
    nvcc = _build.nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    root = tempfile.mkdtemp(prefix="decode_build_")
    try:
        for label, tb in trees.items():
            for fn, kernel in KERNELS.items():
                lib = os.path.join(root, "%s_%s.so" % (label, kernel))
                t0 = time.perf_counter()
                subprocess.run([nvcc] + tb.NVCC_FLAGS + [
                    "-o", lib, os.path.join(tb.SRC_DIR, fn)], check=True,
                    stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
                print("build %s %s: %.1f s" % (label, kernel,
                                               time.perf_counter() - t0),
                      flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def graph_ms(run, calls=20, window_ms=50.0, windows=5):
    """Median device ms per call of ``run(i)`` (i cycles the copies),
    ``calls`` calls captured in one CUDA graph and replayed."""
    for i in range(3):
        run(i)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            run(i)

    def window(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / (reps * calls)

    reps = max(1, int(np.ceil(window_ms / (window(1) * calls))))
    window(reps)
    times = sorted(window(reps) for _ in range(windows))
    return times[len(times) // 2]


def make_inputs(layout, dt, dev, gen):
    """(kernel, q, key bias, per-copy (K, V), tables or None) of one
    layout; every layout at one D holds the same K/V bytes."""
    layout, _, dpart = layout.partition("_d")
    d = int(dpart) if dpart else D
    slots = 1 if layout == "short" else B
    q = torch.randn(slots, N, 1, d, generator=gen, device=dev).to(dt)
    kb = torch.zeros(slots, S)
    for b, live in zip(range(slots), (1, 17, 512, 1024, 100, 333, 1000, 1024)):
        kb[b, live:] = -1e4
    kb = kb.to(dev)
    if layout in ("contiguous", "short"):
        kvs = [tuple(torch.randn(slots, N, S, d, generator=gen, device=dev)
                     .to(dt) for _ in range(2)) for _ in range(COPIES)]
        return "flash_decode", q, kb, kvs, None
    blk = int(layout[-2:])
    mb = S // blk
    if layout == "contig16":
        qq = q.reshape(B * N, 1, 1, d)
        pools = [tuple(torch.randn(1 + B * N * mb, 1, blk, d, generator=gen,
                                   device=dev).to(dt) for _ in range(2))
                 for _ in range(COPIES)]
        tables = (torch.arange(B * N * mb) + 1).reshape(B * N, mb)
        kbb = kb.repeat_interleave(N, 0)
        return "flash_decode_paged", qq, kbb, pools, tables.to(
            torch.int32).to(dev)
    pools = [tuple(torch.randn(1 + B * mb, N, blk, d, generator=gen,
                               device=dev).to(dt) for _ in range(2))
             for _ in range(COPIES)]
    if layout.startswith("ident"):
        tables = (torch.arange(B * mb) + 1).reshape(B, mb)
    else:
        tables = (torch.randperm(B * mb, generator=gen, device=dev)
                  + 1).reshape(B, mb)
    return "flash_decode_paged", q, kb, pools, tables.to(torch.int32).to(dev)


def caller(fn, kernel, q, kb, kvs, tables, split_abi, splits):
    """run(i): one launch of ``fn`` on copy i % len(kvs) into out[i]."""
    outs = [torch.empty_like(q) for _ in kvs]
    bh, heads, d = q.shape[0] * q.shape[1], q.shape[1], q.shape[3]
    scale = 1.0 / math.sqrt(d)
    tail = (splits,) if split_abi else ()

    def run(i):
        k, v = kvs[i % len(kvs)]
        o = outs[i % len(kvs)]
        stream = torch.cuda.current_stream().cuda_stream
        if kernel == "flash_decode":
            args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), kb.data_ptr(),
                    o.data_ptr(), bh, heads, k.shape[2], d, scale)
        else:
            args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    tables.data_ptr(), kb.data_ptr(), o.data_ptr(), bh, heads,
                    heads, tables.shape[1], k.shape[2], k.shape[0], d, scale)
        err = fn(*args, *tail, stream)
        if err:
            raise RuntimeError("%s: CUDA error %d" % (kernel, err))
    return run, outs


def limit_ok(kernel, dt, q, kb, kvs, tables, outs):
    """Whether each copy's output is within the kernel's limit of its
    plain version."""
    ok = True
    for (k, v), got in zip(kvs, outs):
        if kernel == "flash_decode":
            rk, rv = k, v
        else:
            rk, rv = (fa.gather_paged_rows(x, tables.long()) for x in (k, v))
        want = fa.flash_decode_attention_plain(q, rk, rv, key_bias=kb)
        if dt == torch.float32:
            ok = ok and torch.allclose(got, want, atol=2e-5, rtol=1e-4)
        else:
            bound = lowp.out_bound(dt, q, rk, rv, want, key_bias=kb)
            ok = ok and float(lowp.out_ratios(dt, got, want, bound)["elem"]) <= 1
    return ok


def bound_ms(dt, q, kvs, tables):
    """Bytes over 3.35 TB/s: K and V once, q and o, the bias rows, the
    tables."""
    size = torch.finfo(dt).bits // 8
    kv = 2 * kvs[0][0].numel() * size
    extra = 2 * q.numel() * size + 4 * (q.shape[0] if tables is None
                                         else B) * S
    if tables is not None:
        extra += 4 * tables.numel()
    return (kv + extra) / 3.35e12 * 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", metavar="variant",
                    help="default: all of the tree's kind")
    ap.add_argument("--tree", help="directory holding an older tree's "
                                   "paddle_tpu_torch/ (default: this tree)")
    ap.add_argument("--build-seconds", action="store_true",
                    help="only time each decode source's nvcc")
    ap.add_argument("--layouts", default=",".join(LAYOUTS),
                    help="comma-separated layouts to run (default: all)")
    args = ap.parse_args(argv)
    if args.build_seconds:
        trees = {"this": _build}
        if args.tree:
            trees["older"] = load_tree_build(args.tree)
        build_seconds(trees)
        return 0
    if not torch.cuda.is_available():
        print("decode_variants: no CUDA device", file=sys.stderr)
        return 1
    tb = load_tree_build(args.tree)
    split_abi = os.path.exists(os.path.join(tb.SRC_DIR, HDR))
    edits = SPLIT_EDITS if split_abi else PRESPLIT_EDITS
    layouts = args.layouts.split(",")
    for n in layouts:
        if n not in LAYOUTS:
            ap.error("unknown layout %r" % n)
    for n in args.variants:
        try:
            variant_edits(n, edits)
        except ValueError as e:
            ap.error(str(e))
    names = ["tree"] + [n for n in args.variants or (
        SPLIT_VARIANTS if split_abi else PRESPLIT_VARIANTS) if n != "tree"]
    root = tempfile.mkdtemp(prefix="decode_variants_")
    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(0), "split-K tree" if split_abi
          else "tree before split-K", flush=True)
    try:
        fns = build_variants(names, edits, tb, root)
        for dt, et in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            for layout in layouts:
                gen = torch.Generator(device=dev).manual_seed(7)
                kernel, q, kb, kvs, tables = make_inputs(layout, dt, dev, gen)
                bms = bound_ms(dt, q, kvs, tables)
                for name in names:
                    if (name, kernel) not in fns:
                        continue
                    if "blk_const" in name and not layout.endswith("16"):
                        continue
                    if layout.endswith("_d16"):
                        if name not in D16_VARIANTS:
                            continue
                    elif layout == "short":
                        if name != "tree":
                            continue
                    elif layout not in SWEEP_LAYOUTS and (
                            name not in ALL_LAYOUT_VARIANTS):
                        continue
                    bh = q.shape[0] * q.shape[1]
                    blk = None if tables is None else kvs[0][0].shape[2]
                    dflt = fa._decode_splits(bh, S, blk, fa._sm_count(0))
                    sweep = [dflt]
                    if split_abi and (layout in SWEEP_LAYOUTS
                                      or layout == "short"):
                        sweep += [s for s in range(1, 9) if s != dflt]
                    for splits in sweep:
                        run, outs = caller(fns[(name, kernel)][et], kernel, q,
                                           kb, kvs, tables, split_abi, splits)
                        ms = graph_ms(run)
                        for i in range(COPIES):
                            run(i)
                        torch.cuda.synchronize()
                        ok = limit_ok(kernel, dt, q, kb, kvs, tables, outs)
                        print("variant %-26s %-4s %-10s splits %s: %.5f ms  "
                              "bound %.5f (%.0f%%)  limit %s"
                              % (name, et, layout,
                                 splits if split_abi else "-", ms, bms,
                                 100 * bms / ms, "ok" if ok else "MISSED"),
                              flush=True)
                del q, kb, kvs, tables
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
