"""Build and load the hand-written CUDA kernels (``paddle_tpu_torch/csrc``).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``. The
build happens at first use, into ``paddle_tpu_torch/_build/`` (listed in
``.gitignore``), from the sources in the checkout alone. The library's
file name carries a hash of its source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source is rebuilt and a
stale library is never loaded. ``build()`` starts one ``nvcc`` per
source, all at once, counts each library it compiles in ``builds`` and
reports it to ``observability.compile_stats`` (kind ``kernel_library``),
whose strict gate refuses a build on a serving-request thread after
warmup. ``load`` builds under a lock: two threads never start ``nvcc``
on one source together.

Nothing here runs at import time: the CPU tests import every module of
the package on a machine that has no ``nvcc``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

__all__ = ["KERNELS", "build", "load", "nvcc_path"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# kernel name -> (C entry point prefix, element types it is built for,
# argument types). The entry point of element type ``t`` is
# ``<prefix>_<t>``: ``f32``, ``bf16`` or ``f16``, one argument list for
# all. Pointers and the stream are c_void_p (ctypes would otherwise pass
# them as 32-bit ints), unsigned ints c_uint32.
_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
# the flash training kernels' trailing arguments: bh, bias_heads,
# bias_div, bias_rows, sq, sk, d, scale, causal, dropout, seed, thresh,
# keep_prob / inv_keep, stream
_FLASH_TAIL = [_I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _U, _U, _F, _P]
_ALL = ("f32", "bf16", "f16")
KERNELS = {
    "flash_fwd": ("paddle_flash_fwd", _ALL, [_P] * 7 + _FLASH_TAIL),
    "flash_bwd_dq": ("paddle_flash_bwd_dq", _ALL, [_P] * 9 + _FLASH_TAIL),
    "flash_bwd_dkv": ("paddle_flash_bwd_dkv", _ALL,
                      [_P] * 12 + _FLASH_TAIL),
    # q, k, v, key_bias, o, bh, bias_heads, s_len, d, scale, splits,
    # stream
    "flash_decode": ("paddle_flash_decode", _ALL,
                     [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P]),
    # q, k_pool, v_pool, tables, key_bias, o, bh, heads, bias_heads,
    # max_blocks, blk, pool_blocks, d, scale, splits, stream
    "flash_decode_paged": ("paddle_flash_decode_paged", _ALL,
                           [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _I, _F, _I, _P]),
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_lock = threading.Lock()
_libs = {}
_logs = {}
# libraries compiled by this process
builds = 0


def nvcc_path():
    """The ``nvcc`` to build with: ``$CUDA_HOME/bin/nvcc``, then the one
    on ``PATH``, then ``/usr/local/cuda/bin/nvcc``; None if none exists."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    return None


def _lib_path(name):
    """(source, library path); the hash covers the source, every shared
    header of ``csrc/`` and the flags."""
    src = os.path.join(SRC_DIR, name + ".cu")
    h = hashlib.sha256()
    headers = sorted(fn for fn in os.listdir(SRC_DIR) if fn.endswith(".cuh"))
    for path in [src] + [os.path.join(SRC_DIR, fn) for fn in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR, "lib%s-%s.so" % (name, h.hexdigest()[:16]))


def build(names=None):
    """Compile the named kernels (default: all) that are not built yet,
    one ``nvcc`` per source, all started together. Returns
    ``{name: {"seconds": s, "cached": bool, "log": ptxas report}}``;
    raises ``RuntimeError`` with the compiler's output if one fails."""
    global builds
    names = list(KERNELS) if names is None else list(names)
    nvcc = None
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    out = {}
    for name in names:
        src, lib = _lib_path(name)
        if os.path.exists(lib):
            out[name] = {"seconds": 0.0, "cached": True,
                         "log": _logs.get(name, "")}
            continue
        if nvcc is None:
            nvcc = nvcc_path()
            if nvcc is None:
                raise RuntimeError(
                    "nvcc not found (set CUDA_HOME or put nvcc on PATH)")
        tmp = "%s.tmp%d" % (lib, os.getpid())
        cmd = [nvcc] + NVCC_FLAGS + ["-o", tmp, src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib, time.perf_counter())
    # each nvcc's output read (and its end timed) by a thread of its own,
    # so that one kernel's seconds do not include waiting for another's
    done = {}

    def finish(name, proc, t0):
        log, _ = proc.communicate()
        done[name] = (log, time.perf_counter() - t0)

    readers = [threading.Thread(target=finish, args=(name, proc, t0))
               for name, (proc, _tmp, _lib, t0) in procs.items()]
    for t in readers:
        t.start()
    for t in readers:
        t.join()
    failures = []
    for name, (proc, tmp, lib, _t0) in procs.items():
        log, secs = done[name]
        if proc.returncode != 0:
            failures.append("%s (nvcc exit %d):\n%s"
                            % (name, proc.returncode, log))
            continue
        os.replace(tmp, lib)  # atomic: a reader never sees half a library
        builds += 1
        _logs[name] = log
        out[name] = {"seconds": secs, "cached": False, "log": log}
    if failures:
        raise RuntimeError("kernel build failed: " + "\n".join(failures))
    _report_builds(out)
    return out


def _report_builds(out):
    """Each library compiled in this call to the build telemetry; under
    the armed strict gate the first refusal is raised once every build
    is recorded."""
    from ..observability import compile_stats

    refused = None
    for name, info in out.items():
        if info["cached"]:
            continue
        try:
            compile_stats.on_build(
                "kernel_library", name,
                {"library": os.path.basename(_lib_path(name)[1])},
                info["seconds"] * 1e3)
        except compile_stats.SteadyStateRecompileError as e:
            refused = refused or e
    if refused is not None:
        raise refused


def load(name, dtype="f32"):
    """The kernel's C entry point for element type ``dtype`` (``f32``,
    ``bf16`` or ``f16``) as a ctypes function with its
    ``argtypes``/``restype`` set, building the library first if needed."""
    with _lock:
        fn = _libs.get((name, dtype))
        if fn is not None:
            return fn
        prefix, dtypes, argtypes = KERNELS[name]
        if dtype not in dtypes:
            raise TypeError("%s kernel is built for %s, not %s"
                            % (name, "/".join(dtypes), dtype))
        _src, lib_path = _lib_path(name)
        if not os.path.exists(lib_path):
            build([name])
        lib = ctypes.CDLL(lib_path)
        fn = getattr(lib, "%s_%s" % (prefix, dtype))
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        err_fn = lib.paddle_cuda_error_string
        err_fn.argtypes = [ctypes.c_int]
        err_fn.restype = ctypes.c_char_p
        fn.error_string = err_fn
        fn.library = lib  # keeps the CDLL alive beside the function
        _libs[(name, dtype)] = fn
        return fn
