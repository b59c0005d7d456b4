"""The first vector-math call of a test process, taken on one thread.

PyTorch's CPU ``exp``, ``log`` and their kin go through MKL's vector
math (VML), which sets itself up on the process's first such call. When
several threads make that first call together on a loaded machine, one
of them can come back with results off by up to ~1e-4 relative, once;
every later call is right. ``python3 tests/test_torch_cpu_math.py``
counts it: fresh processes started in waves, half of them pinned, whose
first call is ``torch.exp`` on 8 threads. On an 8-core x86 CPU with
AVX-512 (torch 2.13.0+cpu) two runs of 240 each read 3 and 1 bad cold
processes and 0 and 0 pinned ones.

The parity tests of the port hold its plain versions to the JAX package
at 1e-5, and the plain forward's ``torch.logsumexp`` is often the first
vector-math call of an xdist worker: that is how
``test_torch_kernels.py::test_flash_attention_lse_plain_matches_jax_kernel[causal]``
failed in a whole run (lse off by 5e-5 on the half of the heads one
thread computed) and passed when its file ran alone. No other test file
leaves state behind for it: it fails with that test alone in a fresh
process, when several such processes run at once. The parity modules
therefore call ``pin_vector_math`` where they pin the thread count.
"""

import argparse
import os
import subprocess
import sys

import numpy as np
import torch


def pin_vector_math(threads=2):
    """Set up PyTorch's CPU vector math with one call on one thread, then
    run on ``threads`` threads. Idempotent; a few microseconds after the
    first time."""
    torch.set_num_threads(1)
    torch.exp(torch.zeros(1 << 16))
    torch.set_num_threads(threads)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the parity case that failed, computed first thing in a fresh process
# on 8 threads after the pin, against float64
_FRESH_PROCESS = r"""
import sys
import numpy as np
import torch
sys.path.insert(0, %(tests)r)
from test_torch_cpu_math import pin_vector_math
pin_vector_math(8)
from paddle_tpu_torch.kernels import flash_attention as tfa
rs = np.random.RandomState(6)
q, k, v = (rs.randn(2, 2, 32, 16).astype(np.float32) for _ in range(3))
_out, lse = tfa.flash_attention_lse_plain(
    *(torch.from_numpy(a) for a in (q, k, v)), causal=True)
s = np.einsum("bnqd,bnkd->bnqk", q.astype(np.float64), k.astype(np.float64))
s = np.where(np.tril(np.ones((32, 32), bool)), s / 4.0, -1e30)
m = s.max(-1, keepdims=True)
want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
print(float(np.abs(lse.numpy() - want).max()))
"""


def test_pin_restores_the_thread_count():
    pin_vector_math(3)
    assert torch.get_num_threads() == 3
    pin_vector_math(2)
    assert torch.get_num_threads() == 2


def test_first_call_after_the_pin_is_accurate_in_fresh_processes():
    """Six fresh processes at once (a loaded machine, as under xdist), each
    pinning and then taking the failing parity case's plain forward first
    on 8 threads: every lse within 1e-5 of float64, the parity test's
    tolerance."""
    code = _FRESH_PROCESS % {"tests": os.path.join(REPO, "tests")}
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(6)]
    errs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        errs.append(float(out.strip().splitlines()[-1]))
    assert max(errs) <= 1e-5, errs
    assert np.isfinite(errs).all()


# a fresh process whose first vector-math call is torch.exp on `threads`
# threads, after the pin or not: prints the largest relative error
_FIRST_EXP = r"""
import sys
import numpy as np
import torch
sys.path.insert(0, %(tests)r)
from test_torch_cpu_math import pin_vector_math
if %(pin)r:
    pin_vector_math(%(threads)d)
else:
    torch.set_num_threads(%(threads)d)
x = (np.random.RandomState(0).rand(1 << 16) * -12).astype(np.float32)
got = torch.exp(torch.from_numpy(x)).numpy()
print(float(np.abs(got / np.exp(x.astype(np.float64)) - 1).max()))
"""


def race(runs, wave, threads):
    """{"cold": n, "pinned": n}: of ``runs`` fresh processes each, started
    ``wave`` at a time (half of each wave pinned), how many took a first
    ``torch.exp`` more than 1e-6 off."""
    bad = {"cold": 0, "pinned": 0}
    env = dict(os.environ, PYTHONPATH=REPO)
    for _ in range(0, runs, wave // 2):
        procs = [(pin, subprocess.Popen(
            [sys.executable, "-c", _FIRST_EXP % {
                "tests": os.path.join(REPO, "tests"), "pin": pin,
                "threads": threads}],
            env=env, stdout=subprocess.PIPE, text=True))
            for _ in range(wave // 2) for pin in (False, True)]
        for pin, p in procs:
            out, _ = p.communicate(timeout=300)
            if float(out.strip().splitlines()[-1]) > 1e-6:
                bad["pinned" if pin else "cold"] += 1
    return bad


if __name__ == "__main__":
    # python3 tests/test_torch_cpu_math.py --runs 240 --wave 16 --threads 8
    ap = argparse.ArgumentParser(description="first-call vector-math race")
    ap.add_argument("--runs", type=int, default=240)
    ap.add_argument("--wave", type=int, default=16)
    ap.add_argument("--threads", type=int, default=8)
    a = ap.parse_args()
    print({"runs_each": a.runs, "wave": a.wave, "threads": a.threads,
           "torch": torch.__version__,
           "bad": race(a.runs, a.wave, a.threads)})
