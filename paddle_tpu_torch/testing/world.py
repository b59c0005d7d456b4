"""Run one function in every rank of a ``torch.distributed`` world, each
rank a process of its own (the port's data-parallel tests on the CPU).

    results = run_world("tests/test_x.py:rank_main", 2, workdir,
                        kwargs={"steps": 4})

starts ``python -m paddle_tpu_torch.testing.world`` once per rank; each
joins a gloo world through a ``FileStore`` under ``workdir`` (no port to
collide with another world running at the same time), calls
``rank_main(rank, world_size, **kwargs)`` and pickles what it returns.
The rendezvous and every collective have a timeout, and the whole world
has one more: a rank that dies or hangs fails the call, with every
rank's stderr in the message, and no process outlives it.

Run as a launcher's training script (``python -m
paddle_tpu_torch.distributed.launch --nproc_per_node 2 --device cpu
paddle_tpu_torch/testing/world.py --target T --out DIR``), a rank takes
its rank and world from the launcher's env and joins through
``env://``; ``--device cuda --backend gloo`` runs the ranks' tensors on
the card over gloo.
"""

import argparse
import importlib
import importlib.util
import json
import os
import pickle
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def load_target(target):
    """``path/to/file.py:fn`` or ``package.module:fn`` -> the function."""
    where, name = target.rsplit(":", 1)
    if where.endswith(".py"):
        path = where if os.path.isabs(where) else os.path.join(REPO, where)
        # the file's siblings import as they do under pytest
        sys.path.insert(0, os.path.dirname(path))
        spec = importlib.util.spec_from_file_location(
            "_world_target_%d" % abs(hash(path)), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(where)
    return getattr(mod, name)


def run_world(target, nranks, workdir, kwargs=None, timeout_s=240.0,
              collective_timeout_s=120.0, env=None):
    """``target(rank, nranks, **kwargs)`` in ``nranks`` gloo ranks on the
    CPU -> the list of what each rank returned, in rank order."""
    os.makedirs(workdir, exist_ok=True)
    store = os.path.join(workdir, "store")
    if os.path.exists(store):
        os.remove(store)
    penv = dict(os.environ)
    penv["PYTHONPATH"] = REPO + os.pathsep + penv.get("PYTHONPATH", "")
    penv.update(env or {})
    procs, logs = [], []
    for r in range(nranks):
        log = open(os.path.join(workdir, "rank%d.log" % r), "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.testing.world",
             "--target", target, "--rank", str(r), "--world", str(nranks),
             "--store", store, "--out", workdir,
             "--timeout", str(collective_timeout_s),
             "--kwargs", json.dumps(kwargs or {})],
            cwd=REPO, env=penv, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [r for r, p in enumerate(procs) if p.poll() is None]
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for log in logs:
        log.seek(0)
        texts.append(log.read())
        log.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if hung or bad:
        raise RuntimeError(
            "world of %d: ranks %s hung past %.0f s, ranks %s failed\n%s"
            % (nranks, hung, timeout_s, bad, "\n".join(
                "--- rank %d ---\n%s" % (r, t[-4000:])
                for r, t in enumerate(texts))))
    return [read_result(workdir, r) for r in range(nranks)]


def read_result(out_dir, rank):
    with open(os.path.join(out_dir, "rank%d.pkl" % rank), "rb") as f:
        return pickle.load(f)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--target", required=True)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--store", default=None,
                    help="FileStore path (default: the launcher's env://)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--timeout", type=float, default=120.0)
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--kwargs", default="{}")
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(1)
    from paddle_tpu_torch import parallel

    rank = args.rank if args.rank is not None else int(
        os.environ.get("RANK", "0"))
    world = args.world if args.world is not None else int(
        os.environ.get("WORLD_SIZE", "1"))
    init = "file://" + args.store if args.store else None
    parallel.initialize_distributed(
        backend=args.backend, init_method=init, world_size=world, rank=rank,
        timeout_s=args.timeout)
    try:
        result = load_target(args.target)(rank, world,
                                          **json.loads(args.kwargs))
        os.makedirs(args.out, exist_ok=True)
        tmp = os.path.join(args.out, "rank%d.pkl.tmp" % rank)
        with open(tmp, "wb") as f:
            pickle.dump(result, f)
        os.replace(tmp, os.path.join(args.out, "rank%d.pkl" % rank))
    finally:
        parallel.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
