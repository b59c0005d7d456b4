"""Multi-process launcher (port of ``paddle_tpu/distributed/launch.py``;
reference: python/paddle/distributed/launch.py — start_procs:147 spawns
one process per device and wires PADDLE_TRAINER_ID /
PADDLE_CURRENT_ENDPOINT / PADDLE_TRAINER_ENDPOINTS).

    python -m paddle_tpu_torch.distributed.launch [--nproc_per_node N]
        [--selected_gpus 0,1] [--max_restarts K] [--device cpu]
        train.py [args ...]

One process per card, as Paddle's CUDA launcher: ``--selected_gpus``
names the cards (one worker each, its ``CUDA_VISIBLE_DEVICES``), else
``--nproc_per_node`` workers share the visible ones. Besides the
reference's env contract each worker gets torch's: ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK`` (the
reference sets ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
``JAX_PROCESS_ID`` instead), so ``torch.distributed.init_process_group``
can rendezvous; the collectives themselves are not ported yet.

Workers run on the card: the launcher raises without one unless
``--device cpu`` asks for the CPU, which it passes on in
``PADDLE_LAUNCH_DEVICE``; a worker reads it through ``worker_device()``.

The launcher is a supervising agent (``supervisor.py``): worker crashes
and heartbeat stalls tear down the whole gang and, with
``--max_restarts > 0``, restart it with exponential backoff, the workers
resuming from their newest committed checkpoint. SIGTERM is forwarded
to the workers (their handlers commit one final save), survivors are
SIGKILLed after a grace window, and the launcher exits 143."""

import argparse
import os
import sys

from . import supervisor as _supervisor

DEVICE_ENV = "PADDLE_LAUNCH_DEVICE"


def worker_device():
    """The ``torch.device`` a launched worker trains on: the card unless
    the launcher was given ``--device cpu``. Raises without a card."""
    from ..fluid import core

    return core.resolve_device(os.environ.get(DEVICE_ENV) or None)


def _parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="paddle_tpu_torch distributed launcher")
    parser.add_argument(
        "--cluster_node_ips", type=str, default="127.0.0.1",
        help="comma-separated host ips",
    )
    parser.add_argument("--node_ip", type=str, default="127.0.0.1")
    parser.add_argument("--started_port", type=int, default=6170)
    parser.add_argument("--print_config", type=bool, default=True)
    parser.add_argument(
        "--nproc_per_node", type=int, default=1,
        help="processes per node when --selected_gpus is not given",
    )
    parser.add_argument(
        "--selected_gpus", type=str, default=None,
        help="comma-separated card ids: one worker per card, each with "
        "that card alone in its CUDA_VISIBLE_DEVICES",
    )
    parser.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the workers train (default: the card; the launcher "
        "raises without one)",
    )
    parser.add_argument("--log_level", type=int, default=20)
    parser.add_argument("--log_dir", type=str, default=None)
    parser.add_argument(
        "--sigterm_grace_s", type=float, default=30.0,
        help="on SIGTERM: forward it to workers (their preemption "
        "handlers run one final checkpoint save), then SIGKILL "
        "survivors after this many seconds",
    )
    parser.add_argument(
        "--max_restarts", type=int, default=0,
        help="elastic restart budget: after a worker crash or heartbeat "
        "stall the supervisor tears the gang down and relaunches it up "
        "to this many times (workers resume from their newest committed "
        "checkpoint); 0 fails fast",
    )
    parser.add_argument(
        "--max_preempt_restarts", type=int, default=None,
        help="separate restart budget for preempted workers (exit 143 / "
        "SIGTERM death / unspawnable slot) "
        "(default FLAGS_dist_max_preempt_restarts)",
    )
    parser.add_argument(
        "--min_world_size", type=int, default=None,
        help="elastic resize floor: a restart may shrink the gang to "
        "the launchable survivors, never below this "
        "(default FLAGS_elastic_min_world_size)",
    )
    parser.add_argument(
        "--heartbeat_timeout_s", type=float, default=None,
        help="hang watchdog: a running worker whose heartbeat file "
        "(written each step by the trainer) goes stale beyond this is "
        "killed with the gang (default FLAGS_dist_heartbeat_timeout_s)",
    )
    parser.add_argument(
        "--startup_grace_s", type=float, default=None,
        help="staleness bound before a worker's first heartbeat",
    )
    parser.add_argument(
        "--supervisor_dir", type=str, default=None,
        help="where supervisor.log + heartbeat files live "
        "(default: --log_dir, else a temp dir)",
    )
    parser.add_argument(
        "training_script", type=str,
        help="the training script followed by its arguments",
    )
    parser.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def build_specs(args):
    """Per-rank WorkerSpecs carrying the reference env contract
    (reference: launch.py:147 start_procs) and torch's rendezvous vars."""
    node_ips = [ip.strip() for ip in args.cluster_node_ips.split(",")]
    node_id = node_ips.index(args.node_ip)
    num_nodes = len(node_ips)
    gpus = None
    if args.selected_gpus:
        gpus = [g.strip() for g in args.selected_gpus.split(",")
                if g.strip()]
    nproc = len(gpus) if gpus else args.nproc_per_node
    all_endpoints = [
        "%s:%d" % (ip, args.started_port + i)
        for ip in node_ips
        for i in range(nproc)
    ]
    nranks = num_nodes * nproc
    master_port = args.started_port + 1000

    specs = []
    for i in range(nproc):
        rank = node_id * nproc + i
        current_endpoint = "%s:%d" % (args.node_ip, args.started_port + i)
        proc_env = {
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_CURRENT_ENDPOINT": current_endpoint,
            "PADDLE_TRAINERS_NUM": str(nranks),
            "PADDLE_TRAINER_ENDPOINTS": ",".join(all_endpoints),
            # torch.distributed's env:// rendezvous
            "MASTER_ADDR": node_ips[0],
            "MASTER_PORT": str(master_port),
            "WORLD_SIZE": str(nranks),
            "RANK": str(rank),
            "LOCAL_RANK": str(i),
            DEVICE_ENV: args.device,
        }
        if gpus and args.device == "cuda":
            proc_env["CUDA_VISIBLE_DEVICES"] = gpus[i]
        cmd = [sys.executable, "-u", args.training_script] + list(
            args.training_script_args
        )
        log_path = (
            os.path.join(args.log_dir, "workerlog.%d" % i)
            if args.log_dir else None
        )
        specs.append(_supervisor.WorkerSpec(
            cmd, env=proc_env, log_path=log_path, rank=rank,
        ))
    return specs


def _check_device(args):
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError(
                "launch: no CUDA device is available for the workers; "
                "pass --device cpu to train on the CPU")


def start_procs(args):
    """reference: launch.py:147 start_procs — supervised: crashes and
    hangs tear down the whole gang; with --max_restarts the gang is
    relaunched (exponential backoff) and workers resume from their
    newest committed checkpoint; SIGTERM preemption exits 143."""
    import tempfile

    _check_device(args)
    workdir = args.supervisor_dir or args.log_dir
    if workdir is None:
        workdir = tempfile.mkdtemp(prefix="paddle_tpu_torch_supervisor_")
    sup = _supervisor.Supervisor(
        build_specs(args),
        workdir=workdir,
        max_restarts=args.max_restarts,
        max_preempt_restarts=args.max_preempt_restarts,
        min_world_size=args.min_world_size,
        heartbeat_timeout_s=args.heartbeat_timeout_s,
        startup_grace_s=args.startup_grace_s,
        sigterm_grace_s=args.sigterm_grace_s,
    )
    rc = sup.run()
    if rc != 0:
        if sup.failure_report is not None:
            what = (
                "restart budget exhausted" if args.max_restarts > 0
                else "worker failed"
            )
            print(
                "launch: %s: %s" % (what, sup.failure_report),
                file=sys.stderr,
            )
        sys.exit(rc)


def launch(argv=None):
    args = _parse_args(argv)
    if args.print_config:
        print(
            "launch %d procs on node %s (of %s), device %s"
            % (len(build_specs(args)), args.node_ip, args.cluster_node_ips,
               args.device)
        )
    start_procs(args)


if __name__ == "__main__":
    launch()
