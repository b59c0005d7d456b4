"""Where a fleet's closed-loop throughput goes on the CPU: the fleet
probe's pressure phase (``tools/fleet_probe.py``: its model, its
replicas' flags, 10 clients at a 5 ms pause on one tenant) against a
fixed pool of 2 and then 3 port replicas, with the CPU time that each
process spent per answered request.

    python -m paddle_tpu_torch.tools.fleet_cpu_cost --device cpu
    python -m paddle_tpu_torch.tools.fleet_cpu_cost --cpus 2 --spinners 6

``--cpus K`` pins this process, and so every replica it starts, to K
cores; ``--spinners S`` starts S busy processes on the same cores (other
work of a loaded host, such as the other workers of a test run). It
prints one JSON line per pool size: answered requests a second, 429
sheds, and CPU milliseconds a request spent by this process (the clients
and the router) and by the replicas, beside each process's share of one
core. A pool bound by its replicas' 60 rps tenant limit answers about 60
rps a replica; a pool bound by the CPU answers less, and a third replica
then adds little.
"""

import argparse
import json
import multiprocessing
import os
import tempfile
import threading
import time


def _cpu_s(pid):
    """user + system CPU seconds of ``pid`` (``/proc/<pid>/stat``)."""
    with open("/proc/%d/stat" % pid) as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def _spin():
    while True:
        pass


def measure(replicas, seconds, clients, device, tmp):
    from paddle_tpu_torch.checkpoint import modeldir
    from paddle_tpu_torch.fluid import flags as _flags
    from paddle_tpu_torch.serving.fleet import FleetController
    from paddle_tpu_torch.serving.gateway import encode_tensor
    from paddle_tpu_torch.tools import fleet_probe

    export = os.path.join(tmp, "export_%d" % replicas)
    xd = fleet_probe.build_model(export, 1, device)
    _v, _d = modeldir.publish(export, os.path.join(tmp, "repo_%d" %
                                                   replicas))
    _flags.set_flags({"FLAGS_router_health_interval_s": 0.25})
    ctrl = FleetController(
        model_dir=os.path.join(tmp, "repo_%d" % replicas),
        workdir=os.path.join(tmp, "fleet_%d" % replicas), replicas=replicas,
        replica_env={
            "FLAGS_serving_strict_compiles": "1",
            "FLAGS_serving_max_batch_size": "4",
            "FLAGS_serving_workers": "1",
            "FLAGS_serving_queue_depth": "64",
            "FLAGS_gateway_rate_limit_rps": "60",
            "FLAGS_gateway_rate_burst": "12",
        },
        autoscale=False, seed=0, device=device)
    t0 = time.monotonic()
    ctrl.start()
    try:
        ctrl.wait_ready(timeout=300)
        ready_s = time.monotonic() - t0
        url = ctrl.router.url("/v1/infer")
        body = {"inputs": [encode_tensor(xd)], "deadline_ms": 10000}
        stop = threading.Event()
        codes = []

        def client():
            while not stop.is_set():
                try:
                    st, _b, _h = fleet_probe._post(
                        url, body, headers={"X-Tenant-Id": "press"},
                        timeout=30)
                except Exception:  # noqa: BLE001 - counted as an error
                    st = -1
                codes.append(st)
                time.sleep(0.005)

        threads = [threading.Thread(target=client) for _ in range(clients)]
        for t in threads:
            t.start()
        time.sleep(1.0)   # past the warm-up of the loop
        pids = [r["pid"] for r in ctrl.replica_info()]
        n0 = len(codes)
        ok0 = codes.count(200)
        me0 = _cpu_s(os.getpid())
        rep0 = [_cpu_s(p) for p in pids]
        w0 = time.monotonic()
        time.sleep(seconds)
        wall = time.monotonic() - w0
        me = _cpu_s(os.getpid()) - me0
        rep = [_cpu_s(p) - c for p, c in zip(pids, rep0)]
        window = codes[n0:]
        ok = codes.count(200) - ok0
        stop.set()
        for t in threads:
            t.join()
    finally:
        ctrl.stop()
    return {"replicas": replicas, "ready_s": round(ready_s, 2),
            "rps": ok / wall, "sheds_429": window.count(429),
            "errors": sum(1 for c in window if c not in (200, 429)),
            "cpu_ms_per_request": {
                "clients_and_router": 1e3 * me / max(ok, 1),
                "replicas": 1e3 * sum(rep) / max(ok, 1)},
            "core_share": {"clients_and_router": me / wall,
                           "replicas": [c / wall for c in rep]}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--pools", default="2,3")
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--clients", type=int, default=10)
    ap.add_argument("--cpus", type=int, default=0,
                    help="pin to this many cores (0: as started)")
    ap.add_argument("--spinners", type=int, default=0)
    args = ap.parse_args(argv)
    if args.cpus:
        cores = sorted(os.sched_getaffinity(0))[:args.cpus]
        os.sched_setaffinity(0, cores)
    spinners = [multiprocessing.Process(target=_spin, daemon=True)
                for _ in range(args.spinners)]
    for p in spinners:
        p.start()
    try:
        with tempfile.TemporaryDirectory(prefix="fleet_cpu_cost_") as tmp:
            for n in [int(x) for x in args.pools.split(",")]:
                row = measure(n, args.seconds, args.clients, args.device,
                              tmp)
                row.update(cpus=len(os.sched_getaffinity(0)),
                           spinners=args.spinners)
                print(json.dumps(row), flush=True)
    finally:
        for p in spinners:
            p.terminate()
            p.join()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
