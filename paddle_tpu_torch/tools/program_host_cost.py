"""Host cost of the GPT train program's ops, measured on the CPU.

Builds ``gpt.build_gpt_lm_train`` at GPT-2 small's depth (12 layers) but
a width of 64, where the arithmetic is negligible and a step's wall time
is the host's dispatch: the Executor's per-op work, the vjp closures and
the launches of each op. Prints the program step's and the eager step's
wall ms (median of ``--steps``), then each op type's host µs per call
and ms per step, largest first.

    python3 -m paddle_tpu_torch.tools.program_host_cost [--steps 5]

The numbers are host times on the machine that runs it, not device
times; compare two versions only within one run of one machine.
"""

import argparse
import collections
import time

import numpy as np
import torch

from paddle_tpu_torch import fluid
from paddle_tpu_torch.fluid.ops import registry
from paddle_tpu_torch.models import gpt

T, BATCH = 16, 2


def tiny_wide_config():
    return gpt.GPTConfig(vocab_size=211, hidden_size=64, num_layers=12,
                         num_heads=4, intermediate_size=128,
                         max_position_embeddings=T, hidden_dropout=0.0,
                         attention_dropout=0.0, use_flash_attention=True)


def feed():
    rs = np.random.RandomState(0)
    return {"ids": rs.randint(0, 211, (BATCH, T, 1)).astype("int64"),
            "pos_ids": np.tile(np.arange(T).reshape(1, T, 1),
                               (BATCH, 1, 1)).astype("int64"),
            "input_mask": np.ones((BATCH, T, 1), np.float32)}


def median_ms(fn, steps):
    fn()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def per_op_cost(run, steps):
    """{op type: (seconds in all, calls)} over ``steps`` runs, timing
    ``registry.run_op`` and ``registry.run_op_capturing`` (the latter
    under "<type>(captured)")."""
    cost = collections.defaultdict(lambda: [0.0, 0])
    run_op, run_capturing = registry.run_op, registry.run_op_capturing

    def timed_run_op(ctx, op):
        t0 = time.perf_counter()
        run_op(ctx, op)
        c = cost[op.type]
        c[0] += time.perf_counter() - t0
        c[1] += 1

    def timed_capturing(ctx, op, *args):
        t0 = time.perf_counter()
        run_capturing(ctx, op, *args)
        c = cost[op.type + "(captured)"]
        c[0] += time.perf_counter() - t0
        c[1] += 1

    registry.run_op, registry.run_op_capturing = timed_run_op, timed_capturing
    try:
        for _ in range(steps):
            run()
    finally:
        registry.run_op, registry.run_op_capturing = run_op, run_capturing
    return cost


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    cfg = tiny_wide_config()
    with fluid.unique_name.guard():
        main_prog, startup, _feeds, loss = gpt.build_gpt_lm_train(cfg, T)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    data = feed()

    def program_step():
        exe.run(main_prog, feed=data, fetch_list=[loss], scope=scope)

    _m, _o, _n, eager_step = gpt.build_gpt_lm_train_eager(cfg, T,
                                                          device="cpu")
    print("ops", len(main_prog.global_block().ops))
    print("program step ms", median_ms(program_step, args.steps))
    print("eager step ms", median_ms(lambda: eager_step(data), args.steps))
    cost = per_op_cost(program_step, args.steps)
    for op_type, (sec, calls) in sorted(cost.items(), key=lambda kv: -kv[1][0]):
        print("%-34s %8.1f us/call %5d calls/step %7.2f ms/step"
              % (op_type, sec / calls * 1e6, calls // args.steps,
                 sec / args.steps * 1e3))
    print("ops total ms/step", sum(c[0] for c in cost.values())
          / args.steps * 1e3)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
