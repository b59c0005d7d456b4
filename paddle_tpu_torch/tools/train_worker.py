"""One training worker for the launcher: GPT's LM program trained through
``Executor.train_from_dataset`` over MultiSlot token files, with a
checkpoint manager of its own, so a supervised restart resumes from its
newest committed step.

    python -m paddle_tpu_torch.distributed.launch --max_restarts 1 \\
        paddle_tpu_torch/tools/train_worker.py --files DIR --ckpt DIR \\
        --out DIR [--model gpt2|tiny] [--seq 1024] [--batch 8] \\
        [--interval 4] [--sync_saves]

The worker trains where the launcher says (``launch.worker_device()``:
the card unless ``--device cpu`` was given to the launcher), at dropout
``DROPOUT`` and Adam's learning rate ``LR``. Weights come from
``gpt.init_fluid_params(cfg, 0)`` after the startup run;
each rank keeps its checkpoints in ``--ckpt/rank_<RANK>`` (with
``--sync_saves`` an interval save commits before the next step starts,
so a crash mid-run finds the newest interval's checkpoint) and, when it
finishes, writes ``--out/rank_<RANK>.json`` (steps, where it resumed
from, its device, the flash kernels' launches in this life). A file is
``--files/part-*.txt``: one line per sample, three dense slots of
``seq`` values each (ids, positions, the loss mask);
``write_multislot`` writes them.
"""

import argparse
import functools
import glob
import json
import os
import sys

import numpy as np

DROPOUT = 0.1
LR = 3e-4


def write_multislot(path, batches):
    """Write ``batches`` (dicts of ``ids`` / ``pos_ids`` [N, T, 1] int64
    and ``input_mask`` [N, T, 1] float32) as MultiSlot lines: per sample,
    each slot's count and then its values."""
    with open(path, "w") as f:
        for b in batches:
            ids, pos, mask = (np.asarray(b[k]).reshape(len(b[k]), -1)
                              for k in ("ids", "pos_ids", "input_mask"))
            for r in range(ids.shape[0]):
                f.write("%d %s %d %s %d %s\n" % (
                    ids.shape[1], " ".join(map(str, ids[r].tolist())),
                    pos.shape[1], " ".join(map(str, pos[r].tolist())),
                    mask.shape[1], " ".join("%.9g" % x for x in mask[r])))


def gpt_dataset(feeds, files, batch):
    """A QueueDataset over MultiSlot GPT files: three dense slots, given
    ``feeds``' declared shapes."""
    from paddle_tpu_torch import fluid

    ds = fluid.DatasetFactory().create_dataset("QueueDataset")
    ds.set_filelist(list(files))
    ds.set_batch_size(batch)
    ds.set_multislot([False, False, True], dense_slots=[True, True, True])
    ds.set_use_var(feeds)
    return ds


def build(cfg, seq, lr, place, seed=0):
    """(main, feeds, loss, executor, scope): GPT's LM train program
    under a fresh name guard, startup run, weights from
    ``init_fluid_params(cfg, seed)``."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import gpt

    with fluid.unique_name.guard():
        main, startup, feeds, loss = gpt.build_gpt_lm_train(
            cfg, seq, learning_rate=lr)
    exe = fluid.Executor(place)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    gpt.load_fluid_scope(scope, gpt.init_fluid_params(cfg, seed))
    return main, feeds, loss, exe, scope


def config(model, seq, dropout):
    from paddle_tpu_torch.models import gpt

    kw = dict(use_flash_attention=True, hidden_dropout=dropout,
              attention_dropout=dropout)
    if model == "tiny":
        return gpt.GPTConfig.tiny(max_position_embeddings=seq, **kw)
    return gpt.GPTConfig(**kw)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--files", required=True)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--model", choices=("gpt2", "tiny"), default="gpt2")
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--interval", type=int, default=4)
    ap.add_argument("--sync_saves", action="store_true")
    args = ap.parse_args(argv)

    from paddle_tpu_torch import checkpoint, fluid
    from paddle_tpu_torch.distributed import launch

    dev = launch.worker_device()
    place = fluid.CPUPlace() if dev.type == "cpu" else fluid.CUDAPlace(
        dev.index or 0)
    if dev.type == "cpu":
        import torch

        torch.set_num_threads(2)
    rank = int(os.environ.get("RANK", "0"))
    main_prog, feeds, loss, exe, scope = build(
        config(args.model, args.seq, DROPOUT), args.seq, LR, place)
    files = sorted(glob.glob(os.path.join(args.files, "part-*.txt")))
    ds = gpt_dataset(feeds, files, args.batch)
    fluid.set_flags({"ckpt_save_interval_steps": args.interval})
    mgr = checkpoint.CheckpointManager(
        os.path.join(args.ckpt, "rank_%d" % rank))
    if args.sync_saves:
        mgr.save = functools.partial(mgr.save, async_=False)
    steps = exe.train_from_dataset(main_prog, ds, scope=scope,
                                   fetch_list=[loss], print_period=0,
                                   ckpt_manager=mgr)
    mgr.close()
    from paddle_tpu_torch.kernels import flash_attention as fa

    launches = {"flash_fwd": fa.flash_attention_lse.launches,
                "flash_bwd_dq": fa.flash_bwd_dq.launches,
                "flash_bwd_dkv": fa.flash_bwd_dkv.launches}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "rank_%d.json" % rank), "w") as f:
        json.dump({"rank": rank, "steps": steps, "device": str(dev),
                   "restored": mgr.last_restore_info,
                   "latest_step": mgr.latest_step(),
                   "launches": launches}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
