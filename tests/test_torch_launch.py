"""The port's launcher (``python -m paddle_tpu_torch.distributed.launch``)
on the CPU: its per-worker environment against the reference's, its
device guard, and two supervised workers (``tools/train_worker.py``,
the tiny GPT through ``train_from_dataset`` with a checkpoint manager
each) of which one is killed by chaos mid-run: the supervisor restarts
the gang, both resume from their newest checkpoints, and each ends at
the state of an uninterrupted run, bit for bit (dropout 0.1: the
manifests carry the generator states)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddle_tpu.distributed import launch as jlaunch
from paddle_tpu_torch import checkpoint as tcheckpoint
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.distributed import launch as tlaunch
from paddle_tpu_torch.distributed import supervisor as tsupervisor
from paddle_tpu_torch.tools import train_worker as tw
from test_torch_cpu_math import pin_vector_math

pin_vector_math(2)  # 2 threads, as each CPU worker sets (see there)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 16
BATCH = 4
STEPS = 8


def test_worker_env_carries_the_reference_contract_and_torch_rendezvous():
    argv = ["--nproc_per_node", "2", "--started_port", "7100", "train.py",
            "--x", "1"]
    t_specs = tlaunch.build_specs(tlaunch._parse_args(argv))
    j_specs = jlaunch.build_specs(jlaunch._parse_args(argv))
    assert len(t_specs) == len(j_specs) == 2
    for rank, (t, j) in enumerate(zip(t_specs, j_specs)):
        for k, v in j.env.items():
            if k.startswith("PADDLE_"):
                assert t.env[k] == v, k
        assert not any(k.startswith("JAX_") for k in t.env)
        assert t.env["RANK"] == t.env["PADDLE_TRAINER_ID"] == str(rank)
        assert t.env["LOCAL_RANK"] == str(rank)
        assert t.env["WORLD_SIZE"] == "2"
        assert t.env["MASTER_ADDR"] == "127.0.0.1"
        assert t.env["MASTER_PORT"] == "8100"
        assert t.env[tlaunch.DEVICE_ENV] == "cuda"
        assert "CUDA_VISIBLE_DEVICES" not in t.env
        assert t.cmd[-3:] == ["train.py", "--x", "1"] and t.rank == rank


def test_selected_gpus_give_one_card_to_each_worker():
    specs = tlaunch.build_specs(tlaunch._parse_args(
        ["--selected_gpus", "2,5", "--nproc_per_node", "7", "train.py"]))
    assert [s.env["CUDA_VISIBLE_DEVICES"] for s in specs] == ["2", "5"]
    assert [s.env["WORLD_SIZE"] for s in specs] == ["2", "2"]
    cpu = tlaunch.build_specs(tlaunch._parse_args(
        ["--selected_gpus", "0", "--device", "cpu", "train.py"]))
    assert "CUDA_VISIBLE_DEVICES" not in cpu[0].env
    assert cpu[0].env[tlaunch.DEVICE_ENV] == "cpu"


def _uninterrupted(files, steps):
    """The final persistables of one worker's run, trained in process
    without a break."""
    cfg = tw.config("tiny", T, tw.DROPOUT)
    main, feeds, loss, exe, scope = tw.build(cfg, T, tw.LR,
                                             tfluid.CPUPlace())
    got = exe.train_from_dataset(main, tw.gpt_dataset(feeds, files, BATCH),
                                 scope=scope, fetch_list=[loss],
                                 print_period=0)
    assert got == steps
    return {v.name: scope.get(v.name).clone() for v in main.list_vars()
            if v.persistable and isinstance(scope.get(v.name),
                                            torch.Tensor)}


def test_supervised_crash_and_resume_ends_at_the_uninterrupted_state(
        tmp_path):
    rs = np.random.RandomState(0)
    batches = [{"ids": rs.randint(0, 211, (BATCH, T, 1)).astype("int64"),
                "pos_ids": np.tile(np.arange(T).reshape(1, T, 1),
                                   (BATCH, 1, 1)).astype("int64"),
                "input_mask": np.ones((BATCH, T, 1), np.float32)}
               for _ in range(STEPS)]
    fdir = tmp_path / "files"
    fdir.mkdir()
    for i in range(0, STEPS, 4):
        tw.write_multislot(str(fdir / ("part-%05d.txt" % i)),
                           batches[i: i + 4])
    env = dict(os.environ, PYTHONPATH=REPO,
               FLAGS_chaos_crash_at_step="5", FLAGS_chaos_target_rank="1",
               FLAGS_chaos_marker_dir=str(tmp_path / "markers"))
    sup = str(tmp_path / "sup")
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", "2", "--device", "cpu", "--max_restarts",
           "1", "--supervisor_dir", sup,
           os.path.join(REPO, "paddle_tpu_torch", "tools",
                        "train_worker.py"),
           "--files", str(fdir), "--ckpt", str(tmp_path / "ck"),
           "--out", str(tmp_path / "out"), "--model", "tiny",
           "--seq", str(T), "--batch", str(BATCH), "--interval", "2"]
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    kinds = [e["event"] for e in tsupervisor.load_events(sup)]
    assert kinds.count("gang_start") == 2
    for want in ("crash_detected", "restart", "gang_done"):
        assert want in kinds, kinds
    files = sorted(str(p) for p in fdir.iterdir())
    want = _uninterrupted(files, STEPS)
    for rank in (0, 1):
        with open(str(tmp_path / "out" / ("rank_%d.json" % rank))) as f:
            info = json.load(f)
        assert info["steps"] == STEPS and info["device"] == "cpu"
        hb = tsupervisor.read_heartbeat(os.path.join(
            sup, "heartbeats", "heartbeat_%d.json" % rank))
        assert hb["status"] == "done" and hb["step"] == STEPS - 1
        mgr = tcheckpoint.CheckpointManager(
            str(tmp_path / "ck" / ("rank_%d" % rank)))
        assert mgr.latest_step() == STEPS - 1
        got = dict(mgr._iter_step_tensors(STEPS - 1))
        mgr.close()
        assert set(want) <= set(got)
        for n in want:
            assert torch.equal(got[n], want[n]), (rank, n)
    # the crashed rank resumed from a checkpoint of the first life
    with open(str(tmp_path / "out" / "rank_1.json")) as f:
        assert json.load(f)["restored"]["step"] < STEPS - 1


def test_launcher_refuses_to_start_workers_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = tlaunch._parse_args(["train.py"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        tlaunch.start_procs(args)
    monkeypatch.delenv(tlaunch.DEVICE_ENV, raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.worker_device()
    monkeypatch.setenv(tlaunch.DEVICE_ENV, "cpu")
    assert tlaunch.worker_device() == torch.device("cpu")
