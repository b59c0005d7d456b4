"""Package boundary of the PyTorch/CUDA port: ``import paddle_tpu_torch``
loads neither JAX nor any module of the JAX package, and its entry
points run on the card unless the caller asks for the CPU."""

import json
import os
import subprocess
import sys

import pytest
import torch

from paddle_tpu_torch import fluid
from paddle_tpu_torch.fluid.core import CPUPlace, CUDAPlace, resolve_device
from paddle_tpu_torch.models import gpt as tgpt

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import json, sys
import paddle_tpu_torch
from paddle_tpu_torch.serving import decode
from paddle_tpu_torch.kernels import _build, flash_attention
from paddle_tpu_torch.fluid.ops import nn_ops
from paddle_tpu_torch.models import bert, gpt
from paddle_tpu_torch.fluid import optimizer
from paddle_tpu_torch.fluid.ops import math_ops, optimizer_ops
# the paged engine's names (the paged slice)
for fn in (decode.BlockAllocator, decode.PagedPrefixIndex,
           decode._ngram_draft, flash_attention.flash_decode_paged_attention,
           nn_ops.kv_cache_write_paged, nn_ops.kv_cache_gather_paged,
           nn_ops.kv_cache_block_copy, gpt.GPTLM.paged_step,
           gpt.paged_pool_names):
    assert callable(fn)
# the train step's names (the training slice)
for fn in (flash_attention.flash_bwd_dq, flash_attention.flash_bwd_dkv,
           flash_attention.flash_attention_bwd_from_residuals,
           flash_attention.flash_attention_bwd_plain, nn_ops.dropout,
           nn_ops.flash_attention_lse, math_ops.softmax_with_cross_entropy,
           optimizer_ops.adam, optimizer.Adam, bert.DropoutRNG,
           gpt.build_gpt_lm_train_eager, gpt.gpt_lm_loss):
    assert callable(fn)
# the Program/Executor slice
from paddle_tpu_torch import fluid
from paddle_tpu_torch.fluid import backward, executor, framework, layers
for fn in (framework.Program, framework.program_guard, executor.Executor,
           executor.scope_guard, backward.append_backward, layers.fc,
           layers.flash_attention, layers.create_parameter, fluid.Executor,
           gpt.build_gpt_lm_train, gpt.gpt_decoder, gpt.load_fluid_scope,
           bert.multi_head_attention, bert._dropout, bert.flash_engages):
    assert callable(fn)
# the AMP slice
from paddle_tpu_torch.fluid import ir
from paddle_tpu_torch.fluid.contrib import mixed_precision
from paddle_tpu_torch.fluid.contrib.mixed_precision import fp16_lists, fp16_utils
from paddle_tpu_torch.fluid.ops import controlflow_ops, registry
from paddle_tpu_torch.tools import flash_variants, lowp_limits
for fn in (flash_variants.build_variants, flash_variants.main,
           lowp_limits.out_bound, lowp_limits.grad_bounds,
           lowp_limits.planted_faults, mixed_precision.decorate, mixed_precision.AutoMixedPrecisionLists,
           fp16_utils.rewrite_program, fp16_utils.update_loss_scaling,
           fp16_utils.cast_parameters_to_bf16, ir.get_pass, ir.PassBuilder,
           ir.IrGraph, layers.isfinite, layers.where, layers.logical_and,
           layers.greater_equal, bert.linear, fluid.contrib.decorate):
    assert callable(fn)
for op_type in ("cast", "isfinite", "where", "greater_equal", "logical_and",
                "logical_not", "relu"):
    assert registry.has_op(op_type), op_type
assert "amp_rewrite_pass" in ir.all_registered_passes()
# the inference slice: persistence, the predictor and the serving front
from paddle_tpu_torch import inference
from paddle_tpu_torch.fluid import io, proto, proto_wire
from paddle_tpu_torch.fluid.ops import io_ops
from paddle_tpu_torch import serving
from paddle_tpu_torch.serving import buckets, metrics, pool, server
for fn in (io.save_inference_model, io.load_inference_model,
           io.save_persistables, io.load_persistables, proto.program_to_bytes,
           proto_wire.encode_program, io_ops.serialize_lod_tensor,
           inference.AnalysisPredictor, inference.create_paddle_predictor,
           server.InferenceServer, pool.PredictorPool, buckets.BucketLadder,
           metrics.snapshot_stats, gpt.build_gpt_infer, gpt.share_fluid_scope,
           framework.Program.parse_from_string):
    assert callable(fn)
for op_type in ("save", "load", "save_combine", "load_combine", "feed",
                "fetch", "print"):
    assert registry.has_op(op_type), op_type
# the gateway and observability slice
from paddle_tpu_torch.checkpoint import preempt
from paddle_tpu_torch.observability import (compile_stats, exporter, flight,
                                            trace)
from paddle_tpu_torch.serving import access_log, gateway, kv_tier
from paddle_tpu_torch.testing import chaos
from paddle_tpu_torch.tools import gateway_probe
for fn in (gateway.Gateway, gateway.encode_tensor, gateway.decode_tensor,
           access_log.AccessLog, kv_tier.chain_keys, kv_tier.encode_entries,
           kv_tier.decode_entries, kv_tier.read_peers,
           preempt.request_preemption, preempt.preemption_requested,
           chaos.on_stream_token, exporter.maybe_start_from_flags,
           exporter.final_snapshot, exporter.dump_blackbox,
           exporter.stop_global, flight.note, flight.dump_on_error,
           trace.trace_scope, trace.current_context, trace.chrome_trace,
           trace.parse_traceparent, compile_stats.arm_serving_steady,
           compile_stats.serving_request_window, compile_stats.warmup_window,
           compile_stats.summary, gateway_probe.run_probe,
           serving.Gateway, serving.AccessLog):
    assert callable(fn)
assert issubclass(compile_stats.SteadyStateRecompileError, RuntimeError)
# the serving control plane slice
from paddle_tpu_torch import distributed
from paddle_tpu_torch.checkpoint import modeldir
from paddle_tpu_torch.distributed import elastic, supervisor
from paddle_tpu_torch.observability import aggregate, fleet_trace
from paddle_tpu_torch.serving import fleet, replica, router, sim
from paddle_tpu_torch.tools import fleet_probe, fleet_sim
for fn in (router.Router, fleet.FleetController, fleet.AutoscalerPolicy,
           fleet.SLOPolicy, fleet.make_policy, fleet.read_fleet_state,
           replica.build_gpt_decode_engine, replica.main, sim.FleetSim,
           sim.synthetic_workload, sim.from_journeys, modeldir.publish,
           modeldir.commit_json, supervisor.worker_heartbeat,
           supervisor.read_heartbeat, supervisor.load_events,
           supervisor.WorkerHeartbeat, elastic.write_down_marker,
           aggregate.write_fleet_report, fleet_trace.merge,
           fleet_probe.run_probe, fleet_probe.run_runner, fleet_sim.main,
           decode.DecodeEngine.request_export, decode.DecodeEngine.offer_blocks,
           decode.DecodeEngine.prefix_heads, decode.PagedPrefixIndex.admit,
           kv_tier.HostBlockStore, kv_tier.SpillWorker, serving.Router,
           serving.FleetController, serving.AutoscalerPolicy,
           serving.SLOPolicy, serving.make_policy):
    assert callable(fn)
assert distributed.supervisor is supervisor
# the KV-cache serving programs slice
for fn in (gpt.build_gpt_prefill, gpt.build_gpt_resume_prefill,
           gpt.build_gpt_prefix_copy, gpt.build_gpt_decode_step,
           gpt.build_gpt_paged_window, gpt.build_gpt_paged_step,
           gpt.build_gpt_paged_block_copy, decode.ProgramDecodeSession,
           decode.DecodeSession.warmup, layers.flash_decode_attention,
           layers.flash_decode_paged_attention, layers.kv_cache_write,
           layers.kv_cache_copy, layers.kv_cache_gather,
           layers.kv_cache_write_paged, layers.kv_cache_gather_paged,
           layers.kv_cache_block_copy, fluid.save_inference_model,
           fluid.get_flags, fluid.set_flags):
    assert callable(fn)
for op_type in ("flash_decode_attention", "flash_decode_paged_attention",
                "kv_cache_write", "kv_cache_copy", "kv_cache_gather",
                "kv_cache_write_paged", "kv_cache_gather_paged",
                "kv_cache_block_copy"):
    assert registry.has_op(op_type), op_type
# the BERT classifier and vision slice
from paddle_tpu_torch.fluid.layers import metric_op
from paddle_tpu_torch.fluid.ops import metric_ops, tensor_ops
from paddle_tpu_torch.models import lenet, resnet
for fn in (bert.BertConfig.base, bert.BertConfig.tiny, bert.mask_to_bias,
           bert.encoder_layer, bert.bert_encoder, bert.build_bert_classifier,
           lenet.lenet, lenet.build_lenet_train, resnet.resnet,
           resnet.build_resnet_train, layers.conv2d, layers.pool2d,
           layers.batch_norm, layers.relu, layers.topk, layers.accuracy,
           metric_op.accuracy, metric_ops.accuracy, tensor_ops.top_k,
           nn_ops.conv2d, nn_ops.pool2d, nn_ops.batch_norm, optimizer_ops.sgd,
           optimizer_ops.momentum, optimizer.SGD, optimizer.SGDOptimizer,
           optimizer.Momentum, optimizer.MomentumOptimizer,
           fluid.load_program_scope, io.load_program_scope):
    assert callable(fn)
for op_type in ("tanh", "top_k", "accuracy", "conv2d", "depthwise_conv2d",
                "pool2d", "batch_norm", "sgd", "momentum"):
    assert registry.has_op(op_type), op_type
# the Transformer NMT and sub-block control-flow slice
from paddle_tpu_torch.fluid.layers import learning_rate_scheduler, math_op_patch
from paddle_tpu_torch.models import transformer
for fn in (transformer.TransformerConfig, transformer.TransformerConfig.tiny,
           transformer.transformer, transformer.build_transformer_train,
           transformer.build_transformer_infer,
           transformer.beam_search_decode, layers.one_hot,
           layers.label_smooth, layers.elementwise_min, layers.elementwise_pow,
           layers.elementwise_max, layers.autoincreased_step_counter,
           layers.logical_not, layers.exp, layers.floor, layers.ceil,
           layers.cos, layers.tanh, layers.While, layers.Switch, layers.cond,
           layers.increment, layers.less_than, layers.less_equal,
           layers.greater_than, layers.equal, layers.not_equal,
           layers.create_array, layers.array_write, layers.array_read,
           layers.array_length, layers.is_empty, layers.lod_rank_table,
           layers.lod_tensor_to_array, layers.array_to_lod_tensor,
           layers.max_sequence_len, layers.shrink_memory,
           math_op_patch.monkey_patch_variable, executor.lower_while_op,
           executor.lower_while_grad_op, executor.lower_conditional_block,
           executor.lower_conditional_block_grad):
    assert callable(fn)
for name in learning_rate_scheduler.__all__:
    assert getattr(layers, name) is getattr(learning_rate_scheduler, name)
assert len(learning_rate_scheduler.__all__) == 8
assert transformer is __import__("paddle_tpu_torch.models",
                                 fromlist=["transformer"]).transformer
assert callable(framework.Variable.__add__)   # math_op_patch applied
for op_type in ("one_hot", "label_smooth", "elementwise_min",
                "elementwise_pow", "elementwise_mod", "elementwise_floordiv",
                "increment", "floor", "ceil", "exp", "cos", "pow", "while",
                "while_grad", "conditional_block", "conditional_block_grad",
                "select_input", "select_output", "lod_rank_table",
                "lod_tensor_to_array", "array_to_lod_tensor",
                "write_to_array", "read_from_array", "lod_array_length",
                "max_sequence_len", "shrink_rnn_memory", "is_empty",
                "split_lod_tensor", "merge_lod_tensor", "less_than",
                "less_equal", "greater_than", "equal", "not_equal"):
    assert registry.has_op(op_type), op_type
# the recompute and recurrent-layers slice
from paddle_tpu_torch.fluid import data_feeder, lod_tensor, nets
from paddle_tpu_torch.fluid.contrib.layers import rnn_impl
from paddle_tpu_torch.fluid.layers import compat, extended, utils
from paddle_tpu_torch.fluid.ops import rnn_fused_ops, rnn_ops, sequence_ops
for fn in (optimizer.RecomputeOptimizer, optimizer.Adagrad,
           optimizer.AdagradOptimizer, optimizer_ops.adagrad,
           backward._recompute_transform, fluid.DataFeeder,
           fluid.create_lod_tensor, fluid.create_random_int_lodtensor,
           data_feeder.DataToLoDTensorConverter, lod_tensor.create_lod_tensor,
           layers.dynamic_lstm, layers.dynamic_lstmp, layers.dynamic_gru,
           layers.gru_unit, layers.lstm_unit, layers.StaticRNN,
           layers.DynamicRNN, layers.IfElse, layers.RNNCell, layers.GRUCell,
           layers.LSTMCell, layers.Decoder, layers.BeamSearchDecoder,
           layers.dynamic_decode, layers.sequence_pool,
           layers.sequence_conv, layers.lod_reset, layers.gather_tree,
           layers.cross_entropy, compat.lod_reset, extended.dynamic_lstm,
           utils.flatten, rnn_impl.basic_lstm, rnn_impl.basic_gru,
           fluid.contrib.basic_lstm, fluid.contrib.layers.basic_gru,
           nets.simple_img_conv_pool, nets.img_conv_group, nets.glu,
           nets.scaled_dot_product_attention, nets.sequence_conv_pool,
           rnn_ops.gather_tree, sequence_ops.reverse_valid_prefix,
           sequence_ops.lengths_for):
    assert callable(fn)
for op_type in list(sequence_ops.SEQLEN_OUT_SLOTS)[:11] + [
        "sequence_pool", "sequence_softmax", "sequence_expand",
        "sequence_reshape", "sequence_concat", "sequence_mask",
        "sequence_scatter", "im2sequence", "lstm_unit", "gru_unit",
        "recurrent", "dynamic_decode", "gather_tree", "adagrad",
        "recompute_barrier", "concat", "split", "expand", "gather",
        "squeeze2", "fill_constant_batch_size_like", "sigmoid",
        "log_softmax", "clip", "cumsum", "cross_entropy"]:
    assert registry.has_op(op_type), op_type
# the training runtime slice
import paddle_tpu_torch
from paddle_tpu_torch import checkpoint, distributed, reader
from paddle_tpu_torch.checkpoint import manager
from paddle_tpu_torch.distributed import guardian, launch
from paddle_tpu_torch.fluid import (data_feed_desc, dataset, debugger,
                                    device_worker, io_pipeline, native,
                                    trainer, trainer_desc, trainer_factory)
from paddle_tpu_torch.fluid import reader as fluid_reader
from paddle_tpu_torch.fluid.layers import loss as loss_layers
from paddle_tpu_torch.tools import train_worker
for fn in (reader.shuffle, reader.batch, reader.buffered, reader.xmap_readers,
           reader.compose, reader.chain, reader.firstn, reader.cache,
           reader.map_readers, paddle_tpu_torch.batch,
           io_pipeline.DeviceFeeder, io_pipeline.DeviceFeedBatch,
           io_pipeline.resolve_device, io_pipeline.buffer_size,
           native.BlockingQueue, native.MultiSlotFile,
           native.serialize_tensor, fluid_reader.DataLoader.from_generator,
           fluid_reader.DataLoader.from_dataset, fluid_reader.PyReader,
           dataset.DatasetFactory, dataset.QueueDataset,
           dataset.InMemoryDataset, data_feed_desc.DataFeedDesc,
           trainer.MultiTrainer, trainer.train_from_dataset,
           trainer_factory.TrainerFactory, trainer_desc.TrainerDesc,
           device_worker.DeviceWorkerFactory, debugger.scan_fetches,
           debugger.set_check_nan_inf, manager.CheckpointManager,
           checkpoint.list_steps, checkpoint.latest_step,
           guardian.Guardian, guardian.attach_health_fetch,
           guardian.state_digest, guardian.RobustWindow, launch.launch,
           launch.build_specs, launch.worker_device,
           train_worker.write_multislot, fluid.cpu_places, fluid.cuda_places,
           fluid.Executor.train_from_dataset, layers.square,
           layers.square_error_cost, loss_layers.square_error_cost):
    assert callable(fn)
for op_type in ("square", "square_error_cost"):
    assert registry.has_op(op_type), op_type
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "paddle_tpu")
             or m.startswith(("jax.", "jaxlib.", "paddle_tpu.")))
print(json.dumps(bad))
"""


def test_import_loads_no_jax_and_no_reference_package():
    p = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []


def test_import_starts_no_process_group():
    """``import paddle_tpu_torch`` and its data-parallel names start no
    ``torch.distributed`` world and load neither JAX nor the JAX
    package; a world starts only when a caller asks
    (``parallel.initialize_distributed``)."""
    probe = (
        "import json, sys\n"
        "import paddle_tpu_torch\n"
        "import torch.distributed as dist\n"
        "from paddle_tpu_torch import fluid, parallel\n"
        "from paddle_tpu_torch.fluid.incubate.fleet.collective import fleet\n"
        "fluid.CompiledProgram, fluid.ParallelExecutor, fleet\n"
        "print(json.dumps([dist.is_initialized(), parallel.world_size(),\n"
        "    sorted(m for m in sys.modules if m == 'jax'\n"
        "           or m.split('.')[0] == 'paddle_tpu')]))\n")
    p = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert json.loads(p.stdout.strip().splitlines()[-1]) == [False, 1, []]


def test_port_sources_never_import_jax_or_the_reference():
    """Belt and braces for lazy imports the probe above cannot reach."""
    root = os.path.join(REPO, "paddle_tpu_torch")
    offenders = []
    for dirpath, _dirs, files in os.walk(root):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            with open(path) as f:
                for line in f:
                    s = line.strip()
                    if s.startswith(("import ", "from ")) and (
                            " jax" in s or "paddle_tpu " in s
                            or "paddle_tpu." in s):
                        offenders.append((os.path.relpath(path, REPO), s))
    assert offenders == []


def test_every_kernel_source_is_built_and_every_build_has_a_source():
    from paddle_tpu_torch.kernels import _build

    sources = sorted(fn[:-3] for fn in os.listdir(_build.SRC_DIR)
                     if fn.endswith(".cu"))
    assert sources == sorted(_build.KERNELS)
    assert {"flash_decode_paged", "flash_bwd_dq",
            "flash_bwd_dkv"} <= set(sources)


@pytest.mark.skipif("torch.cuda.is_available()",
                    reason="checks the behaviour of a machine without a GPU")
def test_entry_points_default_to_cuda_and_raise_without_gpu():
    cfg = tgpt.GPTConfig.tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgpt.GPTLM(cfg)
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device(CUDAPlace(0))
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    with pytest.raises(RuntimeError):
        fluid.Executor()
    from paddle_tpu_torch import inference

    config = inference.AnalysisConfig("/nonexistent")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        inference.AnalysisPredictor(config)
    config.enable_use_gpu(100, 0)
    with pytest.raises(RuntimeError):
        inference.create_paddle_predictor(config)
    from paddle_tpu_torch.serving import decode

    with pytest.raises(RuntimeError):
        decode.DecodeSession(cfg, slots=1, max_len=8)
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(CPUPlace()) == torch.device("cpu")
    assert tgpt.GPTLM(cfg, device="cpu").device == torch.device("cpu")


# the reference ``fluid``'s top-level persistence and flag names
# (paddle_tpu/fluid/__init__.py:50-62, :69-70, :85-90)
_IO_NAMES = ("save_vars", "save_params", "save_persistables", "load_vars",
             "load_params", "load_persistables", "save_inference_model",
             "load_inference_model", "save", "load", "load_program_state",
             "set_program_state")


@pytest.mark.parametrize("name", _IO_NAMES + ("get_flags", "set_flags"))
def test_fluid_reexports_the_reference_io_and_flag_names(name):
    """Each name the reference's ``fluid`` re-exports from ``fluid.io``
    and ``fluid.flags`` is in the port's ``fluid`` and its ``__all__``,
    and is the port's own ``io`` / ``flags`` function."""
    import paddle_tpu.fluid as jfluid

    home = fluid.io if name in _IO_NAMES else fluid.flags
    assert callable(getattr(jfluid, name))
    assert getattr(fluid, name) is getattr(home, name)
    assert name in fluid.__all__


# the reference ``fluid``'s LoD feed names (paddle_tpu/fluid/__init__.py:49,
# :96-97) and the recurrent layers this port adds
_LOD_NAMES = ("DataFeeder", "create_lod_tensor",
              "create_random_int_lodtensor")
_RNN_LAYERS = ("StaticRNN", "DynamicRNN", "IfElse", "RNNCell", "GRUCell",
               "LSTMCell", "Decoder", "BeamSearchDecoder", "dynamic_decode",
               "dynamic_lstm", "dynamic_lstmp", "dynamic_gru", "gru_unit",
               "lstm_unit", "sequence_pool", "sequence_first_step",
               "sequence_last_step", "sequence_softmax", "sequence_reshape",
               "sequence_concat", "sequence_expand", "sequence_expand_as",
               "sequence_pad", "sequence_unpad", "sequence_slice",
               "sequence_reverse", "sequence_mask", "sequence_enumerate",
               "sequence_scatter", "sequence_conv", "row_conv",
               "im2sequence", "lod_reset", "gather_tree")


# the reference ``fluid``'s data-parallel names
# (paddle_tpu/fluid/__init__.py:45-46, :71-72, :92-93, :101)
_DP_NAMES = ("CompiledProgram", "ExecutionStrategy", "BuildStrategy",
             "ParallelExecutor", "transpiler", "DistributeTranspiler",
             "DistributeTranspilerConfig", "memory_optimize",
             "release_memory", "incubate", "fleet")


@pytest.mark.parametrize("name", _DP_NAMES)
def test_fluid_exports_the_reference_data_parallel_names(name):
    import paddle_tpu.fluid as jfluid

    assert getattr(jfluid, name) is not None
    assert getattr(fluid, name) is not None
    assert name in fluid.__all__
    if name == "fleet":   # both export the fleet package, not an object
        assert fluid.fleet.collective.fleet is not None


@pytest.mark.parametrize("name", _LOD_NAMES)
def test_fluid_exports_the_reference_lod_feed_names(name):
    """``fluid.DataFeeder``, ``create_lod_tensor`` and
    ``create_random_int_lodtensor`` as the reference's ``fluid`` exports
    them, in the port's ``__all__``."""
    import paddle_tpu.fluid as jfluid

    assert callable(getattr(jfluid, name))
    assert callable(getattr(fluid, name))
    assert name in fluid.__all__


@pytest.mark.parametrize("name", _RNN_LAYERS)
def test_layers_export_the_reference_recurrent_layers(name):
    """Each recurrent and sequence layer of the reference's
    ``fluid.layers`` is in the port's ``fluid.layers``."""
    import paddle_tpu.fluid as jfluid

    assert callable(getattr(jfluid.layers, name))
    assert callable(getattr(fluid.layers, name))


def test_get_flags_matches_the_reference():
    """``get_flags`` as the reference's: a name with or without
    ``FLAGS_`` or a list of them, to ``{FLAGS_name: value}``;
    ``ValueError`` on a name that is not registered."""
    from paddle_tpu.fluid import flags as jflags

    one = "decode_slots"
    many = ["FLAGS_decode_slots", "sched_preempt", "FLAGS_serving_workers"]
    assert fluid.get_flags(one) == jflags.get_flags(one)
    assert fluid.get_flags(many) == jflags.get_flags(many)
    assert set(fluid.get_flags(many)) == {
        "FLAGS_decode_slots", "FLAGS_sched_preempt", "FLAGS_serving_workers"}
    for fl in (fluid.flags, jflags):
        with pytest.raises(ValueError, match="not registered"):
            fl.get_flags(["decode_slots", "no_such_knob"])


def test_training_runtime_defaults_to_cuda_and_raises_without_gpu(
        monkeypatch):
    """``DataLoader`` / ``PyReader`` places, ``cuda_places()``,
    ``DeviceFeeder`` and the launcher's workers default to the card and
    raise without one; the CPU runs when it is asked for."""
    import numpy as np

    from paddle_tpu_torch.distributed import launch
    from paddle_tpu_torch.fluid import io_pipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cpu_places"):
        fluid.cuda_places()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        io_pipeline.DeviceFeeder(iter([]))
    assert list(io_pipeline.DeviceFeeder(iter([]), place="cpu")) == []
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        x = fluid.layers.data(name="gx", shape=[2], dtype="float32")

    def batches():
        yield [np.ones((1, 2), "float32")]

    loader = fluid.DataLoader.from_generator(feed_list=[x])
    loader.set_batch_generator(batches)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(iter(loader))
    reader = fluid.PyReader(feed_list=[x], iterable=False)
    reader.decorate_batch_generator(batches)
    reader.start()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        reader.next()
    reader.reset()
    loader.set_batch_generator(batches, places=fluid.cpu_places())
    (b,) = list(loader)
    assert b["gx"].device == torch.device("cpu")
    monkeypatch.delenv(launch.DEVICE_ENV, raising=False)
    with pytest.raises(RuntimeError):
        launch.worker_device()


# the reference's training-runtime names (paddle_tpu/fluid/__init__.py,
# paddle_tpu/__init__.py)
_RUNTIME_NAMES = ("DataLoader", "PyReader", "dataset", "DatasetFactory",
                  "debugger", "set_check_nan_inf", "cpu_places",
                  "cuda_places", "DataFeedDesc", "trainer_desc",
                  "trainer_factory", "device_worker")


@pytest.mark.parametrize("name", _RUNTIME_NAMES)
def test_fluid_exports_the_reference_training_runtime_names(name):
    import paddle_tpu.fluid as jfluid

    # the reference's DatasetFactory lives in its fluid.dataset
    assert getattr(jfluid, name, None) is not None or getattr(
        jfluid.dataset, name) is not None
    assert getattr(fluid, name) is not None
    assert name in fluid.__all__


@pytest.mark.parametrize("name", ("reader", "batch", "checkpoint",
                                  "distributed"))
def test_package_exports_the_reference_top_level_names(name):
    import paddle_tpu
    import paddle_tpu_torch

    assert getattr(paddle_tpu, name) is not None
    assert getattr(paddle_tpu_torch, name) is not None
    assert name in paddle_tpu_torch.__all__


def test_dygraph_import_loads_no_jax_and_no_reference_package():
    """``fluid.dygraph`` and the dygraph model programs load neither JAX
    nor the JAX package."""
    probe = (
        "import json, sys\n"
        "import paddle_tpu_torch.fluid as f\n"
        "f.dygraph.guard, f.dygraph.Layer, f.dygraph.DataParallel\n"
        "from paddle_tpu_torch.fluid.dygraph import (checkpoint, jit, nn,\n"
        "    parallel, tracer)\n"
        "from paddle_tpu_torch.testing import dygraph_models\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "    if m.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu'))))\n")
    p = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []


def test_dygraph_guard_defaults_to_cuda_and_raises_without_gpu():
    """``dygraph.guard()`` with no place is the card and raises on a
    machine without one; ``guard(CPUPlace())`` runs its ops on the
    CPU."""
    import numpy as np

    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a GPU")

    with pytest.raises(RuntimeError, match="device='cpu'"):
        with fluid.dygraph.guard():
            pass
    with pytest.raises(RuntimeError):
        fluid.dygraph.enable_dygraph()
    assert not fluid.in_dygraph_mode()
    # a tracer built by hand is the card too, unless given the CPU
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fluid.dygraph.Tracer()
    assert fluid.dygraph.Tracer(torch.device("cpu")).device.type == "cpu"
    with fluid.dygraph.guard(CPUPlace()):
        assert fluid.in_dygraph_mode()
        y = fluid.layers.relu(fluid.dygraph.to_variable(
            np.array([-1.0, 2.0], np.float32)))
        assert y.value.device == torch.device("cpu")
        assert y.numpy().tolist() == [0.0, 2.0]
    assert not fluid.in_dygraph_mode()
