"""Persistence in the port (``paddle_tpu_torch.fluid.io``, its host ops in
``fluid/ops/io_ops.py`` and the program codec ``fluid/proto*.py``) held
against the JAX package on the CPU, byte for byte.

- The LoDTensor stream: fp32, fp16 and int64, with and without LoD, are
  the reference codec's bytes and read back in both packages. The
  reference's codec has no bf16 entry (its dtype table raises KeyError on
  ``ml_dtypes.bfloat16``), so a bf16 stream is held to the reference's
  stream of the same bits as int16 under the dtype value BF16 = 22.
- The same tiny GPT inference program (``build_gpt_infer``), built by
  both packages after a ``unique_name`` reset and from one call site (op
  attributes record the user's call stack), saves a byte-identical
  ``__model__`` and parameter files, separate and combined.
- A model directory saved by either package loads in the other's
  predictor; logits agree within 1e-5 (the same fp32 arithmetic in two
  frameworks, summed in different orders).
- ``save_persistables`` / ``load_persistables`` resume the port's train
  program: the resumed step's loss is the uninterrupted step's.
"""

import os
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import inference as jinference
from paddle_tpu.fluid.ops import io_ops as jio
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch import inference as tinference
from paddle_tpu_torch.fluid import proto as tproto
from paddle_tpu_torch.fluid.ops import io_ops as tio
from paddle_tpu_torch.models import gpt as tgpt
from test_torch_cpu_math import pin_vector_math

pin_vector_math(2)  # 2 threads, vector math set up on one (see there)

T = 16
_LOD = [[0, 2, 5], [0, 1, 3, 4, 6, 7]]


def _array(kind, rs):
    if kind == "int64":
        return rs.randint(-(1 << 40), 1 << 40, (7, 3)).astype(np.int64)
    a = rs.randn(7, 3).astype(np.float32)
    return a.astype(np.float16) if kind == "fp16" else a


@pytest.mark.parametrize("lod", [False, True], ids=["dense", "lod"])
@pytest.mark.parametrize("kind", ["fp32", "fp16", "int64", "bf16"])
def test_stream_bytes_are_the_references(kind, lod):
    rs = np.random.RandomState(len(kind) + 10 * lod)
    levels = _LOD if lod else []
    if kind == "bf16":
        t = torch.from_numpy(rs.randn(7, 3).astype(np.float32)).bfloat16()
        bits = t.view(torch.int16).numpy()
        ref = jio.serialize_lod_tensor(_ref_lod_tensor(bits, levels))
        # the int16 stream's dtype byte (INT16 = 1) becomes BF16 = 22
        desc = jio._tensor_desc_bytes(bits)
        at = ref.index(desc)
        assert desc[:2] == b"\x08\x01"
        want = ref[:at] + b"\x08\x16" + ref[at + 2:]
        value = t
    else:
        arr = _array(kind, rs)
        want = jio.serialize_lod_tensor(_ref_lod_tensor(arr, levels))
        value = torch.from_numpy(arr)
    got = tio.serialize_lod_tensor(tfluid.LoDTensor(value, lod=levels))
    assert got == want
    back, end = tio.deserialize_lod_tensor(got + b"tail")
    assert end == len(got)
    assert back.lod() == levels
    assert back.tensor().dtype == value.dtype
    assert torch.equal(back.tensor(), value)
    if kind != "bf16":
        jback, jend = jio.deserialize_lod_tensor(got)
        assert jend == len(got) and jback.lod() == levels
        np.testing.assert_array_equal(jback.numpy(), value.numpy())


def _ref_lod_tensor(arr, levels):
    t = jfluid.core.LoDTensor(arr)
    t.set_lod(levels)
    return t


def test_save_load_ops_keep_dtype_and_lod(tmp_path):
    """The ops path, not only the codec: a bf16 and a LoD variable go
    through save_vars / load_vars (separate and combined) and come back
    with their dtype, offsets and values."""
    prog = tfluid.Program()
    blk = prog.global_block()
    a = blk.create_var(name="a_bf16", shape=(3, 4), dtype="bfloat16",
                       persistable=True)
    b = blk.create_var(name="b_lod", shape=(5, 2), dtype="float32",
                       persistable=True)
    va = torch.arange(12, dtype=torch.float32).reshape(3, 4).bfloat16() / 7
    vb = torch.randn(5, 2, generator=torch.Generator().manual_seed(0))
    exe = tfluid.Executor(tfluid.CPUPlace())
    for filename in (None, "__params__"):
        src, dst = tfluid.Scope(), tfluid.Scope()
        src.set("a_bf16", va)
        src.set("b_lod", tfluid.LoDTensor(vb, lod=[[0, 2, 5]]))
        d = str(tmp_path / str(filename))
        with tfluid.scope_guard(src):
            tfluid.io.save_vars(exe, d, prog, vars=[a, b], filename=filename)
        with tfluid.scope_guard(dst):
            tfluid.io.load_vars(exe, d, prog, vars=[a, b], filename=filename)
        assert dst.get("a_bf16").dtype == torch.bfloat16
        assert torch.equal(dst.get("a_bf16"), va)
        assert dst.find_var("b_lod").get_tensor().lod() == [[0, 2, 5]]
        assert torch.equal(dst.get("b_lod"), vb)


def _feed(rows, seq, seed, vocab=211):
    rs = np.random.RandomState(seed)
    mask = np.ones((rows, seq, 1), np.float32)
    mask[0, seq - 3:] = 0.0
    return [rs.randint(0, vocab, (rows, seq, 1)).astype(np.int64),
            np.tile(np.arange(seq).reshape(1, seq, 1),
                    (rows, 1, 1)).astype(np.int64), mask]


def _build_and_save(mod, d, params, params_filename=None):
    """Build the tiny GPT inference program in ``mod``'s package (the
    reference's gpt module or the port's), fill its scope with
    ``params`` and save it: one call site for both packages, so the ops'
    recorded call stacks agree. Returns the startup scope's values."""
    fl = jfluid if mod is jgpt else tfluid
    cfg = mod.GPTConfig.tiny(use_flash_attention=True,
                             max_position_embeddings=T,
                             hidden_dropout=0.0, attention_dropout=0.0)
    with fl.unique_name.guard():
        main, startup, feeds, logits = mod.build_gpt_infer(cfg, T)
    main.random_seed = startup.random_seed = 5
    exe = fl.Executor(fl.CPUPlace())
    scope = fl.core.Scope()
    with fl.scope_guard(scope):
        exe.run(startup)
        if params is not None:
            tgpt.load_fluid_scope(scope, params)
        fl.io.save_inference_model(d, feeds, [logits], exe,
                                   main_program=main,
                                   params_filename=params_filename)
    names = tgpt.fluid_param_shapes(tgpt.GPTConfig.tiny(
        max_position_embeddings=T))
    return {n: np.asarray(scope.get(n)) for n in names}


@pytest.mark.parametrize("params_filename", [None, "__params__"],
                         ids=["separate", "combined"])
def test_inference_model_files_are_the_references(tmp_path, params_filename):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    params = None
    for mod, d in ((jgpt, jdir), (tgpt, tdir)):
        params = _build_and_save(mod, d, params, params_filename)
    files = sorted(os.listdir(jdir))
    assert files == sorted(os.listdir(tdir))
    assert "__model__" in files
    expect = 1 if params_filename else len(params)
    assert len(files) == 1 + expect
    for fn in files:
        with open(os.path.join(jdir, fn), "rb") as f:
            want = f.read()
        with open(os.path.join(tdir, fn), "rb") as f:
            got = f.read()
        assert got == want, fn
    if params_filename:
        # the (program file, params file) form of the config, both sides
        cfgs = [mod.AnalysisConfig(os.path.join(d, "__model__"),
                                   os.path.join(d, params_filename))
                for mod, d in ((jinference, jdir), (tinference, tdir))]
        cfgs[1].disable_gpu()
        feed = _feed(2, T, 4)
        (want,) = jinference.create_paddle_predictor(cfgs[0]).run(feed)
        (got,) = tinference.create_paddle_predictor(cfgs[1]).run(feed)
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    # the program codec round-trips both of its formats
    with open(os.path.join(tdir, "__model__"), "rb") as f:
        blob = f.read()
    prog = tfluid.Program.parse_from_string(blob)
    assert prog.desc_str() == blob
    pickled = tproto.MAGIC + pickle.dumps(
        tproto.program_to_spec(prog))
    assert tproto.program_to_bytes(tproto.program_from_bytes(pickled)) == blob


def _port_predictor(d):
    cfg = tinference.AnalysisConfig(d)
    cfg.disable_gpu()
    return tinference.create_paddle_predictor(cfg)


@pytest.mark.parametrize("saver", ["jax", "torch"])
def test_saved_model_loads_in_the_other_package(tmp_path, saver):
    """Each package's saved directory, served by both predictors: the
    reference's startup values, saved by ``saver``."""
    d = str(tmp_path / saver)
    if saver == "jax":
        _build_and_save(jgpt, d, None)
    else:
        params = _build_and_save(jgpt, str(tmp_path / "init"), None)
        _build_and_save(tgpt, d, params)
    jpred = jinference.create_paddle_predictor(jinference.AnalysisConfig(d))
    tpred = _port_predictor(d)
    assert tpred.get_input_names() == jpred.get_input_names()
    assert tpred.get_output_names() == jpred.get_output_names()
    for rows, seq, seed in ((1, T, 0), (3, 9, 1)):
        feed = _feed(rows, seq, seed)
        (want,) = jpred.run(feed)
        (got,) = tpred.run(feed)
        assert got.shape == (rows, seq, 211)
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


def test_persistables_resume_the_train_program(tmp_path):
    """Step 1, save the persistables, step 2; a fresh scope loaded from
    the save runs step 2 again: the same loss, to fp32 round-off (1e-6
    relative: the same ops on the same values)."""
    cfg = tgpt.GPTConfig.tiny(use_flash_attention=True,
                              max_position_embeddings=T,
                              hidden_dropout=0.0, attention_dropout=0.0)
    with tfluid.unique_name.guard():
        main, startup, _feeds, loss = tgpt.build_gpt_lm_train(
            cfg, T, learning_rate=1e-2)
    exe = tfluid.Executor(tfluid.CPUPlace())
    feed = dict(zip(("ids", "pos_ids", "input_mask"), _feed(2, T, 3)))
    d = str(tmp_path / "ckpt")
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    tgpt.load_fluid_scope(scope, tgpt.init_fluid_params(cfg, 0))
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    with tfluid.scope_guard(scope):
        tfluid.io.save_persistables(exe, d, main)
    (want,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    fresh = tfluid.Scope()
    exe.run(startup, scope=fresh)
    with tfluid.scope_guard(fresh):
        tfluid.io.load_persistables(exe, d, main)
    (got,) = exe.run(main, feed=feed, fetch_list=[loss], scope=fresh)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    saved = set(os.listdir(d))
    assert {"tok_embedding", "lm_head.w_0"} <= saved
    assert any("moment1" in n for n in saved)


def test_print_op_prints_what_the_reference_prints(capsys):
    """The host ``print`` op: the same line as the reference's for the
    same value and attributes, and its output is its input."""
    x = np.arange(6, dtype=np.float32).reshape(2, 3) / 4
    lines = []
    for fl in (jfluid, tfluid):
        prog = fl.Program()
        blk = prog.global_block()
        blk.create_var(name="x", shape=(2, 3), dtype="float32")
        blk.create_var(name="y", shape=(2, 3), dtype="float32")
        blk.append_op(type="print", inputs={"In": ["x"]},
                      outputs={"Out": ["y"]},
                      attrs={"message": "step", "summarize": 4,
                             "first_n": -1, "print_phase": "both"})
        exe = fl.Executor(fl.CPUPlace())
        (y,) = exe.run(prog, feed={"x": x}, fetch_list=["y"],
                       scope=fl.core.Scope())
        np.testing.assert_array_equal(np.asarray(y), x)
        lines.append(capsys.readouterr().out)
    assert lines[1] == lines[0]
    assert lines[1].startswith("step x float32 [2, 3]")
