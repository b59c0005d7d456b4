"""The serving slice of the port (``paddle_tpu_torch``: GPTLM,
DecodeSession, DecodeEngine) held against the JAX package on the CPU.

One tiny GPT (``GPTConfig.tiny``, 2 layers, max_len 16) with
``use_flash_attention=True``: the JAX side initializes it through its
startup program, and the scope's parameters carry across with
``load_fluid_params``. Off the TPU the JAX flash ops take their dense
fallback, and the port's kernel wrappers run their plain versions on
CPU tensors. Logits agree within atol 1e-4 (two layers of fp32 products
summed in different orders; a cache or mask error is O(0.1)); greedy
tokens must be equal, and each one is checked teacher-forced against the
reference's full forward.
"""

import contextlib

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as fluid
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.serving import decode as jdecode
from paddle_tpu_torch.fluid import profiler as tprofiler
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.observability import trace as ttrace
from paddle_tpu_torch.serving import decode as tdecode
from test_torch_cpu_math import pin_vector_math

pin_vector_math(2)  # 2 threads, vector math set up on one (see there)

MAX_LEN = 16
SLOTS = 4
BUCKETS = [8, MAX_LEN]
LOGIT_ATOL = 1e-4


@contextlib.contextmanager
def _reference_decode_defaults():
    """Hold the reference's decode knobs at their registered defaults
    while its engine is built, then restore what was set. Other test
    modules set these knobs process-wide and leave them set, and the
    reference session reads them for anything its engine does not pass
    down (a leftover block size would make it a paged engine)."""
    from paddle_tpu.fluid import flags as jflags

    names = ["FLAGS_" + k for k in jflags._DEFAULTS
             if k.startswith(("decode_", "spmd_decode_"))]
    saved = jflags.get_flags(names)
    jflags.set_flags({n: jflags._DEFAULTS[n[len("FLAGS_"):]] for n in names})
    try:
        yield
    finally:
        jflags.set_flags(saved)


@pytest.fixture(scope="module")
def rig():
    cfg = jgpt.GPTConfig.tiny(hidden_dropout=0.0, attention_dropout=0.0,
                              use_flash_attention=True)
    cfg.max_position_embeddings = MAX_LEN
    with fluid.unique_name.guard():
        infer, startup, _names, logits = jgpt.build_gpt_infer(cfg, MAX_LEN)
    infer.random_seed = startup.random_seed = 11
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.core.Scope()
    with fluid.executor.scope_guard(scope):
        exe.run(startup)
    tcfg = tgpt.GPTConfig.tiny(use_flash_attention=True,
                               max_position_embeddings=MAX_LEN)
    arrays = {name: np.asarray(scope.get(name))
              for name in tgpt.fluid_param_shapes(tcfg)}
    model = tgpt.GPTLM(tcfg, device="cpu")
    tgpt.load_fluid_params(model, arrays)
    # the JAX engine is driven tick by tick from the test thread; its
    # session also serves the direct prefill/step comparisons
    with _reference_decode_defaults():
        jengine = jdecode.DecodeEngine(
            cfg, scope=scope, slots=SLOTS, max_len=MAX_LEN,
            prefill_buckets=BUCKETS, param_program=infer).start(loop=False)
    tsess = tdecode.DecodeSession(model, slots=SLOTS, max_len=MAX_LEN,
                                  prefill_buckets=BUCKETS)

    def jax_logits(seq):
        """Reference full-forward logits [len(seq), vocab] (the infer
        program _reference_generate runs)."""
        ids = np.zeros((1, MAX_LEN, 1), "int64")
        ids[0, :len(seq), 0] = seq
        feed = {"ids": ids,
                "pos_ids": np.arange(MAX_LEN).reshape(1, MAX_LEN, 1),
                "input_mask": (np.arange(MAX_LEN) < len(seq))
                .astype("float32").reshape(1, MAX_LEN, 1)}
        (lv,) = exe.run(infer, feed=feed, fetch_list=[logits], scope=scope)
        return np.asarray(lv)[0, :len(seq)]

    def jax_reference(prompt):
        return jgpt._reference_generate(exe, infer, logits, cfg, prompt,
                                        MAX_LEN, scope=scope)

    yield {"cfg": cfg, "tcfg": tcfg, "model": model, "arrays": arrays,
           "jsess": jengine.session, "jengine": jengine, "tsess": tsess,
           "jax_logits": jax_logits, "jax_reference": jax_reference}
    jengine.stop()


def _prompts(seed, lens, vocab):
    rs = np.random.RandomState(seed)
    return [[int(t) for t in rs.randint(0, vocab, n)] for n in lens]


def test_prefill_logits_and_cache_rows_match_jax_per_bucket(rig):
    jsess, tsess = rig["jsess"], rig["tsess"]
    assert tsess.buckets == jsess.buckets == BUCKETS
    jsess.reset_caches()
    tsess.reset_caches()
    names = jgpt.decode_cache_names(rig["cfg"], SLOTS, MAX_LEN)
    assert tgpt.decode_cache_names(rig["tcfg"], SLOTS, MAX_LEN) == names
    c0 = tprofiler.get_counter("decode_prefills")
    ttrace.reset()
    for slot, prompt in zip((0, 3, 1), _prompts(0, (5, 8, 13),
                                                rig["tcfg"].vocab_size)):
        want = jsess.prefill(slot, prompt)
        got = tsess.prefill(slot, prompt)
        np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)
    caches = tsess.cache_tensors()
    assert sorted(caches) == sorted(n for pair in names for n in pair)
    for name, tensor in caches.items():
        np.testing.assert_allclose(tensor.numpy(),
                                   np.asarray(jsess.scope.get(name)),
                                   atol=LOGIT_ATOL, rtol=0)
    assert tprofiler.get_counter("decode_prefills") == c0 + 3
    spans = [s for s in ttrace.get_spans() if s["name"] == "decode_prefill"]
    assert [s["args"]["bucket"] for s in spans] == [8, 8, 16]


def test_decode_step_logits_match_jax_with_mixed_active_slots(rig):
    jsess, tsess = rig["jsess"], rig["tsess"]
    jsess.reset_caches()
    tsess.reset_caches()
    p0, p2 = _prompts(1, (3, 9), rig["tcfg"].vocab_size)
    tok = {}
    for slot, p in ((0, p0), (2, p2)):
        want = jsess.prefill(slot, p)
        np.testing.assert_allclose(tsess.prefill(slot, p), want,
                                   atol=LOGIT_ATOL, rtol=0)
        tok[slot] = int(want.argmax())
    pos = {0: len(p0), 2: len(p2)}
    active = [True, False, True, False]
    c0 = tprofiler.get_counter("decode_steps")
    for _ in range(4):
        tokens = [tok.get(i, 0) for i in range(SLOTS)]
        positions = [pos.get(i, 0) for i in range(SLOTS)]
        want = jsess.decode_step(tokens, positions, active)
        got = tsess.decode_step(tokens, positions, active)
        assert got.shape == (SLOTS, rig["tcfg"].vocab_size)
        np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)
        for i in (0, 2):
            tok[i] = int(want[i].argmax())
            pos[i] += 1
    assert tprofiler.get_counter("decode_steps") == c0 + 4
    assert len(tprofiler.get_histogram("decode_step_ms")) >= 4


def _teacher_forced(rig, prompt, generated):
    """Each generated token is the reference's argmax along the stream's
    own tokens, or within LOGIT_ATOL of it."""
    ref = rig["jax_logits"](prompt + generated[:-1])[len(prompt) - 1:]
    for i, t in enumerate(generated):
        assert ref[i, t] >= ref[i].max() - LOGIT_ATOL, (i, t)


def test_engine_greedy_tokens_match_reference_and_jax_engine(rig):
    """More requests than slots: the port's engine (loop thread) against
    the JAX engine (driven tick by tick) and the reference's full-forward
    oracle on the same prompts, token for token."""
    prompts = _prompts(2, (1, 4, 9, 3, 12, 6), rig["tcfg"].vocab_size)
    jengine = rig["jengine"]
    jstreams = [jengine.submit(p) for p in prompts]
    for _ in range(200):
        if all(s.done for s in jstreams):
            break
        jengine._tick()
    jax_engine = [s.result(timeout=0) for s in jstreams]

    tengine = tdecode.DecodeEngine(rig["model"], slots=SLOTS, max_len=MAX_LEN,
                                   prefill_buckets=BUCKETS).start()
    try:
        tstreams = [tengine.generate(p) for p in prompts]
        port = [s.result(timeout=120) for s in tstreams]
        stats = tengine.stats()
    finally:
        tengine.stop()
    assert stats["admissions"] == stats["retirements"] == len(prompts)
    for p, got, want_engine, s in zip(prompts, port, jax_engine, tstreams):
        assert s.finish_reason == "length"
        _teacher_forced(rig, p, got[len(p):])
        assert got == want_engine
        assert got == rig["jax_reference"](p)
        # the port's own oracle and cached greedy path agree too
        assert tgpt._reference_generate(rig["model"], p, MAX_LEN) == got
        assert tgpt.greedy_generate(rig["model"], p, MAX_LEN) == got


def test_engine_eos_truncation_cancel_and_late_join(rig):
    model = rig["model"]
    prompts = _prompts(3, (2, 5, 3), rig["tcfg"].vocab_size)
    full = [tgpt._reference_generate(model, p, MAX_LEN) for p in prompts]
    engine = tdecode.DecodeEngine(model, slots=2, max_len=MAX_LEN,
                                  prefill_buckets=BUCKETS).start(loop=False)
    try:
        gen0 = full[0][len(prompts[0]):]
        eos = gen0[2]
        s_eos = engine.submit(prompts[0], eos_id=eos)
        s_cut = engine.submit(prompts[1], max_new_tokens=3)
        engine._tick()
        assert s_eos.first_tick == s_cut.first_tick == 0
        s_late = engine.submit(prompts[2])   # queued: both slots busy
        while not (s_eos.done and s_cut.done):
            engine._tick()
        assert s_eos.tokens() == gen0[:gen0.index(eos) + 1]
        assert s_eos.finish_reason == "eos"
        assert s_cut.tokens() == full[1][len(prompts[1]):][:3]
        assert s_cut.finish_reason == "length"
        while s_late.first_tick is None:
            engine._tick()
        s_gone = engine.submit(prompts[0])
        s_gone.cancel()
        engine._tick()
        assert s_gone.finish_reason == "cancelled"
        while not s_late.done:
            engine._tick()
        assert s_late.result() == full[2]
    finally:
        engine.stop()


def test_engine_submit_validation_and_overload(rig):
    from paddle_tpu_torch.serving.batcher import (ServerOverloadedError,
                                                  ServingError)

    engine = tdecode.DecodeEngine(rig["model"], slots=2, max_len=MAX_LEN,
                                  prefill_buckets=BUCKETS,
                                  queue_depth=2).start(loop=False)
    try:
        with pytest.raises(ValueError):
            engine.submit([])
        with pytest.raises(ValueError):
            engine.submit(list(range(MAX_LEN)))
        with pytest.raises(ValueError):
            engine.submit([1], max_new_tokens=0)
        engine.submit([1])
        engine.submit([2])
        with pytest.raises(ServerOverloadedError):
            engine.submit([3])
    finally:
        engine.stop()
    with pytest.raises(ServingError):
        engine.submit([1])


def test_sampling_matches_jax_and_is_seeded():
    rs = np.random.RandomState(9)
    logits = rs.randn(50).astype(np.float32)
    for kw in ({}, {"temperature": 0.7}, {"temperature": 1.3, "top_k": 5},
               {"temperature": 0.9, "top_p": 0.8}):
        a, b = np.random.RandomState(4), np.random.RandomState(4)
        got = [tdecode.sample_token(logits, rng=a, **kw) for _ in range(20)]
        want = [jdecode.sample_token(logits, rng=b, **kw) for _ in range(20)]
        assert got == want
    a, b = np.random.RandomState(4), np.random.RandomState(4)
    for _ in range(3):
        tdecode.sample_token(logits, temperature=1.0, rng=a)
    tdecode.fast_forward_rng(b, 3)
    assert a.random_sample() == b.random_sample()
    assert tdecode.prefill_ladder(48) == jdecode.prefill_ladder(48)
    assert tdecode.prefill_ladder(20, "4,16") == \
        jdecode.prefill_ladder(20, "4,16")


def test_load_fluid_params_checks_names_and_shapes(rig):
    model = tgpt.GPTLM(rig["tcfg"], device="cpu")
    arrays = dict(rig["arrays"])
    tgpt.load_fluid_params(model, arrays)
    w = model.layers[1].att.q.weight.detach().numpy()
    np.testing.assert_array_equal(w, arrays["gpt_1_att_q.w_0"].T)
    missing = dict(arrays)
    del missing["lm_head.b_0"]
    with pytest.raises(KeyError):
        tgpt.load_fluid_params(model, missing)
    with pytest.raises(KeyError):
        tgpt.load_fluid_params(model, dict(arrays, extra=np.zeros(1)))
    bad = dict(arrays, **{"gpt_0_ln1.w_0": np.zeros(3, np.float32)})
    with pytest.raises(ValueError):
        tgpt.load_fluid_params(model, bad)
    init = tgpt.init_fluid_params(rig["tcfg"], seed=0)
    assert {k: v.shape for k, v in init.items()} == \
        tgpt.fluid_param_shapes(rig["tcfg"])
    assert all(v.dtype == np.float32 for v in init.values())


def test_decode_knobs_match_reference_defaults_and_env_bridge(monkeypatch):
    from paddle_tpu.fluid import flags as jflags
    from paddle_tpu_torch.fluid import flags as tflags

    for key, default in tflags._DEFAULTS.items():
        assert jflags._DEFAULTS[key] == default, key
    for key in ("decode_block_size", "decode_spec_tokens",
                "decode_spec_draft", "decode_prefill_chunk",
                "decode_prefix_cache_mb"):
        assert key in tflags._DEFAULTS, key
    want = {}
    for key, default in tflags._DEFAULTS.items():
        if isinstance(default, bool):
            want[key] = not default
        elif isinstance(default, float):
            want[key] = 7.5
        else:
            want[key] = 7 if isinstance(default, int) else "8,16"
        monkeypatch.setenv("FLAGS_" + key, str(want[key]))
    tflags._read_env()
    numbers = [k for k in want if isinstance(want[k], (int, float))
               and not isinstance(want[k], bool)]
    try:
        assert {k: tflags.get_flag(k) for k in want} == want
        version = tflags.version()
        tflags.set_flags({"FLAGS_" + k: "5" for k in numbers})
        assert tflags.version() > version
        assert all(tflags.get_flag(k) == 5 for k in numbers)
        with pytest.raises(ValueError):
            tflags.set_flags({"no_such_knob": 1})
    finally:
        monkeypatch.undo()
        tflags._read_env()
    assert {k: tflags.get_flag(k) for k in want} == tflags._DEFAULTS
