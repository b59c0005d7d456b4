"""The rest of the decode engine in the port (``paddle_tpu_torch``) held
against the JAX package on the CPU: the contiguous pool's prefix store,
chunked and resume prefill, ``resume_tokens``, and the priority/tenant
scheduler with preemption, on both pools.

One tiny GPT (``GPTConfig.tiny``, 2 layers, hidden 64, 4 heads,
``use_flash_attention=True``) with max_len 32: the JAX side initializes
it through its startup program and the scope's parameters carry across
with ``load_fluid_params``. Both engines run prefix blocks of 4 tokens,
a 6-block store and windows of at most 4 tokens, and both are driven
tick by tick (``start(loop=False)``) with the same submissions, so
their schedules match tick for tick.

- ``kv_cache_copy`` and ``kv_cache_gather`` move values and do no
  arithmetic: they must equal the JAX ops exactly, clamped starts
  included; so must ``PrefixCache``'s entries, evictions and stats.
- The resume window's logits agree with the JAX session's within atol
  1e-4 (two layers of fp32 products summed in different orders; a wrong
  offset, slot or mask moves them by O(0.1)), its cache rows and the
  prefix store within the same.
- Greedy tokens must equal the JAX engine's and the full-forward
  oracle's on every path; a seeded sampled stream must replay its
  uninterrupted run.
"""

import contextlib

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as fluid
from paddle_tpu.fluid import flags as jflags
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.observability import registry as jregistry
from paddle_tpu.serving import decode as jdecode
from paddle_tpu_torch.fluid import flags as tflags
from paddle_tpu_torch.fluid import profiler as tprofiler
from paddle_tpu_torch.fluid.ops import nn_ops as tnn
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.observability import registry as tregistry
from paddle_tpu_torch.observability import trace as ttrace
from paddle_tpu_torch.serving import decode as tdecode
from test_torch_cpu_math import pin_vector_math

pin_vector_math(2)  # 2 threads, vector math set up on one (see there)

MAX_LEN = 32
SLOTS = 3
BLOCK = 4          # prefix block (and the paged pool's block)
STORE_BLOCKS = 6
CHUNK = 4
LOGIT_ATOL = 1e-4
_SCHED = ("sched_preempt", "sched_tenant_weights")


@contextlib.contextmanager
def _reference_decode_defaults():
    """Hold the reference's decode, KV-tier and scheduler knobs at their
    registered defaults while its engines are built and driven, then
    restore what was set: other test modules set these process-wide and
    leave them set (a leftover block size makes a paged engine, a
    leftover host-tier size arms a spill worker)."""
    names = ["FLAGS_" + k for k in jflags._DEFAULTS
             if k.startswith(("decode_", "spmd_decode_", "kv_tier_"))
             or k in _SCHED]
    saved = jflags.get_flags(names)
    jflags.set_flags({n: jflags._DEFAULTS[n[len("FLAGS_"):]] for n in names})
    try:
        yield
    finally:
        jflags.set_flags(saved)


@contextlib.contextmanager
def _sched_flags(**values):
    """Set the scheduler knobs on both packages, then restore them."""
    jsaved = {k: jflags.get_flag(k) for k in _SCHED}
    tsaved = {k: tflags.get_flag(k) for k in _SCHED}
    jflags.set_flags(values)
    tflags.set_flags(values)
    try:
        yield
    finally:
        jflags.set_flags(jsaved)
        tflags.set_flags(tsaved)


def _prompt(seed, n, vocab=211):
    return [int(t) for t in np.random.RandomState(seed).randint(0, vocab, n)]


@pytest.fixture(scope="module")
def rig():
    cfg = jgpt.GPTConfig.tiny(hidden_dropout=0.0, attention_dropout=0.0,
                              use_flash_attention=True)
    cfg.max_position_embeddings = MAX_LEN
    with fluid.unique_name.guard():
        infer, startup, _names, logits = jgpt.build_gpt_infer(cfg, MAX_LEN)
    infer.random_seed = startup.random_seed = 23
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.core.Scope()
    with fluid.executor.scope_guard(scope):
        exe.run(startup)
    tcfg = tgpt.GPTConfig.tiny(use_flash_attention=True,
                               max_position_embeddings=MAX_LEN)
    model = tgpt.GPTLM(tcfg, device="cpu")
    tgpt.load_fluid_params(model, {name: np.asarray(scope.get(name))
                                   for name in tgpt.fluid_param_shapes(tcfg)})
    mb = STORE_BLOCKS * tgpt.prefix_block_bytes(tcfg, BLOCK) / 2.0 ** 20
    knobs = dict(slots=SLOTS, max_len=MAX_LEN, prefix_block=BLOCK,
                 prefix_cache_mb=mb, prefill_chunk=CHUNK)
    one = dict(slots=1, max_len=MAX_LEN)
    paged = dict(one, block_size=BLOCK, prefill_chunk=CHUNK)
    with _reference_decode_defaults():
        jengine = jdecode.DecodeEngine(cfg, scope=scope, param_program=infer,
                                       **knobs).start(loop=False)
        jone = {"contiguous": jdecode.DecodeEngine(
                    cfg, scope=scope, param_program=infer,
                    **one).start(loop=False),
                "paged": jdecode.DecodeEngine(
                    cfg, scope=scope, param_program=infer,
                    **paged).start(loop=False)}
    tengine = tdecode.DecodeEngine(model, **knobs).start(loop=False)
    tone = {"contiguous": tdecode.DecodeEngine(model, **one).start(loop=False),
            "paged": tdecode.DecodeEngine(model, **paged).start(loop=False)}
    oracle = {}

    def full(prompt):
        key = tuple(prompt)
        if key not in oracle:
            oracle[key] = tgpt._reference_generate(model, prompt, MAX_LEN)
        return oracle[key]

    yield {"cfg": cfg, "tcfg": tcfg, "model": model, "scope": scope,
           "exe": exe, "infer": infer, "logits": logits, "jengine": jengine,
           "tengine": tengine, "jone": jone, "tone": tone, "full": full}
    for e in [tengine, jengine] + list(tone.values()) + list(jone.values()):
        e.stop()


def _drive(engines, plan, ticks=400):
    """Drive every engine tick by tick through the same ``plan``: a list
    of (tick, prompt, kwargs) submissions, each made at the start of its
    tick. Returns, per engine, the streams in plan order."""
    streams = [[] for _ in engines]
    with _reference_decode_defaults():
        for t in range(ticks):
            for when, prompt, kw in plan:
                if when == t:
                    for e, out in zip(engines, streams):
                        out.append(e.submit(prompt, **kw))
                        out[-1].submit_tick = e.tick
            if t >= max(w for w, _p, _k in plan) and all(
                    s.done for out in streams for s in out):
                return streams
            for e in engines:
                e._tick()
    raise AssertionError("engines did not drain in %d ticks" % ticks)


def _both(rig, plan):
    """The plan through the port's and the JAX engine: their streams
    must agree token for token and in every admission fact."""
    tstreams, jstreams = _drive([rig["tengine"], rig["jengine"]], plan)
    for t, j in zip(tstreams, jstreams):
        assert t.tokens(timeout=0) == j.tokens(timeout=0)
        assert t.finish_reason == j.finish_reason
        assert (t.cached_prefix_tokens, t.admit_windows,
                t.first_tick - t.submit_tick, t.last_tick - t.submit_tick) \
            == (j.cached_prefix_tokens, j.admit_windows,
                j.first_tick - j.submit_tick, j.last_tick - j.submit_tick)
    return tstreams


# -- the ops and the prefix index -----------------------------------------


def _run_jax(feeds, persist, build):
    """One reference op through a fluid program over persistable vars
    ``persist`` ({name: array}), as its own op tests run it."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        blk = main.global_block()
        pv = {n: blk.create_var(name=n, shape=list(a.shape), dtype="float32",
                                persistable=True) for n, a in persist.items()}
        data = {n: fluid.layers.data(name=n, shape=list(a.shape[1:]),
                                     dtype=str(a.dtype))
                for n, a in feeds.items()}
        out = build(pv, data)
    scope = fluid.core.Scope()
    for n, a in persist.items():
        scope.set(n, a.copy())
    (got,) = fluid.Executor(fluid.CPUPlace()).run(
        main, feed=feeds, fetch_list=[out], scope=scope)
    return np.array(got)


_S, _H, _M, _D, _NB = 3, 2, 12, 4, 4
_CACHE = np.arange(_S * _H * _M * _D, dtype="float32").reshape(_S, _H, _M, _D)
_STORE = -np.arange(_NB * _H * BLOCK * _D, dtype="float32").reshape(
    _NB, _H, BLOCK, _D)


@pytest.mark.parametrize("publish,dst,src", [
    (False, (1, 5), (2, 0)),      # store block 2 into slot 1 at 5
    (True, (1, 0), (0, 3)),       # slot 0 at 3 into store block 1
    (False, (2, 10), (3, 0)),     # position 10 clamps to 12 - 4 = 8
    (False, (7, -3), (9, 0)),     # rows clamp to 2 and 3; position -3
                                  # counts from the end (9), clamps to 8
    (True, (-1, 2), (5, -11)),    # row -1 is the last store block, its
                                  # position clamps to 0; row 5 to 2,
                                  # position -11 is 1
])
def test_kv_cache_copy_matches_jax_op_exactly(publish, dst, src):
    dst_arr, src_arr = (_STORE, _CACHE) if publish else (_CACHE, _STORE)
    feeds = {"dl": np.array([dst], "int64"), "sl": np.array([src], "int64")}
    want = _run_jax(feeds, {"dd": dst_arr, "ss": src_arr},
                    lambda p, d: fluid.layers.kv_cache_copy(
                        p["dd"], p["ss"], d["dl"], d["sl"], BLOCK))
    got = torch.from_numpy(dst_arr.copy())
    out = tnn.kv_cache_copy(got, torch.from_numpy(src_arr), feeds["dl"],
                            feeds["sl"], BLOCK)
    assert out is got   # written in place
    np.testing.assert_array_equal(got.numpy(), want)


def test_kv_cache_gather_matches_jax_op_exactly():
    # -1 is the last slot; -4 and -9 count from the end and clamp to 0
    for slot in (0, 2, -1, -4, -9, 9):
        idx = np.array([[slot]], "int64")
        want = _run_jax({"idx": idx}, {"cg": _CACHE},
                        lambda p, d: fluid.layers.kv_cache_gather(
                            p["cg"], d["idx"]))
        got = tnn.kv_cache_gather(torch.from_numpy(_CACHE), idx)
        assert got.shape == (1, _H, _M, _D)
        np.testing.assert_array_equal(got.numpy(), want)


def _cache_script(pc):
    """lookup / publish / release / forget on one PrefixCache, returning
    what each call gave: entries as (key, store block, pins)."""
    def ents(entries):
        return [(e.key, e.block_idx, e.refs) for e in entries]

    def pub(prompt):
        return [(b, e.key, e.block_idx) for e, b in pc.publish(prompt)]

    pa, pb = list(range(10)), list(range(100, 108)) + [1]
    pc_, pd = list(range(200, 213)), list(range(300, 305))
    out = [("miss", pc.lookup(pa))]
    out.append(("publish", pub(pa)))
    hit, toks = pc.lookup(pa[:9])          # capped at 8 of 9, pinned
    out.append(("hit", toks, ents(hit)))
    out.append(("again", pub(pa)))
    out.append(("second", pub(pb)))
    out.append(("evicting", pub(pc_), pc.evictions))
    pinned, toks = pc.lookup(pc_)
    out.append(("pinned", toks, ents(pinned)))
    out.append(("all pinned", pub(pd), pc.evictions))
    pc.release(hit)
    new = pc.publish(pd)
    out.append(("unpinned", [(b, e.block_idx) for e, b in new],
                pc.evictions))
    if new:
        pc.forget(new[-1][0])
    out.append(("forgot", len(pc), pc.stats()))
    again, toks = pc.lookup(pa)
    out.append(("after", toks, ents(again)))
    pc.release(pinned)
    pc.release(again)
    out.append(("pins", [(e.key, e.refs) for e in pc._entries.values()]))
    return out


@pytest.mark.parametrize("collide", [False, True])
def test_prefix_cache_script_matches_reference(monkeypatch, collide):
    """The same calls on both packages' PrefixCache give the same
    entries, pins, evictions and stats; with every chain key colliding
    (``collide``) both verify the stored link and stop there."""
    if collide:
        def fake(prev, toks):
            return "collide"
        monkeypatch.setattr(jdecode, "_block_hash", fake)
        monkeypatch.setattr(tdecode, "_block_hash", fake)
    want = _cache_script(jdecode.PrefixCache(5, BLOCK))
    got = _cache_script(tdecode.PrefixCache(5, BLOCK))
    assert got == want
    if not collide:
        assert tdecode._block_hash(0, (1, 2)) == jdecode._block_hash(0, (1, 2))
    with pytest.raises(ValueError):
        tdecode.PrefixCache(0, BLOCK)


# -- the session -----------------------------------------------------------


def test_resume_prefill_and_prefix_copies_match_jax_session(rig):
    """A monolithic prefill into slot 1, its blocks published, copied
    into slot 0, then resume windows at block-aligned and unaligned
    offsets (and one into slot 2 from 0): logits, every cache row and
    the prefix store agree with the JAX engine's session, whose state is
    saved and put back around the test."""
    jsess = rig["jengine"].session
    tsess = tdecode.DecodeSession(rig["model"], slots=SLOTS, max_len=MAX_LEN,
                                  prefix_blocks=STORE_BLOCKS,
                                  prefix_block=BLOCK)
    assert tsess.buckets == jsess.buckets == [8, 16, 32]
    names = sorted(tsess.cache_tensors())
    want_names = [n for pair in (
        jgpt.decode_cache_names(rig["cfg"], SLOTS, MAX_LEN)
        + jgpt.prefix_store_names(rig["cfg"], STORE_BLOCKS, BLOCK))
        for n in pair]
    assert names == sorted(want_names)
    saved = {n: np.array(jsess.scope.get(n)) for n in names}
    p = _prompt(5, 13)
    c0 = tprofiler.get_counter("decode_prefills")
    ttrace.reset()
    try:
        jsess.reset_caches()
        for sess in (jsess, tsess):
            sess.prefix_publish(0, 0, 0)     # on zeroed caches: a no-op
        np.testing.assert_allclose(tsess.prefill(1, p), jsess.prefill(1, p),
                                   atol=LOGIT_ATOL, rtol=0)
        for sess in (jsess, tsess):
            for b, dst in enumerate((4, 1, 5)):
                sess.prefix_publish(1, b * BLOCK, dst)
            for j, src in enumerate((4, 1)):
                sess.prefix_copy_in(0, j * BLOCK, src)
        for slot, start, stop in ((0, 8, 13), (0, 13, 16), (2, 0, 7),
                                  (2, 7, 9), (1, 13, 24)):
            seq = p + _prompt(start + stop, 24)[13:]
            want = jsess.resume_prefill(slot, seq[start:stop], start)
            got = tsess.resume_prefill(slot, seq[start:stop], start)
            np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)
        for name, tensor in tsess.cache_tensors().items():
            np.testing.assert_allclose(tensor.numpy(),
                                       np.asarray(jsess.scope.get(name)),
                                       atol=LOGIT_ATOL, rtol=0, err_msg=name)
        # the copied-in head of slot 0 is slot 1's prefill, bit for bit
        k0, k1 = tsess.caches[0][0][0], tsess.caches[0][0][1]
        assert torch.equal(k0[:, :8], k1[:, :8])
        with pytest.raises(ValueError):   # bucket 8 past the row's end
            tsess.resume_prefill(0, [1, 2], MAX_LEN - 4)
        with pytest.raises(ValueError):
            tsess.resume_prefill(SLOTS, [1], 0)
        with pytest.raises(RuntimeError):
            tdecode.DecodeSession(rig["model"], slots=1, max_len=MAX_LEN) \
                .resume_prefill(0, [1], 0)
    finally:
        for n, a in saved.items():
            jsess.scope.set(n, a)
    assert tprofiler.get_counter("decode_prefills") == c0 + 6
    spans = [s for s in ttrace.get_spans()
             if s["name"] == "decode_resume_prefill"]
    assert [(s["args"]["bucket"], s["args"]["offset"]) for s in spans] == \
        [(8, 8), (8, 13), (8, 0), (8, 7), (16, 13)]
    assert sum(s["name"] == "decode_prefix_copy"
               for s in ttrace.get_spans()) == 2


def test_masked_step_write_spares_a_prefilling_row(rig):
    """The fused step writes every slot: an inactive slot's write lands
    where the caller aims it, so a row mid-chunked-prefill keeps its
    head."""
    sess = tdecode.DecodeSession(rig["model"], slots=2, max_len=MAX_LEN)
    sess.prefill(1, _prompt(3, 8))
    head = sess.caches[0][0][1, :, :8].clone()
    sess.decode_step([0, 0], [0, 8], [False, False])
    assert torch.equal(sess.caches[0][0][1, :, :8], head)


# -- the engine: every admission path --------------------------------------


_PATHS = {
    # a fresh 9-token prompt: 3 windows of at most 4, no hit
    "miss": [(0, _prompt(11, 9), {"max_new_tokens": 6})],
    # the same 14-token prompt twice: the second copies 12 cached tokens
    "hit": [(0, _prompt(12, 14), {"max_new_tokens": 5}),
            (8, _prompt(12, 14), {"max_new_tokens": 5})],
    # a 20-token prompt admits in 5 windows while a stream decodes
    "chunked": [(0, _prompt(13, 3), {"max_new_tokens": 14}),
                (2, _prompt(14, 20), {"max_new_tokens": 4})],
    # EOS on the first token of a chunked admission, and mid-stream
    "eos": [(0, _prompt(15, 18), {"eos_id": "first"}),
            (0, _prompt(16, 5), {"eos_id": "third"})],
    # max_new_tokens, and the max_len wall; 30 tokens cannot be windowed
    # under the ladder and prefill whole
    "truncation": [(0, _prompt(17, 6), {"max_new_tokens": 3}),
                   (0, _prompt(18, 24), {}),
                   (1, _prompt(19, 30), {})],
    # more requests than slots: rows are reused
    "slot_reuse": [(0, _prompt(20 + i, n), {"max_new_tokens": 4})
                   for i, n in enumerate((7, 2, 12, 5, 16, 9))],
}


@pytest.mark.parametrize("path", sorted(_PATHS))
def test_engine_paths_token_exact(rig, path):
    plan = []
    for when, prompt, kw in _PATHS[path]:
        kw = dict(kw)
        if isinstance(kw.get("eos_id"), str):
            gen = rig["full"](prompt)[len(prompt):]
            kw["eos_id"] = gen[{"first": 0, "third": 2}[kw["eos_id"]]]
        plan.append((when, prompt, kw))
    streams = _both(rig, plan)
    for (_w, prompt, kw), s in zip(plan, streams):
        gen = rig["full"](prompt)[len(prompt):]
        if kw.get("eos_id") is not None:
            gen = gen[:gen.index(kw["eos_id"]) + 1]
        assert s.tokens(timeout=0) == gen[:kw.get("max_new_tokens")]
    if path == "miss":
        assert (streams[0].admit_windows, streams[0].cached_prefix_tokens) \
            == (3, 0)
    if path == "hit":
        assert streams[1].cached_prefix_tokens == 12
        assert streams[1].admit_windows == 1
    if path == "chunked":
        live, long_ = streams
        assert long_.admit_windows == 5
        # one window a tick, the live stream decoding on each of them
        assert long_.first_tick - live.submit_tick == 2 + 4
        assert live.first_tick == live.submit_tick
        assert len(live.tokens()) == 14
    if path == "eos":
        assert [s.finish_reason for s in streams] == ["eos", "eos"]
        assert len(streams[0].tokens()) == 1
    if path == "truncation":
        assert [s.finish_reason for s in streams] == ["length"] * 3
        assert streams[2].admit_windows == 1
    st = rig["tengine"].stats()
    assert st["admissions"] == st["retirements"]
    assert st["prefix_store"]["blocks"] == STORE_BLOCKS


def test_engine_resume_every_split_greedy(rig):
    """Resuming after k emitted tokens, for every k, continues with the
    uninterrupted run's tokens in both engines, through the prefix and
    window path; the resume counters move by the reference's amounts."""
    p = _prompt(30, 7)
    want = rig["full"](p)[len(p):][:10]
    st0 = rig["tengine"].stats()
    r0 = tprofiler.get_counter("decode_resume_admissions")
    plan = [(2 * k, p, {"max_new_tokens": 10, "resume_tokens": want[:k]})
            for k in range(1, len(want))]
    streams = _both(rig, plan)
    for k, s in enumerate(streams, 1):
        assert want[:k] + s.tokens(timeout=0) == want, k
        assert s.emitted_count == len(want)
        assert s.result(timeout=0) == p + want
        assert s.finish_reason == "length"
    st = rig["tengine"].stats()
    assert st["resume_admissions"] - st0["resume_admissions"] == len(want) - 1
    assert st["resume_tokens"] - st0["resume_tokens"] == \
        sum(range(1, len(want)))
    assert tprofiler.get_counter("decode_resume_admissions") - r0 == \
        len(want) - 1
    assert any(s.cached_prefix_tokens for s in streams)


def test_engine_resume_seeded_sampling(rig):
    """A seeded temperature/top-k/top-p generation resumed at every
    split replays its uninterrupted run (the RNG fast-forwarded past the
    replayed picks), in both engines."""
    p = _prompt(31, 4)
    kn = dict(max_new_tokens=8, temperature=1.3, top_k=20, top_p=0.9,
              seed=77)
    (full,) = _both(rig, [(0, p, kn)])
    full = full.tokens(timeout=0)
    assert len(full) == 8
    plan = [(0, p, dict(kn, resume_tokens=full[:k]))
            for k in range(1, len(full))]
    for k, s in enumerate(_both(rig, plan), 1):
        assert full[:k] + s.tokens(timeout=0) == full, k


def test_engine_resume_validation_and_the_max_len_wall(rig):
    """The resume form's refusals, each as the reference refuses it, and
    a resume at the max_len wall: a finished stream with no tokens."""
    for engine in (rig["tengine"], rig["jengine"]):
        with pytest.raises(ValueError, match="seed"):
            engine.submit([1, 2], temperature=1.0, resume_tokens=[3])
        with pytest.raises(ValueError, match="eos"):
            engine.submit([1, 2], eos_id=5, resume_tokens=[3, 5])
        with pytest.raises(ValueError, match="max_new_tokens"):
            engine.submit([1, 2], max_new_tokens=2, resume_tokens=[3, 4])
        with pytest.raises(ValueError, match="room"):
            engine.submit([0] * MAX_LEN)
        q0 = len(engine._pending)
        s = engine.submit([1, 2], resume_tokens=[0] * (MAX_LEN - 2))
        assert s.done and s.tokens(timeout=0) == []
        assert s.finish_reason == "length"
        assert s.emitted_count == MAX_LEN - 2
        assert s.result(timeout=0) == [1, 2] + [0] * (MAX_LEN - 2)
        assert len(engine._pending) == q0   # no slot, no queue entry


# -- the scheduler -----------------------------------------------------------


def test_dequeue_order_matches_reference(rig):
    """Tenants of weight 4, 1 and 2 and both classes: the scheduler's
    pick order equals the reference's, interactive strictly first."""
    order = {}
    with _sched_flags(sched_tenant_weights="heavy:4, mid:2,bad:x"):
        for name, engine in (("port", rig["tengine"]),
                             ("jax", rig["jengine"])):
            streams = []
            for i in range(12):
                tenant = ("heavy", "light", "mid")[i % 3]
                prio = "interactive" if i in (5, 9) else "batch"
                streams.append(engine.submit([1 + i % 5], max_new_tokens=1,
                                             priority=prio, tenant=tenant))
            picked = []
            with engine._cond:
                while engine._pending:
                    s = engine._dequeue_locked()
                    picked.append((streams.index(s), s.tenant, s.priority))
            for s in streams:
                s._finish("cancelled")   # dequeued by hand, never run
            order[name] = picked
    assert order["port"] == order["jax"]
    assert [p for _i, _t, p in order["port"][:2]] == ["interactive"] * 2
    assert [t for _i, t, _p in order["port"][2:6]].count("heavy") >= 2


@pytest.mark.parametrize("pool", ["contiguous", "paged"])
def test_preemption_tick_by_tick_matches_jax(rig, pool):
    """A 1-slot engine: a batch stream runs k tokens, then an
    interactive request evicts it; the interactive stream runs, then the
    batch stream re-admits by re-prefilling its prompt and emitted
    tokens. Both engines agree tick by tick and in every count, and
    both streams equal the oracle. A pending interactive request never
    evicts an interactive stream."""
    tengine, jengine = rig["tone"][pool], rig["jone"][pool]
    bp, ip = _prompt(40, 3), _prompt(41, 2)
    want_b = rig["full"](bp)[len(bp):][:12]
    want_i = rig["full"](ip)[len(ip):][:5]
    for k in (1, 4):
        t0, j0 = tengine.stats(), jengine.stats()
        with _reference_decode_defaults():
            runs = []
            for e in (tengine, jengine):
                base = e.tick
                b = e.submit(bp, max_new_tokens=12, priority="batch",
                             tenant="bulk")
                seen = [base]
                while len(b._tokens) < k:
                    e._tick()
                emitted = len(b._tokens)
                i = e.submit(ip, max_new_tokens=5, tenant="live")
                while not (b.done and i.done):
                    e._tick()
                    seen.append((len(b._tokens), len(i._tokens)))
                seen[0] = i.first_tick - seen[0]
                runs.append((b, i, seen))
        (tb, ti, tseen), (jb, ji, jseen) = runs
        assert tseen == jseen, k
        assert tb.tokens(timeout=0) == jb.tokens(timeout=0) == want_b, k
        assert ti.tokens(timeout=0) == ji.tokens(timeout=0) == want_i, k
        assert tb.preemptions == jb.preemptions == 1
        # the interactive stream ran before the batch one came back
        assert ti.last_tick < tb.last_tick
        t1, j1 = tengine.stats(), jengine.stats()
        for key in ("preemptions", "preempt_replayed_tokens", "admissions",
                    "retirements", "prompt_tokens", "tokens"):
            assert t1[key] - t0[key] == j1[key] - j0[key], (key, k)
        assert t1["preempt_replayed_tokens"] - t0[
            "preempt_replayed_tokens"] == emitted
    # interactive never preempts interactive
    with _reference_decode_defaults():
        s1 = tengine.submit(ip, max_new_tokens=4)
        tengine._tick()
        s2 = tengine.submit(bp, max_new_tokens=2)
        while not (s1.done and s2.done):
            tengine._tick()
    assert s1.preemptions == s2.preemptions == 0
    # with preemption off, the batch stream keeps its slot
    with _sched_flags(sched_preempt=False):
        b = tengine.submit(bp, max_new_tokens=4, priority="batch")
        tengine._tick()
        i = tengine.submit(ip, max_new_tokens=2)
        while not (b.done and i.done):
            tengine._tick()
    assert b.preemptions == 0 and i.first_tick > b.first_tick
    assert b.tokens() == want_b[:4]


def test_seeded_sampling_survives_preemption(rig):
    """A sampled batch stream evicted mid-generation draws exactly what
    its uninterrupted twin draws: the live RNG rides the stream."""
    engine = rig["tone"]["contiguous"]
    bp = _prompt(42, 4)
    kw = dict(max_new_tokens=10, temperature=0.8, seed=1234,
              priority="batch")
    ref = engine.submit(bp, **kw)
    while not ref.done:
        engine._tick()
    b = engine.submit(bp, **kw)
    while len(b._tokens) < 3:
        engine._tick()
    i = engine.submit(_prompt(43, 2), max_new_tokens=3)
    while not (b.done and i.done):
        engine._tick()
    assert b.preemptions == 1
    assert b.tokens() == ref.tokens()


# -- observability -----------------------------------------------------------


def test_gauges_render_under_the_reference_names(rig):
    """Each started engine registers the reference's gauges (paged adds
    the pool's), they render in the Prometheus text with the engine's
    values, and a stopped engine drops its own."""
    started = {"serving_slot_occupancy", "decode_queue_depth",
               "decode_blocks_free", "decode_blocks_shared"}
    assert started <= set(jregistry.gauge_values())
    assert started <= set(tregistry.gauge_values())
    engine = tdecode.DecodeEngine(rig["model"], slots=2, max_len=MAX_LEN - 1,
                                  block_size=BLOCK, spec_tokens=2)
    engine.start(loop=False)
    try:
        engine.submit([1, 2, 3], max_new_tokens=4)
        text = tregistry.render_prometheus()
        parsed = tregistry.parse_prometheus(text)
        assert "# TYPE decode_queue_depth gauge" in text
        assert parsed[("decode_queue_depth", "")] == 1.0
        assert parsed[("decode_blocks_free", "")] == \
            engine.allocator.free_blocks
        assert ("decode_spec_acceptance", "") in parsed
        while engine._pending or engine._active:
            engine._tick()
        text = tregistry.render_prometheus()
        for counter in ("decode_requests", "serving_slot_admissions",
                        "serving_slot_retirements", "decode_tokens"):
            assert "# TYPE %s counter" % counter in text
        assert "# TYPE decode_ttft_ms summary" in text
        assert "# TYPE decode_intertoken_ms summary" in text
    finally:
        engine.stop()
    assert "decode_spec_acceptance" not in tregistry.gauge_values()
    snap = tregistry.snapshot(rank=3)
    assert snap["rank"] == 3 and snap["schema_version"] == \
        jregistry.SCHEMA_VERSION
    assert tregistry.percentiles([1.0, 2.0, 3.0, 4.0]) == \
        jregistry.percentiles([1.0, 2.0, 3.0, 4.0])
