"""The paged engine with speculative decoding in the port
(``paddle_tpu_torch``) held against the JAX package on the CPU.

One tiny GPT (``GPTConfig.tiny``: 2 layers, hidden 64, 4 heads) served
with MAX_LEN 20, SLOTS 3, block size 4 and speculation width 4, as the
reference's own ``tests/test_decode_paged.py`` serves it. The same
numpy inputs go through the reference and the port:

- the paged KV ops (write, gather, block copy) must agree exactly: they
  move values and do no arithmetic;
- the paged decode attention's plain version must agree with the Pallas
  kernel run in interpret mode within atol 1e-5 (fp32 sums over a few
  dozen terms of magnitude ~1 in different orders give ~1e-6; a wrong
  block or mask gives O(0.1));
- the paged session's logits and pools must agree with the JAX session
  within 1e-4 (two fp32 layers of products summed in different orders);
- the engines must agree token for token with the full-forward oracle,
  with the speculative verify forced through every accept/reject split.
"""

import contextlib
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as fluid
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.serving import decode as jdecode
from paddle_tpu.serving import kv_tier as jkv_tier
from paddle_tpu_torch.fluid import profiler as tprofiler
from paddle_tpu_torch.fluid.ops import nn_ops as tnn
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.serving import decode as tdecode
from paddle_tpu_torch.serving.batcher import ServerOverloadedError
from test_torch_cpu_math import pin_vector_math

# the reference package re-exports the function under the module's name
jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")

pin_vector_math(2)  # 2 threads, vector math set up on one (see there)

MAX_LEN = 20
SLOTS = 3
BLOCK = 4
SPEC_K = 4
CHUNK = 8
LOGIT_ATOL = 1e-4
ATTN_ATOL = 1e-5


@contextlib.contextmanager
def _reference_decode_defaults():
    """Hold the reference's decode and KV-tier knobs at their registered
    defaults while its engines and sessions are built, then restore what
    was set: other test modules set these process-wide and leave them
    set (a leftover host-tier size would arm a spill worker)."""
    from paddle_tpu.fluid import flags as jflags

    names = ["FLAGS_" + k for k in jflags._DEFAULTS
             if k.startswith(("decode_", "spmd_decode_", "kv_tier_"))]
    saved = jflags.get_flags(names)
    jflags.set_flags({n: jflags._DEFAULTS[n[len("FLAGS_"):]] for n in names})
    try:
        yield
    finally:
        jflags.set_flags(saved)


def _prompt(seed, n, vocab):
    return [int(t) for t in np.random.RandomState(seed).randint(0, vocab, n)]


# -- the paged KV ops -------------------------------------------------------


def _run_jax_op(pool0, feeds, build):
    """One reference op through a fluid program over the persistable
    pool ``pp``, as the reference's own op tests run it."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        cache = main.global_block().create_var(
            name="pp", shape=list(pool0.shape), dtype="float32",
            persistable=True)
        data = {n: fluid.layers.data(name=n, shape=list(a.shape[1:]),
                                     dtype=str(a.dtype))
                for n, a in feeds.items()}
        out = build(cache, data)
    scope = fluid.core.Scope()
    scope.set("pp", pool0.copy())
    (got,) = fluid.Executor(fluid.CPUPlace()).run(
        main, feed=feeds, fetch_list=[out], scope=scope)
    return np.array(got)


def test_paged_kv_ops_match_jax_ops_exactly():
    """A permuted table, a block shared by both slots' tables, a window
    that starts mid-block and crosses block boundaries, then a gather
    and a copy-on-write block copy."""
    NB, H, D, S, MB, T = 9, 2, 3, 2, 3, 6
    rs = np.random.RandomState(3)
    pool0 = rs.randn(NB, H, BLOCK, D).astype("float32")
    new = rs.randn(S, H, T, D).astype("float32")
    tables = np.array([[5, 2, 6], [3, 1, 4]], "int64")
    pos = np.array([[2], [0]], "int64")     # slot 0 starts mid-block
    written = _run_jax_op(
        pool0, {"nv": new, "tb": tables, "ps": pos},
        lambda c, d: fluid.layers.kv_cache_write_paged(c, d["nv"], d["tb"],
                                                       d["ps"]))
    pool = torch.from_numpy(pool0.copy())
    t_tab = torch.from_numpy(tables).to(torch.int32)
    out = tnn.kv_cache_write_paged(pool, torch.from_numpy(new), t_tab,
                                   torch.from_numpy(pos))
    assert out is pool  # written in place
    np.testing.assert_array_equal(pool.numpy(), written)
    # the precomputed per-step index writes the same places
    idx = tnn.paged_write_index(t_tab, torch.from_numpy(pos), T, BLOCK)
    again = torch.from_numpy(pool0.copy())
    tnn.kv_cache_write_paged(again, torch.from_numpy(new), t_tab, None,
                             index=idx)
    np.testing.assert_array_equal(again.numpy(), written)

    gtab = np.array([[5, 2, 6], [2, 1, 4]], "int64")   # block 2 shared
    gathered = _run_jax_op(
        written, {"tb": gtab},
        lambda c, d: fluid.layers.kv_cache_gather_paged(c, d["tb"]))
    got = tnn.kv_cache_gather_paged(torch.from_numpy(written),
                                    torch.from_numpy(gtab).to(torch.int32))
    assert got.shape == (S, H, MB * BLOCK, D)
    np.testing.assert_array_equal(got.numpy(), gathered)

    src = np.array([[3, 1]], "int64")
    dst = np.array([[7, 1]], "int64")       # a COW copy and a no-op pair
    copied = _run_jax_op(
        written, {"src": src, "dst": dst},
        lambda c, d: fluid.layers.kv_cache_block_copy(c, d["src"], d["dst"]))
    pool = torch.from_numpy(written.copy())
    assert tnn.kv_cache_block_copy(pool, torch.from_numpy(src),
                                   torch.from_numpy(dst)) is pool
    np.testing.assert_array_equal(pool.numpy(), copied)


# -- the paged decode attention ---------------------------------------------


def test_flash_decode_paged_plain_matches_jax_kernel():
    """The plain version, the kernel wrapper on CPU tensors and the op
    against the Pallas kernel in interpret mode: a permuted table, two
    slots sharing a block, mixed live lengths, and one all-sink slot
    whose keys are all masked (an inactive engine slot)."""
    rs = np.random.RandomState(0)
    B, N, D, MB, NB = 4, 2, 16, 5, 23
    S = MB * BLOCK
    q = rs.randn(B, N, 1, D).astype("float32")
    k_pool = rs.randn(NB, N, BLOCK, D).astype("float32")
    v_pool = rs.randn(NB, N, BLOCK, D).astype("float32")
    tables = (rs.permutation(NB - 1)[:B * MB] + 1).reshape(B, MB) \
        .astype("int32")
    tables[1, 0] = tables[0, 0]
    tables[3] = 0
    kb = np.zeros((B, S), "float32")
    for b, live in enumerate((1, 11, S, 0)):
        kb[b, live:] = -1e4
    want = np.asarray(jfa.flash_decode_paged_attention(
        *(jnp.asarray(a) for a in (q, k_pool, v_pool, tables)),
        key_bias=jnp.asarray(kb), interpret=True))
    tq, tk, tv, tt, tkb = (torch.from_numpy(a)
                           for a in (q, k_pool, v_pool, tables, kb))
    n0 = tfa.flash_decode_paged_attention.launches
    for got in (tfa.flash_decode_paged_attention(tq, tk, tv, tt, key_bias=tkb),
                tfa.flash_decode_paged_attention_plain(tq, tk, tv, tt,
                                                       key_bias=tkb),
                tnn.flash_decode_paged_attention(tq, tk, tv, tt,
                                                 key_bias=tkb)):
        np.testing.assert_allclose(got.numpy(), want, atol=ATTN_ATOL,
                                   rtol=ATTN_ATOL)
    assert tfa.flash_decode_paged_attention.launches == n0
    with pytest.raises(ValueError):        # Sq != 1
        tfa.flash_decode_paged_attention(tq.expand(B, N, 2, D), tk, tv, tt)
    with pytest.raises(ValueError):        # pool heads differ from q's
        tfa.flash_decode_paged_attention(tq, tk[:, :1], tv[:, :1], tt)


# -- host-side bookkeeping ---------------------------------------------------


def test_block_allocator_and_prefix_index_match_reference():
    """The same sequence of calls on the port's and the reference's
    ``BlockAllocator`` / ``PagedPrefixIndex`` gives the same results,
    refcounts and free lists; chain keys are the reference's."""
    assert tdecode._block_hash(0, (1, 2, 3, 4)) == \
        jkv_tier.block_hash(0, (1, 2, 3, 4))

    def drive(mod):
        log = []
        al = mod.BlockAllocator(10)
        ix = mod.PagedPrefixIndex(BLOCK, 3, al)
        p1 = list(range(10))
        log.append(ix.lookup(p1)[1])
        owned = al.alloc(3)
        log.append(al.alloc(8))                       # all or nothing
        log.append([e.block_idx for e in ix.publish(p1, owned)])
        al.decref(owned)
        ent, toks = ix.lookup(p1[:9])
        log.append((toks, [e.block_idx for e in ent]))
        log.append(ix.lookup(p1[:8])[1])               # capped at len - 1
        log.append(ix.evict_one(need_free=True))       # all shared
        al.decref([e.block_idx for e in ent])
        log.append(ix.evict_one(need_free=True))
        b2 = al.alloc(3)
        log.append(len(ix.publish(list(range(100, 112)), b2)))
        log.append((len(ix), ix.evictions, ix.stats(), al.stats()))
        log.append([al.refs(b) for b in range(10)])
        with pytest.raises(ValueError):
            al.incref([0])                              # the sink
        with pytest.raises(ValueError):
            al.decref([9])                              # never allocated
        return log

    assert drive(tdecode) == drive(jdecode)


def test_spec_drafters_match_reference():
    rs = np.random.RandomState(4)
    hists = [[], [7], [5, 1, 2, 3, 9, 1, 2, 3]]
    hists += [list(rs.randint(0, 6, n)) for n in (5, 12, 30)]
    for h in hists:
        for k in (1, 3, 5):
            assert tdecode._ngram_draft(h, k) == jdecode._ngram_draft(h, k)
            assert tdecode._repeat_draft(h, k) == jdecode._repeat_draft(h, k)


def test_engine_rejects_what_the_reference_rejects():
    model = tgpt.GPTLM(tgpt.GPTConfig.tiny(), device="cpu")
    with pytest.raises(ValueError):
        tdecode.DecodeEngine(model, spec_draft="nope", block_size=BLOCK)
    with pytest.raises(ValueError):   # speculation needs the paged pool
        tdecode.DecodeEngine(model, spec_tokens=3)
    with pytest.raises(ValueError):
        tdecode.DecodeEngine(model, block_size=BLOCK, prefill_chunk=-1)
    with pytest.raises(ValueError):   # the contiguous pool's store
        tdecode.DecodeEngine(model, prefix_cache_mb=-1.0)
    with pytest.raises(ValueError):
        tdecode.DecodeSession(model, prefix_block=0)
    with pytest.raises(ValueError):   # no room for the verify's positions
        tdecode.DecodeSession(model, max_len=64, block_size=BLOCK,
                              spec_tokens=SPEC_K)


# -- the rig: one model in both packages, sessions and engines ---------------


@pytest.fixture(scope="module")
def rig():
    cfg = jgpt.GPTConfig.tiny(hidden_dropout=0.0, attention_dropout=0.0,
                              use_flash_attention=True)
    cfg.max_position_embeddings = MAX_LEN + SPEC_K   # the verify's headroom
    with fluid.unique_name.guard():
        infer, startup, _names, logits = jgpt.build_gpt_infer(cfg, MAX_LEN)
    infer.random_seed = startup.random_seed = 17
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.core.Scope()
    with fluid.executor.scope_guard(scope):
        exe.run(startup)
    tcfg = tgpt.GPTConfig.tiny(use_flash_attention=True,
                               max_position_embeddings=MAX_LEN + SPEC_K)
    model = tgpt.GPTLM(tcfg, device="cpu")
    tgpt.load_fluid_params(model, {name: np.asarray(scope.get(name))
                                   for name in tgpt.fluid_param_shapes(tcfg)})
    draft = {"fn": tdecode._ngram_draft}
    knobs = dict(slots=SLOTS, max_len=MAX_LEN, block_size=BLOCK,
                 spec_tokens=SPEC_K, prefill_chunk=CHUNK,
                 prefix_cache_mb=4 * tgpt.paged_block_bytes(tcfg, BLOCK)
                 / 2.0 ** 20,
                 drafter=lambda h, k: draft["fn"](h, k))
    with _reference_decode_defaults():
        jengine = jdecode.DecodeEngine(cfg, scope=scope, param_program=infer,
                                       **knobs).start(loop=False)
    tengine = tdecode.DecodeEngine(model, **knobs).start()
    legacy = tdecode.DecodeEngine(model, slots=2, max_len=MAX_LEN,
                                  prefill_buckets=[8, MAX_LEN]).start()
    yield {"cfg": cfg, "tcfg": tcfg, "model": model, "scope": scope,
           "infer": infer, "exe": exe, "logits": logits, "draft": draft,
           "jengine": jengine, "tengine": tengine, "legacy": legacy}
    tengine.stop()
    legacy.stop()
    jengine.stop()


def _oracle(rig, prompt):
    return tgpt._reference_generate(rig["model"], prompt, MAX_LEN)


def _jax_run(jengine, prompt, **kw):
    s = jengine.submit(prompt, **kw)
    for _ in range(400):
        if s.done:
            break
        jengine._tick()
    return s


def test_paged_session_logits_and_pools_match_jax(rig):
    """Windows (one from 0, one at a block-aligned offset behind a shared
    block, as a prefix hit lays out) then a width-1 step — the Pallas
    paged kernel in interpret mode on the JAX side — and a width-k
    verify, with one slot inactive; logits and every pool agree."""
    icfg = jgpt.GPTConfig.tiny(hidden_dropout=0.0, attention_dropout=0.0,
                               use_flash_attention=True)
    icfg.max_position_embeddings = MAX_LEN + SPEC_K
    icfg.flash_interpret = True
    kw = dict(slots=SLOTS, max_len=MAX_LEN, block_size=BLOCK,
              spec_tokens=SPEC_K, window_cap=CHUNK)
    with _reference_decode_defaults():
        jsess = jdecode.DecodeSession(icfg, scope=fluid.core.Scope(), **kw)
    for name in tgpt.fluid_param_shapes(rig["tcfg"]):
        jsess.scope.set(name, np.asarray(rig["scope"].get(name)))
    tsess = tdecode.DecodeSession(rig["model"], **kw)
    assert tsess.pool_blocks == jsess.pool_blocks
    assert tsess.max_blocks == jsess.max_blocks == 6
    assert tsess.buckets == jsess.buckets == [CHUNK]
    vocab = rig["tcfg"].vocab_size
    pa = _prompt(1, 7, vocab)
    pb = pa[:4] + _prompt(2, 6, vocab)
    ta, tb = [6, 2, 11], [6, 9, 4, 13]          # block 6 shared
    c0 = tprofiler.get_counter("decode_steps")
    tokens = np.zeros((SLOTS, 1), "int64")
    for s, (table, window, offset) in enumerate(((ta, pa, 0),
                                                 (tb, pb[4:], 4))):
        want = jsess.paged_window(table, window, offset)
        got = tsess.paged_window(table, window, offset)
        np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)
        tokens[s, 0] = int(want.argmax())
    tables = [ta, tb, ()]
    active = [True, True, False]
    for width, positions in ((1, [7, 10, 0]), (SPEC_K, [8, 11, 0])):
        toks = np.concatenate(
            [tokens, np.random.RandomState(width).randint(
                0, vocab, (SLOTS, width - 1))], axis=1)
        want = jsess.paged_step(toks, positions, tables, active, width=width)
        got = tsess.paged_step(toks, positions, tables, active, width=width)
        assert got.shape == (SLOTS, width, vocab)
        np.testing.assert_allclose(got[:2], want[:2], atol=LOGIT_ATOL, rtol=0)
        tokens = want[:, -1:, :].argmax(-1)
    assert tprofiler.get_counter("decode_steps") == c0 + 2
    pools = tsess.cache_tensors()
    names = jgpt.paged_pool_names(icfg, jsess.pool_blocks, BLOCK)
    assert sorted(pools) == sorted(n for pair in names for n in pair)
    for name, tensor in pools.items():
        np.testing.assert_allclose(tensor.numpy(),
                                   np.asarray(jsess.scope.get(name)),
                                   atol=LOGIT_ATOL, rtol=0)
    with pytest.raises(ValueError):
        tsess.paged_step(toks, positions, tables, active, width=2)
    with pytest.raises(ValueError):   # the window would pass the table
        tsess.paged_window(ta, pa, MAX_LEN)


def _simulate_spec(prompt, full, max_new, width, drafter):
    """Host mirror of one slot's spec schedule: prefill emits token 0,
    then each tick verifies [pending, drafts] and accepts the longest
    matching prefix. Returns (tokens, drafted, accepted)."""
    out = [full[len(prompt)]]
    drafted = accepted = 0
    while len(out) < max_new:
        win = [out[-1]] + drafter(prompt + out, width - 1)
        emitted = 0
        for j in range(width):
            tok = full[len(prompt) + len(out)]
            emitted += 1
            out.append(tok)
            if len(out) >= max_new:
                break
            if j < width - 1 and tok != win[j + 1]:
                break
        drafted += width - 1
        accepted += max(emitted - 1, 0)
    return out, drafted, accepted


def test_paged_spec_parity_every_split_point(rig):
    """A perfect drafter, and one corrupted at draft index 0, 1 and 2:
    both engines stay token-exact with the oracle at every split, and
    the per-stream drafted/accepted tallies are the host schedule's."""
    engine, jengine = rig["tengine"], rig["jengine"]
    vocab = rig["tcfg"].vocab_size
    p = _prompt(11, 5, vocab)
    full = _oracle(rig, p)
    max_new = 12
    want = full[len(p):len(p) + max_new]

    def forced(corrupt):
        def fn(hist, k):
            d = list(full[len(hist):len(hist) + k])
            d += [0] * (k - len(d))
            if corrupt is not None and corrupt < len(d):
                d[corrupt] = (d[corrupt] + 1) % vocab
            return d
        return fn

    try:
        for corrupt in (None, 0, 1, 2):
            rig["draft"]["fn"] = forced(corrupt)
            sim_toks, sim_d, sim_a = _simulate_spec(p, full, max_new, SPEC_K,
                                                    forced(corrupt))
            assert sim_toks == want
            s = engine.generate(p, max_new_tokens=max_new)
            assert s.tokens(timeout=120) == want, corrupt
            assert (s.spec_drafted, s.spec_accepted) == (sim_d, sim_a), corrupt
            js = _jax_run(jengine, p, max_new_tokens=max_new)
            assert js.tokens(timeout=0) == want, corrupt
            assert (js.spec_drafted, js.spec_accepted) == (sim_d, sim_a)
            if corrupt is None:
                assert s.spec_accepted > 0
            if corrupt == 0:
                assert s.spec_accepted == 0
    finally:
        rig["draft"]["fn"] = tdecode._ngram_draft
    st = engine.stats()
    assert st["spec_drafted"] > 0
    assert 0.0 <= st["spec_acceptance"] <= 1.0


def test_set_spec_width_runtime_toggle(rig):
    """Width 1 runs token-exact and never calls the drafter; width k
    drafts again; unwarmed widths and the contiguous engine refuse."""
    engine = rig["tengine"]
    p = _prompt(7, 6, rig["tcfg"].vocab_size)
    want = _oracle(rig, p)[6:][:8]

    def bomb(hist, k):
        raise AssertionError("drafter called at width 1")

    rig["draft"]["fn"] = bomb
    engine.set_spec_width(1)
    try:
        s = engine.generate(p, max_new_tokens=8)
        assert s.tokens(timeout=120) == want
        assert (s.spec_drafted, s.spec_accepted) == (0, 0)
    finally:
        engine.set_spec_width(SPEC_K)
        rig["draft"]["fn"] = tdecode._ngram_draft
    s2 = engine.generate(p, max_new_tokens=8)
    assert s2.tokens(timeout=120) == want
    assert s2.spec_drafted > 0
    for bad in (0, 2, SPEC_K + 1):
        with pytest.raises(ValueError):
            engine.set_spec_width(bad)
    with pytest.raises(ValueError):
        rig["legacy"].set_spec_width(1)


def test_paged_greedy_parity_and_prefix_hit(rig):
    """Greedy parity across prompt lengths in both engines, then a
    resubmitted 14-token prompt rides the prefix index: 12 cached tokens
    (3 whole blocks of the 13-token cap), token-exact."""
    engine, jengine = rig["tengine"], rig["jengine"]
    vocab = rig["tcfg"].vocab_size
    for n in (1, 3, 9, MAX_LEN - 6):
        p = _prompt(100 + n, n, vocab)
        want = _oracle(rig, p)[n:]
        assert engine.generate(p).tokens(timeout=120) == want, n
        assert _jax_run(jengine, p).tokens(timeout=0) == want, n
    p = _prompt(5, 14, vocab)
    want = _oracle(rig, p)[14:][:4]
    hits0 = engine.stats()["prefix_hits"]
    s1 = engine.generate(p, max_new_tokens=4)
    assert s1.tokens(timeout=120) == want
    assert s1.cached_prefix_tokens == 0
    s2 = engine.generate(p, max_new_tokens=4)
    assert s2.tokens(timeout=120) == want
    assert s2.cached_prefix_tokens == 12
    for _ in range(2):
        js = _jax_run(jengine, p, max_new_tokens=4)
        assert js.tokens(timeout=0) == want
    assert js.cached_prefix_tokens == 12
    st = engine.stats()
    assert st["prefix_hits"] == hits0 + 1
    assert st["paged"]["block_size"] == BLOCK
    assert st["prefix_store"]["cached_blocks"] >= 1


def test_paged_chunked_admission_and_eviction(rig):
    """A 13-token prompt admits as two windows of at most 8; distinct
    prompts churn the 4-block index into evictions; the prompt stays
    token-exact whatever survived."""
    engine = rig["tengine"]
    vocab = rig["tcfg"].vocab_size
    p = _prompt(6, 13, vocab)
    full = _oracle(rig, p)
    s = engine.generate(p, max_new_tokens=5)
    assert s.tokens(timeout=120) == full[13:18]
    assert s.admit_windows == 2
    ev0 = engine.pindex.evictions
    c0 = tprofiler.get_counter("decode_prefix_evictions")
    for seed in (31, 32, 33):
        q = _prompt(seed, 14, vocab)
        engine.generate(q, max_new_tokens=2).tokens(timeout=120)
    assert engine.pindex.evictions > ev0
    assert tprofiler.get_counter("decode_prefix_evictions") > c0
    assert engine.generate(p, max_new_tokens=5).tokens(timeout=120) == \
        full[13:18]
    st = engine.stats()
    assert st["admissions"] == st["retirements"]
    assert st["paged"]["free"] + st["prefix_store"]["cached_blocks"] == \
        engine.session.pool_blocks - 1


def test_paged_sampled_parity_vs_legacy_engine(rig):
    """Seeded sampling through the verify reproduces the contiguous
    engine's stream: each consumed verify row is the sequential row, and
    each emitted token costs one uniform draw."""
    p = [2, 9, 4, 9, 4]
    kw = dict(max_new_tokens=10, temperature=0.8, top_k=32, seed=123)
    want = rig["legacy"].generate(p, **kw).tokens(timeout=120)
    got = rig["tengine"].generate(p, **kw).tokens(timeout=120)
    assert got == want
    assert rig["tengine"].generate(p, **kw).tokens(timeout=120) == want


def test_paged_pool_oom_sheds_not_wedges(rig):
    """A pool for one full-length stream: the first request completes
    token-exact, a concurrent second sheds with ServerOverloadedError,
    and every block returns to the free list."""
    model = rig["model"]
    engine = tdecode.DecodeEngine(
        model, slots=2, max_len=MAX_LEN, block_size=BLOCK,
        pool_blocks=1 + MAX_LEN // BLOCK).start(loop=False)
    try:
        p = [3, 1, 4, 1, 5, 9, 2, 6, 5]   # 3 blocks at admission
        want = _oracle(rig, p)[len(p):]
        c0 = tprofiler.get_counter("decode_paged_oom_sheds")
        s1 = engine.submit(p, max_new_tokens=MAX_LEN - len(p))
        s2 = engine.submit(list(reversed(p)), max_new_tokens=MAX_LEN - len(p))
        while not (s1.done and s2.done):
            engine._tick()
        with pytest.raises(ServerOverloadedError):
            s2.tokens(timeout=0)
        assert s1.tokens(timeout=0) == want
        st = engine.stats()
        assert st["oom_sheds"] >= 1
        assert tprofiler.get_counter("decode_paged_oom_sheds") > c0
        assert st["paged"]["free"] == engine.session.pool_blocks - 1
        s3 = engine.submit(p, max_new_tokens=3)   # the engine still serves
        while not s3.done:
            engine._tick()
        assert s3.tokens(timeout=0) == want[:3]
    finally:
        engine.stop()
