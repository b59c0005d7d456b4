"""The port's fleet KV tier held against the reference's on the CPU.

- The reference's unit cases of ``tests/test_kv_tier.py`` on the port's
  classes: chain digests, the host store, the wire codec, the spill
  worker, the spill pin held across the copy, router affinity, the
  gateway role, the fleet's role fill order and peers file, and the
  fleet report's prefix-cache roll-up.
- ``PagedPrefixIndex``: one sequence of publishes, lookups, evictions and
  admissions through both packages' index gives the same evictions,
  ``on_evict`` calls, ``head_keys`` order and allocator references.
- The paged engine with the host tier, driven tick by tick beside the
  reference's (one tiny GPT's parameters, the index squeezed to one
  block so every chain spills): the same tokens, and the same readmit
  counts, host-store stats, gauges, ``prefix_heads`` and
  ``estimate_cached_tokens``.
- Chains cross between the packages: one engine's ``request_export``
  through ``encode_entries``, the other's ``decode_entries`` and
  ``offer_blocks``, serves the other's prompt to the exporter's tokens,
  both ways. The same chain's K/V rows from both engines agree within
  1e-5 (fp32 sums over one layer in other orders give ~1e-7; a wrong
  row or block gives O(1)); keys, links and tokens are exact.
"""

import json
import threading
import time

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import flags as jflags
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.serving import decode as jdecode
from paddle_tpu.serving import kv_tier as jkv_tier
from paddle_tpu_torch.fluid import flags as tflags
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.observability import registry as obs_registry
from paddle_tpu_torch.serving import decode as tdecode
from paddle_tpu_torch.serving import kv_tier
from paddle_tpu_torch.serving.kv_tier import (
    HostBlockStore, SpillWorker, block_hash, chain_keys,
    decode_entries, encode_entries,
)
from test_torch_cpu_math import pin_vector_math

pin_vector_math(2)  # 2 threads, vector math set up on one (see there)

BLOCK = 8
MAX_LEN = 32
GEOM = {"vocab_size": 50, "hidden_size": 16, "num_layers": 1,
        "num_heads": 2, "intermediate_size": 32}
ROW = [GEOM["num_heads"], BLOCK, GEOM["hidden_size"] // GEOM["num_heads"]]
KV_ATOL = 1e-5
_PREFIXES = ("decode_", "spmd_decode_", "kv_tier_", "sched_")


def _payload(seed, layers=1):
    rs = np.random.RandomState(seed)
    return [(rs.randn(*ROW).astype(np.float32),
             rs.randn(*ROW).astype(np.float32)) for _ in range(layers)]


def _chain(n, seed=0):
    """n linked (key, prev, tokens, payload) blocks."""
    rs = np.random.RandomState(seed)
    out, prev = [], 0
    for i in range(n):
        toks = tuple(int(t) for t in rs.randint(0, 50, BLOCK))
        key = block_hash(prev, toks)
        out.append((key, prev, toks, _payload(100 + i)))
        prev = key
    return out


def _count(name):
    return obs_registry.counter(name).value()


# ---------------------------------------------------------------------------
# chain digests, host store, codec, spill worker (the reference's cases)
# ---------------------------------------------------------------------------
def test_block_hash_and_chain_keys():
    toks = (1, 2, 3, 4, 5, 6, 7, 8)
    k1 = block_hash(0, toks)
    assert k1 == block_hash(0, list(toks))  # container-insensitive
    assert k1 != block_hash(0, toks[:-1] + (9,))
    assert block_hash(k1, toks) != k1  # chained, not positional
    assert k1 == jkv_tier.block_hash(0, toks)  # one digest, both packages
    prompt = list(range(30))
    keys = chain_keys(prompt, BLOCK)
    assert len(keys) == 3  # 30 tokens -> 3 FULL blocks
    assert keys[0] == block_hash(0, tuple(prompt[:8]))
    assert keys[1] == block_hash(keys[0], tuple(prompt[8:16]))
    assert chain_keys(prompt[:7], BLOCK) == []
    assert keys == jkv_tier.chain_keys(prompt, BLOCK)
    assert tdecode._block_hash is kv_tier.block_hash


def test_host_store_round_trip_bit_exact():
    store = HostBlockStore(1 << 20)
    (key, prev, toks, payload), = _chain(1)
    assert store.put(key, prev, toks, payload)
    got = store.get(key, prev, toks)
    assert got is not None
    for (k0, v0), (k1, v1) in zip(payload, got.payload):
        assert np.array_equal(k0, k1) and np.array_equal(v0, v1)
    # chain-verified: the same key under a different claimed link misses
    assert store.get(key, "bogus-prev", toks) is None
    assert store.get(key, prev, toks[:-1] + (99,)) is None
    assert store.get("missing", prev, toks) is None


def test_host_store_lru_cap_and_eviction_counter():
    blocks = _chain(4)
    nbytes = sum(k.nbytes + v.nbytes for k, v in blocks[0][3])
    store = HostBlockStore(3 * nbytes)  # room for exactly 3
    ev0 = _count("kv_tier_host_evictions")
    for key, prev, toks, payload in blocks[:3]:
        assert store.put(key, prev, toks, payload)
    assert len(store) == 3 and store.bytes_used == 3 * nbytes
    # touch the oldest so the SECOND-oldest becomes the LRU victim
    store.get(blocks[0][0], blocks[0][1], blocks[0][2])
    key, prev, toks, payload = blocks[3]
    assert store.put(key, prev, toks, payload)
    assert len(store) == 3
    assert store.get(blocks[1][0], blocks[1][1], blocks[1][2]) is None
    assert store.get(blocks[0][0], blocks[0][1], blocks[0][2]) is not None
    assert _count("kv_tier_host_evictions") - ev0 == 1


def test_host_store_counters_match_traffic():
    blocks = _chain(3, seed=7)
    nbytes = sum(k.nbytes + v.nbytes for k, v in blocks[0][3])
    store = HostBlockStore(1 << 20)
    s0, d0 = _count("kv_tier_spills"), _count("kv_tier_bytes_d2h")
    r0, h0 = _count("kv_tier_readmits"), _count("kv_tier_bytes_h2d")
    for key, prev, toks, payload in blocks[:2]:
        assert store.put(key, prev, toks, payload)
    # idempotent re-put counts nothing
    assert store.put(blocks[0][0], blocks[0][1], blocks[0][2],
                     blocks[0][3])
    # a PULLED block (tally=False) lands without spill accounting
    assert store.put(blocks[2][0], blocks[2][1], blocks[2][2],
                     blocks[2][3], tally=False)
    assert _count("kv_tier_spills") - s0 == 2
    assert _count("kv_tier_bytes_d2h") - d0 == 2 * nbytes
    e = store.get(blocks[0][0], blocks[0][1], blocks[0][2])
    store.note_readmit(e)
    store.note_readmit(e)
    assert _count("kv_tier_readmits") - r0 == 2
    assert _count("kv_tier_bytes_h2d") - h0 == 2 * nbytes
    st = store.stats()
    assert st["host_blocks"] == 3
    assert st["host_bytes"] == 3 * nbytes


def test_host_store_refuses_oversized_block():
    blocks = _chain(1)
    key, prev, toks, payload = blocks[0]
    nbytes = sum(k.nbytes + v.nbytes for k, v in payload)
    store = HostBlockStore(nbytes - 1)
    assert not store.put(key, prev, toks, payload)
    assert len(store) == 0 and store.bytes_used == 0


def test_wire_codec_round_trip_bit_exact_across_packages():
    chain = _chain(3, seed=11)
    blob = encode_entries(chain)
    json.dumps(blob)  # must be JSON-serializable as-is
    assert blob == jkv_tier.encode_entries(chain)
    for back in (decode_entries(blob, ROW),
                 jkv_tier.decode_entries(blob, ROW)):
        assert len(back) == 3
        for (key, prev, toks, payload), (k2, p2, t2, pl2) in zip(chain,
                                                                  back):
            assert k2 == key and p2 == prev and t2 == toks
            for (k0, v0), (k1, v1) in zip(payload, pl2):
                assert np.array_equal(k0, k1) and np.array_equal(v0, v1)


def test_wire_codec_rejects_broken_chain():
    chain = _chain(3, seed=13)
    blob = encode_entries(chain)
    # corrupt the MIDDLE entry's tokens: its digest no longer matches,
    # so decode must keep only the verified prefix (1 block), never the
    # poisoned tail
    blob[1]["tokens"] = [0] * BLOCK
    back = decode_entries(blob, ROW)
    assert len(back) == 1 and back[0][0] == chain[0][0]
    # an empty blob decodes to nothing rather than raising
    assert decode_entries([], ROW) == []


def test_spill_worker_batches_and_survives_errors():
    done = []
    evt = threading.Event()
    calls = []

    def batch(jobs):
        calls.append(list(jobs))
        if len(calls) == 1:
            raise RuntimeError("first batch dies")
        done.extend(jobs)
        evt.set()

    w = SpillWorker(batch)
    try:
        w.submit("a")
        # wait out batch 1 (the failing one), then queue two more
        deadline = time.monotonic() + 5
        while not calls and time.monotonic() < deadline:
            time.sleep(0.01)
        w.submit("b")
        w.submit("c")
        assert evt.wait(5)
        assert done == ["b", "c"]  # batched together, error contained
        assert w.drain(2.0)
        assert w.pending == 0
    finally:
        w.stop()


def test_index_evict_pins_block_until_spill_completes():
    alloc = tdecode.BlockAllocator(8)
    pinned = []

    def on_evict(victim):
        # the engine hook: take the spill pin BEFORE the index decref
        alloc.incref([victim.block_idx])
        pinned.append(victim.block_idx)

    idx = tdecode.PagedPrefixIndex(BLOCK, max_blocks=1, allocator=alloc,
                                   on_evict=on_evict)
    prompt = list(range(BLOCK))
    (blk,) = alloc.alloc(1)
    idx.publish(prompt, [blk])           # index holds its own ref
    alloc.decref([blk])                  # drop the "slot" ref
    assert alloc.refs(blk) == 1          # index is the only holder
    assert idx.evict_one()
    # evicted from the index, but the spill pin keeps it alive: the
    # allocator must NOT re-issue the block while the worker reads it
    assert alloc.refs(blk) == 1
    got = alloc.alloc(6)                 # everything but SINK + the pin
    assert got is not None and blk not in got
    assert alloc.alloc(1) is None        # pool exhausted except the pin
    alloc.decref(got)
    # the loop thread's drain: dropping the pin actually frees it
    assert pinned == [blk]
    alloc.decref([blk])
    got = alloc.alloc(7)                 # SINK stays pinned
    assert got is not None and blk in got


# ---------------------------------------------------------------------------
# PagedPrefixIndex against the reference's, one op sequence
# ---------------------------------------------------------------------------
def test_prefix_index_matches_reference_op_for_op():
    """Publishes of three chains sharing a root, lookups (hits and
    misses), evictions with and without ``need_free``, ``admit`` of new,
    existing and over-budget keys, ``forget``: both indexes log the same
    victims through ``on_evict`` before their decref, hold the same
    allocator references and advertise the same ``head_keys``."""
    rs = np.random.RandomState(17)
    root = [int(t) for t in rs.randint(0, 50, 2 * BLOCK)]
    prompts = [root + [int(t) for t in rs.randint(0, 50, BLOCK + 3)]
               for _ in range(3)]
    toks = tuple(int(t) for t in rs.randint(0, 50, BLOCK))
    key = block_hash(0, toks)
    logs = {}
    states = {}
    for name, mod in (("jax", jdecode), ("torch", tdecode)):
        alloc = mod.BlockAllocator(24)
        log = []

        def hook(victim, alloc=alloc, log=log):
            log.append((victim.key, victim.block_idx,
                        alloc.refs(victim.block_idx)))

        idx = mod.PagedPrefixIndex(BLOCK, max_blocks=4, allocator=alloc,
                                   on_evict=hook)
        trace = []
        slots = []
        for p in prompts:
            blocks = alloc.alloc(-(-len(p) // BLOCK))
            new = idx.publish(p, blocks)
            trace.append(("publish", [e.key for e in new],
                          idx.head_keys(3)))
            slots.append(blocks)
        entries, hit = idx.lookup(prompts[1])
        trace.append(("lookup", [e.key for e in entries], hit))
        trace.append(("miss", idx.lookup([7] * (2 * BLOCK))[1]))
        for blocks in slots[:2]:
            alloc.decref(blocks)  # two slots retire
        trace.append(("evict_free", idx.evict_one(need_free=True),
                      idx.head_keys(8)))
        trace.append(("evict", idx.evict_one(), idx.head_keys(8)))
        (fresh,) = alloc.alloc(1)
        e = idx.admit(key, 0, toks, fresh)
        trace.append(("admit", e is not None, idx.admit(key, 0, toks, 0),
                      idx.head_keys(8)))
        idx.forget(e)
        trace.append(("forget", idx.head_keys(8), len(idx)))
        idx.max_blocks = len(idx)
        (extra,) = alloc.alloc(1)
        trace.append(("admit_full", idx.admit(block_hash(key, toks), key,
                                              toks, extra) is not None,
                      idx.head_keys(2), idx.head_keys(0)))
        logs[name] = log
        states[name] = {"trace": trace,
                        "refs": [alloc.refs(b) for b in range(24)],
                        "stats": idx.stats()}
    assert logs["torch"] == logs["jax"]
    assert len(logs["torch"]) >= 3  # the budget, need_free and admits
    assert states["torch"]["trace"] == states["jax"]["trace"]
    assert states["torch"]["refs"] == states["jax"]["refs"]
    assert states["torch"]["stats"] == states["jax"]["stats"]


# ---------------------------------------------------------------------------
# the engines, both packages, one tiny GPT's parameters
# ---------------------------------------------------------------------------
def _defaults(flags_mod):
    return {"FLAGS_" + k: v for k, v in flags_mod._DEFAULTS.items()
            if k.startswith(_PREFIXES)}


@pytest.fixture(scope="module")
def params():
    cfg = jgpt.GPTConfig.tiny(hidden_dropout=0.0, attention_dropout=0.0,
                              use_flash_attention=True, **GEOM)
    cfg.max_position_embeddings = MAX_LEN
    with jfluid.unique_name.guard():
        infer, startup, _names, _logits = jgpt.build_gpt_infer(cfg, MAX_LEN)
    startup.random_seed = 5
    scope = jfluid.core.Scope()
    with jfluid.executor.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
    tcfg = tgpt.GPTConfig.tiny(use_flash_attention=True,
                               max_position_embeddings=MAX_LEN, **GEOM)
    arrays = {n: np.asarray(scope.get(n))
              for n in tgpt.fluid_param_shapes(tcfg)}
    return {"cfg": cfg, "tcfg": tcfg, "infer": infer, "scope": scope,
            "arrays": arrays}


@pytest.fixture(autouse=True)
def _flags_at_defaults():
    """Both packages' decode and KV-tier knobs at their defaults around
    each test (other modules of this worker set them and leave them)."""
    jsaved = jflags.get_flags(list(_defaults(jflags)))
    jflags.set_flags(_defaults(jflags))
    tflags.set_flags(_defaults(tflags))
    yield
    jflags.set_flags(jsaved)
    tflags.set_flags(_defaults(tflags))


def _knobs(**kw):
    """Paged with block 8 and a 4 MB prefix index."""
    return dict(dict(slots=4, max_len=MAX_LEN, prefill_buckets=[8, MAX_LEN],
                     block_size=BLOCK, prefix_cache_mb=4.0), **kw)


def _port_engine(params, host_mb, loop=True, **kw):
    """The port's engine over ``params`` with ``host_mb`` of host tier."""
    tflags.set_flags({"FLAGS_kv_tier_host_mb": host_mb})
    model = tgpt.GPTLM(params["tcfg"], device="cpu")
    tgpt.load_fluid_params(model, params["arrays"])
    return tdecode.DecodeEngine(model, **_knobs(**kw)).start(loop=loop)


def _engines(params, host_mb, loop=True, **kw):
    """(reference engine, port engine) over the same parameters."""
    jflags.set_flags({"FLAGS_kv_tier_host_mb": host_mb})
    jeng = jdecode.DecodeEngine(params["cfg"], scope=params["scope"],
                                param_program=params["infer"], **_knobs(**kw))
    return jeng.start(loop=loop), _port_engine(params, host_mb, loop, **kw)


def _tick_done(engines, streams):
    """Tick both engines until every stream is done, waiting out each
    tick's spill batch so that both see the same finished spills."""
    for _ in range(200):
        if all(s.done for s in streams):
            return
        for eng in engines:
            eng._tick()
            if eng._spill_worker is not None:
                assert eng._spill_worker.drain(5.0)
    raise AssertionError("streams never finished")


def _assert_index_rows_match(jeng, teng):
    """Every indexed block's K/V rows (readmitted ones among them) equal
    the reference's block under the same chain key, within KV_ATOL."""
    keys = list(teng.pindex._entries)
    assert keys == list(jeng.pindex._entries)
    rows = teng._read_rows([teng.pindex._entries[k].block_idx for k in keys])
    jpools = jeng._pool_arrays()
    for j, key in enumerate(keys):
        jblk = jeng.pindex._entries[key].block_idx
        for li, (jk, jv) in enumerate(jpools):
            np.testing.assert_allclose(rows[li, 0, j], jk[jblk],
                                       atol=KV_ATOL, rtol=0)
            np.testing.assert_allclose(rows[li, 1, j], jv[jblk],
                                       atol=KV_ATOL, rtol=0)


def test_engine_spill_readmit_tick_by_tick_matches_reference(params):
    """Every chain spills (index squeezed to one block) and comes back
    H2D: tokens, readmit counts, host-store stats, gauges, the affinity
    heads and the cached-token estimate equal the reference's after every
    request, and the tokens equal an engine without the tier."""
    jeng, teng = _engines(params, 4.0, loop=False)
    _jo, oracle = _engines(params, 0.0, loop=False)
    try:
        assert teng.host_store is not None and oracle.host_store is None
        jeng.pindex.max_blocks = teng.pindex.max_blocks = 1
        rs = np.random.RandomState(3)
        shared = [int(t) for t in rs.randint(0, 50, 2 * BLOCK + 1)]
        d0 = _count("kv_tier_bytes_d2h")
        for i in range(5):
            prompt = shared + [i] * (1 + i % 2)
            js = jeng.submit(prompt, max_new_tokens=3)
            ts = teng.submit(prompt, max_new_tokens=3)
            os_ = oracle.submit(prompt, max_new_tokens=3)
            _tick_done((jeng, teng, oracle), (js, ts, os_))
            assert ts.tokens() == js.tokens() == os_.tokens(), i
            assert ts.cached_prefix_tokens == js.cached_prefix_tokens
            jst, tst = jeng.stats(), teng.stats()
            assert tst["kv_tier"] == jst["kv_tier"], i
            assert teng._counts["kv_readmits"] == jeng._counts["kv_readmits"]
            assert teng._counts["kv_readmit_tokens"] == \
                jeng._counts["kv_readmit_tokens"]
            assert tst["prefix_store"] == jst["prefix_store"]
            assert tst["paged"] == jst["paged"]
            for g in ("kv_tier_host_blocks", "kv_tier_host_bytes"):
                assert teng._gauges[g]() == getattr(
                    jeng, {"kv_tier_host_blocks": "_host_blocks_gauge",
                           "kv_tier_host_bytes": "_host_bytes_gauge"}[g])()
            assert teng.prefix_heads() == jeng.prefix_heads()
            assert teng.estimate_cached_tokens(prompt) == \
                jeng.estimate_cached_tokens(prompt)
            _assert_index_rows_match(jeng, teng)
        # room again: the next hit readmits the whole chain and keeps it
        # indexed, so its rows written H2D are held to the reference's
        jeng.pindex.max_blocks = teng.pindex.max_blocks = 64
        r0 = teng.stats()["kv_tier"]["readmits"]
        js = jeng.submit(shared + [9], max_new_tokens=3)
        ts = teng.submit(shared + [9], max_new_tokens=3)
        _tick_done((jeng, teng), (js, ts))
        assert ts.tokens() == js.tokens()
        assert teng.stats()["kv_tier"]["readmits"] > r0
        _assert_index_rows_match(jeng, teng)
        st = teng.stats()["kv_tier"]
        assert st["spills"] >= 1 and st["readmits"] >= 2
        assert st["readmit_tokens"] == st["readmits"] * BLOCK
        # the port's D2H bytes are whole block payloads
        block_bytes = tgpt.paged_block_bytes(params["tcfg"], BLOCK)
        assert _count("kv_tier_bytes_d2h") - d0 == st["spills"] * block_bytes
        # the spill pins all came back: only the index and the sink hold
        # blocks once every slot retired
        assert teng.allocator.stats() == jeng.allocator.stats()
    finally:
        for eng in (jeng, teng, _jo, oracle):
            eng.stop()
    # stop() tears the tier's gauges down
    assert not any(g.startswith("kv_tier_") for g in teng._gauges)
    assert teng._spill_worker is None


def test_engine_pool_pressure_waits_for_spills(params):
    """A pool too small for a second prompt while the first one's blocks
    are pinned for spilling: allocation reaps the finished spills and,
    with a batch still in flight (the worker slowed down here), waits for
    it instead of shedding."""
    teng = _port_engine(params, 4.0, loop=False, slots=1, pool_blocks=6)
    worker = teng._spill_worker
    batch_fn, drain = worker._batch_fn, worker.drain
    waits = []

    def slow_batch(jobs):
        time.sleep(0.05)
        batch_fn(jobs)

    def counted_drain(timeout=1.0):
        waits.append(timeout)
        return drain(timeout)

    worker._batch_fn, worker.drain = slow_batch, counted_drain
    try:
        teng.pindex.max_blocks = 1
        rs = np.random.RandomState(8)
        for i in range(3):
            prompt = [int(t) for t in rs.randint(0, 50, 3 * BLOCK + 2)]
            s = teng.submit(prompt, max_new_tokens=2)
            for _ in range(50):
                if s.done:
                    break
                teng._tick()
            assert s.done, i
            assert len(s.tokens()) == 2  # raises if the request failed
        assert teng.stats()["oom_sheds"] == 0
        assert teng.stats()["kv_tier"]["spills"] >= 2
        assert waits  # allocation waited for an in-flight spill batch
    finally:
        teng.stop()


def _export(eng, prefix):
    entries = eng.request_export(prefix, timeout=30.0)
    assert entries is not None
    return entries


def test_chains_cross_between_packages(params):
    """Export -> encode -> decode -> offer, each direction: the cold
    engine serves the prompt to the warm engine's tokens through its
    readmit path, and both packages export the same chain."""
    jwarm, twarm = _engines(params, 4.0)
    jcold, tcold = _engines(params, 4.0)
    try:
        rs = np.random.RandomState(9)
        prefix = [int(t) for t in rs.randint(0, 50, 3 * BLOCK)]
        prompt = prefix + [1, 2]
        jwant = jwarm.generate(prompt, max_new_tokens=4).tokens(timeout=60)
        twant = twarm.generate(prompt, max_new_tokens=4).tokens(timeout=60)
        assert twant == jwant
        jchain = _export(jwarm, prefix)
        tchain = _export(twarm, prefix)
        assert len(jchain) == len(tchain) == 3
        for (k, p, t, pay), (jk, jp, jt, jpay) in zip(tchain, jchain):
            assert (k, p, tuple(t)) == (jk, jp, tuple(jt))
            for (kr, vr), (jkr, jvr) in zip(pay, jpay):
                assert kr.dtype == np.float32 and kr.shape == tuple(ROW)
                np.testing.assert_allclose(kr, np.asarray(jkr),
                                           atol=KV_ATOL, rtol=0)
                np.testing.assert_allclose(vr, np.asarray(jvr),
                                           atol=KV_ATOL, rtol=0)
        # reference -> port
        back = decode_entries(jkv_tier.encode_entries(jchain), ROW)
        assert tcold.offer_blocks(back) == 3
        assert tcold.estimate_cached_tokens(prompt) == 3 * BLOCK
        got = tcold.generate(prompt, max_new_tokens=4).tokens(timeout=60)
        assert got == jwant
        assert tcold.stats()["kv_tier"]["readmits"] == 3
        # port -> reference
        back = jkv_tier.decode_entries(encode_entries(tchain), ROW)
        assert jcold.offer_blocks(back) == 3
        got = jcold.generate(prompt, max_new_tokens=4).tokens(timeout=60)
        assert got == twant
        assert jcold.stats()["kv_tier"]["readmits"] == 3
    finally:
        for eng in (jwarm, twarm, jcold, tcold):
            eng.stop()


def test_export_serves_spilled_blocks_from_the_host(params):
    """A chain evicted from the device index still exports, straight
    from the host tier, with the payloads the pool held."""
    teng = _port_engine(params, 4.0)
    try:
        rs = np.random.RandomState(12)
        prefix = [int(t) for t in rs.randint(0, 50, 2 * BLOCK)]
        teng.generate(prefix + [4], max_new_tokens=2).tokens(timeout=60)
        on_card = _export(teng, prefix)
        teng.pindex.max_blocks = 1
        other = [int(t) for t in rs.randint(0, 50, 2 * BLOCK + 1)]
        teng.generate(other, max_new_tokens=2).tokens(timeout=60)
        assert teng._spill_worker.drain(5.0)
        from_host = _export(teng, prefix)
        assert len(from_host) == 2
        for (k, p, t, pay), (k2, p2, t2, pay2) in zip(on_card, from_host):
            assert (k, p, t) == (k2, p2, t2)
            for (a, b), (c, d) in zip(pay, pay2):
                assert np.array_equal(a, c) and np.array_equal(b, d)
    finally:
        teng.stop()


# ---------------------------------------------------------------------------
# router affinity, gateway role, fleet roles and peers (the reference's)
# ---------------------------------------------------------------------------
def test_router_affinity_scores_stale_and_misses():
    from paddle_tpu_torch.serving.router import Router

    r = Router(port=0)
    r.add_backend(1, "127.0.0.1", 1111, ready=True)
    r.add_backend(2, "127.0.0.1", 2222, ready=True)
    prompt = list(range(5 * BLOCK))
    keys = chain_keys(prompt, BLOCK)
    now = time.monotonic()
    with r._lock:
        b1, b2 = r._backends["1"], r._backends["2"]
        b1.prefix_heads = frozenset([keys[1]])
        b1.advert_block = BLOCK
        b1.advert_t = now
        b2.prefix_heads = frozenset([keys[3]])
        b2.advert_block = BLOCK
        b2.advert_t = now
    # deepest advertised chain head wins: b2 knows 4 blocks, b1 only 2
    pick = r._pick(prompt_ids=prompt)
    assert pick.id == "2" and pick.affinity_score == 4 * BLOCK
    h0 = _count("router_affinity_hits")
    # a stale advert scores zero: the pick falls back to least-inflight
    stale0 = _count("router_affinity_stale")
    with r._lock:
        b2.advert_t = now - 1e4
    pick = r._pick(prompt_ids=prompt)
    assert pick.id == "1"
    assert _count("router_affinity_stale") > stale0
    # no advert anywhere -> miss counter, least-inflight fallback
    m0 = _count("router_affinity_misses")
    with r._lock:
        b1.prefix_heads = frozenset()
        b2.prefix_heads = frozenset()
        b1.inflight = 3
    pick = r._pick(prompt_ids=prompt)
    assert pick.id == "2"
    assert _count("router_affinity_misses") > m0
    assert _count("router_affinity_hits") > h0  # from the first pick
    d = b1.as_dict()
    for key in ("role", "prefix_heads", "prefix_head_sample",
                "advert_block", "advert_age_s", "affinity_score"):
        assert key in d


def test_gateway_rejects_unknown_role():
    from paddle_tpu_torch.serving.gateway import Gateway

    with pytest.raises(ValueError):
        Gateway(object(), port=0, role="prefll")


def test_fleet_role_fill_order_and_peers_file(tmp_path):
    from paddle_tpu_torch.serving.fleet import FleetController, _Replica

    model = tmp_path / "model"
    model.mkdir()
    ctrl = FleetController(
        model_dir=str(model), workdir=str(tmp_path / "work"),
        replicas=3, roles={"prefill": 1, "decode": 2}, autoscale=False,
    )
    with pytest.raises(ValueError):
        FleetController(model_dir=str(model),
                        workdir=str(tmp_path / "w2"),
                        roles={"prefil": 1})

    class _Proc:
        pid = 1234

        def poll(self):
            return None

    def fake(rid, role, state="ready", port=None):
        r = _Replica(rid, 1, str(model), _Proc(), "", "", "", role=role)
        r.state = state
        if port:
            r.endpoint = {"gateway_port": port}
        return r

    with ctrl._lock:
        # empty pool: the prefill slot fills first
        assert ctrl._role_for_next() == "prefill"
        ctrl._replicas[0] = fake(0, "prefill", port=7001)
        assert ctrl._role_for_next() == "decode"
        ctrl._replicas[1] = fake(1, "decode")
        ctrl._replicas[2] = fake(2, "decode")
        # declared counts met: extras stay decode under a role spec
        assert ctrl._role_for_next() == "decode"
        # the prefill replica dying reopens its slot first
        ctrl._replicas[0].state = "exited"
        assert ctrl._role_for_next() == "prefill"
        ctrl._replicas[0].state = "ready"
        assert fake(0, "prefill").info()["role"] == "prefill"
        ctrl._update_peers_locked()
    doc = json.loads(open(ctrl._peers_file).read())
    assert doc["peers"] == [{"id": 0, "host": ctrl.host, "port": 7001}]
    assert kv_tier.read_peers(ctrl._peers_file) == doc["peers"]
    # a roleless controller never steers spawns
    plain = FleetController(model_dir=str(model),
                            workdir=str(tmp_path / "w3"), replicas=2,
                            autoscale=False)
    with plain._lock:
        assert plain._role_for_next() == "mixed"
    assert kv_tier.read_peers(str(tmp_path / "nope.json")) == []


def test_prefix_cache_rollup():
    from paddle_tpu_torch.observability.aggregate import _prefix_cache_rollup

    summaries = {
        "0": {"counters": {
            "decode_prefix_hits": 8, "decode_prefix_misses": 2,
            "decode_prefix_cached_tokens": 160,
            "decode_prompt_tokens": 400,
            "kv_tier_spills": 3, "kv_tier_readmits": 2,
            "kv_tier_bytes_d2h": 3000, "kv_tier_bytes_h2d": 2000,
        }},
        "1": {"counters": {
            "decode_prefix_hits": 2, "decode_prefix_misses": 8,
            "decode_prefix_cached_tokens": 40,
            "decode_prompt_tokens": 100,
        }},
    }
    roll = _prefix_cache_rollup(summaries)
    assert roll["per_replica"]["0"]["hit_rate"] == 0.8
    assert roll["per_replica"]["1"]["hit_rate"] == 0.2
    assert roll["fleet"]["hits"] == 10 and roll["fleet"]["misses"] == 10
    assert roll["fleet"]["hit_rate"] == 0.5
    assert roll["fleet"]["cached_token_fraction"] == 0.4  # 200/500
    assert roll["fleet"]["bytes_d2h"] == 3000
    assert roll["fleet"]["bytes_h2d"] == 2000
    empty = _prefix_cache_rollup({})
    assert empty["fleet"]["hit_rate"] is None
