"""The KV-cache serving programs of the port (``paddle_tpu_torch``: the
eight cache and decode ops and layers, the seven ``gpt.build_gpt_*``
serving builders, the program-form ``DecodeSession`` and the
reference-form ``greedy_generate``) held against the JAX package on the
CPU.

One tiny GPT (``GPTConfig.tiny``: 2 layers, hidden 64, 4 heads, vocab
211, dropout 0) with weights from ``init_fluid_params(cfg, 0)``. Both
packages build their programs under a fresh ``unique_name.guard()`` and
run them through their own Executor on the same numpy feeds and state;
the reference's Pallas decode kernels run in interpret mode
(``flash_interpret``). Tolerances:

- ops that only move values (writes, copies, gathers, block copies)
  must agree exactly;
- the decode attention ops within atol 1e-5 (fp32 sums of a few dozen
  terms of magnitude ~1 in another order give ~1e-7; a wrong row,
  block or mask gives O(0.1));
- program logits and every cache row, prefix-store block and pool block
  a program writes within atol 1e-5 (two fp32 layers of products summed
  in another order: observed ~2e-7);
- generation token for token.
"""

import collections
import contextlib

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import flags as jflags
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.serving import decode as jdecode
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import flags as tflags
from paddle_tpu_torch.fluid import profiler as tprofiler
from paddle_tpu_torch.fluid.ops import registry as tregistry
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.serving import decode as tdecode
from test_torch_cpu_math import pin_vector_math

pin_vector_math(2)  # 2 threads, vector math set up on one (see there)

MAX_LEN = 24
SLOTS = 3
BLOCK = 4
SPEC_K = 4
T = 8
STORE_BLOCKS = 4
ATOL = 1e-5

CACHE_OPS = ("flash_decode_attention", "flash_decode_paged_attention",
             "kv_cache_write", "kv_cache_copy", "kv_cache_gather",
             "kv_cache_write_paged", "kv_cache_gather_paged",
             "kv_cache_block_copy")


@contextlib.contextmanager
def _decode_defaults():
    """Hold both packages' decode knobs at their registered defaults
    while sessions are built (other test modules set some process-wide
    and leave them set), then restore what was set."""
    saved = []
    for fl in (jflags, tflags):
        names = ["FLAGS_" + k for k in fl._DEFAULTS
                 if k.startswith(("decode_", "kv_tier_"))]
        saved.append((fl, fl.get_flags(names)))
        fl.set_flags({n: fl._DEFAULTS[n[len("FLAGS_"):]] for n in names})
    try:
        yield
    finally:
        for fl, values in saved:
            fl.set_flags(values)


def _cfg(mod, flash=True, interpret=True):
    cfg = mod.GPTConfig.tiny(use_flash_attention=flash,
                             max_position_embeddings=MAX_LEN + SPEC_K - 1,
                             hidden_dropout=0.0, attention_dropout=0.0)
    if mod is jgpt and interpret:
        cfg.flash_interpret = True
    return cfg


@pytest.fixture(scope="module")
def params():
    return tgpt.init_fluid_params(_cfg(tgpt), 0)


def _ops(program):
    return collections.Counter(op.type for op in program.global_block().ops)


def _port_tensor(arr):
    return torch.from_numpy(np.array(arr, copy=True))


def _run(fl, main, fetch, feed, state):
    """Run ``main`` once in package ``fl`` over a fresh scope holding
    ``state`` ({name: array}); returns (fetched array, {name: array} of
    the state after the run)."""
    port = fl is tfluid
    scope = tfluid.Scope() if port else jfluid.core.Scope()
    for n, a in state.items():
        scope.set(n, _port_tensor(a) if port else np.array(a, copy=True))
    (got,) = fl.Executor(fl.CPUPlace()).run(main, feed=feed,
                                            fetch_list=[fetch], scope=scope)
    after = {n: (scope.get(n).numpy() if port else np.asarray(scope.get(n)))
             for n in state}
    return np.asarray(got), after


def _close(got, want, atol, what):
    err = float(np.abs(np.asarray(got, np.float64)
                       - np.asarray(want, np.float64)).max())
    assert err <= atol, "%s: max abs err %.3g > %g" % (what, err, atol)


# -- the eight ops ----------------------------------------------------------

_H, _D, _NB = 4, 16, 9


def _op_case(name):
    """(feeds, persistable state, build(fl, vars) -> fetched var, atol)
    for one op, made with numpy from a seed."""
    rs = np.random.RandomState(CACHE_OPS.index(name) if name in CACHE_OPS
                               else 11)
    cache = rs.randn(SLOTS, _H, MAX_LEN, _D).astype("float32")
    pool = rs.randn(_NB, _H, BLOCK, _D).astype("float32")
    store = rs.randn(STORE_BLOCKS, _H, BLOCK, _D).astype("float32")
    lens = np.array([5, 0, 17])
    key_bias = np.where(np.arange(MAX_LEN)[None] <= lens[:, None], 0.0,
                        -1e4).astype("float32")
    tables = np.array([[3, 5, 6, 1, 0, 0], [0] * 6, [7, 8, 2, 4, 6, 0]],
                      "int64")
    q = rs.randn(SLOTS, _H, 1, _D).astype("float32")
    if name == "flash_decode_attention":
        feeds = {"q": q, "k": cache, "v": cache[::-1].copy(),
                 "kb": key_bias}
        return feeds, {}, lambda fl, v: fl.layers.flash_decode_attention(
            v["q"], v["k"], v["v"], key_bias=v["kb"], interpret=True), ATOL
    if name == "flash_decode_paged_attention":
        feeds = {"q": q, "tables": tables, "kb": key_bias}
        state = {"pk": pool, "pv": pool[::-1].copy()}
        return feeds, state, lambda fl, v: \
            fl.layers.flash_decode_paged_attention(
                v["q"], v["pk"], v["pv"], v["tables"], key_bias=v["kb"],
                interpret=True), ATOL
    if name == "kv_cache_write":
        feeds = {"new": rs.randn(SLOTS, _H, 1, _D).astype("float32"),
                 "pos": np.array([[[4]], [[0]], [[23]]], "int64")}
        return feeds, {"cache": cache}, lambda fl, v: \
            fl.layers.kv_cache_write(v["cache"], v["new"], v["pos"]), 0.0
    if name in ("kv_cache_write[slot]", "kv_cache_write[slot_offset]"):
        loc = [[2]] if name == "kv_cache_write[slot]" else [[1, 9]]
        feeds = {"new": rs.randn(1, _H, 5, _D).astype("float32"),
                 "pos": np.array(loc, "int64")}
        return feeds, {"cache": cache}, lambda fl, v: \
            fl.layers.kv_cache_write(v["cache"], v["new"], v["pos"],
                                     slot_mode=True), 0.0
    if name == "kv_cache_copy":
        feeds = {"dst_loc": np.array([[2, 12]], "int64"),
                 "src_loc": np.array([[3, 0]], "int64")}
        return feeds, {"cache": cache, "store": store}, lambda fl, v: \
            fl.layers.kv_cache_copy(v["cache"], v["store"], v["dst_loc"],
                                    v["src_loc"], BLOCK), 0.0
    if name == "kv_cache_gather":
        feeds = {"slot": np.array([[1]], "int64")}
        return feeds, {"cache": cache}, lambda fl, v: \
            fl.layers.kv_cache_gather(v["cache"], v["slot"]), 0.0
    if name == "kv_cache_write_paged":
        feeds = {"new": rs.randn(SLOTS, _H, 3, _D).astype("float32"),
                 "tables": tables, "pos": np.array([6, 0, 10], "int64")}
        return feeds, {"pool": pool}, lambda fl, v: \
            fl.layers.kv_cache_write_paged(v["pool"], v["new"], v["tables"],
                                           v["pos"]), 0.0
    if name == "kv_cache_gather_paged":
        return {"tables": tables}, {"pool": pool}, lambda fl, v: \
            fl.layers.kv_cache_gather_paged(v["pool"], v["tables"]), 0.0
    assert name == "kv_cache_block_copy"
    feeds = {"src": np.array([[3, 5]], "int64"),
             "dst": np.array([[7, 8]], "int64")}
    return feeds, {"pool": pool}, lambda fl, v: \
        fl.layers.kv_cache_block_copy(v["pool"], v["src"], v["dst"]), 0.0


def _one_op_program(fl, feeds, state, build):
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        blk = main.global_block()
        v = {n: fl.layers.data(name=n, shape=list(a.shape), dtype=str(a.dtype),
                               append_batch_size=False)
             for n, a in feeds.items()}
        v.update({n: blk.create_var(name=n, shape=list(a.shape),
                                    dtype="float32", persistable=True)
                  for n, a in state.items()})
        out = build(fl, v)
    return main, out


def test_cache_ops_are_registered_and_exported():
    """The eight reference ops are registered with no grad (inference
    only, as in the reference) and ``fluid.layers`` exports the eight
    layers under the reference's names."""
    for name in CACHE_OPS:
        d = tregistry.get_op_def(name)
        assert d is not None and d.lower is not None, name
        assert d.grad_maker is None, name
        assert name in tfluid.layers.nn.__all__, name
        assert callable(getattr(tfluid.layers, name)), name
        assert hasattr(jfluid.layers, name), name


@pytest.mark.parametrize("name", [
    "flash_decode_attention", "flash_decode_paged_attention",
    "kv_cache_write", "kv_cache_write[slot]", "kv_cache_write[slot_offset]",
    "kv_cache_copy", "kv_cache_gather", "kv_cache_write_paged",
    "kv_cache_gather_paged", "kv_cache_block_copy"])
def test_cache_op_matches_reference_op(name):
    """Each op in a one-op program of each package on the same inputs:
    the output and every persistable it writes, exactly for the ops
    that move values, within 1e-5 for the decode attention ops (the
    reference's Pallas kernels in interpret mode). The write ops write
    the scope's tensor in place: the port's output is its input var."""
    feeds, state, build, atol = _op_case(name)
    jmain, jout = _one_op_program(jfluid, feeds, state, build)
    tmain, tout = _one_op_program(tfluid, feeds, state, build)
    assert _ops(tmain) == _ops(jmain)
    want, jstate = _run(jfluid, jmain, jout, feeds, state)
    got, tstate = _run(tfluid, tmain, tout, feeds, state)
    assert got.shape == want.shape
    _close(got, want, atol, name)
    for n in state:
        _close(tstate[n], jstate[n], atol, "%s: %s" % (name, n))


def test_lowering_reads_fed_locations_on_the_host_once_a_run():
    """``LowerCtx.host_ints`` reads a fed location from the host array
    it came from (a device tensor is never read back), and ``memo``
    keeps one result while its source tensors stay the same objects."""
    t = torch.tensor([[7, 3]])
    op = tregistry._FakeOp("kv_cache_gather", {"Pos": ["loc"]}, {}, {})
    ctx = tregistry.LowerCtx(env={"loc": t},
                             host_feeds={"loc": (t, np.array([[2, 5]]))})
    assert ctx.host_ints(op, "Pos") == [2, 5]
    ctx.set("loc", torch.tensor([[4, 1]]))      # an op wrote it: read it
    assert ctx.host_ints(op, "Pos") == [4, 1]
    calls = []
    src = torch.zeros(2)
    for _ in range(3):
        ctx.memo("k", (src,), lambda: calls.append(1) or len(calls))
    assert calls == [1]
    assert ctx.memo("k", (torch.zeros(2),), lambda: 9) == 9


# -- the seven builders -----------------------------------------------------


def _bias(offset, rows, cols):
    allow = np.arange(cols)[None, :] <= (offset + np.arange(rows))[:, None]
    return np.where(allow, 0.0, -1e4).astype("float32")[None]


def _window(rs, P, offset, cols):
    ids = np.zeros((1, T, 1), "int64")
    ids[0, :P, 0] = rs.randint(0, 211, P)
    last = np.zeros((1, T, 1), "float32")
    last[0, P - 1, 0] = 1.0
    return {"ids": ids,
            "pos_ids": (offset + np.arange(T)).reshape(1, T, 1)
            .astype("int64"),
            "resume_bias": _bias(offset, T, cols), "last_onehot": last}


_MAX_BLOCKS = -(-(MAX_LEN + SPEC_K - 1) // BLOCK)
_POOL = SLOTS * _MAX_BLOCKS + 1
_SPAN = _MAX_BLOCKS * BLOCK


def _builder_case(name, rs):
    """(args for the builder after cfg, feeds) of one builder case."""
    tables = np.array([[3, 5, 6, 1, 0, 0, 0], [0] * 7, [7, 8, 2, 4, 9, 0, 0]],
                      "int64")
    if name == "prefill":
        feed = _window(rs, 5, 0, MAX_LEN)
        del feed["resume_bias"]
        feed["input_mask"] = (np.arange(T) < 5).astype("float32") \
            .reshape(1, T, 1)
        feed["slot_idx"] = np.array([[1]], "int64")
        return (SLOTS, T, MAX_LEN), feed
    if name == "resume_prefill":
        feed = _window(rs, 6, 9, MAX_LEN)
        feed["slot_off"] = np.array([[2, 9]], "int64")
        return (SLOTS, T, MAX_LEN), feed
    if name.startswith("prefix_copy"):
        publish = name.endswith("publish")
        feed = {"dst_loc": np.array([[3, 0] if publish else [1, 8]], "int64"),
                "src_loc": np.array([[2, 12] if publish else [2, 0]],
                                    "int64")}
        return (SLOTS, MAX_LEN, STORE_BLOCKS, BLOCK, publish), feed
    if name.startswith("decode_step"):
        pos = np.array([6, 0, 17], "int64")
        act = np.array([True, False, True])
        return (SLOTS, MAX_LEN), {
            "step_ids": rs.randint(0, 211, (SLOTS, 1, 1)).astype("int64"),
            "step_pos": pos.reshape(SLOTS, 1, 1),
            "key_bias": ((np.arange(MAX_LEN)[None] > pos[:, None])
                         | ~act[:, None]).astype("float32") * -1e4}
    if name == "paged_window":
        feed = _window(rs, 7, 5, _SPAN)
        feed["table"] = tables[2:3]
        feed["window_pos"] = np.array([[5]], "int64")
        return (_POOL, BLOCK, _MAX_BLOCKS, T), feed
    if name.startswith("paged_step"):
        w = SPEC_K if "verify" in name else 1
        pos = np.array([13, 0, 9], "int64")
        act = np.array([True, False, True])
        qpos = pos[:, None] + np.arange(w)[None]
        return (SLOTS, _POOL, BLOCK, _MAX_BLOCKS, w), {
            "step_ids": rs.randint(0, 211, (SLOTS, w, 1)).astype("int64"),
            "step_pos": qpos.reshape(SLOTS, w, 1).astype("int64"),
            "tables": tables,
            "step_bias": ((np.arange(_SPAN)[None, None] > qpos[:, :, None])
                          | ~act[:, None, None]).astype("float32") * -1e4}
    assert name == "paged_block_copy"
    return (_POOL, BLOCK, 1), {"src": np.array([[5]], "int64"),
                               "dst": np.array([[9]], "int64")}


def _builder_state(cfg, name, rs, params):
    """Random caches, stores or pools of the builder's geometry beside
    the model's parameters."""
    state = dict(params)
    if name.startswith("paged"):
        groups = [(tgpt.paged_pool_names(cfg, _POOL, BLOCK),
                   tgpt.paged_pool_shape(cfg, _POOL, BLOCK))]
    else:
        groups = [(tgpt.decode_cache_names(cfg, SLOTS, MAX_LEN),
                   tgpt.decode_cache_shape(cfg, SLOTS, MAX_LEN))]
        if name.startswith("prefix_copy"):
            groups.append((tgpt.prefix_store_names(cfg, STORE_BLOCKS, BLOCK),
                           tgpt.prefix_store_shape(cfg, STORE_BLOCKS,
                                                   BLOCK)))
    for names, shape in groups:
        for pair in names:
            for n in pair:
                state[n] = rs.randn(*shape).astype("float32")
    return state


_BUILDERS = {
    "prefill": "build_gpt_prefill",
    "resume_prefill": "build_gpt_resume_prefill",
    "prefix_copy": "build_gpt_prefix_copy",
    "prefix_copy_publish": "build_gpt_prefix_copy",
    "decode_step": "build_gpt_decode_step",
    "decode_step_dense": "build_gpt_decode_step",
    "paged_window": "build_gpt_paged_window",
    "paged_step": "build_gpt_paged_step",
    "paged_step_dense": "build_gpt_paged_step",
    "paged_step_verify": "build_gpt_paged_step",
    "paged_block_copy": "build_gpt_paged_block_copy",
}


@pytest.mark.parametrize("name", sorted(_BUILDERS))
def test_builder_program_matches_reference(name, params):
    """Each builder's program (``_dense``: ``use_flash_attention`` off,
    the dense decode attention) against the reference's on the same
    parameters, random caches / stores / pools and feeds: the same op
    types and feed names, the fetch within 1e-5, and every cache row,
    prefix-store block and pool block within 1e-5."""
    flash = not name.endswith("_dense")
    rs = np.random.RandomState(sorted(_BUILDERS).index(name))
    args, feed = _builder_case(name, rs)
    state = _builder_state(_cfg(tgpt), name, rs, params)
    kw = {"step_w": args[-1]} if name.startswith("paged_step") else {}
    if name.startswith("paged_step"):
        args = args[:-1]
    if name.startswith("prefix_copy"):
        kw, args = {"publish": args[-1]}, args[:-1]
    built = []
    for fl, mod in ((jfluid, jgpt), (tfluid, tgpt)):
        with fl.unique_name.guard():
            main, _startup, feeds, fetch = getattr(mod, _BUILDERS[name])(
                _cfg(mod, flash), *args, **kw)
        built.append((main, feeds, fetch))
    (jmain, jfeeds, jfetch), (tmain, tfeeds, tfetch) = built
    assert tfeeds == jfeeds and sorted(feed) == sorted(tfeeds)
    assert _ops(tmain) == _ops(jmain)
    if name in ("decode_step", "paged_step"):
        kernel_op = {"decode_step": "flash_decode_attention",
                     "paged_step": "flash_decode_paged_attention"}[name]
        assert _ops(tmain)[kernel_op] == 2      # one a layer
    assert getattr(tmain, "_donate_mutable", False)
    want, jstate = _run(jfluid, jmain, jfetch, feed, state)
    got, tstate = _run(tfluid, tmain, tfetch, feed, state)
    assert got.shape == want.shape
    _close(got, want, ATOL, name)
    for n in state:
        _close(tstate[n], jstate[n], ATOL, "%s: %s" % (name, n))


# -- the program-form session and greedy_generate ---------------------------


def _sessions(params, **kw):
    with _decode_defaults():
        jsess = jdecode.DecodeSession(_cfg(jgpt), scope=jfluid.core.Scope(),
                                      **kw)
        tsess = tdecode.DecodeSession(_cfg(tgpt), place=tfluid.CPUPlace(),
                                      scope=tfluid.Scope(), **kw)
    for n, a in params.items():
        jsess.scope.set(n, np.array(a, copy=True))
        tsess.scope.set(n, _port_tensor(a))
    return jsess, tsess


def _check_state(jsess, tsess, what):
    for n, t in tsess.cache_tensors().items():
        _close(t.numpy(), np.asarray(jsess.scope.get(n)), ATOL,
               "%s: %s" % (what, n))


@pytest.mark.parametrize("pool", ["contiguous", "paged"])
def test_program_session_tick_by_tick_matches_reference(params, pool):
    """The program-form ``DecodeSession(cfg, place, scope, ...)`` against
    the reference's ``DecodeSession`` built the same way, driven call by
    call on the same inputs. Contiguous (a prefix store of 4 blocks and
    resume windows): prefills, a publish, a copy-in, a resume window,
    three decode steps with one slot inactive. Paged (block 4, width 4):
    windows through a table (one behind a shared block), width-1 steps,
    a width-4 verify, a block copy. Logits within 1e-5 after every call,
    every cache, store and pool within 1e-5 at the end; the scope's
    tensors are written in place (same storage before and after)."""
    if pool == "contiguous":
        kw = dict(slots=SLOTS, max_len=MAX_LEN, prefill_buckets=[8, 16],
                  prefix_blocks=STORE_BLOCKS, prefix_block=BLOCK,
                  build_resume=True, block_size=0, spec_tokens=0)
    else:
        kw = dict(slots=SLOTS, max_len=MAX_LEN, prefill_buckets=[8],
                  block_size=BLOCK, spec_tokens=SPEC_K, window_cap=T)
    jsess, tsess = _sessions(params, **kw)
    assert isinstance(tsess, tdecode.ProgramDecodeSession)
    assert isinstance(tsess, tdecode.DecodeSession)
    assert tsess.buckets == jsess.buckets
    ptrs = {n: t.data_ptr() for n, t in tsess.cache_tensors().items()}
    rs = np.random.RandomState(3)
    c0 = tprofiler.get_counter("decode_steps")
    calls = []
    if pool == "contiguous":
        p = [int(x) for x in rs.randint(0, 211, 11)]
        calls += [("prefill", 0, p), ("prefill", 1, p[:5])]
        calls += [("prefix_publish", 0, 4, 2), ("prefix_copy_in", 2, 0, 2),
                  ("resume_prefill", 2, p[4:10], 4)]
        for t in range(3):
            calls.append(("decode_step",
                          [int(x) for x in rs.randint(0, 211, SLOTS)],
                          [11 + t, 5 + t, 10 + t], [True, t != 1, True]))
    else:
        p = [int(x) for x in rs.randint(0, 211, 12)]
        tables = [[3, 5, 6], [3, 9], [7, 8, 2, 4]]
        calls += [("paged_window", tables[0], p[:8], 0),
                  ("paged_window", tables[0], p[8:], 8),
                  ("paged_window", tables[1], p[4:8], 4)]
        for t in range(2):
            calls.append(("paged_step", rs.randint(0, 211, (SLOTS, 1)),
                          [12 + t, 8 + t, 0], tables, [True, True, False]))
        calls.append(("paged_step", rs.randint(0, 211, (SLOTS, SPEC_K)),
                      [14, 10, 0], tables, [True, True, False], SPEC_K))
        calls.append(("block_copy", [5], [10]))
    for call in calls:
        want = getattr(jsess, call[0])(*call[1:])
        got = getattr(tsess, call[0])(*call[1:])
        if want is not None:
            assert got.shape == np.asarray(want).shape, call[0]
            _close(got, want, ATOL, call[0])
    _check_state(jsess, tsess, pool)
    assert {n: t.data_ptr() for n, t in tsess.cache_tensors().items()} \
        == ptrs
    steps = sum(c[0] in ("decode_step", "paged_step") for c in calls)
    assert tprofiler.get_counter("decode_steps") - c0 == steps
    assert tsess.steps == steps


def test_reference_form_greedy_generate_matches_reference(params):
    """``greedy_generate(exe, infer_prog, logits, cfg, prompt, max_len,
    scope=...)`` against the reference's, token for token on fixed
    prompts, and against the eager form on a ``GPTLM`` with the same
    weights. The inference program is the second built under one guard,
    so its parameters say ``.w_1`` and the session binds them to the
    canonical ``.w_0`` (the scope's tensors, no copy)."""
    runs = []
    for fl, mod in ((jfluid, jgpt), (tfluid, tgpt)):
        cfg = _cfg(mod)
        with fl.unique_name.guard():
            mod.build_gpt_infer(cfg, MAX_LEN)
            infer, _startup, _feeds, logits = mod.build_gpt_infer(cfg,
                                                                  MAX_LEN)
        scope = tfluid.Scope() if fl is tfluid else jfluid.core.Scope()
        for p in infer.all_parameters():
            canon = p.name[:-2] + "_0" if p.name.endswith("_1") else p.name
            a = np.array(params[canon], copy=True)
            scope.set(p.name, _port_tensor(a) if fl is tfluid else a)
        exe = fl.Executor(fl.CPUPlace())
        with _decode_defaults():
            runs.append([mod.greedy_generate(exe, infer, logits, cfg, prompt,
                                             MAX_LEN, scope=scope)
                         for prompt in ([5, 17, 42], [1], [9] * 9)])
        if fl is tfluid:
            w1 = scope.get("gpt_1_ffn_fc0.w_1")
            assert scope.get("gpt_1_ffn_fc0.w_0") is w1
    assert runs[1] == runs[0]
    model = tgpt.GPTLM(_cfg(tgpt), device="cpu")
    tgpt.load_fluid_params(model, params)
    eager = [tgpt.greedy_generate(model, prompt, MAX_LEN)
             for prompt in ([5, 17, 42], [1], [9] * 9)]
    assert eager == runs[1]
    assert all(len(r) == MAX_LEN for r in runs[1])


def test_program_session_dispatch_scope_and_tp():
    """``DecodeSession(cfg, ...)`` is the program form, the model form
    stays eager, ``scope`` None means ``global_scope()`` (the session's
    caches appear there), and ``tp`` other than 1 raises, as
    ``DecodeEngine``'s does."""
    cfg = _cfg(tgpt)
    with _decode_defaults():
        with pytest.raises(NotImplementedError, match="tensor-parallel"):
            tdecode.DecodeSession(cfg, place=tfluid.CPUPlace(), tp=2)
        sess = tdecode.DecodeSession(cfg, place=tfluid.CPUPlace(), slots=1,
                                     max_len=8, prefill_buckets=[8])
        eager = tdecode.DecodeSession(tgpt.GPTLM(cfg, device="cpu"),
                                      slots=1, max_len=8)
    try:
        assert type(sess) is tdecode.ProgramDecodeSession
        assert type(eager) is tdecode.DecodeSession
        assert sess.scope is tfluid.global_scope()
        for name, t in sess.cache_tensors().items():
            assert tfluid.global_scope().get(name) is t
        assert sess.device == torch.device("cpu") == sess.exe.device
    finally:
        tfluid.global_scope().erase(list(sess.cache_tensors()))


def test_program_session_warmup_builds_every_plan_once(params):
    """``warmup()`` runs every program once (each bucket's prefill and
    resume window, both copies, the step), so the session's Executor
    plans are all built before a strict build gate could be armed: a
    second pass over every program builds none, and warmup leaves the
    caches zeroed."""
    with _decode_defaults():
        sess = tdecode.DecodeSession(
            _cfg(tgpt), place=tfluid.CPUPlace(), scope=tfluid.Scope(),
            slots=2, max_len=16, prefill_buckets=[8, 16], prefix_blocks=2,
            prefix_block=BLOCK, build_resume=True, block_size=0,
            spec_tokens=0)
    for n, a in params.items():
        sess.scope.set(n, _port_tensor(a))
    b0 = tprofiler.get_counter("executor_plan_builds")
    sess.warmup()
    built = tprofiler.get_counter("executor_plan_builds") - b0
    assert built == 2 + 2 + 2 + 1       # prefill, resume, copies, step
    sess.warmup()
    assert tprofiler.get_counter("executor_plan_builds") - b0 == built
    assert all(float(t.abs().max()) == 0.0
               for t in sess.cache_tensors().values())
