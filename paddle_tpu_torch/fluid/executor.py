"""The Executor: runs a Program's block op by op on torch tensors (port of
``paddle_tpu/fluid/executor.py``).

``Executor(place).run(program, feed, fetch_list, scope)`` interprets the
global block in order on the place's device. Feeds become tensors on
the device; variables the block reads before it writes come from the
scope; persistable variables the block writes go back to the scope,
updated in place where the op updates its input (optimizer state).
The only host syncs are the feeds' copies at the start and the fetches
at the end.

The reference lowers whole blocks to XLA in segments with a jit plan;
this interpreter dispatches each op eagerly instead (the CUDA-graph plan
is later work). What it plans once per program version:

- which generic grad op belongs to which forward op in the block: that
  forward runs once, through its op's ``vjp`` rule or on the autograd
  tape, and its grad op reuses the vjp closure
  (``registry.run_op_capturing``), so no forward runs twice;
- when each variable is read for the last time, so the run's
  environment drops it there, as eager autograd frees what nothing saves
  (the closures keep exactly what their backward needs).

A ``while`` or ``conditional_block`` op runs its sub-block op by op on
the run's environment (``lower_while_op``, ``lower_conditional_block``);
the plan counts what a sub-block reads and writes as its op's, so the
scope reads, the liveness and the persistables written back see through
it. Reading a ``while`` condition, or a scalar ``conditional_block``
condition, waits for the device: one host sync a loop iteration
(``control_flow_host_syncs``), where the reference's ``lax.while_loop``
stays on the device.

Each plan built counts in the ``executor_plan_builds`` profiler counter
(a server asserts it stays still after warmup). One Executor may serve
several threads (a predictor pool shares one): a plan is built under the
Executor's lock, and a run keeps all its other state to itself.
"""

import contextlib
import threading
import time

import numpy as np
import torch

from . import core, profiler
from ..observability import compile_stats, trace
from .framework import Variable, default_main_program
from .ops import registry as _registry

__all__ = ["Executor", "global_scope", "scope_guard"]

GRAD_SUFFIX = _registry.GRAD_SUFFIX
EMPTY_VAR = _registry.EMPTY_VAR


def global_scope():
    return core.global_scope()


@contextlib.contextmanager
def scope_guard(scope):
    old = core._switch_scope(scope)
    try:
        yield
    finally:
        core._switch_scope(old)


def _signature(type_, inputs, outputs):
    def frozen(io):
        return tuple(sorted((k, tuple(v)) for k, v in io.items()))

    return type_, frozen(inputs), frozen(outputs)


class _Plan(object):
    """What ``run`` needs to know about one block, computed once per
    program version: the ops, the capture pairs, the reads that come from
    the scope, the names to drop after each op and the persistables."""

    def __init__(self, program, block):
        ops = list(block.ops)
        self.ops = ops
        persistable = {v.name for v in program.list_vars() if v.persistable}
        self.persistable = persistable
        produced = set()
        for op_ in ops:
            produced.update(n for n in op_.output_arg_names if n != EMPTY_VAR)

        # generic grad op -> its forward op, matched by the signature the
        # grad maker recorded
        forward_at = {}
        for i, op_ in enumerate(ops):
            forward_at.setdefault(
                _signature(op_.type, op_.inputs, op_.outputs), i)
        self.capture = {}            # forward index -> (grad op, cot names)
        captured_grads = set()
        for j, op_ in enumerate(ops):
            if not _registry.is_generic_grad(op_.type):
                continue
            sig = _signature(op_.type[: -len("_grad")],
                             op_.attr(_registry.FWD_INPUTS_ATTR) or {},
                             op_.attr(_registry.FWD_OUTPUTS_ATTR) or {})
            i = forward_at.get(sig)
            if i is None or i >= j:
                continue
            fwd = ops[i]
            cots = [n for slot in sorted(fwd.outputs)
                    for n in fwd.outputs[slot]
                    if n != EMPTY_VAR and n + GRAD_SUFFIX in produced
                    and _is_float_var(block, n)]
            self.capture[i] = (op_, cots)
            captured_grads.add(j)

        # liveness: last read of every name; a captured grad op reads only
        # its cotangents (its closure holds the rest); a control-flow op
        # reads and writes what its sub-block does
        last = {}
        first_write = {}
        scope_reads = []
        for j, op_ in enumerate(ops):
            reads, writes = _op_io(op_)
            if j in captured_grads:
                reads = [n for slot, names in op_.inputs.items()
                         if slot.endswith(GRAD_SUFFIX) for n in names]
            for n in reads:
                if n == EMPTY_VAR:
                    continue
                if n not in first_write and n not in scope_reads:
                    scope_reads.append(n)
                last[n] = j
            for n in writes:
                if n != EMPTY_VAR:
                    first_write.setdefault(n, j)
                    last.setdefault(n, j)
        self.scope_reads = scope_reads
        self.free_after = [[] for _ in ops]
        for n, j in last.items():
            if n not in persistable:
                self.free_after[j].append(n)
        self.writes_persistable = sorted(
            n for n in first_write if n in persistable)


def _sub_block(op_):
    return op_.block.program.block(op_.attr("sub_block"))


def _op_io(op_):
    """(reads, writes) of one op; a control-flow op's include what its
    sub-block reads from outside it and writes."""
    reads, writes = op_.input_arg_names, op_.output_arg_names
    if op_.has_attr("sub_block"):
        sub_reads, sub_writes = _analyze_ops(_sub_block(op_).ops)
        reads, writes = reads + sub_reads, writes + sub_writes
    return reads, writes


def _analyze_ops(ops):
    """(reads from outside, writes) of an op list, each in first-use
    order: a name counts as read from outside when an op reads it before
    any op of the list wrote it (``executor.py:_analyze_ops`` of the
    reference, nested sub-blocks included)."""
    reads, writes = [], []
    for op_ in ops:
        op_reads, op_writes = _op_io(op_)
        for n in op_reads:
            if n != EMPTY_VAR and n not in writes and n not in reads:
                reads.append(n)
        for n in op_writes:
            if n != EMPTY_VAR and n not in writes:
                writes.append(n)
    return reads, writes


def _is_float_var(block, name):
    v = block._find_var_recursive(name)
    return v is None or core.dtype_is_floating(v.dtype)


def _as_tensor(value, device):
    """A feed as a tensor on ``device``: a tensor as it is (moved if it
    lives elsewhere), an array copied, so that an op that updates its
    input in place never writes the caller's array (the CPU would
    otherwise share its memory)."""
    if isinstance(value, core.LoDTensor):
        value = value.tensor()
    if isinstance(value, torch.Tensor):
        return value.to(device)
    return torch.tensor(np.asarray(value), device=device)


def _to_numpy(t):
    """A fetched tensor as a numpy array on the host that owns its
    memory (a CPU tensor is copied: the scope's tensors are updated in
    place by later runs); bf16, which numpy has no type for, comes back
    as fp32 (every bf16 value is one)."""
    t = t.detach()
    t = t.cpu() if t.device.type != "cpu" else t.clone()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class Executor(object):
    """Drop-in for fluid.Executor (reference:
    python/paddle/fluid/executor.py:418). ``place`` None means the card
    (``resolve_device``); ``CPUPlace()`` runs the plain path on the CPU."""

    def __init__(self, place=None):
        self.place = place
        self.device = core.resolve_device(place)
        self._plans = {}
        self._lock = threading.Lock()

    def close(self):
        with self._lock:
            self._plans.clear()

    def _plan(self, program, fetch_names):
        key = (program, program._version, tuple(fetch_names))
        plan = self._plans.get(key)
        if plan is not None:
            return plan
        built_ms = None
        with self._lock:
            plan = self._plans.get(key)
            if plan is None:
                t0 = time.perf_counter()
                plan = _Plan(program, program.global_block())
                for n in fetch_names:
                    for frees in plan.free_after:
                        if n in frees:
                            frees.remove(n)
                self._plans = {k: v for k, v in self._plans.items()
                               if k[0] is not program}
                self._plans[key] = plan
                profiler.bump_counter("executor_plan_builds")
                built_ms = (time.perf_counter() - t0) * 1e3
        if built_ms is not None:
            # outside the lock: under the armed strict gate this raises
            # (the plan stays cached, as a build that happened)
            compile_stats.on_build(
                "executor_plan", compile_stats.program_label(program),
                {"version": int(program._version),
                 "fetches": list(fetch_names)}, built_ms)
        return plan

    def run(self, program=None, feed=None, fetch_list=None,
            feed_var_name="feed", fetch_var_name="fetch", scope=None,
            return_numpy=True, use_program_cache=True):
        """Run ``program``'s global block once; returns the fetched values
        (numpy arrays, bf16 as fp32; or tensors with
        ``return_numpy=False``)."""
        program = program if program is not None else default_main_program()
        scope = scope if scope is not None else core.global_scope()
        fetch_list = fetch_list or []
        if not isinstance(fetch_list, (list, tuple)):
            fetch_list = [fetch_list]
        fetch_names = [f.name if isinstance(f, Variable) else str(f)
                       for f in fetch_list]
        plan = self._plan(program, fetch_names)
        dev = self.device
        env = {}
        host_feeds = {}
        for name, value in (feed or {}).items():
            env[name] = _as_tensor(value, dev)
            if not isinstance(value, (torch.Tensor, core.LoDTensor)):
                # the host array stays readable without a device sync
                host_feeds[name] = (env[name], value)
        for name in plan.scope_reads:
            if name in env:
                continue
            v = scope.get(name)
            if v is not None:
                env[name] = v
        ctx = _registry.LowerCtx(
            env=env, device=dev, block=program.global_block(), scope=scope,
            rng=scope.rng(dev, program.random_seed), host_feeds=host_feeds)
        with trace.span("executor_run", cat="exec"), torch.no_grad():
            for i, op_ in enumerate(plan.ops):
                cap = plan.capture.get(i)
                if cap is not None:
                    _registry.run_op_capturing(ctx, op_, cap[0], cap[1])
                else:
                    _registry.run_op(ctx, op_)
                for n in plan.free_after[i]:
                    env.pop(n, None)
        for name in plan.writes_persistable:
            if name in env:
                scope.set(name, env[name])
        outs = []
        for n in fetch_names:
            v = env.get(n)
            if v is None:
                v = scope.get(n)
            if v is None:
                raise ValueError("fetch variable %r was not computed" % n)
            outs.append(_to_numpy(v) if return_numpy else v)
        profiler.bump_counter("executor_runs")
        return outs


# ---------------------------------------------------------------------------
# Sub-block control flow (lowered from ops/controlflow_ops.py)
# ---------------------------------------------------------------------------
HOST_SYNC_COUNTER = "control_flow_host_syncs"


def _sub_ctx(ctx, sub, env):
    return _registry.LowerCtx(env=env, device=ctx.device, rng=ctx.rng,
                              block=sub, scope=ctx.scope,
                              host_feeds=ctx.host_feeds)


def _run_block(ctx, sub, env):
    sub_ctx = _sub_ctx(ctx, sub, env)
    for op_ in sub.ops:
        _registry.run_op(sub_ctx, op_)


def _holds(t):
    """A one-element condition read on the host (a wait on the device)."""
    profiler.bump_counter(HOST_SYNC_COUNTER)
    return bool(t.reshape(()).item())


def _rng_state(ctx):
    return None if ctx.rng is None else tuple(g.get_state() for g in ctx.rng)


@contextlib.contextmanager
def _rng_at(ctx, state):
    """The run's generators set to ``state`` inside, back where they
    were after: a replay draws what the forward drew."""
    if state is None:
        yield
        return
    now = _rng_state(ctx)
    for g, st in zip(ctx.rng, state):
        g.set_state(st)
    try:
        yield
    finally:
        for g, st in zip(ctx.rng, now):
            g.set_state(st)


def _stash_wanted(ctx, op_, slot):
    """Whether an op of the run's block reads ``op_``'s ``slot`` output
    (the StepScopes / Scope a grad op replays from)."""
    names = [n for n in op_.output(slot) if n != EMPTY_VAR]
    return bool(names) and any(names[0] in o.input_arg_names
                               for o in ctx.block.ops)


def _is_float(v):
    return isinstance(v, torch.Tensor) and v.is_floating_point()


def _check_no_nested_control_flow(sub, grad_kind):
    """A grad over a body holding another ``while`` or
    ``conditional_block`` raises, as the reference's does
    (``executor.py:306``)."""
    nested = sorted({o.type for o in sub.ops
                     if o.type in ("while", "conditional_block")})
    if nested:
        raise NotImplementedError(
            "%s over a sub-block containing nested %s is not supported: "
            "restructure the inner loop or hoist it out of the "
            "differentiated region" % (grad_kind, nested))


def _while_parts(ctx, op_):
    """(sub-block, carried names, frozen names) of a ``while``, from the
    environment before the loop (``_while_parts`` of the reference):
    carried are the condition and what the body writes that has a value
    before the loop; frozen is the rest of what it reads."""
    sub = _sub_block(op_)
    env = ctx.env
    cond_name = op_.input("Condition")[0]
    reads, writes = _analyze_ops(sub.ops)
    carried = [n for n in dict.fromkeys([cond_name] + writes) if n in env]
    frozen = [n for n in reads if n not in carried and n in env]
    return sub, carried, frozen


def lower_while_op(ctx, op_):
    """Run the sub-block on the run's environment while the condition
    holds (``while_op.cc``). When a ``while_grad`` of the block reads
    this op's StepScopes, it holds the carried values at the start of
    every iteration (references, no copies: the body's ops make new
    tensors) with the generators' states, and the frozen reads."""
    sub, carried, frozen = _while_parts(ctx, op_)
    env = ctx.env
    cond_name = op_.input("Condition")[0]
    keep = _stash_wanted(ctx, op_, "StepScopes")
    sub_ctx = _sub_ctx(ctx, sub, env)
    steps = []
    while _holds(env[cond_name]):
        if keep:
            steps.append(([env[n] for n in carried], _rng_state(ctx)))
        for inner in sub.ops:
            _registry.run_op(sub_ctx, inner)
    if keep:
        ctx.set(op_.output("StepScopes")[0], {
            "carried": carried, "frozen": {n: env[n] for n in frozen},
            "steps": steps})


def lower_while_grad_op(ctx, op_):
    """``while_grad`` (``WhileGradOp``): the steps in reverse, each
    replayed from its kept carried values under autograd, its vjp taking
    the carried cotangent one step back and adding into the frozen
    reads' grads (loop-invariant parameters sum over the iterations)."""
    sub = _sub_block(op_)
    _check_no_nested_control_flow(sub, "while_grad")
    stash = ctx.get(op_.input("StepScopes")[0])
    carried, frozen, steps = stash["carried"], stash["frozen"], \
        stash["steps"]
    init = steps[0][0] if steps else [ctx.get(n) for n in carried]
    fc = [i for i, v in enumerate(init) if _is_float(v)]
    ff = [n for n, v in frozen.items() if _is_float(v)]
    g_c = []
    for i in fc:
        g = ctx.get_opt(carried[i] + GRAD_SUFFIX)
        g_c.append(torch.zeros_like(init[i]) if g is None else g)
    g_f = [torch.zeros_like(frozen[n]) for n in ff]
    for vals, rng in reversed(steps):
        leaves_c = [vals[i].detach().requires_grad_() for i in fc]
        leaves_f = [frozen[n].detach().requires_grad_() for n in ff]
        env = dict(frozen)
        env.update(zip(carried, vals))
        env.update(zip((carried[i] for i in fc), leaves_c))
        env.update(zip(ff, leaves_f))
        with torch.enable_grad(), _rng_at(ctx, rng):
            _run_block(ctx, sub, env)
        outs = [(env[carried[i]], g) for i, g in zip(fc, g_c)
                if env[carried[i]].requires_grad]
        leaves = leaves_c + leaves_f
        if outs:
            grads = torch.autograd.grad(
                [o for o, _g in outs], leaves, [g for _o, g in outs],
                allow_unused=True, materialize_grads=True)
        else:
            grads = [torch.zeros_like(x) for x in leaves]
        g_c = list(grads[:len(fc)])
        g_f = [a + b for a, b in zip(g_f, grads[len(fc):])]
    by_name = dict(zip(ff, g_f))
    by_name.update(zip((carried[i] for i in fc), g_c))
    for xn, gn in zip(op_.input("X"), op_.output("X@GRAD")):
        if gn == EMPTY_VAR:
            continue
        g = by_name.get(xn)
        if g is None:
            v = ctx.get_opt(xn)
            if not _is_float(v):
                continue
            g = torch.zeros_like(v)
        ctx.set(gn, g)


def _cond_holds(ctx, op_):
    """A ``conditional_block``'s condition: the one-element Cond read on
    the host when ``is_scalar_condition`` (every Switch case), else, as
    ``conditional_block_op.cc``, that no Cond tensor is empty."""
    conds = ctx.ins(op_, "Cond")
    if op_.attr("is_scalar_condition", False):
        return _holds(conds[0])
    return all(c.numel() > 0 for c in conds)


def _branch_shapes(ctx, sub, reads, names):
    """{name: (shape, dtype)} the branch would give ``names``, from a run
    of its ops on meta tensors (shapes and dtypes only)."""
    meta = torch.device("meta")
    env = {n: torch.empty(v.shape, dtype=v.dtype, device=meta)
           for n, v in reads.items() if isinstance(v, torch.Tensor)}
    sub_ctx = _registry.LowerCtx(env=env, device=meta, block=sub,
                                 scope=ctx.scope)
    for inner in sub.ops:
        _registry.run_op(sub_ctx, inner)
    return {n: (env[n].shape, env[n].dtype) for n in names}


def lower_conditional_block(ctx, op_):
    """Run the sub-block on the run's environment when the condition
    holds (``conditional_block_op.cc``). A skipped branch leaves its
    outputs as they were; an output with no value yet becomes zeros of
    the shape the branch would give it, the reference's false-branch
    value (``lax.cond`` needs one)."""
    sub = _sub_block(op_)
    env = ctx.env
    reads, writes = _analyze_ops(sub.ops)
    out_names = op_.output("Out") or writes
    read_vals = {n: env[n] for n in reads if n in env}
    prevs = {n: env[n] for n in out_names if n in env}
    keep = _stash_wanted(ctx, op_, "Scope")
    rng = _rng_state(ctx) if keep else None
    holds = _cond_holds(ctx, op_)
    if holds:
        _run_block(ctx, sub, env)
    else:
        missing = [n for n in out_names if n not in env]
        if missing:
            for n, (shape, dtype) in _branch_shapes(
                    ctx, sub, read_vals, missing).items():
                env[n] = torch.zeros(shape, dtype=dtype, device=ctx.device)
    if keep:
        ctx.set(op_.output("Scope")[0], {
            "cond": holds, "reads": read_vals, "prevs": prevs, "rng": rng})


def lower_conditional_block_grad(ctx, op_):
    """``conditional_block_grad``: when the branch ran, the vjp of its
    replay (from the values it read, under the generators' states it
    ran with) gives the reads' grads and an output that existed before
    gets none through the branch; when it was skipped, the reads get
    zeros and such an output passes its cotangent through."""
    sub = _sub_block(op_)
    _check_no_nested_control_flow(sub, "conditional_block_grad")
    stash = ctx.get(op_.input("Scope")[0])
    reads, prevs = stash["reads"], stash["prevs"]
    read_names = [n for n, v in reads.items() if _is_float(v)]
    float_outs = [n for n in op_.input("Out") if _is_float(ctx.get_opt(n))]
    g_outs = {}
    for n in float_outs:
        g = ctx.get_opt(n + GRAD_SUFFIX)
        g_outs[n] = torch.zeros_like(ctx.get(n)) if g is None else g
    pass_names = [n for n in float_outs if n in prevs]
    if not read_names and not pass_names:
        return
    g_reads, g_pass = {}, {}
    if stash["cond"]:
        leaves = [reads[n].detach().requires_grad_() for n in read_names]
        env = dict(reads)
        env.update(zip(read_names, leaves))
        with torch.enable_grad(), _rng_at(ctx, stash["rng"]):
            _run_block(ctx, sub, env)
        outs = [(env[n], g_outs[n]) for n in float_outs
                if n in env and env[n].requires_grad]
        if outs:
            grads = torch.autograd.grad(
                [o for o, _g in outs], leaves, [g for _o, g in outs],
                allow_unused=True, materialize_grads=True)
        else:
            grads = [torch.zeros_like(x) for x in leaves]
        g_reads = dict(zip(read_names, grads))
        g_pass = {n: torch.zeros_like(prevs[n]) for n in pass_names}
    else:
        g_reads = {n: torch.zeros_like(reads[n]) for n in read_names}
        g_pass = {n: g_outs[n] for n in pass_names}
    for xn, gn in zip(op_.input("X"), op_.output("X@GRAD")):
        if gn == EMPTY_VAR:
            continue
        total = g_reads.get(xn)
        if xn in g_pass:
            total = g_pass[xn] if total is None else total + g_pass[xn]
        if total is None:
            v = ctx.get_opt(xn)
            if not _is_float(v):
                continue
            total = torch.zeros_like(v)
        ctx.set(gn, total)
