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
        # its cotangents (its closure holds the rest)
        last = {}
        first_write = {}
        scope_reads = []
        for j, op_ in enumerate(ops):
            if j in captured_grads:
                reads = [n for slot, names in op_.inputs.items()
                         if slot.endswith(GRAD_SUFFIX) for n in names]
            else:
                reads = op_.input_arg_names
            for n in reads:
                if n == EMPTY_VAR:
                    continue
                if n not in first_write and n not in scope_reads:
                    scope_reads.append(n)
                last[n] = j
            for n in op_.output_arg_names:
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
