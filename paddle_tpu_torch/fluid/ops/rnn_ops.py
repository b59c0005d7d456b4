"""Recurrent ops ``recurrent`` (a loop over a sub-block), ``dynamic_decode``
(a bounded loop over a sub-block) and ``gather_tree`` (beam-search
backtracking) (port of ``paddle_tpu/fluid/ops/rnn_ops.py:32-330``).

The reference lowers ``recurrent`` to one ``lax.scan`` and
``dynamic_decode`` to one ``lax.while_loop`` with pre-allocated output
buffers. Here ``recurrent`` is a Python loop over its static length with
no host sync; its generic grad runs the loop once on the autograd tape
(the Executor's capture) and takes the backward from it.
``dynamic_decode`` stops early when every beam has finished: it reads
that flag on the host before each step (``executor._holds``), counted in
``control_flow_host_syncs`` as ``while`` counts its condition, where
the reference's loop stays on the device. Padded steps of a recurrence
carry the old state and emit zeros (the reference's step mask).
"""

import numpy as np
import torch

from .registry import LowerCtx, SkipInferShape, in_var, op, run_op, set_out
from .sequence_ops import SEQ_LEN, companion


def _sub_block(ctx, op_):
    idx = op_.attr("sub_block")
    idx = idx if isinstance(idx, int) else idx.idx
    return ctx.block.program.block(idx)


def _frozen_env(ctx, sub, bound_names):
    """Outer values the sub-block reads (parameters etc.)."""
    from ..executor import _analyze_ops

    reads, _ = _analyze_ops(sub.ops)
    bound = set(bound_names)
    out = {}
    for n in reads:
        if n in bound:
            continue
        v = ctx.get_opt(n)
        if v is not None:
            out[n] = v
    return out


def _run_sub(ctx, sub, env):
    """The sub-block's ops on ``env``; companions and generators come from
    the run the op belongs to."""
    sub_ctx = LowerCtx(env=env, device=ctx.device, rng=ctx.rng, block=sub,
                       scope=ctx.scope, host_feeds=ctx.host_feeds,
                       parent=ctx)
    for o in sub.ops:
        run_op(sub_ctx, o)
    return env


# ---------------------------------------------------------------------------
# recurrent
# ---------------------------------------------------------------------------
def _recurrent_infer(op_, block):
    time_major = bool(op_.attr("time_major", False))
    x = in_var(op_, block, "Inputs")
    if x is None or len(x.shape) < 2:
        raise SkipInferShape()
    n, t = (x.shape[1], x.shape[0]) if time_major else (x.shape[0],
                                                        x.shape[1])
    idx = op_.attr("sub_block")
    sub = block.program.block(idx if isinstance(idx, int) else idx.idx)
    for i, name in enumerate(op_.attr("step_output_names") or []):
        v = sub._find_var_recursive(name)
        if v is not None:
            shape = ((t, n) if time_major else (n, t)) + tuple(v.shape[1:])
            set_out(op_, block, "Outputs", shape, v.dtype, idx=i)
    for i, name in enumerate(op_.inputs.get("InitStates") or []):
        v = block._find_var_recursive(name)
        if v is not None:
            set_out(op_, block, "FinalStates", v.shape, v.dtype, idx=i)


@op("recurrent", infer_shape=_recurrent_infer, grad="generic")
def _recurrent_lower(ctx, op_):
    sub = _sub_block(ctx, op_)
    step_in = list(op_.attr("step_input_names") or [])
    st_in = list(op_.attr("state_input_names") or [])
    st_out = list(op_.attr("state_output_names") or [])
    out_names = list(op_.attr("step_output_names") or [])
    time_major = bool(op_.attr("time_major", False))
    rev = bool(op_.attr("is_reverse", False))

    xs = ctx.ins(op_, "Inputs")
    states = list(ctx.ins(op_, "InitStates"))
    seq_len = ctx.in1(op_, "SequenceLength", optional=True)
    if seq_len is None:
        # ragged inputs carry their lengths as companions (DynamicRNN)
        in_names = op_.inputs.get("Inputs") or []
        if in_names:
            seq_len = companion(ctx, in_names[0] + SEQ_LEN)
    if not time_major:
        xs = [x.transpose(0, 1) for x in xs]  # -> [T, N, ...]
    if rev:
        xs = [torch.flip(x, [0]) for x in xs]
    frozen = _frozen_env(ctx, sub, step_in + st_in)
    for n in op_.inputs.get("Parameters") or []:
        v = ctx.get_opt(n)
        if v is not None:
            frozen[n] = v
    T = xs[0].shape[0]
    alive_all = None
    if seq_len is not None:
        # past a sequence's end the old state carries on (the reference's
        # step mask); reversed, padding sits at the front: a sequence of
        # length L lives for t in [T - L, T)
        sl = seq_len.reshape(1, -1).to(torch.int32)
        t = torch.arange(T, device=sl.device)[:, None]
        alive_all = (t >= T - sl) if rev else (t < sl)  # [T, N]
    ys = [[] for _ in out_names]
    for t in range(T):
        env = dict(frozen)
        env.update(zip(step_in, (x[t] for x in xs)))
        env.update(zip(st_in, states))
        _run_sub(ctx, sub, env)
        new_st = [env[n] for n in st_out]
        outs = [env[n] for n in out_names]
        if alive_all is not None:
            alive = alive_all[t]

            def keep(new, old):
                return torch.where(
                    alive.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)

            new_st = [keep(a, b) for a, b in zip(new_st, states)]
            outs = [keep(o, torch.zeros_like(o)) for o in outs]
        states = new_st
        for acc, o in zip(ys, outs):
            acc.append(o)
    ys = [torch.stack(y, 0) for y in ys]
    if rev:
        ys = [torch.flip(y, [0]) for y in ys]
    if not time_major:
        ys = [y.transpose(0, 1) for y in ys]
    ctx.outs(op_, "Outputs", ys)
    ctx.outs(op_, "FinalStates", states)
    if seq_len is not None:
        for n in op_.outputs.get("Outputs") or []:
            if n != "@EMPTY@":
                ctx.set(n + SEQ_LEN, seq_len.reshape(-1))


# ---------------------------------------------------------------------------
# dynamic_decode
# ---------------------------------------------------------------------------
def _dynamic_decode_infer(op_, block):
    idx = op_.attr("sub_block")
    sub = block.program.block(idx if isinstance(idx, int) else idx.idx)
    max_steps = int(op_.attr("max_step_num"))
    for i, name in enumerate(op_.attr("step_output_names") or []):
        v = sub._find_var_recursive(name)
        if v is not None:
            n = v.shape[0] if v.shape else -1
            set_out(op_, block, "Outputs",
                    (n, max_steps) + tuple(v.shape[1:]), v.dtype, idx=i)
    for i, name in enumerate(op_.inputs.get("InitStates") or []):
        v = block._find_var_recursive(name)
        if v is not None:
            set_out(op_, block, "FinalStates", v.shape, v.dtype, idx=i)
    fin = in_var(op_, block, "InitFinished")
    if fin is not None:
        set_out(op_, block, "Length", fin.shape, np.int32)


@op("dynamic_decode", infer_shape=_dynamic_decode_infer)
def _dynamic_decode_lower(ctx, op_):
    from ..executor import _holds

    sub = _sub_block(ctx, op_)
    time_name = op_.attr("time_name")
    input_names = list(op_.attr("input_names") or [])
    st_in = list(op_.attr("state_input_names") or [])
    fin_name = op_.attr("finished_name")
    out_names = list(op_.attr("step_output_names") or [])
    next_in = list(op_.attr("next_input_names") or [])
    st_out = list(op_.attr("state_output_names") or [])
    next_fin = op_.attr("next_finished_name")
    max_steps = int(op_.attr("max_step_num"))

    inputs = list(ctx.ins(op_, "InitInputs"))
    states = list(ctx.ins(op_, "InitStates"))
    # the body reads the flag in its own type (beam search does float
    # arithmetic on it); the loop's test and the lengths use it as bool
    fin_val = ctx.in1(op_, "InitFinished")
    finished = fin_val.to(torch.bool)
    frozen = _frozen_env(ctx, sub, input_names + st_in + [time_name,
                                                          fin_name])
    dev = finished.device

    def step_env(t, ins, st, fin):
        env = dict(frozen)
        env.update(zip(input_names, ins))
        env.update(zip(st_in, st))
        env[time_name] = torch.tensor(t, dtype=torch.int32, device=dev)
        env[fin_name] = fin
        return env

    steps = []
    lengths = torch.full(finished.shape, max_steps, dtype=torch.int32,
                         device=dev)
    t = 0
    while t < max_steps and not _holds(finished.all()):
        env = _run_sub(ctx, sub, step_env(t, inputs, states, fin_val))
        steps.append([env[n] for n in out_names])
        fin_val = env[next_fin].reshape(finished.shape)
        new_fin = fin_val.to(torch.bool)
        # the first step where finished turns on is the decoded length
        lengths = torch.where(~finished & new_fin,
                              torch.full_like(lengths, t + 1), lengths)
        inputs = [env[n] for n in next_in]
        states = [env[n] for n in st_out]
        finished = new_fin
        t += 1
    if steps:
        probe = steps[0]
    else:
        from ..executor import _branch_shapes

        reads = step_env(0, inputs, states, fin_val)
        probe = [torch.empty(s, dtype=d, device=dev) for s, d in
                 _branch_shapes(ctx, sub, reads, out_names).values()]
    # steps past an early exit hold each buffer's tail value, a valid
    # step: beam search fills tokens with end_token and parents with the
    # identity beam, so gather_tree keeps each beam's own ancestry
    tail_fill = list(op_.attr("output_tail_fill") or [])
    tail_arange = list(op_.attr("output_tail_arange") or [])
    outs = []
    for i, p in enumerate(probe):
        got = [s[i].to(p.dtype) for s in steps]
        rest = max_steps - len(got)
        if rest:
            shape = (rest,) + tuple(p.shape)
            if i < len(tail_arange) and tail_arange[i]:
                tail = torch.arange(shape[-1], dtype=p.dtype,
                                    device=dev).expand(shape)
            else:
                fill = tail_fill[i] if i < len(tail_fill) else 0
                tail = torch.full(shape, fill, dtype=p.dtype, device=dev)
            got.append(tail)
        buf = torch.cat([g.unsqueeze(0) if g.dim() == p.dim() else g
                         for g in got], 0)
        outs.append(buf.movedim(0, 1))  # -> [batch, T, ...]
    ctx.outs(op_, "Outputs", outs)
    ctx.outs(op_, "FinalStates", states)
    ctx.out(op_, "Length", lengths)


# ---------------------------------------------------------------------------
# gather_tree
# ---------------------------------------------------------------------------
def _gather_tree_infer(op_, block):
    ids = in_var(op_, block, "Ids")
    if ids is None:
        raise SkipInferShape()
    set_out(op_, block, "Out", ids.shape, ids.dtype)


def gather_tree(ids, parents):
    """Backtrack beams (``gather_tree_op``): ids and parents [batch, T,
    beam]; from the last step, follow each beam's parents back to the
    first and read the token at every step."""
    T = ids.shape[1]
    beam_idx = torch.arange(ids.shape[2], device=ids.device).expand(
        ids.shape[0], ids.shape[2])
    toks = [None] * T
    for t in range(T - 1, -1, -1):
        toks[t] = torch.gather(ids[:, t], 1, beam_idx)
        beam_idx = torch.gather(parents[:, t], 1, beam_idx).long()
    return torch.stack(toks, 1)


@op("gather_tree", infer_shape=_gather_tree_infer)
def _gather_tree_lower(ctx, op_):
    ctx.out(op_, "Out", gather_tree(ctx.in1(op_, "Ids"),
                                    ctx.in1(op_, "Parents")))
