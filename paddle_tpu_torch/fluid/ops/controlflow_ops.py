"""Comparison, logical, ``where``, ``increment``, sub-block and
TensorArray ops (port of ``paddle_tpu/fluid/ops/controlflow_ops.py``).

Compares and logicals give bool tensors and no gradient; ``where`` is
differentiable in X and Y. ``while`` and ``conditional_block`` run their
sub-block through the Executor (``executor.py``: ``lower_while_op``,
``lower_conditional_block`` and their grads), and their gradients are
the desc-level ``while_grad`` / ``conditional_block_grad`` ops that
``append_backward`` builds through the reference's grad makers.

A LoD tensor array keeps the reference's representation: a time-major
stacked dense tensor [T, B, ...]. ``write_to_array`` appends (the index
orders the writes; the reference's does the same), ``read_from_array``
gathers one step at a tensor index without reading it on the host, and
the rank table is the rows' length vector: full-batch steps with length
masking stand in for the reference C++'s per-step shrinking batches.
"""

import torch

from .registry import SkipInferShape, in_var, op, register_op, \
    same_shape_infer, set_out

__all__ = []


def _cmp_infer(op_, block):
    v = in_var(op_, block, "X")
    if v is None:
        raise SkipInferShape()
    set_out(op_, block, "Out", v.shape, 0)  # BOOL


def _register_compare(name, fn):
    def lower(ctx, op_, _fn=fn):
        ctx.out(op_, "Out", _fn(ctx.in1(op_, "X"), ctx.in1(op_, "Y")))

    register_op(name, infer_shape=_cmp_infer, lower=lower)


_register_compare("equal", torch.eq)
_register_compare("not_equal", torch.ne)
_register_compare("less_than", torch.lt)
_register_compare("less_equal", torch.le)
_register_compare("greater_than", torch.gt)
_register_compare("greater_equal", torch.ge)


def _register_logical(name, fn, unary=False):
    def lower(ctx, op_, _fn=fn, _unary=unary):
        x = ctx.in1(op_, "X")
        ctx.out(op_, "Out", _fn(x) if _unary else _fn(x, ctx.in1(op_, "Y")))

    register_op(name, infer_shape=_cmp_infer, lower=lower)


_register_logical("logical_and", torch.logical_and)
_register_logical("logical_or", torch.logical_or)
_register_logical("logical_xor", torch.logical_xor)
_register_logical("logical_not", torch.logical_not, unary=True)


@op("increment", infer_shape=same_shape_infer("X"))
def _increment(ctx, op_):
    """X + step in X's dtype (an int64 counter stays int64), as a new
    tensor: the Executor carries a persistable Out back to the scope,
    and a ``while`` keeps the old value of a carried counter."""
    x = ctx.in1(op_, "X")
    step = float(op_.attr("step", 1.0))
    ctx.out(op_, "Out", x + (step if x.is_floating_point() else int(step)))


@op("where", grad="generic")
def _where(ctx, op_):
    ctx.out(op_, "Out", torch.where(ctx.in1(op_, "Condition"),
                                    ctx.in1(op_, "X"), ctx.in1(op_, "Y")))


@op("select_input")
def _select_input(ctx, op_):
    """Out = X[Mask] (``controlflow_ops.py:83``), chosen on the device."""
    xs = ctx.ins(op_, "X")
    mask = ctx.in1(op_, "Mask").reshape(()).to(torch.int32)
    out = xs[0]
    for i, x in enumerate(xs[1:], start=1):
        out = torch.where(mask == i, x, out)
    ctx.out(op_, "Out", out)


@op("select_output")
def _select_output(ctx, op_):
    """Route X to Out[Mask] (``controlflow_ops.py:324``): every branch
    output is written, the chosen one with X and the others with zeros
    (a ``select_input`` on the same mask picks the live one)."""
    x = ctx.in1(op_, "X")
    mask = ctx.in1(op_, "Mask").reshape(()).to(torch.int32)
    for i, name in enumerate(op_.output("Out")):
        ctx.set(name, torch.where(mask == i, x, torch.zeros_like(x)))


# -- sub-block ops: lowered by the Executor, which owns sub-block runs --------
def _while_lower(ctx, op_):
    from .. import executor

    executor.lower_while_op(ctx, op_)


def _while_grad_lower(ctx, op_):
    from .. import executor

    executor.lower_while_grad_op(ctx, op_)


def _while_grad_maker(op_):
    """The reference's ``WhileGradOp`` maker (``controlflow_ops.py:117``):
    X@GRAD from Out@GRAD through the forward's ``StepScopes``."""
    xs = list(op_.input("X"))
    outs = list(op_.output("Out"))
    return [dict(
        type="while_grad",
        inputs={"X": xs, "Out": outs,
                "Out@GRAD": [n + "@GRAD" for n in outs],
                "Condition": list(op_.input("Condition")),
                "StepScopes": list(op_.output("StepScopes"))},
        outputs={"X@GRAD": [n + "@GRAD" for n in xs]},
        attrs=dict(op_.attrs))]


def _cond_block_lower(ctx, op_):
    from .. import executor

    executor.lower_conditional_block(ctx, op_)


def _cond_block_grad_lower(ctx, op_):
    from .. import executor

    executor.lower_conditional_block_grad(ctx, op_)


def _cond_block_grad_maker(op_):
    """The reference's ``ConditionalBlockGradOp`` maker
    (``controlflow_ops.py:148``): grads flow to the sub-block's reads and
    to outputs that existed before it (the skipped branch passes them
    through), restricted to variables the parent block sees."""
    from .. import executor

    reads, _writes = executor._analyze_ops(executor._sub_block(op_).ops)
    outs = list(op_.output("Out"))
    xs = list(dict.fromkeys(
        n for n in reads + outs
        if op_.block._find_var_recursive(n) is not None))
    return [dict(
        type="conditional_block_grad",
        inputs={"X": xs, "Cond": list(op_.input("Cond")), "Out": outs,
                "Out@GRAD": [n + "@GRAD" for n in outs],
                "Scope": list(op_.output("Scope"))},
        outputs={"X@GRAD": [n + "@GRAD" for n in xs]},
        attrs=dict(op_.attrs))]


register_op("while", lower=_while_lower, grad=_while_grad_maker)
register_op("while_grad", lower=_while_grad_lower)
register_op("conditional_block", lower=_cond_block_lower,
            grad=_cond_block_grad_maker)
register_op("conditional_block_grad", lower=_cond_block_grad_lower)


# -- TensorArray / LoD-array ops (``controlflow_ops.py:202-337``) -------------
def _seq_len(ctx, op_, slot):
    names = op_.inputs.get(slot) or []
    return ctx.get_opt(names[0] + "@SEQ_LEN") if names else None


@op("lod_rank_table")
def _lod_rank_table(ctx, op_):
    """The rows' lengths ([B] int32): X's ``@SEQ_LEN`` companion when the
    run has one, else X's full time dim for every row."""
    x = ctx.in1(op_, "X")
    lens = _seq_len(ctx, op_, "X")
    if lens is None:
        lens = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                          device=x.device)
    ctx.out(op_, "Out", lens)


@op("lod_tensor_to_array", grad="generic")
def _lod_tensor_to_array(ctx, op_):
    """[B, T, ...] -> the time-major array [T, B, ...]."""
    ctx.out(op_, "Out", ctx.in1(op_, "X").transpose(0, 1))
    lens = _seq_len(ctx, op_, "X")
    if lens is not None:
        ctx.set(op_.output("Out")[0] + "@SEQ_LEN", lens)


@op("array_to_lod_tensor", grad="generic")
def _array_to_lod_tensor(ctx, op_):
    """The array [T, B, ...] -> [B, T, ...]; a rank table becomes the
    output's ``@SEQ_LEN``."""
    ctx.out(op_, "Out", ctx.in1(op_, "X").transpose(0, 1))
    rt = ctx.in1(op_, "RankTable", optional=True)
    if rt is not None:
        ctx.set(op_.output("Out")[0] + "@SEQ_LEN", rt.reshape(-1))


@op("write_to_array", grad="generic")
def _write_to_array(ctx, op_):
    """Append X as the array's next step (a new array when Out holds
    none yet or an empty one)."""
    x = ctx.in1(op_, "X")
    arr = ctx.in1(op_, "Out", optional=True)
    if arr is None:
        arr = ctx.get_opt(op_.output("Out")[0])
    if arr is None or arr.numel() == 0:
        out = x.unsqueeze(0)
    else:
        out = torch.cat([arr, x.unsqueeze(0)], 0)
    ctx.out(op_, "Out", out)


@op("read_from_array", grad="generic")
def _read_from_array(ctx, op_):
    """Step I of the array, gathered on the device."""
    x = ctx.in1(op_, "X")
    i = ctx.in1(op_, "I").reshape(1).long()
    ctx.out(op_, "Out", torch.index_select(x, 0, i).squeeze(0))


@op("lod_array_length")
def _lod_array_length(ctx, op_):
    x = ctx.in1(op_, "X")
    ctx.out(op_, "Out", torch.full((1,), x.shape[0], dtype=torch.int64,
                                   device=x.device))


@op("max_sequence_len")
def _max_sequence_len(ctx, op_):
    ctx.out(op_, "Out", ctx.in1(op_, "RankTable").max().reshape(1).long())


@op("shrink_rnn_memory", grad="generic")
def _shrink_rnn_memory(ctx, op_):
    """The memory as it is: full-batch masked steps keep every row (the
    reference drops the rows whose sequences ended)."""
    ctx.out(op_, "Out", ctx.in1(op_, "X"))


@op("is_empty")
def _is_empty(ctx, op_):
    x = ctx.in1(op_, "X")
    ctx.out(op_, "Out", torch.full((1,), x.numel() == 0, dtype=torch.bool,
                                   device=x.device))


@op("split_lod_tensor", grad="generic")
def _split_lod_tensor(ctx, op_):
    """Both branches see the whole batch; ``merge_lod_tensor`` picks each
    row by the mask."""
    x = ctx.in1(op_, "X")
    ctx.out(op_, "OutTrue", x)
    ctx.out(op_, "OutFalse", x)


@op("merge_lod_tensor", grad="generic")
def _merge_lod_tensor(ctx, op_):
    mask = ctx.in1(op_, "Mask")
    t = ctx.in1(op_, "InTrue")
    f = ctx.in1(op_, "InFalse")
    m = mask.reshape((-1,) + (1,) * (t.dim() - 1)).to(torch.bool)
    ctx.out(op_, "Out", torch.where(m, t, f))
