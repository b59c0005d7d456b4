"""Tensor creation and manipulation op lowerings (port of the matching
rules in ``paddle_tpu/fluid/ops/tensor_ops.py`` and of ``assign_value``
in ``paddle_tpu/fluid/initializer.py``).

Random creation ops draw from the run's generator on the executor's
device (``LowerCtx.generator``): the startup program's ``uniform_random``
initializes parameters on the card. Shape ops return views where torch
can; gradients come from the generic vjp path.
"""

import numpy as np
import torch
import torch.nn.functional as F

from .. import core
from .registry import (
    SkipInferShape,
    in_var,
    op,
    register_op,
    same_shape_infer,
    set_out,
)


def _dtype(attr_dtype):
    return core.dtype_to_torch(
        core.VarDesc.VarType.FP32 if attr_dtype is None else attr_dtype)


def _empty_like_shape(x):
    """The ``XShape`` output of the *2 shape ops: a size-0 placeholder, as
    the reference carries it."""
    return x.new_empty((0,))


# -- creation ----------------------------------------------------------------
def _fill_constant_infer(op_, block):
    shape = op_.attr("shape", [])
    set_out(op_, block, "Out", shape,
            op_.attr("dtype", core.VarDesc.VarType.FP32))


@op("fill_constant", infer_shape=_fill_constant_infer)
def _fill_constant(ctx, op_):
    shape = [int(s) for s in op_.attr("shape", [])]
    ctx.out(op_, "Out", torch.full(shape, float(op_.attr("value", 0.0)),
                                   dtype=_dtype(op_.attr("dtype")),
                                   device=ctx.device))


@op("uniform_random", infer_shape=_fill_constant_infer)
def _uniform_random(ctx, op_):
    shape = [int(s) for s in op_.attr("shape", [])]
    lo = float(op_.attr("min", -1.0))
    hi = float(op_.attr("max", 1.0))
    out = torch.empty(shape, dtype=_dtype(op_.attr("dtype")),
                      device=ctx.device)
    ctx.out(op_, "Out", out.uniform_(lo, hi, generator=ctx.generator(op_)))


@op("gaussian_random", infer_shape=_fill_constant_infer)
def _gaussian_random(ctx, op_):
    shape = [int(s) for s in op_.attr("shape", [])]
    out = torch.empty(shape, dtype=_dtype(op_.attr("dtype")),
                      device=ctx.device)
    ctx.out(op_, "Out", out.normal_(float(op_.attr("mean", 0.0)),
                                    float(op_.attr("std", 1.0)),
                                    generator=ctx.generator(op_)))


@op("truncated_gaussian_random", infer_shape=_fill_constant_infer)
def _truncated_gaussian_random(ctx, op_):
    shape = [int(s) for s in op_.attr("shape", [])]
    mean = float(op_.attr("mean", 0.0))
    std = float(op_.attr("std", 1.0))
    out = torch.empty(shape, dtype=_dtype(op_.attr("dtype")),
                      device=ctx.device)
    # N(0, 1) truncated at ±2, as the reference's truncated_normal(-2, 2)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0,
                                generator=ctx.generator(op_))
    ctx.out(op_, "Out", out * std + mean)


@op("assign_value", infer_shape=_fill_constant_infer)
def _assign_value(ctx, op_):
    vals = np.asarray(op_.attr("values"))
    shape = [int(s) for s in op_.attr("shape")]
    ctx.out(op_, "Out", torch.as_tensor(
        vals.reshape(shape), dtype=_dtype(op_.attr("dtype"))
    ).to(ctx.device))


@op("assign", infer_shape=same_shape_infer("X"), grad="generic")
def _assign(ctx, op_):
    ctx.out(op_, "Out", ctx.in1(op_, "X"))


def _cast_infer(op_, block):
    v = in_var(op_, block, "X")
    if v is None:
        raise SkipInferShape()
    set_out(op_, block, "Out", v.shape, op_.attr("out_dtype"))


def _cast_vjp(ctx, op_, slots):
    """``cast`` across fp32, bf16, fp16 (and the rest of the enum) with
    its pullback: Out's cotangent cast back to X's type."""
    x = ctx.in1(op_, "X")
    ctx.out(op_, "Out", x.to(_dtype(op_.attr("out_dtype"))))
    in_dtype = x.dtype
    return lambda g: {"X": g.to(in_dtype)}


register_op("cast", infer_shape=_cast_infer,
            lower=lambda ctx, op_: _cast_vjp(ctx, op_, ()), grad="generic",
            vjp=_cast_vjp)


@op("isfinite")
def _isfinite(ctx, op_):
    """One bool [1]: every element of every input finite (the
    reference's ``math_ops.py:662``)."""
    ok = torch.ones((), dtype=torch.bool, device=ctx.device)
    for x in ctx.ins(op_, "X"):
        ok = ok & torch.isfinite(x).all()
    ctx.out(op_, "Out", ok.reshape((1,)))


@op("scale", infer_shape=same_shape_infer("X"), grad="generic")
def _scale(ctx, op_):
    x = ctx.in1(op_, "X")
    scale = float(op_.attr("scale", 1.0))
    bias = float(op_.attr("bias", 0.0))
    if op_.attr("bias_after_scale", True):
        out = x * scale if bias == 0.0 else x * scale + bias
    else:
        out = (x + bias) * scale
    ctx.out(op_, "Out", out.to(x.dtype))


@op("sum", infer_shape=same_shape_infer("X"), grad="generic")
def _sum(ctx, op_):
    xs = ctx.ins(op_, "X")
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    ctx.out(op_, "Out", out)


# -- shape manipulation --------------------------------------------------------
def _reshape_infer(op_, block):
    v = in_var(op_, block, "X")
    if v is None:
        raise SkipInferShape()
    shape = list(op_.attr("shape", []))
    in_shape = list(v.shape)
    if -1 in shape or 0 in shape:
        shape = [in_shape[i] if s == 0 else s for i, s in enumerate(shape)]
        if -1 in shape and all(s > 0 for s in in_shape):
            known = int(np.prod([s for s in shape if s != -1])) or 1
            total = int(np.prod(in_shape))
            shape[shape.index(-1)] = total // known
    set_out(op_, block, "Out", shape, v.dtype)
    if op_.output("XShape"):
        set_out(op_, block, "XShape", (0,) + tuple(in_shape), v.dtype)


def _reshape_lower(ctx, op_):
    x = ctx.in1(op_, "X")
    shape = [x.shape[i] if s == 0 else int(s)
             for i, s in enumerate(op_.attr("shape", []))]
    ctx.out(op_, "Out", x.reshape(shape))
    if op_.output("XShape"):
        ctx.out(op_, "XShape", _empty_like_shape(x))


def _reshape_vjp(ctx, op_, slots):
    """``reshape2`` with its pullback: Out's cotangent in X's shape."""
    shape = ctx.in1(op_, "X").shape
    _reshape_lower(ctx, op_)
    return lambda g: {"X": g.reshape(shape)}


register_op("reshape2", infer_shape=_reshape_infer, lower=_reshape_lower,
            grad="generic", vjp=_reshape_vjp)


def _transpose_infer(op_, block):
    v = in_var(op_, block, "X")
    if v is None:
        raise SkipInferShape()
    shape = [v.shape[a] for a in op_.attr("axis", [])]
    set_out(op_, block, "Out", shape, v.dtype)
    if op_.output("XShape"):
        set_out(op_, block, "XShape", (0,) + tuple(v.shape), v.dtype)


def _transpose_lower(ctx, op_):
    x = ctx.in1(op_, "X")
    ctx.out(op_, "Out", x.permute(*op_.attr("axis")))
    if op_.output("XShape"):
        ctx.out(op_, "XShape", _empty_like_shape(x))


def _transpose_vjp(ctx, op_, slots):
    """``transpose2`` with its pullback: Out's cotangent permuted back."""
    _transpose_lower(ctx, op_)
    inverse = [0] * len(op_.attr("axis"))
    for i, a in enumerate(op_.attr("axis")):
        inverse[a] = i
    return lambda g: {"X": g.permute(*inverse)}


register_op("transpose2", infer_shape=_transpose_infer,
            lower=_transpose_lower, grad="generic", vjp=_transpose_vjp)


def _unsqueeze_shape(shape, axes):
    out = list(shape)
    for a in sorted(a % (len(out) + 1) for a in axes):
        out.insert(a, 1)
    return out


def _unsqueeze_infer(op_, block):
    v = in_var(op_, block, "X")
    if v is None:
        raise SkipInferShape()
    set_out(op_, block, "Out", _unsqueeze_shape(v.shape, op_.attr("axes", [])),
            v.dtype)
    if op_.output("XShape"):
        set_out(op_, block, "XShape", (0,) + tuple(v.shape), v.dtype)


def _unsqueeze_lower(ctx, op_):
    x = ctx.in1(op_, "X")
    ctx.out(op_, "Out", x.reshape(_unsqueeze_shape(x.shape,
                                                   op_.attr("axes", []))))
    if op_.output("XShape"):
        ctx.out(op_, "XShape", _empty_like_shape(x))


register_op("unsqueeze2", infer_shape=_unsqueeze_infer,
            lower=_unsqueeze_lower, grad="generic")


@op("slice", grad="generic")
def _slice(ctx, op_):
    x = ctx.in1(op_, "Input")
    idx = [slice(None)] * x.dim()
    for a, s, e in zip(op_.attr("axes", []), op_.attr("starts", []),
                       op_.attr("ends", [])):
        dim = x.shape[a]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        idx[a] = slice(int(s), int(e))
    out = x[tuple(idx)]
    decrease = op_.attr("decrease_axis", [])
    if decrease:
        out = out.squeeze(tuple(decrease))
    ctx.out(op_, "Out", out)


def _lookup_table_infer(op_, block):
    w = in_var(op_, block, "W")
    ids = in_var(op_, block, "Ids")
    if w is None or ids is None:
        raise SkipInferShape()
    id_shape = list(ids.shape)
    if id_shape and id_shape[-1] == 1:
        id_shape = id_shape[:-1]
    set_out(op_, block, "Out", tuple(id_shape) + (w.shape[-1],), w.dtype)


@op("lookup_table", infer_shape=_lookup_table_infer, grad="generic")
def _lookup_table(ctx, op_):
    """Rows of W at Ids ([..., 1] int ids; the port keeps int64, where the
    reference's JAX runs them as int32). Rows at ``padding_idx`` read 0."""
    w = ctx.in1(op_, "W")
    ids = ctx.in1(op_, "Ids")
    if ids.dim() and ids.shape[-1] == 1:
        ids = ids.reshape(ids.shape[:-1])
    out = F.embedding(ids, w)
    padding_idx = int(op_.attr("padding_idx", -1))
    if padding_idx != -1:
        if padding_idx < 0:
            padding_idx += w.shape[0]
        out = out * (ids != padding_idx).unsqueeze(-1).to(out.dtype)
    ctx.out(op_, "Out", out)


def top_k(x, k):
    """The ``top_k`` op (``tensor_ops.py:589``): the ``k`` largest entries
    of the last axis, largest first, and their int64 indices. Equal
    entries keep their order, so a tie picks the lower index, as
    ``jax.lax.top_k`` does (``torch.topk`` leaves tie order open on the
    card)."""
    idx = torch.sort(x, dim=-1, descending=True, stable=True).indices
    idx = idx[..., :k]
    return x.gather(-1, idx), idx


def _top_k_infer(op_, block):
    v = in_var(op_, block, "X")
    if v is None or not v.shape:
        raise SkipInferShape()
    shape = tuple(v.shape[:-1]) + (int(op_.attr("k", 1)),)
    set_out(op_, block, "Out", shape, v.dtype)
    set_out(op_, block, "Indices", shape, core.VarDesc.VarType.INT64)


@op("top_k", infer_shape=_top_k_infer)
def _top_k(ctx, op_):
    vals, idx = top_k(ctx.in1(op_, "X"), int(op_.attr("k", 1)))
    ctx.out(op_, "Out", vals)
    ctx.out(op_, "Indices", idx)


def _one_hot_infer(op_, block):
    v = in_var(op_, block, "X")
    if v is None:
        raise SkipInferShape()
    shape = list(v.shape)
    if shape and shape[-1] == 1:
        shape = shape[:-1]
    set_out(op_, block, "Out", shape + [int(op_.attr("depth"))],
            core.VarDesc.VarType.FP32)


@op("one_hot", infer_shape=_one_hot_infer)
def _one_hot(ctx, op_):
    """fp32 [..., depth] rows of ids X ([..., 1] or [...]); an id outside
    [0, depth) gives a row of zeros, with or without
    ``allow_out_of_range``, as the reference's ``jax.nn.one_hot``
    (``tensor_ops.py:562``)."""
    x = ctx.in1(op_, "X")
    depth = int(op_.attr("depth"))
    if x.dim() and x.shape[-1] == 1:
        x = x.reshape(x.shape[:-1])
    x = x.long()
    inside = (x >= 0) & (x < depth)
    out = torch.zeros(tuple(x.shape) + (depth,), dtype=torch.float32,
                      device=x.device)
    out.scatter_(-1, x.clamp(0, depth - 1).unsqueeze(-1),
                 inside.unsqueeze(-1).to(torch.float32))
    ctx.out(op_, "Out", out)
