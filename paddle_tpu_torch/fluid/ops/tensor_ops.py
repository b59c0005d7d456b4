"""Tensor creation and manipulation op lowerings (port of
``paddle_tpu/fluid/ops/tensor_ops.py`` and of ``assign_value`` in
``paddle_tpu/fluid/initializer.py``).

Random creation ops draw from the run's generator on the executor's
device (``LowerCtx.generator``): the startup program's ``uniform_random``
initializes parameters on the card. Shape ops return views where torch
can; gradients come from the generic vjp path. An op whose output shape
depends on values (``range``, ``linspace``, ``where_index``) reads them
on the host and counts the read in ``op_host_reads``; ``shape`` and
``size`` read the tensor's own metadata. Index outputs keep the desc's
int64 where the reference's JAX gives int32.
"""

import numpy as np
import torch
import torch.nn.functional as F

from .. import core
from .. import profiler
from .registry import (
    HOST_READ_COUNTER,
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


@op("fill_constant_batch_size_like", infer_shape=_fill_constant_infer)
def _fill_constant_bsl(ctx, op_):
    """``fill_constant`` with one dim taken from Input's
    (``tensor_ops.py:47``)."""
    ref = ctx.in1(op_, "Input")
    shape = [int(s) for s in op_.attr("shape", [])]
    shape[int(op_.attr("output_dim_idx", 0))] = ref.shape[
        int(op_.attr("input_dim_idx", 0))]
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


@op("recompute_barrier", infer_shape=same_shape_infer("X"))
def _recompute_barrier(ctx, op_):
    """The recompute replay's read of a value from outside its segment
    (``tensor_ops.py:169``): X itself. The reference's is an
    ``optimization_barrier`` that keeps XLA from merging the replay into
    the forward and, through ``Dep`` (the cotangent entering the
    segment), from hoisting it; eager ops neither merge nor move."""
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


for _t in ("reshape", "reshape2"):
    register_op(_t, infer_shape=_reshape_infer, lower=_reshape_lower,
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


for _t in ("transpose", "transpose2"):
    register_op(_t, infer_shape=_transpose_infer, lower=_transpose_lower,
                grad="generic", vjp=_transpose_vjp)


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


for _t in ("unsqueeze", "unsqueeze2"):
    register_op(_t, infer_shape=_unsqueeze_infer, lower=_unsqueeze_lower,
                grad="generic")


def _squeeze_axes(shape, axes):
    if axes:
        drop = {a % len(shape) for a in axes}
        return [d for i, d in enumerate(shape) if i not in drop]
    return [d for d in shape if d != 1]


def _squeeze_infer(op_, block):
    v = in_var(op_, block, "X")
    if v is None:
        raise SkipInferShape()
    set_out(op_, block, "Out", _squeeze_axes(list(v.shape),
                                             op_.attr("axes", [])), v.dtype)
    if op_.output("XShape"):
        set_out(op_, block, "XShape", (0,) + tuple(v.shape), v.dtype)


def _squeeze_lower(ctx, op_):
    x = ctx.in1(op_, "X")
    ctx.out(op_, "Out", x.reshape(_squeeze_axes(list(x.shape),
                                                op_.attr("axes", []))))
    if op_.output("XShape"):
        ctx.out(op_, "XShape", _empty_like_shape(x))


for _t in ("squeeze", "squeeze2"):
    register_op(_t, infer_shape=_squeeze_infer, lower=_squeeze_lower,
                grad="generic")


def _flatten_infer(op_, block):
    v = in_var(op_, block, "X")
    if v is None:
        raise SkipInferShape()
    ax = int(op_.attr("axis", 1))
    shape = list(v.shape)
    if all(s >= 0 for s in shape):
        out = [int(np.prod(shape[:ax])) if ax else 1,
               int(np.prod(shape[ax:]))]
    else:
        out = [-1, -1]
    set_out(op_, block, "Out", out, v.dtype)
    if op_.output("XShape"):
        set_out(op_, block, "XShape", (0,) + tuple(v.shape), v.dtype)


def _flatten_lower(ctx, op_):
    """``tensor_ops.py:355``: X as 2-D, the dims before ``axis`` in the
    rows and the rest in the columns."""
    x = ctx.in1(op_, "X")
    ax = int(op_.attr("axis", 1))
    lead = int(np.prod(x.shape[:ax])) if ax else 1
    ctx.out(op_, "Out", x.reshape(lead, -1))
    if op_.output("XShape"):
        ctx.out(op_, "XShape", _empty_like_shape(x))


for _t in ("flatten", "flatten2"):
    register_op(_t, infer_shape=_flatten_infer, lower=_flatten_lower,
                grad="generic")


def _concat_infer(op_, block):
    vs = [block._find_var_recursive(n) for n in op_.input("X")]
    if any(v is None for v in vs):
        raise SkipInferShape()
    ax = int(op_.attr("axis", 0))
    shape = list(vs[0].shape)
    if shape and all(v.shape for v in vs):
        shape[ax] = sum(v.shape[ax] for v in vs)
    set_out(op_, block, "Out", shape, vs[0].dtype)


@op("concat", infer_shape=_concat_infer, grad="generic")
def _concat(ctx, op_):
    """``tensor_ops.py:388``: X joined along ``axis``."""
    xs = ctx.ins(op_, "X")
    ctx.out(op_, "Out", torch.cat(xs, dim=int(op_.attr("axis", 0))))


def _split_infer(op_, block):
    x = in_var(op_, block, "X")
    if x is None or not x.shape:
        raise SkipInferShape()
    ax = int(op_.attr("axis", 0)) % len(x.shape)
    sections = op_.attr("sections", [])
    num = int(op_.attr("num", 0))
    dim = x.shape[ax]
    for i in range(len(op_.outputs.get("Out") or [])):
        d = int(sections[i]) if sections else (
            dim // num if dim >= 0 else -1)
        set_out(op_, block, "Out", tuple(
            d if j == ax else s for j, s in enumerate(x.shape)), x.dtype,
            idx=i)


@op("split", infer_shape=_split_infer, grad="generic")
def _split(ctx, op_):
    """``tensor_ops.py:421``: X cut along ``axis`` into ``sections`` or
    ``num`` equal parts."""
    x = ctx.in1(op_, "X")
    ax = int(op_.attr("axis", 0))
    sections = op_.attr("sections", [])
    if sections:
        outs = torch.split(x, [int(n) for n in sections], dim=ax)
    else:
        outs = torch.chunk(x, int(op_.attr("num", 0)), dim=ax)
    ctx.outs(op_, "Out", list(outs))


def _expand_infer(op_, block):
    v = in_var(op_, block, "X")
    if v is None:
        raise SkipInferShape()
    times = op_.attr("expand_times", [])
    set_out(op_, block, "Out", [d * t if d >= 0 else -1
                                for d, t in zip(v.shape, times)], v.dtype)


@op("expand", infer_shape=_expand_infer, grad="generic")
def _expand(ctx, op_):
    """``tensor_ops.py:464``: X tiled ``expand_times`` along each dim."""
    ctx.out(op_, "Out", ctx.in1(op_, "X").repeat(
        *[int(t) for t in op_.attr("expand_times")]))


@op("gather", grad="generic")
def _gather(ctx, op_):
    """``tensor_ops.py:493``: rows of X at Index."""
    x = ctx.in1(op_, "X")
    ctx.out(op_, "Out", x[ctx.in1(op_, "Index").reshape(-1).long()])


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
    if op_.type == "lookup_table" and id_shape and id_shape[-1] == 1:
        id_shape = id_shape[:-1]
    set_out(op_, block, "Out", tuple(id_shape) + (w.shape[-1],), w.dtype)


def _lookup_table(ctx, op_):
    """Rows of W at Ids ([..., 1] int ids for ``lookup_table``, any shape
    for ``lookup_table_v2``; the port keeps int64, where the reference's
    JAX runs them as int32). Rows at ``padding_idx`` read 0."""
    w = ctx.in1(op_, "W")
    ids = ctx.in1(op_, "Ids")
    if op_.type == "lookup_table" and ids.dim() and ids.shape[-1] == 1:
        ids = ids.reshape(ids.shape[:-1])
    out = F.embedding(ids, w)
    padding_idx = int(op_.attr("padding_idx", -1))
    if padding_idx != -1:
        if padding_idx < 0:
            padding_idx += w.shape[0]
        out = out * (ids != padding_idx).unsqueeze(-1).to(out.dtype)
    ctx.out(op_, "Out", out)


for _t in ("lookup_table", "lookup_table_v2"):
    register_op(_t, infer_shape=_lookup_table_infer, lower=_lookup_table,
                grad="generic")


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


def _one_hot(ctx, op_):
    """fp32 [..., depth] rows of ids X ([..., 1] or [...] for ``one_hot``;
    any shape, the trailing 1 kept, for ``one_hot_v2``, whose depth may
    come from ``depth_tensor``, read on the host); an id outside
    [0, depth) gives a row of zeros, with or without
    ``allow_out_of_range``, as the reference's ``jax.nn.one_hot``
    (``tensor_ops.py:562``, ``:734``)."""
    x = ctx.in1(op_, "X")
    depth = int(op_.attr("depth", -1))
    if op_.input("depth_tensor"):
        depth = int(ctx.host_values(op_, "depth_tensor")[0])
    if op_.type == "one_hot" and x.dim() and x.shape[-1] == 1:
        x = x.reshape(x.shape[:-1])
    x = x.long()
    inside = (x >= 0) & (x < depth)
    out = torch.zeros(tuple(x.shape) + (depth,), dtype=torch.float32,
                      device=x.device)
    out.scatter_(-1, x.clamp(0, depth - 1).unsqueeze(-1),
                 inside.unsqueeze(-1).to(torch.float32))
    ctx.out(op_, "Out", out)


def _one_hot_v2_infer(op_, block):
    v = in_var(op_, block, "X")
    if v is None:
        raise SkipInferShape()
    set_out(op_, block, "Out", list(v.shape) + [int(op_.attr("depth", -1))],
            core.VarDesc.VarType.FP32)


register_op("one_hot", infer_shape=_one_hot_infer, lower=_one_hot)
register_op("one_hot_v2", infer_shape=_one_hot_v2_infer, lower=_one_hot)


# -- creation (``tensor_ops.py:101-135``, ``:672-748``) ---------------------
@op("range")
def _range(ctx, op_):
    """``tensor_ops.py:101``: Start + Step·[0, n) with n =
    ⌊(End − Start)/Step⌋; n is read on the host (``host_values``), the
    values are computed on the device from the tensors."""
    start = ctx.in1(op_, "Start").reshape(())
    step = ctx.in1(op_, "Step").reshape(())
    lo = float(ctx.host_values(op_, "Start")[0])
    hi = float(ctx.host_values(op_, "End")[0])
    by = float(ctx.host_values(op_, "Step")[0])
    n = int(np.floor((hi - lo) / by))
    ctx.out(op_, "Out", start + step * torch.arange(
        n, dtype=start.dtype, device=start.device))


@op("fill_zeros_like", infer_shape=same_shape_infer("X"))
def _fill_zeros_like(ctx, op_):
    ctx.out(op_, "Out", torch.zeros_like(ctx.in1(op_, "X")))


@op("fill_any_like", infer_shape=same_shape_infer("X"))
def _fill_any_like(ctx, op_):
    """``tensor_ops.py:135``: ``value`` in X's shape, in ``dtype`` (-1:
    X's)."""
    x = ctx.in1(op_, "X")
    dt = op_.attr("dtype", -1)
    dtype = x.dtype if dt in (-1, None) else _dtype(dt)
    ctx.out(op_, "Out", torch.full(x.shape, op_.attr("value", 0.0),
                                   dtype=dtype, device=x.device))


@op("fill")
def _fill(ctx, op_):
    """``tensor_ops.py:702``: the attr ``value`` list reshaped to
    ``shape``."""
    vals = np.asarray(op_.attr("value", []), np.float64)
    shape = [int(s) for s in op_.attr("shape", [])]
    ctx.out(op_, "Out", torch.as_tensor(
        vals.reshape(shape), dtype=_dtype(op_.attr("dtype"))
    ).to(ctx.device))


@op("fill_zeros_like2", infer_shape=same_shape_infer("X"))
def _fill_zeros_like2(ctx, op_):
    x = ctx.in1(op_, "X")
    dt = op_.attr("dtype", None)
    ctx.out(op_, "Out", torch.zeros(
        x.shape, dtype=x.dtype if dt is None else _dtype(dt),
        device=x.device))


@op("linspace")
def _linspace(ctx, op_):
    """``tensor_ops.py:672``: ``Num`` points from Start to Stop, both
    ends included; ``Num`` read on the host, the points computed on the
    device, the last one Stop exactly."""
    start = ctx.in1(op_, "Start").reshape(())
    stop = ctx.in1(op_, "Stop").reshape(())
    num = int(ctx.host_values(op_, "Num")[0])
    if num == 1:
        out = start.reshape(1)
    else:
        i = torch.arange(num, dtype=start.dtype, device=start.device)
        out = start + i * ((stop - start) / (num - 1))
        out = torch.cat([out[:-1], stop.reshape(1).to(out.dtype)])
    ctx.out(op_, "Out", out)


@op("diag")
def _diag(ctx, op_):
    """``tensor_ops.py:682``: the square matrix with Diagonal on its
    diagonal."""
    ctx.out(op_, "Out", torch.diag(ctx.in1(op_, "Diagonal")))


@op("eye")
def _eye(ctx, op_):
    rows = int(op_.attr("num_rows"))
    cols = int(op_.attr("num_columns", -1))
    ctx.out(op_, "Out", torch.eye(
        rows, rows if cols < 0 else cols,
        dtype=_dtype(op_.attr("dtype", core.VarDesc.VarType.FP32)),
        device=ctx.device))


@op("gaussian_random_batch_size_like")
def _gaussian_random_bsl(ctx, op_):
    """``tensor_ops.py:748``: N(mean, std) of ``shape`` with dim
    ``output_dim_idx`` taken from Input's ``input_dim_idx``."""
    ref = ctx.in1(op_, "Input")
    shape = [int(s) for s in op_.attr("shape", [])]
    shape[int(op_.attr("output_dim_idx", 0))] = ref.shape[
        int(op_.attr("input_dim_idx", 0))]
    out = torch.empty(shape, dtype=_dtype(op_.attr("dtype")),
                      device=ctx.device)
    ctx.out(op_, "Out", out.normal_(float(op_.attr("mean", 0.0)),
                                    float(op_.attr("std", 1.0)),
                                    generator=ctx.generator(op_)))


# -- shape and index --------------------------------------------------------
@op("share_data", infer_shape=same_shape_infer("X"), grad="generic")
def _share_data(ctx, op_):
    ctx.out(op_, "Out", ctx.in1(op_, "X"))


@op("shape")
def _shape(ctx, op_):
    """``tensor_ops.py:512``: Input's shape as int32 [rank], made from
    the tensor's own metadata (no read of the card)."""
    x = ctx.in1(op_, "Input")
    ctx.out(op_, "Out", torch.tensor(list(x.shape), dtype=torch.int32,
                                     device=ctx.device))


@op("size")
def _size(ctx, op_):
    """``tensor_ops.py:722``: Input's element count, an int64 scalar
    (the layer's declared type; the reference's JAX gives int32), from
    the tensor's metadata."""
    x = ctx.in1(op_, "Input")
    ctx.out(op_, "Out", torch.tensor(x.numel(), dtype=torch.int64,
                                     device=ctx.device))


def _arg_infer(op_, block):
    v = in_var(op_, block, "X")
    if v is None or not v.shape:
        raise SkipInferShape()
    ax = int(op_.attr("axis", -1)) % len(v.shape)
    set_out(op_, block, "Out", [d for i, d in enumerate(v.shape) if i != ax],
            core.VarDesc.VarType.INT64)


@op("arg_max", infer_shape=_arg_infer)
def _arg_max(ctx, op_):
    """``tensor_ops.py:573``: the index of the largest entry along
    ``axis`` (the first of equal ones), int64 as the desc declares."""
    ctx.out(op_, "Out", torch.argmax(ctx.in1(op_, "X"),
                                     dim=int(op_.attr("axis", -1))))


@op("arg_min", infer_shape=_arg_infer)
def _arg_min(ctx, op_):
    ctx.out(op_, "Out", torch.argmin(ctx.in1(op_, "X"),
                                     dim=int(op_.attr("axis", -1))))


@op("argsort")
def _argsort(ctx, op_):
    """``tensor_ops.py:661``: X sorted ascending along ``axis`` (equal
    entries in their order) and the int64 indices."""
    vals, idx = torch.sort(ctx.in1(op_, "X"), dim=int(op_.attr("axis", -1)),
                           stable=True)
    ctx.out(op_, "Out", vals)
    ctx.out(op_, "Indices", idx)


@op("where_index")
def _where_index(ctx, op_):
    """``tensor_ops.py:600``: the int64 [n, rank] coordinates of the
    nonzero entries of Condition. n depends on the data: the count is
    read on the host (``op_host_reads``). The reference's JAX cannot
    give a shape from data and raises."""
    cond = ctx.in1(op_, "Condition")
    if cond.device.type == "meta":
        raise SkipInferShape()
    profiler.bump_counter(HOST_READ_COUNTER)
    ctx.out(op_, "Out", torch.nonzero(cond))


def _any_infer(op_, block):
    set_out(op_, block, "Out", (1,), core.VarDesc.VarType.BOOL)


@op("isinf", infer_shape=_any_infer)
def _isinf(ctx, op_):
    """``tensor_ops.py:645``: one bool [1], any entry of X infinite."""
    ctx.out(op_, "Out", torch.isinf(ctx.in1(op_, "X")).any().reshape((1,)))


@op("isnan", infer_shape=_any_infer)
def _isnan(ctx, op_):
    ctx.out(op_, "Out", torch.isnan(ctx.in1(op_, "X")).any().reshape((1,)))


# -- data movement ----------------------------------------------------------
@op("stack", grad="generic")
def _stack(ctx, op_):
    ctx.out(op_, "Y", torch.stack(ctx.ins(op_, "X"),
                                  dim=int(op_.attr("axis", 0))))


@op("unstack", grad="generic")
def _unstack(ctx, op_):
    ctx.outs(op_, "Y", list(torch.unbind(ctx.in1(op_, "X"),
                                         dim=int(op_.attr("axis", 0)))))


@op("scatter", grad="generic")
def _scatter(ctx, op_):
    """``tensor_ops.py:500``: X with its rows at Ids set to Updates
    (``overwrite``), or Updates added to them."""
    x = ctx.in1(op_, "X")
    ids = ctx.in1(op_, "Ids").reshape(-1).long()
    upd = ctx.in1(op_, "Updates")
    if op_.attr("overwrite", True):
        out = x.index_put((ids,), upd)
    else:
        out = x.index_add(0, ids, upd)
    ctx.out(op_, "Out", out)


@op("pad", grad="generic")
def _pad(ctx, op_):
    """``tensor_ops.py:608``: X padded by ``paddings`` (before, after
    for each dim) with ``pad_value``."""
    x = ctx.in1(op_, "X")
    p = [int(v) for v in op_.attr("paddings")]
    pairs = []
    for i in reversed(range(x.dim())):
        pairs += [p[2 * i], p[2 * i + 1]]
    ctx.out(op_, "Out", F.pad(x, pairs,
                              value=float(op_.attr("pad_value", 0.0))))


_PAD2D_MODES = {"constant": "constant", "reflect": "reflect",
                "edge": "replicate"}


@op("pad2d", grad="generic")
def _pad2d(ctx, op_):
    """``tensor_ops.py:619``: the H and W dims of X padded by
    ``paddings`` [top, bottom, left, right]: ``constant`` (``pad_value``),
    ``reflect`` or ``edge``, NCHW or NHWC."""
    x = ctx.in1(op_, "X")
    p = [int(v) for v in op_.attr("paddings")]
    nhwc = op_.attr("data_format", "NCHW") == "NHWC"
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    mode = _PAD2D_MODES[op_.attr("mode", "constant")]
    pads = (p[2], p[3], p[0], p[1])
    if mode == "constant":
        out = F.pad(x, pads, value=float(op_.attr("pad_value", 0.0)))
    else:
        out = F.pad(x, pads, mode=mode)
    ctx.out(op_, "Out", out.permute(0, 2, 3, 1) if nhwc else out)


@op("reverse", grad="generic")
def _reverse(ctx, op_):
    ctx.out(op_, "Out", torch.flip(ctx.in1(op_, "X"),
                                   [int(a) for a in op_.attr("axis")]))


# -- the rest ---------------------------------------------------------------
@op("random_crop")
def _random_crop(ctx, op_):
    """``tensor_ops.py:764``: each sample's trailing ``len(shape)`` dims
    cropped to ``shape`` at offsets drawn from the op's generator, on the
    device (one gather, no read of the offsets)."""
    x = ctx.in1(op_, "X")
    crop = [int(s) for s in op_.attr("shape", [])]
    k = len(crop)
    lead = x.dim() - k
    flat = x.reshape((-1,) + tuple(x.shape[lead:]))
    n = flat.shape[0]
    maxoff = torch.tensor([x.shape[lead + i] - crop[i] + 1 for i in range(k)],
                          device=x.device)
    u = torch.rand((n, k), generator=ctx.generator(op_), device=x.device)
    off = torch.minimum((u * maxoff).long(), maxoff - 1)
    index = [torch.arange(n, device=x.device).reshape((n,) + (1,) * k)]
    for i in range(k):
        shape = [1] * (k + 1)
        shape[1 + i] = crop[i]
        index.append((off[:, i].reshape((n,) + (1,) * k) + torch.arange(
            crop[i], device=x.device).reshape(shape)))
    out = flat[tuple(index)]
    ctx.out(op_, "Out", out.reshape(tuple(x.shape[:lead]) + tuple(crop)))


@op("tensor_array_to_tensor")
def _tensor_array_to_tensor(ctx, op_):
    """``tensor_ops.py:791``: a LoD array (the stacked [T, ...] tensor)
    joined along ``axis`` (``use_stack``: stacked there), and each
    step's extent along it as int32 ``OutIndex``; sizes come from the
    array's shape, so nothing is read on the host."""
    arr = ctx.in1(op_, "X")
    axis = int(op_.attr("axis", 0))
    n = arr.shape[0]
    if op_.attr("use_stack", False):
        out = torch.movedim(arr, 0, axis)
        sizes = [1] * n
    else:
        out = torch.cat(list(torch.unbind(arr, 0)), dim=axis)
        sizes = [arr.shape[1 + axis]] * n
    ctx.out(op_, "Out", out)
    ctx.out(op_, "OutIndex", torch.tensor(sizes, dtype=torch.int32,
                                          device=arr.device))
