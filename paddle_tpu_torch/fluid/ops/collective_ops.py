"""Collective ops over ``torch.distributed`` (port of
``paddle_tpu/fluid/ops/collective_ops.py``).

Reference: ``paddle/fluid/operators/collective/`` (``c_allreduce_op.h``
runs ``ncclAllReduce`` on the ring keyed by ``ring_id``;
``c_broadcast``, ``c_allgather``, ``c_reducescatter``, the stream syncs,
and the ``c_comm_init`` / ``c_gen_nccl_id`` bootstrap). The JAX package
lowers each to an XLA collective over a mesh axis inside ``shard_map``.
Here each rank is a process: ``ring_id`` picks a ``ProcessGroup``
(``parallel.mesh.CommContext``), and each op calls the one
``torch.distributed`` collective that computes it. A process in no world
(a world of one), and the shape inference's meta tensors, see the
identity, as the reference's lowering does outside a mesh.

The collectives have no autograd, so each lowering goes through a
``torch.autograd.Function`` whose backward is the matching collective
(the transpose the reference's generic grad takes through ``lax``):
an all-reduce sum's is the all-reduce sum of the cotangent; an
all-gather's the reduce-scatter sum; a reduce-scatter's the all-gather;
a broadcast's the sum, kept on the root; max and min send the summed
cotangent to the ranks that hold the extreme (split evenly between
ties); a product sends each rank the summed cotangent times the other
ranks' factors.

The collectives run in the order of the current stream (NCCL's own
stream waits on it and the result is waited for before the op returns;
gloo stages CUDA tensors through host memory inside the call), so
``c_sync_calc_stream`` and ``c_sync_comm_stream`` are identities, as
they are in the reference. Both backends take the same calls:
``all_reduce`` (sum, max, min, product), ``broadcast``,
``all_gather_into_tensor``, ``reduce_scatter_tensor`` and
``all_to_all_single`` carry CUDA tensors over gloo as well as NCCL. A
backend that lacks one raises from ``torch.distributed`` with its name;
no route falls back to another backend or to the CPU.
"""

import torch

from ...parallel.mesh import CommContext
from .registry import op, same_shape_infer


def _dist():
    import torch.distributed as dist

    return dist


def group_for(ctx, ring_id=0):
    """The ProcessGroup an op on ``ring_id`` runs over; None for the
    identity (no world, or shape inference on meta tensors)."""
    if ctx.device.type == "meta":
        return None
    return CommContext.instance().group(ring_id)


def _op_group(ctx, op_):
    return group_for(ctx, op_.attr("ring_id", 0))


def _group_rank(group):
    return _dist().get_rank(group)


def _sum(t, group):
    out = t.contiguous().clone()
    _dist().all_reduce(out, group=group)
    return out


class AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _AllReduceExtreme(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, reduce_op):
        out = x.contiguous().clone()
        _dist().all_reduce(out, op=reduce_op, group=group)
        ctx.group = group
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        hit = (x == out).to(g.dtype)
        return _sum(g, ctx.group) * hit / _sum(hit, ctx.group), None, None


def _all_gather(x, group):
    n = _dist().get_world_size(group)
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    _dist().all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def _reduce_scatter(x, group):
    n = _dist().get_world_size(group)
    if x.shape[0] % n:
        raise ValueError("c_reducescatter: dim 0 (%d) is not a multiple of "
                         "the ring's %d ranks" % (x.shape[0], n))
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    _dist().reduce_scatter_tensor(out, x.contiguous(), group=group)
    return out


class _AllReduceProd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        _dist().all_reduce(out, op=_dist().ReduceOp.PRODUCT, group=group)
        ctx.group = group
        ctx.save_for_backward(x)
        return out

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        group = ctx.group
        n = _dist().get_world_size(group)
        r = _group_rank(group)
        stack = _all_gather(x.reshape((1,) + tuple(x.shape)), group)
        others = torch.cat([stack[:r], stack[r + 1:]]).prod(0) if n > 1 \
            else torch.ones_like(x)
        return _sum(g, group) * others, None


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, root):
        out = x.contiguous().clone()
        _dist().broadcast(out, src=_dist().get_global_rank(group, root),
                          group=group)
        ctx.group, ctx.root = group, root
        return out

    @staticmethod
    def backward(ctx, g):
        total = _sum(g, ctx.group)
        if _group_rank(ctx.group) != ctx.root:
            total = torch.zeros_like(total)
        return total, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce_scatter(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group), None


def allreduce_sum(x, group):
    """Differentiable all-reduce sum of ``x`` over ``group`` (None: the
    identity)."""
    return x if group is None else AllReduceSum.apply(x, group)


def _register_allreduce(name, reduce):
    def lower(ctx, op_, _reduce=reduce):
        x = ctx.in1(op_, "X")
        group = _op_group(ctx, op_)
        ctx.out(op_, "Out", x if group is None else _reduce(x, group))

    op(name, infer_shape=same_shape_infer("X"), grad="generic")(lower)


def _extreme(name):
    def reduce(x, group):
        return _AllReduceExtreme.apply(x, group,
                                       getattr(_dist().ReduceOp, name))

    return reduce


@op("c_allreduce_sum", infer_shape=same_shape_infer("X"), grad="generic")
def _c_allreduce_sum(ctx, op_):
    """c_allreduce_sum, with the int8-wire path: ``quantized_allreduce``
    routes sums on ring 0 (the gradient allreduce) through
    ``parallel/quantized_allreduce.py``; sums on other rings stay exact.
    Its gradient is straight through, the exact sum's."""
    from .. import flags as _flags

    x = ctx.in1(op_, "X")
    group = _op_group(ctx, op_)
    if group is not None:
        if int(op_.attr("ring_id", 0)) == 0 and _flags.get_flag(
                "quantized_allreduce", False):
            from ...parallel.quantized_allreduce import quantized_psum

            x = quantized_psum(x, group)
        else:
            x = AllReduceSum.apply(x, group)
    ctx.out(op_, "Out", x)


_register_allreduce("c_allreduce_max", _extreme("MAX"))
_register_allreduce("c_allreduce_min", _extreme("MIN"))
_register_allreduce("c_allreduce_prod", _AllReduceProd.apply)
_register_allreduce("allreduce", AllReduceSum.apply)


@op("c_broadcast", infer_shape=same_shape_infer("X"), grad="generic")
def _c_broadcast(ctx, op_):
    x = ctx.in1(op_, "X")
    group = _op_group(ctx, op_)
    if group is not None:
        x = _Broadcast.apply(x, group, int(op_.attr("root", 0)))
    ctx.out(op_, "Out", x)


@op("broadcast", infer_shape=same_shape_infer("X"), grad="generic")
def _broadcast_op(ctx, op_):
    _c_broadcast(ctx, op_)


@op("c_allgather", grad="generic")
def _c_allgather(ctx, op_):
    """Every rank's X joined on dim 0, in rank order."""
    x = ctx.in1(op_, "X")
    group = _op_group(ctx, op_)
    ctx.out(op_, "Out", x if group is None else _AllGather.apply(x, group))


@op("c_reducescatter", grad="generic")
def _c_reducescatter(ctx, op_):
    """The sum over the ranks, split on dim 0: rank k keeps block k."""
    x = ctx.in1(op_, "X")
    group = _op_group(ctx, op_)
    ctx.out(op_, "Out",
            x if group is None else _ReduceScatter.apply(x, group))


# The collectives run in the current stream's order: the syncs are
# identities.
@op("c_sync_calc_stream", infer_shape=same_shape_infer("X"))
def _c_sync_calc_stream(ctx, op_):
    ctx.out(op_, "Out", ctx.in1(op_, "X"))


@op("c_sync_comm_stream", infer_shape=same_shape_infer("X"))
def _c_sync_comm_stream(ctx, op_):
    ctx.out(op_, "Out", ctx.in1(op_, "X"))


# Bootstrap ops: the world starts from the launcher's env
# (``parallel.initialize_distributed``), before any program runs.
# ``c_comm_init`` makes its ring's group, so a transpiled startup program
# creates every ring on every rank in the same order.
@op("c_comm_init")
def _c_comm_init(ctx, op_):
    group_for(ctx, op_.attr("ring_id", 0))


@op("c_comm_init_all")
def _c_comm_init_all(ctx, op_):
    pass


@op("c_gen_nccl_id")
def _c_gen_nccl_id(ctx, op_):
    pass


@op("gen_nccl_id")
def _gen_nccl_id(ctx, op_):
    pass
