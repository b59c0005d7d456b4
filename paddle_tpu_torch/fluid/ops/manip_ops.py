"""Tensor-manipulation ops (port of ``paddle_tpu/fluid/ops/manip_ops.py``):
indexing and scattering, slicing and cropping, the layout shuffles, the
norms, ``spectral_norm`` and ``grid_sampler``. ``unique`` and
``unique_with_counts`` size their outputs from the data: on the card one
read of the count (``op_host_reads``), as the reference runs them on the
host. Index outputs are int64, as the reference's desc declares them."""

import torch
import torch.nn.functional as F

from .. import profiler
from .registry import (HOST_READ_COUNTER, SkipInferShape, in_var, op,
                       same_shape_infer, set_out)

__all__ = ["strided_slice", "grid_sampler", "spectral_norm"]


def _index_tuple(idx):
    idx = idx.long()
    return tuple(idx[..., i] for i in range(idx.shape[-1]))


def _gather_nd_infer(op_, block):
    x = in_var(op_, block, "X")
    idx = in_var(op_, block, "Index")
    if x is None or idx is None:
        raise SkipInferShape()
    k = int(idx.shape[-1])
    set_out(op_, block, "Out", tuple(idx.shape[:-1]) + tuple(x.shape[k:]),
            x.dtype)


@op("gather_nd", infer_shape=_gather_nd_infer, grad="generic")
def _gather_nd(ctx, op_):
    """``manip_ops.py:41``: X at each Index row's leading coordinates."""
    ctx.out(op_, "Out", ctx.in1(op_, "X")[_index_tuple(
        ctx.in1(op_, "Index"))])


@op("scatter_nd_add", infer_shape=same_shape_infer("X"), grad="generic")
def _scatter_nd_add(ctx, op_):
    """``manip_ops.py:55``: X plus Updates at Index's coordinates,
    repeated coordinates summed."""
    ctx.out(op_, "Out", ctx.in1(op_, "X").index_put(
        _index_tuple(ctx.in1(op_, "Index")), ctx.in1(op_, "Updates"),
        accumulate=True))


@op("scatter_nd", grad="generic")
def _scatter_nd(ctx, op_):
    """``manip_ops.py:64``: ``scatter_nd_add`` into zeros of ``shape``."""
    upd = ctx.in1(op_, "Updates")
    zeros = upd.new_zeros([int(s) for s in op_.attr("shape")])
    ctx.out(op_, "Out", zeros.index_put(_index_tuple(ctx.in1(op_, "Index")),
                                        upd, accumulate=True))


def strided_slice(x, axes, starts, ends, strides):
    """``manip_ops.py:76``: numpy's x[s:e:st] on each axis, negative
    strides too (torch slicing takes none: those axes gather)."""
    for a, s, e, st in zip(axes, starts, ends, strides):
        a = int(a) % x.dim()
        s, e, st = int(s), int(e), int(st)
        if st > 0:
            x = x[(slice(None),) * a + (slice(s, e, st),)]
        else:
            idx = range(*slice(s, e, st).indices(x.shape[a]))
            x = x.index_select(a, torch.tensor(list(idx), dtype=torch.long,
                                               device=x.device))
    return x


@op("strided_slice", grad="generic")
def _strided_slice(ctx, op_):
    axes = [int(a) for a in op_.attr("axes")]
    ctx.out(op_, "Out", strided_slice(
        ctx.in1(op_, "Input"), axes, op_.attr("starts"), op_.attr("ends"),
        op_.attr("strides") or [1] * len(axes)))


@op("expand_as", grad="generic")
def _expand_as(ctx, op_):
    """``manip_ops.py:89``: X tiled to ``target_tensor``'s (or Y's)
    shape."""
    x = ctx.in1(op_, "X")
    y = ctx.in1(op_, "target_tensor", optional=True)
    if y is None:
        y = ctx.in1(op_, "Y")
    ctx.out(op_, "Out", x.repeat([t // s for t, s in zip(y.shape, x.shape)]))


@op("multiplex", grad="generic")
def _multiplex(ctx, op_):
    """``manip_ops.py:101``: row b of Out is row b of X[Ids[b]]."""
    ids = ctx.in1(op_, "Ids").reshape(-1).long()
    xs = torch.stack(ctx.ins(op_, "X"), 0)
    ctx.out(op_, "Out", xs[ids, torch.arange(xs.shape[1], device=xs.device)])


def _window(x, offsets, shape):
    """x[o:o + n] on every axis, each start clamped into [0, dim − n] as
    ``lax.dynamic_slice`` clamps it; ``offsets`` ints, or a tensor read on
    the device (no host wait)."""
    if isinstance(offsets, torch.Tensor):
        off = offsets.reshape(-1).long()
        for a, n in enumerate(shape):
            start = off[a].clamp(0, x.shape[a] - n)
            x = x.index_select(a, start + torch.arange(n, device=x.device))
        return x
    for a, (o, n) in enumerate(zip(offsets, shape)):
        x = x.narrow(a, min(max(int(o), 0), x.shape[a] - n), n)
    return x


@op("crop", grad="generic")
def _crop(ctx, op_):
    """``manip_ops.py:121``: X's window of Y's shape (or ``shape``) at
    Offsets (or ``offsets``)."""
    x = ctx.in1(op_, "X")
    offsets = ctx.in1(op_, "Offsets", optional=True)
    if offsets is None:
        offsets = [int(v) for v in (op_.attr("offsets") or [0] * x.dim())]
    y = ctx.in1(op_, "Y", optional=True)
    shape = list(y.shape) if y is not None else [
        int(s) for s in op_.attr("shape")]
    ctx.out(op_, "Out", _window(x, offsets, shape))


@op("crop_tensor", grad="generic")
def _crop_tensor(ctx, op_):
    """``manip_ops.py:139``: X's window of Shape (or ``shape``; −1 runs to
    the end) at Offsets (or ``offsets``). A Shape tensor sizes the output
    and is read on the host, as are Offsets under a −1."""
    x = ctx.in1(op_, "X")
    if ctx.in1(op_, "Shape", optional=True) is not None:
        shape = [int(s) for s in ctx.host_values(op_, "Shape")]
    else:
        shape = [int(s) for s in op_.attr("shape")]
    offsets = ctx.in1(op_, "Offsets", optional=True)
    if offsets is None:
        offsets = [int(v) for v in (op_.attr("offsets") or [0] * x.dim())]
    elif any(s == -1 for s in shape):
        offsets = [int(v) for v in ctx.host_values(op_, "Offsets")]
    if not isinstance(offsets, torch.Tensor):
        shape = [x.shape[i] - offsets[i] if s == -1 else s
                 for i, s in enumerate(shape)]
    ctx.out(op_, "Out", _window(x, offsets, shape))


@op("pad_constant_like", grad="generic")
def _pad_constant_like(ctx, op_):
    """``manip_ops.py:178``: Y padded after its end to X's shape with
    ``pad_value``."""
    x = ctx.in1(op_, "X")
    y = ctx.in1(op_, "Y")
    pads = []
    for xs, ys in reversed(list(zip(x.shape, y.shape))):
        pads += [0, int(xs - ys)]
    ctx.out(op_, "Out", F.pad(y, pads, value=float(op_.attr("pad_value",
                                                            0.0))))


def _unique(ctx, op_, counts):
    """``manip_ops.py:186-211``: X's sorted distinct values (its dtype),
    the int64 index of each entry's value in them (X's shape) and, with
    ``counts``, the int64 count of each. The output's size comes from
    the data: one read on the card, counted."""
    x = ctx.in1(op_, "X")
    if x.device.type == "meta":
        raise SkipInferShape()
    profiler.bump_counter(HOST_READ_COUNTER)
    out, index, count = torch.unique(x, sorted=True, return_inverse=True,
                                     return_counts=True)
    ctx.out(op_, "Out", out)
    ctx.out(op_, "Index", index.reshape(x.shape).long())
    if counts:
        ctx.out(op_, "Count", count.long())


@op("unique")
def _unique_op(ctx, op_):
    _unique(ctx, op_, False)


@op("unique_with_counts")
def _unique_with_counts_op(ctx, op_):
    _unique(ctx, op_, True)


@op("shard_index")
def _shard_index(ctx, op_):
    """``manip_ops.py:214``: an id of shard ``shard_id`` (size
    ⌈index_num/nshards⌉) becomes its offset in the shard, any other id
    ``ignore_value``."""
    x = ctx.in1(op_, "X")
    nshards = int(op_.attr("nshards"))
    size = (int(op_.attr("index_num")) + nshards - 1) // nshards
    in_shard = torch.div(x, size, rounding_mode="floor") == int(
        op_.attr("shard_id"))
    ctx.out(op_, "Out", torch.where(
        in_shard, torch.remainder(x, size),
        torch.full_like(x, int(op_.attr("ignore_value", -1)))))


@op("space_to_depth", grad="generic")
def _space_to_depth(ctx, op_):
    """``manip_ops.py:233``: NCHW blocks of b × b to channels, Paddle's
    order: channel (i·b + j)·C + c holds (c, h·b + i, w·b + j)."""
    x = ctx.in1(op_, "X")
    b = int(op_.attr("blocksize"))
    N, C, H, W = x.shape
    out = x.reshape(N, C, H // b, b, W // b, b).permute(0, 3, 5, 1, 2, 4)
    ctx.out(op_, "Out", out.reshape(N, C * b * b, H // b, W // b))


@op("pixel_shuffle", grad="generic")
def _pixel_shuffle(ctx, op_):
    """``manip_ops.py:243``: channels c·r² + i·r + j to pixel
    (h·r + i, w·r + j) of channel c."""
    x = ctx.in1(op_, "X")
    r = int(op_.attr("upscale_factor"))
    N, C, H, W = x.shape
    out = x.reshape(N, C // (r * r), r, r, H, W).permute(0, 1, 4, 2, 5, 3)
    ctx.out(op_, "Out", out.reshape(N, C // (r * r), H * r, W * r))


@op("shuffle_channel", grad="generic")
def _shuffle_channel(ctx, op_):
    """``manip_ops.py:253``: channels as [group, C/group], transposed."""
    x = ctx.in1(op_, "X")
    g = int(op_.attr("group"))
    N, C, H, W = x.shape
    ctx.out(op_, "Out", x.reshape(N, g, C // g, H, W).transpose(1, 2)
            .reshape(N, C, H, W))


@op("temporal_shift", grad="generic")
def _temporal_shift(ctx, op_):
    """``manip_ops.py:262``: X [N·T, C, H, W]: the first ⌊C·ratio⌋
    channels shifted one segment back, the next ⌊2C·ratio⌋ − ⌊C·ratio⌋
    one forward (zeros enter), the rest kept."""
    x = ctx.in1(op_, "X")
    T = int(op_.attr("seg_num"))
    ratio = float(op_.attr("shift_ratio", 0.25))
    NT, C, H, W = x.shape
    c1, c2 = int(C * ratio), int(C * 2 * ratio)
    xt = x.reshape(NT // T, T, C, H, W)
    back = F.pad(xt[:, 1:, :c1], (0, 0, 0, 0, 0, 0, 0, 1))
    fwd = F.pad(xt[:, :-1, c1:c2], (0, 0, 0, 0, 0, 0, 1, 0))
    ctx.out(op_, "Out", torch.cat([back, fwd, xt[:, :, c2:]], 2)
            .reshape(NT, C, H, W))


@op("minus", infer_shape=same_shape_infer("X"), grad="generic")
def _minus(ctx, op_):
    ctx.out(op_, "Out", ctx.in1(op_, "X") - ctx.in1(op_, "Y"))


@op("selu", infer_shape=same_shape_infer("X"), grad="generic")
def _selu(ctx, op_):
    """``manip_ops.py:290``: scale·(x if x > 0 else α(eˣ − 1))."""
    x = ctx.in1(op_, "X")
    scale = float(op_.attr("scale", 1.0507009873554805))
    alpha = float(op_.attr("alpha", 1.6732632423543772))
    ctx.out(op_, "Out", scale * torch.where(x > 0, x,
                                            alpha * (torch.exp(x) - 1.0)))


@op("norm", grad="generic")
def _norm(ctx, op_):
    """``manip_ops.py:303``: X over √(Σx² + ε) along ``axis``, and that
    norm."""
    x = ctx.in1(op_, "X")
    norm = torch.sqrt((x * x).sum(int(op_.attr("axis", -1)), keepdim=True)
                      + float(op_.attr("epsilon", 1e-10)))
    ctx.out(op_, "Out", x / norm)
    ctx.out(op_, "Norm", norm)


@op("l1_norm", grad="generic")
def _l1_norm(ctx, op_):
    ctx.out(op_, "Out", ctx.in1(op_, "X").abs().sum().reshape(1))


@op("affine_channel", grad="generic")
def _affine_channel(ctx, op_):
    """``manip_ops.py:322``: X·scale + bias by channel (NCHW or NHWC)."""
    x = ctx.in1(op_, "X")
    if op_.attr("data_layout", "NCHW") == "NCHW":
        shape = (1, -1) + (1,) * (x.dim() - 2)
    else:
        shape = (1,) * (x.dim() - 1) + (-1,)
    ctx.out(op_, "Out", x * ctx.in1(op_, "Scale").reshape(shape)
            + ctx.in1(op_, "Bias").reshape(shape))


@op("conv_shift", grad="generic")
def _conv_shift(ctx, op_):
    """``manip_ops.py:335``: circular correlation,
    out[b, i] = Σ_j x[b, (i + j − W//2) mod N]·y[b, j]."""
    x = ctx.in1(op_, "X")
    y = ctx.in1(op_, "Y")
    N, W = x.shape[1], y.shape[1]
    i = torch.arange(N, device=x.device)
    out = torch.zeros_like(x)
    for j in range(W):
        out = out + x.index_select(1, (i + j - W // 2) % N) * y[:, j:j + 1]
    ctx.out(op_, "Out", out)


def spectral_norm(w, u, v, dim=0, power_iters=1, eps=1e-12):
    """``spectral_norm`` (``manip_ops.py:354``): W over σ = uᵀ·W_m·v,
    W_m the [W.shape[dim], −1] matrix, after ``power_iters`` power
    iterations v = l2(W_mᵀu), u = l2(W_m v) from (u, v); the gradient
    runs through the iterations, as the reference's. Returns (out, u,
    v)."""
    perm = [dim] + [i for i in range(w.dim()) if i != dim]
    wm = w.permute(perm).reshape(w.shape[dim], -1)

    def l2(a):
        return a / (torch.linalg.vector_norm(a) + eps)

    for _ in range(power_iters):
        v = l2(wm.t() @ u)
        u = l2(wm @ v)
    return w / (u @ (wm @ v)), u, v


@op("spectral_norm", grad="generic")
def _spectral_norm(ctx, op_):
    """U and V are state: the iterated vectors are written back into
    their tensors in place (the reference's ``stateful_inputs``), so the
    iteration goes on from them in the next run."""
    u_in = ctx.in1(op_, "U")
    v_in = ctx.in1(op_, "V")
    power_iters = int(op_.attr("power_iters", 1))
    # values, not the state's storage: the in-place write below must not
    # change what the iteration's pullback saved
    out, u, v = spectral_norm(
        ctx.in1(op_, "Weight"), u_in.reshape(-1).clone(),
        v_in.reshape(-1).clone(), int(op_.attr("dim", 0)),
        power_iters, float(op_.attr("eps", 1e-12)))
    if power_iters > 0:
        with torch.no_grad():
            u_in.copy_(u.reshape(u_in.shape))
            v_in.copy_(v.reshape(v_in.shape))
    ctx.out(op_, "Out", out)


def grid_sampler(x, grid):
    """``grid_sampler`` (``manip_ops.py:394``): X [N, C, H, W] sampled
    bilinearly at Grid [N, Ho, Wo, 2] (x, y in [−1, 1], the corners at
    the edge pixels' centres), zero outside; [N, C, Ho, Wo]."""
    N, _C, H, W = x.shape
    gx = (grid[..., 0] + 1.0) * (W - 1) / 2.0
    gy = (grid[..., 1] + 1.0) * (H - 1) / 2.0
    x0, y0 = torch.floor(gx), torch.floor(gy)
    wx, wy = gx - x0, gy - y0
    b = torch.arange(N, device=x.device).reshape(N, 1, 1)

    def at(yi, xi):
        ok = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        v = x[b, :, yi.clamp(0, H - 1).long(), xi.clamp(0, W - 1).long()]
        return v * ok[..., None].to(x.dtype)

    out = at(y0, x0) * ((1 - wy) * (1 - wx))[..., None] + \
        at(y0, x0 + 1) * ((1 - wy) * wx)[..., None] + \
        at(y0 + 1, x0) * (wy * (1 - wx))[..., None] + \
        at(y0 + 1, x0 + 1) * (wy * wx)[..., None]
    return out.permute(0, 3, 1, 2)


@op("grid_sampler", grad="generic")
def _grid_sampler(ctx, op_):
    ctx.out(op_, "Output", grid_sampler(ctx.in1(op_, "X"),
                                        ctx.in1(op_, "Grid")))

