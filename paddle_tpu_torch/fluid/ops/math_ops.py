"""Math ops the GPT, BERT and vision paths rely on (port of the matching
lowerings in ``paddle_tpu/fluid/ops/math_ops.py``): plain functions on
tensors, which the eager models call, and the registered op lowerings
the Executor runs (elementwise with Fluid's axis broadcast, ``mul``,
``matmul``, reductions, ``softmax``, ``softmax_with_cross_entropy`` with
its grad, ``layer_norm``, ``label_smooth``, and the ``gelu``, ``relu``,
``tanh`` and ``sqrt`` activations with the unary ops the learning-rate
schedules build: ``floor``, ``ceil``, ``exp``, ``cos`` and ``pow``).
These stay PyTorch calls; what matters is that they mean what the
reference's ops mean."""

import math

import torch
import torch.nn.functional as F

from .registry import SkipInferShape, in_var, op, register_op, \
    same_shape_infer, set_out

__all__ = ["layer_norm", "gelu", "softmax",
           "softmax_with_cross_entropy", "softmax_with_cross_entropy_grad"]


def layer_norm(x, weight=None, bias=None, begin_norm_axis=1, epsilon=1e-5):
    """Normalize over the dims from ``begin_norm_axis`` on, with the
    reference's epsilon 1e-5 and biased variance (mean of squares),
    then scale and shift."""
    return F.layer_norm(x, tuple(x.shape[begin_norm_axis:]), weight, bias,
                        epsilon)


def gelu(x, approximate=False):
    """GELU; exact (erf) by default, as the reference's ``gelu`` op."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def softmax(x, axis=-1):
    return torch.softmax(x, dim=axis)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, axis=-1,
                               return_softmax=False):
    """The ``softmax_with_cross_entropy`` op (``math_ops.py:495``): the
    loss −log softmax(logits)[label] with the class axis kept as size 1.
    Hard labels may carry a trailing dim of 1; entries equal to
    ``ignore_index`` give loss 0 (and no gradient). ``soft_label`` takes
    a distribution over the classes instead. With ``return_softmax`` it
    also returns the softmax, as the op's second output."""
    logp = F.log_softmax(logits, dim=axis)
    if soft_label:
        loss = -(label * logp).sum(dim=axis, keepdim=True)
    else:
        lab = label
        if lab.dim() and lab.shape[-1] == 1:
            lab = lab.reshape(lab.shape[:-1])
        lab = lab.long().unsqueeze(axis)
        ignored = lab == ignore_index
        loss = -logp.gather(axis, lab.masked_fill(ignored, 0))
        loss = loss.masked_fill(ignored, 0.0)
    if return_softmax:
        return loss, logp.exp()
    return loss


def softmax_with_cross_entropy_grad(softmax, label, dloss, soft_label=False,
                                    ignore_index=-100, axis=-1):
    """The ``softmax_with_cross_entropy_grad`` op: d logits = (softmax −
    onehot(label))·dLoss, 0 on ignored rows; soft labels subtract the
    label distribution. The hard-label form scatters −dLoss into the
    label column instead of building a one-hot tensor."""
    if soft_label:
        return (softmax - label) * dloss
    lab = label
    if lab.dim() and lab.shape[-1] == 1:
        lab = lab.reshape(lab.shape[:-1])
    lab = lab.long().unsqueeze(axis)
    ignored = lab == ignore_index
    # ignored rows take a zero dLoss: their whole row of d logits is 0
    dloss = dloss.masked_fill(ignored, 0.0)
    d = softmax * dloss
    d.scatter_add_(axis, lab.masked_fill(ignored, 0), -dloss)
    return d


# ---------------------------------------------------------------------------
# op lowerings
# ---------------------------------------------------------------------------
def _broadcast_y(x, y, axis):
    """Fluid's elementwise broadcast: Y lines up with X's dims from
    ``axis`` on (-1: the trailing dims), trailing size-1 dims of Y
    dropped."""
    if x.shape == y.shape:
        return y
    if axis == -1 or axis is None:
        axis = x.dim() - y.dim()
    yshape = list(y.shape)
    while yshape and yshape[-1] == 1 and len(yshape) + axis > x.dim():
        yshape = yshape[:-1]
    return y.reshape([1] * axis + yshape + [1] * (x.dim() - axis - len(yshape)))


def _ew_infer(op_, block):
    v = in_var(op_, block, "X")
    if v is None:
        raise SkipInferShape()
    shape = v.shape
    y = in_var(op_, block, "Y")
    if y is not None and y.shape and len(y.shape) > len(shape):
        shape = y.shape
    elif (y is not None and y.shape and len(y.shape) == len(shape)
          and any(s in (1, -1) for s in shape)):
        shape = tuple(ys if xs == 1 and ys != 1 else xs
                      for xs, ys in zip(shape, y.shape))
    set_out(op_, block, "Out", shape, v.dtype)


def _register_elementwise(name, fn, vjp=None, grad="generic"):
    def lower(ctx, op_, _fn=fn):
        x = ctx.in1(op_, "X")
        y = ctx.in1(op_, "Y")
        ctx.out(op_, "Out", _fn(x, _broadcast_y(x, y, int(op_.attr("axis", -1)))))

    register_op(name, infer_shape=_ew_infer, lower=lower, grad=grad,
                vjp=vjp)


def _sum_to(g, shape):
    """``g`` summed over the dims that ``shape`` broadcast along (leading
    dims it lacks, and its size-1 dims), as autograd reduces a
    broadcast input's gradient."""
    lead = g.dim() - len(shape)
    dims = list(range(lead)) + [lead + i for i, s in enumerate(shape)
                                if s == 1 and g.shape[lead + i] != 1]
    return (g.sum(dims, keepdim=True) if dims else g).reshape(shape)


def _add_vjp(ctx, op_, slots):
    """``elementwise_add`` with its pullback: Out's cotangent summed down
    to each input's shape."""
    x = ctx.in1(op_, "X")
    y = ctx.in1(op_, "Y")
    yb = _broadcast_y(x, y, int(op_.attr("axis", -1)))
    ctx.out(op_, "Out", x + yb)
    shapes = {"X": (x.shape, x.shape), "Y": (yb.shape, y.shape)}
    return lambda g: {slot: _sum_to(g, shapes[slot][0]).reshape(
        shapes[slot][1]) for slot in slots}


_register_elementwise("elementwise_add", torch.add, vjp=_add_vjp)
_register_elementwise("elementwise_sub", torch.sub)
_register_elementwise("elementwise_mul", torch.mul)
_register_elementwise("elementwise_div", torch.div)
_register_elementwise("elementwise_max", torch.maximum)
_register_elementwise("elementwise_min", torch.minimum)
_register_elementwise("elementwise_pow", torch.pow)


# no gradient, as the reference's (``math_ops.py:198-203``); both round
# toward -inf, as Python's % and // and jnp.mod / jnp.floor_divide
_register_elementwise("elementwise_mod", torch.remainder, grad=None)
_register_elementwise("elementwise_floordiv", torch.floor_divide, grad=None)


def _mul_infer(op_, block):
    x = in_var(op_, block, "X")
    y = in_var(op_, block, "Y")
    if x is None or y is None or not x.shape or not y.shape:
        raise SkipInferShape()
    xnc = int(op_.attr("x_num_col_dims", 1))
    ync = int(op_.attr("y_num_col_dims", 1))
    set_out(op_, block, "Out", tuple(x.shape[:xnc]) + tuple(y.shape[ync:]),
            x.dtype)


def _mul_vjp(ctx, op_, slots):
    """``mul``: X flattened to 2-D at ``x_num_col_dims`` times Y
    flattened at ``y_num_col_dims``, one GEMM; its pullback takes one
    GEMM for each input grad asked for (dX = dOut·Yᵀ, dY = Xᵀ·dOut, on
    the 2-D forms) and keeps only the operand that grad reads."""
    x = ctx.in1(op_, "X")
    y = ctx.in1(op_, "Y")
    xnc = int(op_.attr("x_num_col_dims", 1))
    ync = int(op_.attr("y_num_col_dims", 1))
    x2 = x.reshape(math.prod(x.shape[:xnc]), -1)
    y2 = y.reshape(math.prod(y.shape[:ync]), -1)
    ctx.out(op_, "Out", torch.mm(x2, y2).reshape(
        tuple(x.shape[:xnc]) + tuple(y.shape[ync:])))
    xshape, yshape = x.shape, y.shape
    g2_shape = (x2.shape[0], y2.shape[1])
    x2 = x2 if "Y" in slots else None
    y2 = y2 if "X" in slots else None

    def pullback(g):
        g2 = g.reshape(g2_shape)
        grads = {}
        if "X" in slots:
            grads["X"] = torch.mm(g2, y2.t()).reshape(xshape)
        if "Y" in slots:
            grads["Y"] = torch.mm(x2.t(), g2).reshape(yshape)
        return grads

    return pullback


register_op("mul", infer_shape=_mul_infer,
            lower=lambda ctx, op_: _mul_vjp(ctx, op_, ()), grad="generic",
            vjp=_mul_vjp)


def _matmul_infer(op_, block):
    x = in_var(op_, block, "X")
    y = in_var(op_, block, "Y")
    if x is None or y is None or len(x.shape) < 2 or len(y.shape) < 2:
        raise SkipInferShape()
    xs, ys = list(x.shape), list(y.shape)
    if op_.attr("transpose_X", False):
        xs[-1], xs[-2] = xs[-2], xs[-1]
    if op_.attr("transpose_Y", False):
        ys[-1], ys[-2] = ys[-2], ys[-1]
    batch = xs[:-2] if len(xs) > len(ys) else ys[:-2]
    set_out(op_, block, "Out", tuple(batch) + (xs[-2], ys[-1]), x.dtype)


@op("matmul", infer_shape=_matmul_infer, grad="generic")
def _matmul(ctx, op_):
    x = ctx.in1(op_, "X")
    y = ctx.in1(op_, "Y")
    if op_.attr("transpose_X", False) and x.dim() > 1:
        x = x.transpose(-1, -2)
    if op_.attr("transpose_Y", False) and y.dim() > 1:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = float(op_.attr("alpha", 1.0))
    ctx.out(op_, "Out", out * alpha if alpha != 1.0 else out)


def _reduce_infer(op_, block):
    v = in_var(op_, block, "X")
    if v is None:
        raise SkipInferShape()
    dims = op_.attr("dim", [0])
    keep = op_.attr("keep_dim", False)
    if op_.attr("reduce_all", False):
        shape = [1] * len(v.shape) if keep else [1]
    else:
        dims = [d % len(v.shape) for d in dims]
        shape = [(1 if i in dims else s) if keep else s
                 for i, s in enumerate(v.shape) if keep or i not in dims]
        shape = shape or [1]
    set_out(op_, block, "Out", shape, v.dtype)


def _register_reduce(name, fn):
    def lower(ctx, op_, _fn=fn):
        x = ctx.in1(op_, "X")
        if op_.attr("reduce_all", False):
            axes = tuple(range(x.dim()))
        else:
            axes = tuple(d % x.dim() for d in op_.attr("dim", [0]))
        keep = bool(op_.attr("keep_dim", False))
        out = _fn(x, axes, keep)
        if not keep and out.dim() == 0:
            out = out.reshape((1,))
        ctx.out(op_, "Out", out)

    register_op(name, infer_shape=_reduce_infer, lower=lower, grad="generic")


_register_reduce("reduce_sum", lambda x, a, k: torch.sum(x, dim=a, keepdim=k))
_register_reduce("reduce_mean",
                 lambda x, a, k: torch.mean(x, dim=a, keepdim=k))


@op("mean", grad="generic")
def _mean(ctx, op_):
    ctx.out(op_, "Out", ctx.in1(op_, "X").mean().reshape((1,)))


@op("softmax", infer_shape=same_shape_infer("X"), grad="generic")
def _softmax(ctx, op_):
    ctx.out(op_, "Out", softmax(ctx.in1(op_, "X"),
                                axis=int(op_.attr("axis", -1))))


def _gelu_vjp(ctx, op_, slots):
    """``gelu`` with its pullback, the kernel autograd runs for it."""
    x = ctx.in1(op_, "X")
    approximate = "tanh" if op_.attr("approximate", False) else "none"
    ctx.out(op_, "Out", F.gelu(x, approximate=approximate))
    return lambda g: {"X": torch.ops.aten.gelu_backward(
        g, x, approximate=approximate)}


register_op("gelu", infer_shape=same_shape_infer("X"),
            lower=lambda ctx, op_: _gelu_vjp(ctx, op_, ()), grad="generic",
            vjp=_gelu_vjp)


def _relu_vjp(ctx, op_, slots):
    """``relu`` with its pullback: the cotangent where the output is
    positive (0 at x = 0, as the reference's ``jax.nn.relu``)."""
    out = torch.relu(ctx.in1(op_, "X"))
    ctx.out(op_, "Out", out)
    return lambda g: {"X": torch.ops.aten.threshold_backward(g, out, 0)}


register_op("relu", infer_shape=same_shape_infer("X"),
            lower=lambda ctx, op_: _relu_vjp(ctx, op_, ()), grad="generic",
            vjp=_relu_vjp)


def _tanh_vjp(ctx, op_, slots):
    """``tanh`` (the reference's activation table, ``math_ops.py:58``)
    with its pullback g·(1 − out²)."""
    out = torch.tanh(ctx.in1(op_, "X"))
    ctx.out(op_, "Out", out)
    return lambda g: {"X": torch.ops.aten.tanh_backward(g, out)}


register_op("tanh", infer_shape=same_shape_infer("X"),
            lower=lambda ctx, op_: _tanh_vjp(ctx, op_, ()), grad="generic",
            vjp=_tanh_vjp)


@op("sqrt", infer_shape=same_shape_infer("X"), grad="generic")
def _sqrt(ctx, op_):
    ctx.out(op_, "Out", torch.sqrt(ctx.in1(op_, "X")))


def _register_unary(name, fn):
    """An activation-table op of the reference (``math_ops.py:52-91``):
    ``Out = fn(X, op)``, grad through the generic vjp."""
    def lower(ctx, op_, _fn=fn):
        ctx.out(op_, "Out", _fn(ctx.in1(op_, "X"), op_))

    register_op(name, infer_shape=same_shape_infer("X"), lower=lower,
                grad="generic")


_register_unary("floor", lambda x, op_: torch.floor(x))
_register_unary("ceil", lambda x, op_: torch.ceil(x))
_register_unary("exp", lambda x, op_: torch.exp(x))
_register_unary("cos", lambda x, op_: torch.cos(x))
_register_unary("square", lambda x, op_: x * x)


@op("square_error_cost", infer_shape=same_shape_infer("X"), grad="generic")
def _square_error_cost(ctx, op_):
    """(X - Y)^2 elementwise (``math_ops.py:560``)."""
    d = ctx.in1(op_, "X") - ctx.in1(op_, "Y")
    ctx.out(op_, "Out", d * d)
_register_unary("pow", lambda x, op_: torch.pow(
    x, torch.tensor(float(op_.attr("factor", 1.0)), dtype=x.dtype,
                    device=x.device)))


@op("label_smooth", infer_shape=same_shape_infer("X"), grad="generic")
def _label_smooth(ctx, op_):
    """(1 − ε)·X + ε/K over the last axis of size K, or + ε·PriorDist
    when given (``math_ops.py:695``); X's dtype kept."""
    x = ctx.in1(op_, "X")
    eps = float(op_.attr("epsilon", 0.1))
    prior = ctx.in1(op_, "PriorDist", optional=True)
    k = x.shape[-1]
    if prior is not None:
        out = (1.0 - eps) * x + eps * prior.reshape((1,) * (x.dim() - 1)
                                                    + (k,))
    else:
        out = (1.0 - eps) * x + eps / k
    ctx.out(op_, "Out", out.to(x.dtype))


def _swce_infer(op_, block):
    x = in_var(op_, block, "Logits")
    if x is None:
        raise SkipInferShape()
    set_out(op_, block, "Loss", tuple(x.shape[:-1]) + (1,), x.dtype)
    set_out(op_, block, "Softmax", x.shape, x.dtype)


def _swce_grad_maker(op_):
    # custom maker: the grad needs Softmax + Loss@GRAD + Label only
    return [dict(
        type="softmax_with_cross_entropy_grad",
        inputs={"Label": op_.input("Label"),
                "Softmax": op_.output("Softmax"),
                "Loss@GRAD": [n + "@GRAD" for n in op_.output("Loss")]},
        outputs={"Logits@GRAD": [n + "@GRAD" for n in op_.input("Logits")]},
        attrs=dict(op_.attrs),
    )]


@op("softmax_with_cross_entropy", infer_shape=_swce_infer,
    grad=_swce_grad_maker)
def _softmax_with_cross_entropy(ctx, op_):
    loss, sm = softmax_with_cross_entropy(
        ctx.in1(op_, "Logits"), ctx.in1(op_, "Label"),
        soft_label=bool(op_.attr("soft_label", False)),
        ignore_index=int(op_.attr("ignore_index", -100)),
        axis=int(op_.attr("axis", -1)), return_softmax=True)
    ctx.out(op_, "Loss", loss)
    ctx.out(op_, "Softmax", sm)


@op("softmax_with_cross_entropy_grad")
def _softmax_with_cross_entropy_grad(ctx, op_):
    ctx.out(op_, "Logits@GRAD", softmax_with_cross_entropy_grad(
        ctx.in1(op_, "Softmax"), ctx.in1(op_, "Label"),
        ctx.in1(op_, "Loss@GRAD"),
        soft_label=bool(op_.attr("soft_label", False)),
        ignore_index=int(op_.attr("ignore_index", -100)),
        axis=int(op_.attr("axis", -1))))


def _layer_norm_infer(op_, block):
    v = in_var(op_, block, "X")
    if v is None:
        raise SkipInferShape()
    ax = int(op_.attr("begin_norm_axis", 1))
    set_out(op_, block, "Y", v.shape, v.dtype)
    set_out(op_, block, "Mean", v.shape[:ax], v.dtype)
    set_out(op_, block, "Variance", v.shape[:ax], v.dtype)


def _layer_norm_vjp(ctx, op_, slots):
    """``layer_norm`` with its pullback, the kernel autograd runs for it
    (``native_layer_norm_backward`` from the forward's mean and
    1/sqrt(var + eps))."""
    x = ctx.in1(op_, "X")
    w = ctx.in1(op_, "Scale", optional=True)
    b = ctx.in1(op_, "Bias", optional=True)
    axis = int(op_.attr("begin_norm_axis", 1))
    eps = float(op_.attr("epsilon", 1e-5))
    shape = tuple(x.shape[axis:])
    w2 = None if w is None else w.reshape(shape)
    b2 = None if b is None else b.reshape(shape)
    y, mean, rstd = torch.native_layer_norm(x, shape, w2, b2, eps)
    rows = tuple(x.shape[:axis])
    ctx.out(op_, "Y", y)
    ctx.out(op_, "Mean", mean.reshape(rows))
    ctx.out(op_, "Variance", (rstd.reshape(rows) ** -2) - eps)
    mask = ["X" in slots, "Scale" in slots, "Bias" in slots]

    def pullback(g):
        dx, dw, db = torch.ops.aten.native_layer_norm_backward(
            g, x, shape, mean, rstd, w2, b2, mask)
        grads = {"X": dx}
        if w is not None:
            grads["Scale"] = None if dw is None else dw.reshape(w.shape)
        if b is not None:
            grads["Bias"] = None if db is None else db.reshape(b.shape)
        return grads

    return pullback


register_op("layer_norm", infer_shape=_layer_norm_infer,
            lower=lambda ctx, op_: _layer_norm_vjp(ctx, op_, ()),
            grad="generic", vjp=_layer_norm_vjp)


# ---------------------------------------------------------------------------
# what the recurrent layers and decoders add (``math_ops.py``)
# ---------------------------------------------------------------------------
@op("sigmoid", infer_shape=same_shape_infer("X"), grad="generic")
def _sigmoid(ctx, op_):
    ctx.out(op_, "Out", torch.sigmoid(ctx.in1(op_, "X")))


@op("log_softmax", infer_shape=same_shape_infer("X"), grad="generic")
def _log_softmax(ctx, op_):
    ctx.out(op_, "Out", F.log_softmax(ctx.in1(op_, "X"),
                                      dim=int(op_.attr("axis", -1))))


@op("clip", infer_shape=same_shape_infer("X"), grad="generic")
def _clip(ctx, op_):
    ctx.out(op_, "Out", torch.clamp(ctx.in1(op_, "X"),
                                    float(op_.attr("min")),
                                    float(op_.attr("max"))))


@op("cumsum", grad="generic")
def _cumsum(ctx, op_):
    """``math_ops.py:677``: the running sum along ``axis``, from the end
    with ``reverse``, without each element itself with ``exclusive``."""
    x = ctx.in1(op_, "X")
    ax = int(op_.attr("axis", -1))
    if op_.attr("reverse", False):
        out = torch.flip(torch.cumsum(torch.flip(x, [ax]), dim=ax), [ax])
    else:
        out = torch.cumsum(x, dim=ax)
    if op_.attr("exclusive", False):
        out = out - x
    ctx.out(op_, "Out", out.to(x.dtype))


def _xent_infer(op_, block):
    x = in_var(op_, block, "X")
    if x is None:
        raise SkipInferShape()
    set_out(op_, block, "Out", tuple(x.shape[:-1]) + (1,), x.dtype)


@op("cross_entropy", infer_shape=_xent_infer, grad="generic")
def _cross_entropy(ctx, op_):
    """``math_ops.py:445``: −log of X (probabilities, clipped to
    [1e-15, 1]) at Label, or −Σ label·log X with ``soft_label``;
    ``ignore_index`` rows give 0."""
    x = ctx.in1(op_, "X")
    label = ctx.in1(op_, "Label")
    ignore_index = int(op_.attr("ignore_index", -100))
    logp = torch.log(torch.clamp(x, 1e-15, 1.0))
    if op_.attr("soft_label", False):
        out = -(label * logp).sum(-1, keepdim=True)
    else:
        lab = label
        if lab.dim() and lab.shape[-1] == 1:
            lab = lab.reshape(lab.shape[:-1])
        ignored = (lab == ignore_index)[..., None]
        safe = torch.where(lab == ignore_index, torch.zeros_like(lab), lab)
        picked = logp.gather(-1, safe[..., None].long())
        out = torch.where(ignored, torch.zeros_like(picked), -picked)
    ctx.out(op_, "Out", out)


def _scalar1_infer(op_, block):
    x = in_var(op_, block, "X")
    if x is None:
        raise SkipInferShape()
    set_out(op_, block, "Out", (1,), x.dtype)


@op("squared_l2_norm", infer_shape=_scalar1_infer, grad="generic")
def _squared_l2_norm(ctx, op_):
    """Σ X² as a [1] tensor (``math_ops.py:411``; the global-norm clip)."""
    x = ctx.in1(op_, "X")
    ctx.out(op_, "Out", (x * x).sum().reshape((1,)))
