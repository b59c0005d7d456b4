"""Math ops (port of ``paddle_tpu/fluid/ops/math_ops.py``): plain
functions on tensors, which the eager models call, and the registered
op lowerings the Executor runs: elementwise with Fluid's axis broadcast,
``mul``, ``matmul``, ``bmm``, ``dot``, the reductions, the activation
table (``_ACTIVATIONS``, one registrar as the reference's), ``prelu``,
``softmax`` and the cross-entropy losses with their grads,
``layer_norm``, the norms and clips, the products
(``bilinear_tensor_product``, ``fsp``, ``cos_sim``,
``squared_l2_distance``), the regression losses, ``label_smooth`` and
the rest of the reference's module. These stay PyTorch calls; what
matters is that they mean what the reference's ops mean."""

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


def _register_reduce(name, fn, grad="generic"):
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

    register_op(name, infer_shape=_reduce_infer, lower=lower, grad=grad)


def _prod(x, axes, keep):
    """The product over ``axes`` (``torch.prod`` takes one dim a call)."""
    for a in sorted(axes, reverse=True):
        x = torch.prod(x, dim=a, keepdim=keep)
    return x


_register_reduce("reduce_sum", lambda x, a, k: torch.sum(x, dim=a, keepdim=k))
_register_reduce("reduce_mean",
                 lambda x, a, k: torch.mean(x, dim=a, keepdim=k))
_register_reduce("reduce_max", lambda x, a, k: torch.amax(x, dim=a, keepdim=k))
_register_reduce("reduce_min", lambda x, a, k: torch.amin(x, dim=a, keepdim=k))
_register_reduce("reduce_prod", _prod)
_register_reduce("reduce_all", lambda x, a, k: torch.all(x, dim=a, keepdim=k),
                 grad=None)
_register_reduce("reduce_any", lambda x, a, k: torch.any(x, dim=a, keepdim=k),
                 grad=None)


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


# ---------------------------------------------------------------------------
# the activation table (``math_ops.py:52-106``): Out = fn(X, op), each
# attr read with the reference's default; relu, tanh and gelu above keep
# their hand-written pullbacks
# ---------------------------------------------------------------------------
def _register_activation(name, fn, grad=True):
    def lower(ctx, op_, _fn=fn):
        ctx.out(op_, "Out", _fn(ctx.in1(op_, "X"), op_))

    register_op(name, infer_shape=same_shape_infer("X"), lower=lower,
                grad="generic" if grad else None)


def _f(a, name, default):
    return float(a.attr(name, default))


def _soft_relu(x, a):
    t = _f(a, "threshold", 40.0)
    return torch.log(1.0 + torch.exp(torch.clamp(x, -t, t)))


_ACTIVATIONS = {
    "sigmoid": lambda x, a: torch.sigmoid(x),
    "logsigmoid": lambda x, a: F.logsigmoid(x),
    "tanh_shrink": lambda x, a: x - torch.tanh(x),
    "sqrt": lambda x, a: torch.sqrt(x),
    "rsqrt": lambda x, a: 1.0 / torch.sqrt(x),
    "abs": lambda x, a: torch.abs(x),
    "ceil": lambda x, a: torch.ceil(x),
    "floor": lambda x, a: torch.floor(x),
    "round": lambda x, a: torch.round(x),
    "cos": lambda x, a: torch.cos(x),
    "sin": lambda x, a: torch.sin(x),
    "acos": lambda x, a: torch.acos(x),
    "asin": lambda x, a: torch.asin(x),
    "atan": lambda x, a: torch.atan(x),
    "reciprocal": lambda x, a: 1.0 / x,
    "square": lambda x, a: x * x,
    "exp": lambda x, a: torch.exp(x),
    "log": lambda x, a: torch.log(x),
    "softplus": lambda x, a: torch.logaddexp(x, torch.zeros_like(x)),
    "softsign": lambda x, a: x / (1.0 + torch.abs(x)),
    "softshrink": lambda x, a: F.softshrink(x, _f(a, "lambda", 0.5)),
    "hard_shrink": lambda x, a: F.hardshrink(x, _f(a, "threshold", 0.5)),
    "hard_sigmoid": lambda x, a: torch.clamp(
        _f(a, "slope", 0.2) * x + _f(a, "offset", 0.5), 0.0, 1.0),
    "hard_swish": lambda x, a: x * torch.clamp(
        x + _f(a, "offset", 3.0), 0.0, _f(a, "threshold", 6.0))
    / _f(a, "scale", 6.0),
    "brelu": lambda x, a: torch.clamp(x, _f(a, "t_min", 0.0),
                                      _f(a, "t_max", 24.0)),
    "leaky_relu": lambda x, a: torch.where(x >= 0, x,
                                           _f(a, "alpha", 0.02) * x),
    "elu": lambda x, a: F.elu(x, _f(a, "alpha", 1.0)),
    "relu6": lambda x, a: torch.clamp(x, 0.0, _f(a, "threshold", 6.0)),
    "pow": lambda x, a: torch.pow(x, torch.tensor(
        _f(a, "factor", 1.0), dtype=x.dtype, device=x.device)),
    "stanh": lambda x, a: _f(a, "scale_b", 1.7159) * torch.tanh(
        _f(a, "scale_a", 0.67) * x),
    "swish": lambda x, a: x * torch.sigmoid(_f(a, "beta", 1.0) * x),
    "thresholded_relu": lambda x, a: torch.where(
        x > _f(a, "threshold", 1.0), x, torch.zeros_like(x)),
    "soft_relu": _soft_relu,
    "erf": lambda x, a: torch.erf(x),
}

for _name, _fn in _ACTIVATIONS.items():
    _register_activation(_name, _fn)


@op("prelu", infer_shape=same_shape_infer("X"), grad="generic")
def _prelu(ctx, op_):
    """``math_ops.py:127``: X where positive, else Alpha·X; Alpha one
    value (``all``), one a channel (``channel``, dim 1) or one an
    element of X's trailing dims (``element``)."""
    x = ctx.in1(op_, "X")
    alpha = ctx.in1(op_, "Alpha")
    mode = op_.attr("mode", "all")
    if mode == "channel":
        alpha = alpha.reshape((1, -1) + (1,) * (x.dim() - 2))
    elif mode == "all":
        alpha = alpha.reshape(())
    ctx.out(op_, "Out", torch.where(x > 0, x, alpha * x))


@op("square_error_cost", infer_shape=same_shape_infer("X"), grad="generic")
def _square_error_cost(ctx, op_):
    """(X - Y)^2 elementwise (``math_ops.py:560``)."""
    d = ctx.in1(op_, "X") - ctx.in1(op_, "Y")
    ctx.out(op_, "Out", d * d)


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


@op("frobenius_norm", infer_shape=_scalar1_infer, grad="generic")
def _frobenius_norm(ctx, op_):
    """√(Σ X²) over the whole of X as a [1] tensor (``math_ops.py:417``;
    the reference reads no ``dim``)."""
    x = ctx.in1(op_, "X")
    ctx.out(op_, "Out", torch.sqrt((x * x).sum()).reshape((1,)))


@op("clip_by_norm", infer_shape=same_shape_infer("X"), grad="generic")
def _clip_by_norm(ctx, op_):
    """``math_ops.py:652``: X scaled to L2 norm ``max_norm`` when its norm
    is larger, chosen on the device."""
    x = ctx.in1(op_, "X")
    max_norm = float(op_.attr("max_norm"))
    norm = torch.sqrt((x * x).sum())
    scale = torch.where(norm > max_norm,
                        max_norm / torch.clamp(norm, min=1e-12),
                        torch.ones_like(norm))
    ctx.out(op_, "Out", x * scale.to(x.dtype))


def _l2_normalize_infer(op_, block):
    v = in_var(op_, block, "X")
    if v is None:
        raise SkipInferShape()
    set_out(op_, block, "Out", v.shape, v.dtype)
    ax = int(op_.attr("axis", -1)) % max(len(v.shape), 1)
    set_out(op_, block, "Norm", tuple(1 if i == ax else d
                                      for i, d in enumerate(v.shape)),
            v.dtype)


@op("l2_normalize", infer_shape=_l2_normalize_infer, grad="generic")
def _l2_normalize(ctx, op_):
    """``math_ops.py:632``: X / max(‖X‖₂ along ``axis``, ε), and the norm
    (kept dim) as ``Norm``."""
    x = ctx.in1(op_, "X")
    ax = int(op_.attr("axis", -1))
    eps = float(op_.attr("epsilon", 1e-10))
    norm = torch.sqrt((x * x).sum(dim=ax, keepdim=True))
    ctx.out(op_, "Out", x / torch.clamp(norm, min=eps))
    ctx.out(op_, "Norm", norm)


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------
@op("bmm", grad="generic")
def _bmm(ctx, op_):
    """``math_ops.py:334``: batched X·Y."""
    ctx.out(op_, "Out", torch.matmul(ctx.in1(op_, "X"), ctx.in1(op_, "Y")))


@op("dot", grad="generic")
def _dot(ctx, op_):
    """``math_ops.py:339``: Σ X·Y over the last axis, kept as size 1."""
    ctx.out(op_, "Out", (ctx.in1(op_, "X") * ctx.in1(op_, "Y")).sum(
        -1, keepdim=True))


def _bilinear_tp_infer(op_, block):
    x = in_var(op_, block, "X")
    w = in_var(op_, block, "Weight")
    if x is None or w is None:
        raise SkipInferShape()
    set_out(op_, block, "Out", [x.shape[0], w.shape[0]], x.dtype)


@op("bilinear_tensor_product", infer_shape=_bilinear_tp_infer,
    grad="generic")
def _bilinear_tensor_product(ctx, op_):
    """``math_ops.py:825``: Out[b, k] = X[b]·W[k]·Y[b]ᵀ (+ Bias[k]); X
    [B, M], Y [B, N], Weight [K, M, N]."""
    x = ctx.in1(op_, "X")
    y = ctx.in1(op_, "Y")
    w = ctx.in1(op_, "Weight")
    out = torch.einsum("bm,kmn,bn->bk", x, w, y)
    b = ctx.in1(op_, "Bias", optional=True)
    if b is not None:
        out = out + b.reshape(1, -1)
    ctx.out(op_, "Out", out)


@op("fsp", grad="generic")
def _fsp(ctx, op_):
    """``math_ops.py:895``: the FSP matrix Out[n, i, j] = mean over h, w
    of X[n, i, h, w]·Y[n, j, h, w]."""
    x = ctx.in1(op_, "X")
    y = ctx.in1(op_, "Y")
    hw = x.shape[2] * x.shape[3]
    ctx.out(op_, "Out", torch.einsum("nihw,njhw->nij", x, y) / hw)


def _cos_sim_infer(op_, block):
    v = in_var(op_, block, "X")
    yv = in_var(op_, block, "Y")
    if v is None or yv is None:
        raise SkipInferShape()
    set_out(op_, block, "Out", [v.shape[0], 1], v.dtype)
    set_out(op_, block, "XNorm", [v.shape[0], 1], v.dtype)
    set_out(op_, block, "YNorm", [yv.shape[0], 1], yv.dtype)


@op("cos_sim", infer_shape=_cos_sim_infer, grad="generic")
def _cos_sim(ctx, op_):
    """``math_ops.py:786``: the rows' cosine similarity (Y of one row
    broadcasts), with each side's row norms."""
    x = ctx.in1(op_, "X")
    y = ctx.in1(op_, "Y")
    xn = torch.sqrt((x * x).sum(1, keepdim=True))
    yn = torch.sqrt((y * y).sum(1, keepdim=True))
    ctx.out(op_, "Out", (x * y).sum(1, keepdim=True) / (xn * yn + 1e-12))
    ctx.out(op_, "XNorm", xn)
    ctx.out(op_, "YNorm", yn)


def _sq_l2_distance_infer(op_, block):
    v = in_var(op_, block, "X")
    if v is None:
        raise SkipInferShape()
    set_out(op_, block, "Out", [v.shape[0], 1], v.dtype)
    set_out(op_, block, "sub_result", list(v.shape), v.dtype)


@op("squared_l2_distance", infer_shape=_sq_l2_distance_infer,
    grad="generic")
def _squared_l2_distance(ctx, op_):
    """``math_ops.py:808``: Σ (X − Y)² over each row, and X − Y."""
    sub = ctx.in1(op_, "X") - ctx.in1(op_, "Y")
    ctx.out(op_, "sub_result", sub)
    ctx.out(op_, "Out", (sub * sub).sum(
        tuple(range(1, sub.dim()))).reshape(-1, 1))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
@op("sigmoid_cross_entropy_with_logits", infer_shape=same_shape_infer("X"),
    grad="generic")
def _sigmoid_xent(ctx, op_):
    """``math_ops.py:545``: max(x, 0) − x·label + log(1 + e^−|x|); 0
    where the label is ``ignore_index`` (when it is not −100); divided by
    the count of labels other than ``ignore_index`` with ``normalize``."""
    x = ctx.in1(op_, "X")
    label = ctx.in1(op_, "Label")
    ignore_index = int(op_.attr("ignore_index", -100))
    loss = torch.clamp(x, min=0) - x * label + torch.log1p(
        torch.exp(-torch.abs(x)))
    if ignore_index != -100:
        loss = torch.where(label == ignore_index, torch.zeros_like(loss),
                           loss)
    if op_.attr("normalize", False):
        n = torch.clamp((label != ignore_index).to(x.dtype).sum(), min=1.0)
        loss = loss / n
    ctx.out(op_, "Out", loss)


@op("huber_loss", grad="generic")
def _huber_loss(ctx, op_):
    """``math_ops.py:568``: r = Y − X; ½r² where |r| ≤ δ, else
    δ(|r| − ½δ); the residual as ``Residual``."""
    r = ctx.in1(op_, "Y") - ctx.in1(op_, "X")
    delta = float(op_.attr("delta", 1.0))
    a = torch.abs(r)
    ctx.out(op_, "Out", torch.where(a <= delta, 0.5 * r * r,
                                    delta * (a - 0.5 * delta)))
    ctx.out(op_, "Residual", r)


@op("smooth_l1_loss", grad="generic")
def _smooth_l1_loss(ctx, op_):
    """``math_ops.py:581``: d = X − Y; ½σ²d² where |d| < 1/σ², else
    |d| − ½/σ², summed over each row ([N, 1]); d as ``Diff``."""
    d = ctx.in1(op_, "X") - ctx.in1(op_, "Y")
    sigma = float(op_.attr("sigma", 1.0))
    s2 = sigma * sigma
    a = torch.abs(d)
    val = torch.where(a < 1.0 / s2, 0.5 * d * d * s2, a - 0.5 / s2)
    ctx.out(op_, "Diff", d)
    ctx.out(op_, "Out", val.sum(tuple(range(1, val.dim()))).reshape(-1, 1))


# ---------------------------------------------------------------------------
# the rest
# ---------------------------------------------------------------------------
@op("maximum", grad="generic")
def _maximum(ctx, op_):
    ctx.out(op_, "Out", torch.maximum(ctx.in1(op_, "X"), ctx.in1(op_, "Y")))


@op("sign", infer_shape=same_shape_infer("X"))
def _sign(ctx, op_):
    """``math_ops.py:690``: −1, 0 or 1; no gradient, as the reference's."""
    ctx.out(op_, "Out", torch.sign(ctx.in1(op_, "X")))


@op("maxout", grad="generic")
def _maxout(ctx, op_):
    """``math_ops.py:709``: the max over each run of ``groups`` channels
    of X [N, C, H, W]."""
    x = ctx.in1(op_, "X")
    groups = int(op_.attr("groups"))
    n, c, h, w = x.shape
    ctx.out(op_, "Out", x.reshape(n, c // groups, groups, h, w).amax(2))


@op("unfold", grad="generic")
def _unfold(ctx, op_):
    """``math_ops.py:755``: the im2col patches of X [N, C, H, W] as
    [N, C·kh·kw, L], channel-major; ``paddings`` [top, left, bottom,
    right]."""
    x = ctx.in1(op_, "X")
    ks = [int(k) for k in op_.attr("kernel_sizes")]
    st = [int(v) for v in op_.attr("strides", [1, 1])]
    pd = [int(v) for v in op_.attr("paddings", [0, 0, 0, 0])]
    dl = [int(v) for v in op_.attr("dilations", [1, 1])]
    if any(pd):
        x = F.pad(x, (pd[1], pd[3], pd[0], pd[2]))
    ctx.out(op_, "Y", F.unfold(x, ks, dilation=dl, stride=st))


@op("add_position_encoding", infer_shape=same_shape_infer("X"),
    grad="generic")
def _add_position_encoding(ctx, op_):
    """``math_ops.py:841``: α·X + β·the sinusoid table of X [B, T, D]:
    sin on the first ⌊D/2⌋ columns, cos on the rest, wavelengths
    10000^(i/⌊D/2⌋)."""
    x = ctx.in1(op_, "X")
    alpha = float(op_.attr("alpha", 1.0))
    beta = float(op_.attr("beta", 1.0))
    _b, t, d = x.shape
    half = d // 2
    pos = torch.arange(t, dtype=torch.float32, device=x.device)[:, None]

    def wavelen(n):
        return torch.pow(10000.0, torch.arange(
            n, dtype=torch.float32, device=x.device) / max(half, 1))

    enc = torch.cat([torch.sin(pos / wavelen(half)),
                     torch.cos(pos / wavelen(d - half))], dim=1)
    ctx.out(op_, "Out", alpha * x + beta * enc[None].to(x.dtype))


@op("similarity_focus", infer_shape=same_shape_infer("X"))
def _similarity_focus(ctx, op_):
    """``math_ops.py:863``: for each channel of ``indexes`` of X
    [B, C, H, W] (``axis`` 1), min(H, W) times the largest cell whose row
    and column are both still free is marked and its row and column
    retired; Out is the union of the marks, broadcast over C. All on the
    device: a fixed number of masked argmaxes."""
    x = ctx.in1(op_, "X")
    if int(op_.attr("axis", 1)) != 1:
        raise NotImplementedError("similarity_focus: only axis=1 supported")
    bsz, _c, h, w = x.shape
    rows = torch.arange(bsz, device=x.device)
    neg = torch.finfo(x.dtype).min
    mask = torch.zeros((bsz, h, w), dtype=x.dtype, device=x.device)
    for ch in [int(i) for i in op_.attr("indexes", [])]:
        fm = x[:, ch]
        row_used = torch.zeros((bsz, h), dtype=torch.bool, device=x.device)
        col_used = torch.zeros((bsz, w), dtype=torch.bool, device=x.device)
        for _ in range(min(h, w)):
            avail = ~row_used[:, :, None] & ~col_used[:, None, :]
            flat = torch.where(avail, fm, torch.full_like(fm, neg)).reshape(
                bsz, -1).argmax(1)
            ri, ci = flat // w, flat % w
            mask[rows, ri, ci] = 1
            row_used[rows, ri] = True
            col_used[rows, ci] = True
    ctx.out(op_, "Out", mask[:, None].expand(x.shape).contiguous())


@op("sampling_id")
def _sampling_id(ctx, op_):
    """``math_ops.py:718``: one class drawn from each row of the
    probabilities X [B, K], int64 [B], from the op's generator."""
    x = ctx.in1(op_, "X")
    ids = torch.multinomial(x.float() + 1e-20, 1,
                            generator=ctx.generator(op_))
    ctx.out(op_, "Out", ids.reshape(-1))


@op("uniform_random_batch_size_like")
def _uniform_random_bsl(ctx, op_):
    """``math_ops.py:732``: U(min, max) of ``shape`` with dim
    ``output_dim_idx`` taken from Input's ``input_dim_idx``."""
    from .. import core

    ref = ctx.in1(op_, "Input")
    shape = [int(s) for s in op_.attr("shape", [])]
    shape[int(op_.attr("output_dim_idx", 0))] = ref.shape[
        int(op_.attr("input_dim_idx", 0))]
    out = torch.empty(shape, dtype=core.dtype_to_torch(op_.attr("dtype", 5)),
                      device=ctx.device)
    ctx.out(op_, "Out", out.uniform_(float(op_.attr("min", -1.0)),
                                     float(op_.attr("max", 1.0)),
                                     generator=ctx.generator(op_)))
