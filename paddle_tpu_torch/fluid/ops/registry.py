"""Op registry and lowering machinery (port of
``paddle_tpu/fluid/ops/registry.py``).

Each ``OpDef`` carries

- ``infer_shape(op, block)`` — compile-time shape/dtype propagation,
- ``lower(ctx, op)`` — the rule that computes the op on torch tensors,
  run by the Executor op by op,
- ``grad_maker(op)`` — desc-level grad-op construction; ``"generic"``
  gives the generic maker, whose ``<op>_grad`` lowering is the vjp of
  the forward rule, taken on the autograd tape;
- ``vjp(ctx, op, slots)`` — optional: the forward with a hand-written
  pullback, which a generic grad uses in place of the tape.

Eager PyTorch has no common-subexpression elimination, so a generic grad
that replayed its forward (as the reference's ``jax.vjp`` does, XLA then
merging the copy) would run every forward product twice. The Executor
therefore runs a forward op whose grad op is in the same block once,
through its ``vjp`` rule or on the autograd tape (``run_op_capturing``),
and keeps the vjp closure in the run's context; the grad op calls it.
Only where no closure exists does the grad lowering replay the forward,
and it counts each replay in the ``generic_grad_replays`` profiler
counter.

Grad naming contract as the reference: grad of var ``x`` is ``x@GRAD``.
"""

import re

import numpy as np
import torch
from torch.autograd.graph import get_gradient_edge

from .. import core
from .. import profiler

GRAD_SUFFIX = "@GRAD"
EMPTY_VAR = "@EMPTY@"

# attr keys used to carry the forward op signature on generic grad ops
FWD_INPUTS_ATTR = "__fwd_inputs__"
FWD_OUTPUTS_ATTR = "__fwd_outputs__"

REPLAY_COUNTER = "generic_grad_replays"

# reads of a tensor's values on the host by an op whose output shape
# depends on them (``range``, ``linspace``, ``where_index``, ...): each
# waits on the device, as ``control_flow_host_syncs`` counts a loop's
# condition
HOST_READ_COUNTER = "op_host_reads"

_REPLAY_TAG = re.compile(r"@(RECOMPUTE|CKPT)@\d+$")


def unreplayed_name(name):
    """A recompute replay's var name (``v@RECOMPUTE@k``, or a barriered
    read ``v@CKPT@k``; ``backward._recompute_transform``) as the
    forward's ``v``; any other name as it is."""
    return _REPLAY_TAG.sub("", name)


class SkipInferShape(Exception):
    """Raised by infer_shape rules that can't infer (e.g. unknown dims)."""


class OpDef(object):
    __slots__ = ("type", "infer_shape", "lower", "grad_maker", "vjp")

    def __init__(self, type, infer_shape=None, lower=None, grad_maker=None,
                 vjp=None):
        self.type = type
        self.infer_shape = infer_shape
        self.lower = lower
        self.grad_maker = grad_maker
        self.vjp = vjp


_REGISTRY = {}


def register_op(type, infer_shape=None, lower=None, grad=None, vjp=None):
    """Register an op. ``grad`` may be "generic" (the vjp-backed generic
    maker), None (no gradient) or a callable(op) -> [op-spec dict]. An
    op that updates a variable in place (optimizer state) writes the
    input's tensor and names it again as its output.

    ``vjp``, for a generic-grad op: a rule ``vjp(ctx, op, slots) ->
    pullback`` that lowers the forward as ``lower`` does and returns
    ``pullback(g) -> {slot: grad}`` giving, from the cotangent ``g`` of
    its one output that receives a gradient, the grads of the input
    ``slots`` asked for. A captured forward uses it in place of the
    autograd tape: the same arithmetic for a fraction of the host's
    dispatch cost, and the pullback keeps only what those grads read."""
    grad_maker = generic_grad_maker if grad == "generic" else grad
    d = OpDef(type, infer_shape=infer_shape, lower=lower,
              grad_maker=grad_maker, vjp=vjp)
    _REGISTRY[type] = d
    return d


def op(type, **kwargs):
    """Decorator form: @op("relu", grad="generic") def lower(ctx, op)."""

    def deco(fn):
        register_op(type, lower=fn, **kwargs)
        return fn

    return deco


def get_op_def(type):
    d = _REGISTRY.get(type)
    if d is None and type.endswith("_grad"):
        base = _REGISTRY.get(type[: -len("_grad")])
        if base is not None and base.lower is not None:
            # synthesize a generic vjp grad def (cached)
            d = OpDef(type, lower=_generic_grad_lower)
            _REGISTRY[type] = d
    return d


def is_generic_grad(type):
    d = get_op_def(type)
    return d is not None and d.lower is _generic_grad_lower


def has_op(type):
    return get_op_def(type) is not None


def all_op_types():
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# Lowering context
# ---------------------------------------------------------------------------
class LowerCtx(object):
    """The environment of one run: ``env`` maps var name -> tensor,
    ``device`` is where new tensors go, ``rng`` the (device, CPU)
    generator pair random ops draw from, ``vjps`` the forward closures
    kept for generic grad ops (keyed by the grad op's id), ``host_feeds``
    the host arrays the run's feeds came from ({name: (tensor, array)}),
    which ``host_ints`` reads instead of the tensor, and ``parent`` the
    context a captured forward or a recurrence step runs inside, through
    which the sequence ops find the run's ``@SEQ_LEN`` companions."""

    def __init__(self, env=None, device=None, rng=None, block=None,
                 scope=None, host_feeds=None, parent=None):
        self.env = env if env is not None else {}
        self.device = torch.device("cpu") if device is None else device
        self.rng = rng
        self.block = block
        self.scope = scope
        self.host_feeds = host_feeds if host_feeds is not None else {}
        self.parent = parent
        self.vjps = {}
        self._memo = {}
        self._cur_op = None

    def memo(self, key, srcs, fn):
        """``fn()``, computed once while the tensors ``srcs`` stay the
        very ones it was computed from: what every layer of a serving
        program derives alike from one step's feeds (the paged write
        index, int32 block tables, a location read on the host) costs
        one computation a run, not one a layer."""
        hit = self._memo.get(key)
        if hit is not None and len(hit[0]) == len(srcs) and all(
                a is b for a, b in zip(hit[0], srcs)):
            return hit[1]
        value = fn()
        self._memo[key] = (tuple(srcs), value)
        return value

    def host_ints(self, op, slot):
        """Input ``slot`` of ``op`` as a list of Python ints: from the
        host array the feed came from (no wait on the device), else read
        from the tensor, once a run."""
        name = op.input(slot)[0]
        t = self.get(name)

        def read():
            fed = self.host_feeds.get(name)
            if fed is not None and fed[0] is t:
                return [int(x) for x in np.asarray(fed[1]).reshape(-1)]
            return [int(x) for x in t.reshape(-1).tolist()]

        return self.memo(("host_ints", name), (t,), read)

    def host_values(self, op, slot):
        """Input ``slot`` of ``op`` as a flat list of Python numbers for
        an output shape that depends on them: from the host array the
        feed came from, else read from the tensor, counted in
        ``op_host_reads``."""
        name = op.input(slot)[0]
        t = self.get(name)
        fed = self.host_feeds.get(name)
        if fed is not None and fed[0] is t:
            return np.asarray(fed[1]).reshape(-1).tolist()
        if t.device.type == "meta":  # shape inference: no values to read
            raise SkipInferShape()
        profiler.bump_counter(HOST_READ_COUNTER)
        return t.reshape(-1).tolist()

    def host_array(self, name):
        """Env entry ``name`` as a numpy array, for an op that computes
        on the host: the host array the feed came from, else the tensor
        read once, counted in ``op_host_reads``."""
        t = self.get(name)
        fed = self.host_feeds.get(name)
        if fed is not None and fed[0] is t:
            return np.asarray(fed[1])
        if t.device.type == "meta":
            raise SkipInferShape()
        profiler.bump_counter(HOST_READ_COUNTER)
        return t.detach().cpu().numpy()

    def write_state(self, op, in_slot, out_slot, value):
        """The new value of a state input (``auc``'s buckets, a center
        table): copied into the input's tensor when ``out_slot`` names
        the same variable, as the layers build it (the update ops'
        in-place form), else set as a tensor of its own."""
        t = self.in1(op, in_slot)
        if op.outputs.get(out_slot) == op.inputs.get(in_slot):
            with torch.no_grad():
                t.copy_(value)
            value = t
        self.out(op, out_slot, value)

    # -- env access --
    def get(self, name):
        if name == EMPTY_VAR:
            return None
        try:
            return self.env[name]
        except KeyError:
            raise KeyError(
                "var %r is not materialized in the lowering environment"
                % name)

    def get_opt(self, name):
        if name == EMPTY_VAR:
            return None
        return self.env.get(name)

    def set(self, name, value):
        if name != EMPTY_VAR:
            self.env[name] = value

    # -- op-relative access --
    def in1(self, op, slot, idx=0, optional=False):
        names = op.inputs.get(slot) or []
        if not names or names[idx] == EMPTY_VAR:
            if optional:
                return None
            raise KeyError("op %s missing input slot %r" % (op.type, slot))
        return self.get(names[idx]) if not optional else self.get_opt(
            names[idx])

    def ins(self, op, slot):
        return [self.get(n) for n in op.inputs.get(slot, []) if n != EMPTY_VAR]

    def out(self, op, slot, value, idx=0):
        names = op.outputs.get(slot) or []
        if names and names[idx] != EMPTY_VAR:
            self.set(names[idx], value)

    def outs(self, op, slot, values):
        names = op.outputs.get(slot) or []
        for n, v in zip(names, values):
            if n != EMPTY_VAR:
                self.set(n, v)

    def generator(self, op=None):
        """The device generator for the op being lowered: a fresh one from
        the op's nonzero ``seed`` attr (fully deterministic, as the
        reference's seeded ops), else the run's shared generator."""
        op = op or self._cur_op
        seed = int(op.attr("seed", 0) or 0) if op is not None else 0
        if seed:
            return torch.Generator(device=self.device).manual_seed(seed)
        if self.rng is None:
            raise RuntimeError("random op lowered without a generator")
        return self.rng[0]

    def host_generator(self):
        """The run's CPU generator (integer seeds drawn on the host)."""
        if self.rng is None:
            raise RuntimeError("random op lowered without a generator")
        return self.rng[1]


class OpError(RuntimeError):
    """Lowering/runtime failure annotated with the op's Python creation
    site (reference: framework/op_call_stack.cc InsertCallStackInfo)."""


def _raise_op_error(op, e):
    stack = op.attr("op_callstack") if hasattr(op, "attr") else None
    site = "\n  defined at:\n    " + "\n    ".join(stack) if stack else ""
    raise OpError("error lowering op %r: %s: %s%s"
                  % (op.type, type(e).__name__, e, site)) from e


def run_op(ctx, op):
    """Lower a single op into the context environment."""
    d = get_op_def(op.type)
    if d is None or d.lower is None:
        raise NotImplementedError(
            "no lowering rule registered for op %r" % op.type)
    prev = ctx._cur_op
    ctx._cur_op = op
    try:
        d.lower(ctx, op)
    except OpError:
        raise
    except Exception as e:
        _raise_op_error(op, e)
    finally:
        ctx._cur_op = prev


# ---------------------------------------------------------------------------
# Generic grad: desc maker + vjp lowering
# ---------------------------------------------------------------------------
def generic_grad_maker(op):
    """Grad-op spec with the reference naming convention: inputs are the
    forward inputs, forward outputs, and output grads (slot ``S@GRAD``);
    outputs are input grads. The forward signature is recorded in attrs so
    the vjp lowering can run the forward rule."""
    g_inputs = {}
    for slot, names in op.inputs.items():
        g_inputs[slot] = list(names)
    for slot, names in op.outputs.items():
        g_inputs[slot] = list(names)
        g_inputs[slot + GRAD_SUFFIX] = [n + GRAD_SUFFIX for n in names]
    g_outputs = {
        slot + GRAD_SUFFIX: [n + GRAD_SUFFIX for n in names]
        for slot, names in op.inputs.items()
    }
    attrs = dict(op.attrs)
    attrs[FWD_INPUTS_ATTR] = {k: list(v) for k, v in op.inputs.items()}
    attrs[FWD_OUTPUTS_ATTR] = {k: list(v) for k, v in op.outputs.items()}
    return [dict(type=op.type + "_grad", inputs=g_inputs, outputs=g_outputs,
                 attrs=attrs)]


class _FakeOp(object):
    """Lightweight op stand-in for running a forward rule inside vjp."""

    __slots__ = ("type", "inputs", "outputs", "attrs")

    def __init__(self, type, inputs, outputs, attrs):
        self.type = type
        self.inputs = inputs
        self.outputs = outputs
        self.attrs = attrs

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def has_attr(self, name):
        return name in self.attrs

    def input(self, slot):
        return list(self.inputs.get(slot, []))

    def output(self, slot):
        return list(self.outputs.get(slot, []))


def _is_float(v):
    return isinstance(v, torch.Tensor) and v.is_floating_point()


def _grad_wrt(ctx, grad_op, fwd_op=None):
    """[(input name, grad name, input slot, index)] the generic grad op
    computes: its non-empty ``S@GRAD`` outputs whose forward input is a
    float tensor (read under ``fwd_op``'s name for that place when given:
    a recompute replay reads a barriered ``v@CKPT@k``)."""
    fwd_inputs = grad_op.attr(FWD_INPUTS_ATTR)
    wrt = []
    for gslot, gnames in grad_op.outputs.items():
        if not gslot.endswith(GRAD_SUFFIX):
            continue
        slot = gslot[: -len(GRAD_SUFFIX)]
        src = fwd_inputs.get(slot, [])
        if fwd_op is not None:
            src = fwd_op.inputs.get(slot, [])
        for idx, gname in enumerate(gnames):
            if gname != EMPTY_VAR and idx < len(src) and \
                    _is_float(ctx.get_opt(src[idx])):
                wrt.append((src[idx], gname, slot, idx))
    return wrt


def _vjp_of_forward(ctx, fwd_type, fwd_inputs, fwd_outputs, attrs, wrt,
                    cot_names):
    """Run the forward rule once on the autograd tape with respect to the
    ``wrt`` input names. Returns (vjp_fn, {output name: value}) for every
    forward output (detached); ``vjp_fn`` takes cotangents for
    ``cot_names`` (float outputs, in that order) and returns the grads of
    the ``wrt`` inputs (zeros where an input does not reach an output).

    This is the vjp ``torch.func.vjp`` would give, without its per-call
    pytree and transform-level bookkeeping, which costs the host several
    times a small op's own dispatch. The closure keeps the outputs' gradient
    edges, not the outputs, so an output's memory goes when the run's
    environment drops it, as eager autograd frees what nothing saved."""
    fwd_def = get_op_def(fwd_type)
    fake = _FakeOp(fwd_type, fwd_inputs, fwd_outputs, attrs)
    env = {}
    for names in fwd_inputs.values():
        for n in names:
            v = ctx.get_opt(n)
            if v is not None:
                env[n] = v
    leaves = [ctx.get(n).detach().requires_grad_() for n, _g, _s in wrt]
    env.update(zip((n for n, _g, _s in wrt), leaves))
    sub = LowerCtx(env=env, device=ctx.device, rng=ctx.rng, block=ctx.block,
                   scope=ctx.scope, host_feeds=ctx.host_feeds, parent=ctx)
    sub._cur_op = fake
    given = set(env)
    with torch.enable_grad():
        fwd_def.lower(sub, fake)
    # an output the rule left unset, or set to a non-tensor, takes none
    edges = [get_gradient_edge(env[n]) if isinstance(env.get(n),
                                                     torch.Tensor)
             and env[n].requires_grad else None for n in cot_names]
    # the outputs, and what else the rule set (an output's @SEQ_LEN)
    outs = {n for names in fwd_outputs.values() for n in names}
    values = {n: v.detach() if isinstance(v, torch.Tensor) else v
              for n, v in env.items() if n not in given or n in outs}

    def vjp_fn(cots):
        pairs = [(e, c) for e, c in zip(edges, cots)
                 if e is not None and c is not None]
        if not pairs:
            return [torch.zeros_like(x) for x in leaves]
        return torch.autograd.grad([e for e, _c in pairs], leaves,
                                   [c for _e, c in pairs], allow_unused=True,
                                   materialize_grads=True)

    return vjp_fn, values


def _rule_vjp(ctx, op, rule, wrt, cot_names):
    """Lower forward ``op`` through its registered ``vjp`` rule; returns
    a ``vjp_fn`` with ``_vjp_of_forward``'s interface."""
    slots = [slot for _n, _g, slot in wrt]
    pullback = rule(ctx, op, set(slots))
    out = ctx.get(cot_names[0])
    meta = (out.shape, out.dtype, out.device)

    def vjp_fn(cots):
        (g,) = cots
        if g is None:
            g = torch.zeros(meta[0], dtype=meta[1], device=meta[2])
        grads = pullback(g)
        return [grads[slot] for slot in slots]

    return vjp_fn


def rule_output(op):
    """The output a ``vjp`` rule's pullback differentiates: the first of
    ``Out``, ``Y`` and ``Output`` the op has."""
    for slot in ("Out", "Y", "Output"):
        names = op.outputs.get(slot)
        if names and names[0] != EMPTY_VAR:
            return names[0]
    return None


def differentiable_outputs(op):
    """The outputs a gradient flows back from when nothing says which
    ones receive one (the dygraph tracer): an op with a ``vjp`` rule,
    the output its rule differentiates; any other op, all of them."""
    if get_op_def(op.type).vjp is not None and rule_output(op) is not None:
        return [rule_output(op)]
    return [n for names in op.outputs.values() for n in names]


def capture_vjp(ctx, op, wrt, cot_names):
    """Run forward ``op`` once, through its ``vjp`` rule when the only
    cotangent is its rule's output, else on the autograd tape; returns
    (vjp_fn, {name: value} to set in the environment).
    ``vjp_fn`` takes a cotangent (or None) for each of ``cot_names`` and
    returns the grads of the ``wrt`` inputs [(name, grad name, slot)]."""
    prev = ctx._cur_op
    ctx._cur_op = op
    try:
        rule = get_op_def(op.type).vjp
        if rule is not None and list(cot_names) == [rule_output(op)]:
            return _rule_vjp(ctx, op, rule, wrt, cot_names), {}
        return _vjp_of_forward(ctx, op.type, op.inputs, op.outputs,
                               op.attrs, wrt, cot_names)
    except Exception as e:
        _raise_op_error(op, e)
    finally:
        ctx._cur_op = prev


def run_op_capturing(ctx, op, grad_op, cot_names, grad_cot_names):
    """Run forward ``op`` once (``capture_vjp``) and keep the vjp closure
    for its generic ``grad_op`` (same run). ``cot_names``: the float
    outputs of ``op`` that receive a gradient in the block;
    ``grad_cot_names``: their cotangents, the grad op's ``S@GRAD`` inputs
    at their places (a recompute replay's ``v@RECOMPUTE@k`` gets
    ``v@GRAD``).
    The grads are taken with respect to ``op``'s own inputs at the slots
    and places the grad op asks for."""
    wrt = [(op.inputs[slot][idx], gname, slot)
           for _n, gname, slot, idx in _grad_wrt(ctx, grad_op, op)]
    vjp_fn, values = capture_vjp(ctx, op, wrt, cot_names)
    for n, v in values.items():
        ctx.set(n, v)
    ctx.vjps[id(grad_op)] = (vjp_fn, wrt, list(grad_cot_names))


def _generic_grad_lower(ctx, op):
    """Lower ``foo_grad`` through the vjp of foo's forward rule: the
    closure kept by ``run_op_capturing`` when there is one,
    else a counted replay of the forward."""
    kept = ctx.vjps.pop(id(op), None)
    if kept is not None:
        vjp_fn, wrt, cot_grads = kept
        if not wrt:
            return
        cots = [ctx.get_opt(c) for c in cot_grads]
    else:
        fwd_inputs = op.attr(FWD_INPUTS_ATTR)
        fwd_outputs = op.attr(FWD_OUTPUTS_ATTR)
        if fwd_inputs is None or fwd_outputs is None:
            raise NotImplementedError(
                "generic grad for %s requires maker-recorded signature"
                % op.type)
        wrt = [w[:3] for w in _grad_wrt(ctx, op)]
        if not wrt:
            return
        outs = [(n, (op.inputs.get(slot + GRAD_SUFFIX) or [None] * (
                    k + 1))[k])
                for slot in sorted(fwd_outputs)
                for k, n in enumerate(fwd_outputs[slot])
                if n != EMPTY_VAR and _is_float(ctx.get_opt(n))]
        cot_names = [n for n, _c in outs]
        attrs = {k: v for k, v in op.attrs.items()
                 if k not in (FWD_INPUTS_ATTR, FWD_OUTPUTS_ATTR)}
        profiler.bump_counter(REPLAY_COUNTER)
        vjp_fn, values = _vjp_of_forward(
            ctx, op.type[: -len("_grad")], fwd_inputs, fwd_outputs, attrs,
            wrt, cot_names)
        cots = []
        for n, c in outs:
            g = ctx.get_opt(n + GRAD_SUFFIX)
            if g is None and c is not None:
                g = ctx.get_opt(c)
            if g is None:
                g = torch.zeros_like(values[n]) if n in values else None
            cots.append(g)
    grads = vjp_fn(tuple(cots))
    for (_name, gname, _slot), g in zip(wrt, grads):
        ctx.set(gname, g)


# ---------------------------------------------------------------------------
# generic infer_shape: the lowering run on "meta" tensors
# ---------------------------------------------------------------------------
# dynamic dims (-1) are probed with this size; output dims equal to it are
# mapped back to -1 (batch-dim propagation heuristic)
_PROBE_DIM = 977


def generic_infer_shape(op, block):
    """Compile-time shape/dtype propagation with no per-op rule: run the
    op's own lowering on ``device="meta"`` tensors built from the block's
    var metadata (the reference uses ``jax.eval_shape``). Meta tensors
    carry shapes and dtypes only, so this costs no arithmetic and cannot
    disagree with the run-time shapes."""
    d = get_op_def(op.type)
    if d is None or d.lower is None:
        raise SkipInferShape()
    if op.has_attr("sub_block"):
        raise SkipInferShape()
    meta = torch.device("meta")
    env = {}
    for name in op.input_arg_names:
        if name == EMPTY_VAR:
            continue
        v = block._find_var_recursive(name)
        if v is None or v.shape is None:
            raise SkipInferShape()
        shape = tuple(_PROBE_DIM if int(s) < 0 else int(s) for s in v.shape)
        try:
            dt = core.dtype_to_torch(v.dtype)
        except (KeyError, TypeError):
            raise SkipInferShape()
        env[name] = torch.empty(shape, dtype=dt, device=meta)
    ctx = LowerCtx(env=env, device=meta, block=block)
    ctx._cur_op = op
    try:
        with torch.no_grad():
            d.lower(ctx, op)
    except Exception:
        raise SkipInferShape()
    for n in op.output_arg_names:
        if n == EMPTY_VAR or n not in env:
            continue
        v = block._find_var_recursive(n)
        t = env[n]
        if v is None or not isinstance(t, torch.Tensor):
            continue
        v.shape = tuple(-1 if int(s) == _PROBE_DIM else int(s)
                        for s in t.shape)
        v.dtype = core.np_to_dtype(t.dtype)


# ---------------------------------------------------------------------------
# infer_shape helpers
# ---------------------------------------------------------------------------
def set_out(op, block, slot, shape, dtype=None, idx=0):
    names = op.outputs.get(slot) or []
    if not names or names[idx] == EMPTY_VAR:
        return
    v = block._find_var_recursive(names[idx])
    if v is not None:
        v.shape = tuple(int(s) for s in shape)
        if dtype is not None:
            v.dtype = dtype


def in_var(op, block, slot, idx=0):
    names = op.inputs.get(slot) or []
    if not names:
        return None
    return block._find_var_recursive(names[idx])


def same_shape_infer(in_slot, out_slot="Out"):
    def infer(op, block):
        v = in_var(op, block, in_slot)
        if v is None:
            raise SkipInferShape()
        set_out(op, block, out_slot, v.shape, v.dtype)

    return infer

