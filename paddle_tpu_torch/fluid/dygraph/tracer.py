"""The eager tensor and the tracer with its tape (port of
``paddle_tpu/fluid/dygraph/tracer.py``; reference:
paddle/fluid/imperative/tracer.cc:81 ``Tracer::TraceOp``, engine.cc
``BasicEngine::Execute``, layer.h:55 ``VarBase``).

``Tracer.trace_op`` runs an op's lowering at once on the tensors of its
input ``VarBase``s, through the registry the Executor uses, so eager and
static mode share one implementation of every op. An op goes on the tape
only when it needs a gradient: one of its float inputs is a ``VarBase``
that does not stop the gradient. Its fresh outputs then carry the
gradient on; the fresh outputs of an op that needs none stop it, as
Paddle's tracer passes ``stop_gradient`` on. What an entry keeps depends
on the op's grad:

- a generic grad (the vjp of the forward rule): the forward runs once,
  through ``registry.capture_vjp`` as the Executor's captured ops do,
  and the entry keeps the pullback. The reference's tape replays the
  forward under ``jax.vjp``, which eager PyTorch would run a second
  time;
- an explicit grad maker (``softmax_with_cross_entropy``, ``dropout``,
  and ``flash_attention``, whose ``flash_attention_grad`` drives both
  backward kernels from the forward's out and lse): the forward runs
  outside autograd, the entry keeps the tensors its grad ops read (the
  companions the lowering set beside its outputs included), and the
  backward lowers those grad ops as the reference replays them.

An entry holds the ``VarBase``s it reads and writes by id and weak
reference only, so the tape keeps alive what the backward needs (what
autograd saved, what the grad ops read) and no more: an activation no
pullback reads goes when the user's code drops it, as in eager PyTorch.

``loss.backward()`` walks the tape in reverse, dropping each entry once
it has run, and the gradient of a ``VarBase`` that is gone once its
producer is reached. It sums each ``VarBase``'s contributions (in
forward order under ``BackwardStrategy.sorted_sum_gradient``), adds the
sums to every reached live ``VarBase``'s ``_grad`` (kept across calls
until ``clear_gradient``) and leaves the tape empty.
"""

import itertools
import weakref

import numpy as np
import torch

from .. import core
from .. import framework
from .. import unique_name
from ..ops import registry as _registry
from ..ops.registry import GRAD_SUFFIX, EMPTY_VAR, LowerCtx, _FakeOp

__all__ = ["VarBase", "Tracer"]

_UIDS = itertools.count()


def _as_list(v):
    return list(v) if isinstance(v, (list, tuple)) else [v]


def _is_float(t):
    return isinstance(t, torch.Tensor) and t.is_floating_point()


def _expected_device():
    tracer = framework._dygraph_tracer()
    if tracer is not None:
        return tracer.device
    return core.resolve_device(framework._current_expected_place())


def _to_tensor(value, like=None):
    """``value`` (a tensor, an array or a scalar) as a tensor of its own
    memory: on ``like``'s device in ``like``'s dtype when given, else on
    the guard's device in its own dtype."""
    if isinstance(value, VarBase):
        value = value._value
    t = value.detach() if isinstance(value, torch.Tensor) else \
        torch.from_numpy(np.array(value))
    if like is not None:
        return t.to(device=like.device, dtype=like.dtype, copy=True)
    return t.to(device=_expected_device(), copy=True)


class VarBase(object):
    """Eager tensor: a torch tensor on the guard's device and a gradient
    slot (reference: imperative/layer.h:55)."""

    def __init__(self, value=None, name=None, persistable=False,
                 stop_gradient=False, is_parameter=False):
        self.name = name or unique_name.generate("eager_tmp")
        self._uid = next(_UIDS)   # the tape's key: ids of dead objects recur
        self._value = value if value is None or isinstance(
            value, torch.Tensor) else _to_tensor(value)
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_parameter = is_parameter
        self._grad = None
        self.trainable = not stop_gradient

    # -- value access --
    @property
    def value(self):
        return self._value

    def set_value(self, value):
        """Replace the value by a copy of ``value``: a tensor, an array or
        a ``VarBase``, of this one's shape (cast to its dtype)."""
        if self._value is None:
            self._value = _to_tensor(value)
            return
        shape = tuple(value.shape) if hasattr(value, "shape") else \
            np.shape(value)
        if tuple(shape) != tuple(self._value.shape):
            raise ValueError("set_value of %r: shape %s, not %s"
                             % (self.name, list(shape),
                                list(self._value.shape)))
        self._value = _to_tensor(value, like=self._value)

    def numpy(self):
        """The value copied to the host (bf16 as fp32)."""
        t = self._value.detach()
        t = t.cpu() if t.device.type != "cpu" else t.clone()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    @property
    def shape(self):
        return tuple(self._value.shape) if self._value is not None else ()

    @property
    def dtype(self):
        return core.np_to_dtype(self._value.dtype)

    def detach(self):
        return VarBase(self._value.detach(), stop_gradient=True)

    # -- autograd --
    def backward(self, backward_strategy=None):
        tracer = framework._dygraph_tracer()
        if tracer is None:
            raise RuntimeError("backward() outside the dygraph guard")
        tracer.run_backward(self, backward_strategy)

    def gradient(self):
        if self._grad is None:
            return None
        g = self._grad.detach()
        g = g.cpu() if g.device.type != "cpu" else g.clone()
        return (g.float() if g.dtype == torch.bfloat16 else g).numpy()

    def clear_gradient(self):
        self._grad = None

    @property
    def grad(self):
        return self._grad

    def __repr__(self):
        return "VarBase(name=%s, shape=%s)" % (self.name, list(self.shape))

    # math ops go through the tracer, so the tape sees them; a Python
    # scalar becomes a [1] tensor of this one's dtype (reference :96-118)
    def _binary(self, other, op_type, reverse=False):
        tracer = framework._dygraph_tracer()
        x, y = self, other
        if np.isscalar(other):
            y = VarBase(torch.full((1,), other, dtype=self._value.dtype,
                                   device=self._value.device),
                        stop_gradient=True)
        if reverse:
            x, y = y, x
        outs = tracer.trace_op(op_type, {"X": [x], "Y": [y]}, {"Out": 1},
                               {"axis": -1})
        return outs["Out"][0]

    def __add__(self, o):
        return self._binary(o, "elementwise_add")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binary(o, "elementwise_sub")

    def __rsub__(self, o):
        return self._binary(o, "elementwise_sub", reverse=True)

    def __mul__(self, o):
        return self._binary(o, "elementwise_mul")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binary(o, "elementwise_div")


class _EnvScope(object):
    """Scope view over an op's environment, so host op lowerings (which
    read and write ``ctx.scope``) run under the tracer too."""

    __slots__ = ("_env",)

    def __init__(self, env):
        self._env = env

    def get(self, name, default=None):
        return self._env.get(name, default)

    def set(self, name, value):
        self._env[name] = value


class _Handle(object):
    """What a tape entry keeps of a ``VarBase``: its uid, its env name, a
    weak reference and, for an output, its value's (shape, dtype,
    device) for a zero cotangent."""

    __slots__ = ("uid", "name", "ref", "meta")

    def __init__(self, v, value=None):
        self.uid = v._uid
        self.name = v.name
        self.ref = weakref.ref(v)
        self.meta = None if not isinstance(value, torch.Tensor) else \
            (value.shape, value.dtype, value.device)

    def zeros(self):
        shape, dtype, device = self.meta
        return torch.zeros(shape, dtype=dtype, device=device)


class _Pullback(object):
    """Tape entry of a generic-grad op: the kept pullback, the outputs
    whose cotangents it takes, and the inputs it gives gradients of."""

    __slots__ = ("fn", "cots", "targets")

    def __init__(self, fn, cots, targets):
        self.fn = fn
        self.cots = cots
        self.targets = targets

    def backward(self, tracer, cots):
        return zip(self.targets, self.fn(tuple(cots)))


class _GradOps(object):
    """Tape entry of an op with an explicit grad maker: its grad op
    specs, the tensors they read, the outputs whose ``@GRAD`` they read,
    and {grad name: input handle} for what they write."""

    __slots__ = ("specs", "kept", "cots", "targets")

    def __init__(self, specs, kept, cots, targets):
        self.specs = specs
        self.kept = kept
        self.cots = cots
        self.targets = targets

    def backward(self, tracer, cots):
        env = dict(self.kept)
        for h, g in zip(self.cots, cots):
            env[h.name + GRAD_SUFFIX] = g if g is not None else h.zeros()
        ctx = LowerCtx(env=env, device=tracer.device, rng=tracer._rng,
                       scope=_EnvScope(env))
        for spec in self.specs:
            _registry.run_op(ctx, _FakeOp(spec["type"], spec["inputs"],
                                          spec["outputs"], spec["attrs"]))
        return [(h, env.get(n)) for n, h in self.targets.items()]


class Tracer(object):
    """Runs ops eagerly on ``device`` and records what their backward
    needs. Random ops draw from a (device, CPU) generator pair seeded from
    ``seed``, as a scope's runs do (``Scope.rng``). ``device`` defaults
    to the guard's place (``CUDAPlace(0)`` outside one), so a tracer
    raises on a machine without a GPU unless it is given the CPU."""

    def __init__(self, device=None, seed=0):
        self.device = core.resolve_device(
            framework._current_expected_place() if device is None
            else device)
        self._tape = []
        self._no_grad = False
        self._rng = (torch.Generator(device=self.device).manual_seed(
            int(seed)), torch.Generator().manual_seed(int(seed) + 1))

    def trace_op(self, type, inputs, outputs, attrs, stop_gradient=False):
        """Run op ``type`` now; returns {slot: [VarBase]} of its outputs.

        ``outputs`` maps a slot to a count of new ``VarBase``s or to the
        existing ones to write (an optimizer names its parameter again,
        and the op updates its tensor in place)."""
        opdef = _registry.get_op_def(type)
        if opdef is None or opdef.lower is None:
            raise NotImplementedError(
                "no lowering rule registered for op %r" % type)
        env, in_names, owners = {}, {}, {}
        for slot, vs in inputs.items():
            names = []
            for v in _as_list(vs):
                if v is None:
                    continue
                if not isinstance(v, VarBase):
                    raise TypeError(
                        "dygraph op %r: input %s is a %s, not a VarBase"
                        % (type, slot, v.__class__.__name__))
                # one env name per occurrence, so x * x gets both grads
                name, k = v.name, 0
                while name in env:
                    k += 1
                    name = "%s@DUP%d" % (v.name, k)
                env[name] = v._value
                owners[name] = v
                names.append(name)
            in_names[slot] = names
        out_vars, out_names = {}, {}
        for slot, spec in outputs.items():
            vs = [VarBase() for _ in range(spec)] if isinstance(spec, int) \
                else _as_list(spec)
            out_vars[slot] = vs
            out_names[slot] = [v.name for v in vs]
        fake = _FakeOp(type, in_names, out_names, dict(attrs or {}))
        ctx = LowerCtx(env=env, device=self.device, rng=self._rng,
                       scope=_EnvScope(env))
        wrt = []
        if not (self._no_grad or stop_gradient or opdef.grad_maker is None):
            wrt = [(n, n + GRAD_SUFFIX, slot)
                   for slot, names in in_names.items() for n in names
                   if not owners[n].stop_gradient and _is_float(env[n])]
        by_name = {v.name: v for vs in out_vars.values() for v in vs}
        fresh = [v for v in by_name.values() if v._value is None]
        entry = None
        if not wrt:
            with torch.no_grad():
                _registry.run_op(ctx, fake)
        elif opdef.grad_maker is _registry.generic_grad_maker and \
                _registry.is_generic_grad(type + "_grad"):
            entry = self._capture(ctx, fake, wrt, owners, by_name)
        else:
            entry = self._keep(ctx, fake, opdef, wrt, owners, by_name)
        for name, v in by_name.items():
            if name in env:
                v._value = env[name]
        carried = {h.uid for h in entry.cots} if entry else ()
        for v in fresh:
            v.stop_gradient = v._uid not in carried or not _is_float(v._value)
        if entry is not None:
            self._tape.append(entry)
        return out_vars

    def _capture(self, ctx, op_, wrt, owners, by_name):
        """Lower a generic-grad op once, keeping its pullback."""
        cots = _registry.differentiable_outputs(op_)
        fn, values = _registry.capture_vjp(ctx, op_, wrt, cots)
        ctx.env.update(values)
        return _Pullback(fn, [_Handle(by_name[n]) for n in cots],
                         [_Handle(owners[n]) for n, _g, _s in wrt])

    def _keep(self, ctx, op_, opdef, wrt, owners, by_name):
        """Lower an op outside autograd, keeping what its grad ops read."""
        given = set(ctx.env)
        with torch.no_grad():
            _registry.run_op(ctx, op_)
        wanted = {g for _n, g, _s in wrt}
        specs, reads = [], set()
        for spec in opdef.grad_maker(op_):
            outs = {slot: [n if n in wanted else EMPTY_VAR for n in names]
                    for slot, names in spec["outputs"].items()}
            specs.append(dict(spec, outputs=outs))
            reads.update(n for names in spec["inputs"].values()
                         for n in names)
        kept = {n: t for n, t in ctx.env.items()
                if n in reads or (n not in given and n not in by_name)}
        cots = [_Handle(v, ctx.env.get(n)) for n, v in by_name.items()
                if n + GRAD_SUFFIX in reads]
        return _GradOps(specs, kept, cots,
                        {g: _Handle(owners[n]) for n, g, _s in wrt})

    # -- backward (reference: BasicEngine::Execute, engine.cc) --
    def backward_grads(self, seeds, sorted_sum=False):
        """Walk the tape from ``seeds`` [(VarBase, cotangent)], emptying
        it; returns ({uid: summed gradient}, {uid: VarBase}) of every
        reached VarBase that is still alive. With ``sorted_sum`` each
        final sum adds its terms in forward-op order
        (``backward_strategy.h:24``)."""
        grads, refs = {}, {}
        contribs = {} if sorted_sum else None
        for v, g in seeds:
            grads[v._uid] = g
            refs[v._uid] = weakref.ref(v)
            if contribs is not None:
                contribs[v._uid] = [(len(self._tape), g)]
        tape, self._tape = self._tape, []
        with torch.no_grad():
            while tape:
                idx = len(tape) - 1
                entry = tape.pop()   # its kept tensors go after it runs
                cots = [grads.get(h.uid) for h in entry.cots]
                if any(c is not None for c in cots):
                    for h, g in entry.backward(self, cots):
                        target = h.ref()
                        if g is None or (target is not None
                                         and target.stop_gradient):
                            continue
                        k = h.uid
                        grads[k] = grads[k] + g if k in grads else g
                        refs[k] = h.ref
                        if contribs is not None:
                            contribs.setdefault(k, []).append((idx, g))
                # an output's gradient is whole once its op is reached:
                # one whose VarBase is gone is read by nobody
                for h in entry.cots:
                    if h.ref() is None:
                        grads.pop(h.uid, None)
                        refs.pop(h.uid, None)
                        if contribs is not None:
                            contribs.pop(h.uid, None)
                del entry, cots
        if contribs is not None:
            for k, cs in contribs.items():
                cs = sorted(cs, key=lambda c: c[0])
                total = cs[0][1]
                for _i, g in cs[1:]:
                    total = total + g
                grads[k] = total
        holders = {k: r() for k, r in refs.items()}
        return ({k: g for k, g in grads.items() if holders[k] is not None},
                {k: v for k, v in holders.items() if v is not None})

    def run_backward(self, loss, backward_strategy=None):
        """``loss.backward()``: every reached VarBase that does not stop
        the gradient gets its gradient added to ``_grad``; the tape is
        cleared."""
        sorted_sum = bool(getattr(backward_strategy, "sorted_sum_gradient",
                                  False))
        try:
            grads, holders = self.backward_grads(
                [(loss, torch.ones_like(loss._value))], sorted_sum)
            for k, g in grads.items():
                vb = holders[k]
                if not vb.stop_gradient:
                    vb._grad = g if vb._grad is None else vb._grad + g
        finally:
            self._tape = []

    def reset(self):
        self._tape = []
