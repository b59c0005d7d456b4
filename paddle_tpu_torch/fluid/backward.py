"""append_backward — desc-level reverse-mode autodiff (copy of
``paddle_tpu/fluid/backward.py``).

Reference: python/paddle/fluid/backward.py (append_backward:933, duplicate
output summation _addup_repetitive_outputs_:324, no-grad pruning
_remove_no_grad_branch_:406). Parity requires the grad-op graph (grad ops are
visible in the Program, named ``<op>_grad``, grads named ``<var>@GRAD``) —
so the port builds the same graph, and the Executor runs it. The generic
grad ops' lowerings are the vjp of the forward rule, taken on the
autograd tape (ops/registry.py). With ``checkpoints=`` the backward
region replays each inter-checkpoint forward segment before its grad ops
(``_recompute_transform``), the reference's desc op for op; the Executor
captures the replayed forwards, not the originals, so the segment's
activations are freed after their last forward read.
"""

from collections import defaultdict

from . import core
from .framework import (
    OP_ROLE_KEY,
    OP_ROLE_VAR_KEY,
    OpRole,
    Parameter,
    Variable,
    op_role_guard,
)
from .ops import registry as _registry

from .framework import _append_grad_suffix_, _strip_grad_suffix_  # noqa: E402

GRAD_SUFFIX = _registry.GRAD_SUFFIX
EMPTY_VAR = _registry.EMPTY_VAR


def _collect_no_grad(block, no_grad_set):
    no_grad = set(no_grad_set or set())
    for var in block.vars.values():
        if var.stop_gradient and not isinstance(var, Parameter):
            no_grad.add(var.name)
        if isinstance(var, Parameter) and not var.trainable:
            no_grad.add(var.name)
    return no_grad


def _is_differentiable_var(block, name):
    v = block._find_var_recursive(name)
    if v is None:
        return True  # unknown — assume float tensor
    return core.dtype_is_floating(v.dtype)


def _find_relevant_ops(block, loss_name):
    """Reverse slice: ops whose outputs (transitively) feed the loss."""
    needed = {loss_name}
    relevant = []
    for op_ in reversed(block.ops):
        if set(op_.output_arg_names) & needed:
            relevant.append(op_)
            needed |= set(op_.input_arg_names)
    relevant.reverse()
    return relevant


def _make_grad_op_specs(block, relevant_ops, no_grad):
    """Per-op grad specs in reverse topological order, with no-grad pruning
    (reference: _remove_no_grad_branch_)."""
    return [s for _, s in _make_grad_op_pairs(block, relevant_ops, no_grad)]


def _make_grad_op_pairs(block, relevant_ops, no_grad):
    """[(forward_op_index, grad_spec)] in reverse topological order."""
    specs = []
    # vars with a grad signal flowing back from the loss
    has_grad = set()
    loss_ops = list(reversed(relevant_ops))
    if loss_ops:
        has_grad |= set(loss_ops[0].output_arg_names)
    index_of = {id(op_): i for i, op_ in enumerate(relevant_ops)}
    for op_ in loss_ops:
        opdef = _registry.get_op_def(op_.type)
        if opdef is None or opdef.grad_maker is None:
            continue
        # skip ops none of whose outputs carry grad (no-grad branch pruning,
        # reference: _remove_no_grad_branch_)
        if not (set(op_.output_arg_names) & has_grad):
            continue
        op_specs = opdef.grad_maker(op_)
        for spec in op_specs:
            # prune grads for no-grad / non-float inputs
            for slot, names in list(spec["outputs"].items()):
                pruned = []
                for n in names:
                    base = _strip_grad_suffix_(n)
                    if (
                        base in no_grad
                        or not _is_differentiable_var(block, base)
                    ):
                        pruned.append(EMPTY_VAR)
                    else:
                        pruned.append(n)
                spec["outputs"][slot] = pruned
            if all(
                n == EMPTY_VAR
                for names in spec["outputs"].values()
                for n in names
            ):
                continue
            spec["attrs"][OP_ROLE_KEY] = OpRole.Backward
            specs.append((index_of[id(op_)], spec))
            # inputs that received a grad output now carry grad signal
            for names in spec["outputs"].values():
                for n in names:
                    if n != EMPTY_VAR:
                        has_grad.add(_strip_grad_suffix_(n))
    return specs


def _addup_repetitive_outputs(specs):
    """Fan-out handling (reference: backward.py:324): when several grad ops
    write the same ``x@GRAD``, rename each write and insert a ``sum`` op after
    the last producer."""
    # Writes to one grad name are grouped into GENERATIONS: a
    # read-modify-write op (while_grad / conditional_block_grad consumes
    # Out@GRAD and emits X@GRAD under the same name — the cotangent of a
    # DIFFERENT SSA value of the var) closes the current generation and
    # starts a new one. Producers are summed within a generation only;
    # summing across generations would add the post-loop cotangent into the
    # pre-loop one.
    gens = defaultdict(lambda: [[]])  # gname -> [generation -> [(i,slot,j)]]
    for i, spec in enumerate(specs):
        spec_reads = {
            n
            for names in spec["inputs"].values()
            for n in names
            if n != EMPTY_VAR
        }
        for slot, names in spec["outputs"].items():
            for j, n in enumerate(names):
                if n != EMPTY_VAR and n.endswith(GRAD_SUFFIX):
                    if n in spec_reads:
                        gens[n].append([(i, slot, j)])
                    else:
                        gens[n][-1].append((i, slot, j))
    insertions = []  # (after_idx, sum_spec)
    for gname, generations in gens.items():
        for g_id, plist in enumerate(generations):
            if len(plist) <= 1:
                continue
            new_names = []
            for k, (i, slot, j) in enumerate(plist):
                nn = "%s@RENAME@%d_%d" % (gname, g_id, k)
                specs[i]["outputs"][slot][j] = nn
                new_names.append(nn)
            last = max(i for i, _, _ in plist)
            insertions.append(
                (
                    last,
                    dict(
                        type="sum",
                        inputs={"X": new_names},
                        outputs={"Out": [gname]},
                        attrs={OP_ROLE_KEY: OpRole.Backward},
                    ),
                )
            )
    # apply insertions from the back so indices stay valid
    for after_idx, sum_spec in sorted(insertions, key=lambda t: -t[0]):
        specs.insert(after_idx + 1, sum_spec)
    return specs


RECOMPUTE_TAG = "@RECOMPUTE@"
CKPT_TAG = "@CKPT@"

_RECOMPUTE_RANDOM_OPS = {
    # outputs of random ops are kept, never replayed: a recompute replay
    # would draw fresh randomness and corrupt the gradients
    "uniform_random",
    "gaussian_random",
    "truncated_gaussian_random",
    "dropout",
    "sampling_id",
    "uniform_random_batch_size_like",
}


def _base_var_name(name):
    for tag in (GRAD_SUFFIX, RECOMPUTE_TAG, CKPT_TAG):
        i = name.find(tag)
        if i >= 0:
            name = name[:i]
    return name


def _recompute_transform(block, relevant, grad_pairs, checkpoints):
    """Reference-style activation checkpointing
    (_append_backward_ops_with_checkpoints_, reference backward.py:576):
    for each inter-checkpoint segment, in reverse order, emit (a) replayed
    copies of the segment's forward ops whose inputs are barriered
    checkpoint values and whose outputs are renamed ``v@RECOMPUTE@seg``,
    then (b) the segment's grad ops rewritten to read the replayed
    activations. The desc is the reference's op for op. The Executor
    drops the original activations after their last forward read and
    captures the replayed forwards for the generic grads
    (``executor._Plan``), so peak memory holds the checkpoints plus one
    segment's activations; ``recompute_barrier`` is an identity here, its
    ``Dep`` operand a read that orders the replay after the later
    segment's backward, as the interpreter runs ops in order anyway."""
    produced_by = {}
    for i, op_ in enumerate(relevant):
        for n in op_.output_arg_names:
            produced_by.setdefault(n, i)
    ckpt = sorted(
        {c for c in checkpoints if c in produced_by},
        key=lambda c: produced_by[c],
    )
    keep = set(ckpt)
    for op_ in relevant:
        if op_.type in _RECOMPUTE_RANDOM_OPS:
            keep |= set(op_.output_arg_names)
        if op_.has_attr("sub_block"):
            # control-flow ops are not replayed; their outputs stay live
            keep |= set(op_.output_arg_names)

    bounds = sorted({produced_by[c] for c in ckpt})
    segments = []
    s = 0
    for b in bounds:
        if b + 1 > s:
            segments.append((s, b + 1))
            s = b + 1
    if s < len(relevant):
        segments.append((s, len(relevant)))

    out_specs = []
    emitted_grads = set()  # grad vars produced by already-emitted specs
    for seg_id, (start, end) in enumerate(reversed(segments)):
        seg_grads = [spec for i, spec in grad_pairs if start <= i < end]
        if not seg_grads:
            continue
        seg_ops = relevant[start:end]
        rename = {}  # original var -> replayed name
        barriered = {}  # external var -> barrier alias
        rec_specs = []
        # cotangent entering this segment: grad of the boundary checkpoint
        # (produced by the later segment's backward, already emitted) —
        # routed through the barriers to order replay after that backward
        dep_name = None
        for n in relevant[end - 1].output_arg_names:
            g = _append_grad_suffix_(n)
            if n in keep and g in emitted_grads:
                dep_name = g
                break

        def _alias(n):
            if n in rename:
                return rename[n]
            v = block._find_var_recursive(n)
            if v is not None and (isinstance(v, Parameter) or v.persistable):
                # params/persistables are live anyway; a barrier would only
                # force a copy. CSE through them is broken by the barriered
                # activation operand of the same op.
                return n
            if n not in barriered:
                barriered[n] = "%s%s%d" % (n, CKPT_TAG, seg_id)
                b_inputs = {"X": [n]}
                if dep_name is not None:
                    b_inputs["Dep"] = [dep_name]
                rec_specs.append(
                    dict(
                        type="recompute_barrier",
                        inputs=b_inputs,
                        outputs={"Out": [barriered[n]]},
                        attrs={OP_ROLE_KEY: OpRole.Backward},
                    )
                )
            return barriered[n]

        for op_ in seg_ops:
            if op_.type in _RECOMPUTE_RANDOM_OPS or op_.has_attr("sub_block"):
                continue
            # inputs: replayed if produced in-segment, barriered otherwise
            new_inputs = {}
            for slot, names in op_.inputs.items():
                nn = []
                for n in names:
                    if n == EMPTY_VAR:
                        nn.append(n)
                    elif n in rename:
                        nn.append(rename[n])
                    else:
                        nn.append(_alias(n))
                new_inputs[slot] = nn
            new_outputs = {}
            for slot, names in op_.outputs.items():
                nn = []
                for n in names:
                    if n == EMPTY_VAR or n in keep:
                        nn.append(n if n == EMPTY_VAR else _alias_out(n, rename, seg_id))
                    else:
                        rename[n] = "%s%s%d" % (n, RECOMPUTE_TAG, seg_id)
                        nn.append(rename[n])
                new_outputs[slot] = nn
            rec_specs.append(
                dict(
                    type=op_.type,
                    inputs=new_inputs,
                    outputs=new_outputs,
                    attrs=dict(op_.attrs, **{OP_ROLE_KEY: OpRole.Backward}),
                )
            )

        # rewrite this segment's grad specs to read replayed activations;
        # kept vars (checkpoints, random outputs) are read directly — they
        # are live, and the unused replay aliases are dropped after the
        # replay (the Executor's liveness)
        remap = {k: v for k, v in rename.items() if k not in keep}
        for spec in seg_grads:
            for slot, names in spec["inputs"].items():
                if slot.endswith(GRAD_SUFFIX):
                    continue
                spec["inputs"][slot] = [remap.get(n, n) for n in names]
            for key in (
                _registry.FWD_INPUTS_ATTR,
                _registry.FWD_OUTPUTS_ATTR,
            ):
                sig = spec["attrs"].get(key)
                if sig:
                    spec["attrs"][key] = {
                        slot: [remap.get(n, n) for n in names]
                        for slot, names in sig.items()
                    }
        out_specs.extend(rec_specs)
        out_specs.extend(seg_grads)
        for spec in seg_grads:
            for names in spec["outputs"].values():
                emitted_grads.update(n for n in names if n != EMPTY_VAR)
    return out_specs


def _alias_out(n, rename, seg_id):
    """A kept var written inside a replayed segment (e.g. the checkpoint
    itself, which ends the segment): replay it under a renamed alias too so
    the replay never clobbers live state."""
    rename[n] = "%s%s%d" % (n, RECOMPUTE_TAG, seg_id)
    return rename[n]


def _create_grad_vars(block, specs):
    for spec in specs:
        for names in spec["outputs"].values():
            for n in names:
                if n == EMPTY_VAR or block.has_var_recursive(n):
                    continue
                base = block._find_var_recursive(_base_var_name(n))
                block.create_var(
                    name=n,
                    shape=base.shape if base is not None else (),
                    dtype=base.dtype if base is not None else core.VarDesc.VarType.FP32,
                    persistable=False,
                    stop_gradient=False,
                )


def append_backward(
    loss, parameter_list=None, no_grad_set=None, callbacks=None,
    checkpoints=None,
):
    """Append grad ops for `loss` to its program; returns [(param, grad)].

    ``checkpoints``: list of Variables to treat as recompute checkpoints —
    the backward region replays each inter-checkpoint forward segment from
    barriered checkpoint values (_recompute_transform; reference:
    _append_backward_ops_with_checkpoints_, backward.py:576); wired through
    RecomputeOptimizer.
    """
    assert isinstance(loss, Variable), "loss must be a Variable"
    program = loss.block.program
    block = program.global_block()
    no_grad = _collect_no_grad(block, no_grad_set)

    # mark the loss op (reference adds OpRole.Loss to the producing op)
    for op_ in reversed(block.ops):
        if loss.name in op_.output_arg_names:
            op_.attrs[OP_ROLE_KEY] = op_.attrs.get(OP_ROLE_KEY, 0) | OpRole.Loss
            break

    relevant = _find_relevant_ops(block, loss.name)

    with op_role_guard(OpRole.Backward):
        # d(loss)/d(loss) = 1
        loss_grad_name = _append_grad_suffix_(loss.name)
        block.create_var(
            name=loss_grad_name,
            shape=loss.shape or (1,),
            dtype=loss.dtype,
            persistable=False,
        )
        block.append_op(
            type="fill_constant",
            outputs={"Out": [loss_grad_name]},
            attrs={
                "shape": list(loss.shape or (1,)),
                "dtype": loss.dtype,
                "value": 1.0,
                OP_ROLE_KEY: OpRole.Backward,
            },
        )

        ckpt_names = [
            c.name if isinstance(c, Variable) else c
            for c in (checkpoints or [])
        ]
        if ckpt_names:
            pairs = _make_grad_op_pairs(block, relevant, no_grad)
            specs = _recompute_transform(block, relevant, pairs, ckpt_names)
        else:
            specs = _make_grad_op_specs(block, relevant, no_grad)
        specs = _addup_repetitive_outputs(specs)
        _create_grad_vars(block, specs)
        for spec in specs:
            block.append_op(
                type=spec["type"],
                inputs=spec["inputs"],
                outputs=spec["outputs"],
                attrs=spec["attrs"],
            )

    # collect (param, grad) pairs
    if parameter_list is not None:
        params = []
        for p in parameter_list:
            params.append(block._var_recursive(p) if isinstance(p, str) else p)
    else:
        params = [
            p
            for p in block.all_parameters()
            if p.trainable and p.name not in no_grad
        ]
    params_grads = []
    for p in params:
        gname = _append_grad_suffix_(p.name)
        if block.has_var_recursive(gname):
            g = block._var_recursive(gname)
            params_grads.append((p, g))
    # annotate backward ops with their param/grad pairs for the collective
    # transpiler (reference: OP_ROLE_VAR_KEY attr)
    pg_names = {g.name: p.name for p, g in params_grads}
    for op_ in block.ops:
        if not (op_.attr(OP_ROLE_KEY, 0) & OpRole.Backward):
            continue
        role_vars = []
        for n in op_.output_arg_names:
            if n in pg_names:
                role_vars.extend([pg_names[n], n])
        if role_vars:
            op_.attrs[OP_ROLE_VAR_KEY] = role_vars
    program._params_grads = [(p.name, g.name) for p, g in params_grads]
    return params_grads


def calc_gradient(targets, inputs, target_gradients=None,
                  no_grad_set=None):
    """reference: backward.py calc_gradient — the underlying API
    ``gradients`` wraps (same contract here)."""
    return gradients(targets, inputs, target_gradients, no_grad_set)


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """reference: backward.py gradients — grads of targets wrt inputs."""
    if not isinstance(targets, (list, tuple)):
        targets = [targets]
    if not isinstance(inputs, (list, tuple)):
        inputs = [inputs]
    if len(targets) != 1:
        raise NotImplementedError("gradients() currently supports one target")
    loss = targets[0]
    append_backward(loss, no_grad_set=no_grad_set)
    block = loss.block.program.global_block()
    outs = []
    for x in inputs:
        gname = _append_grad_suffix_(x.name)
        outs.append(
            block._var_recursive(gname) if block.has_var_recursive(gname) else None
        )
    return outs
