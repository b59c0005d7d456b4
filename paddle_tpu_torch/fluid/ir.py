"""ir::Graph / Pass / PassBuilder user API (port of
``paddle_tpu/fluid/ir.py``; reference: framework/ir/graph.h, pass.h +
REGISTER_PASS, pass_builder.h).

A Pass rewrites the Program IR directly through an ``IrGraph`` view (op
and var nodes over a Program's block), and ``PassBuilder`` keeps the
reference's append/insert/remove API. Three passes are registered:
``delete_dropout_pass``, ``amp_rewrite_pass`` (the AMP program rewrite)
and ``collective_grad_allreduce_pass`` (the data-parallel gradient
allreduce, which ``CompiledProgram.with_data_parallel`` runs). The
reference's ``fuse_elewise_add_act_pass`` and
``quantization_transform_pass`` rewrite into ops the port has not ported
yet; ``get_pass`` of one of them raises the reference's ``ValueError``
for an unregistered pass.
"""

_PASS_REGISTRY = {}


class IrNode(object):
    """A node view over an Operator or Variable (reference: ir/node.h)."""

    def __init__(self, graph, obj, is_op):
        self._graph = graph
        self._obj = obj
        self._is_op = is_op

    def is_op(self):
        return self._is_op

    def is_var(self):
        return not self._is_op

    def name(self):
        return self._obj.type if self._is_op else self._obj.name

    def op(self):
        return self._obj if self._is_op else None

    def var(self):
        return None if self._is_op else self._obj

    # op-node helpers
    def inputs(self):
        if self._is_op:
            return [
                self._graph._var_node(n)
                for n in self._obj.input_arg_names
                if self._graph._block.has_var(n)
            ]
        return [
            IrNode(self._graph, o, True)
            for o in self._graph._block.ops
            if self._obj.name in o.output_arg_names
        ]

    def outputs(self):
        if self._is_op:
            return [
                self._graph._var_node(n)
                for n in self._obj.output_arg_names
                if self._graph._block.has_var(n)
            ]
        return [
            IrNode(self._graph, o, True)
            for o in self._graph._block.ops
            if self._obj.name in o.input_arg_names
        ]


class IrGraph(object):
    """Graph view over one Program block (reference: ir/graph.h built from
    ProgramDesc; Python wrapper framework.py:3125)."""

    def __init__(self, program, for_test=False, block_idx=0):
        self._program = program
        self._block = program.block(block_idx)
        self._for_test = for_test

    @property
    def program(self):
        return self._program

    def all_op_nodes(self):
        return [IrNode(self, o, True) for o in list(self._block.ops)]

    def all_var_nodes(self):
        return [IrNode(self, v, False) for v in self._block.vars.values()]

    def _var_node(self, name):
        return IrNode(self, self._block.var(name), False)

    def var_node(self, name):
        return self._var_node(name)

    def create_op_node(self, op_type, attrs, inputs, outputs, index=None):
        """Insert an op (reference: ir/graph.h CreateOpNode). inputs/outputs
        map slot -> [var name or IrNode]."""

        def names(d):
            return {
                k: [v.name() if isinstance(v, IrNode) else str(v) for v in vs]
                for k, vs in d.items()
            }

        if index is None:
            op_ = self._block.append_op(
                type=op_type, inputs=names(inputs), outputs=names(outputs),
                attrs=dict(attrs or {}),
            )
        else:
            op_ = self._block._insert_op(
                index, type=op_type, inputs=names(inputs),
                outputs=names(outputs), attrs=dict(attrs or {}),
            )
        return IrNode(self, op_, True)

    def create_persistable_node(self, name, var_type, shape, var_dtype):
        v = self._block.create_var(
            name=name, type=var_type, shape=shape, dtype=var_dtype,
            persistable=True,
        )
        return IrNode(self, v, False)

    def safe_remove_nodes(self, nodes):
        """Remove op nodes (reference: GraphSafeRemoveNodes, graph.h)."""
        targets = {id(n._obj) for n in nodes if n.is_op()}
        drop = [
            i
            for i, o in enumerate(self._block.ops)
            if id(o) in targets
        ]
        for i in reversed(drop):
            self._block._remove_op(i)

    def op_index(self, node):
        for i, o in enumerate(self._block.ops):
            if o is node._obj:
                return i
        return -1

    def to_program(self):
        return self._program


class Pass(object):
    """Base pass (reference: ir/pass.h). Subclasses implement apply()."""

    def __init__(self, name=None, **attrs):
        self.name = name or type(self).__name__
        self._attrs = dict(attrs)

    def set_attr(self, key, value):
        self._attrs[key] = value
        return self

    def attr(self, key, default=None):
        return self._attrs.get(key, default)

    def apply(self, graph):
        raise NotImplementedError

    def apply_program(self, program):
        g = IrGraph(program)
        self.apply(g)
        return program


def register_pass(name):
    """REGISTER_PASS equivalent (reference: ir/pass.h:REGISTER_PASS)."""

    def deco(cls):
        _PASS_REGISTRY[name] = cls
        cls.pass_name = name
        return cls

    return deco


def get_pass(name, **attrs):
    cls = _PASS_REGISTRY.get(name)
    if cls is None:
        raise ValueError(
            "pass %r is not registered (known: %s)"
            % (name, sorted(_PASS_REGISTRY))
        )
    p = cls(name=name)
    for k, v in attrs.items():
        p.set_attr(k, v)
    return p


def all_registered_passes():
    return sorted(_PASS_REGISTRY)


class PassBuilder(object):
    """Ordered pass pipeline (reference: ir/pass_builder.h, exposed at
    pybind.cc:1547 — append_pass/insert_pass/remove_pass/all_passes)."""

    def __init__(self):
        self._passes = []

    def append_pass(self, pass_or_name, **attrs):
        p = (
            pass_or_name
            if isinstance(pass_or_name, Pass)
            else get_pass(pass_or_name, **attrs)
        )
        self._passes.append(p)
        return p

    def insert_pass(self, idx, pass_or_name, **attrs):
        p = (
            pass_or_name
            if isinstance(pass_or_name, Pass)
            else get_pass(pass_or_name, **attrs)
        )
        self._passes.insert(idx, p)
        return p

    def remove_pass(self, idx):
        self._passes.pop(idx)

    def all_passes(self):
        return list(self._passes)

    def apply(self, program):
        for p in self._passes:
            p.apply_program(program)
        return program


# ---------------------------------------------------------------------------
# built-in semantic passes
# ---------------------------------------------------------------------------
@register_pass("delete_dropout_pass")
class DeleteDropoutPass(Pass):
    """Inference cleanup: replace dropout with scale(1.0) passthrough
    (reference analog: ir/mkldnn and inference passes drop test-mode
    dropout)."""

    def apply(self, graph):
        block = graph._block
        for i, op_ in enumerate(list(block.ops)):
            if op_.type != "dropout":
                continue
            x = op_.input("X")[0]
            out = op_.output("Out")[0]
            block._insert_op(
                i, type="scale", inputs={"X": [x]}, outputs={"Out": [out]},
                attrs={"scale": 1.0, "bias": 0.0},
            )
            block._remove_op(i + 1)


# ---------------------------------------------------------------------------
# the framework's own rewrite routed through the registry: AMP is an
# ordinary registered pass, so PassBuilder users can inspect, reorder or
# disable it (the implementation stays in its home module; the import is
# lazy to avoid a cycle)
# ---------------------------------------------------------------------------


@register_pass("amp_rewrite_pass")
class AmpRewritePass(Pass):
    """bf16-first AMP rewrite (home: contrib/mixed_precision/fp16_utils.py
    rewrite_program; reference analog: fluid/contrib/mixed_precision/
    fp16_utils.py rewrite_program). Attrs: ``amp_lists`` (defaults to
    AutoMixedPrecisionLists()), ``use_bf16`` (default True)."""

    def apply(self, graph):
        from .contrib.mixed_precision import fp16_lists, fp16_utils

        lists = self.attr("amp_lists") or fp16_lists.AutoMixedPrecisionLists()
        fp16_utils.rewrite_program(
            graph.program, lists, use_bf16=self.attr("use_bf16", True)
        )


@register_pass("collective_grad_allreduce_pass")
class CollectiveGradAllReducePass(Pass):
    """Data-parallel gradient allreduce insertion (home: transpiler/
    collective.py GradAllReduce; reference: multi_devices_graph_pass.cc:454
    CreateAllReduceOp + transpiler/collective.py:178). Attrs: ``nranks``
    (required), ``loss_name`` (required), ``nrings``."""

    def apply(self, graph):
        from .transpiler.collective import GradAllReduce

        t = GradAllReduce(nrings=self.attr("nrings", 1))
        t._transpile_main_program_inplace(
            graph.program,
            nranks=int(self.attr("nranks")),
            loss_name=self.attr("loss_name"),
        )
