"""Graph-building core: Program / Block / Operator / Variable / Parameter
(copy of ``paddle_tpu/fluid/framework.py``).

Mirrors the reference's Python frontend (python/paddle/fluid/framework.py:
Variable:561, Operator:1680, Block:2132, Program:3515, Parameter:4459,
default programs :4559-4647, program_guard :4679). The descriptors are
native Python objects that the port's Executor interprets op by op
(executor.py). Saving programs (proto.py) is not ported yet.
"""

import contextlib
import copy
import os

import numpy as np
import torch

from . import core
from . import unique_name
from .ops import registry as _registry

# Grad suffix contract shared with the reference so that var naming in saved
# programs matches (reference: python/paddle/fluid/backward.py, operator
# GradVarName() == name + "@GRAD"). Single source of truth: ops/registry.py.
EMPTY_VAR_NAME = _registry.EMPTY_VAR
GRAD_VAR_SUFFIX = _registry.GRAD_SUFFIX

ZERO_VAR_SUFFIX = "@ZERO"
TEMP_VAR_NAME = "@TEMP@"


def grad_var_name(name):
    return name + GRAD_VAR_SUFFIX


def _append_grad_suffix_(name):
    return name + GRAD_VAR_SUFFIX


def _strip_grad_suffix_(name):
    pos = name.find(GRAD_VAR_SUFFIX)
    return name[:pos] if pos != -1 else name


# ---------------------------------------------------------------------------
# Op roles (reference: framework/op_proto_maker.h OpRole enum): used by
# clone(for_test), AMP rewriting and the collective transpiler to tell
# forward / backward / optimize ops apart.
# ---------------------------------------------------------------------------
class OpRole(object):
    Forward = 0x0000
    Backward = 0x0001
    Optimize = 0x0002
    RPC = 0x0004
    Dist = 0x0008
    LRSched = 0x0010
    Loss = 0x0100
    Collective = 0x0200


OP_ROLE_KEY = "op_role"
OP_ROLE_VAR_KEY = "op_role_var"

_current_op_role = [OpRole.Forward]
_current_role_var = [[]]


@contextlib.contextmanager
def op_role_guard(role, role_var=None):
    _current_op_role.append(role)
    _current_role_var.append(role_var or [])
    try:
        yield
    finally:
        _current_op_role.pop()
        _current_role_var.pop()


def current_op_role():
    return _current_op_role[-1]


# ---------------------------------------------------------------------------
# dygraph-mode switch (reference: framework.py:85-122). Under the guard,
# ``Block.append_op`` hands each op to the tracer, which runs it at once.
# ---------------------------------------------------------------------------
_dygraph_tracer_ = None
_dygraph_current_expected_place_ = None


def in_dygraph_mode():
    return _dygraph_tracer_ is not None


def _dygraph_tracer():
    return _dygraph_tracer_


def _current_expected_place():
    """The guard's place; outside a guard the card, as every entry point
    of the port defaults to it (the reference's is the CPU)."""
    return _dygraph_current_expected_place_ or core.CUDAPlace(0)


@contextlib.contextmanager
def _dygraph_guard(tracer):
    global _dygraph_tracer_
    old = _dygraph_tracer_
    _dygraph_tracer_ = tracer
    try:
        yield
    finally:
        _dygraph_tracer_ = old


@contextlib.contextmanager
def _dygraph_place_guard(place):
    global _dygraph_current_expected_place_
    old = _dygraph_current_expected_place_
    _dygraph_current_expected_place_ = place
    try:
        yield
    finally:
        _dygraph_current_expected_place_ = old


# ---------------------------------------------------------------------------
# Variable
# ---------------------------------------------------------------------------
class Variable(object):
    """A named tensor slot in a Block (reference: framework.py:561).

    It is symbolic: shape/dtype/lod_level metadata only. ``-1`` in shape
    means unknown at build time (typically the batch); real shapes come
    with the values the Executor runs.
    """

    def __init__(
        self,
        block,
        type=core.VarDesc.VarType.LOD_TENSOR,
        name=None,
        shape=None,
        dtype=None,
        lod_level=None,
        capacity=None,
        persistable=None,
        error_clip=None,
        stop_gradient=False,
        is_data=False,
        need_check_feed=False,
        belong_to_optimizer=False,
        **kwargs,
    ):
        self.block = block
        if name is None:
            name = unique_name.generate("_generated_var")
        self.name = name
        self.type = type
        self.shape = tuple(shape) if shape is not None else ()
        if dtype is None:
            dtype = core.VarDesc.VarType.FP32
        if not isinstance(dtype, int):
            dtype = core.np_to_dtype(dtype)
        self.dtype = dtype
        self.lod_level = lod_level if lod_level is not None else 0
        self.persistable = bool(persistable) if persistable is not None else False
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.error_clip = error_clip
        self.need_check_feed = need_check_feed
        self.belong_to_optimizer = belong_to_optimizer
        self.op = None  # producing Operator, set by append_op

    # -- metadata --
    def _set_error_clip(self, error_clip):
        self.error_clip = error_clip

    @property
    def is_parameter(self):
        return isinstance(self, Parameter)

    def clone(self):
        return self.block.create_var(
            name=unique_name.generate_with_ignorable_key(self.name + "_clone")
            if hasattr(unique_name, "generate_with_ignorable_key")
            else unique_name.generate(self.name),
            shape=self.shape,
            dtype=self.dtype,
            lod_level=self.lod_level,
            persistable=self.persistable,
        )

    # -- eager value access (works after an Executor.run touched the var) --
    def get_value(self, scope=None):
        scope = scope or core.global_scope()
        return scope.get(self.name)

    def set_value(self, value, scope=None):
        scope = scope or core.global_scope()
        scope.set(self.name, torch.as_tensor(np.asarray(value)))

    def numpy(self):
        v = self.get_value()
        return None if v is None else v.detach().cpu().numpy()

    def __repr__(self):
        return "Variable(name=%r, shape=%s, dtype=%s%s)" % (
            self.name,
            list(self.shape),
            core.dtype_name(self.dtype) if isinstance(self.dtype, int) else self.dtype,
            ", persistable" if self.persistable else "",
        )

    __str__ = __repr__

    def to_string(self, throw_on_error=False, with_details=False):
        return repr(self)


class Parameter(Variable):
    """A persistable, trainable Variable (reference: framework.py:4459)."""

    def __init__(self, block, shape, dtype, **kwargs):
        kwargs.setdefault("persistable", True)
        self.trainable = kwargs.pop("trainable", True)
        self.optimize_attr = kwargs.pop("optimize_attr", {"learning_rate": 1.0})
        self.regularizer = kwargs.pop("regularizer", None)
        self.gradient_clip_attr = kwargs.pop("gradient_clip_attr", None)
        self.do_model_average = kwargs.pop("do_model_average", None)
        self.initializer = kwargs.pop("initializer", None)
        super().__init__(block, shape=shape, dtype=dtype, **kwargs)
        self.stop_gradient = not self.trainable


# ---------------------------------------------------------------------------
# Operator
# ---------------------------------------------------------------------------
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__))) + os.sep


def _user_callstack(limit=4):
    """Frames of the op's creation site OUTSIDE this package (the line the
    user actually wrote), innermost last, formatted 'File "f", line N, in
    fn'."""
    import traceback

    frames = []
    for fs in traceback.extract_stack()[:-2]:
        if fs.filename.startswith(_PKG_DIR):
            continue
        frames.append(
            'File "%s", line %d, in %s' % (fs.filename, fs.lineno, fs.name)
        )
    return frames[-limit:]


class Operator(object):
    """One op node (reference: framework.py:1680). inputs/outputs are
    dict slot-name -> list of var names; attrs is a plain dict."""

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        self.inputs = _normalize_io(inputs)
        self.outputs = _normalize_io(outputs)
        self.attrs = dict(attrs or {})
        if OP_ROLE_KEY not in self.attrs:
            self.attrs[OP_ROLE_KEY] = current_op_role()
        if "op_callstack" not in self.attrs:
            # record the user code line that appended this op, so lowering/
            # runtime errors can point at it (reference:
            # framework/op_call_stack.cc + framework.py:1774
            # kOpCreationCallstackAttrName)
            self.attrs["op_callstack"] = _user_callstack()
        # compile-time shape/dtype inference through the registry
        opdef = _registry.get_op_def(type)
        if opdef is not None:
            try:
                if opdef.infer_shape is not None:
                    opdef.infer_shape(self, block)
                elif not (type.endswith("@GRAD") or type.endswith("_grad")):
                    # no hand-written rule: abstract-evaluate the lowering
                    # (grad-op shapes come from their forward vars, set by
                    # append_backward)
                    _registry.generic_infer_shape(self, block)
            except _registry.SkipInferShape:
                pass

    # -- accessors matching the reference Operator API --
    def input(self, slot):
        return list(self.inputs.get(slot, []))

    def output(self, slot):
        return list(self.outputs.get(slot, []))

    @property
    def input_names(self):
        return list(self.inputs)

    @property
    def output_names(self):
        return list(self.outputs)

    @property
    def input_arg_names(self):
        return [n for ns in self.inputs.values() for n in ns]

    @property
    def output_arg_names(self):
        return [n for ns in self.outputs.values() for n in ns]

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def has_attr(self, name):
        return name in self.attrs

    def _set_attr(self, name, val):
        self.attrs[name] = val
        self.block.program._bump_version()

    def _rename_input(self, old, new):
        for slot, names in self.inputs.items():
            self.inputs[slot] = [new if n == old else n for n in names]
        self.block.program._bump_version()

    def _rename_output(self, old, new):
        for slot, names in self.outputs.items():
            self.outputs[slot] = [new if n == old else n for n in names]
        self.block.program._bump_version()

    def in_var(self, slot, idx=0):
        names = self.inputs.get(slot) or []
        return self.block._var_recursive(names[idx]) if names else None

    def out_var(self, slot, idx=0):
        names = self.outputs.get(slot) or []
        return self.block._var_recursive(names[idx]) if names else None

    def __repr__(self):
        io = lambda d: {k: v for k, v in d.items()}
        return "Operator(%s, inputs=%s, outputs=%s)" % (
            self.type,
            io(self.inputs),
            io(self.outputs),
        )

    __str__ = __repr__


def _normalize_io(io):
    """Accept {slot: Variable | name | list of either} -> {slot: [names]}."""
    out = {}
    for slot, args in (io or {}).items():
        if args is None:
            out[slot] = []
            continue
        if not isinstance(args, (list, tuple)):
            args = [args]
        out[slot] = [a.name if isinstance(a, Variable) else str(a) for a in args]
    return out


# ---------------------------------------------------------------------------
# Block
# ---------------------------------------------------------------------------
class Block(object):
    """Straight-line op list + symbol table; sub-blocks implement control
    flow (reference: framework.py:2132)."""

    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars = {}  # name -> Variable
        self.ops = []  # [Operator]
        self.forward_block_idx = -1  # for backward blocks of control flow

    @property
    def parent_block(self):
        if self.parent_idx == -1:
            return None
        return self.program.block(self.parent_idx)

    # -- vars --
    def create_var(self, **kwargs):
        name = kwargs.get("name")
        if name is not None and name in self.vars:
            return self.vars[name]
        v = Variable(self, **kwargs)
        self.vars[v.name] = v
        self.program._bump_version()
        return v

    def create_parameter(self, **kwargs):
        shape = kwargs.pop("shape")
        dtype = kwargs.pop("dtype")
        p = Parameter(self, shape, dtype, **kwargs)
        # parameters always live in the global block, as in the reference
        gb = self.program.global_block()
        gb.vars[p.name] = p
        p.block = gb
        self.program._bump_version()
        return p

    def var(self, name):
        v = self.vars.get(name)
        if v is None:
            raise ValueError(
                "var %r not found in block %d" % (name, self.idx)
            )
        return v

    def has_var(self, name):
        return name in self.vars

    def _var_recursive(self, name):
        b = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = b.parent_block
        raise ValueError("var %r not found in block hierarchy" % name)

    def _find_var_recursive(self, name):
        try:
            return self._var_recursive(name)
        except ValueError:
            return None

    def has_var_recursive(self, name):
        return self._find_var_recursive(name) is not None

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def _rename_var(self, old_name, new_name):
        v = self.vars.pop(old_name)
        v.name = new_name
        self.vars[new_name] = v
        for op in self.ops:
            op._rename_input(old_name, new_name)
            op._rename_output(old_name, new_name)
        self.program._bump_version()
        return v

    def _remove_var(self, name):
        self.vars.pop(name, None)
        self.program._bump_version()

    # -- ops --
    def append_op(self, type=None, inputs=None, outputs=None, attrs=None):
        if in_dygraph_mode():
            return _dygraph_tracer().trace_op(
                type, inputs or {}, outputs or {}, attrs or {})
        op = Operator(self, type, inputs=inputs, outputs=outputs, attrs=attrs)
        self.ops.append(op)
        for name in op.output_arg_names:
            v = self._find_var_recursive(name)
            if v is not None and v.op is None:
                v.op = op
        self.program._bump_version()
        return op

    def _prepend_op(self, type=None, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type, inputs=inputs, outputs=outputs, attrs=attrs)
        self.ops.insert(0, op)
        self.program._bump_version()
        return op

    def _insert_op(self, index, type=None, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type, inputs=inputs, outputs=outputs, attrs=attrs)
        self.ops.insert(index, op)
        self.program._bump_version()
        return op

    def _remove_op(self, index):
        self.ops.pop(index)
        self.program._bump_version()

    def __repr__(self):
        lines = ["Block(idx=%d, parent=%d)" % (self.idx, self.parent_idx)]
        for v in self.vars.values():
            lines.append("  " + repr(v))
        for op in self.ops:
            lines.append("  " + repr(op))
        return "\n".join(lines)

    __str__ = __repr__


# ---------------------------------------------------------------------------
# Program
# ---------------------------------------------------------------------------
class Program(object):
    """A whole computation: list of Blocks, block 0 global
    (reference: framework.py:3515)."""

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self._version = 0
        self._seed = 0
        self._is_distributed = False
        self._is_chief = True
        self.lr_sheduler = None
        # populated by append_backward: [(param_name, grad_name)]
        self._params_grads = []
        self._op_role = OpRole.Forward
        self._appending_grad_times = 0
        # data-parallel annotations consumed by the executor/compiler
        self._data_parallel = None

    # -- version: cache invalidation for compiled executables --
    def _bump_version(self):
        self._version += 1

    @property
    def random_seed(self):
        return self._seed

    @random_seed.setter
    def random_seed(self, seed):
        self._seed = int(seed)

    def global_block(self):
        return self.blocks[0]

    def block(self, idx):
        return self.blocks[idx]

    def current_block(self):
        return self.blocks[self.current_block_idx]

    @property
    def num_blocks(self):
        return len(self.blocks)

    def _create_block(self, parent_idx=None):
        new_idx = len(self.blocks)
        parent = (
            self.current_block_idx if parent_idx is None else parent_idx
        )
        self.blocks.append(Block(self, new_idx, parent))
        self.current_block_idx = new_idx
        self._bump_version()
        return self.current_block()

    def _rollback(self):
        self.current_block_idx = self.current_block().parent_idx

    def all_parameters(self):
        return self.global_block().all_parameters()

    def list_vars(self):
        for b in self.blocks:
            for v in b.vars.values():
                yield v

    # -- cloning (reference: framework.py:3775 clone(for_test)) --
    def clone(self, for_test=False):
        p = Program.__new__(Program)
        p.__dict__.update(
            {
                k: v
                for k, v in self.__dict__.items()
                # _rng_run_counters must NOT be shared: a clone is a new
                # program whose first run in any scope is run 0 (sharing
                # would make training dropout streams depend on how often
                # a for_test clone was evaluated in between)
                if k not in ("blocks", "_rng_run_counters")
            }
        )
        p._params_grads = list(self._params_grads)
        p.blocks = []
        memo = {}
        for b in self.blocks:
            nb = Block(p, b.idx, b.parent_idx)
            nb.forward_block_idx = b.forward_block_idx
            p.blocks.append(nb)
        for b, nb in zip(self.blocks, p.blocks):
            for name, v in b.vars.items():
                kwargs = dict(
                    name=v.name,
                    shape=v.shape,
                    dtype=v.dtype,
                    lod_level=v.lod_level,
                    persistable=v.persistable,
                    stop_gradient=v.stop_gradient,
                    is_data=v.is_data,
                    type=v.type,
                )
                if isinstance(v, Parameter):
                    nv = Parameter(
                        nb,
                        kwargs.pop("shape"),
                        kwargs.pop("dtype"),
                        trainable=v.trainable,
                        regularizer=v.regularizer,
                        optimize_attr=v.optimize_attr,
                        **kwargs,
                    )
                else:
                    nv = Variable(nb, **kwargs)
                nb.vars[name] = nv
            for op in b.ops:
                if for_test and (
                    op.attr(OP_ROLE_KEY, OpRole.Forward)
                    & (OpRole.Backward | OpRole.Optimize)
                ):
                    continue
                nop = Operator.__new__(Operator)
                nop.block = nb
                nop.type = op.type
                nop.inputs = {k: list(v) for k, v in op.inputs.items()}
                nop.outputs = {k: list(v) for k, v in op.outputs.items()}
                nop.attrs = copy.deepcopy(op.attrs)
                if for_test and "is_test" in nop.attrs:
                    nop.attrs["is_test"] = True
                nb.ops.append(nop)
        p.current_block_idx = 0
        p._version = 0
        if for_test:
            p._params_grads = []
        return p

    def _prune(self, feeds, fetches):
        """Keep only ops needed to compute `fetches` from `feeds`
        (reference: framework.py:3962). Operates on a clone."""
        p = self.clone(for_test=False)
        fetch_names = {
            f.name if isinstance(f, Variable) else str(f) for f in fetches
        }
        feed_names = {
            f.name if isinstance(f, Variable) else str(f) for f in feeds
        }
        b = p.global_block()
        needed = set(fetch_names)
        kept = []
        for op in reversed(b.ops):
            if set(op.output_arg_names) & needed:
                kept.append(op)
                needed |= set(op.input_arg_names) - feed_names
        b.ops = list(reversed(kept))
        p._bump_version()
        return p

    def to_string(self, throw_on_error=False, with_details=False):
        return "\n".join(str(b) for b in self.blocks)

    __str__ = to_string
    __repr__ = to_string

    # serialization through proto.py (framework.proto wire bytes)
    def desc_str(self):
        from . import proto

        return proto.program_to_bytes(self)

    @staticmethod
    def parse_from_string(binary):
        from . import proto

        return proto.program_from_bytes(binary)


# ---------------------------------------------------------------------------
# default programs + guards (reference: framework.py:4559-4725)
# ---------------------------------------------------------------------------
_main_program_ = Program()
_startup_program_ = Program()


def default_main_program():
    return _main_program_


def default_startup_program():
    return _startup_program_


def switch_main_program(program):
    global _main_program_
    old = _main_program_
    _main_program_ = program
    return old


def switch_startup_program(program):
    global _startup_program_
    old = _startup_program_
    _startup_program_ = program
    return old


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    old_main = switch_main_program(main_program)
    old_startup = None
    if startup_program is not None:
        old_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_startup is not None:
            switch_startup_program(old_startup)


_name_scope_stack = []


@contextlib.contextmanager
def name_scope(prefix=None):
    _name_scope_stack.append(prefix or "")
    try:
        yield
    finally:
        _name_scope_stack.pop()


def get_name_scope():
    return "/".join(s for s in _name_scope_stack if s)


def cpu_places(device_count=None):
    """``device_count`` CPUPlaces (default 1)."""
    return [core.CPUPlace()] * (device_count or 1)


def cuda_places(device_ids=None):
    """A CUDAPlace for each of ``device_ids`` (default: every visible
    card). On a machine without a card this raises: the port has no CPU
    fallback behind a place that names the GPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "cuda_places: no CUDA device is available; use cpu_places() "
            "to run on the CPU")
    if device_ids is None:
        device_ids = range(torch.cuda.device_count())
    return [core.CUDAPlace(i) for i in device_ids]
