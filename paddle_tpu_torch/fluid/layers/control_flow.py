"""Control-flow layers (port of ``paddle_tpu/fluid/layers/control_flow.py``):
the compares (each may write a given ``cond``), ``increment``, ``While``
and its block guard, ``Switch`` and ``cond`` over ``conditional_block``,
the tensor-array layers, and the LoD rank-table layers. ``While`` builds
a sub-block that the Executor runs while the condition holds;
``StaticRNN``, ``DynamicRNN`` and ``IfElse`` are not ported yet."""

from .. import core, unique_name
from ..executor import _analyze_ops
from ..layer_helper import LayerHelper

__all__ = [
    "While", "Switch", "lod_rank_table", "lod_tensor_to_array",
    "array_to_lod_tensor", "max_sequence_len", "shrink_memory",
    "increment", "array_write", "array_read", "array_length",
    "create_array", "less_than", "less_equal", "greater_than",
    "greater_equal", "equal", "not_equal", "cond", "is_empty",
]


def _compare(op_type, x, y, cond=None):
    helper = LayerHelper(op_type)
    if cond is None:
        cond = helper.create_variable_for_type_inference(
            dtype=core.VarDesc.VarType.BOOL)
        cond.stop_gradient = True
    helper.append_op(
        type=op_type, inputs={"X": [x], "Y": [y]}, outputs={"Out": [cond]})
    return cond


def less_than(x, y, force_cpu=None, cond=None):
    return _compare("less_than", x, y, cond)


def less_equal(x, y, cond=None):
    return _compare("less_equal", x, y, cond)


def greater_than(x, y, cond=None):
    return _compare("greater_than", x, y, cond)


def greater_equal(x, y, cond=None):
    return _compare("greater_equal", x, y, cond)


def equal(x, y, cond=None):
    return _compare("equal", x, y, cond)


def not_equal(x, y, cond=None):
    return _compare("not_equal", x, y, cond)


def increment(x, value=1.0, in_place=True):
    """x + value, written back to ``x`` when ``in_place``."""
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_variable_for_type_inference(
        dtype=x.dtype)
    helper.append_op(type="increment", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"step": float(value)})
    return out


class While(object):
    """A loop over a sub-block (``control_flow.py:99``)::

        cond = layers.less_than(i, n)
        loop = layers.While(cond)
        with loop.block():
            ...
            layers.increment(i)
            layers.less_than(i, n, cond=cond)
    """

    def __init__(self, cond, is_test=False, name=None):
        self.helper = LayerHelper("while", name=name)
        self.cond_var = cond
        self.is_test = is_test

    def block(self):
        return _WhileBlockGuard(self)


def _sub_block_guard(helper):
    main = helper.main_program
    parent = main.current_block()
    main._create_block()
    return parent


def _close_sub_block(helper):
    main = helper.main_program
    sub = main.current_block()
    main._rollback()
    return sub, main.current_block()


class _WhileBlockGuard(object):
    """Opens the loop's sub-block; on exit appends the ``while`` op to
    the parent: X the parent-visible names the body reads before it
    writes them, Out the parent-visible names it writes. A read inside
    a nested block counts (the reference's guard misses it, so its
    ``append_backward`` drops that gradient without a word)."""

    def __init__(self, while_op):
        self.while_op = while_op

    def __enter__(self):
        _sub_block_guard(self.while_op.helper)
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is not None:
            return False
        helper = self.while_op.helper
        sub, parent = _close_sub_block(helper)
        reads, writes = _analyze_ops(sub.ops)
        step_scopes = parent.create_var(
            name=helper.name + ".step_scopes",
            type=core.VarDesc.VarType.STEP_SCOPES)
        parent.append_op(
            type="while",
            inputs={"X": [n for n in reads
                          if parent._find_var_recursive(n)],
                    "Condition": [self.while_op.cond_var]},
            outputs={"Out": [n for n in writes
                             if parent._find_var_recursive(n)],
                     "StepScopes": [step_scopes]},
            attrs={"sub_block": sub.idx, "is_test": self.while_op.is_test})
        return True


class Switch(object):
    """Cases tried in order, each a ``conditional_block`` whose condition
    is its own and the negations of the cases before it
    (``control_flow.py:161``)::

        with layers.Switch() as switch:
            with switch.case(cond_a):
                ...
            with switch.default():
                ...
    """

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self.inside_scope = False
        self.pre_not_conditions = []

    def case(self, condition):
        return _SwitchCaseGuard(self, condition)

    def default(self):
        return _SwitchCaseGuard(self, None)

    def __enter__(self):
        self.inside_scope = True
        return self

    def __exit__(self, *args):
        self.inside_scope = False
        return False


class _SwitchCaseGuard(object):
    def __init__(self, switch, condition):
        self.switch = switch
        self.condition = condition

    def __enter__(self):
        from .nn import logical_and, logical_not

        prevs = self.switch.pre_not_conditions
        if self.condition is None:   # default: every earlier case false
            full = prevs[0]
            for p in prevs[1:]:
                full = logical_and(full, p)
        else:
            full = self.condition
            for p in prevs:
                full = logical_and(full, p)
            prevs.append(logical_not(self.condition))
        self._cond = full
        _sub_block_guard(self.switch.helper)
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is not None:
            return False
        helper = self.switch.helper
        sub, parent = _close_sub_block(helper)
        # every write of the case is an output: branch temps (a ``cond``
        # branch's result) are read by later ops of the parent
        out_names = []
        for op_ in sub.ops:
            out_names.extend(n for n in op_.output_arg_names
                             if n not in out_names)
        scope_var = parent.create_var(
            name=unique_name.generate(helper.name + ".scope"),
            type=core.VarDesc.VarType.STEP_SCOPES)
        parent.append_op(
            type="conditional_block",
            inputs={"Cond": [self._cond], "Input": []},
            outputs={"Out": out_names, "Scope": [scope_var]},
            attrs={"sub_block": sub.idx, "is_scalar_condition": True})
        return True


def cond(pred, true_fn=None, false_fn=None, name=None):
    """The two branches as two Switch cases, merged by ``where`` on
    ``pred`` (``control_flow.py:240``); both branches must give the same
    shape and dtype."""
    from .nn import logical_not

    helper = LayerHelper("cond", name=name)
    true_out = false_out = None
    with Switch() as switch:
        with switch.case(pred):
            if true_fn is not None:
                true_out = true_fn()
        with switch.case(logical_not(pred)):
            if false_fn is not None:
                false_out = false_fn()
    if true_out is None:
        return None
    out = helper.create_variable_for_type_inference(dtype=true_out.dtype)
    helper.append_op(
        type="where",
        inputs={"Condition": [pred], "X": [true_out], "Y": [false_out]},
        outputs={"Out": [out]})
    return out


# -- tensor arrays -------------------------------------------------------------
def create_array(dtype):
    helper = LayerHelper("array")
    return helper.create_variable(
        name="{0}.out".format(helper.name),
        type=core.VarDesc.VarType.LOD_TENSOR_ARRAY, dtype=dtype)


def array_write(x, i, array=None):
    helper = LayerHelper("array_write")
    if array is None:
        array = create_array(x.dtype)
    helper.append_op(type="write_to_array", inputs={"X": [x], "I": [i]},
                     outputs={"Out": [array]})
    return array


def array_read(array, i):
    helper = LayerHelper("array_read")
    out = helper.create_variable_for_type_inference(dtype=array.dtype)
    helper.append_op(type="read_from_array", inputs={"X": [array], "I": [i]},
                     outputs={"Out": [out]})
    return out


def array_length(array):
    helper = LayerHelper("array_length")
    out = helper.create_variable_for_type_inference(
        dtype=core.VarDesc.VarType.INT64)
    helper.append_op(type="lod_array_length", inputs={"X": [array]},
                     outputs={"Out": [out]})
    return out


def is_empty(x, cond=None):
    helper = LayerHelper("is_empty")
    if cond is None:
        cond = helper.create_variable_for_type_inference(
            dtype=core.VarDesc.VarType.BOOL)
    helper.append_op(type="is_empty", inputs={"X": [x]},
                     outputs={"Out": [cond]})
    return cond


# -- LoD rank tables -----------------------------------------------------------
def lod_rank_table(x, level=0):
    helper = LayerHelper("lod_rank_table")
    table = helper.main_program.current_block().create_var(
        name=unique_name.generate("lod_rank_table"),
        type=core.VarDesc.VarType.LOD_RANK_TABLE, dtype="int32")
    helper.append_op(type="lod_rank_table", inputs={"X": [x]},
                     outputs={"Out": [table]}, attrs={"level": level})
    return table


def lod_tensor_to_array(x, table):
    helper = LayerHelper("lod_tensor_to_array")
    array = helper.main_program.current_block().create_var(
        name=unique_name.generate("lod_tensor_to_array"),
        type=core.VarDesc.VarType.LOD_TENSOR_ARRAY, dtype=x.dtype)
    helper.append_op(type="lod_tensor_to_array",
                     inputs={"X": [x], "RankTable": [table]},
                     outputs={"Out": [array]})
    return array


def array_to_lod_tensor(x, table):
    helper = LayerHelper("array_to_lod_tensor")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="array_to_lod_tensor",
                     inputs={"X": [x], "RankTable": [table]},
                     outputs={"Out": [out]})
    return out


def max_sequence_len(rank_table):
    helper = LayerHelper("max_seqence_len")
    out = helper.create_variable_for_type_inference(dtype="int64")
    helper.append_op(type="max_sequence_len",
                     inputs={"RankTable": [rank_table]},
                     outputs={"Out": [out]})
    return out


def shrink_memory(x, i, table):
    helper = LayerHelper("shrink_memory")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="shrink_rnn_memory",
                     inputs={"X": [x], "I": [i], "RankTable": [table]},
                     outputs={"Out": [out]})
    return out
