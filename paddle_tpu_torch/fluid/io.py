"""Persistence (port of ``paddle_tpu/fluid/io.py``; Paddle's
python/paddle/fluid/io.py — save_vars:149, save_params:273,
save_persistables:523, save_inference_model:1011,
load_inference_model:1215, save:1493 / load:1547).

Save and load programs are built from the host ops ``save`` /
``save_combine`` / ``load`` / ``load_combine`` (``ops/io_ops.py``) and run
through the Executor, as in the reference, so the files are the
reference's tensor streams and ``__model__`` its framework.proto bytes: a
model saved by either package loads in the other. Loaded tensors land on
the Executor's device.

``save`` / ``load`` / ``load_program_state`` keep the reference's
consolidated pickles of numpy arrays (``.pdparams`` / ``.pdopt`` /
``.pdmodel``); a bf16 tensor, which numpy has no type for, is pickled as
fp32.
"""

import os
import pickle

import numpy as np
import torch

from . import core
from .executor import _to_numpy
from .framework import Parameter, Program, Variable, default_main_program
from .ops.io_ops import _atomic_write

__all__ = [
    "save_vars",
    "save_params",
    "save_persistables",
    "load_vars",
    "load_params",
    "load_persistables",
    "save_inference_model",
    "load_inference_model",
    "save",
    "load",
    "load_program_state",
    "set_program_state",
    "get_parameter_value",
    "get_parameter_value_by_name",
    "prepend_feed_ops",
    "append_fetch_ops",
    "load_program_scope",
]


def is_persistable(var):
    return var.persistable and var.name not in ("feed", "fetch")


def is_parameter(var):
    return isinstance(var, Parameter)


def is_belong_to_optimizer(var):
    """Optimizer state: persistable tensors that are not parameters
    (moments, learning rate, accumulators)."""
    return var.persistable and not isinstance(var, Parameter)


def _io_program(vars_list, dirname, filename, op_one, op_all, slot_in):
    prog = Program()
    block = prog.global_block()
    for v in vars_list:
        block.create_var(name=v.name, shape=v.shape, dtype=v.dtype,
                         persistable=True)
    names = [v.name for v in vars_list]

    def io(ns):
        return ({"X": ns}, {}) if slot_in else ({}, {"Out": ns})

    if filename is None:
        for n in names:
            ins, outs = io([n])
            block.append_op(type=op_one, inputs=ins, outputs=outs,
                            attrs={"file_path": os.path.join(dirname, n)})
    else:
        ins, outs = io(names)
        block.append_op(type=op_all, inputs=ins, outputs=outs,
                        attrs={"file_path": os.path.join(dirname, filename)})
    return prog


def _select_vars(main_program, vars, predicate):
    if vars is None:
        vars = [v for v in main_program.list_vars()
                if (predicate or is_persistable)(v)]
    else:
        vars = [main_program.global_block()._var_recursive(v)
                if isinstance(v, str) else v for v in vars]
    return [v for v in vars if v is not None]


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """Write each selected variable of the current scope to
    ``dirname/<name>``, or all of them to ``dirname/filename``."""
    main_program = main_program or default_main_program()
    vars = _select_vars(main_program, vars, predicate)
    os.makedirs(dirname, exist_ok=True)
    executor.run(_io_program(vars, dirname, filename, "save",
                             "save_combine", slot_in=True))


def save_params(executor, dirname, main_program=None, filename=None):
    save_vars(executor, dirname, main_program, predicate=is_parameter,
              filename=filename)


def save_persistables(executor, dirname, main_program=None, filename=None):
    save_vars(executor, dirname, main_program, predicate=is_persistable,
              filename=filename)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """Read the selected variables into the current scope, on the
    Executor's device."""
    main_program = main_program or default_main_program()
    vars = _select_vars(main_program, vars, predicate)
    executor.run(_io_program(vars, dirname, filename, "load",
                             "load_combine", slot_in=False))


def load_params(executor, dirname, main_program=None, filename=None):
    load_vars(executor, dirname, main_program, predicate=is_parameter,
              filename=filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    load_vars(executor, dirname, main_program, predicate=is_persistable,
              filename=filename)


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, export_for_deployment=True,
                         program_only=False):
    """Prune to the inference subgraph, write it as ``__model__`` (or
    ``model_filename``) with feed/fetch ops naming its inputs and
    outputs, and save its persistables (reference: io.py:1011)."""
    main_program = main_program or default_main_program()
    if isinstance(target_vars, Variable):
        target_vars = [target_vars]
    pruned = main_program.clone(for_test=True)
    pruned = pruned._prune(feeds=feeded_var_names,
                           fetches=[t.name for t in target_vars])
    # the feed/fetch targets persist as in-graph feed/fetch ops, from
    # which load_inference_model recovers the names
    blk = pruned.global_block()
    feed_holder = blk.create_var(
        name="feed", type=core.VarDesc.VarType.FEED_MINIBATCH,
        persistable=True)
    fetch_holder = blk.create_var(
        name="fetch", type=core.VarDesc.VarType.FETCH_LIST, persistable=True)
    for i, name in reversed(list(enumerate(feeded_var_names))):
        blk._prepend_op(type="feed", inputs={"X": [feed_holder.name]},
                        outputs={"Out": [name]}, attrs={"col": i})
    for i, t in enumerate(target_vars):
        blk.append_op(type="fetch", inputs={"X": [t.name]},
                      outputs={"Out": [fetch_holder.name]}, attrs={"col": i})
    pruned._inference_io = {"feed": list(feeded_var_names),
                            "fetch": [t.name for t in target_vars]}
    os.makedirs(dirname, exist_ok=True)
    model_path = os.path.join(dirname, model_filename or "__model__")
    from . import proto

    with open(model_path, "wb") as f:
        f.write(proto.program_to_bytes(pruned))
    if not program_only:
        save_persistables(executor, dirname, pruned, params_filename)
    return [t.name for t in target_vars]


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None, pserver_endpoints=None):
    """[program, feed names, fetch variables] of a saved inference model;
    its persistables are loaded into the current scope."""
    from . import proto

    model_path = os.path.join(dirname, model_filename or "__model__")
    with open(model_path, "rb") as f:
        program = proto.program_from_bytes(f.read())
    load_persistables(executor, dirname, program, params_filename)
    feed_cols, fetch_cols = [], []
    for op in program.global_block().ops:
        if op.type == "feed":
            feed_cols.append((int(op.attr("col", 0)), op.output("Out")[0]))
        elif op.type == "fetch":
            fetch_cols.append((int(op.attr("col", 0)), op.input("X")[0]))
    feed_names = [n for _, n in sorted(feed_cols)]
    fetch_names = [n for _, n in sorted(fetch_cols)]
    if not feed_names and not fetch_names:
        # models saved without feed/fetch ops carry the targets as
        # program metadata
        io_info = getattr(program, "_inference_io", None) or {}
        feed_names = io_info.get("feed", [])
        fetch_names = io_info.get("fetch", [])
    fetch_vars = [program.global_block()._var_recursive(n)
                  for n in fetch_names]
    return [program, feed_names, fetch_vars]


def _numpy(value):
    if isinstance(value, core.LoDTensor):
        value = value.tensor()
    if isinstance(value, torch.Tensor):
        return _to_numpy(value)
    return np.asarray(value)


def _set_array(scope, name, arr, device):
    """Put ``arr`` in the scope as a tensor on ``device`` (the Executor's,
    else where the scope's old value lived, else the default device)."""
    if device is None:
        old = scope.get(name)
        device = old.device if isinstance(old, torch.Tensor) else \
            core.resolve_device(None)
    scope.set(name, torch.as_tensor(np.asarray(arr)).to(device))


def load_program_scope(program, scope, arrays):
    """Fill ``scope``, after ``program``'s startup run, from ``{var name:
    np.ndarray}``, for any model: every persistable variable of
    ``program`` (parameters, batch-norm running stats, optimizer
    accumulators, the learning rate) must be given, with the shape the
    scope holds; a name that is not a persistable of ``program`` raises.
    Values are copied into the scope's tensors in place, on their device
    and in their type. Returns ``scope``."""
    wanted = {v.name for v in program.list_vars() if is_persistable(v)}
    missing = sorted(wanted - set(arrays))
    unknown = sorted(set(arrays) - wanted)
    if missing or unknown:
        raise KeyError("load_program_scope: missing %s, unknown %s"
                       % (missing[:5], unknown[:5]))
    tensors = {}
    for name, arr in arrays.items():
        t = scope.get(name)
        if not isinstance(t, torch.Tensor):
            raise KeyError("load_program_scope: the scope holds no tensor "
                           "%r (run the startup program first)" % name)
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError("load_program_scope: %s has shape %s, the "
                             "scope holds %s" % (name, arr.shape,
                                                 tuple(t.shape)))
        tensors[name] = (t, arr)
    with torch.no_grad():
        for t, arr in tensors.values():
            t.copy_(torch.from_numpy(np.array(arr, order="C")).to(t.dtype))
    return scope


def save(program, model_path):
    """Consolidated ``.pdparams`` / ``.pdopt`` / ``.pdmodel`` save of the
    global scope's persistables (reference: io.py:1493)."""
    scope = core.global_scope()
    param_dict, opt_dict = {}, {}
    for v in program.list_vars():
        if not v.persistable:
            continue
        val = scope.get(v.name)
        if val is None:
            continue
        (param_dict if isinstance(v, Parameter) else opt_dict)[v.name] = \
            _numpy(val)
    _atomic_write(model_path + ".pdparams",
                        pickle.dumps(param_dict, protocol=2))
    _atomic_write(model_path + ".pdopt",
                        pickle.dumps(opt_dict, protocol=2))
    from . import proto

    _atomic_write(model_path + ".pdmodel",
                        proto.program_to_bytes(program))


def load_program_state(model_path, var_list=None):
    """{name: numpy array} of a consolidated save; raises ValueError
    when neither file exists."""
    state = {}
    found = False
    for suffix in (".pdparams", ".pdopt"):
        path = model_path + suffix
        if os.path.exists(path):
            found = True
            with open(path, "rb") as f:
                state.update(pickle.load(f))
    if not found:
        raise ValueError(
            "no checkpoint at %r (neither %r nor %r exists)"
            % (model_path, model_path + ".pdparams", model_path + ".pdopt"))
    return state


def load(program, model_path, executor=None, var_list=None):
    """Restore a consolidated save into the global scope (reference:
    io.py:1547); raises ValueError when no checkpoint exists there."""
    scope = core.global_scope()
    device = executor.device if executor is not None else None
    for name, arr in load_program_state(model_path).items():
        _set_array(scope, name, arr, device)


def set_program_state(program, state):
    scope = core.global_scope()
    for v in program.list_vars():
        if v.name in state:
            _set_array(scope, v.name, state[v.name], None)


def get_parameter_value(para, executor):
    """A parameter's current value in the global scope, as numpy."""
    return get_parameter_value_by_name(para.name, executor)


def get_parameter_value_by_name(name, executor, program=None):
    """A variable's current value in the global scope, as numpy; raises
    on a missing variable (it may live in a scope_guard scope that has
    exited)."""
    val = core.global_scope().get(name)
    if val is None:
        raise ValueError(
            "variable %r not found in the current global scope (was the "
            "program run inside a scope_guard that has since exited?)"
            % name)
    return _numpy(val)


def prepend_feed_ops(inference_program, feed_target_names,
                     feed_holder_name="feed"):
    """Feeding happens by name at the Executor boundary, so this returns
    the program as it is (save_inference_model already writes the feed
    ops); kept for API parity."""
    return inference_program


def append_fetch_ops(inference_program, fetch_target_names,
                     fetch_holder_name="fetch"):
    """Fetching is by name too; kept for API parity."""
    return inference_program
