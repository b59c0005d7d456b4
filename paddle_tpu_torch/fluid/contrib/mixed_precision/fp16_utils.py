"""AMP program rewrite + loss scaling (port of
``paddle_tpu/fluid/contrib/mixed_precision/fp16_utils.py``; reference:
contrib/mixed_precision/fp16_utils.py — rewrite_program:174 inserts cast
ops per black/white lists; update_loss_scaling:300 dynamic scaling).

The low-precision dtype is bf16 by default. rewrite_program inserts cast
ops at precision boundaries: white ops (the matrix products) run on bf16
operands, so cuBLAS runs them on the tensor cores, and the flash kernels
follow their bf16 Q/K/V. Dynamic loss scaling is expressed with in-graph
isfinite/where ops, as in the reference. Everything here but
``cast_parameters_to_bf16`` is the reference's code, on the port's IR."""

from __future__ import annotations

from ... import core
from ...framework import OP_ROLE_KEY, OpRole
from ... import unique_name

_FLOAT_SLOTS_SKIP = {"LearningRate", "Mean", "Variance", "Beta1Pow", "Beta2Pow"}

# Per-op float input slots that stay fp32 even when the op itself runs in
# low precision: normalization statistics/affine params (the bf16-safe BN
# contract keeps them fp32 at runtime) and additive attention masks (the
# flash kernel upcasts them to fp32 internally; -1e4 pad masks survive a
# bf16 round-trip, but there is no bandwidth win casting a [S]-sized row).
_OP_FLOAT_SLOTS_SKIP = {
    "batch_norm": {"Scale", "Bias", "Mean", "Variance"},
    "flash_attention": {"KeyBias", "Bias"},
}


def _low_dtype(use_bf16=True):
    return core.VarDesc.VarType.BF16 if use_bf16 else core.VarDesc.VarType.FP16


def _insert_cast_op(block, idx, in_name, out_name, in_dtype, out_dtype):
    block._insert_op(
        idx,
        type="cast",
        inputs={"X": [in_name]},
        outputs={"Out": [out_name]},
        attrs={
            "in_dtype": in_dtype,
            "out_dtype": out_dtype,
            OP_ROLE_KEY: OpRole.Forward,
        },
    )


def _cast_inputs(block, op_, idx, target, cast_cache, black_varnames):
    """Insert cast ops so every float input of ``op_`` arrives as
    ``target`` (slot-skips and black_varnames excepted). Returns the
    number of ops inserted before ``op_``."""
    skip = set(_FLOAT_SLOTS_SKIP)
    if target == _low_dtype(True) or target == core.VarDesc.VarType.FP16:
        # the per-op table encodes "keep fp32": it suppresses DOWNcasts
        # only — a black-list (fp32) target must still restore fp32 on
        # these slots (e.g. after cast_parameters_to_bf16)
        skip |= _OP_FLOAT_SLOTS_SKIP.get(op_.type, set())
    n_insert = 0
    for slot, names in list(op_.inputs.items()):
        if slot in skip:
            continue
        new_names = []
        for name in names:
            var = block._find_var_recursive(name)
            if (
                var is None
                or var.dtype
                not in (core.VarDesc.VarType.FP32, core.VarDesc.VarType.BF16,
                        core.VarDesc.VarType.FP16)
                or var.dtype == target
                or name in black_varnames
            ):
                new_names.append(name)
                continue
            key = (name, target)
            if key not in cast_cache:
                cast_name = unique_name.generate(name + ".cast")
                block.create_var(
                    name=cast_name,
                    shape=var.shape,
                    dtype=target,
                    persistable=False,
                )
                _insert_cast_op(
                    block, idx + n_insert, name, cast_name, var.dtype, target
                )
                n_insert += 1
                cast_cache[key] = cast_name
            new_names.append(cast_cache[key])
        op_.inputs[slot] = new_names
    return n_insert


def rewrite_program(main_prog, amp_lists, use_bf16=True):
    """Cast float inputs of white-list ops to bf16 and float inputs of
    black-list ops back to fp32 (reference: fp16_utils.py:174)."""
    low = _low_dtype(use_bf16)
    block = main_prog.global_block()
    cast_cache = {}  # (var, dtype) -> casted name
    idx = 0
    float_dtypes = (
        core.VarDesc.VarType.FP32,
        core.VarDesc.VarType.BF16,
        core.VarDesc.VarType.FP16,
    )
    while idx < len(block.ops):
        op_ = block.ops[idx]
        target = None
        if op_.type in amp_lists.white_list:
            target = low
        elif op_.type in amp_lists.black_list:
            target = core.VarDesc.VarType.FP32
        if target is None:
            # gray op: dtype FOLLOWS the inputs. When any float input desc
            # is low, the op RUNS low: (a) propagate low precision into the
            # output var descs — otherwise a later black-list op sees a
            # stale FP32 desc on a runtime-bf16 value and skips its
            # protective fp32 cast — and (b) cast the remaining fp32 float
            # inputs down so the runtime value matches the desc. Without
            # (b) a mixed add (bf16 activation + fp32 bias param) silently
            # PROMOTES to fp32 at runtime while the desc says bf16, and
            # every desc-trusting consumer downstream (including the gray
            # flash_attention kernel) inherits fp32 — the desc lie in the
            # opposite direction (reference fp16_utils casts all float
            # inputs of an op to its chosen run dtype the same way).
            if op_.type in amp_lists.gray_list:
                # exempt slots (fp32-pinned masks/statistics) neither
                # trigger low precision nor receive casts: the op's run
                # dtype is decided by its data inputs only
                gray_skip = _FLOAT_SLOTS_SKIP | _OP_FLOAT_SLOTS_SKIP.get(
                    op_.type, set()
                )
                data_vars = [
                    block._find_var_recursive(n)
                    for slot, names in op_.inputs.items()
                    if slot not in gray_skip
                    for n in names
                    if n not in amp_lists.black_varnames
                ]
                any_low = any(
                    v is not None and v.dtype == low for v in data_vars
                )
                # a black_varnames input stays fp32 uncast, so the op
                # would still promote at runtime — treat it as fp32 (no
                # desc flip) rather than recreate the desc-vs-runtime lie
                pinned_fp32 = any(
                    block._find_var_recursive(n) is not None
                    and block._find_var_recursive(n).dtype
                    == core.VarDesc.VarType.FP32
                    for slot, names in op_.inputs.items()
                    if slot not in gray_skip
                    for n in names
                    if n in amp_lists.black_varnames
                )
                if any_low and not pinned_fp32:
                    n_insert = _cast_inputs(
                        block, op_, idx, low, cast_cache,
                        amp_lists.black_varnames,
                    )
                    for slot, names in op_.outputs.items():
                        # normalization statistics stay fp32 at runtime
                        # (bf16-safe BN contract) — keep their descs fp32
                        if slot in (
                            "MeanOut", "VarianceOut", "SavedMean",
                            "SavedVariance",
                        ):
                            continue
                        for n in names:
                            v = block._find_var_recursive(n)
                            if v is not None and v.dtype in float_dtypes:
                                v.dtype = low
                    idx += n_insert
            idx += 1
            continue
        n_insert = _cast_inputs(
            block, op_, idx, target, cast_cache, amp_lists.black_varnames
        )
        # outputs of white ops are low precision
        if target == low:
            for slot, names in op_.outputs.items():
                for name in names:
                    var = block._find_var_recursive(name)
                    if var is not None and var.dtype == core.VarDesc.VarType.FP32:
                        var.dtype = low
        idx += n_insert + 1
    main_prog._bump_version()


def cast_parameters_to_bf16(program, scope=None):
    """Optional weight cast for pure-bf16 training: every fp32 parameter
    tensor of ``scope`` becomes bf16, and so does its var desc."""
    import torch

    scope = scope or core.global_scope()
    for p in program.all_parameters():
        val = scope.get(p.name)
        if val is not None and val.dtype == torch.float32:
            scope.set(p.name, val.to(torch.bfloat16))
            p.dtype = core.VarDesc.VarType.BF16


def scale_loss(loss, loss_scaling_var):
    from ...layers import nn as lnn

    return lnn.elementwise_mul(loss, loss_scaling_var)


def unscale_grads(params_grads, loss_scaling_var):
    from ...layers import nn as lnn

    out = []
    for p, g in params_grads:
        if g is None:
            out.append((p, g))
        else:
            out.append((p, lnn.elementwise_div(g, loss_scaling_var)))
    return out


def mask_nonfinite_grads(params_grads, finite):
    """Route each gradient through a where-select against the all-finite
    predicate: a found_inf step applies an exactly-zero update. The
    multiply form (``g * cast(finite)``) is WRONG here — ``inf * 0`` is
    NaN in IEEE 754, so the "masked" update would itself poison every
    parameter it touches and the scaler's skip-step would never actually
    skip."""
    from ...layers import nn as lnn
    from ...layers import tensor as ltensor

    zeros = {}  # one shared [1] zero per grad dtype (where broadcasts)
    out = []
    for p, g in params_grads:
        if g is None:
            out.append((p, g))
            continue
        dtype = g.dtype
        if dtype not in zeros:
            zeros[dtype] = ltensor.fill_constant([1], dtype, 0.0)
        out.append((p, lnn.where(finite, g, zeros[dtype])))
    return out


def update_loss_scaling(
    grads,
    loss_scaling_var,
    good_steps_var,
    incr_every_n_steps,
    decr_every_n_nan_or_inf,
    incr_ratio,
    decr_ratio,
):
    """In-graph dynamic loss-scale update (reference: fp16_utils.py:300).
    Returns the all-finite BOOL predicate var; the caller routes grads
    through ``mask_nonfinite_grads`` with it so a found_inf step applies
    a zero update (the in-graph form of "skip the update")."""
    from ...layers import tensor as ltensor
    from ...layers import nn as lnn
    from ...layer_helper import LayerHelper

    helper = LayerHelper("update_loss_scaling")
    finite = None
    for _, g in grads:
        if g is None:
            continue
        f = ltensor.isfinite(g)
        finite = f if finite is None else lnn.logical_and(finite, f)
    if finite is None:
        return None

    one = ltensor.fill_constant([1], "float32", 1.0)
    zero = ltensor.fill_constant([1], "float32", 0.0)
    finite_f = ltensor.cast(finite, "float32")

    # good_steps = finite ? good_steps+1 : 0
    inc = lnn.elementwise_add(good_steps_var, one)
    new_good = lnn.elementwise_mul(inc, finite_f)

    # grow when good_steps reaches threshold
    thresh = ltensor.fill_constant([1], "float32", float(incr_every_n_steps))
    from ...layers import control_flow as cf

    grow = ltensor.cast(cf.greater_equal(new_good, thresh), "float32")
    grown = lnn.elementwise_mul(
        loss_scaling_var, ltensor.fill_constant([1], "float32", incr_ratio)
    )
    shrunk = lnn.elementwise_mul(
        loss_scaling_var, ltensor.fill_constant([1], "float32", decr_ratio)
    )
    # new_scale = finite ? (grow ? grown : scale) : shrunk
    kept = lnn.elementwise_add(
        lnn.elementwise_mul(grown, grow),
        lnn.elementwise_mul(loss_scaling_var, lnn.elementwise_sub(one, grow)),
    )
    new_scale = lnn.elementwise_add(
        lnn.elementwise_mul(kept, finite_f),
        lnn.elementwise_mul(shrunk, lnn.elementwise_sub(one, finite_f)),
    )
    # reset good counter after growth
    new_good = lnn.elementwise_mul(new_good, lnn.elementwise_sub(one, grow))

    helper.append_op(
        type="assign",
        inputs={"X": [new_scale]},
        outputs={"Out": [loss_scaling_var]},
        attrs={OP_ROLE_KEY: OpRole.Optimize},
    )
    helper.append_op(
        type="assign",
        inputs={"X": [new_good]},
        outputs={"Out": [good_steps_var]},
        attrs={OP_ROLE_KEY: OpRole.Optimize},
    )
    _ = zero
    return finite
