"""In-graph learning-rate schedules (copy of
``paddle_tpu/fluid/layers/learning_rate_scheduler.py``): each schedule
is ops of the main program driven by the ``@LR_DECAY_COUNTER@`` step
counter (``autoincreased_step_counter``), so a step computes its own
rate with no value from the host."""

import math

from ..layer_helper import LayerHelper
from . import control_flow
from .nn import autoincreased_step_counter, elementwise_max, elementwise_min
from .ops import ceil, cos, exp, floor
from .tensor import cast, fill_constant

__all__ = [
    "exponential_decay",
    "natural_exp_decay",
    "inverse_time_decay",
    "polynomial_decay",
    "piecewise_decay",
    "noam_decay",
    "cosine_decay",
    "linear_lr_warmup",
]


def _decay_step_counter(begin=0):
    global_step = autoincreased_step_counter(
        counter_name="@LR_DECAY_COUNTER@", begin=begin, step=1)
    return cast(global_step, "float32")


def noam_decay(d_model, warmup_steps):
    global_step = _decay_step_counter(1)
    a = global_step ** -0.5
    b = (warmup_steps ** -1.5) * global_step
    return (d_model ** -0.5) * elementwise_min(a, b)


def exponential_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    global_step = _decay_step_counter()
    div_res = global_step / decay_steps
    if staircase:
        div_res = floor(div_res)
    return learning_rate * (decay_rate ** div_res)


def natural_exp_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    global_step = _decay_step_counter()
    div_res = global_step / decay_steps
    if staircase:
        div_res = floor(div_res)
    return learning_rate * exp(-1 * decay_rate * div_res)


def inverse_time_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    global_step = _decay_step_counter()
    div_res = global_step / decay_steps
    if staircase:
        div_res = floor(div_res)
    return learning_rate / (1 + decay_rate * div_res)


def polynomial_decay(
    learning_rate, decay_steps, end_learning_rate=0.0001, power=1.0, cycle=False
):
    global_step = _decay_step_counter()
    if cycle:
        div_res = ceil(global_step / decay_steps)
        one = fill_constant(shape=[1], dtype="float32", value=1.0)
        div_res = elementwise_max(div_res, one)
        decay_steps_var = div_res * float(decay_steps)
        frac = global_step / decay_steps_var
    else:
        cap = fill_constant(shape=[1], dtype="float32", value=float(decay_steps))
        clipped = elementwise_min(global_step, cap)
        frac = clipped / float(decay_steps)
    one_m = 1.0 - frac
    return (learning_rate - end_learning_rate) * (one_m ** power) + end_learning_rate


def piecewise_decay(boundaries, values):
    """boundaries: [b0, b1, ...], values one longer — built with nested
    `where` selects so it stays a pure device computation."""
    if len(values) - len(boundaries) != 1:
        raise ValueError("len(values) must be len(boundaries) + 1")
    global_step = _decay_step_counter()
    helper = LayerHelper("piecewise_decay")
    lr = fill_constant(shape=[1], dtype="float32", value=float(values[-1]))
    # build from the last boundary backwards: where(step < b_i, v_i, lr)
    for b, v in reversed(list(zip(boundaries, values[:-1]))):
        bvar = fill_constant(shape=[1], dtype="float32", value=float(b))
        cond = control_flow.less_than(global_step, bvar)
        vvar = fill_constant(shape=[1], dtype="float32", value=float(v))
        out = helper.create_variable_for_type_inference("float32")
        helper.append_op(
            type="where",
            inputs={"Condition": [cond], "X": [vvar], "Y": [lr]},
            outputs={"Out": [out]},
        )
        lr = out
    return lr


def cosine_decay(learning_rate, step_each_epoch, epochs):
    global_step = _decay_step_counter()
    cur_epoch = floor(global_step / step_each_epoch)
    return (
        learning_rate
        * 0.5
        * (cos(cur_epoch * (math.pi / epochs)) + 1)
    )


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    global_step = _decay_step_counter()
    helper = LayerHelper("lr_warmup")
    wsteps = fill_constant(shape=[1], dtype="float32", value=float(warmup_steps))
    cond = control_flow.less_than(global_step, wsteps)
    warm = start_lr + (end_lr - start_lr) * (global_step / float(warmup_steps))
    if not hasattr(learning_rate, "dtype"):
        learning_rate = fill_constant(
            shape=[1], dtype="float32", value=float(learning_rate)
        )
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op(
        type="where",
        inputs={"Condition": [cond], "X": [warm], "Y": [learning_rate]},
        outputs={"Out": [out]},
    )
    return out
