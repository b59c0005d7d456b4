"""Loss layers (port of part of ``paddle_tpu/fluid/layers/loss.py``):
``square_error_cost``, the regression loss of the trainer's tests."""

from ..layer_helper import LayerHelper

__all__ = ["square_error_cost"]


def square_error_cost(input, label):
    """(input - label)^2 elementwise, in input's dtype."""
    helper = LayerHelper("square_error_cost")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type="square_error_cost",
        inputs={"X": [input], "Y": [label]},
        outputs={"Out": [out]},
    )
    return out

