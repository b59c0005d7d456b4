"""Loss layers (port of ``paddle_tpu/fluid/layers/loss.py``;
``cross_entropy`` and ``softmax_with_cross_entropy`` are ``nn``'s)."""

from ..layer_helper import LayerHelper

__all__ = ["square_error_cost", "sigmoid_cross_entropy_with_logits",
           "huber_loss", "smooth_l1", "mean_squared_error"]


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


mean_squared_error = square_error_cost


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100, name=None,
                                      normalize=False):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        type="sigmoid_cross_entropy_with_logits",
        inputs={"X": [x], "Label": [label]}, outputs={"Out": [out]},
        attrs={"ignore_index": ignore_index, "normalize": normalize})
    return out


def huber_loss(input, label, delta):
    helper = LayerHelper("huber_loss")
    residual = helper.create_variable_for_type_inference(dtype=input.dtype)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type="huber_loss", inputs={"X": [input], "Y": [label]},
                     outputs={"Out": [out], "Residual": [residual]},
                     attrs={"delta": delta})
    return out


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    """The reference's: the weights are taken and not used."""
    helper = LayerHelper("smooth_l1_loss")
    diff = helper.create_variable_for_type_inference(dtype=x.dtype)
    loss = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="smooth_l1_loss", inputs={"X": [x], "Y": [y]},
                     outputs={"Diff": [diff], "Out": [loss]},
                     attrs={"sigma": sigma if sigma is not None else 1.0})
    return loss
