"""``lod_reset`` and ``gather_tree`` (copy of
``paddle_tpu/fluid/layers/compat.py:394-460``)."""

from ..layer_helper import LayerHelper

__all__ = ["lod_reset", "gather_tree"]


def _single_out(op_type, inputs, attrs=None, dtype="float32",
                out_slot="Out"):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(type=op_type, inputs=inputs,
                     outputs={out_slot: [out]}, attrs=attrs or {})
    return out


def gather_tree(ids, parents):
    """Beam-search backtrace (reference nn.py:17617, gather_tree_op.cc)."""
    return _single_out("gather_tree", {"Ids": [ids], "Parents": [parents]},
                       dtype=ids.dtype)


def lod_reset(x, y=None, target_lod=None):
    """reference nn.py:9146 over lod_reset_op.cc."""
    helper = LayerHelper("lod_reset")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    inputs = {"X": [x]}
    attrs = {}
    if y is not None:
        inputs["Y"] = [y]
    elif target_lod is not None:
        attrs["target_lod"] = [int(v) for v in target_lod]
    else:
        raise ValueError("y and target_lod should not be both none")
    helper.append_op(type="lod_reset", inputs=inputs,
                     outputs={"Out": [out]}, attrs=attrs)
    return out
