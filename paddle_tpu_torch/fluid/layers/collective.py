"""Collective layers (port of ``paddle_tpu/fluid/layers/collective.py``;
reference: python/paddle/fluid/layers/collective.py — _allreduce:20,
_broadcast:53): each appends one ``c_*`` op
(``fluid/ops/collective_ops.py``)."""

from __future__ import annotations

from ..layer_helper import LayerHelper


def _allreduce(x, out=None, reduce_type="sum", sync_mode=False, ring_id=0):
    helper = LayerHelper("allreduce")
    if reduce_type not in ("sum", "max", "min", "prod"):
        raise TypeError("reduce type can only be [sum|max|min|prod]")
    op_type = "c_allreduce_" + reduce_type
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        type=op_type,
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"ring_id": ring_id, "use_calc_stream": sync_mode},
    )
    return out


def _broadcast(x, root, sync_mode=False, ring_id=0):
    helper = LayerHelper("broadcast")
    helper.append_op(
        type="c_broadcast",
        inputs={"X": [x]},
        outputs={"Out": [x]},
        attrs={"root": root, "ring_id": ring_id, "use_calc_stream": sync_mode},
    )
    return x


def _c_allgather(x, nranks, ring_id=0, use_calc_stream=False):
    helper = LayerHelper("c_allgather")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        type="c_allgather",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={
            "nranks": nranks,
            "ring_id": ring_id,
            "use_calc_stream": use_calc_stream,
        },
    )
    return out


def _c_reducescatter(x, nranks, ring_id=0, use_calc_stream=False):
    helper = LayerHelper("c_reducescatter")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        type="c_reducescatter",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={
            "nranks": nranks,
            "ring_id": ring_id,
            "use_calc_stream": use_calc_stream,
        },
    )
    return out
