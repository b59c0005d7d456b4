"""Data-input layers (port of ``paddle_tpu/fluid/layers/io.py``;
reference: python/paddle/fluid/layers/io.py — the data layer)."""

from .. import core
from ..layer_helper import LayerHelper

__all__ = ["data"]


def data(
    name,
    shape,
    append_batch_size=True,
    dtype="float32",
    lod_level=0,
    type=core.VarDesc.VarType.LOD_TENSOR,
    stop_gradient=True,
):
    """Declare a feed slot (reference: layers/io.py data — injects a var
    with is_data=True; feeding happens at executor boundary, no feed op)."""
    helper = LayerHelper("data")
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    return helper.create_global_variable(
        name=name,
        shape=shape,
        dtype=dtype,
        type=type,
        stop_gradient=stop_gradient,
        lod_level=lod_level,
        is_data=True,
        persistable=False,
    )
