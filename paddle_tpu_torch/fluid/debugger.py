"""NaN/Inf checking (port of part of ``paddle_tpu/fluid/debugger.py``;
reference: the FLAGS_check_nan_inf check at operator.cc:945-956).

When ``check_nan_inf`` is set, ``Executor.run`` routes every fetched
value through ``scan_fetches``, which raises a ``NanInfError`` naming
the first fetch var that holds NaN or Inf. The reference also turns on
``jax_debug_nans``; the port has no counterpart and scans the fetches
only. The training guardian (``distributed/guardian.py``) reuses
``nonfinite_kind`` as its NaN/Inf detector."""

import numpy as np
import torch

from . import flags as _flags

__all__ = [
    "set_check_nan_inf",
    "NanInfError",
    "nonfinite_kind",
    "scan_fetches",
]


class NanInfError(RuntimeError):
    """A fetched value holds NaN/Inf (the ``check_nan_inf`` post-run
    fetch scan). ``var_name`` names the fetch, ``kind`` is "nan" or
    "inf", so a supervising layer can react without parsing a
    message."""

    def __init__(self, var_name, kind, message=None):
        super().__init__(
            message
            or "fetch var %r contains %s (FLAGS_check_nan_inf post-run "
               "fetch scan; reference operator.cc:945)"
               % (var_name, kind)
        )
        self.var_name = str(var_name)
        self.kind = str(kind)


def nonfinite_kind(value):
    """"nan" / "inf" when a fetched value holds a non-finite float, else
    None (an integer fetch is never non-finite). A tensor is scanned
    where it lives; one boolean per kind comes back to the host."""
    if value is None:
        return None
    if isinstance(value, torch.Tensor):
        if not value.is_floating_point():
            return None
        if bool(torch.isnan(value).any()):
            return "nan"
        if bool(torch.isinf(value).any()):
            return "inf"
        return None
    arr = np.asarray(value.numpy() if hasattr(value, "numpy") else value)
    if not np.issubdtype(arr.dtype, np.floating):
        return None
    if np.isnan(arr).any():
        return "nan"
    if np.isinf(arr).any():
        return "inf"
    return None


def scan_fetches(names, values):
    """The Executor's post-run fetch scan: raise ``NanInfError`` naming
    the first fetch var whose value holds NaN/Inf. Returns the number of
    values scanned."""
    scanned = 0
    for name, value in zip(names, values):
        scanned += 1
        kind = nonfinite_kind(value)
        if kind is not None:
            raise NanInfError(name, kind)
    return scanned


def set_check_nan_inf(enabled=True):
    """Turn the Executor's post-run fetch scan on or off."""
    _flags.set_flags({"check_nan_inf": bool(enabled)})

