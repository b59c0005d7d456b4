"""Dygraph save/load (copy of ``paddle_tpu/fluid/dygraph/checkpoint.py``;
reference: python/paddle/fluid/dygraph/checkpoint.py save_dygraph /
load_dygraph): a state dict pickled as {key: numpy array}, to
``.pdparams`` (parameters) or ``.pdopt`` (any entry that is not a
parameter: an optimizer's state). The files are the reference's, so each
package reads what the other wrote."""

import os
import pickle

import numpy as np

from .tracer import VarBase


def save_dygraph(state_dict, model_path):
    base = model_path
    suffix = ".pdparams"
    to_save = {}
    for k, v in state_dict.items():
        arr = v.numpy() if isinstance(v, VarBase) else np.asarray(v)
        to_save[k] = arr
        if isinstance(v, VarBase) and not getattr(v, "is_parameter", False):
            suffix = ".pdopt"
    d = os.path.dirname(base)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(base + suffix, "wb") as f:
        pickle.dump(to_save, f, protocol=2)


def load_dygraph(model_path):
    para_dict = None
    opt_dict = None
    if os.path.exists(model_path + ".pdparams"):
        with open(model_path + ".pdparams", "rb") as f:
            para_dict = pickle.load(f)
    if os.path.exists(model_path + ".pdopt"):
        with open(model_path + ".pdopt", "rb") as f:
            opt_dict = pickle.load(f)
    return para_dict, opt_dict
