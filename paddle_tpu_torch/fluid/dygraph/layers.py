"""The dygraph ``Layer`` (copy of ``paddle_tpu/fluid/dygraph/layers.py``;
reference: python/paddle/fluid/dygraph/layers.py:33 Layer,
``__call__``:173): parameters and sublayers registered by attribute,
``state_dict`` of live ``VarBase``s and ``set_dict`` / ``load_dict``
copying arrays into them."""

from collections import OrderedDict

import numpy as np

from .. import unique_name
from .tracer import VarBase


class Layer(object):
    def __init__(self, name_scope=None, dtype="float32"):
        name_scope = name_scope or self.__class__.__name__.lower()
        self._full_name = unique_name.generate(name_scope)
        self._dtype = dtype
        self._parameters = OrderedDict()
        self._sub_layers = OrderedDict()
        self._buffers = OrderedDict()
        self.training = True

    def full_name(self):
        return self._full_name

    def train(self):
        self.training = True
        for l in self._sub_layers.values():
            l.train()

    def eval(self):
        self.training = False
        for l in self._sub_layers.values():
            l.eval()

    def forward(self, *inputs, **kwargs):
        raise NotImplementedError

    def __call__(self, *inputs, **kwargs):
        return self.forward(*inputs, **kwargs)

    # -- parameter management --
    def create_parameter(self, attr, shape, dtype="float32", is_bias=False,
                         default_initializer=None):
        from ..param_attr import ParamAttr
        from ..initializer import Constant, Xavier
        from .base import _create_parameter_eager

        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        init = attr.initializer or default_initializer or (
            Constant(0.0) if is_bias else Xavier()
        )
        return _create_parameter_eager(attr, shape, dtype, init)

    def add_parameter(self, name, parameter):
        self._parameters[name] = parameter
        return parameter

    def add_sublayer(self, name, sublayer):
        self._sub_layers[name] = sublayer
        return sublayer

    def parameters(self, include_sublayers=True):
        ret = list(self._parameters.values())
        if include_sublayers:
            for l in self._sub_layers.values():
                ret.extend(l.parameters())
        return ret

    def sublayers(self, include_sublayers=True):
        ret = list(self._sub_layers.values())
        if include_sublayers:
            for l in self._sub_layers.values():
                ret.extend(l.sublayers())
        return ret

    def named_parameters(self, prefix=""):
        for name, p in self._parameters.items():
            yield (prefix + name if not prefix else prefix + "." + name), p
        for lname, l in self._sub_layers.items():
            sub_prefix = lname if not prefix else prefix + "." + lname
            yield from l.named_parameters(sub_prefix)

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_gradient()

    # -- state dict (reference: dygraph/checkpoint.py style) --
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix=""):
        dest = destination if destination is not None else OrderedDict()
        for name, p in self._parameters.items():
            if p is not None:
                dest[structured_name_prefix + name] = p
        for name, buf in self._buffers.items():
            if buf is not None:
                dest[structured_name_prefix + name] = buf
        if include_sublayers:
            for lname, l in self._sub_layers.items():
                l.state_dict(
                    dest, True, structured_name_prefix + lname + "."
                )
        return dest

    def set_dict(self, stat_dict, include_sublayers=True):
        self.load_dict(stat_dict, include_sublayers)

    def load_dict(self, stat_dict, include_sublayers=True):
        own = self.state_dict(include_sublayers=include_sublayers)
        for key, value in stat_dict.items():
            if key in own:
                target = own[key]
                arr = value.numpy() if isinstance(value, VarBase) else np.asarray(value)
                target.set_value(arr)

    def __setattr__(self, name, value):
        if isinstance(value, VarBase) and getattr(value, "is_parameter", False):
            self.__dict__.setdefault("_parameters", OrderedDict())
            self._parameters[name] = value
        elif isinstance(value, Layer):
            self.__dict__.setdefault("_sub_layers", OrderedDict())
            self._sub_layers[name] = value
        object.__setattr__(self, name, value)

    def __getattr__(self, name):
        params = self.__dict__.get("_parameters")
        if params is not None and name in params:
            return params[name]
        subs = self.__dict__.get("_sub_layers")
        if subs is not None and name in subs:
            return subs[name]
        raise AttributeError(
            "%r object has no attribute %r" % (type(self).__name__, name)
        )
