"""Dygraph layer containers (copy of
``paddle_tpu/fluid/dygraph/container.py``; reference:
python/paddle/fluid/dygraph/container.py:20 Sequential)."""

from .layers import Layer

__all__ = ["Sequential"]


class Sequential(Layer):
    """Runs sub-layers in registration order. Accepts iterable Layers or
    (name, Layer) pairs; supports indexing, item assignment/deletion and
    len(), matching the reference container."""

    def __init__(self, name_scope=None, *layers):
        # v1.6 required a name_scope first argument; also accept the
        # layers-only calling convention (a Layer as first argument)
        if isinstance(name_scope, (Layer, tuple)):
            layers = (name_scope,) + layers
            name_scope = "sequential"
        super(Sequential, self).__init__(name_scope)
        if len(layers) > 0 and isinstance(layers[0], tuple):
            for name, layer in layers:
                self.add_sublayer(name, layer)
        else:
            for idx, layer in enumerate(layers):
                self.add_sublayer(str(idx), layer)

    def __getitem__(self, name):
        return self._sub_layers[str(name)]

    def __setitem__(self, name, layer):
        assert isinstance(layer, Layer)
        self._sub_layers[str(name)] = layer

    def __delitem__(self, name):
        name = str(name)
        assert name in self._sub_layers
        del self._sub_layers[name]

    def __len__(self):
        return len(self._sub_layers)

    def forward(self, input):
        for layer in self._sub_layers.values():
            input = layer(input)
        return input
