"""Initializers — appended as ops in the startup program (copy of
``paddle_tpu/fluid/initializer.py``; reference:
python/paddle/fluid/initializer.py; init runs once via
``exe.run(startup_program)``, exactly as in the reference). The random
startup ops draw from the scope's generator on the executor's device
(``ops/tensor_ops.py``).
"""

import math

import numpy as np



__all__ = [
    "Constant", "Uniform", "Normal", "TruncatedNormal", "Xavier", "MSRA",
    "Bilinear", "ConstantInitializer", "UniformInitializer",
    "NormalInitializer", "TruncatedNormalInitializer", "XavierInitializer",
    "MSRAInitializer", "BilinearInitializer", "NumpyArrayInitializer",
]


class Initializer(object):
    def __call__(self, var, block):
        raise NotImplementedError

    @staticmethod
    def _startup_var(var, block):
        """Mirror the param var into the startup block so the init op can
        write it (the reference keeps params in both programs)."""
        if not block.has_var(var.name):
            block.create_var(
                name=var.name,
                shape=var.shape,
                dtype=var.dtype,
                persistable=True,
            )
        return block.vars[var.name]


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0, force_cpu=False):
        self.value = float(value)
        self.force_cpu = force_cpu

    def __call__(self, var, block):
        self._startup_var(var, block)
        return block.append_op(
            type="fill_constant",
            outputs={"Out": var.name},
            attrs={
                "shape": list(var.shape),
                "dtype": var.dtype,
                "value": self.value,
            },
        )


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low = float(low)
        self.high = float(high)
        self.seed = seed

    def __call__(self, var, block):
        self._startup_var(var, block)
        return block.append_op(
            type="uniform_random",
            outputs={"Out": var.name},
            attrs={
                "shape": list(var.shape),
                "dtype": var.dtype,
                "min": self.low,
                "max": self.high,
                "seed": self.seed,
            },
        )


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc = float(loc)
        self.scale = float(scale)
        self.seed = seed

    def __call__(self, var, block):
        self._startup_var(var, block)
        return block.append_op(
            type="gaussian_random",
            outputs={"Out": var.name},
            attrs={
                "shape": list(var.shape),
                "dtype": var.dtype,
                "mean": self.loc,
                "std": self.scale,
                "seed": self.seed,
            },
        )


class TruncatedNormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc = float(loc)
        self.scale = float(scale)
        self.seed = seed

    def __call__(self, var, block):
        self._startup_var(var, block)
        return block.append_op(
            type="truncated_gaussian_random",
            outputs={"Out": var.name},
            attrs={
                "shape": list(var.shape),
                "dtype": var.dtype,
                "mean": self.loc,
                "std": self.scale,
                "seed": self.seed,
            },
        )


def _fans(var):
    shape = var.shape
    if len(shape) < 2:
        fan_in = fan_out = int(shape[0]) if shape else 1
    else:
        receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
        fan_in = int(shape[1]) * receptive  # conv OIHW / fc [in, out]
        fan_out = int(shape[0]) * receptive
        if len(shape) == 2:
            # fc weights are [in, out] in fluid
            fan_in, fan_out = int(shape[0]), int(shape[1])
    return fan_in, fan_out


class XavierInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform = uniform
        self.fan_in = fan_in
        self.fan_out = fan_out
        self.seed = seed

    def __call__(self, var, block):
        fi, fo = _fans(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            return UniformInitializer(-limit, limit, self.seed)(var, block)
        std = math.sqrt(2.0 / (fi + fo))
        return NormalInitializer(0.0, std, self.seed)(var, block)


class MSRAInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform = uniform
        self.fan_in = fan_in
        self.seed = seed

    def __call__(self, var, block):
        fi, _ = _fans(var)
        fi = self.fan_in if self.fan_in is not None else fi
        if self.uniform:
            limit = math.sqrt(6.0 / fi)
            return UniformInitializer(-limit, limit, self.seed)(var, block)
        std = math.sqrt(2.0 / fi)
        return NormalInitializer(0.0, std, self.seed)(var, block)


class BilinearInitializer(Initializer):
    """Bilinear upsample kernel init (reference: initializer.py Bilinear)."""

    def __call__(self, var, block):
        shape = var.shape
        if len(shape) != 4:
            raise ValueError("Bilinear init expects a 4-D conv weight")
        weight = np.zeros(shape, np.float32)
        k = shape[3]
        f = int(np.ceil(k / 2.0))
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(int(np.prod(shape[2:]))):
            x = i % k
            y = (i // k) % k
            v = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
            weight[:, :, y, x] = v
        return NumpyArrayInitializer(weight)(var, block)


class NumpyArrayInitializer(Initializer):
    def __init__(self, value):
        self.value = np.asarray(value)

    def __call__(self, var, block):
        self._startup_var(var, block)
        return block.append_op(
            type="assign_value",
            outputs={"Out": var.name},
            attrs={
                "shape": list(self.value.shape),
                "dtype": var.dtype,
                "values": self.value,
            },
        )


# reference aliases (initializer.py bottom)
Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
Bilinear = BilinearInitializer


def force_init_on_cpu():
    return False
