"""Dygraph learning-rate schedules (copy of
``paddle_tpu/fluid/dygraph/learning_rate_scheduler.py``; reference:
python/paddle/fluid/dygraph/learning_rate_scheduler.py): host floats, one
a call, each call a step (no ops in eager mode). A dygraph optimizer
given one as its ``learning_rate`` calls it once a ``minimize``."""

import math


class LearningRateDecay(object):
    def __init__(self, begin=0, step=1, dtype="float32"):
        self.step_num = begin
        self.step_size = step
        self.dtype = dtype

    def __call__(self):
        lr = self.step()
        self.step_num += self.step_size
        return lr

    def step(self):
        raise NotImplementedError


class PiecewiseDecay(LearningRateDecay):
    def __init__(self, boundaries, values, begin, step=1, dtype="float32"):
        super().__init__(begin, step, dtype)
        self.boundaries = boundaries
        self.values = values

    def step(self):
        for i in range(len(self.boundaries)):
            if self.step_num < self.boundaries[i]:
                return self.values[i]
        return self.values[len(self.values) - 1]


class NaturalExpDecay(LearningRateDecay):
    def __init__(self, learning_rate, decay_steps, decay_rate, staircase=False,
                 begin=0, step=1, dtype="float32"):
        super().__init__(begin, step, dtype)
        self.learning_rate = learning_rate
        self.decay_steps = decay_steps
        self.decay_rate = decay_rate
        self.staircase = staircase

    def step(self):
        div = self.step_num / self.decay_steps
        if self.staircase:
            div = math.floor(div)
        return self.learning_rate * math.exp(-1 * self.decay_rate * div)


class ExponentialDecay(LearningRateDecay):
    def __init__(self, learning_rate, decay_steps, decay_rate, staircase=False,
                 begin=0, step=1, dtype="float32"):
        super().__init__(begin, step, dtype)
        self.learning_rate = learning_rate
        self.decay_steps = decay_steps
        self.decay_rate = decay_rate
        self.staircase = staircase

    def step(self):
        div = self.step_num / self.decay_steps
        if self.staircase:
            div = math.floor(div)
        return self.learning_rate * (self.decay_rate ** div)


class InverseTimeDecay(LearningRateDecay):
    def __init__(self, learning_rate, decay_steps, decay_rate, staircase=False,
                 begin=0, step=1, dtype="float32"):
        super().__init__(begin, step, dtype)
        self.learning_rate = learning_rate
        self.decay_steps = decay_steps
        self.decay_rate = decay_rate
        self.staircase = staircase

    def step(self):
        div = self.step_num / self.decay_steps
        if self.staircase:
            div = math.floor(div)
        return self.learning_rate / (1 + self.decay_rate * div)


class PolynomialDecay(LearningRateDecay):
    def __init__(self, learning_rate, decay_steps, end_learning_rate=0.0001,
                 power=1.0, cycle=False, begin=0, step=1, dtype="float32"):
        super().__init__(begin, step, dtype)
        self.learning_rate = learning_rate
        self.decay_steps = decay_steps
        self.end_learning_rate = end_learning_rate
        self.power = power
        self.cycle = cycle

    def step(self):
        step_num = self.step_num
        decay_steps = self.decay_steps
        if self.cycle:
            div = math.ceil(step_num / float(decay_steps)) or 1
            decay_steps = decay_steps * div
        else:
            step_num = min(step_num, decay_steps)
        frac = (1.0 - step_num / float(decay_steps)) ** self.power
        return (self.learning_rate - self.end_learning_rate) * frac + \
            self.end_learning_rate


class CosineDecay(LearningRateDecay):
    def __init__(self, learning_rate, step_each_epoch, epochs, begin=0, step=1,
                 dtype="float32"):
        super().__init__(begin, step, dtype)
        self.learning_rate = learning_rate
        self.step_each_epoch = step_each_epoch
        self.epochs = epochs

    def step(self):
        cur_epoch = math.floor(self.step_num / self.step_each_epoch)
        return self.learning_rate * 0.5 * (
            math.cos(cur_epoch * math.pi / self.epochs) + 1
        )


class NoamDecay(LearningRateDecay):
    def __init__(self, d_model, warmup_steps, begin=1, step=1, dtype="float32"):
        super().__init__(begin, step, dtype)
        self.d_model = d_model
        self.warmup_steps = warmup_steps

    def step(self):
        a = self.step_num ** -0.5
        b = (self.warmup_steps ** -1.5) * self.step_num
        return (self.d_model ** -0.5) * min(a, b)
