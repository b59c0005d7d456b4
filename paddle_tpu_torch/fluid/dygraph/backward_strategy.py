"""BackwardStrategy (copy of
``paddle_tpu/fluid/dygraph/backward_strategy.py``; reference:
paddle/fluid/imperative/backward_strategy.h:24, whose
``sorted_sum_gradient_`` sets the order gradients are summed in).

With ``sorted_sum_gradient = True`` the tape sums each variable's
gradient contributions in forward-op order (ascending tape index)
instead of the order the backward meets them."""

__all__ = ["BackwardStrategy"]


class BackwardStrategy(object):
    def __init__(self):
        self.sorted_sum_gradient = False

    def __repr__(self):
        return "BackwardStrategy(sorted_sum_gradient=%r)" % (
            self.sorted_sum_gradient,
        )
