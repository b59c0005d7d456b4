"""Nested-structure helpers of the cell API (copy of
``paddle_tpu/fluid/layers/utils.py``)."""

import collections

__all__ = ["is_sequence", "flatten", "map_structure"]


def is_sequence(seq):
    return isinstance(seq, collections.abc.Sequence) and not isinstance(
        seq, str
    ) or isinstance(seq, dict)


def flatten(nest):
    out = []

    def _walk(x):
        if isinstance(x, dict):
            for k in sorted(x):
                _walk(x[k])
        elif is_sequence(x):
            for i in x:
                _walk(i)
        else:
            out.append(x)

    _walk(nest)
    return out


def map_structure(func, *structures):
    s = structures[0]
    if isinstance(s, dict):
        return {k: map_structure(func, *[x[k] for x in structures]) for k in s}
    if is_sequence(s):
        return type(s)(
            map_structure(func, *xs) for xs in zip(*structures)
        )
    return func(*structures)
