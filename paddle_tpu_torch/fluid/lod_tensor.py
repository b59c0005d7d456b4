"""LoDTensor construction helpers (copy of
``paddle_tpu/fluid/lod_tensor.py``: ``create_lod_tensor``,
``create_random_int_lodtensor``).

A LoDTensor made here holds the sequences' rows back to back with
length-based LoD; the Executor pads it to [batch, max_len, ...] and
hands the lengths to the sequence ops as ``@SEQ_LEN`` companions
(``executor._lod_feed``)."""

import numpy as np

from . import core

__all__ = ["create_lod_tensor", "create_random_int_lodtensor"]


def create_lod_tensor(data, recursive_seq_lens, place):
    """A LoDTensor holding ``data`` with length-based LoD
    ``recursive_seq_lens`` (e.g. [[2, 3]] for two sequences of 2 and 3
    steps) on ``place``. ``data`` may be a LoDTensor, a numpy array whose
    outer dim equals the summed innermost lengths, or a nested list of
    per-sequence values (each gets a trailing unit dim, as the
    reference's converter does)."""
    if isinstance(data, core.LoDTensor):
        return create_lod_tensor(np.array(data.numpy()),
                                 recursive_seq_lens, place)
    if isinstance(data, list):
        flat = [np.asarray(seq) for seq in data]
        lens = [len(seq) for seq in data]
        assert [lens] == recursive_seq_lens, (
            "data and recursive_seq_lens do not match")
        arr = np.concatenate([f.reshape(len(f), -1) for f in flat], axis=0)
        arr = arr.reshape(arr.shape + (1,)) if arr.ndim == 1 else arr
        t = core.LoDTensor()
        t.set(arr, place)
        t.set_recursive_sequence_lengths(recursive_seq_lens)
        return t
    if isinstance(data, np.ndarray):
        t = core.LoDTensor()
        t.set(data, place)
        t.set_recursive_sequence_lengths(recursive_seq_lens)
        assert t.has_valid_recursive_sequence_lengths(), (
            "the provided lod info is invalid")
        return t
    raise TypeError(
        "data should be either a LoDTensor, a Numpy array or a list")


def create_random_int_lodtensor(recursive_seq_lens, base_shape, place, low,
                                high):
    """Random-integer LoDTensor: shape [sum(innermost lens)] +
    ``base_shape``, values uniform in [low, high] (numpy's global
    generator, as the reference)."""
    assert isinstance(base_shape, list), "base_shape should be a list"
    converted_lod = core._lengths_to_offsets(recursive_seq_lens[-1])
    overall_shape = [converted_lod[-1]] + base_shape
    data = np.random.randint(low, high + 1, overall_shape).astype("int64")
    return create_lod_tensor(data, recursive_seq_lens, place)
