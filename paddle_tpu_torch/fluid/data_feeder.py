"""DataFeeder: samples of numpy arrays or lists into the feed dict of
LoDTensors (copy of ``paddle_tpu/fluid/data_feeder.py``).

A ``lod_level`` 0 slot becomes one array of the batch; a ragged slot
becomes its sequences' rows back to back with their lengths as LoD,
which the Executor pads and turns into ``@SEQ_LEN`` companions
(``executor._lod_feed``)."""

import numpy as np

from . import core
from .framework import Variable, default_main_program

__all__ = ["DataFeeder", "DataToLoDTensorConverter"]


class DataToLoDTensorConverter(object):
    def __init__(self, place, lod_level, shape, dtype):
        self.place = place
        self.lod_level = lod_level
        self.shape = shape
        negtive_count = sum(1 for s in shape if s < 0)
        if negtive_count > 1:
            self.shape = None
        self.dtype = core.dtype_to_np(dtype)
        self.data = []
        self.lod = [[] for _ in range(lod_level)]

    def feed(self, data):
        self._feed_impl_(data, self.lod, self.lod_level)

    def _feed_impl_(self, data, lod, lod_level):
        if lod_level == 0:
            self.data.append(data)
        else:
            lod[0].append(len(data))
            for each_data in data:
                self._feed_impl_(each_data, lod[1:], lod_level - 1)

    def done(self):
        if self.lod_level == 0:
            arr = np.array(self.data, dtype=self.dtype)
            if self.shape:
                if len(arr.shape) != len(self.shape):
                    try:
                        arr = arr.reshape(self.shape)
                    except ValueError:
                        pass
            return core.LoDTensor(arr)
        # ragged: the rows back to back and their lengths; the Executor
        # pads them
        arr = np.array(self.data, dtype=self.dtype)
        t = core.LoDTensor(arr)
        t.set_recursive_sequence_lengths(self.lod)
        return t


class DataFeeder(object):
    def __init__(self, feed_list, place, program=None):
        self.feed_dtypes = []
        self.feed_names = []
        self.feed_shapes = []
        self.feed_lod_level = []
        program = program or default_main_program()
        for each_var in feed_list:
            if isinstance(each_var, str):
                each_var = program.global_block().var(each_var)
            if not isinstance(each_var, Variable):
                raise TypeError("feed_list should contain Variable or str")
            self.feed_dtypes.append(each_var.dtype)
            self.feed_names.append(each_var.name)
            self.feed_lod_level.append(each_var.lod_level)
            self.feed_shapes.append(each_var.shape)
        self.place = place

    def feed(self, iterable):
        converter = []
        for lod_level, shape, dtype in zip(
                self.feed_lod_level, self.feed_shapes, self.feed_dtypes):
            converter.append(DataToLoDTensorConverter(
                place=self.place, lod_level=lod_level, shape=shape,
                dtype=dtype))
        for each_sample in iterable:
            assert len(each_sample) == len(converter), (
                "the number of fields in each sample must match feed_list")
            for each_converter, each_slot in zip(converter, each_sample):
                each_converter.feed(each_slot)
        return {name: c.done()
                for name, c in zip(self.feed_names, converter)}

    def feed_parallel(self, iterable, num_places=None):
        """One merged feed (the reference's SPMD form: no per-device
        split)."""
        yield self.feed([s for batch in iterable for s in batch])

    def decorate_reader(self, reader, multi_devices=False, num_places=None,
                        drop_last=True):
        def _reader():
            for batch in reader():
                yield self.feed(batch)

        return _reader
