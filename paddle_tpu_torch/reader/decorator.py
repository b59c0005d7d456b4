"""Reader decorators (copy of ``paddle_tpu/reader/decorator.py``;
reference: python/paddle/reader/decorator.py — pure Python composable
readers: map/shuffle/batch/buffered/xmap/cache)."""

from __future__ import annotations

import itertools
import queue
import random
import threading

__all__ = [
    "map_readers",
    "buffered",
    "compose",
    "chain",
    "shuffle",
    "ComposeNotAligned",
    "firstn",
    "xmap_readers",
    "cache",
    "multiprocess_reader",
    "batch",
]


class ComposeNotAligned(ValueError):
    pass


def map_readers(func, *readers):
    def reader():
        rs = [r() for r in readers]
        for e in map(func, *rs):
            yield e

    return reader


def shuffle(reader, buf_size):
    def data_reader():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                random.shuffle(buf)
                for b in buf:
                    yield b
                buf = []
        if buf:
            random.shuffle(buf)
            for b in buf:
                yield b

    return data_reader


def chain(*readers):
    def reader():
        rs = [r() for r in readers]
        for e in itertools.chain(*rs):
            yield e

    return reader


def compose(*readers, **kwargs):
    check_alignment = kwargs.pop("check_alignment", True)

    def make_tuple(x):
        if isinstance(x, tuple):
            return x
        return (x,)

    def reader():
        rs = [r() for r in readers]
        if not check_alignment:
            for outputs in zip(*rs):
                yield sum(list(map(make_tuple, outputs)), ())
        else:
            for outputs in itertools.zip_longest(*rs):
                for o in outputs:
                    if o is None:
                        raise ComposeNotAligned(
                            "outputs of readers are not aligned"
                        )
                yield sum(list(map(make_tuple, outputs)), ())

    return reader


def buffered(reader, size):
    class EndSignal(object):
        pass

    end = EndSignal()

    def read_worker(r, q):
        for d in r:
            q.put(d)
        q.put(end)

    def data_reader():
        r = reader()
        q = queue.Queue(maxsize=size)
        t = threading.Thread(target=read_worker, args=(r, q))
        t.daemon = True
        t.start()
        e = q.get()
        while e is not end:
            yield e
            e = q.get()

    return data_reader


def firstn(reader, n):
    def firstn_reader():
        for i, item in enumerate(reader()):
            if i == n:
                break
            yield item

    return firstn_reader


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Parallel map over a reader with worker threads
    (reference: decorator.py xmap_readers)."""
    end = object()

    def data_reader():
        in_q = queue.Queue(buffer_size)
        out_q = queue.Queue(buffer_size)
        flags = {"producing": True}

        def producer():
            for sample in reader():
                in_q.put(sample)
            for _ in range(process_num):
                in_q.put(end)

        def worker():
            while True:
                sample = in_q.get()
                if sample is end:
                    out_q.put(end)
                    return
                out_q.put(mapper(sample))

        threads = [threading.Thread(target=producer, daemon=True)]
        threads += [
            threading.Thread(target=worker, daemon=True)
            for _ in range(process_num)
        ]
        for t in threads:
            t.start()
        finished = 0
        while finished < process_num:
            sample = out_q.get()
            if sample is end:
                finished += 1
            else:
                yield sample
        _ = flags

    return data_reader


def cache(reader):
    all_data = []

    def cache_reader():
        if not all_data:
            all_data.extend(reader())
        for d in all_data:
            yield d

    return cache_reader


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """Fan-in of the readers one after another (interface-compatible;
    true multiprocessing would add pickling for no gain here)."""
    return chain(*readers)


def batch(reader, batch_size, drop_last=False):
    if not isinstance(batch_size, int) or batch_size <= 0:
        raise ValueError(
            "batch_size should be a positive integer value, "
            "but got batch_size={}".format(batch_size))

    def batch_reader():
        r = reader()
        b = []
        for instance in r:
            b.append(instance)
            if len(b) == batch_size:
                yield b
                b = []
        if drop_last is False and len(b) != 0:
            yield b

    return batch_reader
