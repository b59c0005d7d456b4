"""DataLoader / PyReader — the host-side asynchronous data pipeline
(port of ``paddle_tpu/fluid/reader.py``).

Reference: python/paddle/fluid/reader.py (DataLoader.from_generator:73,
GeneratorLoader:298, PyReader:583) over a C++ LoDTensorBlockingQueue and
BufferedReader's double-buffered H2D copies on a CUDA stream of its own
(operators/reader/buffered_reader.cc:63-95).

Batches are decoded through the native blocking queue (``native``, when
the host library builds) and, with ``use_double_buffer``, staged onto
the first of ``places`` by ``io_pipeline.DeviceFeeder``: a pinned host
copy and a ``non_blocking`` H2D copy on the feeder's stream, one batch
ahead of the step. ``places`` None means the card, as everywhere in the
port; without one the first pull raises unless the caller passes
``fluid.cpu_places()``. Without double buffering the loader is plain
threaded buffering of host batches at ``capacity`` depth."""

import struct
import threading

import numpy as np

from . import core
from . import io_pipeline as _io_pipeline
from .framework import Variable

__all__ = ["DataLoader", "PyReader"]


def _close_queue(holder):
    """Close an epoch's native queue exactly once (idempotent; holder may
    be None before the first epoch)."""
    q = holder.pop("q", None) if holder else None
    if q is not None:
        try:
            q.close()
        except Exception:
            pass


class _GeneratorLoader(object):
    def __init__(
        self,
        feed_list=None,
        capacity=64,
        use_double_buffer=True,
        iterable=True,
        return_list=False,
    ):
        self._feed_list = feed_list or []
        self._capacity = capacity
        self._use_double_buffer = use_double_buffer
        self._iterable = iterable
        self._return_list = return_list
        self._batch_reader = None
        self._places = None
        self._queue = None
        self._thread = None
        self._exit_event = None  # current epoch's shutdown signal
        self._pipe = None  # current epoch's DeviceFeeder
        # current epoch's {"q": BlockingQueue} holder — PER EPOCH, so a
        # stale iterator's cleanup can only ever close its own queue,
        # never a newer epoch's
        self._native_holder = None
        self._it = None

    # -- wiring --
    def set_sample_generator(
        self, reader, batch_size, drop_last=True, places=None
    ):
        from ..reader.decorator import batch as batch_decorator

        self.set_sample_list_generator(
            batch_decorator(reader, batch_size, drop_last), places
        )
        return self

    def set_sample_list_generator(self, reader, places=None):
        def _batch_reader():
            for sample_list in reader():
                slots = None
                for sample in sample_list:
                    if slots is None:
                        slots = [[] for _ in sample]
                    for i, field in enumerate(sample):
                        slots[i].append(field)
                yield [np.asarray(s) for s in slots]

        self.set_batch_generator(_batch_reader, places)
        return self

    def set_batch_generator(self, reader, places=None):
        self._batch_reader = reader
        self._places = places
        return self

    # -- iteration --
    def _feed_names(self):
        return [
            v.name if isinstance(v, Variable) else str(v)
            for v in self._feed_list
        ]

    def __iter__(self):
        if not self._iterable:
            raise RuntimeError(
                "DataLoader is not iterable; use start()/reset() mode"
            )
        return self._run()

    def _run(self):
        """One epoch: a decode source (native blocking queue when the C++
        library is present, plain Python otherwise) wrapped in a
        DeviceFeeder. With ``use_double_buffer`` the feeder's thread
        decodes batch N+1 and copies it to the first of ``places`` (the
        card when None) while step N computes; otherwise it is plain
        threaded host buffering at ``capacity`` depth."""
        from . import native

        exit_ev = threading.Event()
        self._exit_event = exit_ev
        holder = {"q": None}
        self._native_holder = holder
        if native.available():
            src = self._run_native(exit_ev, holder)
        else:
            src = self._iter_decoded(exit_ev)
        pipe = _io_pipeline.DeviceFeeder(
            src,
            place=self._places if self._use_double_buffer else None,
            depth=None if self._use_double_buffer else self._capacity,
            stage=self._use_double_buffer,
        )
        self._pipe = pipe
        try:
            yield from pipe
        finally:
            # normal exhaustion, consumer abandon (GeneratorExit), or a
            # propagated producer error all land here: no leaked threads
            exit_ev.set()
            _close_queue(holder)
            pipe.close()
            # the queue registers from the feeder thread at generator
            # start — re-check in case that happened mid-shutdown
            _close_queue(holder)
            if self._pipe is pipe:
                self._pipe = None

    def _iter_decoded(self, exit_ev):
        """Synchronous decode source (no native library): runs on the
        DeviceFeeder's producer thread."""
        names = self._feed_names()
        for batch in self._batch_reader():
            if exit_ev.is_set():
                return
            if isinstance(batch, dict):
                yield batch
            else:
                # no feed_list (from_dataset) -> yield the raw batch list
                yield dict(zip(names, batch)) if names else batch

    def _run_native(self, exit_ev, holder):
        """Producer thread feeds the native C++ blocking queue with
        tensor-stream-encoded batches (reference: GeneratorLoader over
        LoDTensorBlockingQueue, reader.py:298 + reader_py.cc); blocking
        push/pop release the GIL so parsing overlaps with compute."""
        import pickle

        from . import native
        from .ops import io_ops as _io

        q = native.BlockingQueue(self._capacity)
        holder["q"] = q  # reset()/epoch cleanup close it to unblock both ends
        names = self._feed_names()
        producer_error = []

        def _encode_item(arr):
            # kind 0: tensor stream; kind 1: pickle (dtypes/objects the
            # stream format does not cover — same universality as the
            # Python-queue path)
            try:
                if isinstance(arr, core.LoDTensor):
                    return b"\x00" + _io.serialize_lod_tensor(arr)
                a = np.asarray(arr)
                if np.dtype(a.dtype) in native._NP_TO_ENUM:
                    return b"\x00" + native.serialize_tensor(a, [])
            except Exception:
                pass
            return b"\x01" + pickle.dumps(arr, protocol=4)

        def _encode(batch):
            # dict batches keep their own keys (same semantics as the
            # Python-queue path, which yields dicts unchanged)
            keys = None
            if isinstance(batch, dict):
                keys = list(batch.keys())
                batch = [batch[k] for k in keys]
            parts = [_encode_item(arr) for arr in batch]
            head = struct.pack("<I", len(parts))
            kblob = pickle.dumps(keys, protocol=4)
            return (
                head + struct.pack("<Q", len(kblob)) + kblob
                + b"".join(struct.pack("<Q", len(p)) + p for p in parts)
            )

        def _producer():
            try:
                for batch in self._batch_reader():
                    if exit_ev.is_set():
                        return
                    try:
                        q.push(_encode(batch))
                    except native.QueueClosed:
                        return
            except BaseException as e:  # surfaced to the consumer
                producer_error.append(e)
            finally:
                q.close()

        t = threading.Thread(target=_producer, daemon=True)
        t.start()
        while True:
            try:
                blob = q.pop()
            except native.QueueClosed:
                if producer_error:
                    raise producer_error[0]
                return
            if blob is None:
                continue
            (count,) = struct.unpack_from("<I", blob, 0)
            pos = 4
            (klen,) = struct.unpack_from("<Q", blob, pos)
            pos += 8
            keys = pickle.loads(blob[pos : pos + klen])
            pos += klen
            vals = []
            for _ in range(count):
                (plen,) = struct.unpack_from("<Q", blob, pos)
                pos += 8
                kind = blob[pos]
                body = blob[pos + 1 : pos + plen]
                pos += plen
                if kind == 0:
                    tns, _ = _io.deserialize_lod_tensor(body)
                    vals.append(tns if tns.lod() else tns.numpy())
                else:
                    vals.append(pickle.loads(body))
            if keys is not None:
                yield dict(zip(keys, vals))
            elif names:
                yield dict(zip(names, vals))
            else:
                yield vals

    # non-iterable (start/reset) mode
    def start(self):
        self._it = self._run()

    def reset(self):
        """Stop the current epoch's pipeline mid-stream: signals the
        decode source, closes the native queue (unblocking a mid-push
        producer), and joins the feeder thread — no leaked threads, and a
        fresh ``__iter__``/``start()`` begins a clean epoch."""
        ev = self._exit_event
        if ev is not None:
            ev.set()
        holder = self._native_holder
        _close_queue(holder)
        pipe = self._pipe
        if pipe is not None:
            self._pipe = None
            pipe.close()
        _close_queue(holder)  # registered mid-shutdown from the feeder
        it = self._it
        if it is not None:
            self._it = None
            it.close()

    def next(self):
        return next(self._it)


class DataLoader(object):
    @staticmethod
    def from_generator(
        feed_list=None,
        capacity=64,
        use_double_buffer=True,
        iterable=True,
        return_list=False,
        use_multiprocess=False,
    ):
        """reference: reader.py:73."""
        return _GeneratorLoader(
            feed_list, capacity, use_double_buffer, iterable, return_list
        )

    @staticmethod
    def from_dataset(dataset, places, drop_last=True):
        def _gen():
            for batch in dataset._iter_batches():
                yield batch

        loader = _GeneratorLoader(iterable=True)
        loader.set_batch_generator(_gen, places)
        return loader


class PyReader(_GeneratorLoader):
    """reference: reader.py:583 PyReader — older alias of GeneratorLoader."""

    def __init__(
        self,
        feed_list=None,
        capacity=64,
        use_double_buffer=True,
        iterable=True,
        return_list=False,
    ):
        super().__init__(
            feed_list, capacity, use_double_buffer, iterable, return_list
        )

    def decorate_sample_generator(self, sample_generator, batch_size,
                                  drop_last=True, places=None):
        return self.set_sample_generator(
            sample_generator, batch_size, drop_last, places
        )

    def decorate_sample_list_generator(self, reader, places=None):
        return self.set_sample_list_generator(reader, places)

    def decorate_batch_generator(self, reader, places=None):
        return self.set_batch_generator(reader, places)

