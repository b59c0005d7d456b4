"""Double-buffered host-to-device input pipeline (port of
``paddle_tpu/fluid/io_pipeline.py``).

Reference: the C++ BufferedReader, which double-buffers H2D copies on a
CUDA stream of its own (operators/reader/buffered_reader.cc:63-95),
behind ``double_buffered_reader`` and fed by GeneratorLoader's
LoDTensorBlockingQueue.

A bounded producer thread decodes batch N+1 and copies it to the card
while step N computes. Each dense value goes into a pinned host tensor,
then to the device with a ``non_blocking`` copy on the feeder's own
``torch.cuda.Stream``; an event recorded after the batch's copies rides
on the ``DeviceFeedBatch``. The consumer (``Executor.run``) makes its
stream wait on that event and calls ``record_stream`` on every tensor
before it uses them (``DeviceFeedBatch.wait``), for every staged batch,
a LoD one too, so

- no op reads a half-finished copy (the wait);
- the allocator never hands a tensor made on the copy stream to another
  allocation while the compute stream still reads it
  (``record_stream``);
- a pinned buffer is never rewritten before its copy ended: each batch
  takes fresh pinned tensors from the caching host allocator, which
  recycles a block only after the copy that read it has completed, and
  the batch keeps its own (``DeviceFeedBatch.host``) alive until it is
  dropped.

Each such wait counts in ``io_pipeline_stream_waits``. The queue bound
(``reader_buffer_size``, default 2, classic double buffering) caps how
many staged batches sit on the card.

On the CUDA path nothing falls back: a value that cannot be staged
raises at the consumer's next pull (the reference keeps such a value on
the host). LoD batches keep their host form, as in the reference: the
Executor derives their ``@SEQ_LEN`` companions from the offsets. With
``stage=False`` the feeder is plain threaded buffering of host batches.
"""

import queue
import threading

import numpy as np
import torch

from . import core
from . import flags as _flags
from . import profiler as _profiler
from ..observability import trace as _obs_trace

__all__ = ["DeviceFeedBatch", "DeviceFeeder", "buffer_size",
           "resolve_device"]


def buffer_size():
    """Queue depth of the double-buffered feed (``reader_buffer_size``,
    at least 1)."""
    try:
        return max(int(_flags.get_flag("reader_buffer_size", 2)), 1)
    except (TypeError, ValueError):
        return 2


class DeviceFeedBatch(dict):
    """A feed dict whose values are tensors already on ``device``.

    ``device`` is None when some value kept its host form (a LoDTensor);
    the other values are staged all the same, on ``staged_on``.
    ``event`` is the CUDA event recorded after the batch's copies on the
    feeder's stream (None on the CPU); ``host`` maps each staged name to
    the pinned host tensor it was copied from."""

    __slots__ = ("device", "staged_on", "event", "host", "_waited")

    def __init__(self, mapping, device=None, event=None, host=None,
                 staged_on=None):
        super().__init__(mapping)
        self.device = device
        self.staged_on = staged_on if staged_on is not None else device
        self.event = event
        self.host = dict(host or {})
        self._waited = set()

    def wait(self, stream=None):
        """Make ``stream`` (default: the current stream of the device the
        batch was staged on) wait for the batch's copies, and mark every
        tensor as in use on it. Needed once per stream before the tensors
        are read, whether or not some value kept its host form."""
        if self.event is None:
            return self
        if stream is None:
            stream = torch.cuda.current_stream(self.staged_on)
        key = (stream.device_index, stream.stream_id)
        if key in self._waited:
            return self
        stream.wait_event(self.event)
        for v in self.values():
            if isinstance(v, torch.Tensor) and v.device.type == "cuda":
                v.record_stream(stream)
        self._waited.add(key)
        _profiler.bump_counter("io_pipeline_stream_waits")
        return self


class _Sentinel(object):
    __slots__ = ()


_END = _Sentinel()


def resolve_device(place):
    """A place (or the first of a list of places; a ``torch.device`` or a
    string too) as a ``torch.device``. ``None`` means the card, as every
    entry point of the port; without one this raises."""
    if isinstance(place, (list, tuple)):
        if not place:
            raise ValueError("resolve_device: an empty list of places")
        place = place[0]
    return core.resolve_device(place)


class DeviceFeeder(object):
    """Bounded background producer over an iterable of batches.

    The producer thread pulls from ``source`` (host decode runs there),
    stages each dict batch onto ``place``'s device and parks at most
    ``depth`` staged batches in a queue. Order is kept; a producer
    exception re-raises at the consumer's next pull; ``close()`` (also
    run on exhaustion) stops the thread without leaking it. ``place``
    None means the card; ``stage=False`` passes host batches through."""

    def __init__(self, source, place=None, depth=None, stage=True):
        self._source = source
        self._device = resolve_device(place) if stage else None
        if depth is None:
            depth = buffer_size() if self._device is not None else 8
        self._stream = None
        self._q = queue.Queue(maxsize=max(int(depth), 1))
        self._stop = threading.Event()
        self._error = []
        self._done = False
        self._thread = threading.Thread(
            target=self._produce, name="io_pipeline_feeder", daemon=True
        )
        self._thread.start()

    # -- producer side --
    def _stage(self, batch):
        dev = self._device
        if dev is None or not isinstance(batch, dict):
            return batch
        if dev.type == "cuda":
            return self._stage_cuda(batch, dev)
        staged = {}
        all_on_device = True
        for k, v in batch.items():
            if isinstance(v, core.LoDTensor):
                staged[k] = v
                all_on_device = False
            elif isinstance(v, torch.Tensor):
                staged[k] = v.to(dev, copy=True)
            else:
                staged[k] = torch.tensor(np.asarray(v), device=dev)
        if all_on_device:
            _profiler.bump_counter("io_pipeline_h2d_batches")
        return DeviceFeedBatch(staged, device=dev if all_on_device else None,
                               staged_on=dev)

    def _stage_cuda(self, batch, dev):
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=dev)
        staged = {}
        pinned = {}
        all_on_device = True
        with torch.cuda.stream(self._stream):
            for k, v in batch.items():
                if isinstance(v, core.LoDTensor):
                    # LoD batches keep their host form: the Executor
                    # derives the @SEQ_LEN companions from the offsets
                    staged[k] = v
                    all_on_device = False
                    continue
                if isinstance(v, torch.Tensor) and v.device == dev:
                    staged[k] = v
                    continue
                host = v.detach() if isinstance(v, torch.Tensor) else \
                    torch.from_numpy(np.ascontiguousarray(np.asarray(v)))
                buf = torch.empty(host.shape, dtype=host.dtype,
                                  pin_memory=True)
                buf.copy_(host)
                pinned[k] = buf
                staged[k] = buf.to(dev, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        if all_on_device:
            _profiler.bump_counter("io_pipeline_h2d_batches")
        return DeviceFeedBatch(staged, device=dev if all_on_device else None,
                               event=event, host=pinned, staged_on=dev)

    def _put(self, item):
        """Bounded put that re-checks stop, so an abandoned consumer never
        strands the producer on a full queue. False once stopped."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self):
        from ..testing import chaos as _chaos

        try:
            for batch in self._source:
                if self._stop.is_set():
                    break
                # the span covers the chaos delay and the staging, on the
                # producer thread's row beside the consumer's executor_run
                with _obs_trace.span("feed_stage", cat="feed"):
                    _chaos.maybe_slow_feed()
                    staged = self._stage(batch)
                if not self._put(staged):
                    break
        except BaseException as e:  # surfaced at the consumer's next pull
            self._error.append(e)
        finally:
            self._put(_END)
            close = getattr(self._source, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:
                    pass

    # -- consumer side --
    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        while True:
            if self._stop.is_set():
                self._done = True
                raise StopIteration
            try:
                item = self._q.get(timeout=0.5)
                break
            except queue.Empty:
                if not self._thread.is_alive() and self._q.empty():
                    # the producer died before it could park the sentinel
                    self._done = True
                    if self._error:
                        raise self._error[0]
                    raise StopIteration
        if isinstance(item, _Sentinel):
            self._done = True
            self.close()
            if self._error:
                raise self._error[0]
            raise StopIteration
        return item

    def close(self, join_timeout=5.0):
        """Idempotent shutdown: stop the producer, drain the queue so a
        blocked put unsticks, and join the thread."""
        self._stop.set()
        self._done = True
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        if self._thread.is_alive():
            self._thread.join(timeout=join_timeout)

    @property
    def device(self):
        return self._device
