"""The port's input pipeline (``paddle_tpu_torch.reader``,
``fluid.io_pipeline``, ``fluid.reader``, ``fluid.native``,
``fluid.dataset``, ``fluid.data_feed_desc``) held against the JAX
package on the CPU: the reader decorators' outputs, the batches of
``DataLoader`` and ``PyReader``, the native stream bytes and MultiSlot
parse, the dataset batches, and the feeder's thread hygiene.

The port stages onto ``fluid.cpu_places()`` here (on the card it copies
through pinned memory on a stream of its own, ``chip_smoke.py``'s
``train_runtime`` phase); the reference stages onto its CPU device.
Values cross as numpy arrays and are compared exactly.
"""

import random
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import dataset as jdataset
from paddle_tpu.fluid import native as jnative
from paddle_tpu.fluid.data_feed_desc import DataFeedDesc as JDataFeedDesc
from paddle_tpu.reader import decorator as jdec
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import dataset as tdataset
from paddle_tpu_torch.fluid import io_pipeline as tio
from paddle_tpu_torch.fluid import native as tnative
from paddle_tpu_torch.fluid import profiler as tprofiler
from paddle_tpu_torch.fluid.data_feed_desc import DataFeedDesc as TDataFeedDesc
from paddle_tpu_torch.reader import decorator as tdec
from test_torch_cpu_math import pin_vector_math

pin_vector_math(2)  # 2 threads, vector math set up on one (see there)


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.numpy()
    if hasattr(v, "numpy"):
        return np.asarray(v.numpy())
    return np.asarray(v)


def _feeder_threads():
    return [t for t in threading.enumerate()
            if t.name == "io_pipeline_feeder" and t.is_alive()]


def _wait_no_feeders(timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if not _feeder_threads():
            return True
        time.sleep(0.02)
    return False


# ---------------------------------------------------------------------------
# reader decorators
# ---------------------------------------------------------------------------
def _samples(n=23):
    def reader():
        for i in range(n):
            yield (i, i * i)
    return reader


def _letters():
    def reader():
        for c in "abcdefg":
            yield c
    return reader


_DECORATED = {
    "batch": lambda d: d.batch(_samples(), 5),
    "batch_drop_last": lambda d: d.batch(_samples(), 5, drop_last=True),
    "shuffle": lambda d: d.shuffle(_samples(), 7),
    "buffered": lambda d: d.buffered(_samples(), 3),
    "xmap": lambda d: d.xmap_readers(
        lambda s: (s[0] + 1, s[1]), _samples(), 3, 4),
    "compose": lambda d: d.compose(_samples(7), _letters()),
    "chain": lambda d: d.chain(_samples(4), _letters()),
    "firstn": lambda d: d.firstn(_samples(), 6),
    "cache": lambda d: d.cache(_samples(9)),
    "map_readers": lambda d: d.map_readers(
        lambda a, b: (a, b), _samples(7), _letters()),
    "multiprocess_reader": lambda d: d.multiprocess_reader(
        [_samples(5)], use_pipe=False),
}


# worker threads map in any order (the reference's xmap_readers keeps no
# order either): compared as multisets
_UNORDERED = {"xmap"}


@pytest.mark.parametrize("name", sorted(_DECORATED))
def test_decorator_outputs_match_reference(name):
    """Each decorator of ``paddle_tpu_torch.reader`` yields what the
    reference's yields from the same readers (``shuffle`` from the same
    ``random`` seed)."""
    random.seed(5)
    want = list(_DECORATED[name](jdec)())
    random.seed(5)
    got = list(_DECORATED[name](tdec)())
    if name in _UNORDERED:
        got, want = sorted(got), sorted(want)
    assert got == want
    assert len(got) > 0


def test_top_level_batch_is_the_decorator():
    import paddle_tpu
    import paddle_tpu_torch

    assert paddle_tpu_torch.batch is tdec.batch
    assert list(paddle_tpu_torch.batch(_samples(), 4)()) == list(
        paddle_tpu.batch(_samples(), 4)())


def test_compose_not_aligned_raises_as_reference():
    for d in (jdec, tdec):
        with pytest.raises(d.ComposeNotAligned):
            list(d.compose(_samples(3), _samples(4))())


# ---------------------------------------------------------------------------
# native host library
# ---------------------------------------------------------------------------
_STREAM_CASES = {
    "f32": (np.arange(12, dtype=np.float32).reshape(3, 4), []),
    "i64_lod": (np.arange(5, dtype=np.int64).reshape(5, 1), [[0, 2, 5]]),
    "f64_0d": (np.array(2.5), []),
    "i32": (np.array([[1, -2], [3, 4]], np.int32), []),
    "u8": (np.arange(7, dtype=np.uint8), []),
    "bool": (np.array([True, False, True]), []),
    "f16": (np.linspace(0, 1, 6).astype(np.float16), []),
}


@pytest.mark.parametrize("case", sorted(_STREAM_CASES))
def test_native_stream_bytes_match_reference(case):
    """The port's native codec writes the reference's bytes, equal to the
    port's Python codec too, and reads them back."""
    from paddle_tpu_torch.fluid.ops.io_ops import serialize_lod_tensor

    assert tnative.available() and jnative.available()
    arr, lod = _STREAM_CASES[case]
    got = tnative.serialize_tensor(arr, lod)
    assert got == jnative.serialize_tensor(arr, lod)
    assert got == serialize_lod_tensor(tfluid.LoDTensor(arr, lod=lod))
    back, back_lod, used = tnative.deserialize_tensor(got)
    np.testing.assert_array_equal(back, arr)
    assert back_lod == lod and used == len(got)


def test_native_blocking_queue_order_capacity_and_close():
    q = tnative.BlockingQueue(2)
    assert q.push(b"a") and q.push(b"bb")
    assert not q.push(b"c", timeout_ms=10)  # full
    assert q.size() == 2
    assert q.pop() == b"a" and q.pop() == b"bb"
    assert q.pop(timeout_ms=10) is None
    q.close()
    with pytest.raises(tnative.QueueClosed):
        q.pop()
    with pytest.raises(tnative.QueueClosed):
        q.push(b"x")


def _multislot_file(tmp_path, name="ms.txt"):
    path = str(tmp_path / name)
    with open(path, "w") as f:
        f.write("2 0.5 1.5 3 7 8 9\n")
        f.write("2 2.5 3.5 1 4\n")
        f.write("2 -1 0 2 5 6\n")
    return path


def test_native_multislot_parse_matches_reference(tmp_path):
    path = _multislot_file(tmp_path)
    t = tnative.MultiSlotFile(path, [True, False])
    j = jnative.MultiSlotFile(path, [True, False])
    assert t.num_lines == j.num_lines == 3
    for i in range(2):
        (tv, to), (jv, jo) = t.slot(i), j.slot(i)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(to, jo)
        assert tv.dtype == jv.dtype


# ---------------------------------------------------------------------------
# the feeder
# ---------------------------------------------------------------------------
def test_feeder_order_kept_and_staged_on_the_place():
    batches = [{"a": np.full((2, 2), i, "float32")} for i in range(7)]
    n0 = tprofiler.get_counter("io_pipeline_h2d_batches")
    out = list(tio.DeviceFeeder(iter(batches), place=tfluid.CPUPlace()))
    assert len(out) == 7
    for i, b in enumerate(out):
        assert isinstance(b, tio.DeviceFeedBatch)
        assert b.device == torch.device("cpu") and b.event is None
        assert isinstance(b["a"], torch.Tensor)
        np.testing.assert_array_equal(b["a"].numpy(), batches[i]["a"])
    assert tprofiler.get_counter("io_pipeline_h2d_batches") - n0 == 7
    assert _wait_no_feeders()


def test_feeder_staged_tensor_is_a_copy():
    """A staged batch owns its memory: an op that updates its input in
    place never writes the producer's array."""
    src = np.zeros((3,), "float32")
    (b,) = list(tio.DeviceFeeder(iter([{"a": src}]), place="cpu"))
    b["a"].add_(1.0)
    assert float(src.sum()) == 0.0


def test_feeder_exception_propagates():
    def bad():
        yield {"a": np.zeros((1,), "float32")}
        raise ValueError("decode exploded")

    it = iter(tio.DeviceFeeder(bad(), place=tfluid.CPUPlace()))
    next(it)
    with pytest.raises(ValueError, match="decode exploded"):
        next(it)
    assert _wait_no_feeders()


def test_feeder_close_unsticks_blocked_producer():
    produced = []

    def infinite():
        i = 0
        while True:
            produced.append(i)
            yield {"a": np.full((1,), i, "float32")}
            i += 1

    pipe = tio.DeviceFeeder(infinite(), place=tfluid.CPUPlace())
    it = iter(pipe)
    next(it)
    next(it)
    pipe.close()  # the producer is parked on the bounded queue
    assert _wait_no_feeders()
    assert len(produced) <= tio.buffer_size() + 4


def test_feeder_unstaged_passes_host_batches_through():
    batches = [[np.ones((2,), "float32")] for _ in range(3)]
    out = list(tio.DeviceFeeder(iter(batches), stage=False))
    assert len(out) == 3 and isinstance(out[0][0], np.ndarray)


def test_feeder_lod_batches_keep_host_form():
    lod = tfluid.LoDTensor(np.arange(3, dtype="int64").reshape(3, 1))
    lod.set_recursive_sequence_lengths([[2, 1]])
    (batch,) = list(tio.DeviceFeeder(
        iter([{"ids": lod, "x": np.ones((2, 2), "float32")}]),
        place=tfluid.CPUPlace()))
    assert batch.device is None
    assert isinstance(batch["ids"], tfluid.LoDTensor)


def test_feeder_depth_follows_the_flag():
    tfluid.set_flags({"reader_buffer_size": 5})
    try:
        assert tio.buffer_size() == 5
        pipe = tio.DeviceFeeder(iter([]), place="cpu")
        assert pipe._q.maxsize == 5
        list(pipe)
    finally:
        tfluid.set_flags({"reader_buffer_size": 2})


# ---------------------------------------------------------------------------
# DataLoader / PyReader against the reference
# ---------------------------------------------------------------------------
def _data_vars(fluid_mod):
    main, startup = fluid_mod.Program(), fluid_mod.Program()
    with fluid_mod.program_guard(main, startup):
        x = fluid_mod.layers.data(name="rd_x", shape=[4], dtype="float32")
        y = fluid_mod.layers.data(name="rd_y", shape=[1], dtype="int64")
    return [x, y]


def _sample_reader():
    rs = np.random.RandomState(3)
    samples = [(rs.rand(4).astype("float32"), np.array([i], "int64"))
               for i in range(10)]

    def reader():
        return iter(samples)
    return reader


def _sample_list_reader():
    inner = _sample_reader()

    def reader():
        it = inner()
        while True:
            chunk = [s for _, s in zip(range(3), it)]
            if not chunk:
                return
            yield chunk
    return reader


def _batch_reader():
    rs = np.random.RandomState(4)
    batches = [(rs.rand(3, 4).astype("float32"),
                np.arange(3, dtype="int64").reshape(3, 1) + 3 * i)
               for i in range(4)]

    def reader():
        return iter(batches)
    return reader


_WIRING = {
    "sample": lambda ld, places: ld.set_sample_generator(
        _sample_reader(), 4, drop_last=False, places=places),
    "sample_list": lambda ld, places: ld.set_sample_list_generator(
        _sample_list_reader(), places=places),
    "batch": lambda ld, places: ld.set_batch_generator(
        _batch_reader(), places=places),
}


def _epoch(fluid_mod, kind, wiring, double_buffer, places):
    feeds = _data_vars(fluid_mod)
    if kind == "data_loader":
        loader = fluid_mod.DataLoader.from_generator(
            feed_list=feeds, capacity=4, use_double_buffer=double_buffer)
        _WIRING[wiring](loader, places)
        return [{k: _np(v) for k, v in b.items()} for b in loader]
    reader = fluid_mod.PyReader(feed_list=feeds, capacity=4,
                                use_double_buffer=double_buffer,
                                iterable=False)
    _WIRING[wiring](reader, places)
    reader.start()
    out = []
    while True:
        try:
            b = reader.next()
        except StopIteration:
            break
        out.append({k: _np(v) for k, v in b.items()})
    reader.reset()
    return out


@pytest.mark.parametrize("double_buffer", [True, False],
                         ids=["double_buffer", "host"])
@pytest.mark.parametrize("wiring", sorted(_WIRING))
@pytest.mark.parametrize("kind", ["data_loader", "py_reader"])
def test_loader_batches_match_reference(kind, wiring, double_buffer):
    """``DataLoader.from_generator`` (iterable) and ``PyReader``
    (start/next/reset) over sample, sample-list and batch generators give
    the reference's batches, in order, value for value."""
    want = _epoch(jfluid, kind, wiring, double_buffer,
                  jfluid.cpu_places())
    got = _epoch(tfluid, kind, wiring, double_buffer, tfluid.cpu_places())
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
            # the reference's staged int64 comes back int32 (JAX without
            # x64); the port keeps the generator's int64
            assert g[k].dtype == w[k].dtype or (
                double_buffer and (g[k].dtype, w[k].dtype) == (
                    np.dtype("int64"), np.dtype("int32")))
    assert _wait_no_feeders()


def test_loader_double_buffer_stages_device_batches():
    feeds = _data_vars(tfluid)
    loader = tfluid.DataLoader.from_generator(feed_list=feeds, capacity=4)
    loader.set_batch_generator(_batch_reader(), places=tfluid.cpu_places())
    out = list(loader)
    assert all(isinstance(b, tio.DeviceFeedBatch) and
               b.device == torch.device("cpu") for b in out)
    assert _wait_no_feeders()


def _make_loader(data):
    feeds = _data_vars(tfluid)[:1]
    loader = tfluid.DataLoader.from_generator(feed_list=feeds, capacity=8)
    loader.set_batch_generator(lambda: iter(data),
                               places=tfluid.cpu_places())
    return loader


def test_loader_reset_mid_epoch_stops_threads_and_restarts():
    rs = np.random.RandomState(0)
    data = [(rs.rand(4, 4).astype("float32"),) for _ in range(6)]
    loader = _make_loader(data * 50)
    it = iter(loader)
    next(it)
    next(it)
    loader.reset()
    assert _wait_no_feeders()
    seen = list(loader)
    assert len(seen) == len(data) * 50
    np.testing.assert_array_equal(seen[0]["rd_x"].numpy(), data[0][0])
    assert _wait_no_feeders()


def test_stale_iterator_cannot_cut_a_live_epoch():
    """An abandoned epoch-1 iterator closing while epoch 2 runs tears
    down only its own native queue, never the live epoch's stream."""
    data = [(np.full((2, 4), i, "float32"),) for i in range(30)]
    loader = _make_loader(data)
    it1 = iter(loader)
    next(it1)
    loader.reset()
    it2 = iter(loader)
    first = next(it2)
    it1.close()
    rest = list(it2)
    assert 1 + len(rest) == len(data), "live epoch was truncated"
    np.testing.assert_array_equal(first["rd_x"].numpy(), data[0][0])
    np.testing.assert_array_equal(rest[-1]["rd_x"].numpy(), data[-1][0])
    assert _wait_no_feeders()


def test_loader_producer_error_propagates_and_epochs_leave_no_threads():
    data = [(np.ones((2, 4), "float32"),) for _ in range(4)]
    loader = _make_loader(data)
    for _ in range(3):
        assert len(list(loader)) == 4
    assert _wait_no_feeders()

    def bad():
        yield (np.ones((2, 4), "float32"),)
        raise RuntimeError("reader died mid-epoch")

    loader.set_batch_generator(bad, places=tfluid.cpu_places())
    with pytest.raises(RuntimeError, match="reader died mid-epoch"):
        list(loader)
    assert _wait_no_feeders()


def test_executor_fast_lane_takes_staged_batches():
    """A ``DeviceFeedBatch`` on the Executor's device goes in as it is
    (``executor_feed_fast_lane_steps``); the fetches equal a numpy feed's."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="fl_x", shape=[4], dtype="float32")
        y = tfluid.layers.fc(input=x, size=3)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    xs = [np.random.RandomState(i).rand(2, 4).astype("float32")
          for i in range(3)]
    want = [exe.run(main, feed={"fl_x": a}, fetch_list=[y], scope=scope)[0]
            for a in xs]
    n0 = tprofiler.get_counter("executor_feed_fast_lane_steps")
    got = [exe.run(main, feed=b, fetch_list=[y], scope=scope)[0]
           for b in tio.DeviceFeeder(iter([{"fl_x": a} for a in xs]),
                                     place=exe.device)]
    assert tprofiler.get_counter("executor_feed_fast_lane_steps") - n0 == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _mixed_lod_program():
    """Per sequence the sum of a LoD feature's rows beside the mean of a
    dense feature, an fc and a softmax loss, trained by SGD: each batch
    mixes a LoD value with dense ones."""
    L = tfluid.layers
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = L.data(name="mx_x", shape=[-1, 6], dtype="float32", lod_level=1)
        d = L.data(name="mx_d", shape=[5, 6], dtype="float32")
        label = L.data(name="mx_label", shape=[1], dtype="int64")
        feat = L.concat([L.sequence_pool(x, "sum"),
                         L.reduce_mean(d, dim=[1])], axis=1)
        loss = L.mean(L.softmax_with_cross_entropy(L.fc(feat, size=3),
                                                   label))
        tfluid.optimizer.SGD(0.5).minimize(loss)
    return main, startup, [x, d, label], loss


def _mixed_lod_batches(n=4, batch=3):
    rs = np.random.RandomState(3)
    out = []
    for _ in range(n):
        lens = rs.randint(1, 5, size=batch).tolist()
        x = tfluid.LoDTensor(rs.rand(sum(lens), 6).astype("float32"))
        x.set_recursive_sequence_lengths([lens])
        out.append([x, rs.rand(batch, 5, 6).astype("float32"),
                    rs.randint(0, 3, (batch, 1)).astype("int64")])
    return out


class _CountingBatch(tio.DeviceFeedBatch):
    __slots__ = ("waits",)

    def wait(self, stream=None):
        self.waits += 1
        return super().wait(stream)


def test_executor_waits_on_a_staged_batch_that_mixes_lod_and_dense():
    """A staged batch whose LoD value kept its host form (``device``
    None) still has the run wait on its copies before any value is read,
    and takes no fast lane; through the double-buffered ``DataLoader``
    its losses are those of the same values fed as they are."""
    main, startup, feeds, loss = _mixed_lod_program()
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    init = {v.name: scope.get(v.name).clone() for v in main.list_vars()
            if v.persistable and isinstance(scope.get(v.name), torch.Tensor)}
    batches = _mixed_lod_batches()
    names = [v.name for v in feeds]
    want = [exe.run(main, feed=dict(zip(names, b)), fetch_list=[loss],
                    scope=scope)[0] for b in batches]
    for n, t in init.items():
        scope.get(n).copy_(t)
    loader = tfluid.DataLoader.from_generator(feed_list=feeds, capacity=2,
                                              use_double_buffer=True)
    loader.set_batch_generator(lambda: iter(batches),
                               places=tfluid.cpu_places())
    fast0 = tprofiler.get_counter("executor_feed_fast_lane_steps")
    got, waits = [], []
    for b in loader:
        assert isinstance(b, tio.DeviceFeedBatch) and b.device is None
        assert b.staged_on == exe.device
        assert isinstance(b["mx_x"], tfluid.LoDTensor)
        assert isinstance(b["mx_d"], torch.Tensor)
        spy = _CountingBatch(b, device=b.device, event=b.event, host=b.host,
                             staged_on=b.staged_on)
        spy.waits = 0
        got.append(exe.run(main, feed=spy, fetch_list=[loss],
                           scope=scope)[0])
        waits.append(spy.waits)
    assert waits == [1] * len(batches)
    assert tprofiler.get_counter("executor_feed_fast_lane_steps") == fast0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------
def _dataset(mod, path, use_var, dense, kind="QueueDataset", batch=2):
    ds = mod.DatasetFactory().create_dataset(kind)
    ds.set_filelist([path])
    ds.set_batch_size(batch)
    ds.set_multislot([True, False], dense_slots=dense)
    ds.set_use_var(use_var)
    return ds


@pytest.mark.parametrize("dense", [None, [True, False]],
                         ids=["inferred", "explicit"])
def test_dataset_multislot_batches_match_reference(tmp_path, dense):
    """MultiSlot batches through the native parser: the dense float slot
    stacks, the int slot batches as a LoDTensor, each the reference's."""
    path = _multislot_file(tmp_path)
    want = list(_dataset(jdataset, path, [], dense)._iter_batches())
    got = list(_dataset(tdataset, path, [], dense)._iter_batches())
    assert len(got) == len(want) == 2
    for gb, wb in zip(got, want):
        np.testing.assert_array_equal(_np(gb[0]), np.asarray(wb[0]))
        assert isinstance(gb[1], tfluid.LoDTensor)
        np.testing.assert_array_equal(gb[1].numpy(), _np(wb[1]))
        assert gb[1].lod() == wb[1].lod()


def test_dataset_dense_slot_takes_its_declared_shape(tmp_path):
    """A dense slot batch takes its ``use_var``'s declared shape, -1 for
    the batch (data_feed.cc); the reference stacks [batch, count]."""
    path = _multislot_file(tmp_path)
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="ms_x", shape=[2, 1], dtype="float32")
    want = list(_dataset(jdataset, path, [], [True, False])._iter_batches())
    got = list(_dataset(tdataset, path, [x], [True, False])._iter_batches())
    for gb, wb in zip(got, want):
        assert gb[0].shape == (len(wb[0]), 2, 1)
        np.testing.assert_array_equal(gb[0].reshape(wb[0].shape), wb[0])


def test_in_memory_dataset_local_shuffle_matches_reference(tmp_path):
    path = _multislot_file(tmp_path)
    out = []
    for mod in (jdataset, tdataset):
        ds = _dataset(mod, path, [], [True, False], "InMemoryDataset", 1)
        ds.load_into_memory()
        random.seed(11)
        ds.local_shuffle()
        out.append([_np(b[0]).tolist() for b in ds._iter_batches()])
        assert ds.get_memory_data_size() == 3
    assert out[0] == out[1]


def test_queue_dataset_refuses_shuffle_as_reference():
    for mod in (jdataset, tdataset):
        ds = mod.QueueDataset()
        with pytest.raises(NotImplementedError):
            ds.local_shuffle()


def test_data_feed_desc_matches_reference(tmp_path):
    path = str(tmp_path / "data.proto")
    with open(path, "w") as f:
        f.write('name: "MultiSlotDataFeed"\nbatch_size: 2\n'
                'multi_slot_desc {\n'
                '  slots { name: "words" type: "uint64" is_dense: false '
                'is_used: false }\n'
                '  slots { name: "label" type: "float" is_dense: false '
                'is_used: false shape: 1 }\n}\n')
    t, j = TDataFeedDesc(path), JDataFeedDesc(path)
    for d in (t, j):
        d.set_batch_size(8)
        d.set_use_slots(["words"])
        d.set_dense_slots(["label"])
    assert t.desc() == j.desc()
    assert t.batch_size == 8 and t.slots[0].is_used and t.slots[1].is_dense
