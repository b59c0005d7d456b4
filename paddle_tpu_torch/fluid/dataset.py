"""fluid.dataset — file-based training ingest (port of
``paddle_tpu/fluid/dataset.py``; reference: python/paddle/fluid/dataset.py
over C++ Dataset/DataFeed, framework/data_set.h:41-226,
data_feed.h:61-532 with distributed shuffle).

Datasets produce numpy batches on host threads; the trainer's
``io_pipeline.DeviceFeeder`` copies them to the card. MultiSlot files
parse through the native library (``native.MultiSlotFile``).
``InMemoryDataset.global_shuffle`` with a fleet re-routes samples over the
native RPC transport, as the reference's.

One difference from the reference, made on purpose: a dense slot batch
takes the shape its ``use_var`` declares (-1 for the batch), as Paddle's
MultiSlotDataFeed does (data_feed.cc, ``use_slots_shape_``), so a
[batch, T] slot feeds a var declared [-1, T, 1]. The reference stacks
[batch, count] and leaves it so."""

import random

import numpy as np

__all__ = ["DatasetFactory", "InMemoryDataset", "QueueDataset"]


class DatasetFactory(object):
    def create_dataset(self, datafeed_class="QueueDataset"):
        if datafeed_class == "InMemoryDataset":
            return InMemoryDataset()
        return QueueDataset()


class DatasetBase(object):
    def __init__(self):
        self.filelist = []
        self.use_var = []
        self.batch_size = 1
        self.thread_num = 1
        self.pipe_command = "cat"
        self._parse_fn = None
        self._rank = 0
        self._nranks = 1

    def set_batch_size(self, batch_size):
        self.batch_size = batch_size

    def set_thread(self, thread_num):
        self.thread_num = thread_num

    def set_filelist(self, filelist):
        self.filelist = list(filelist)

    def set_use_var(self, var_list):
        self.use_var = var_list

    def set_pipe_command(self, pipe_command):
        self.pipe_command = pipe_command

    def set_parse_fn(self, fn):
        """An extension: a python line-parser replacing the C++
        MultiSlotDataFeed proto parsing (data_feed.proto)."""
        self._parse_fn = fn

    def set_multislot(self, slot_is_float, dense_slots=None):
        """Parse files in the MultiSlot text format (reference:
        framework/data_feed.cc MultiSlotDataFeed — per line, per slot:
        count then values) with the native C++ parser.

        ``dense_slots``: per-slot bool; dense slots stack into one array,
        sparse slots always batch as LoDTensors. Default: inferred from the
        first parsed file (a slot with a uniform per-line count is dense) —
        the decision is then FIXED for the whole epoch so a slot's batch
        type never flips with batch content."""
        self._multislot = list(slot_is_float)
        self._dense_slots = list(dense_slots) if dense_slots else None

    def set_hdfs_config(self, fs_name, fs_ugi):
        self._hdfs = (fs_name, fs_ugi)

    def _default_parse(self, line):
        parts = line.strip().split()
        return [np.asarray([float(p)]) for p in parts]

    def _iter_samples(self):
        files = [
            f
            for i, f in enumerate(self.filelist)
            if i % self._nranks == self._rank
        ]
        if getattr(self, "_multislot", None) is not None:
            yield from self._iter_multislot(files)
            return
        parse = self._parse_fn or self._default_parse
        for path in files:
            with open(path, "r") as f:
                for line in f:
                    yield parse(line)

    def _iter_multislot(self, files):
        from . import native

        for path in files:
            ms = native.MultiSlotFile(path, self._multislot)
            slots = [ms.slot(i) for i in range(len(self._multislot))]
            if self._dense_slots is None:
                # reference semantics: sparse id (int) slots are ALWAYS LoD;
                # float slots are dense when the first file is uniform.
                # Pass dense_slots explicitly to override (recommended under
                # SPMD, where ranks parse different files).
                self._dense_slots = [
                    bool(
                        self._multislot[i]
                        and len(set(np.diff(offs))) <= 1
                    )
                    for i, (_, offs) in enumerate(slots)
                ]
            for line in range(ms.num_lines):
                yield [
                    vals[offs[line]:offs[line + 1]]
                    for vals, offs in slots
                ]

    def _iter_batches(self):
        slots = None
        count = 0
        for sample in self._iter_samples():
            if slots is None:
                slots = [[] for _ in sample]
            for i, field in enumerate(sample):
                slots[i].append(field)
            count += 1
            if count == self.batch_size:
                yield self._stack_batch(slots)
                slots, count = None, 0
        if slots and count:
            yield self._stack_batch(slots)

    def _stack_batch(self, slots):
        dense = getattr(self, "_dense_slots", None)
        out = [
            _stack_slot(s, None if dense is None else dense[i])
            for i, s in enumerate(slots)
        ]
        return [_declared_shape(a, self.use_var[i] if i < len(
            self.use_var) else None) for i, a in enumerate(out)]


def _declared_shape(arr, var):
    """A dense slot batch in its var's declared shape (-1 takes the
    batch), when the element counts agree; else as it is."""
    shape = getattr(var, "shape", None)
    if not isinstance(arr, np.ndarray) or not shape:
        return arr
    want = [arr.shape[0] if d == -1 else int(d) for d in shape]
    if list(arr.shape) == want or int(np.prod(want)) != arr.size:
        return arr
    return arr.reshape(want)


def _stack_slot(fields, dense=None):
    """Batch one slot: dense slots stack into one array; sparse slots become
    LoDTensors — concatenated values with sequence lengths (reference:
    MultiSlotDataFeed emitting LoD slots). ``dense=None`` decides from this
    batch's content (generic parse_fn path)."""
    if dense is None:
        lens = {np.asarray(f).shape[:1] for f in fields}
        dense = len(lens) <= 1
    if dense:
        lens = {np.asarray(f).shape[:1] for f in fields}
        if len(lens) > 1:
            raise ValueError(
                "slot declared dense but has variable per-line counts; "
                "pass dense_slots=[...] to set_multislot to mark it sparse"
            )
        return np.asarray(fields)
    from . import core

    flat = np.concatenate([np.asarray(f).ravel() for f in fields])
    t = core.LoDTensor(flat.reshape(-1, 1))
    t.set_recursive_sequence_lengths(
        [[int(np.asarray(f).size) for f in fields]]
    )
    return t


class QueueDataset(DatasetBase):
    """Streaming dataset (reference: data_feed.h MultiSlotDataFeed)."""

    def local_shuffle(self):
        raise NotImplementedError(
            "QueueDataset streams; use InMemoryDataset for shuffle"
        )

    def global_shuffle(self, fleet=None):
        raise NotImplementedError(
            "QueueDataset streams; use InMemoryDataset for shuffle"
        )


class InMemoryDataset(DatasetBase):
    """Loaded-then-shuffled dataset (reference: data_set.h InMemoryDataset,
    load_into_memory/local_shuffle/global_shuffle)."""

    def __init__(self):
        super().__init__()
        self._samples = []
        self._loaded = False

    def load_into_memory(self):
        self._samples = list(super()._iter_samples())
        self._loaded = True

    def local_shuffle(self):
        random.shuffle(self._samples)

    def global_shuffle(self, fleet=None, thread_num=12):
        """Fleet-coordinated SAMPLE shuffle (reference: data_set.h:226
        MultiSlotDataset::GlobalShuffle — every in-memory sample is re-routed
        to a random worker, so the global sample multiset is re-partitioned,
        not merely the file assignment).

        Without a fleet (single worker) this degrades to local_shuffle.
        With a fleet: all-to-all over the native RPC transport — each
        worker hashes every sample to a destination worker (shared seed, so
        all workers agree), pushes the per-destination batches to its
        peers' shuffle servers, and keeps what lands on it."""
        if fleet is None or fleet.worker_num() <= 1:
            rng = random.Random(len(self.filelist))
            rng.shuffle(self.filelist)
            if self._loaded:
                self.load_into_memory()
            self.local_shuffle()
            return
        import pickle

        from . import native

        rank = fleet.worker_index()
        n = fleet.worker_num()
        endpoints = fleet.worker_endpoints()
        seed = len(self.filelist) + 1013904223

        def shuffle_endpoint(ep):
            host, port = ep.rsplit(":", 1)
            return host, int(port) + 1317  # shuffle-service port offset

        _host, my_port = shuffle_endpoint(endpoints[rank])
        server = native.RpcServer(my_port, n, sync_mode=False)
        try:
            # per-SENDER random destinations (the reference GlobalShuffle
            # behavior): only the owner routes each sample, so no
            # cross-worker agreement is needed — and unlike content
            # hashing, duplicate samples spread out and the partition
            # re-randomizes every call
            rng = random.Random(seed * 1000003 + rank * 7919 + len(self._samples))
            buckets = [[] for _ in range(n)]
            for s in self._samples:
                buckets[rng.randrange(n)].append(s)
            for dst in range(n):
                if dst == rank:
                    continue
                host, port = shuffle_endpoint(endpoints[dst])
                client = native.RpcClient("%s:%d" % (host, port), rank)
                client.send_var(
                    "shuffle_samples",
                    pickle.dumps(buckets[dst], protocol=2),
                )
                client.close()
            mine = list(buckets[rank])
            received = 0
            while received < n - 1:
                item = server.pop_send(timeout_ms=120000)
                if item == "timeout" or item is None:
                    raise RuntimeError(
                        "global_shuffle: got %d/%d peer payloads"
                        % (received, n - 1)
                    )
                _name, _tid, payload = item
                mine.extend(pickle.loads(payload))
                received += 1
            self._samples = mine
            self._loaded = True
            self.local_shuffle()
        finally:
            server.shutdown()

    def release_memory(self):
        self._samples = []
        self._loaded = False

    def get_memory_data_size(self, fleet=None):
        return len(self._samples)

    def get_shuffle_data_size(self, fleet=None):
        return len(self._samples)

    def _iter_samples(self):
        if not self._loaded:
            self.load_into_memory()
        return iter(self._samples)
