"""ctypes bindings for the native C++ host library (port of
``paddle_tpu/fluid/native.py``; the sources are copies of the
reference's ``csrc/paddle_tpu_native.cpp`` and ``csrc/rpc.cpp``, kept in
``paddle_tpu_torch/csrc/native/``).

The library is compiled with ``g++`` at first use into
``paddle_tpu_torch/_build/`` (rebuilt when a source is newer). Its
components and their reference counterparts:

- ``serialize_tensor``/``deserialize_tensor`` — the LoDTensor stream
  format (framework/tensor_util.cc TensorToStream), byte-identical to the
  Python codec in ``ops/io_ops.py``.
- ``BlockingQueue`` — operators/reader/lod_tensor_blocking_queue.h;
  blocking push/pop release the GIL (ctypes), so DataLoader producer
  threads overlap with compute.
- ``MultiSlotFile`` — framework/data_feed.cc MultiSlotDataFeed text
  parser.
- ``RpcServer``/``RpcClient`` — the host transport of
  ``InMemoryDataset.global_shuffle`` across a fleet.
"""

import ctypes
import os
import random
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_HERE)
_CSRC = os.path.join(_PKG, "csrc", "native")
_SO = os.path.join(_PKG, "_build", "libpaddle_tpu_torch_native.so")

_lib = None
_lib_lock = threading.Lock()
_compile_error = None


def _sources():
    return sorted(
        os.path.join(_CSRC, f)
        for f in os.listdir(_CSRC)
        if f.endswith(".cpp")
    )


def _compile():
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    # compile to a per-pid temp file and rename: concurrent worker processes
    # must never CDLL a half-written library
    tmp = "%s.%d.tmp" % (_SO, os.getpid())
    cmd = [
        "g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread",
        *_sources(), "-o", tmp,
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, _SO)


def _load():
    global _lib, _compile_error
    with _lib_lock:
        if _lib is not None or _compile_error is not None:
            return _lib
        try:
            src_mtime = max(os.path.getmtime(s) for s in _sources())
            if (
                not os.path.exists(_SO)
                or os.path.getmtime(_SO) < src_mtime
            ):
                _compile()
            lib = ctypes.CDLL(_SO)
        except Exception as e:  # no g++ / compile failure -> Python fallback
            _compile_error = e
            return None
        c = ctypes.c_void_p
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u64 = ctypes.c_uint64
        u64p = ctypes.POINTER(u64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.pt_free.argtypes = [c]
        lib.pt_queue_create.restype = c
        lib.pt_queue_create.argtypes = [u64]
        lib.pt_queue_push.argtypes = [c, u8p, u64, ctypes.c_int]
        lib.pt_queue_pop.argtypes = [
            c, ctypes.POINTER(u8p), u64p, ctypes.c_int
        ]
        lib.pt_queue_close.argtypes = [c]
        lib.pt_queue_size.restype = u64
        lib.pt_queue_size.argtypes = [c]
        lib.pt_queue_destroy.argtypes = [c]
        lib.pt_tensor_serialize.argtypes = [
            ctypes.c_int, ctypes.c_int, i64p, u8p, u64, ctypes.c_int,
            u64p, u64p, ctypes.POINTER(u8p), u64p,
        ]
        lib.pt_tensor_read.restype = c
        lib.pt_tensor_read.argtypes = [u8p, u64]
        lib.pt_tensor_dtype.argtypes = [c]
        lib.pt_tensor_ndim.argtypes = [c]
        lib.pt_tensor_dims.restype = i64p
        lib.pt_tensor_dims.argtypes = [c]
        lib.pt_tensor_data.restype = u8p
        lib.pt_tensor_data.argtypes = [c]
        lib.pt_tensor_nbytes.restype = u64
        lib.pt_tensor_nbytes.argtypes = [c]
        lib.pt_tensor_consumed.restype = u64
        lib.pt_tensor_consumed.argtypes = [c]
        lib.pt_tensor_lod_levels.argtypes = [c]
        lib.pt_tensor_lod_level_len.restype = u64
        lib.pt_tensor_lod_level_len.argtypes = [c, ctypes.c_int]
        lib.pt_tensor_lod_level.restype = u64p
        lib.pt_tensor_lod_level.argtypes = [c, ctypes.c_int]
        lib.pt_tensor_destroy.argtypes = [c]
        lib.pt_multislot_parse.restype = c
        lib.pt_multislot_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
        ]
        lib.pt_ms_num_lines.restype = u64
        lib.pt_ms_num_lines.argtypes = [c]
        lib.pt_ms_offsets.restype = u64p
        lib.pt_ms_offsets.argtypes = [c, ctypes.c_int]
        lib.pt_ms_ints.restype = i64p
        lib.pt_ms_ints.argtypes = [c, ctypes.c_int]
        lib.pt_ms_floats.restype = ctypes.POINTER(ctypes.c_float)
        lib.pt_ms_floats.argtypes = [c, ctypes.c_int]
        lib.pt_ms_total.restype = u64
        lib.pt_ms_total.argtypes = [c, ctypes.c_int]
        lib.pt_ms_destroy.argtypes = [c]
        # RPC transport (rpc.cpp)
        u32 = ctypes.c_uint32
        u32p = ctypes.POINTER(u32)
        lib.pt_rpc_server_create.restype = c
        lib.pt_rpc_server_create.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int
        ]
        lib.pt_rpc_server_port.restype = ctypes.c_int
        lib.pt_rpc_server_port.argtypes = [c]
        lib.pt_rpc_server_wait_sends.argtypes = [c, ctypes.c_int]
        lib.pt_rpc_server_begin_serve.argtypes = [c]
        lib.pt_rpc_server_end_step.argtypes = [c, ctypes.c_int]
        lib.pt_rpc_server_get_recv.argtypes = [
            c, ctypes.c_char_p, ctypes.POINTER(u8p), u64p
        ]
        lib.pt_rpc_server_put_param.argtypes = [c, ctypes.c_char_p, u8p, u64]
        lib.pt_rpc_server_pop_send.argtypes = [
            c, ctypes.c_char_p, ctypes.c_int, u32p, ctypes.POINTER(u8p),
            u64p, ctypes.c_int,
        ]
        lib.pt_rpc_server_n_complete.restype = ctypes.c_int
        lib.pt_rpc_server_n_complete.argtypes = [c]
        lib.pt_rpc_server_destroy.argtypes = [c]
        lib.pt_rpc_connect.restype = c
        lib.pt_rpc_connect.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int
        ]
        lib.pt_rpc_send_var.argtypes = [c, u32, u64, ctypes.c_char_p, u8p, u64]
        lib.pt_rpc_get_var.argtypes = [
            c, u32, ctypes.c_char_p, ctypes.POINTER(u8p), u64p
        ]
        lib.pt_rpc_send_barrier.argtypes = [c, u32, u64]
        lib.pt_rpc_fetch_barrier.argtypes = [c, u32, u64]
        lib.pt_rpc_complete.argtypes = [c, u32, u64]
        lib.pt_rpc_close.argtypes = [c]
        lib.pt_rpc_server_put_table.argtypes = [
            c, ctypes.c_char_p, u8p, u64, u64
        ]
        lib.pt_rpc_server_pop_notify.argtypes = [c, ctypes.c_char_p, ctypes.c_int]
        lib.pt_rpc_server_worker_idle_ms.argtypes = [c, i64p]
        lib.pt_rpc_prefetch.argtypes = [
            c, u32, ctypes.c_char_p, u8p, u64, ctypes.POINTER(u8p), u64p
        ]
        lib.pt_rpc_checkpoint_notify.argtypes = [c, u32, u64, ctypes.c_char_p]
        lib.pt_rpc_set_deadline.argtypes = [c, ctypes.c_int]
        _lib = lib
        return _lib


def available():
    return _load() is not None


# ---------------------------------------------------------------------------
# tensor stream serialization
# ---------------------------------------------------------------------------
_NP_TO_ENUM = {
    np.dtype(np.bool_): 0, np.dtype(np.int16): 1, np.dtype(np.int32): 2,
    np.dtype(np.int64): 3, np.dtype(np.float16): 4, np.dtype(np.float32): 5,
    np.dtype(np.float64): 6, np.dtype(np.uint8): 20, np.dtype(np.int8): 21,
}
_ENUM_TO_NP = {v: k for k, v in _NP_TO_ENUM.items()}


def serialize_tensor(arr, lod=None):
    """numpy array (+ LoD offsets) -> reference tensor-stream bytes."""
    lib = _load()
    # note: np.ascontiguousarray would promote 0-d to 1-d; asarray keeps rank
    arr = np.asarray(arr, order="C")
    lod = lod or []
    dims = (ctypes.c_int64 * arr.ndim)(*arr.shape)
    flat = []
    lens = []
    for level in lod:
        lens.append(len(level))
        flat.extend(int(x) for x in level)
    lens_arr = (ctypes.c_uint64 * max(len(lens), 1))(*(lens or [0]))
    flat_arr = (ctypes.c_uint64 * max(len(flat), 1))(*(flat or [0]))
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_uint64()
    data = arr.tobytes()
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    rc = lib.pt_tensor_serialize(
        _NP_TO_ENUM[arr.dtype], arr.ndim, dims, buf, len(data),
        len(lod), lens_arr, flat_arr, ctypes.byref(out),
        ctypes.byref(out_len),
    )
    if rc != 0:
        raise RuntimeError("pt_tensor_serialize failed (%d)" % rc)
    try:
        return ctypes.string_at(out, out_len.value)
    finally:
        lib.pt_free(out)


def deserialize_tensor(buf, pos=0):
    """bytes -> (numpy array, lod list, bytes consumed)."""
    lib = _load()
    # zero-copy view at offset: c_char_p exposes the bytes object's own
    # buffer (read-only use; `buf` outlives the call)
    base = ctypes.cast(ctypes.c_char_p(buf), ctypes.c_void_p).value
    ptr = ctypes.cast(
        ctypes.c_void_p(base + pos), ctypes.POINTER(ctypes.c_uint8)
    )
    h = lib.pt_tensor_read(ptr, len(buf) - pos)
    if not h:
        raise ValueError("malformed tensor stream")
    try:
        dt = _ENUM_TO_NP[lib.pt_tensor_dtype(h)]
        ndim = lib.pt_tensor_ndim(h)
        dims = [lib.pt_tensor_dims(h)[i] for i in range(ndim)]
        nbytes = lib.pt_tensor_nbytes(h)
        arr = np.frombuffer(
            ctypes.string_at(lib.pt_tensor_data(h), nbytes), dt
        ).reshape(dims).copy()
        lod = []
        for i in range(lib.pt_tensor_lod_levels(h)):
            ln = lib.pt_tensor_lod_level_len(h, i)
            p = lib.pt_tensor_lod_level(h, i)
            lod.append([int(p[j]) for j in range(ln)])
        return arr, lod, int(lib.pt_tensor_consumed(h))
    finally:
        lib.pt_tensor_destroy(h)


# ---------------------------------------------------------------------------
# blocking queue
# ---------------------------------------------------------------------------
class QueueClosed(Exception):
    pass


class BlockingQueue(object):
    """Bounded blocking byte-blob queue backed by the C++ implementation
    (reference: LoDTensorBlockingQueue). Blocking ops release the GIL."""

    def __init__(self, capacity):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable: %s"
                               % _compile_error)
        self._lib = lib
        self._h = lib.pt_queue_create(int(capacity))

    def push(self, data, timeout_ms=-1):
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        rc = self._lib.pt_queue_push(self._h, buf, len(data), timeout_ms)
        if rc == 2:
            raise QueueClosed()
        return rc == 0

    def pop(self, timeout_ms=-1):
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_uint64()
        rc = self._lib.pt_queue_pop(
            self._h, ctypes.byref(out), ctypes.byref(out_len), timeout_ms
        )
        if rc == 2:
            raise QueueClosed()
        if rc == 1:
            return None
        try:
            return ctypes.string_at(out, out_len.value)
        finally:
            self._lib.pt_free(out)

    def close(self):
        self._lib.pt_queue_close(self._h)

    def size(self):
        return int(self._lib.pt_queue_size(self._h))

    def __del__(self):
        try:
            if self._h:
                self._lib.pt_queue_close(self._h)
                self._lib.pt_queue_destroy(self._h)
                self._h = None
        except Exception:
            pass


# ---------------------------------------------------------------------------
# MultiSlot parser
# ---------------------------------------------------------------------------
class MultiSlotFile(object):
    """Parse a MultiSlot-format text file (reference data_feed.cc format:
    per line, per slot: count then values)."""

    def __init__(self, path, slot_is_float):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable: %s"
                               % _compile_error)
        self._lib = lib
        flags = (ctypes.c_int * len(slot_is_float))(
            *[1 if f else 0 for f in slot_is_float]
        )
        self._n_slots = len(slot_is_float)
        self._is_float = list(slot_is_float)
        self._h = lib.pt_multislot_parse(
            path.encode(), self._n_slots, flags
        )
        if not self._h:
            raise ValueError("failed to parse MultiSlot file %r" % path)

    @property
    def num_lines(self):
        return int(self._lib.pt_ms_num_lines(self._h))

    def slot(self, i):
        """-> (values ndarray, offsets ndarray[num_lines+1])."""
        n = self.num_lines
        offs = np.ctypeslib.as_array(
            self._lib.pt_ms_offsets(self._h, i), shape=(n + 1,)
        ).copy()
        total = int(self._lib.pt_ms_total(self._h, i))
        if self._is_float[i]:
            vals = np.ctypeslib.as_array(
                self._lib.pt_ms_floats(self._h, i), shape=(max(total, 1),)
            )[:total].copy()
        else:
            vals = np.ctypeslib.as_array(
                self._lib.pt_ms_ints(self._h, i), shape=(max(total, 1),)
            )[:total].copy()
        return vals, offs

    def __del__(self):
        try:
            if self._h:
                self._lib.pt_ms_destroy(self._h)
                self._h = None
        except Exception:
            pass


# ---------------------------------------------------------------------------
# RPC transport (pserver runtime)
# ---------------------------------------------------------------------------
class RpcServer(object):
    """Parameter-server transport endpoint (reference: RPCServer,
    operators/distributed/rpc_server.h; gRPC backend grpc/grpc_server.cc).
    Handles SEND/GET/barriers/COMPLETE; the optimize loop lives in Python
    (ops/distributed_ops.py listen_and_serv)."""

    def __init__(self, port, n_trainers, sync_mode=True):
        lib = _load()
        if lib is None:
            raise RuntimeError(
                "native library unavailable: %s" % _compile_error
            )
        self._lib = lib
        self._n_trainers = int(n_trainers)
        self._h = lib.pt_rpc_server_create(
            int(port), int(n_trainers), 1 if sync_mode else 0
        )
        if not self._h:
            raise RuntimeError("failed to bind rpc server on port %s" % port)

    @property
    def port(self):
        return int(self._lib.pt_rpc_server_port(self._h))

    def wait_sends(self, timeout_ms=-1):
        """0 = batch ready, 1 = timeout, 3 = all trainers complete."""
        return int(self._lib.pt_rpc_server_wait_sends(self._h, timeout_ms))

    def begin_serve(self):
        self._lib.pt_rpc_server_begin_serve(self._h)

    def end_step(self, timeout_ms=-1):
        return int(self._lib.pt_rpc_server_end_step(self._h, timeout_ms))

    def get_recv(self, name):
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_uint64()
        rc = self._lib.pt_rpc_server_get_recv(
            self._h, name.encode(), ctypes.byref(out), ctypes.byref(out_len)
        )
        if rc != 0:
            return None
        try:
            return ctypes.string_at(out, out_len.value)
        finally:
            self._lib.pt_free(out)

    def put_param(self, name, data):
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        self._lib.pt_rpc_server_put_param(
            self._h, name.encode(), buf, len(data)
        )

    def pop_send(self, timeout_ms=-1):
        """Async mode: -> (name, trainer_id, payload) | "timeout" | None
        (None = all trainers complete and queue drained)."""
        name_buf = ctypes.create_string_buffer(64 << 10)
        trainer = ctypes.c_uint32()
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_uint64()
        rc = self._lib.pt_rpc_server_pop_send(
            self._h, name_buf, len(name_buf), ctypes.byref(trainer),
            ctypes.byref(out), ctypes.byref(out_len), timeout_ms,
        )
        if rc == 1:
            return "timeout"
        if rc == 3:
            return None
        try:
            return (
                name_buf.value.decode(),
                int(trainer.value),
                ctypes.string_at(out, out_len.value),
            )
        finally:
            self._lib.pt_free(out)

    def put_table(self, name, arr):
        """Serve ``arr``'s rows to kPrefetch requests (sparse lookup).
        One copy total: C++ stages from the array's buffer outside the
        server lock, then swaps it in (`arr` keeps the buffer alive)."""
        arr = np.ascontiguousarray(arr)
        row_bytes = arr.strides[0] if arr.ndim > 0 else arr.itemsize
        ptr = arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        self._lib.pt_rpc_server_put_table(
            self._h, name.encode(), ptr, arr.nbytes, row_bytes
        )

    def pop_notify(self):
        """-> checkpoint directory string or None."""
        buf = ctypes.create_string_buffer(4096)
        rc = self._lib.pt_rpc_server_pop_notify(self._h, buf, len(buf))
        if rc < 0:
            # name didn't fit: -rc is the required capacity (incl. NUL)
            buf = ctypes.create_string_buffer(-rc)
            rc = self._lib.pt_rpc_server_pop_notify(self._h, buf, len(buf))
        return buf.value.decode() if rc == 0 else None

    def worker_idle_ms(self):
        """-> list of per-trainer ms since last request (-1 = never)."""
        n = getattr(self, "_n_trainers", None)
        if n is None:
            return []
        arr = (ctypes.c_int64 * n)()
        self._lib.pt_rpc_server_worker_idle_ms(self._h, arr)
        return list(arr)

    def n_complete(self):
        return int(self._lib.pt_rpc_server_n_complete(self._h))

    def shutdown(self):
        if self._h:
            self._lib.pt_rpc_server_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.shutdown()
        except Exception:
            pass


class RpcClient(object):
    """Trainer-side connection to one pserver endpoint (reference:
    RPCClient, operators/distributed/rpc_client.h / grpc/grpc_client.cc)."""

    def __init__(self, endpoint, trainer_id=0, timeout_ms=None):
        lib = _load()
        if lib is None:
            raise RuntimeError(
                "native library unavailable: %s" % _compile_error
            )
        self._lib = lib
        host, port = endpoint.rsplit(":", 1)
        if host in ("localhost", ""):
            host = "127.0.0.1"
        self.endpoint = endpoint
        self.trainer_id = int(trainer_id)
        # FLAGS rpc_deadline / rpc_retry_times (reference:
        # python/paddle/fluid/__init__.py:187 whitelists both; grpc client
        # honors them per call) — env-bridged via fluid.flags
        from . import flags as _flags

        self._deadline_ms = int(
            timeout_ms
            if timeout_ms is not None
            else _flags.get_flag("rpc_deadline", 180000)
        )
        self._retry_times = int(_flags.get_flag("rpc_retry_times", 3))
        self._host, self._port = host, int(port)
        # serializes every call AND reconnection on this shared client
        # (clients are cached per (endpoint, trainer_id) and used from the
        # communicator's background threads concurrently)
        self._call_lock = threading.Lock()
        # per-logical-operation sequence ids for server-side retry dedup.
        # The server dedups by EXACT match in a bounded window, so all that
        # matters is uniqueness: seed randomly (safe across trainer
        # restarts — no wall-clock monotonicity assumption) and increment.
        self._seq_lock = threading.Lock()
        self._next_seq = random.getrandbits(63) | 1
        self._h = lib.pt_rpc_connect(
            host.encode(), int(port), self._deadline_ms
        )
        if not self._h:
            raise ConnectionError(
                "cannot connect to pserver at %s" % endpoint
            )
        lib.pt_rpc_set_deadline(self._h, self._deadline_ms)

    def _reconnect(self):
        try:
            if self._h:
                self._lib.pt_rpc_close(self._h)
        except Exception:
            pass
        self._h = self._lib.pt_rpc_connect(
            self._host.encode(), self._port, self._deadline_ms
        )
        if self._h:
            self._lib.pt_rpc_set_deadline(self._h, self._deadline_ms)
        return bool(self._h)

    def _new_seq(self):
        with self._seq_lock:
            self._next_seq += 1
            return self._next_seq

    def _with_retry(self, fn, what):
        """FLAGS_rpc_retry_times semantics: a deadline/io failure (-1)
        reconnects (which also resyncs the request/response stream) and
        retries; other statuses surface immediately. Retrying a MUTATING op
        after an ambiguous rc=-1 (request applied, response lost to the
        deadline) is safe because ``fn`` re-sends the same per-operation seq
        and the server dedups it (rpc.cpp handle_conn seq_windows)."""
        last_rc = -1
        with self._call_lock:
            for attempt in range(self._retry_times + 1):
                if not self._h and not self._reconnect():
                    continue
                rc = fn()
                if rc != -1:
                    return rc
                last_rc = rc
                self._reconnect()
        raise ConnectionError(
            "%s failed after %d retries (rpc_deadline=%dms) -> rc %d"
            % (what, self._retry_times, self._deadline_ms, last_rc)
        )

    def send_var(self, name, payload):
        buf = (ctypes.c_uint8 * len(payload)).from_buffer_copy(payload)
        seq = self._new_seq()
        rc = self._with_retry(
            lambda: self._lib.pt_rpc_send_var(
                self._h, self.trainer_id, seq, name.encode(), buf, len(payload)
            ),
            "send_var(%s)" % name,
        )
        if rc != 0:
            raise ConnectionError("send_var(%s) -> rc %d" % (name, rc))

    def get_var(self, name):
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_uint64()

        def call():
            return self._lib.pt_rpc_get_var(
                self._h, self.trainer_id, name.encode(), ctypes.byref(out),
                ctypes.byref(out_len),
            )

        rc = self._with_retry(call, "get_var(%s)" % name)
        if rc != 0:
            if bool(out):
                self._lib.pt_free(out)
            raise ConnectionError("get_var(%s) -> rc %d" % (name, rc))
        try:
            return ctypes.string_at(out, out_len.value)
        finally:
            self._lib.pt_free(out)

    def prefetch(self, table, ids):
        """Fetch table rows by LOCAL row id (kPrefetch; reference:
        parameter_prefetch.cc). ids: int64 array -> raw row bytes."""
        ids = np.ascontiguousarray(np.asarray(ids, np.int64))
        data = ids.tobytes()
        buf = (ctypes.c_uint8 * max(len(data), 1)).from_buffer_copy(
            data or b"\0"
        )
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_uint64()

        def call():
            return self._lib.pt_rpc_prefetch(
                self._h, self.trainer_id, table.encode(), buf, len(data),
                ctypes.byref(out), ctypes.byref(out_len),
            )

        rc = self._with_retry(call, "prefetch(%s)" % table)
        if rc != 0:
            if bool(out):
                self._lib.pt_free(out)
            raise ConnectionError("prefetch(%s) -> rc %d" % (table, rc))
        try:
            return ctypes.string_at(out, out_len.value)
        finally:
            self._lib.pt_free(out)

    def checkpoint_notify(self, dirname):
        seq = self._new_seq()
        rc = self._with_retry(
            lambda: self._lib.pt_rpc_checkpoint_notify(
                self._h, self.trainer_id, seq, dirname.encode()
            ),
            "checkpoint_notify",
        )
        if rc != 0:
            raise ConnectionError("checkpoint_notify -> rc %d" % rc)

    def send_barrier(self):
        seq = self._new_seq()
        rc = self._with_retry(
            lambda: self._lib.pt_rpc_send_barrier(self._h, self.trainer_id, seq),
            "send_barrier",
        )
        if rc != 0:
            raise ConnectionError("send_barrier -> rc %d" % rc)

    def fetch_barrier(self):
        seq = self._new_seq()
        rc = self._with_retry(
            lambda: self._lib.pt_rpc_fetch_barrier(self._h, self.trainer_id, seq),
            "fetch_barrier",
        )
        if rc != 0:
            raise ConnectionError("fetch_barrier -> rc %d" % rc)

    def complete(self):
        seq = self._new_seq()
        rc = self._with_retry(
            lambda: self._lib.pt_rpc_complete(self._h, self.trainer_id, seq),
            "complete",
        )
        if rc != 0:
            raise ConnectionError("complete -> rc %d" % rc)

    def close(self):
        with self._call_lock:
            if self._h:
                self._lib.pt_rpc_close(self._h)
                self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
