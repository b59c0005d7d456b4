"""Runtime core: places, dtypes, Scope, LoDTensor (port of
``paddle_tpu/fluid/core.py``).

The port speaks ``torch.device``: the Fluid place classes are thin
spellings of the two devices, and ``resolve_device`` turns either form
into a ``torch.device``. The default is the card: a caller that wants
the CPU says so, and a machine without a GPU raises instead of quietly
running on the CPU. A Scope maps variable names to torch tensors, which
the Executor updates in place where an op writes a variable it reads
(optimizer state); a LoDTensor wraps one tensor with level-of-detail
offsets.
"""

import threading

import numpy as np
import torch

__all__ = [
    "VarDesc", "CPUPlace", "CUDAPlace", "resolve_device", "dtype_to_np",
    "dtype_to_torch", "np_to_dtype", "dtype_is_floating", "dtype_name",
    "LoDTensor", "Scope", "global_scope",
]


# ---------------------------------------------------------------------------
# dtype enum — the proto VarType.Type numbering, the serialization contract
# (reference: paddle/fluid/framework/framework.proto:105-137).
# ---------------------------------------------------------------------------
class VarDesc(object):
    class VarType(object):
        BOOL = 0
        INT16 = 1
        INT32 = 2
        INT64 = 3
        FP16 = 4
        FP32 = 5
        FP64 = 6
        LOD_TENSOR = 7
        SELECTED_ROWS = 8
        FEED_MINIBATCH = 9
        FETCH_LIST = 10
        STEP_SCOPES = 11
        LOD_RANK_TABLE = 12
        LOD_TENSOR_ARRAY = 13
        PLACE_LIST = 14
        READER = 15
        RAW = 17
        TUPLE = 18
        SIZE_T = 19
        UINT8 = 20
        INT8 = 21
        BF16 = 22


_T = VarDesc.VarType
_DTYPE_TO_TORCH = {
    _T.BOOL: torch.bool,
    _T.INT16: torch.int16,
    _T.INT32: torch.int32,
    _T.INT64: torch.int64,
    _T.FP16: torch.float16,
    _T.FP32: torch.float32,
    _T.FP64: torch.float64,
    _T.UINT8: torch.uint8,
    _T.INT8: torch.int8,
    _T.BF16: torch.bfloat16,
}
_TORCH_TO_DTYPE = {v: k for k, v in _DTYPE_TO_TORCH.items()}


def dtype_to_torch(dtype):
    """fluid dtype enum / numpy dtype / string / torch dtype -> torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if not isinstance(dtype, int):
        dtype = np_to_dtype(dtype)
    return _DTYPE_TO_TORCH[dtype]


def dtype_to_np(dtype):
    """fluid dtype enum (or string / np.dtype) -> numpy dtype (bf16 has
    none: it raises)."""
    t = dtype_to_torch(dtype)
    return torch.empty((), dtype=t).numpy().dtype


def np_to_dtype(np_dtype):
    """numpy dtype / string / torch dtype -> fluid dtype enum."""
    if isinstance(np_dtype, torch.dtype):
        return _TORCH_TO_DTYPE[np_dtype]
    if str(np_dtype) == "bfloat16":
        return _T.BF16
    t = torch.from_numpy(np.zeros((), dtype=np.dtype(np_dtype))).dtype
    return _TORCH_TO_DTYPE[t]


def convert_np_dtype_to_dtype_(np_dtype):
    return np_to_dtype(np_dtype)


def dtype_is_floating(dtype):
    if not isinstance(dtype, int):
        dtype = np_to_dtype(dtype)
    return dtype in (_T.FP16, _T.FP32, _T.FP64, _T.BF16)


def dtype_name(dtype):
    return str(dtype_to_torch(dtype)).replace("torch.", "")


# ---------------------------------------------------------------------------
# Places (reference: paddle/fluid/platform/place.h:26-58)
# ---------------------------------------------------------------------------
class CPUPlace(object):
    def __eq__(self, other):
        return isinstance(other, CPUPlace)

    def __hash__(self):
        return hash("cpu")

    def __repr__(self):
        return "CPUPlace"


class CUDAPlace(object):
    def __init__(self, device_id=0):
        self.device_id = int(device_id)

    def __eq__(self, other):
        return isinstance(other, CUDAPlace) and \
            other.device_id == self.device_id

    def __hash__(self):
        return hash(("cuda", self.device_id))

    def __repr__(self):
        return "CUDAPlace(%d)" % self.device_id


def resolve_device(place_or_device=None):
    """``None`` / ``CUDAPlace(i)`` / ``CPUPlace()`` / ``"cpu"`` /
    ``"cuda:1"`` / ``torch.device`` -> ``torch.device``.

    ``None`` means ``cuda``. Asking for a CUDA device on a machine
    without one raises ``RuntimeError``; there is no CPU fallback."""
    p = place_or_device
    if p is None:
        dev = torch.device("cuda")
    elif isinstance(p, CPUPlace):
        dev = torch.device("cpu")
    elif isinstance(p, CUDAPlace):
        dev = torch.device("cuda", p.device_id)
    else:
        dev = torch.device(p)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU"
        )
    return dev


# ---------------------------------------------------------------------------
# LoDTensor — dense storage + level-of-detail offsets
# (reference: paddle/fluid/framework/lod_tensor.h:52 LoD, :104 LoDTensor).
# ---------------------------------------------------------------------------
class LoDTensor(object):
    """One torch tensor with ragged-batch offsets. ``set`` takes a numpy
    array or a tensor (and a place to put it on); ``numpy()`` reads it
    back to the host."""

    def __init__(self, array=None, lod=None, place=None):
        self._tensor = None
        self._lod = [list(level) for level in (lod or [])]
        if array is not None:
            self.set(array, place)

    def set(self, array, place=None):
        t = torch.as_tensor(np.asarray(array) if not isinstance(
            array, torch.Tensor) else array)
        if place is not None:
            t = t.to(resolve_device(place))
        self._tensor = t

    def tensor(self):
        return self._tensor

    def set_lod(self, lod):
        self._lod = [list(level) for level in lod]

    def lod(self):
        return [list(level) for level in self._lod]

    def set_recursive_sequence_lengths(self, lengths):
        self._lod = [_lengths_to_offsets(level) for level in lengths]

    def recursive_sequence_lengths(self):
        return [_offsets_to_lengths(level) for level in self._lod]

    def has_valid_recursive_sequence_lengths(self):
        if not self._lod:
            return True
        try:
            n = self._lod[-1][-1]
        except IndexError:
            return False
        return self._tensor is None or n == self._tensor.shape[0]

    def shape(self):
        return list(self._tensor.shape) if self._tensor is not None else []

    def numpy(self):
        return self._tensor.detach().cpu().numpy()

    def __array__(self, dtype=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def __repr__(self):
        return "LoDTensor(shape=%s, lod=%s)" % (self.shape(), self._lod)


def _lengths_to_offsets(lengths):
    out = [0]
    for n in lengths:
        out.append(out[-1] + int(n))
    return out


def _offsets_to_lengths(offsets):
    return [int(offsets[i + 1] - offsets[i]) for i in range(len(offsets) - 1)]


# ---------------------------------------------------------------------------
# Scope — hierarchical name -> value map (reference: framework/scope.h:46)
# ---------------------------------------------------------------------------
class _ScopeVar(object):
    __slots__ = ("name", "value")

    def __init__(self, name, value=None):
        self.name = name
        self.value = value  # torch.Tensor | LoDTensor | python object

    def get_tensor(self):
        """The value as a LoDTensor sharing its tensor (written through:
        the scope variable then holds the wrapper)."""
        if isinstance(self.value, LoDTensor):
            return self.value
        t = LoDTensor()
        t._tensor = self.value
        self.value = t
        return t

    def set_value(self, value):
        self.value = value


class Scope(object):
    """Name -> value. Values are torch tensors on the executor's device;
    ``get`` unwraps a LoDTensor to its tensor. The executor keeps its
    random generators here (``rng``), one set per scope and device."""

    def __init__(self, parent=None):
        self._vars = {}
        self._parent = parent
        self._kids = []
        self._lock = threading.Lock()
        self._rngs = {}

    def var(self, name):
        with self._lock:
            if name not in self._vars:
                self._vars[name] = _ScopeVar(name)
            return self._vars[name]

    def find_var(self, name):
        s = self
        while s is not None:
            v = s._vars.get(name)
            if v is not None:
                return v
            s = s._parent
        return None

    def erase(self, names):
        with self._lock:
            for n in names:
                self._vars.pop(n, None)

    def new_scope(self):
        kid = Scope(parent=self)
        self._kids.append(kid)
        return kid

    def drop_kids(self):
        self._kids = []

    def local_var_names(self):
        return list(self._vars)

    def get(self, name, default=None):
        v = self.find_var(name)
        if v is None or v.value is None:
            return default
        return v.value.tensor() if isinstance(v.value, LoDTensor) else v.value

    def set(self, name, value):
        self.var(name).set_value(value)

    def has(self, name):
        return self.find_var(name) is not None

    def rng(self, device, seed=0):
        """(device generator, CPU generator) of this scope for ``device``,
        made at first use from ``seed``: random ops on the device draw
        from the first, host-side draws (the flash kernels' integer
        dropout seeds) from the second, so no draw waits on the card."""
        key = str(device)
        with self._lock:
            pair = self._rngs.get(key)
            if pair is None:
                pair = (torch.Generator(device=device).manual_seed(int(seed)),
                        torch.Generator().manual_seed(int(seed) + 1))
                self._rngs[key] = pair
            return pair

    def rng_states(self):
        """{device key: (device generator state, CPU generator state)}
        of every generator pair this scope made (ByteTensors)."""
        with self._lock:
            return {k: (dev.get_state(), cpu.get_state())
                    for k, (dev, cpu) in self._rngs.items()}

    def set_rng_states(self, states):
        """Set the generator pairs from ``rng_states()``'s form, making a
        pair where the scope has none; a device this machine lacks is
        skipped."""
        for key, (dev_state, cpu_state) in states.items():
            device = torch.device(key)
            if device.type == "cuda" and not torch.cuda.is_available():
                continue
            dev, cpu = self.rng(device)
            dev.set_state(dev_state)
            cpu.set_state(cpu_state)


_global_scope = Scope()


def global_scope():
    return _global_scope


def _switch_scope(scope):
    global _global_scope
    old = _global_scope
    _global_scope = scope
    return old
