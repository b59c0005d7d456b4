"""Host-side save/load ops and the reference's binary tensor stream (port
of ``paddle_tpu/fluid/ops/io_ops.py``).

Serialization as Paddle's framework/tensor_util.cc TensorToStream /
TensorFromStream:

    LoDTensor stream := uint32 version(0)
                        uint64 lod_level
                        { uint64 nbytes, size_t[] offsets } * lod_level
                        uint32 version(0)
                        int32  desc_size
                        VarType.TensorDesc proto (data_type=1, dims=2 packed)
                        raw tensor bytes

The bytes written are the reference's bytes. numpy has no bf16, so a
bf16 tensor travels through its bits (``view(torch.int16)``) under the
dtype value BF16 = 22, and reads back as a bf16 tensor. The reference's
optional native codec (``fluid/native.py``) is not carried over: the
Python codec is the format.

The ops run on the host inside ``Executor.run``: ``save`` and
``save_combine`` read their variables from the run (a LoDTensor held in
the scope keeps its offsets), ``load`` and ``load_combine`` put what they
read on the Executor's device, where the run's write-back stores it in
the scope. ``feed`` and ``fetch`` are no-ops: feeds enter a run by name
and fetches leave it by name, so a pruned inference program's feed and
fetch ops only record the names.
"""

import os
import struct

import numpy as np
import torch

from .. import core
from .registry import SkipInferShape, register_op

__all__ = ["serialize_lod_tensor", "deserialize_lod_tensor",
           "lod_tensor_stream_parts"]

_VT = core.VarDesc.VarType
_TORCH_TO_PROTO = {
    torch.bool: _VT.BOOL,
    torch.int16: _VT.INT16,
    torch.int32: _VT.INT32,
    torch.int64: _VT.INT64,
    torch.float16: _VT.FP16,
    torch.float32: _VT.FP32,
    torch.float64: _VT.FP64,
    torch.uint8: _VT.UINT8,
    torch.int8: _VT.INT8,
    torch.bfloat16: _VT.BF16,
}
_PROTO_TO_TORCH = {v: k for k, v in _TORCH_TO_PROTO.items()}


def _encode_varint(value):
    out = b""
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out += bytes([bits | 0x80])
        else:
            out += bytes([bits])
            return out


def _decode_varint(buf, pos):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def _tensor_desc_bytes(t):
    """VarType.TensorDesc{ data_type=1 (enum), dims=2 (packed int64) }."""
    out = bytes([0x08]) + _encode_varint(_TORCH_TO_PROTO[t.dtype])
    dims_payload = b"".join(_encode_varint(int(d)) for d in t.shape)
    out += bytes([0x12]) + _encode_varint(len(dims_payload)) + dims_payload
    return out


def _parse_tensor_desc(buf):
    pos = 0
    dtype_enum = None
    dims = []
    while pos < len(buf):
        tag, pos = _decode_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 0:
            dtype_enum, pos = _decode_varint(buf, pos)
        elif field == 2 and wire == 2:
            ln, pos = _decode_varint(buf, pos)
            end = pos + ln
            while pos < end:
                d, pos = _decode_varint(buf, pos)
                dims.append(d)
        elif field == 2 and wire == 0:  # unpacked
            d, pos = _decode_varint(buf, pos)
            dims.append(d)
        else:
            raise ValueError("unexpected TensorDesc field %d" % field)
    if dtype_enum not in _PROTO_TO_TORCH:
        raise ValueError("unsupported tensor data_type %r" % dtype_enum)
    return _PROTO_TO_TORCH[dtype_enum], dims


def _host_tensor(value):
    """(contiguous CPU tensor, lod) of a LoDTensor / tensor / array."""
    lod = []
    if isinstance(value, core.LoDTensor):
        lod = value.lod()
        value = value.tensor()
    if not isinstance(value, torch.Tensor):
        value = torch.from_numpy(np.ascontiguousarray(np.asarray(value)))
    return value.detach().cpu().contiguous(), lod


def _raw_view(t):
    """The tensor's bytes as a flat uint8 array sharing its memory."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().reshape(-1).view(np.uint8)


def lod_tensor_stream_parts(value):
    """(header bytes, raw data as a uint8 array sharing the host tensor's
    memory) of a LoDTensor, tensor or numpy array: the stream is their
    concatenation, which a writer can put down without joining them."""
    t, lod = _host_tensor(value)
    out = struct.pack("<I", 0)  # version
    out += struct.pack("<Q", len(lod))
    for level in lod:
        level_arr = np.asarray(level, np.uint64)
        out += struct.pack("<Q", level_arr.nbytes)
        out += level_arr.tobytes()
    out += struct.pack("<I", 0)  # tensor version
    desc = _tensor_desc_bytes(t)
    out += struct.pack("<i", len(desc))
    out += desc
    return out, _raw_view(t)


def serialize_lod_tensor(value):
    """The stream bytes of a LoDTensor, tensor or numpy array."""
    header, raw = lod_tensor_stream_parts(value)
    return header + raw.tobytes()


def deserialize_lod_tensor(buf, pos=0, copy=True):
    """(LoDTensor on the CPU, position after it) read from ``buf`` at
    ``pos``; a bf16 stream gives a bf16 tensor. ``copy=False`` shares a
    writable ``buf``'s memory (a ``bytearray``) instead of copying."""
    (version,) = struct.unpack_from("<I", buf, pos)
    pos += 4
    if version != 0:
        raise ValueError("unsupported tensor stream version %d" % version)
    (lod_level,) = struct.unpack_from("<Q", buf, pos)
    pos += 8
    lod = []
    for _ in range(lod_level):
        (nbytes,) = struct.unpack_from("<Q", buf, pos)
        pos += 8
        level = np.frombuffer(buf, np.uint64, int(nbytes) // 8, pos)
        pos += int(nbytes)
        lod.append([int(x) for x in level])
    (tversion,) = struct.unpack_from("<I", buf, pos)
    pos += 4
    if tversion != 0:
        raise ValueError("unsupported tensor version %d" % tversion)
    (desc_size,) = struct.unpack_from("<i", buf, pos)
    pos += 4
    dtype, dims = _parse_tensor_desc(buf[pos: pos + desc_size])
    pos += desc_size
    count = int(np.prod(dims)) if dims else 1
    wire = torch.int16 if dtype == torch.bfloat16 else dtype
    np_dtype = torch.empty((), dtype=wire).numpy().dtype
    arr = np.frombuffer(buf, np_dtype, count, pos).reshape(dims)
    pos += arr.nbytes
    t = torch.from_numpy(arr.copy() if copy else arr)
    if dtype == torch.bfloat16:
        t = t.view(torch.bfloat16)
    return core.LoDTensor(t, lod=lod), pos


# -- host op implementations -------------------------------------------------
def _ensure_dir(path):
    d = os.path.dirname(path)
    if d and not os.path.isdir(d):
        os.makedirs(d, exist_ok=True)


def _atomic_write(path, data):
    """Same-dir temp + fsync + os.replace, so a process killed mid-save
    never leaves a torn file at the real path."""
    _atomic_write_stream(path, (data,))


def _atomic_write_stream(path, chunks):
    """Atomic write fed chunk by chunk (a generator is fine): a combined
    parameters file streams tensor by tensor instead of holding the whole
    payload in host memory. A failure mid-stream removes the temp."""
    tmp = "%s.tmp.%d" % (path, os.getpid())
    try:
        with open(tmp, "wb") as f:
            for chunk in chunks:
                f.write(chunk)
            f.flush()
            os.fsync(f.fileno())
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    os.replace(tmp, path)


def _host_op_infer(op_, block):
    """Host ops have no shape rule: their variables keep what the program
    declared (and the abstract evaluation must not write files)."""
    raise SkipInferShape()


def _saved_value(ctx, name):
    """The run's value of ``name``, as the LoDTensor the scope holds
    around it where there is one (its offsets are part of the stream)."""
    value = ctx.get_opt(name)
    var = ctx.scope.find_var(name) if ctx.scope is not None else None
    held = var.value if var is not None else None
    if isinstance(held, core.LoDTensor) and (value is None
                                            or held.tensor() is value):
        return held
    return value


def _loaded(ctx, t):
    """A read LoDTensor on the run's device: a plain tensor unless it
    carries offsets."""
    t.set(t.tensor().to(ctx.device))
    return t if t.lod() else t.tensor()


def _save_lower(ctx, op_):
    name = op_.input("X")[0]
    value = _saved_value(ctx, name)
    if value is None:
        raise ValueError("save: variable %r not found in scope" % name)
    path = op_.attr("file_path")
    _ensure_dir(path)
    _atomic_write(path, serialize_lod_tensor(value))


def _load_lower(ctx, op_):
    name = op_.output("Out")[0]
    with open(op_.attr("file_path"), "rb") as f:
        t, _ = deserialize_lod_tensor(f.read())
    ctx.set(name, _loaded(ctx, t))


def _save_combine_lower(ctx, op_):
    names = op_.input("X")
    path = op_.attr("file_path")
    _ensure_dir(path)
    values = []
    for n in names:  # validate everything before the temp file opens
        value = _saved_value(ctx, n)
        if value is None:
            raise ValueError("save_combine: %r not in scope" % n)
        values.append(value)
    _atomic_write_stream(path, (serialize_lod_tensor(v) for v in values))


def _load_combine_lower(ctx, op_):
    with open(op_.attr("file_path"), "rb") as f:
        buf = f.read()
    pos = 0
    for n in op_.output("Out"):
        t, pos = deserialize_lod_tensor(buf, pos)
        ctx.set(n, _loaded(ctx, t))


for _type, _lower in (("save", _save_lower), ("load", _load_lower),
                      ("save_combine", _save_combine_lower),
                      ("load_combine", _load_combine_lower)):
    register_op(_type, infer_shape=_host_op_infer, lower=_lower)


def _print_lower(ctx, op_):
    name = op_.input("In")[0] if op_.input("In") else op_.input("X")[0]
    value = ctx.get(name)
    phase = op_.attr("print_phase", "both") or "both"
    is_grad = bool(op_.attr("is_grad_print", False))
    # the forward instance prints activations, the grad instance (made by
    # the grad maker) prints gradients
    should = phase == "both" or phase == ("backward" if is_grad else "forward")
    first_n = int(op_.attr("first_n", -1))
    if should and first_n >= 0:
        # the count lives on the op object: no global table to leak
        seen = getattr(op_, "_print_seen", 0)
        op_._print_seen = seen + 1
        should = seen < first_n
    if should:
        message = op_.attr("message", "")
        summarize = int(op_.attr("summarize", 20))
        t, _ = _host_tensor(value)
        arr = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        shown = arr.ravel()[:summarize] if summarize >= 0 else arr
        parts = [message] if message else []
        if is_grad:
            parts.append("(grad)")
        if op_.attr("print_tensor_name", True):
            parts.append(name)
        if op_.attr("print_tensor_type", True):
            parts.append(core.dtype_name(t.dtype))
        if op_.attr("print_tensor_shape", True):
            parts.append(str(list(arr.shape)))
        parts.append(str(shown))
        print(" ".join(parts))
    out_names = op_.output("Out")
    if out_names:
        ctx.set(out_names[0], value)


def _print_grad_maker(op_):
    """The grad of print is another print (reference: print_op.cc
    PrintOpGradientMaker): it forwards the gradient unchanged and prints
    it when print_phase is 'backward' or 'both'."""
    outs = op_.output("Out")
    ins = op_.input("In") or op_.input("X")  # legacy 'X'-slot programs
    if not outs or not ins:
        return []
    attrs = dict(op_.attrs)
    attrs["is_grad_print"] = True
    return [dict(
        type="print",
        inputs={"In": [outs[0] + "@GRAD"]},
        outputs={"Out": [ins[0] + "@GRAD"]},
        attrs=attrs,
    )]


register_op("print", infer_shape=_host_op_infer, lower=_print_lower,
            grad=_print_grad_maker)


def _noop(ctx, op_):
    pass


register_op("feed", infer_shape=_host_op_infer, lower=_noop)
register_op("fetch", infer_shape=_host_op_infer, lower=_noop)
