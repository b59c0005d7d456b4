"""Hand-rolled protobuf (proto2) wire-format codec for ProgramDesc (a copy
of ``paddle_tpu/fluid/proto_wire.py``, pointed at the port's ``core``; the
bytes it writes are the reference's bytes).

This encodes a Program spec (the dict produced by ``proto.program_to_spec``)
as bytes that parse under Paddle's schema ``framework/framework.proto``
(ProgramDesc L212 ⊃ BlockDesc L174 ⊃ OpDesc L43 + VarDesc L165; AttrType
enum L26-39; VarType.Type enum L105-137) — no protobuf library
dependency, wire semantics only:

- wire types: 0 = varint, 1 = 64-bit, 2 = length-delimited, 5 = 32-bit;
  tag = (field_number << 3) | wire_type.
- proto2 ``int32``/``int64`` negatives are 10-byte two's-complement varints.
- repeated scalar fields are emitted unpacked (proto2 default, which is what
  protoc's output produces); the decoder also accepts packed.

Metadata that has no slot in the schema (Parameter-ness, stop_gradient,
the inference feed/fetch lists, params_grads, random seed) rides in a
single length-delimited field number 1000 on ProgramDesc / VarDesc-keyed
entries inside it, as UTF-8 JSON. Conformant proto parsers skip unknown
fields.

bf16 note: the extension dtype BF16 (value 22, core.py) has no slot in
the schema's enum, and TensorDesc.data_type is a REQUIRED proto2 field —
an unknown enum value there would fail the required-field check in
conformant parsers. BF16 vars therefore encode FP16 as a schema-valid
stand-in in TensorDesc.data_type and carry the true dtype in the
field-1000 extras, restored on decode.
"""

from __future__ import annotations

import base64
import json
import pickle
import struct

from . import core

# AttrType enum (framework.proto:26-39)
_INT = 0
_FLOAT = 1
_STRING = 2
_INTS = 3
_FLOATS = 4
_STRINGS = 5
_BOOLEAN = 6
_BOOLEANS = 7
_BLOCK = 8
_LONG = 9
_BLOCKS = 10
_LONGS = 11

_VT = core.VarDesc.VarType
_EXTRAS_FIELD = 1000  # unknown-field extension slot (skipped by conformant parsers)

_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1


# ---------------------------------------------------------------------------
# low-level wire helpers
# ---------------------------------------------------------------------------


def _uvarint(n):
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _svarint(n):
    """proto2 int32/int64 encoding: negatives as 64-bit two's complement."""
    n = int(n)
    if n < 0:
        n += 1 << 64
    return _uvarint(n)


def _tag(field, wt):
    return _uvarint((field << 3) | wt)


def _ld(field, payload):
    return _tag(field, 2) + _uvarint(len(payload)) + payload


def _vi(field, n):
    return _tag(field, 0) + _svarint(n)


def _f32(field, x):
    return _tag(field, 5) + struct.pack("<f", float(x))


def _s(field, s):
    return _ld(field, s.encode("utf-8") if isinstance(s, str) else bytes(s))


def _to_signed(v, bits=64):
    if v >= 1 << (bits - 1):
        v -= 1 << bits
    return v


# ---------------------------------------------------------------------------
# generic decoder: bytes -> {field: [(wiretype, raw_value), ...]}
# ---------------------------------------------------------------------------


def _parse_msg(buf):
    fields = {}
    i, n = 0, len(buf)
    while i < n:
        key = 0
        shift = 0
        while True:
            b = buf[i]
            i += 1
            key |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        field, wt = key >> 3, key & 7
        if wt == 0:
            v = 0
            shift = 0
            while True:
                b = buf[i]
                i += 1
                v |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
        elif wt == 2:
            ln = 0
            shift = 0
            while True:
                b = buf[i]
                i += 1
                ln |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
            v = buf[i : i + ln]
            i += ln
        elif wt == 5:
            v = buf[i : i + 4]
            i += 4
        elif wt == 1:
            v = buf[i : i + 8]
            i += 8
        else:
            raise ValueError("unsupported wire type %d" % wt)
        fields.setdefault(field, []).append((wt, v))
    return fields


def _one(fields, field, default=None):
    vs = fields.get(field)
    return vs[-1][1] if vs else default


def _ints(fields, field):
    """Repeated varint field; accepts unpacked and packed encodings."""
    out = []
    for wt, v in fields.get(field, []):
        if wt == 0:
            out.append(v)
        else:  # packed
            i = 0
            while i < len(v):
                x = 0
                shift = 0
                while True:
                    b = v[i]
                    i += 1
                    x |= (b & 0x7F) << shift
                    if not b & 0x80:
                        break
                    shift += 7
                out.append(x)
    return out


def _floats(fields, field):
    out = []
    for wt, v in fields.get(field, []):
        if wt == 5:
            out.append(struct.unpack("<f", v)[0])
        else:  # packed
            out.extend(x[0] for x in struct.iter_unpack("<f", v))
    return out


# ---------------------------------------------------------------------------
# attr classification + encoding
# ---------------------------------------------------------------------------


def _is_bool(v):
    return isinstance(v, bool) or type(v).__name__ == "bool_"


def _is_int(v):
    if _is_bool(v):
        return False
    if isinstance(v, int):
        return True
    return type(v).__name__ in ("int8", "int16", "int32", "int64", "uint8", "uint64")


def _is_float(v):
    return isinstance(v, float) or type(v).__name__ in ("float16", "float32", "float64")


def classify_attr(name, v):
    """Return the AttrType for a Python attr value, or None if unencodable."""
    if name == "sub_block" and _is_int(v):
        return _BLOCK
    if name in ("sub_blocks", "blocks_idx") and isinstance(v, (list, tuple)) and v and all(_is_int(x) for x in v):
        return _BLOCKS
    if _is_bool(v):
        return _BOOLEAN
    if _is_int(v):
        return _INT if _INT32_MIN <= v <= _INT32_MAX else _LONG
    if _is_float(v):
        return _FLOAT
    if isinstance(v, str):
        return _STRING
    if isinstance(v, (list, tuple)):
        if not v:
            return _INTS
        if all(_is_bool(x) for x in v):
            return _BOOLEANS
        if all(_is_int(x) for x in v):
            return _INTS if all(_INT32_MIN <= x <= _INT32_MAX for x in v) else _LONGS
        if all(_is_int(x) or _is_float(x) for x in v):
            return _FLOATS
        if all(isinstance(x, str) for x in v):
            return _STRINGS
    return None


def _encode_attr(name, v, atype):
    # OpDesc.Attr: name=1, type=2, i=3, f=4, s=5, ints=6, floats=7, strings=8,
    # b=10, bools=11, block_idx=12, l=13, blocks_idx=14, longs=15
    out = _s(1, name) + _vi(2, atype)
    if atype == _INT:
        out += _vi(3, v)
    elif atype == _FLOAT:
        out += _f32(4, v)
    elif atype == _STRING:
        out += _s(5, v)
    elif atype == _INTS:
        out += b"".join(_vi(6, x) for x in v)
    elif atype == _FLOATS:
        out += b"".join(_f32(7, x) for x in v)
    elif atype == _STRINGS:
        out += b"".join(_s(8, x) for x in v)
    elif atype == _BOOLEAN:
        out += _vi(10, 1 if v else 0)
    elif atype == _BOOLEANS:
        out += b"".join(_vi(11, 1 if x else 0) for x in v)
    elif atype == _BLOCK:
        out += _vi(12, v)
    elif atype == _LONG:
        out += _vi(13, v)
    elif atype == _BLOCKS:
        out += b"".join(_vi(14, x) for x in v)
    elif atype == _LONGS:
        out += b"".join(_vi(15, x) for x in v)
    return _ld(4, out)


def _decode_attr(buf):
    f = _parse_msg(buf)
    name = _one(f, 1).decode("utf-8")
    atype = _one(f, 2)
    if atype == _INT:
        v = _to_signed(_one(f, 3), 64)
    elif atype == _FLOAT:
        v = struct.unpack("<f", _one(f, 4))[0]
    elif atype == _STRING:
        v = _one(f, 5).decode("utf-8")
    elif atype == _INTS:
        v = [_to_signed(x) for x in _ints(f, 6)]
    elif atype == _FLOATS:
        v = _floats(f, 7)
    elif atype == _STRINGS:
        v = [x[1].decode("utf-8") for x in f.get(8, [])]
    elif atype == _BOOLEAN:
        v = bool(_one(f, 10))
    elif atype == _BOOLEANS:
        v = [bool(x) for x in _ints(f, 11)]
    elif atype == _BLOCK:
        v = _to_signed(_one(f, 12))
    elif atype == _LONG:
        v = _to_signed(_one(f, 13))
    elif atype == _BLOCKS:
        v = [_to_signed(x) for x in _ints(f, 14)]
    elif atype == _LONGS:
        v = [_to_signed(x) for x in _ints(f, 15)]
    else:
        raise ValueError("unknown AttrType %s" % atype)
    return name, v


# ---------------------------------------------------------------------------
# Var / Op / Block / Program encoding
# ---------------------------------------------------------------------------

# VarType.Type values that carry a TensorDesc in a sub-message slot
_TENSOR_SLOT = {
    _VT.LOD_TENSOR: 3,  # VarType.lod_tensor (LoDTensorDesc)
    _VT.SELECTED_ROWS: 2,  # VarType.selected_rows (bare TensorDesc)
    _VT.LOD_TENSOR_ARRAY: 4,  # VarType.tensor_array (LoDTensorDesc)
}


def _encode_var(vs):
    vtype = vs["type"]
    dims = [int(d) if d is not None else -1 for d in vs.get("shape") or ()]
    # TensorDesc.data_type is a REQUIRED proto2 enum: the extension
    # value 22 (BF16) would decode as an unknown field and fail the
    # required-field check under the schema. Encode a
    # schema-valid stand-in (FP16, the closest 16-bit type the CUDA-era
    # schema has) and carry the true dtype in the field-1000 extras
    # (_var_extras), restored by _decode_var.
    wire_dtype = _VT.FP16 if vs["dtype"] == _VT.BF16 else vs["dtype"]
    tensor_desc = _vi(1, wire_dtype) + b"".join(_vi(2, d) for d in dims)
    vt = _vi(1, vtype)
    slot = _TENSOR_SLOT.get(vtype)
    if slot == 2:
        vt += _ld(2, tensor_desc)
    elif slot is not None:
        vt += _ld(slot, _ld(1, tensor_desc) + _vi(2, vs.get("lod_level") or 0))
    out = _s(1, vs["name"]) + _ld(2, vt)
    if vs.get("persistable"):
        out += _vi(3, 1)
    if vs.get("need_check_feed"):
        out += _vi(4, 1)
    return out


def _var_extras(vs):
    """Spec keys with no VarDesc slot (only non-defaults recorded)."""
    ex = {}
    if vs.get("is_parameter"):
        ex["is_parameter"] = True
        if vs.get("trainable") is not None:
            ex["trainable"] = bool(vs["trainable"])
    if vs.get("stop_gradient"):
        ex["stop_gradient"] = True
    if vs.get("is_data"):
        ex["is_data"] = True
    if vs.get("dtype") == _VT.BF16:
        # true dtype for the FP16 stand-in written into TensorDesc.data_type
        ex["dtype"] = vs["dtype"]
    if _TENSOR_SLOT.get(vs["type"]) is None:
        # no TensorDesc slot for this var type: keep dtype/shape out-of-band
        if vs.get("dtype") != _VT.FP32:
            ex["dtype"] = vs["dtype"]
        if vs.get("shape"):
            ex["shape"] = [int(d) if d is not None else -1 for d in vs["shape"]]
        if vs.get("lod_level"):
            ex["lod_level"] = vs["lod_level"]
    return ex


def _decode_var(buf, extras):
    f = _parse_msg(buf)
    name = _one(f, 1).decode("utf-8")
    vt = _parse_msg(_one(f, 2))
    vtype = _one(vt, 1)
    dtype, shape, lod_level = _VT.FP32, [], 0
    slot = _TENSOR_SLOT.get(vtype)
    if slot is not None and slot in vt:
        if slot == 2:
            td = _parse_msg(_one(vt, 2))
        else:
            ltd = _parse_msg(_one(vt, slot))
            td = _parse_msg(_one(ltd, 1))
            lod_level = _one(ltd, 2, 0)
        dtype = _one(td, 1)
        shape = [_to_signed(d) for d in _ints(td, 2)]
    ex = extras.get(name, {})
    return dict(
        name=name,
        shape=ex.get("shape", shape),
        dtype=ex.get("dtype", dtype),
        lod_level=ex.get("lod_level", lod_level),
        persistable=bool(_one(f, 3, 0)),
        need_check_feed=bool(_one(f, 4, 0)),
        stop_gradient=ex.get("stop_gradient", False),
        is_data=ex.get("is_data", False),
        type=vtype,
        is_parameter=ex.get("is_parameter", False),
        trainable=ex.get("trainable"),
    )


def _encode_op(ospec, unencodable_sink):
    # OpDesc: inputs=1, outputs=2, type=3, attrs=4
    out = b""
    for param, args in ospec["inputs"].items():
        out += _ld(1, _s(1, param) + b"".join(_s(2, a) for a in args))
    for param, args in ospec["outputs"].items():
        out += _ld(2, _s(1, param) + b"".join(_s(2, a) for a in args))
    out += _s(3, ospec["type"])
    for name, v in ospec["attrs"].items():
        atype = classify_attr(name, v)
        if atype is None:
            unencodable_sink[name] = _jsonable(v)
        else:
            out += _encode_attr(name, v, atype)
    return out


def _decode_op(buf, extras):
    f = _parse_msg(buf)
    inputs, outputs, attrs = {}, {}, {}
    for _, v in f.get(1, []):
        m = _parse_msg(v)
        inputs[_one(m, 1).decode("utf-8")] = [a[1].decode("utf-8") for a in m.get(2, [])]
    for _, v in f.get(2, []):
        m = _parse_msg(v)
        outputs[_one(m, 1).decode("utf-8")] = [a[1].decode("utf-8") for a in m.get(2, [])]
    for _, v in f.get(4, []):
        name, av = _decode_attr(v)
        attrs[name] = av
    for name, av in extras.items():
        attrs[name] = _unjsonable(av)
    return dict(
        type=_one(f, 3).decode("utf-8"), inputs=inputs, outputs=outputs, attrs=attrs
    )


def _jsonable(v):
    """Best-effort JSON value; last resort = pickled + base64 with marker."""
    try:
        json.dumps(v)
        return v
    except (TypeError, ValueError):
        if isinstance(v, (list, tuple)):
            return {"__tuple__": [_jsonable(x) for x in v]} if isinstance(v, tuple) else [
                _jsonable(x) for x in v
            ]
        return {"__pickle__": base64.b64encode(pickle.dumps(v, protocol=2)).decode("ascii")}


def _unjsonable(v):
    if isinstance(v, dict):
        if "__pickle__" in v:
            return pickle.loads(base64.b64decode(v["__pickle__"]))
        if "__tuple__" in v:
            return tuple(_unjsonable(x) for x in v["__tuple__"])
        return {k: _unjsonable(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_unjsonable(x) for x in v]
    return v


def encode_program(spec):
    """Program spec dict (proto.program_to_spec) -> framework.proto wire bytes."""
    extras = {"vars": {}, "op_attrs": {}}
    out = b""
    for bspec in spec["blocks"]:
        bidx = bspec["idx"]
        body = _vi(1, bidx) + _vi(2, bspec["parent_idx"])
        for vs in bspec["vars"]:
            body += _ld(3, _encode_var(vs))
            ex = _var_extras(vs)
            if ex:
                extras["vars"]["%d/%s" % (bidx, vs["name"])] = ex
        for oi, ospec in enumerate(bspec["ops"]):
            sink = {}
            body += _ld(4, _encode_op(ospec, sink))
            if sink:
                extras["op_attrs"]["%d/%d" % (bidx, oi)] = sink
        fwd = bspec.get("forward_block_idx", -1)
        if fwd != -1:
            body += _vi(5, fwd)
        out += _ld(1, body)
    out += _ld(4, _vi(1, 0))  # Version.version = 0
    if spec.get("random_seed"):
        extras["random_seed"] = spec["random_seed"]
    if spec.get("inference_io"):
        extras["inference_io"] = _jsonable(spec["inference_io"])
    if spec.get("params_grads"):
        extras["params_grads"] = [list(pg) for pg in spec["params_grads"]]
    out += _ld(_EXTRAS_FIELD, json.dumps(extras, sort_keys=True).encode("utf-8"))
    return out


def decode_program(data):
    """framework.proto wire bytes -> Program spec dict."""
    f = _parse_msg(bytes(data))
    extras = {}
    raw_ex = _one(f, _EXTRAS_FIELD)
    if raw_ex:
        extras = json.loads(raw_ex.decode("utf-8"))
    var_ex = extras.get("vars", {})
    op_ex = extras.get("op_attrs", {})
    blocks = []
    for _, bbuf in f.get(1, []):
        bf = _parse_msg(bbuf)
        bidx = _to_signed(_one(bf, 1, 0))
        vext = {
            k.split("/", 1)[1]: v
            for k, v in var_ex.items()
            if int(k.split("/", 1)[0]) == bidx
        }
        blocks.append(
            dict(
                idx=bidx,
                parent_idx=_to_signed(_one(bf, 2, 0)),
                forward_block_idx=_to_signed(_one(bf, 5, (1 << 64) - 1)),
                vars=[_decode_var(v, vext) for _, v in bf.get(3, [])],
                ops=[
                    _decode_op(v, op_ex.get("%d/%d" % (bidx, oi), {}))
                    for oi, (_, v) in enumerate(bf.get(4, []))
                ],
            )
        )
    spec = dict(
        version=1,
        blocks=blocks,
        random_seed=extras.get("random_seed", 0),
        inference_io=_unjsonable(extras.get("inference_io")),
        params_grads=[tuple(pg) for pg in extras.get("params_grads", [])],
    )
    return spec
