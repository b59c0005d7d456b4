"""Sequence (ragged) ops on the padded + lengths representation (port of
``paddle_tpu/fluid/ops/sequence_ops.py``).

A ragged batch is a dense [batch, max_len, ...] tensor with its lengths
in a companion env entry ``{name}@SEQ_LEN`` (int32 [batch]); outer LoD
levels ride ``{name}@SEQ_LEN@L{k}``. The Executor makes the companions
from a ``LoDTensor`` feed (``executor._lod_feed``), sequence ops mask
with them, and ops that emit a ragged output set its companion
(``SEQLEN_OUT_SLOTS``). Masks are built on the device from the lengths
tensor; no lowering here reads a length on the host.
"""

import numpy as np
import torch

from .registry import op

__all__ = ["SEQLEN_OUT_SLOTS", "SEQ_LEN", "reverse_valid_prefix",
           "lengths_for"]

SEQ_LEN = "@SEQ_LEN"

# ops whose listed output slot carries a `{name}@SEQ_LEN` companion
SEQLEN_OUT_SLOTS = {
    "sequence_pad": "Out",
    "sequence_unpad": "Out",
    "sequence_slice": "Out",
    "sequence_reverse": "Y",
    "sequence_erase": "Out",
    "sequence_enumerate": "Out",
    "sequence_conv": "Out",
    "sequence_expand_as": "Out",
    "lod_reset": "Out",
    "row_conv": "Out",
    "lstm": "Hidden",
    "lstmp": "Projection",
    "gru": "Hidden",
    "crf_decoding": "ViterbiPath",
    # host ops with ragged outputs
    "multiclass_nms": "Out",
    "generate_proposals": "RpnRois",
    "mine_hard_examples": "NegIndices",
}

# ops that keep the [B, T] leading layout, so a missing companion is
# inherited from their main input. The port adds ``lookup_table``: an
# embedding of a LoD feed keeps the feed's lengths (the reference's
# chain stops there, so its sequence ops after an embedding see no
# lengths; ROADMAP C)
_COMPANION_TRANSPARENT = {
    "mul", "elementwise_add", "elementwise_sub",
    "elementwise_mul", "elementwise_div", "scale", "cast", "sum",
    "dropout", "relu", "tanh", "sigmoid", "gelu", "leaky_relu",
    "softmax", "layer_norm", "lookup_table",
}


def companion(ctx, key):
    """The env entry ``key`` of the run, looked up through the contexts a
    captured forward or a recurrence step runs in (``LowerCtx.parent``)."""
    while ctx is not None:
        v = ctx.env.get(key)
        if v is not None:
            return v
        ctx = getattr(ctx, "parent", None)
    return None


def reverse_valid_prefix(x, lengths):
    """Reverse each row's valid prefix along the time dim (axis 1),
    keeping padded tails in place; lengths None reverses the whole dim."""
    T = x.shape[1]
    t = torch.arange(T, device=x.device)
    if lengths is None:
        idx = (T - 1 - t).expand(x.shape[0], T)
    else:
        lens = lengths.reshape(-1, 1).long()
        idx = torch.where(t[None, :] < lens, lens - 1 - t[None, :],
                          t[None, :])
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(x.shape)
    return torch.gather(x, 1, idx)


def lengths_for(ctx, name, _depth=8):
    """Companion lengths for ``name``, chaining up through
    layout-preserving producer ops when the direct companion is absent."""
    v = companion(ctx, name + SEQ_LEN)
    if v is not None or ctx.block is None or _depth <= 0:
        return v
    for op_ in ctx.block.ops:
        if name in op_.output_arg_names:
            if op_.type not in _COMPANION_TRANSPARENT:
                return None
            for n in op_.input_arg_names:
                got = lengths_for(ctx, n, _depth - 1)
                if got is not None:
                    return got
            return None
    return None


def _lengths(ctx, op_, slot="X"):
    names = op_.inputs.get(slot) or []
    if not names:
        return None
    return lengths_for(ctx, names[0])


def lod_level_count(ctx, name):
    """LoD levels carried by ``name``'s companions: outer level k rides
    ``{name}@SEQ_LEN@L{k}``, the innermost ``{name}@SEQ_LEN``."""
    n = 0
    while companion(ctx, name + SEQ_LEN + "@L%d" % n) is not None:
        n += 1
    return n + (1 if lengths_for(ctx, name) is not None else 0)


def lengths_level(ctx, name, level):
    """Length vector of LoD level ``level`` (0 = outermost, -1 =
    innermost)."""
    n_levels = lod_level_count(ctx, name)
    if n_levels == 0:
        return None
    if level < 0:
        level += n_levels
    if level == n_levels - 1:
        return lengths_for(ctx, name)
    return companion(ctx, name + SEQ_LEN + "@L%d" % level)


def _full_lengths(x):
    return torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                      device=x.device)


def _lengths_or_full(ctx, op_, x, slot="X"):
    lengths = _lengths(ctx, op_, slot)
    return _full_lengths(x) if lengths is None else lengths


def _mask(x, lengths):
    """[B, T] bool: position t of row b lies inside its sequence."""
    if lengths is None:
        return torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
    t = torch.arange(x.shape[1], device=x.device)
    return t[None, :] < lengths.reshape(-1, 1)


def _bcast(m, x):
    """A [B, T] mask shaped to broadcast against ``x``."""
    return m.reshape(m.shape + (1,) * (x.dim() - 2))


def _set_out_lengths(ctx, op_, lengths, slot="Out"):
    names = op_.outputs.get(slot) or []
    if names and lengths is not None:
        ctx.set(names[0] + SEQ_LEN, lengths)


def _f32_min(dtype):
    return torch.tensor(np.finfo(np.float32).min).to(dtype)


@op("sequence_pool", grad="generic")
def _sequence_pool(ctx, op_):
    x = ctx.in1(op_, "X")  # [B, T, ...]
    ptype = op_.attr("pooltype", "AVERAGE").upper()
    lengths = _lengths(ctx, op_)
    mexp = _bcast(_mask(x, lengths), x).to(x.dtype)
    if ptype == "SUM":
        out = (x * mexp).sum(1)
    elif ptype == "AVERAGE":
        out = (x * mexp).sum(1) / mexp.sum(1).clamp_min(1.0)
    elif ptype == "SQRT":
        out = (x * mexp).sum(1) / mexp.sum(1).clamp_min(1.0).sqrt()
    elif ptype == "MAX":
        out = torch.where(mexp > 0, x, _f32_min(x.dtype).to(x.device)
                          ).amax(1)
    elif ptype == "LAST":
        if lengths is None:
            out = x[:, -1]
        else:
            idx = (lengths.long() - 1).clamp_min(0).reshape(
                (-1, 1) + (1,) * (x.dim() - 2)).expand(
                (x.shape[0], 1) + tuple(x.shape[2:]))
            out = torch.gather(x, 1, idx)[:, 0]
    elif ptype == "FIRST":
        out = x[:, 0]
    else:
        raise NotImplementedError("sequence_pool type %r" % ptype)
    ctx.out(op_, "Out", out)
    if op_.output("MaxIndex"):
        ctx.out(op_, "MaxIndex", x.argmax(1).to(torch.int32))


@op("sequence_softmax", grad="generic")
def _sequence_softmax(ctx, op_):
    x = ctx.in1(op_, "X")  # [B, T]
    m = _mask(x, _lengths(ctx, op_))
    masked = torch.where(m, x, _f32_min(x.dtype).to(x.device))
    e = torch.exp(masked - masked.amax(1, keepdim=True))
    e = torch.where(m, e, torch.zeros_like(e))
    ctx.out(op_, "Out", e / e.sum(1, keepdim=True).clamp_min(1e-12))


@op("sequence_expand", grad="generic")
def _sequence_expand(ctx, op_):
    """``sequence_expand_op.cc``: each X entry repeated by the matching
    Y lod[ref_level] length. On the padded representation the output's
    instance count is Y's, so the expansion is a gather: out[j] =
    x[group(j)], group(j) = searchsorted(cumsum(ref_lens), j, right)."""
    x = ctx.in1(op_, "X")
    y = ctx.in1(op_, "Y")
    ref_level = int(op_.attr("ref_level", -1))
    ynames = op_.inputs.get("Y") or []
    n_levels = lod_level_count(ctx, ynames[0]) if ynames else 0
    resolved = ref_level + n_levels if ref_level < 0 else ref_level
    ref_lens = None
    if n_levels >= 2:
        if resolved == n_levels - 1:
            raise NotImplementedError(
                "sequence_expand by the INNERMOST level of a multi-level "
                "LoD Y has a data-dependent output length; use "
                "ref_level <= %d (group levels) or restructure"
                % (n_levels - 2))
        if resolved != n_levels - 2:
            raise NotImplementedError(
                "sequence_expand ref_level=%d of a %d-level Y: only the "
                "level counting Y's instances (level %d) maps to the "
                "padded representation" % (ref_level, n_levels,
                                           n_levels - 2))
        ref_lens = lengths_level(ctx, ynames[0], resolved)
    if ref_lens is not None and x.shape[0] == ref_lens.shape[0]:
        cum = torch.cumsum(ref_lens.long(), 0)
        j = torch.arange(y.shape[0], device=x.device)
        grp = torch.searchsorted(cum, j, right=True)
        out = x[grp.clamp(0, x.shape[0] - 1)]
        valid = (j < cum[-1]).reshape((-1,) + (1,) * (out.dim() - 1))
        ctx.out(op_, "Out", torch.where(valid, out, torch.zeros_like(out)))
        _set_out_lengths(ctx, op_, _lengths(ctx, op_, "Y"))
        return
    # single-level form: broadcast along Y's time
    if x.dim() < y.dim():
        x = x[:, None]
    reps = [1] * x.dim()
    reps[1] = y.shape[1] // x.shape[1] if x.shape[1] else y.shape[1]
    ctx.out(op_, "Out", x.repeat(*reps))


@op("sequence_reshape", grad="generic")
def _sequence_reshape(ctx, op_):
    x = ctx.in1(op_, "X")
    ctx.out(op_, "Out", x.reshape(x.shape[0], -1, int(op_.attr("new_dim"))))


@op("sequence_concat", grad="generic")
def _sequence_concat(ctx, op_):
    ctx.out(op_, "Out", torch.cat(ctx.ins(op_, "X"), dim=1))


@op("sequence_pad", grad="generic")
def _sequence_pad(ctx, op_):
    """``sequence_pad_op.cc``: the data is already dense; the tail is set
    to PadValue and Length emitted (int64)."""
    x = ctx.in1(op_, "X")
    pad_value = ctx.in1(op_, "PadValue").to(x.dtype)
    lengths = _lengths_or_full(ctx, op_, x)
    padded_length = int(op_.attr("padded_length", -1))
    if pad_value.dim() and pad_value.numel() > 1:
        pv = pad_value.reshape((1,) * (x.dim() - pad_value.dim())
                               + tuple(pad_value.shape))
    else:
        pv = pad_value.reshape((1,) * x.dim())
    pv = pv.expand(x.shape)
    out = torch.where(_bcast(_mask(x, lengths), x), x, pv)
    if padded_length > 0:
        if padded_length < x.shape[1]:
            out = out[:, :padded_length]
        elif padded_length > x.shape[1]:
            extra = (x.shape[0], padded_length - x.shape[1]) + tuple(
                x.shape[2:])
            out = torch.cat([out, pv[:, :1].expand(extra)], dim=1)
    ctx.out(op_, "Out", out)
    ctx.out(op_, "Length", lengths.long())
    _set_out_lengths(ctx, op_, lengths)


@op("sequence_unpad", grad="generic")
def _sequence_unpad(ctx, op_):
    """``sequence_unpad_op.cc``: the output stays dense, masked; Length
    becomes the companion."""
    x = ctx.in1(op_, "X")
    lengths = ctx.in1(op_, "Length").reshape(-1).to(torch.int32)
    ctx.out(op_, "Out", x * _bcast(_mask(x, lengths), x).to(x.dtype))
    _set_out_lengths(ctx, op_, lengths)


@op("sequence_mask")
def _sequence_mask(ctx, op_):
    """``sequence_mask_op.cc``: Y[b, t] = t < X[b], ``maxlen`` columns
    (max(X) read on the host when ``maxlen`` is unset, as the
    reference's concrete-length path)."""
    from .tensor_ops import _dtype

    x = ctx.in1(op_, "X").reshape(-1)
    maxlen = op_.attr("maxlen", -1)
    if op_.input("MaxLenTensor"):
        maxlen = ctx.host_ints(op_, "MaxLenTensor")[0]
    if maxlen is None or int(maxlen) < 0:
        maxlen = int(x.max())
    t = torch.arange(int(maxlen), device=x.device)
    ctx.out(op_, "Y", (t[None, :] < x[:, None]).to(
        _dtype(op_.attr("out_dtype", 5))))


@op("sequence_slice", grad="generic")
def _sequence_slice(ctx, op_):
    """``sequence_slice_op.cc``: per sequence [offset, offset + length)."""
    x = ctx.in1(op_, "X")  # [B, T, ...]
    offset = ctx.in1(op_, "Offset").reshape(-1).long()
    length = ctx.in1(op_, "Length").reshape(-1).to(torch.int32)
    T = x.shape[1]
    t = torch.arange(T, device=x.device)
    src = (offset[:, None] + t[None, :]).clamp(0, T - 1)
    src = src.reshape(src.shape + (1,) * (x.dim() - 2)).expand(x.shape)
    gathered = torch.gather(x, 1, src)
    m = _bcast(t[None, :] < length[:, None], x)
    ctx.out(op_, "Out", torch.where(m, gathered, torch.zeros_like(gathered)))
    _set_out_lengths(ctx, op_, length)


@op("sequence_reverse", grad="generic")
def _sequence_reverse(ctx, op_):
    """``sequence_reverse_op.cc``: each sequence's valid prefix reversed,
    padding kept in place."""
    x = ctx.in1(op_, "X")
    lengths = _lengths(ctx, op_)
    ctx.out(op_, "Y", reverse_valid_prefix(x, lengths))
    _set_out_lengths(ctx, op_, _full_lengths(x) if lengths is None
                     else lengths, slot="Y")


def _squeezed_ids(x):
    if x.dim() == 3 and x.shape[2] == 1:
        return x[:, :, 0], True
    return x, False


@op("sequence_erase")
def _sequence_erase(ctx, op_):
    """``sequence_erase_op.cc``: listed tokens dropped and each sequence
    compacted left in order (a stable sort on the drop flag)."""
    x, squeeze_back = _squeezed_ids(ctx.in1(op_, "X"))
    lengths = _lengths(ctx, op_)
    t = torch.arange(x.shape[1], device=x.device)
    valid = (t[None, :] < lengths.reshape(-1, 1)) if lengths is not None \
        else torch.ones_like(x, dtype=torch.bool)
    remove = torch.zeros_like(x, dtype=torch.bool)
    for tok in op_.attr("tokens") or []:
        remove = remove | (x == int(tok))
    keep = valid & ~remove
    order = torch.sort((~keep).to(torch.int32), dim=1, stable=True).indices
    out = torch.gather(x, 1, order)
    new_len = keep.sum(1).to(torch.int32)
    out = torch.where(t[None, :] < new_len[:, None], out,
                      torch.zeros_like(out))
    ctx.out(op_, "Out", out[:, :, None] if squeeze_back else out)
    _set_out_lengths(ctx, op_, new_len)


@op("sequence_enumerate")
def _sequence_enumerate(ctx, op_):
    """``sequence_enumerate_op.cc``: windows of ``win_size`` ids, positions
    past the sequence end filled with ``pad_value``; [B, T, win]."""
    x, _sq = _squeezed_ids(ctx.in1(op_, "X"))
    win = int(op_.attr("win_size"))
    pad = int(op_.attr("pad_value", 0))
    lengths = _lengths(ctx, op_)
    T = x.shape[1]
    t = torch.arange(T, device=x.device)
    L = lengths.reshape(-1, 1) if lengths is not None else T
    cols = []
    for k in range(win):
        v = x[:, (t + k).clamp(0, T - 1)]
        cols.append(torch.where((t[None, :] + k) < L, v,
                                torch.full_like(v, pad)))
    ctx.out(op_, "Out", torch.stack(cols, dim=2))
    _set_out_lengths(ctx, op_, _lengths_or_full(ctx, op_, x))


@op("sequence_conv", grad="generic")
def _sequence_conv(ctx, op_):
    """``sequence_conv_op.cc``: the context window [x_{t+start}, ...,
    x_{t+start+len-1}] times Filter; positions outside the sequence
    contribute zeros."""
    x = ctx.in1(op_, "X")  # [B, T, D]
    filt = ctx.in1(op_, "Filter")  # [context_length * D, M]
    ctx_len = int(op_.attr("contextLength"))
    ctx_start = int(op_.attr("contextStart", -((ctx_len - 1) // 2)))
    lengths = _lengths(ctx, op_)
    T = x.shape[1]
    t = torch.arange(T, device=x.device)
    L = lengths.reshape(-1, 1) if lengths is not None else T
    pieces = []
    for j in range(ctx_len):
        shift = ctx_start + j
        v = x[:, (t + shift).clamp(0, T - 1)]
        ok = ((t[None, :] + shift) >= 0) & ((t[None, :] + shift) < L)
        pieces.append(torch.where(ok[:, :, None], v, torch.zeros_like(v)))
    out = torch.cat(pieces, dim=2) @ filt
    if lengths is not None:
        out = out * _mask(out, lengths)[:, :, None].to(out.dtype)
    ctx.out(op_, "Out", out)
    _set_out_lengths(ctx, op_, _lengths_or_full(ctx, op_, x))


@op("sequence_expand_as", grad="generic")
def _sequence_expand_as(ctx, op_):
    """``sequence_expand_as_op.cc``: each row of X along Y's time."""
    x = ctx.in1(op_, "X")
    y = ctx.in1(op_, "Y")
    ylen = _lengths(ctx, op_, slot="Y")
    if x.dim() == 2:  # [B, D] -> [B, T, D]
        out = x[:, None].expand((x.shape[0], y.shape[1]) + tuple(
            x.shape[1:]))
    else:  # [B, 1, D] -> [B, T, D]
        out = x.expand((x.shape[0], y.shape[1]) + tuple(x.shape[2:]))
    if ylen is not None:
        out = out * _bcast(_mask(out, ylen), out).to(out.dtype)
    ctx.out(op_, "Out", out)
    _set_out_lengths(ctx, op_, _lengths_or_full(ctx, op_, y, slot="Y"))


@op("sequence_scatter", grad="generic")
def _sequence_scatter(ctx, op_):
    """``sequence_scatter_op.cc``: per sequence i, X[i, ids] += updates
    over the sequence's tokens."""
    x = ctx.in1(op_, "X")  # [B, D]
    ids, _s = _squeezed_ids(ctx.in1(op_, "Ids"))
    upd, _s = _squeezed_ids(ctx.in1(op_, "Updates"))
    lengths = _lengths(ctx, op_, slot="Ids")
    if lengths is not None:
        valid = torch.arange(ids.shape[1], device=x.device)[None, :] < \
            lengths.reshape(-1, 1)
        upd = torch.where(valid, upd, torch.zeros_like(upd))
    ctx.out(op_, "Out", x.scatter_add(1, ids.long(), upd.to(x.dtype)))


@op("lod_reset", grad="generic")
def _lod_reset(ctx, op_):
    """``lod_reset_op.cc``: the data unchanged, the companion lengths
    from Y (offsets) or the ``target_lod`` attr (offsets)."""
    x = ctx.in1(op_, "X")
    ctx.out(op_, "Out", x)
    y = ctx.in1(op_, "Y", optional=True)
    if y is not None:
        offs = y.reshape(-1).to(torch.int32)
        _set_out_lengths(ctx, op_, offs[1:] - offs[:-1])
        return
    target = op_.attr("target_lod") or []
    if target:
        t = np.asarray(target, np.int64)
        _set_out_lengths(ctx, op_, torch.as_tensor(
            (t[1:] - t[:-1]).astype(np.int32), device=x.device))
    else:
        _set_out_lengths(ctx, op_, _lengths_or_full(ctx, op_, x))


@op("im2sequence", grad="generic")
def _im2sequence(ctx, op_):
    """``im2sequence_op.cc``: an NCHW image as the [B, patches,
    C·kh·kw] sequence of its patches."""
    x = ctx.in1(op_, "X")  # [B, C, H, W]
    kh, kw = [int(v) for v in op_.attr("kernels")]
    strides = [int(v) for v in (op_.attr("strides") or [1, 1])]
    pads = [int(v) for v in (op_.attr("paddings") or [0, 0, 0, 0])]
    x = torch.nn.functional.pad(x, (pads[1], pads[3], pads[0], pads[2]))
    patches = torch.nn.functional.unfold(x, (kh, kw), stride=strides)
    ctx.out(op_, "Out", patches.transpose(1, 2).contiguous())


@op("row_conv", grad="generic")
def _row_conv(ctx, op_):
    """``row_conv_op.cc``: lookahead out[b, t] = Σ_j x[b, t+j] · W[j]
    (future context inside the sequence only)."""
    x = ctx.in1(op_, "X")  # [B, T, D]
    w = ctx.in1(op_, "Filter")  # [future_context + 1, D]
    lengths = _lengths(ctx, op_)
    T = x.shape[1]
    t = torch.arange(T, device=x.device)
    L = lengths.reshape(-1, 1) if lengths is not None else T
    out = torch.zeros_like(x)
    for j in range(w.shape[0]):
        v = x[:, (t + j).clamp(0, T - 1)] * w[j][None, None, :]
        out = out + torch.where(((t[None, :] + j) < L)[:, :, None], v,
                                torch.zeros_like(v))
    ctx.out(op_, "Out", out)
    _set_out_lengths(ctx, op_, _lengths_or_full(ctx, op_, x))
