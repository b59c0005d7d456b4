"""Fused recurrent ops ``lstm``, ``lstmp``, ``lstm_unit``, ``gru`` and
``gru_unit`` (port of ``paddle_tpu/fluid/ops/rnn_fused_ops.py:25-277``).

Gate layouts are the reference's (``lstm_op.cc``: [candidate, input,
forget, output] with peepholes on i/f from the previous cell and on o
from the new cell; ``gru_op.cc``: [update, reset, candidate], with
``origin_mode`` choosing h = u·h_prev + (1−u)·c or (1−u)·h_prev + u·c;
``lstm_unit_op.cc``: [i, f, o, g] with ``forget_bias``). The reference
lowers each recurrence to one ``lax.scan``; here it is a loop over time
of plain torch ops, and the generic grad takes its backward on the
autograd tape the forward left. Neither cuDNN's RNN (other gate order,
no peepholes, fixed activations) nor a hand kernel (no TPU kernel
exists for these) is used. Padded steps freeze the carry and emit zeros
(masking in place of the reference's LoD batch reordering); a reversed
op runs each sequence's valid prefix back to front.
"""

import torch

from .registry import SkipInferShape, in_var, op, set_out
from .sequence_ops import SEQ_LEN, lengths_for, reverse_valid_prefix

_ACTS = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "identity": lambda v: v,
    "linear": lambda v: v,
}


def _act(name):
    return _ACTS[name or "tanh"]


def _seq_lens(ctx, op_, slot, B, T, device):
    names = op_.inputs.get(slot) or []
    lens = lengths_for(ctx, names[0]) if names else None
    if lens is None:
        lens = torch.full((B,), T, dtype=torch.int32, device=device)
    return lens


def _live_steps(lens, T):
    """[T, B, 1] bool: step t of row b lies inside its sequence."""
    t = torch.arange(T, device=lens.device)
    return (t[:, None] < lens.reshape(1, -1))[:, :, None]


def _lstm_impl(ctx, op_, with_projection):
    x = ctx.in1(op_, "Input")  # [B, T, 4D] (x @ Wx + b done by an fc)
    w = ctx.in1(op_, "Weight")  # [D or P, 4D] hidden-to-hidden
    bias = ctx.in1(op_, "Bias", optional=True)  # [1, 4D] or [1, 7D]
    h0 = ctx.in1(op_, "H0", optional=True)
    c0 = ctx.in1(op_, "C0", optional=True)
    B, T = x.shape[0], x.shape[1]
    D = x.shape[2] // 4
    is_reverse = bool(op_.attr("is_reverse", False))
    use_peepholes = bool(op_.attr("use_peepholes", False))
    act_gate = _act(op_.attr("gate_activation", "sigmoid"))
    act_cell = _act(op_.attr("cell_activation", "tanh"))
    act_cand = _act(op_.attr("candidate_activation", "tanh"))
    lens = _seq_lens(ctx, op_, "Input", B, T, x.device)

    gate_bias = None
    checkI = checkF = checkO = None
    if bias is not None:
        b = bias.reshape(-1)
        gate_bias = b[: 4 * D]
        if use_peepholes and b.shape[0] >= 7 * D:
            checkI, checkF, checkO = (b[4 * D:5 * D], b[5 * D:6 * D],
                                      b[6 * D:7 * D])
    if with_projection:
        proj_w = ctx.in1(op_, "ProjWeight")  # [D, P]
        act_proj = _act(op_.attr("proj_activation", "tanh"))
        h = h0 if h0 is not None else x.new_zeros((B, proj_w.shape[1]))
    else:
        h = h0 if h0 is not None else x.new_zeros((B, D))
    c = c0 if c0 is not None else x.new_zeros((B, D))
    if is_reverse:
        x = reverse_valid_prefix(x, lens)
    live = _live_steps(lens, T)
    hs, cs, gates_all = [], [], []
    for t in range(T):
        gates = x[:, t] + h @ w
        if gate_bias is not None:
            gates = gates + gate_bias
        cand = act_cand(gates[:, :D])
        gi, gf = gates[:, D:2 * D], gates[:, 2 * D:3 * D]
        if checkI is not None:
            gi, gf = gi + c * checkI, gf + c * checkF
        ig, fg = act_gate(gi), act_gate(gf)
        c_new = cand * ig + fg * c
        go = gates[:, 3 * D:]
        if checkO is not None:
            go = go + c_new * checkO
        h_new = act_gate(go) * act_cell(c_new)
        if with_projection:
            h_new = act_proj(h_new @ proj_w)
        h = torch.where(live[t], h_new, h)
        c = torch.where(live[t], c_new, c)
        hs.append(h)
        cs.append(c)
        gates_all.append(gates)
    # padded steps emit zeros: one mask over the stacked outputs
    out_live = live.transpose(0, 1)  # [B, T, 1]
    hidden = torch.where(out_live, torch.stack(hs, 1), 0.0)
    cell = torch.where(out_live, torch.stack(cs, 1), 0.0)
    if is_reverse:
        hidden = reverse_valid_prefix(hidden, lens)
        cell = reverse_valid_prefix(cell, lens)
    out_slot = "Projection" if with_projection else "Hidden"
    ctx.out(op_, out_slot, hidden)
    ctx.out(op_, "Cell", cell)
    ctx.out(op_, "BatchGate", torch.stack(gates_all, 1))
    ctx.out(op_, "BatchCellPreAct", cell)
    names = op_.outputs.get(out_slot) or []
    if names:
        ctx.set(names[0] + SEQ_LEN, lens)


def _lstm_infer(op_, block):
    x = in_var(op_, block, "Input")
    if x is None or len(x.shape) != 3:
        raise SkipInferShape()
    B, T, D4 = x.shape
    set_out(op_, block, "Hidden", (B, T, D4 // 4), x.dtype)
    set_out(op_, block, "Cell", (B, T, D4 // 4), x.dtype)


@op("lstm", infer_shape=_lstm_infer, grad="generic")
def _lstm(ctx, op_):
    _lstm_impl(ctx, op_, with_projection=False)


@op("lstmp", grad="generic")
def _lstmp(ctx, op_):
    _lstm_impl(ctx, op_, with_projection=True)


@op("lstm_unit", grad="generic")
def _lstm_unit(ctx, op_):
    """One step; gate layout [i, f, o, g] (``lstm_unit_op.h:63-71``)."""
    x = ctx.in1(op_, "X")  # [B, 4D]
    c_prev = ctx.in1(op_, "C_prev")
    fb = float(op_.attr("forget_bias", 0.0))
    D = x.shape[1] // 4
    i = torch.sigmoid(x[:, :D])
    f = torch.sigmoid(x[:, D:2 * D] + fb)
    o = torch.sigmoid(x[:, 2 * D:3 * D])
    g = torch.tanh(x[:, 3 * D:])
    c = f * c_prev + i * g
    ctx.out(op_, "C", c)
    ctx.out(op_, "H", o * torch.tanh(c))


def _gru_math(gates_xt, h_prev, w, D, act_gate, act_cand, origin_mode):
    """One GRU step from the input's pre-activations [B, 3D] and the carry
    [B, D] (``gru_kernel.h`` gru_resetOutput / gru_finalOutput)."""
    ur = gates_xt[:, :2 * D] + h_prev @ w[:, :2 * D]
    u = act_gate(ur[:, :D])
    r = act_gate(ur[:, D:])
    reset_h = r * h_prev
    c = act_cand(gates_xt[:, 2 * D:] + reset_h @ w[:, 2 * D:])
    if origin_mode:
        h = u * h_prev + c - u * c
    else:
        h = h_prev - u * h_prev + u * c
    return h, u, r, reset_h, c


@op("gru", grad="generic")
def _gru(ctx, op_):
    x = ctx.in1(op_, "Input")  # [B, T, 3D] (x @ Wx done by an fc)
    w = ctx.in1(op_, "Weight")  # [D, 3D]
    bias = ctx.in1(op_, "Bias", optional=True)
    h0 = ctx.in1(op_, "H0", optional=True)
    B, T = x.shape[0], x.shape[1]
    D = w.shape[0]
    act_gate = _act(op_.attr("gate_activation", "sigmoid"))
    act_cand = _act(op_.attr("activation", "tanh"))
    origin_mode = bool(op_.attr("origin_mode", False))
    is_reverse = bool(op_.attr("is_reverse", False))
    lens = _seq_lens(ctx, op_, "Input", B, T, x.device)
    if bias is not None:
        x = x + bias.reshape(1, 1, -1)
    if is_reverse:
        x = reverse_valid_prefix(x, lens)
    h = h0 if h0 is not None else x.new_zeros((B, D))
    live = _live_steps(lens, T)
    hs, resets = [], []
    for t in range(T):
        h_new, _u, _r, reset_h, _c = _gru_math(
            x[:, t], h, w, D, act_gate, act_cand, origin_mode)
        h = torch.where(live[t], h_new, h)
        hs.append(h)
        resets.append(reset_h)
    hidden = torch.where(live.transpose(0, 1), torch.stack(hs, 1), 0.0)
    if is_reverse:
        hidden = reverse_valid_prefix(hidden, lens)
    ctx.out(op_, "Hidden", hidden)
    ctx.out(op_, "BatchHidden", hidden)
    ctx.out(op_, "BatchResetHiddenPrev", torch.stack(resets, 1))
    names = op_.outputs.get("Hidden") or []
    if names:
        ctx.set(names[0] + SEQ_LEN, lens)


# activation attrs of gru_unit are the proto's enum ints
# (``gru_unit_op.cc``): 0 identity, 1 sigmoid, 2 tanh, 3 relu
_ACT_ENUM = {0: "identity", 1: "sigmoid", 2: "tanh", 3: "relu"}


def _act_of(v, default):
    if isinstance(v, str) or v is None:
        return _act(v or default)
    return _act(_ACT_ENUM.get(int(v), default))


@op("gru_unit", grad="generic")
def _gru_unit(ctx, op_):
    x = ctx.in1(op_, "Input")  # [B, 3D]
    h_prev = ctx.in1(op_, "HiddenPrev")
    w = ctx.in1(op_, "Weight")
    bias = ctx.in1(op_, "Bias", optional=True)
    act_gate = _act_of(op_.attr("gate_activation", 1), "sigmoid")
    act_cand = _act_of(op_.attr("activation", 2), "tanh")
    if bias is not None:
        x = x + bias.reshape(1, -1)
    h, u, r, reset_h, c = _gru_math(
        x, h_prev, w, w.shape[0], act_gate, act_cand,
        bool(op_.attr("origin_mode", False)))
    ctx.out(op_, "Gate", torch.cat([u, r, c], dim=1))
    ctx.out(op_, "ResetHiddenPrev", reset_h)
    ctx.out(op_, "Hidden", h)
