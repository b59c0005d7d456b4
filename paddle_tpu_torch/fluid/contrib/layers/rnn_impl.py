"""Multi-layer (bi)directional GRU/LSTM builders (copy of
``paddle_tpu/fluid/contrib/layers/rnn_impl.py``; reference
python/paddle/fluid/contrib/layers/rnn_impl.py basic_gru:139,
basic_lstm:358), composed from the cells of ``fluid.layers.rnn``
(``GRUCell`` / ``LSTMCell`` and ``rnn``: one ``recurrent`` op a layer and
direction)."""

# NOTE: ``from ...layers import rnn`` would pick up the star-exported
# rnn FUNCTION (package-attribute shadowing); import the module members
# by their full path instead
from ...layers.rnn import GRUCell, LSTMCell, rnn as _rnn_fn
from ...layers import nn as _nn
from ...layers.tensor import concat as _concat

__all__ = ["basic_gru", "basic_lstm", "BasicGRUUnit", "BasicLSTMUnit"]

# the per-step units are the shared RNN cells themselves
BasicGRUUnit = GRUCell
BasicLSTMUnit = LSTMCell


def _split_inits(init, num_layers, bidirectional):
    """[num_layers(*2), B, D] -> per-forward-layer initial states."""
    if init is None:
        return None
    from ...layers.nn import slice as _slice
    from ...layers.nn import squeeze as _squeeze

    per = 2 if bidirectional else 1
    outs = []
    for layer in range(num_layers):
        idx = layer * per
        outs.append(_squeeze(
            _slice(init, axes=[0], starts=[idx], ends=[idx + 1]),
            axes=[0],
        ))
    return outs


def _stack(input, hidden_size, num_layers, bidirectional, make_cell,
           sequence_length, dropout_prob, name, init_states):
    """-> (top outputs, [per-(layer,direction) final states])."""
    fw = input
    finals = []
    for layer in range(num_layers):
        init = None if init_states is None else init_states[layer]
        outs, fstate = _rnn_fn(
            make_cell("%s_fw_l%d" % (name, layer)), fw,
            initial_states=init, sequence_length=sequence_length,
        )
        finals.append(fstate)
        if bidirectional:
            bouts, bstate = _rnn_fn(
                make_cell("%s_bw_l%d" % (name, layer)), fw,
                sequence_length=sequence_length, is_reverse=True,
            )
            outs = _concat([outs, bouts], axis=-1)
            finals.append(bstate)
        if dropout_prob and layer < num_layers - 1:
            outs = _nn.dropout(outs, dropout_prob=dropout_prob)
        fw = outs
    return fw, finals


def basic_gru(input, init_hidden, hidden_size, num_layers=1,
              sequence_length=None, dropout_prob=0.0, bidirectional=False,
              batch_first=True, param_attr=None, bias_attr=None,
              gate_activation=None, activation=None, dtype="float32",
              name="basic_gru"):
    """reference contrib rnn_impl.py:139: stacked (bi)GRU;
    -> (rnn_out [B,T,D(*2)], last_hidden of the top forward layer).
    ``init_hidden``: optional [num_layers(*2), B, D], sliced per layer."""
    if not batch_first:
        input = _nn.transpose(input, perm=[1, 0, 2])
    inits = _split_inits(init_hidden, num_layers, bidirectional)
    out, finals = _stack(
        input, hidden_size, num_layers, bidirectional,
        lambda nm: GRUCell(hidden_size, param_attr=param_attr,
                           bias_attr=bias_attr,
                           gate_activation=gate_activation,
                           activation=activation, name=nm),
        sequence_length, dropout_prob, name, inits,
    )
    if not batch_first:
        out = _nn.transpose(out, perm=[1, 0, 2])
    return out, finals[-2 if bidirectional else -1]


def basic_lstm(input, init_hidden, init_cell, hidden_size, num_layers=1,
               sequence_length=None, dropout_prob=0.0, bidirectional=False,
               batch_first=True, param_attr=None, bias_attr=None,
               gate_activation=None, activation=None, forget_bias=1.0,
               dtype="float32", name="basic_lstm"):
    """reference contrib rnn_impl.py:358: stacked (bi)LSTM;
    -> (rnn_out, last_hidden, last_cell) of the top forward layer.
    ``init_hidden``/``init_cell``: optional [num_layers(*2), B, D]."""
    if not batch_first:
        input = _nn.transpose(input, perm=[1, 0, 2])
    inits = None
    if init_hidden is not None and init_cell is not None:
        hs = _split_inits(init_hidden, num_layers, bidirectional)
        cs = _split_inits(init_cell, num_layers, bidirectional)
        inits = [[h, c] for h, c in zip(hs, cs)]
    out, finals = _stack(
        input, hidden_size, num_layers, bidirectional,
        lambda nm: LSTMCell(hidden_size, param_attr=param_attr,
                            bias_attr=bias_attr,
                            gate_activation=gate_activation,
                            activation=activation,
                            forget_bias=forget_bias, name=nm),
        sequence_length, dropout_prob, name, inits,
    )
    if not batch_first:
        out = _nn.transpose(out, perm=[1, 0, 2])
    top = finals[-2 if bidirectional else -1]
    last_hidden, last_cell = top[0], top[1]
    return out, last_hidden, last_cell
