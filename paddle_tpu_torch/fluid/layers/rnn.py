"""The cell API and beam-search decoding (port of
``paddle_tpu/fluid/layers/rnn.py:29-553``; reference
python/paddle/fluid/layers/rnn.py RNNCell:36, GRUCell:166, LSTMCell:255,
rnn:351, Decoder:480, BeamSearchDecoder:576, dynamic_decode:1028).

``rnn`` appends one ``recurrent`` op whose sub-block holds the cell's
graph, and ``dynamic_decode`` one ``dynamic_decode`` op over the
decoder's step; the ops run the loops (``ops/rnn_ops.py``).
"""

import numpy as np

from .. import unique_name
from ..framework import default_main_program
from ..layer_helper import LayerHelper
from . import control_flow, nn, ops, tensor
from . import utils


__all__ = [
    "RNNCell", "GRUCell", "LSTMCell", "rnn", "Decoder",
    "BeamSearchDecoder", "dynamic_decode",
]


class RNNCell(object):
    """Base class: ``call(inputs, states)`` -> (outputs, new_states)."""

    def call(self, inputs, states, **kwargs):
        raise NotImplementedError()

    def __call__(self, inputs, states, **kwargs):
        return self.call(inputs, states, **kwargs)

    @property
    def state_shape(self):
        raise NotImplementedError()

    def get_initial_states(self, batch_ref, shape=None, dtype="float32",
                           init_value=0.0, batch_dim_idx=0):
        """Zero states shaped like ``state_shape`` with the batch dim taken
        from ``batch_ref`` (reference: rnn.py RNNCell.get_initial_states)."""
        ref = utils.flatten(batch_ref)[0]
        shapes = shape if shape is not None else self.state_shape

        def _is_shape(s):
            return isinstance(s, (list, tuple)) and all(
                isinstance(e, int) for e in s
            )

        def _one(s):
            return tensor.fill_constant_batch_size_like(
                input=ref, shape=[-1] + list(s), dtype=dtype,
                value=init_value, input_dim_idx=batch_dim_idx,
            )

        def _walk(s):
            if _is_shape(s):
                return _one(s)
            return type(s)(_walk(e) for e in s)

        return _walk(shapes)


class GRUCell(RNNCell):
    """reference: layers/rnn.py:166 GRUCell."""

    def __init__(self, hidden_size, param_attr=None, bias_attr=None,
                 gate_activation=None, activation=None, dtype="float32",
                 name="GRUCell"):
        self.hidden_size = hidden_size
        self._param_attr = param_attr
        self._bias_attr = bias_attr
        self._dtype = dtype
        self._name = name

    def call(self, inputs, states):
        h = states
        xh = tensor.concat([inputs, h], axis=-1)
        gates = nn.fc(
            input=xh, size=2 * self.hidden_size, act="sigmoid",
            name="%s_gates" % self._name, param_attr=self._param_attr,
            bias_attr=self._bias_attr,
        )
        r, z = nn.split(gates, 2, dim=-1)
        rh = nn.elementwise_mul(r, h)
        c = nn.fc(
            input=tensor.concat([inputs, rh], axis=-1),
            size=self.hidden_size, act="tanh",
            name="%s_cand" % self._name, param_attr=self._param_attr,
            bias_attr=self._bias_attr,
        )
        one = tensor.fill_constant(shape=[1], dtype=self._dtype, value=1.0)
        new_h = nn.elementwise_add(
            nn.elementwise_mul(nn.elementwise_sub(one, z), h),
            nn.elementwise_mul(z, c),
        )
        return new_h, new_h

    @property
    def state_shape(self):
        return [self.hidden_size]


class LSTMCell(RNNCell):
    """reference: layers/rnn.py:255 LSTMCell; states = [h, c]."""

    def __init__(self, hidden_size, param_attr=None, bias_attr=None,
                 gate_activation=None, activation=None, forget_bias=1.0,
                 dtype="float32", name="LSTMCell"):
        self.hidden_size = hidden_size
        self._param_attr = param_attr
        self._bias_attr = bias_attr
        self._forget_bias = float(forget_bias)
        self._dtype = dtype
        self._name = name

    def call(self, inputs, states):
        h, c = states
        xh = tensor.concat([inputs, h], axis=-1)
        gates = nn.fc(
            input=xh, size=4 * self.hidden_size,
            name="%s_gates" % self._name, param_attr=self._param_attr,
            bias_attr=self._bias_attr,
        )
        i, f, ct, o = nn.split(gates, 4, dim=-1)
        fb = tensor.fill_constant(
            shape=[1], dtype=self._dtype, value=self._forget_bias
        )
        new_c = nn.elementwise_add(
            nn.elementwise_mul(
                ops.sigmoid(nn.elementwise_add(f, fb)), c
            ),
            nn.elementwise_mul(ops.sigmoid(i), ops.tanh(ct)),
        )
        new_h = nn.elementwise_mul(ops.sigmoid(o), ops.tanh(new_c))
        return new_h, [new_h, new_c]

    @property
    def state_shape(self):
        return [[self.hidden_size], [self.hidden_size]]


def _enter_sub_block():
    main = default_main_program()
    parent = main.current_block()
    sub = main._create_block()
    return main, parent, sub


def _make_step_var(sub, ref_shape, dtype, hint):
    return sub.create_var(
        name=unique_name.generate(hint), shape=tuple(ref_shape), dtype=dtype
    )


def _external_reads(sub, bound_names):
    """Outer var names read by the sub-block graph (parameters etc.)."""
    from ..executor import _analyze_ops

    reads, _ = _analyze_ops(sub.ops)
    bound = set(bound_names)
    return [n for n in reads if n not in bound]


def rnn(cell, inputs, initial_states=None, sequence_length=None,
        time_major=False, is_reverse=False, **kwargs):
    """Run ``cell`` over the time axis of ``inputs``; returns
    (final_outputs, final_states) (reference: layers/rnn.py:351)."""
    inputs_list = utils.flatten(inputs)
    if initial_states is None:
        initial_states = cell.get_initial_states(
            inputs_list[0], batch_dim_idx=1 if time_major else 0
        )
    states_list = utils.flatten(initial_states)

    main, parent, sub = _enter_sub_block()
    try:
        time_axis = 0 if time_major else 1
        step_vars = []
        for x in inputs_list:
            shp = tuple(
                s for i, s in enumerate(x.shape) if i != time_axis
            )
            step_vars.append(_make_step_var(sub, shp, x.dtype, "rnn_x"))
        state_vars = [
            _make_step_var(sub, s.shape, s.dtype, "rnn_h")
            for s in states_list
        ]
        cell_inputs = (
            step_vars[0] if not utils.is_sequence(inputs) else list(step_vars)
        )
        # rebuild the nested state structure around the flat step vars
        flat_iter = iter(state_vars)
        cell_states = utils.map_structure(
            lambda _: next(flat_iter), initial_states
        )
        outputs, new_states = cell.call(cell_inputs, cell_states, **kwargs)
        out_list = utils.flatten(outputs)
        new_states_list = utils.flatten(new_states)
    finally:
        main._rollback()

    bound = [v.name for v in step_vars] + [v.name for v in state_vars]
    params = [
        n for n in _external_reads(sub, bound)
        if parent._find_var_recursive(n) is not None
    ]

    helper = LayerHelper("rnn")
    stacked = [
        helper.create_variable_for_type_inference(o.dtype) for o in out_list
    ]
    finals = [
        helper.create_variable_for_type_inference(s.dtype)
        for s in states_list
    ]
    inputs_map = {
        "Inputs": [v.name for v in inputs_list],
        "InitStates": [v.name for v in states_list],
        "Parameters": params,
    }
    if sequence_length is not None:
        inputs_map["SequenceLength"] = [sequence_length.name]
    parent.append_op(
        type="recurrent",
        inputs=inputs_map,
        outputs={
            "Outputs": [v.name for v in stacked],
            "FinalStates": [v.name for v in finals],
        },
        attrs={
            "sub_block": sub.idx,
            "step_input_names": [v.name for v in step_vars],
            "state_input_names": [v.name for v in state_vars],
            "state_output_names": [v.name for v in new_states_list],
            "step_output_names": [v.name for v in out_list],
            "time_major": time_major,
            "is_reverse": is_reverse,
        },
    )
    final_outputs = (
        stacked[0] if len(stacked) == 1 and not utils.is_sequence(outputs)
        else stacked
    )
    flat_iter2 = iter(finals)
    final_states = utils.map_structure(
        lambda _: next(flat_iter2), new_states
    )
    return final_outputs, final_states


def dynamic_lstm_rnn(input, hidden_size, sequence_length=None, **kw):
    """Convenience: LSTM over padded [N,T,D] input."""
    cell = LSTMCell(hidden_size)
    return rnn(cell, input, sequence_length=sequence_length, **kw)


def dynamic_gru_rnn(input, hidden_size, sequence_length=None, **kw):
    cell = GRUCell(hidden_size)
    return rnn(cell, input, sequence_length=sequence_length, **kw)


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------
class Decoder(object):
    """reference: layers/rnn.py:480."""

    def initialize(self, inits):
        raise NotImplementedError()

    def step(self, time, inputs, states, **kwargs):
        raise NotImplementedError()

    def finalize(self, outputs, final_states, sequence_lengths):
        raise NotImplementedError()


class BeamSearchDecoder(Decoder):
    """Beam search over an RNNCell (reference: layers/rnn.py:576).

    States carried through the loop: [cell_states..., log_probs, finished].
    ``step`` emits (token_ids, parent_ids) per step; ``finalize`` backtracks
    with ``gather_tree``.
    """

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn
        # steps past early loop exit read from the buffers' initial values:
        # tokens as end_token, parents as the identity beam (arange), so
        # gather_tree keeps each beam's own ancestry on unexecuted steps
        self.output_tail_spec = ([float(self.end_token), 0.0], [False, True])

    # -- beam layout helpers (reference: BeamSearchDecoder.tile_beam_*) --
    def _expand_to_beam(self, x):
        """[N, ...] -> [N*beam, ...] replicating each row beam times."""
        x = nn.unsqueeze(x, axes=[1])
        expand_times = [1, self.beam_size] + [1] * (len(x.shape) - 2)
        x = nn.expand(x, expand_times=expand_times)
        return nn.reshape(x, shape=[-1] + list(x.shape[2:]))

    def initialize(self, inits):
        """``inits``: initial cell states (e.g. encoder final state)."""
        cell_states = utils.flatten(inits)
        batch_ref = cell_states[0]
        expanded = [self._expand_to_beam(s) for s in cell_states]
        # log_probs: beam 0 = 0, others = -inf so step 1 picks from beam 0
        lp_row = np.array(
            [0.0] + [-1e9] * (self.beam_size - 1), dtype="float32"
        )
        lp = tensor.assign(lp_row.reshape(1, -1))
        log_probs = nn.elementwise_add(
            tensor.fill_constant_batch_size_like(
                batch_ref, shape=[-1, self.beam_size], dtype="float32",
                value=0.0,
            ),
            lp,
        )
        finished = tensor.fill_constant_batch_size_like(
            batch_ref, shape=[-1, self.beam_size], dtype="float32", value=0.0
        )
        start = tensor.fill_constant_batch_size_like(
            batch_ref, shape=[-1, self.beam_size], dtype="int64",
            value=self.start_token,
        )
        start_flat = nn.reshape(start, shape=[-1, 1])
        inputs = (
            self.embedding_fn(start_flat)
            if self.embedding_fn is not None
            else start_flat
        )
        inputs = nn.reshape(
            inputs, shape=[-1] + list(inputs.shape[2:])
        ) if len(inputs.shape) > 2 else inputs
        states = list(expanded) + [log_probs]
        return inputs, states, finished

    def step(self, time, inputs, states, **kwargs):
        cell_states, log_probs = list(states[:-1]), states[-1]
        finished = kwargs["finished"]  # [N, beam] float 0/1
        beam = self.beam_size

        cell_state_arg = (
            cell_states[0] if len(cell_states) == 1 else cell_states
        )
        cell_out, new_cell_states = self.cell.call(inputs, cell_state_arg)
        logits = (
            self.output_fn(cell_out) if self.output_fn is not None else cell_out
        )  # [N*beam, V]
        vocab = logits.shape[-1]
        step_lp = nn.log_softmax(logits)  # [N*beam, V]
        step_lp = nn.reshape(step_lp, shape=[-1, beam, vocab])

        # finished beams: only end_token continues, with prob 0
        noend = np.full((1, 1, vocab), -1e9, dtype="float32")
        noend[0, 0, self.end_token] = 0.0
        noend_t = tensor.assign(noend)
        fin3 = nn.unsqueeze(finished, axes=[2])  # [N, beam, 1]
        one = tensor.fill_constant(shape=[1], dtype="float32", value=1.0)
        step_lp = nn.elementwise_add(
            nn.elementwise_mul(step_lp, nn.elementwise_sub(one, fin3)),
            nn.elementwise_mul(noend_t, fin3),
        )

        total = nn.elementwise_add(step_lp, nn.unsqueeze(log_probs, axes=[2]))
        flat = nn.reshape(total, shape=[-1, beam * vocab])
        top_scores, top_idx = nn.topk(flat, k=beam)  # [N, beam]

        vocab_c = tensor.fill_constant(
            shape=[1], dtype=top_idx.dtype, value=vocab
        )
        parent = nn.elementwise_floordiv(top_idx, vocab_c)  # beam index
        token = nn.elementwise_mod(top_idx, vocab_c)

        # gather cell states / finished along the chosen parent beams:
        # flat_idx = batch_offset*beam + parent
        batch_pos = ops.cumsum(
            tensor.fill_constant_batch_size_like(
                log_probs, shape=[-1, 1], dtype="int64", value=1
            ),
            axis=0, exclusive=True,
        )  # [N,1] = 0..N-1
        beam_c = tensor.fill_constant(
            shape=[1], dtype="int64", value=beam
        )
        flat_idx = nn.reshape(
            nn.elementwise_add(
                nn.elementwise_mul(batch_pos, beam_c), parent
            ),
            shape=[-1],
        )  # [N*beam]
        new_cell_states = [
            nn.gather(s, flat_idx) for s in utils.flatten(new_cell_states)
        ]
        prev_fin = nn.reshape(finished, shape=[-1])
        gathered_fin = nn.gather(prev_fin, flat_idx)
        gathered_fin = nn.reshape(gathered_fin, shape=[-1, beam])

        end_c = tensor.fill_constant(shape=[1], dtype=token.dtype,
                                     value=self.end_token)
        is_end = tensor.cast(control_flow.equal(token, end_c), "float32")
        next_finished = nn.clip(
            nn.elementwise_add(gathered_fin, is_end), 0.0, 1.0
        )

        token_flat = nn.reshape(token, shape=[-1, 1])
        next_inputs = (
            self.embedding_fn(token_flat)
            if self.embedding_fn is not None
            else tensor.cast(token_flat, "float32")
        )
        next_inputs = nn.reshape(
            next_inputs, shape=[-1] + list(next_inputs.shape[2:])
        ) if len(next_inputs.shape) > 2 else next_inputs

        next_states = list(new_cell_states) + [top_scores]
        outputs = [token, parent]
        return outputs, next_states, next_inputs, next_finished

    def finalize(self, outputs, final_states, sequence_lengths):
        """Backtrack (token, parent) traces -> full beams."""
        token_ids, parent_ids = outputs  # [N, T, beam]
        helper = LayerHelper("gather_tree")
        out = helper.create_variable_for_type_inference(token_ids.dtype)
        helper.append_op(
            type="gather_tree",
            inputs={"Ids": [token_ids], "Parents": [parent_ids]},
            outputs={"Out": [out]},
        )
        return out, final_states


def dynamic_decode(decoder, inits=None, max_step_num=None,
                   output_time_major=False, **kwargs):
    """Run ``decoder`` until all sequences finish or ``max_step_num`` steps
    (reference: layers/rnn.py:1028). ``max_step_num`` is required: it
    bounds the loop (the op stops early when every beam finishes, and
    fills the steps it did not run with the decoder's tail values)."""
    if max_step_num is None:
        raise ValueError(
            "dynamic_decode requires max_step_num (bounded loop)"
        )
    initial_inputs, initial_states, initial_finished = decoder.initialize(
        inits
    )
    states_list = utils.flatten(initial_states)
    inputs_list = utils.flatten(initial_inputs)

    main, parent, sub = _enter_sub_block()
    try:
        time_var = _make_step_var(sub, (), np.int32, "dec_t")
        in_vars = [
            _make_step_var(sub, v.shape, v.dtype, "dec_in")
            for v in inputs_list
        ]
        st_vars = [
            _make_step_var(sub, v.shape, v.dtype, "dec_st")
            for v in states_list
        ]
        fin_var = _make_step_var(
            sub, initial_finished.shape, initial_finished.dtype, "dec_fin"
        )
        flat_iter = iter(st_vars)
        st_struct = utils.map_structure(
            lambda _: next(flat_iter), initial_states
        )
        step_inputs = (
            in_vars[0]
            if len(in_vars) == 1 and not utils.is_sequence(initial_inputs)
            else list(in_vars)
        )
        outputs, next_states, next_inputs, next_finished = decoder.step(
            time_var, step_inputs, st_struct, finished=fin_var, **kwargs
        )
        out_list = utils.flatten(outputs)
        next_states_list = utils.flatten(next_states)
        next_inputs_list = utils.flatten(next_inputs)
    finally:
        main._rollback()

    bound = (
        [time_var.name, fin_var.name]
        + [v.name for v in in_vars]
        + [v.name for v in st_vars]
    )
    params = [
        n for n in _external_reads(sub, bound)
        if parent._find_var_recursive(n) is not None
    ]

    tail_spec = getattr(decoder, "output_tail_spec", None)
    tail_fill, tail_arange = tail_spec if tail_spec else ([], [])

    helper = LayerHelper("dynamic_decode")
    stacked = [
        helper.create_variable_for_type_inference(o.dtype) for o in out_list
    ]
    finals = [
        helper.create_variable_for_type_inference(s.dtype)
        for s in states_list
    ]
    length = helper.create_variable_for_type_inference(np.int32)
    parent.append_op(
        type="dynamic_decode",
        inputs={
            "InitInputs": [v.name for v in inputs_list],
            "InitStates": [v.name for v in states_list],
            "InitFinished": [initial_finished.name],
            "Parameters": params,
        },
        outputs={
            "Outputs": [v.name for v in stacked],
            "FinalStates": [v.name for v in finals],
            "Length": [length.name],
        },
        attrs={
            "sub_block": sub.idx,
            "time_name": time_var.name,
            "input_names": [v.name for v in in_vars],
            "state_input_names": [v.name for v in st_vars],
            "finished_name": fin_var.name,
            "step_output_names": [v.name for v in out_list],
            "next_input_names": [v.name for v in next_inputs_list],
            "state_output_names": [v.name for v in next_states_list],
            "next_finished_name": next_finished.name,
            "max_step_num": int(max_step_num),
            "output_tail_fill": list(tail_fill),
            "output_tail_arange": list(tail_arange),
        },
    )
    outputs_struct = (
        stacked[0]
        if len(stacked) == 1 and not utils.is_sequence(out_list)
        else stacked
    )
    if hasattr(decoder, "finalize"):
        try:
            outputs_struct, finals = decoder.finalize(
                outputs_struct, finals, length
            )
        except NotImplementedError:
            pass
    return outputs_struct, finals
