"""Transformer NMT, encoder-decoder (port of
``paddle_tpu/models/transformer.py``; BASELINE.json config 5). Program
builders under the reference's names over the BERT pieces
(``multi_head_attention``, ``_ffn``, ``_dropout``, ``mask_to_bias``,
``mask_to_key_bias``): ``build_transformer_train`` (label-smoothed loss
under the Noam schedule, Adam) and ``build_transformer_infer`` (one
fixed-shape program of next-token logits), and ``beam_search_decode``,
the reference's beam search on the host in numpy over ``exe.run`` of the
inference program.

With ``use_flash_attention`` the encoder's self-attention (non-causal,
key bias), the decoder's self-attention (causal, key bias) and the
cross-attention (target queries against source keys, key bias) each run
as one ``flash_attention`` op. Padding then rides a key-only bias, where
the dense masks also blank padded query rows, so the two forms differ at
padded target rows; the masked loss and its gradients agree.
"""

import math

import numpy as np

from .. import fluid
from ..fluid.layers.learning_rate_scheduler import noam_decay
from .bert import (multi_head_attention, _ffn, _dropout, mask_to_bias,
                   mask_to_key_bias)

__all__ = ["TransformerConfig", "transformer", "build_transformer_train",
           "build_transformer_infer", "beam_search_decode"]


class TransformerConfig(object):
    """Transformer-base's widths (6 + 6 layers, hidden 512, 8 heads, FFN
    2048, vocabularies of 30000, ``max_len`` 256); ``tiny()`` a 2-layer
    width-64 model for tests (``transformer.py:18``)."""

    def __init__(self, src_vocab=30000, tgt_vocab=30000, hidden_size=512,
                 num_heads=8, num_layers=6, intermediate_size=2048,
                 max_len=256, dropout=0.1, label_smooth=0.1, is_test=False,
                 use_flash_attention=False):
        self.src_vocab = src_vocab
        self.tgt_vocab = tgt_vocab
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.num_layers = num_layers
        self.intermediate_size = intermediate_size
        self.max_len = max_len
        self.dropout = dropout
        self.label_smooth = label_smooth
        self.is_test = is_test
        self.use_flash_attention = use_flash_attention
        # bert.multi_head_attention reads these names:
        self.hidden_dropout = dropout
        self.attention_dropout = dropout

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("src_vocab", 1000)
        kw.setdefault("tgt_vocab", 1000)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("num_heads", 4)
        kw.setdefault("num_layers", 2)
        kw.setdefault("intermediate_size", 128)
        kw.setdefault("max_len", 32)
        return cls(**kw)


def _pos_encoding_table(max_len, d_model):
    """The sinusoid table [max_len, d_model], fp32 (sin on even dims, cos
    on odd)."""
    pos = np.arange(max_len)[:, None].astype("float64")
    dim = np.arange(d_model)[None, :].astype("float64")
    angle = pos / np.power(10000.0, 2 * (dim // 2) / d_model)
    table = np.zeros((max_len, d_model), dtype="float32")
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


def _embed(ids, pos_ids, vocab, cfg, name):
    """Word embedding · sqrt(hidden) + the frozen sinusoid position
    embedding, then dropout."""
    emb = fluid.layers.embedding(
        input=ids, size=[vocab, cfg.hidden_size],
        param_attr=fluid.ParamAttr(name="%s_word_emb" % name))
    emb = fluid.layers.elementwise_mul(
        emb, fluid.layers.fill_constant(
            shape=[1], dtype="float32", value=math.sqrt(cfg.hidden_size)))
    pos = fluid.layers.embedding(
        input=pos_ids, size=[cfg.max_len, cfg.hidden_size],
        param_attr=fluid.ParamAttr(
            name="%s_pos_emb" % name,
            initializer=fluid.initializer.NumpyArrayInitializer(
                _pos_encoding_table(cfg.max_len, cfg.hidden_size)),
            trainable=False))
    pos.stop_gradient = True
    emb = fluid.layers.elementwise_add(emb, pos)
    return _dropout(emb, cfg.dropout, cfg.is_test)


def _residual_ln(x, sub, cfg, name):
    sub = _dropout(sub, cfg.dropout, cfg.is_test)
    return fluid.layers.layer_norm(
        fluid.layers.elementwise_add(x, sub), begin_norm_axis=2, name=name)


def transformer(cfg, src_ids, src_pos, src_mask, tgt_ids, tgt_pos, tgt_mask,
                causal_mask):
    """The forward; returns the decoder's logits [N, T, tgt_vocab].

    ``src_mask`` / ``tgt_mask`` [N, S, 1] float (1 on a real token);
    ``causal_mask`` [1, T, T] the lower-triangular ones."""
    src_self = fluid.layers.matmul(
        src_mask, fluid.layers.transpose(src_mask, perm=[0, 2, 1]))
    enc_bias = mask_to_bias(src_self)
    # key-only padding biases for the flash path: encoder and cross keys
    # are source positions, the decoder's self-attention keys target
    # positions, with causality on the kernel's flag
    src_key_bias = tgt_key_bias = None
    if getattr(cfg, "use_flash_attention", False):
        src_key_bias = mask_to_key_bias(src_mask)
        tgt_key_bias = mask_to_key_bias(tgt_mask)
    enc = _embed(src_ids, src_pos, cfg.src_vocab, cfg, "src")
    for i in range(cfg.num_layers):
        name = "enc_%d" % i
        attn = multi_head_attention(enc, enc, enc_bias, cfg, name + "_att",
                                    key_bias=src_key_bias)
        enc = _residual_ln(enc, attn, cfg, name + "_ln1")
        enc = _residual_ln(enc, _ffn(enc, cfg, name + "_ffn"), cfg,
                           name + "_ln2")

    tgt_self = fluid.layers.matmul(
        tgt_mask, fluid.layers.transpose(tgt_mask, perm=[0, 2, 1]))
    tgt_self = fluid.layers.elementwise_mul(tgt_self, causal_mask)
    dec_self_bias = mask_to_bias(tgt_self)
    # cross mask: [N, T, 1] x [N, 1, S]
    cross = fluid.layers.matmul(
        tgt_mask, fluid.layers.transpose(src_mask, perm=[0, 2, 1]))
    cross_bias = mask_to_bias(cross)

    dec = _embed(tgt_ids, tgt_pos, cfg.tgt_vocab, cfg, "tgt")
    for i in range(cfg.num_layers):
        name = "dec_%d" % i
        attn = multi_head_attention(dec, dec, dec_self_bias, cfg,
                                    name + "_satt", key_bias=tgt_key_bias,
                                    causal=True)
        dec = _residual_ln(dec, attn, cfg, name + "_ln1")
        xatt = multi_head_attention(dec, enc, cross_bias, cfg, name + "_xatt",
                                    key_bias=src_key_bias)
        dec = _residual_ln(dec, xatt, cfg, name + "_ln2")
        dec = _residual_ln(dec, _ffn(dec, cfg, name + "_ffn"), cfg,
                           name + "_ln3")

    return fluid.layers.fc(input=dec, size=cfg.tgt_vocab, num_flatten_dims=2,
                           name="dec_proj")


def build_transformer_train(cfg, src_len, tgt_len, learning_rate=2.0,
                            warmup_steps=4000):
    """(main, startup, feeds, avg_loss): the label-smoothed NMT loss over
    the real target tokens, minimised by Adam (β 0.9 / 0.98, ε 1e-9)
    under ``learning_rate`` × the Noam schedule (``transformer.py:163``)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        src_ids = fluid.layers.data(name="src_ids", shape=[src_len, 1],
                                    dtype="int64")
        src_pos = fluid.layers.data(name="src_pos", shape=[src_len, 1],
                                    dtype="int64")
        src_mask = fluid.layers.data(name="src_mask", shape=[src_len, 1],
                                     dtype="float32")
        tgt_ids = fluid.layers.data(name="tgt_ids", shape=[tgt_len, 1],
                                    dtype="int64")
        tgt_pos = fluid.layers.data(name="tgt_pos", shape=[tgt_len, 1],
                                    dtype="int64")
        tgt_mask = fluid.layers.data(name="tgt_mask", shape=[tgt_len, 1],
                                     dtype="float32")
        labels = fluid.layers.data(name="labels", shape=[tgt_len, 1],
                                   dtype="int64")
        causal = _causal_const(tgt_len)
        logits = transformer(cfg, src_ids, src_pos, src_mask, tgt_ids,
                             tgt_pos, tgt_mask, causal)
        flat = fluid.layers.reshape(logits, shape=[-1, cfg.tgt_vocab])
        lab = fluid.layers.reshape(labels, shape=[-1, 1])
        if cfg.label_smooth > 0:
            one_hot = fluid.layers.one_hot(lab, depth=cfg.tgt_vocab)
            smoothed = fluid.layers.label_smooth(label=one_hot,
                                                 epsilon=cfg.label_smooth)
            smoothed.stop_gradient = True
            loss = fluid.layers.softmax_with_cross_entropy(
                flat, smoothed, soft_label=True)
        else:
            loss = fluid.layers.softmax_with_cross_entropy(flat, lab)
        # mask out pad positions
        wmask = fluid.layers.reshape(tgt_mask, shape=[-1, 1])
        loss = fluid.layers.elementwise_mul(loss, wmask)
        avg_loss = fluid.layers.elementwise_div(
            fluid.layers.reduce_sum(loss), fluid.layers.reduce_sum(wmask))
        lr = noam_decay(cfg.hidden_size, warmup_steps)
        lr = fluid.layers.elementwise_mul(
            lr, fluid.layers.fill_constant(shape=[1], dtype="float32",
                                           value=float(learning_rate)))
        opt = fluid.optimizer.Adam(learning_rate=lr, beta1=0.9, beta2=0.98,
                                   epsilon=1e-9)
        opt.minimize(avg_loss)
    feeds = [src_ids, src_pos, src_mask, tgt_ids, tgt_pos, tgt_mask, labels]
    return main, startup, feeds, avg_loss


def _causal_const(tgt_len):
    table = np.tril(np.ones((tgt_len, tgt_len), dtype="float32"))[None]
    v = fluid.layers.assign(table)
    v.stop_gradient = True
    return v


def build_transformer_infer(cfg, src_len, tgt_len):
    """(program, feed names, logits [N, T, V]): next-token logits for a
    target prefix. Causality makes position t's logits depend only on
    ``tgt_ids[:t+1]``, so one fixed-shape program serves every decode
    step (``transformer.py:208``). Built under a fresh name scope, so its
    parameter names are those of a train program built in its own."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        src_ids = fluid.layers.data(name="src_ids", shape=[src_len, 1],
                                    dtype="int64")
        src_pos = fluid.layers.data(name="src_pos", shape=[src_len, 1],
                                    dtype="int64")
        src_mask = fluid.layers.data(name="src_mask", shape=[src_len, 1],
                                     dtype="float32")
        tgt_ids = fluid.layers.data(name="tgt_ids", shape=[tgt_len, 1],
                                    dtype="int64")
        tgt_pos = fluid.layers.data(name="tgt_pos", shape=[tgt_len, 1],
                                    dtype="int64")
        tgt_mask = fluid.layers.data(name="tgt_mask", shape=[tgt_len, 1],
                                     dtype="float32")
        causal = _causal_const(tgt_len)
        logits = transformer(cfg, src_ids, src_pos, src_mask, tgt_ids,
                             tgt_pos, tgt_mask, causal)
    feeds = ["src_ids", "src_pos", "src_mask", "tgt_ids", "tgt_pos",
             "tgt_mask"]
    return main, feeds, logits


def beam_search_decode(exe, infer_prog, logits, cfg, src, bos_id, eos_id,
                       beam_size=4, max_len=None, scope=None,
                       length_penalty=0.0, src_pad_id=None):
    """Beam search over the fixed-shape inference program, on the host in
    numpy as the reference's (``transformer.py:234``): log-probabilities
    summed along each beam, the first step expanding beam 0 alone, a
    finished beam extended only by ``eos_id`` at no cost, the top K of
    each row's K·V totals in ``np.argsort`` order, and the optional
    length penalty ((5 + len) / 6) ** ``length_penalty``.

    ``src`` [N, S] int64. Returns (sequences [N, beam, T] int64, scores
    [N, beam]) best first."""
    N, S = src.shape
    # the infer program's target length is baked into its shapes
    T = infer_prog.global_block().var("tgt_ids").shape[1]
    if max_len is not None and max_len != T:
        raise ValueError(
            "max_len=%d but the infer program was built with tgt_len=%d"
            % (max_len, T))
    K = beam_size
    V = cfg.tgt_vocab

    src_b = np.repeat(src, K, axis=0)  # [N*K, S]
    src_pos = np.tile(np.arange(S, dtype=np.int64), (N * K, 1))
    if src_pad_id is not None:  # variable-length sources padded with pad_id
        src_mask = (src_b != src_pad_id).astype("float32")
    else:
        src_mask = np.ones((N * K, S), "float32")

    seqs = np.full((N * K, T), eos_id, np.int64)
    seqs[:, 0] = bos_id
    scores = np.full((N, K), -1e9, np.float64)
    scores[:, 0] = 0.0  # first step expands only beam 0 (identical prefixes)
    finished = np.zeros((N, K), bool)

    for t in range(T - 1):
        feed = {
            "src_ids": src_b[..., None],
            "src_pos": src_pos[..., None],
            "src_mask": src_mask[..., None],
            "tgt_ids": seqs[..., None],
            "tgt_pos": np.tile(np.arange(T, dtype=np.int64),
                               (N * K, 1))[..., None],
            "tgt_mask": (np.arange(T) <= t)[None, :].repeat(N * K, 0).astype(
                "float32")[..., None],
        }
        (lg,) = exe.run(infer_prog, feed=feed, fetch_list=[logits],
                        scope=scope)
        lg = np.asarray(lg).reshape(N, K, T, V)[:, :, t, :]  # [N, K, V]
        logp = lg - np.log(np.exp(lg - lg.max(-1, keepdims=True)).sum(
            -1, keepdims=True)) - lg.max(-1, keepdims=True)
        # frozen beams only extend with eos at no cost
        logp = np.where(
            finished[..., None],
            np.where(np.arange(V)[None, None, :] == eos_id, 0.0, -1e9),
            logp)
        total = scores[..., None] + logp  # [N, K, V]
        flat = total.reshape(N, K * V)
        top = np.argsort(-flat, axis=1)[:, :K]  # [N, K]
        new_scores = np.take_along_axis(flat, top, axis=1)
        beam_idx = top // V
        tok = top % V
        new_seqs = np.empty_like(seqs.reshape(N, K, T))
        for n in range(N):
            new_seqs[n] = seqs.reshape(N, K, T)[n, beam_idx[n]]
            new_seqs[n, :, t + 1] = tok[n]
        seqs = new_seqs.reshape(N * K, T)
        finished = np.take_along_axis(finished, beam_idx, axis=1) | (
            tok == eos_id)
        scores = new_scores
        if finished.all():
            break

    if length_penalty > 0:
        lens = (seqs.reshape(N, K, T) != eos_id).sum(-1)
        scores = scores / ((5.0 + lens) / 6.0) ** length_penalty
    order = np.argsort(-scores, axis=1)
    seqs = np.take_along_axis(seqs.reshape(N, K, T), order[..., None], axis=1)
    scores = np.take_along_axis(scores, order, axis=1)
    return seqs, scores
