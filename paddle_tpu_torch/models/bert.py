"""The BERT encoder and sequence classifier, and the transformer pieces
the GPT serving and training paths share with it (port of
``paddle_tpu/models/bert.py``), in two forms.

Program builders under the reference's names, for the Fluid
Program/Executor path: ``BertConfig``, ``bert_encoder`` and
``build_bert_classifier`` (BASELINE.json's BERT-base headline model)
over ``encoder_layer``, ``mask_to_bias`` and ``multi_head_attention``
(the training/encoder form, flash or dense, and the serving programs'
KV-cache modes through the cache ops: ``prefill``, ``decode``,
``resume``, ``paged_window``, ``paged_step``), ``_ffn``, ``_dropout``
(the dropout layer) and ``flash_engages``.

Eager modules for serving and the eager train step: where a training
forward draws its random numbers (``DropoutRNG``), the eager dropout
helper ``_dropout_eager``, the FFN, and multi-head attention with
attention dropout in training and its KV-cache modes: ``prefill`` and
``decode`` and ``resume`` over the contiguous slot pool,
``paged_window`` and ``paged_step`` over the paged pool.

Both share the flash policy (``flash_wanted``) and the key-only padding
bias (``mask_to_key_bias``, which builds ops for a program variable and
computes for a tensor). The projections and the FFN are plain products,
as the reference left them to XLA outside any Pallas kernel; the score /
softmax / context chain goes through the flash ops, which run the
hand-written kernels on the card.
"""

import math

import torch
from torch import nn

from .. import fluid
from ..fluid.framework import Variable
from ..fluid.ops import math_ops, nn_ops

__all__ = [
    "BertConfig",
    "mask_to_bias",
    "encoder_layer",
    "bert_encoder",
    "build_bert_classifier",
    "FLASH_AUTO_SEQ_THRESHOLD",
    "flash_wanted",
    "flash_engages",
    "mask_to_key_bias",
    "multi_head_attention",
    "DropoutRNG",
    "FFN",
    "MultiHeadAttention",
]

# The reference's dense/flash crossover for use_flash_attention="auto",
# kept as it is; the H100's own (BERT-base step ms, dense vs flash at seq
# 128 and 384, chip_smoke.py's bert phase) is recorded in PERF.md.
FLASH_AUTO_SEQ_THRESHOLD = 1024


class BertConfig(object):
    """BERT's widths and training switches (``bert.py:18``); ``base()`` is
    BERT-base, ``tiny()`` a 2-layer width-64 model for tests.
    ``use_flash_attention``: True, False or "auto" (``flash_wanted``)."""

    def __init__(self, vocab_size=30522, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=3072,
                 max_position_embeddings=512, type_vocab_size=2,
                 hidden_dropout=0.1, attention_dropout=0.1, is_test=False,
                 use_flash_attention=False):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.hidden_dropout = hidden_dropout
        self.attention_dropout = attention_dropout
        self.is_test = is_test
        self.use_flash_attention = use_flash_attention

    @classmethod
    def base(cls, **kw):
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("vocab_size", 1024)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("num_layers", 2)
        kw.setdefault("num_heads", 4)
        kw.setdefault("intermediate_size", 128)
        kw.setdefault("max_position_embeddings", 64)
        return cls(**kw)


def flash_wanted(cfg, seq_len=None):
    """Resolve ``cfg.use_flash_attention`` (True/False/"auto") to a bool:
    "auto" fuses at or beyond ``cfg.flash_auto_threshold`` (default
    ``FLASH_AUTO_SEQ_THRESHOLD``) when the sequence length is known."""
    want = getattr(cfg, "use_flash_attention", False)
    if want == "auto":
        thr = getattr(cfg, "flash_auto_threshold", FLASH_AUTO_SEQ_THRESHOLD)
        want = seq_len is not None and seq_len >= thr
    return bool(want)


def flash_engages(cfg, key_bias, seq_len=None):
    """True when ``multi_head_attention`` will run the fused flash path:
    the policy wants it and the key-only mask it needs was built."""
    return bool(flash_wanted(cfg, seq_len) and key_bias is not None)


def mask_to_key_bias(mask):
    """[N, S, 1] (or [N, S]) 0/1 token mask -> key-only additive bias
    [N, S]: 0 where attendable, -1e4 on padded keys. A program variable
    gets the reference's ops (reshape, scale; no gradient), a tensor is
    computed."""
    if isinstance(mask, Variable):
        b = fluid.layers.scale(fluid.layers.reshape(mask, shape=[0, -1]),
                               scale=1e4, bias=-1e4)
        b.stop_gradient = True
        return b
    return mask.reshape(mask.shape[0], -1).float() * 1e4 - 1e4


def mask_to_bias(mask_2d):
    """[N, S, S] 0/1 attention mask -> additive bias [N, 1, S, S] (0 where
    attendable, -10000 where masked), broadcast over heads; no gradient
    (``bert.py:57``)."""
    neg = fluid.layers.elementwise_mul(
        fluid.layers.elementwise_add(
            mask_2d,
            fluid.layers.fill_constant(shape=[1], dtype="float32",
                                       value=-1.0)),
        fluid.layers.fill_constant(shape=[1], dtype="float32",
                                   value=10000.0))
    bias = fluid.layers.unsqueeze(neg, axes=[1])
    bias.stop_gradient = True
    return bias


class DropoutRNG(object):
    """Where a training forward draws its random numbers: ``masks``, a
    ``torch.Generator`` on the model's device for the dropout op's masks,
    and ``seeds``, a CPU generator for the flash kernel's per-layer
    dropout seeds, drawn as Python ints so that no draw waits on the card.
    Both seeded from ``seed``."""

    def __init__(self, device, seed=0):
        self.masks = torch.Generator(device=device).manual_seed(int(seed))
        self.seeds = torch.Generator().manual_seed(int(seed) + 1)


def _dropout(x, rate, is_test):
    """``bert._dropout`` (:51), program form: the dropout layer with its
    default ``downgrade_in_infer`` (x·mask in training, no upscale),
    skipped entirely at ``is_test`` or rate 0 — the reference's
    train/infer mismatch, kept as it is."""
    if is_test or rate <= 0.0:
        return x
    return fluid.layers.dropout(x, dropout_prob=rate)


def _dropout_eager(x, rate, is_test, rng=None):
    """``_dropout`` on a tensor: the dropout op's function, masks drawn
    from ``rng.masks`` (torch's default generator when ``rng`` is
    None)."""
    if is_test or rate <= 0.0:
        return x
    return nn_ops.dropout(x, dropout_prob=rate,
                          generator=None if rng is None else rng.masks)


def _apply_kv_cache(cache, k, v):
    """Write this call's split-head K/V into the cache ``cache``
    describes (``bert.py:122``) and return the (k, v) the attention that
    follows reads: the prompt's own K/V for ``prefill``; the slot's whole
    updated row for ``resume``; every slot's logical row gathered through
    its table for ``paged_window``; the updated caches or pools for
    ``decode`` and ``paged_step``. Every location is fed data."""
    mode = cache["mode"]
    if mode == "prefill":
        fluid.layers.kv_cache_write(cache["k"], k, cache["slot_idx"],
                                    slot_mode=True)
        fluid.layers.kv_cache_write(cache["v"], v, cache["slot_idx"],
                                    slot_mode=True)
        return k, v
    if mode == "resume":
        k_upd = fluid.layers.kv_cache_write(cache["k"], k, cache["slot_off"],
                                            slot_mode=True)
        v_upd = fluid.layers.kv_cache_write(cache["v"], v, cache["slot_off"],
                                            slot_mode=True)
        return (fluid.layers.kv_cache_gather(k_upd, cache["slot_off"]),
                fluid.layers.kv_cache_gather(v_upd, cache["slot_off"]))
    if mode in ("paged_window", "paged_step"):
        k_upd = fluid.layers.kv_cache_write_paged(
            cache["k"], k, cache["tables"], cache["pos"])
        v_upd = fluid.layers.kv_cache_write_paged(
            cache["v"], v, cache["tables"], cache["pos"])
        if mode == "paged_step":
            # the attention reads the pools through the tables itself
            return k_upd, v_upd
        return (fluid.layers.kv_cache_gather_paged(k_upd, cache["tables"]),
                fluid.layers.kv_cache_gather_paged(v_upd, cache["tables"]))
    if mode != "decode":
        raise ValueError("unknown KV-cache mode %r" % (mode,))
    return (fluid.layers.kv_cache_write(cache["k"], k, cache["pos"]),
            fluid.layers.kv_cache_write(cache["v"], v, cache["pos"]))


def _dense_over_rows(q, k, v, bias4, scale):
    """softmax(q·kᵀ·scale + bias4)·v, the fed bias taking no gradient."""
    bias4.stop_gradient = True
    scores = fluid.layers.matmul(q, k, transpose_y=True, alpha=scale)
    weights = fluid.layers.softmax(
        fluid.layers.elementwise_add(scores, bias4), axis=-1)
    return fluid.layers.matmul(weights, v)


def multi_head_attention(q_in, kv_in, attn_bias, cfg, name, key_bias=None,
                         causal=False, use_flash=None, cache=None):
    """Self/cross attention on [N, S, H] program variables, the
    reference's builder (``bert.py:185``): q/k/v fc projections split
    into heads, the attention, then the output projection.

    Without ``cache`` (training/encoder form): either ONE fused
    ``flash_attention`` op (``key_bias`` [N, S] carrying the padding
    mask, ``causal`` the kernel flag, attention dropout in the kernel) or
    the dense chain matmul → (+ ``attn_bias``) → softmax → dropout →
    matmul. ``use_flash`` is the builder's resolved policy (None
    re-resolves it from the static query length).

    ``cache`` (the serving programs): a dict with the layer's persistable
    ``k``/``v`` cache vars ([slots, heads, max_len, d_head], or the paged
    pools [blocks, heads, block, d_head]) and a ``mode``:

    - ``"prefill"``: the normal path over the prompt, which also writes
      its K/V into the row of slot ``slot_idx``;
    - ``"decode"``: each slot's token lands at its ``pos``, then the
      single query attends over the updated cache under ``key_bias``
      [slots, max_len] — the ``flash_decode_attention`` op when
      ``use_flash``, dense otherwise (``attn_bias``/``causal`` unused:
      the key bias is the causal mask);
    - ``"resume"`` / ``"paged_window"``: one window at a fed offset of a
      slot's row (through a block table for the paged pool) attends dense
      over the whole updated row under ``resume_bias`` [1, T, S] — dense
      by design, as in the reference: the causal flash kernel assumes an
      aligned q/k diagonal;
    - ``"paged_step"``: every slot's T-token window written through its
      table, then attended under ``step_bias`` [slots, T, S]: at T = 1
      with ``use_flash`` the ``flash_decode_paged_attention`` op reads
      the pools through the tables, otherwise (the width-k verify) the
      rows are gathered and attended dense."""
    d_head = cfg.hidden_size // cfg.num_heads

    def _proj(x, suffix):
        return fluid.layers.fc(input=x, size=cfg.hidden_size,
                               num_flatten_dims=2,
                               name="%s_%s" % (name, suffix))

    def _split_heads(x):
        # [N, S, H] -> [N, heads, S, d_head]
        x = fluid.layers.reshape(x, shape=[0, 0, cfg.num_heads, d_head])
        return fluid.layers.transpose(x, perm=[0, 2, 1, 3])

    q = _split_heads(_proj(q_in, "q"))
    k = _split_heads(_proj(kv_in, "k"))
    v = _split_heads(_proj(kv_in, "v"))
    if cache is not None:
        k, v = _apply_kv_cache(cache, k, v)
    mode = cache["mode"] if cache is not None else None
    scale = 1.0 / math.sqrt(d_head)
    interpret = getattr(cfg, "flash_interpret", False)
    if mode == "paged_step":
        if use_flash and q.shape[2] == 1:
            # the width-1 step: the kernel chases the tables, the logical
            # rows never materialize
            kb = fluid.layers.reshape(cache["step_bias"], shape=[0, -1])
            kb.stop_gradient = True
            ctxt = fluid.layers.flash_decode_paged_attention(
                q, cache["k"], cache["v"], cache["tables"], key_bias=kb,
                scale=scale, interpret=interpret)
        else:
            rows_k = fluid.layers.kv_cache_gather_paged(cache["k"],
                                                        cache["tables"])
            rows_v = fluid.layers.kv_cache_gather_paged(cache["v"],
                                                        cache["tables"])
            ctxt = _dense_over_rows(
                q, rows_k, rows_v,
                fluid.layers.unsqueeze(cache["step_bias"], axes=[1]), scale)
    elif mode in ("resume", "paged_window"):
        ctxt = _dense_over_rows(
            q, k, v, fluid.layers.unsqueeze(cache["resume_bias"], axes=[1]),
            scale)
    elif mode == "decode":
        if use_flash:
            ctxt = fluid.layers.flash_decode_attention(
                q, k, v, key_bias=cache["key_bias"], scale=scale,
                interpret=interpret)
        else:
            ctxt = _dense_over_rows(
                q, k, v,
                fluid.layers.reshape(cache["key_bias"], shape=[0, 1, 1, -1]),
                scale)
    else:
        ctxt = _attend(q, k, v, q_in, attn_bias, key_bias, causal, use_flash,
                       cfg, scale)
    ctxt = fluid.layers.transpose(ctxt, perm=[0, 2, 1, 3])
    ctxt = fluid.layers.reshape(ctxt, shape=[0, 0, cfg.hidden_size])
    return fluid.layers.fc(input=ctxt, size=cfg.hidden_size,
                           num_flatten_dims=2, name="%s_out" % name)


def _attend(q, k, v, q_in, attn_bias, key_bias, causal, use_flash, cfg,
            scale):
    """The training/encoder attention of ``multi_head_attention`` (also
    the prefill's, over the prompt's own K/V)."""
    if use_flash is None:
        _sq = q_in.shape[1] if len(q_in.shape) >= 2 else -1
        use_flash = flash_engages(
            cfg, key_bias, seq_len=None if _sq in (-1, None) else int(_sq))
    else:
        # the kernel still needs the key-side mask to ride along
        use_flash = bool(use_flash) and key_bias is not None
    if use_flash:
        return fluid.layers.flash_attention(
            q, k, v, key_bias=key_bias, causal=causal, scale=scale,
            dropout_rate=cfg.attention_dropout, is_test=cfg.is_test)
    scores = fluid.layers.matmul(q, k, transpose_y=True, alpha=scale)
    if attn_bias is not None:
        scores = fluid.layers.elementwise_add(scores, attn_bias)
    weights = fluid.layers.softmax(scores, axis=-1)
    weights = _dropout(weights, cfg.attention_dropout, cfg.is_test)
    return fluid.layers.matmul(weights, v)  # [N, heads, S, d_head]


def _ffn(x, cfg, name):
    """fc0 (GELU) -> fc1 on a program variable (``bert.py:383``)."""
    h = fluid.layers.fc(input=x, size=cfg.intermediate_size,
                        num_flatten_dims=2, act="gelu",
                        name="%s_fc0" % name)
    return fluid.layers.fc(input=h, size=cfg.hidden_size, num_flatten_dims=2,
                           name="%s_fc1" % name)


def encoder_layer(x, attn_bias, cfg, name, key_bias=None, use_flash=None):
    """One post-LN encoder layer (``bert.py:394``): self-attention,
    dropout, add and layer norm, then the FFN, dropout, add and layer
    norm."""
    attn = multi_head_attention(x, x, attn_bias, cfg, "%s_att" % name,
                                key_bias=key_bias, use_flash=use_flash)
    attn = _dropout(attn, cfg.hidden_dropout, cfg.is_test)
    x = fluid.layers.layer_norm(fluid.layers.elementwise_add(x, attn),
                                begin_norm_axis=2, name="%s_ln1" % name)
    ff = _dropout(_ffn(x, cfg, "%s_ffn" % name), cfg.hidden_dropout,
                  cfg.is_test)
    return fluid.layers.layer_norm(fluid.layers.elementwise_add(x, ff),
                                   begin_norm_axis=2, name="%s_ln2" % name)


def bert_encoder(src_ids, pos_ids, sent_ids, input_mask, cfg):
    """(sequence_output [N, S, H], pooled_output [N, H]) of the encoder
    (``bert.py:409``): word, position and sentence embeddings summed and
    layer-normed, ``num_layers`` encoder layers, and the pooler, a tanh
    fc over the first token. ``input_mask``: [N, S, 1] float32, 1.0 on
    real tokens.

    The flash policy is resolved once from the static sequence length and
    passed down to every layer. The dense bias (mask·maskᵀ, which masks
    padded query rows as well as keys) is built always, so a dense layer
    stays masked either way; the flash path takes the key-only bias,
    whose padded query rows differ from the dense path's but reach no
    loss term."""
    emb = fluid.layers.embedding(
        input=src_ids, size=[cfg.vocab_size, cfg.hidden_size],
        param_attr=fluid.ParamAttr(name="word_embedding"))
    pos = fluid.layers.embedding(
        input=pos_ids, size=[cfg.max_position_embeddings, cfg.hidden_size],
        param_attr=fluid.ParamAttr(name="pos_embedding"))
    sent = fluid.layers.embedding(
        input=sent_ids, size=[cfg.type_vocab_size, cfg.hidden_size],
        param_attr=fluid.ParamAttr(name="sent_embedding"))
    emb = fluid.layers.elementwise_add(
        fluid.layers.elementwise_add(emb, pos), sent)
    emb = fluid.layers.layer_norm(emb, begin_norm_axis=2, name="emb_ln")
    emb = _dropout(emb, cfg.hidden_dropout, cfg.is_test)

    mask_t = fluid.layers.transpose(input_mask, perm=[0, 2, 1])
    attn_bias = mask_to_bias(fluid.layers.matmul(input_mask, mask_t))
    _s = src_ids.shape[1] if len(src_ids.shape) >= 2 else -1
    use_flash = flash_wanted(cfg, seq_len=None if _s in (-1, None)
                             else int(_s))
    key_bias = mask_to_key_bias(input_mask) if use_flash else None

    x = emb
    for i in range(cfg.num_layers):
        x = encoder_layer(x, attn_bias, cfg, "layer_%d" % i,
                          key_bias=key_bias, use_flash=use_flash)

    first_tok = fluid.layers.slice(x, axes=[1], starts=[0], ends=[1])
    first_tok = fluid.layers.reshape(first_tok, shape=[-1, cfg.hidden_size])
    pooled = fluid.layers.fc(input=first_tok, size=cfg.hidden_size,
                             act="tanh", name="pooler")
    return x, pooled


def build_bert_classifier(cfg, seq_len, num_classes=2, learning_rate=2e-5,
                          use_amp=False):
    """Sequence-classification fine-tune program (``bert.py:458``): the
    encoder, dropout on the pooled output, the ``cls`` fc, softmax cross
    entropy averaged over the batch, top-1 accuracy, Adam. Feeds
    ``src_ids`` / ``pos_ids`` / ``sent_ids`` ([N, seq_len, 1] int64),
    ``input_mask`` ([N, seq_len, 1] float32) and ``label`` ([N, 1]
    int64). ``use_amp``: Adam decorated with
    ``contrib.mixed_precision.decorate`` (bf16 products, fp32 layer
    norms, loss and master weights), as the reference does.

    Returns (main, startup, feeds, avg_loss, acc)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        src_ids = fluid.layers.data(name="src_ids", shape=[seq_len, 1],
                                    dtype="int64")
        pos_ids = fluid.layers.data(name="pos_ids", shape=[seq_len, 1],
                                    dtype="int64")
        sent_ids = fluid.layers.data(name="sent_ids", shape=[seq_len, 1],
                                     dtype="int64")
        input_mask = fluid.layers.data(name="input_mask", shape=[seq_len, 1],
                                       dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        _, pooled = bert_encoder(src_ids, pos_ids, sent_ids, input_mask, cfg)
        pooled = _dropout(pooled, cfg.hidden_dropout, cfg.is_test)
        logits = fluid.layers.fc(input=pooled, size=num_classes, name="cls")
        loss = fluid.layers.softmax_with_cross_entropy(logits, label)
        avg_loss = fluid.layers.mean(loss)
        acc = fluid.layers.accuracy(input=fluid.layers.softmax(logits),
                                    label=label)
        opt = fluid.optimizer.Adam(learning_rate=learning_rate)
        if use_amp:
            opt = fluid.contrib.mixed_precision.decorate(opt)
        opt.minimize(avg_loss)
    feeds = [src_ids, pos_ids, sent_ids, input_mask, label]
    return main, startup, feeds, avg_loss, acc


def linear(x, lin, amp_dtype=None):
    """``lin(x)``; with ``amp_dtype`` (bf16 or fp16) the fc of the AMP
    program rewrite instead: the product of ``x`` and the weight, both
    cast to ``amp_dtype``, then the bias cast to it added, as its ``mul``
    and ``elementwise_add`` ops do. The parameters stay fp32."""
    if amp_dtype is None:
        return lin(x)
    return (torch.matmul(x.to(amp_dtype), lin.weight.to(amp_dtype).t())
            + lin.bias.to(amp_dtype))


class FFN(nn.Module):
    """fc0 (exact-erf GELU) -> fc1."""

    def __init__(self, hidden_size, intermediate_size, device=None):
        super().__init__()
        self.fc0 = nn.Linear(hidden_size, intermediate_size, device=device)
        self.fc1 = nn.Linear(intermediate_size, hidden_size, device=device)

    def forward(self, x, amp_dtype=None):
        return linear(math_ops.gelu(linear(x, self.fc0, amp_dtype)),
                      self.fc1, amp_dtype)


class MultiHeadAttention(nn.Module):
    """Self-attention on [N, S, H] inputs with q/k/v/out projections.

    ``forward(x, attn_bias, key_bias, causal, use_flash, cache,
    dropout_rate, rng)``:

    - ``use_flash`` (the caller's resolved policy, as in the reference)
      with a ``key_bias`` [N, S] runs the fused flash op under the
      ``causal`` flag; otherwise dense attention adds ``attn_bias``.
    - ``dropout_rate`` > 0 (a training forward; only without ``cache``):
      the flash op drops attention probabilities in the kernel from a
      seed drawn from ``rng.seeds``; the dense branch drops the attention
      weights with the dropout op (``downgrade_in_infer``, masks from
      ``rng.masks``), as the reference does (:373). ``rng`` None draws
      from torch's default generators.
    - ``cache``: None outside serving, else a dict with the layer's
      ``k``/``v`` cache tensors [slots, heads, max_len, d_head] and a
      ``mode``:

      * ``"prefill"``: attention runs the normal path over the prompt
        and, as a side effect, writes the prompt's K/V into the row of
        slot ``cache["slot_idx"]``;
      * ``"decode"``: each slot's new K/V lands at its ``cache["pos"]``
        position, then the single query attends over the updated cache
        under ``cache["key_bias"]`` [slots, max_len] (-1e4 beyond each
        slot's live length, which is also the causal mask) — the flash
        decode op when ``use_flash``, dense otherwise.
      * ``"resume"``: one prompt window (N = 1) lands in the row of
        ``cache["slot_off"]`` = (slot, offset) at ``offset``, after a
        cached prefix or earlier windows; its queries attend over the
        slot's whole updated row under ``cache["resume_bias"]`` [1, T,
        max_len] (the causal mask shifted by the offset). Dense by
        design, as in the reference: the causal flash kernel assumes an
        aligned q/k diagonal, so ``use_flash`` raises here.

      For the paged pool, ``k``/``v`` are the layer's shared pools
      [blocks, heads, block, d_head], ``cache["tables"]`` the int32 block
      tables [N, max_blocks], ``cache["write_index"]`` where this call's
      tokens land (``nn_ops.paged_write_index``, computed once per step)
      and ``cache["bias"]`` the additive mask [N, T, max_blocks*block]:

      * ``"paged_window"``: one prompt window (N = 1) is written through
        the table, then attends dense over the gathered logical row;
      * ``"paged_step"``: every slot's T-token window is written through
        its table; at T = 1 with ``use_flash`` the paged flash op reads
        the pool through the tables, otherwise (the T = k speculative
        verify, or no flash) the logical rows are gathered and attended
        dense.
    - ``amp_dtype`` (bf16 or fp16; without ``cache``): the casts of the
      AMP program rewrite. The projections run as ``linear`` on
      ``amp_dtype`` operands, the flash op follows its ``amp_dtype``
      q/k/v, and dense attention runs its softmax in fp32.
    """

    def __init__(self, hidden_size, num_heads, device=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.d_head = hidden_size // num_heads
        self.q = nn.Linear(hidden_size, hidden_size, device=device)
        self.k = nn.Linear(hidden_size, hidden_size, device=device)
        self.v = nn.Linear(hidden_size, hidden_size, device=device)
        self.out = nn.Linear(hidden_size, hidden_size, device=device)

    def _split_heads(self, x):
        # [N, S, H] -> [N, heads, S, d_head], contiguous for the kernels
        N, S, _ = x.shape
        return x.view(N, S, self.num_heads, self.d_head).transpose(1, 2) \
            .contiguous()

    def _merge_heads(self, ctxt):
        N, _, S, _ = ctxt.shape
        return ctxt.transpose(1, 2).reshape(N, S, self.hidden_size)

    def forward(self, x, attn_bias=None, key_bias=None, causal=False,
                use_flash=False, cache=None, dropout_rate=0.0, rng=None,
                amp_dtype=None):
        scale = 1.0 / math.sqrt(self.d_head)
        q = self._split_heads(linear(x, self.q, amp_dtype))
        k = self._split_heads(linear(x, self.k, amp_dtype))
        v = self._split_heads(linear(x, self.v, amp_dtype))
        mode = cache["mode"] if cache is not None else None
        if mode == "prefill":
            nn_ops.kv_cache_write(cache["k"], k, cache["slot_idx"],
                                  slot_mode=True)
            nn_ops.kv_cache_write(cache["v"], v, cache["slot_idx"],
                                  slot_mode=True)
        elif mode in ("paged_window", "paged_step"):
            pk, pv, tables = cache["k"], cache["v"], cache["tables"]
            nn_ops.kv_cache_write_paged(pk, k, tables, None,
                                        index=cache["write_index"])
            nn_ops.kv_cache_write_paged(pv, v, tables, None,
                                        index=cache["write_index"])
            if mode == "paged_step" and use_flash and q.shape[2] == 1:
                # the width-1 step: the paged kernel chases the tables,
                # the logical rows never materialize; the kernel reads
                # bias row bh // heads of the [slots, S] step bias
                kb = cache["bias"].reshape(q.shape[0], -1)
                ctxt = nn_ops.flash_decode_paged_attention(
                    q, pk, pv, tables, key_bias=kb, scale=scale)
            else:
                # the paged window and the width-k verify: gather the
                # logical rows, then dense attention under the fed bias
                # [N, T, S] (offset-shifted causal, sink garbage masked)
                rows_k = nn_ops.kv_cache_gather_paged(pk, tables)
                rows_v = nn_ops.kv_cache_gather_paged(pv, tables)
                scores = torch.matmul(q, rows_k.transpose(-1, -2)) * scale
                bias4 = cache["bias"].unsqueeze(1)
                ctxt = torch.matmul(math_ops.softmax(scores + bias4), rows_v)
            return self.out(self._merge_heads(ctxt))
        elif mode == "resume":
            if use_flash:
                raise ValueError("the resume window attends dense: the "
                                 "causal flash kernel assumes an aligned "
                                 "q/k diagonal")
            slot_off = cache["slot_off"]
            rows_k = nn_ops.kv_cache_gather(nn_ops.kv_cache_write(
                cache["k"], k, slot_off, slot_mode=True), slot_off)
            rows_v = nn_ops.kv_cache_gather(nn_ops.kv_cache_write(
                cache["v"], v, slot_off, slot_mode=True), slot_off)
            scores = torch.matmul(q, rows_k.transpose(-1, -2)) * scale
            bias4 = cache["resume_bias"].unsqueeze(1)
            ctxt = torch.matmul(math_ops.softmax(scores + bias4), rows_v)
            return self.out(self._merge_heads(ctxt))
        elif mode == "decode":
            k = nn_ops.kv_cache_write(cache["k"], k, cache["pos"])
            v = nn_ops.kv_cache_write(cache["v"], v, cache["pos"])
            if use_flash:
                ctxt = nn_ops.flash_decode_attention(
                    q, k, v, key_bias=cache["key_bias"], scale=scale)
            else:
                scores = torch.matmul(q, k.transpose(-1, -2)) * scale
                bias4 = cache["key_bias"].reshape(q.shape[0], 1, 1, -1)
                ctxt = torch.matmul(math_ops.softmax(scores + bias4), v)
            return self.out(self._merge_heads(ctxt))
        elif mode is not None:
            raise ValueError("unknown KV-cache mode %r" % (mode,))
        training = dropout_rate > 0.0
        if use_flash and key_bias is not None:
            ctxt = nn_ops.flash_attention(
                q, k, v, key_bias=key_bias, causal=causal, scale=scale,
                dropout_rate=dropout_rate, is_test=not training,
                generator=None if rng is None else rng.seeds)
        else:
            # under AMP the bias add follows the scores' type, the softmax
            # and dropout run in fp32 and the weights are cast for P·V
            scores = torch.matmul(q, k.transpose(-1, -2)) * scale
            if attn_bias is not None:
                scores = scores + attn_bias.to(scores.dtype)
            weights = _dropout_eager(math_ops.softmax(scores.float()),
                                     dropout_rate, not training, rng)
            ctxt = torch.matmul(weights.to(v.dtype), v)
        return linear(self._merge_heads(ctxt), self.out, amp_dtype)
