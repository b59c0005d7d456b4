"""Decoder-only causal language model, GPT-2 style (port of
``paddle_tpu/models/gpt.py``: serving and the train step).

``GPTLM`` is the post-LN decoder of the reference (``gpt_decoder`` +
``gpt_lm_logits``) as an ``nn.Module`` with seven entry points: the full
forward; over the contiguous slot pool, ``prefill`` (mirrors
``build_gpt_prefill``), ``resume_prefill`` (``build_gpt_resume_prefill``,
one prompt window at an offset of a slot's row), ``prefix_copy``
(``build_gpt_prefix_copy``, a block between the prefix store and a slot
row) and ``decode_step`` (``build_gpt_decode_step``); over the paged pool, ``paged_window`` (``build_gpt_paged_window``, one
prompt window written through a block table) and ``paged_step``
(``build_gpt_paged_step``, every slot's width-1 step or width-k
speculative verify). The KV caches and pools are plain tensors the
caller owns and passes in; the model writes them in place. The serving
modes never drop (the reference's serving programs run with
``is_test``); the full forward applies hidden and attention dropout
only in training mode with ``cfg.is_test`` false.

Training comes in two forms. ``build_gpt_lm_train`` is the reference's
program builder under its name and signature: ``gpt_decoder`` and
``gpt_lm_logits`` build the forward into a Fluid Program, Adam's
``minimize`` appends the backward and the updates, and it returns
``(main, startup, feeds, avg_loss)`` for ``fluid.Executor``.
``build_gpt_lm_train_eager`` runs the same step on torch autograd: the
model, the Adam optimizer and a ``step`` that runs forward, the masked
next-token loss (``gpt_lm_loss``), backward through the flash kernels
and the update.

``build_gpt_infer`` is the reference's inference program (the forward
with ``is_test``), which ``fluid.io.save_inference_model`` saves and
``inference.AnalysisPredictor`` serves. The serving programs are the
reference's builders too: ``build_gpt_prefill``,
``build_gpt_resume_prefill``, ``build_gpt_prefix_copy``,
``build_gpt_decode_step``, ``build_gpt_paged_window``,
``build_gpt_paged_step`` and ``build_gpt_paged_block_copy``, whose
caches, prefix stores and pools are persistable program variables that
the cache ops write in place; the program-form
``serving.decode.DecodeSession(cfg, ...)`` runs them, and
``greedy_generate`` takes the reference's Executor form beside the
model form.

Weights carry across from the reference as ``{fluid_param_name:
np.ndarray}``: into a model with ``load_fluid_params``, into a program's
scope with ``load_fluid_scope``; ``init_fluid_params`` makes such a dict
from a seed. ``share_fluid_scope`` makes a model's parameters the
tensors a program scope holds, with no copy.
"""

import copy
import time

import numpy as np
import torch
from torch import nn

from .. import fluid
from ..fluid import optimizer as _optimizer
from ..fluid import profiler
from ..fluid.core import resolve_device
from ..fluid.ops import math_ops, nn_ops
from ..observability import trace
from . import bert as _bert

__all__ = [
    "GPTConfig",
    "GPTLM",
    "decode_cache_names",
    "decode_cache_shape",
    "prefix_store_names",
    "prefix_store_shape",
    "prefix_block_bytes",
    "paged_pool_names",
    "paged_pool_shape",
    "paged_block_bytes",
    "fluid_param_shapes",
    "load_fluid_params",
    "load_fluid_scope",
    "share_fluid_scope",
    "init_fluid_params",
    "greedy_generate",
    "gpt_decoder",
    "gpt_lm_logits",
    "build_gpt_lm_train",
    "build_gpt_infer",
    "build_gpt_prefill",
    "build_gpt_resume_prefill",
    "build_gpt_prefix_copy",
    "build_gpt_decode_step",
    "build_gpt_paged_window",
    "build_gpt_paged_step",
    "build_gpt_paged_block_copy",
    "gpt_lm_loss",
    "build_gpt_lm_train_eager",
]


class GPTConfig(object):
    def __init__(self, vocab_size=50257, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=3072,
                 max_position_embeddings=1024, hidden_dropout=0.1,
                 attention_dropout=0.1, is_test=False,
                 use_flash_attention=False):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size
        self.max_position_embeddings = max_position_embeddings
        self.hidden_dropout = hidden_dropout
        self.attention_dropout = attention_dropout
        self.is_test = is_test
        self.use_flash_attention = use_flash_attention

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("vocab_size", 211)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("num_layers", 2)
        kw.setdefault("num_heads", 4)
        kw.setdefault("intermediate_size", 128)
        kw.setdefault("max_position_embeddings", 64)
        return cls(**kw)


def _causal_bias_eager(seq_len, device):
    """[1, 1, T, T] additive bias (0 attendable / -1e4 future) for the
    dense path; the flash path masks inside the kernel instead."""
    tri = torch.ones(seq_len, seq_len, device=device).tril()
    return ((tri - 1.0) * 1e4)[None, None]


class GPTLayer(nn.Module):
    """One post-LN block: h = LN1(h + attn(h)); h = LN2(h + ffn(h)).

    With ``amp_dtype`` (the AMP program's casts) the block's input is cast
    to it, the products and the residual adds run in it, and each layer
    norm casts its input back to fp32."""

    def __init__(self, cfg, device=None):
        super().__init__()
        H = cfg.hidden_size
        self.att = _bert.MultiHeadAttention(H, cfg.num_heads, device=device)
        self.ln1 = nn.LayerNorm(H, eps=1e-5, device=device)
        self.ffn = _bert.FFN(H, cfg.intermediate_size, device=device)
        self.ln2 = nn.LayerNorm(H, eps=1e-5, device=device)

    def forward(self, h, attn_bias, key_bias, use_flash, cache,
                hidden_dropout=0.0, attention_dropout=0.0, rng=None,
                amp_dtype=None):
        if amp_dtype is not None:
            h = h.to(amp_dtype)
        a = self.att(h, attn_bias=attn_bias, key_bias=key_bias, causal=True,
                     use_flash=use_flash, cache=cache,
                     dropout_rate=attention_dropout, rng=rng,
                     amp_dtype=amp_dtype)
        a = _bert._dropout_eager(a, hidden_dropout, False, rng)
        h = math_ops.layer_norm((h + a).float(), self.ln1.weight,
                                self.ln1.bias, begin_norm_axis=2)
        if amp_dtype is not None:
            h = h.to(amp_dtype)
        ff = _bert._dropout_eager(self.ffn(h, amp_dtype), hidden_dropout,
                                  False, rng)
        return math_ops.layer_norm((h + ff).float(), self.ln2.weight,
                                   self.ln2.bias, begin_norm_axis=2)


class GPTLM(nn.Module):
    """GPT causal LM: token + position embeddings, ``num_layers`` post-LN
    blocks, an untied LM head.

    ``device``: where the weights live; ``None`` means the card (and
    raises without one), ``"cpu"`` runs the plain path on the CPU. The
    model starts in eval mode; in training mode (``.train()``) with
    ``cfg.is_test`` false the full forward drops, drawing from ``rng``
    (a ``bert.DropoutRNG``; None means torch's default generators)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = copy.copy(cfg)
        self.rng = None
        H = cfg.hidden_size
        self.tok_embedding = nn.Embedding(cfg.vocab_size, H, device=dev)
        self.pos_embedding = nn.Embedding(cfg.max_position_embeddings, H,
                                          device=dev)
        self.layers = nn.ModuleList(
            GPTLayer(cfg, device=dev) for _ in range(cfg.num_layers))
        self.lm_head = nn.Linear(H, cfg.vocab_size, device=dev)
        self.eval()

    @property
    def device(self):
        return self.lm_head.weight.device

    def decoder(self, ids, pos_ids, input_mask=None, use_flash=None,
                kv_cache=None, amp_dtype=None):
        """Hidden states [N, T, H] for ids/pos_ids [N, T] (or [N, T, 1]).
        ``amp_dtype`` (full forward only) runs each block with the AMP
        program's casts (``GPTLayer``).

        Full forward / prefill: ``input_mask`` [N, T] marks real tokens;
        with flash it becomes a key-only bias and causality rides the
        kernel flag, otherwise a dense causal + padding bias is built.
        ``use_flash`` None resolves the config's policy from T.
        Decode and the paged step (``kv_cache["mode"]`` ``"decode"`` /
        ``"paged_step"``): the fed per-slot bias carries all masking, and
        the policy keys on the cache length. The resume and paged windows
        attend dense by design, as in the reference (the causal flash
        kernel assumes an aligned q/k diagonal)."""
        N = ids.shape[0]
        ids = ids.reshape(N, -1)
        pos_ids = pos_ids.reshape(N, -1)
        T = ids.shape[1]
        h = self.tok_embedding(ids) + self.pos_embedding(pos_ids)
        mode = kv_cache["mode"] if kv_cache is not None else None
        # dropout at the reference's three places (gpt.py:80, 159, 164)
        # and in attention, only in a training forward
        drop = self.training and not self.cfg.is_test and mode is None
        hidden_p = self.cfg.hidden_dropout if drop else 0.0
        attn_p = self.cfg.attention_dropout if drop else 0.0
        h = _bert._dropout_eager(h, hidden_p, False, self.rng)
        key_bias = attn_bias = None
        if mode in ("decode", "paged_step"):
            use_flash = _bert.flash_wanted(self.cfg,
                                           seq_len=int(kv_cache["max_len"]))
        elif mode in ("resume", "paged_window"):
            use_flash = False
        else:
            if use_flash is None:
                use_flash = _bert.flash_wanted(self.cfg, seq_len=T)
            if use_flash:
                key_bias = _bert.mask_to_key_bias(input_mask)
            else:
                pad = input_mask.reshape(N, 1, 1, T).float() * 1e4 - 1e4
                attn_bias = _causal_bias_eager(T, h.device) + pad
        for i, layer in enumerate(self.layers):
            cache_i = None
            if kv_cache is not None:
                k_c, v_c = kv_cache["caches"][i]
                cache_i = {"k": k_c, "v": v_c, "mode": mode}
                if mode == "prefill":
                    cache_i["slot_idx"] = kv_cache["slot_idx"]
                elif mode == "resume":
                    cache_i["slot_off"] = kv_cache["slot_off"]
                    cache_i["resume_bias"] = kv_cache["resume_bias"]
                elif mode in ("paged_window", "paged_step"):
                    for key in ("tables", "write_index", "bias"):
                        cache_i[key] = kv_cache[key]
                else:
                    cache_i["pos"] = kv_cache["pos"]
                    cache_i["key_bias"] = kv_cache["key_bias"]
            h = layer(h, attn_bias, key_bias, use_flash, cache_i,
                      hidden_dropout=hidden_p, attention_dropout=attn_p,
                      rng=self.rng, amp_dtype=amp_dtype)
        return h

    def forward(self, ids, pos_ids, input_mask, use_flash=None,
                amp_dtype=None):
        """Full forward: next-token logits [N, T, vocab]. ``amp_dtype``
        (bf16 or fp16) applies the casts of the AMP program rewrite
        (``contrib.mixed_precision``): the products run on ``amp_dtype``
        operands, the ops that follow their inputs (bias adds, GELU,
        dropout, head split/merge, the residual adds, flash attention)
        stay in it, layer norm and the softmax run in fp32, and the
        logits come back in ``amp_dtype``. The embeddings and parameters
        stay fp32; each use casts."""
        h = self.decoder(ids, pos_ids, input_mask, use_flash=use_flash,
                         amp_dtype=amp_dtype)
        return _bert.linear(h, self.lm_head, amp_dtype)

    def prefill(self, ids, pos_ids, input_mask, slot_idx, last_onehot,
                caches):
        """One prompt (batch 1, padded to its bucket T) runs the causal
        forward and writes every layer's K/V into the row of slot
        ``slot_idx`` of ``caches`` (a list of per-layer (k, v) tensors
        [slots, heads, max_len, d_head]). ``last_onehot`` [1, T] selects
        the last real position; returns its next-token logits [1, vocab].

        The reference projects all T positions through the LM head and
        then selects; selecting the hidden state first gives the same
        row for 1/T of the head's work."""
        h = self.decoder(ids, pos_ids, input_mask, kv_cache={
            "mode": "prefill", "caches": caches, "slot_idx": slot_idx,
            "max_len": caches[0][0].shape[2],
        })
        last = (h * last_onehot.reshape(1, -1, 1).to(h.dtype)).sum(dim=1)
        return self.lm_head(last)

    def resume_prefill(self, ids, pos_ids, slot_off, resume_bias,
                       last_onehot, caches):
        """One prompt window (batch 1, padded to its bucket T) whose
        token i lands at position ``offset + i`` of slot ``slot``'s row,
        ``slot_off`` = (slot, offset) as host data: the suffix after a
        copied prefix, or one chunk of a chunked prefill. Its queries
        attend over the slot's whole updated row under ``resume_bias``
        [1, T, max_len] (0 where position j <= offset + i for query i,
        -1e4 beyond). ``last_onehot`` [1, T] selects the window's last
        real token; returns its logits [1, vocab] (the hidden row is
        selected before the LM head, as in ``prefill``)."""
        h = self.decoder(ids, pos_ids, kv_cache={
            "mode": "resume", "caches": caches, "slot_off": slot_off,
            "resume_bias": resume_bias, "max_len": caches[0][0].shape[2],
        })
        last = (h * last_onehot.reshape(1, -1, 1).to(h.dtype)).sum(dim=1)
        return self.lm_head(last)

    @staticmethod
    def prefix_copy(caches, stores, dst_loc, src_loc, publish=False):
        """Move one prefix block between the prefix ``stores`` (per-layer
        (k, v) [blocks, heads, block, d_head]) and the slot ``caches``,
        in every layer's K and V, in place: ``publish`` False copies
        store block ``src_loc`` = (block, 0) into the slot row at
        ``dst_loc`` = (slot, position) (admitting a hit), True copies the
        row block at ``src_loc`` = (slot, position) into store block
        ``dst_loc`` = (block, 0) (publishing a finished prefill)."""
        block = stores[0][0].shape[2]
        for (ck, cv), (sk, sv) in zip(caches, stores):
            if publish:
                nn_ops.kv_cache_copy(sk, ck, dst_loc, src_loc, block)
                nn_ops.kv_cache_copy(sv, cv, dst_loc, src_loc, block)
            else:
                nn_ops.kv_cache_copy(ck, sk, dst_loc, src_loc, block)
                nn_ops.kv_cache_copy(cv, sv, dst_loc, src_loc, block)

    def decode_step(self, step_ids, step_pos, key_bias, caches):
        """One new token per slot (step_ids/step_pos [slots], any shape
        with one entry per slot): each slot's K/V lands at its position
        and its query attends over the cache under ``key_bias``
        [slots, max_len]. Returns logits [slots, vocab]."""
        slots = step_ids.numel()
        h = self.decoder(step_ids.reshape(slots, 1),
                         step_pos.reshape(slots, 1), kv_cache={
                             "mode": "decode", "caches": caches,
                             "pos": step_pos.reshape(-1),
                             "key_bias": key_bias,
                             "max_len": caches[0][0].shape[2],
                         })
        return self.lm_head(h).reshape(slots, -1)

    def _paged(self, mode, ids, pos_ids, tables, write_pos, bias, pools):
        """Decoder run over the paged pools: tables [N, max_blocks] int32
        on the model's device, bias [N, T, max_blocks*block]; the write
        index is computed once for every layer."""
        T = ids.numel() // ids.shape[0]
        block = pools[0][0].shape[2]
        return self.decoder(ids, pos_ids, kv_cache={
            "mode": mode, "caches": pools, "tables": tables, "bias": bias,
            "write_index": nn_ops.paged_write_index(tables, write_pos, T,
                                                    block),
            "max_len": tables.shape[1] * block,
        })

    def paged_window(self, ids, pos_ids, table, window_pos, resume_bias,
                     last_onehot, pools):
        """One prompt window (batch 1, padded to its bucket T) whose
        token i lands at logical position ``window_pos + i`` through the
        block ``table`` [1, max_blocks] (int32) into ``pools`` (a list of
        per-layer (k, v) pools [blocks, heads, block, d_head]); its
        queries attend over the gathered logical row under
        ``resume_bias`` [1, T, max_blocks*block]. ``last_onehot`` [1, T]
        selects the window's last real token; returns its logits
        [1, vocab] (the hidden row is selected before the LM head, as in
        ``prefill``)."""
        h = self._paged("paged_window", ids, pos_ids, table, window_pos,
                        resume_bias, pools)
        last = (h * last_onehot.reshape(1, -1, 1).to(h.dtype)).sum(dim=1)
        return self.lm_head(last)

    def paged_step(self, step_ids, step_pos, tables, step_bias, pools):
        """Every slot advances a width-T window: ``step_ids``/``step_pos``
        [slots, T] (any shape with slots * T entries, positions
        contiguous per slot), written through ``tables`` [slots,
        max_blocks] (int32) into ``pools``; query i of slot s attends
        under ``step_bias`` [slots, T, max_blocks*block]. T = 1 is the
        decode step (the paged flash kernel on the card), T = k the
        speculative verify. Returns logits [slots, T, vocab]."""
        slots = tables.shape[0]
        step_pos = step_pos.reshape(slots, -1)
        h = self._paged("paged_step", step_ids.reshape(slots, -1), step_pos,
                        tables, step_pos[:, 0], step_bias, pools)
        return self.lm_head(h)


# ---------------------------------------------------------------------------
# KV-cache geometry (shared with the serving session)
# ---------------------------------------------------------------------------


def decode_cache_names(cfg, slots, max_len):
    """Per-layer (K, V) cache names; the pool geometry is part of the
    name, as in the reference."""
    return [
        ("gpt_cache_k_%d_p%dx%d" % (i, slots, max_len),
         "gpt_cache_v_%d_p%dx%d" % (i, slots, max_len))
        for i in range(cfg.num_layers)
    ]


def decode_cache_shape(cfg, slots, max_len):
    return [
        int(slots), cfg.num_heads, int(max_len),
        cfg.hidden_size // cfg.num_heads,
    ]


def prefix_store_names(cfg, blocks, block):
    """Per-layer (K, V) prefix-store names; the store geometry is part
    of the name, as in the reference."""
    return [
        ("gpt_prefix_k_%d_n%dx%d" % (i, blocks, block),
         "gpt_prefix_v_%d_n%dx%d" % (i, blocks, block))
        for i in range(cfg.num_layers)
    ]


def prefix_store_shape(cfg, blocks, block):
    """A store block has a paged pool block's layout."""
    return paged_pool_shape(cfg, blocks, block)


def prefix_block_bytes(cfg, block):
    """Device bytes one cached prefix block costs across all layers
    (K + V, fp32): what ``decode_prefix_cache_mb`` divides by."""
    return paged_block_bytes(cfg, block)


def paged_pool_names(cfg, blocks, block):
    """Per-layer (K, V) paged-pool names, the pool geometry part of the
    name as in the reference."""
    return [
        ("gpt_paged_k_%d_n%dx%d" % (i, blocks, block),
         "gpt_paged_v_%d_n%dx%d" % (i, blocks, block))
        for i in range(cfg.num_layers)
    ]


def paged_pool_shape(cfg, blocks, block):
    return [
        int(blocks), cfg.num_heads, int(block),
        cfg.hidden_size // cfg.num_heads,
    ]


def paged_block_bytes(cfg, block):
    """Device bytes one pool block costs across all layers (K + V,
    fp32): a slot costs ``ceil(len / block)`` of these."""
    d_head = cfg.hidden_size // cfg.num_heads
    return cfg.num_layers * 2 * cfg.num_heads * int(block) * d_head * 4


# ---------------------------------------------------------------------------
# weights carried across from the reference scope
# ---------------------------------------------------------------------------


def fluid_param_shapes(cfg):
    """{fluid parameter name: shape} as the reference's scope holds them
    after its startup run. fc weights are [in, out]."""
    H, F_, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    out = {
        "tok_embedding": (V, H),
        "pos_embedding": (cfg.max_position_embeddings, H),
    }
    for i in range(cfg.num_layers):
        p = "gpt_%d_" % i
        for proj in ("q", "k", "v", "out"):
            out[p + "att_%s.w_0" % proj] = (H, H)
            out[p + "att_%s.b_0" % proj] = (H,)
        out[p + "ffn_fc0.w_0"] = (H, F_)
        out[p + "ffn_fc0.b_0"] = (F_,)
        out[p + "ffn_fc1.w_0"] = (F_, H)
        out[p + "ffn_fc1.b_0"] = (H,)
        for ln in ("ln1", "ln2"):
            out[p + ln + ".w_0"] = (H,)
            out[p + ln + ".b_0"] = (H,)
    out["lm_head.w_0"] = (H, V)
    out["lm_head.b_0"] = (V,)
    return out


def _param_owners(model):
    """{fluid name: (module, attribute, transpose)} — fc weights are
    [in, out] in the reference and [out, in] in ``nn.Linear``."""
    t = {
        "tok_embedding": (model.tok_embedding, "weight", False),
        "pos_embedding": (model.pos_embedding, "weight", False),
        "lm_head.w_0": (model.lm_head, "weight", True),
        "lm_head.b_0": (model.lm_head, "bias", False),
    }
    for i, layer in enumerate(model.layers):
        p = "gpt_%d_" % i
        fcs = {"att_q": layer.att.q, "att_k": layer.att.k,
               "att_v": layer.att.v, "att_out": layer.att.out,
               "ffn_fc0": layer.ffn.fc0, "ffn_fc1": layer.ffn.fc1}
        for name, lin in fcs.items():
            t[p + name + ".w_0"] = (lin, "weight", True)
            t[p + name + ".b_0"] = (lin, "bias", False)
        for name, ln in (("ln1", layer.ln1), ("ln2", layer.ln2)):
            t[p + name + ".w_0"] = (ln, "weight", False)
            t[p + name + ".b_0"] = (ln, "bias", False)
    return t


def _param_targets(model):
    """{fluid name: (module parameter, transpose)}."""
    return {name: (getattr(mod, attr), transpose)
            for name, (mod, attr, transpose) in _param_owners(model).items()}


def load_fluid_params(model, arrays):
    """Fill ``model`` from ``{fluid_param_name: np.ndarray}``, exactly the
    names and layouts of the reference scope. Every parameter must be
    present with its reference shape; an unknown name raises too."""
    targets = _param_targets(model)
    missing = sorted(set(targets) - set(arrays))
    unknown = sorted(set(arrays) - set(targets))
    if missing or unknown:
        raise KeyError("fluid params: missing %s, unknown %s"
                       % (missing[:5], unknown[:5]))
    shapes = fluid_param_shapes(model.cfg)
    with torch.no_grad():
        for name, (param, transpose) in targets.items():
            arr = np.asarray(arrays[name], dtype=np.float32)
            if tuple(arr.shape) != tuple(shapes[name]):
                raise ValueError("fluid param %s: shape %s, expected %s"
                                 % (name, arr.shape, shapes[name]))
            param.copy_(torch.from_numpy(
                np.array(arr.T if transpose else arr, order="C")))
    return model


def load_fluid_scope(scope, arrays):
    """Fill a program scope (after its startup run) from
    ``{fluid var name: np.ndarray}``, the layout the reference's scope
    holds after its startup run: every GPT parameter the scope holds must
    be given (the names of ``fluid_param_shapes`` for the model whose
    embeddings and layers the scope holds), every given name must be a
    variable of the scope (optimizer accumulators and the learning rate
    may be given too) with the scope's shape. Values are copied into the
    scope's tensors in place, on their device."""
    tok, pos = scope.get("tok_embedding"), scope.get("pos_embedding")
    if tok is None or pos is None:
        raise KeyError("scope holds no GPT embeddings: run the startup "
                       "program first")
    layers = 0
    while scope.get("gpt_%d_att_q.w_0" % layers) is not None:
        layers += 1
    ffn = scope.get("gpt_0_ffn_fc0.w_0")
    cfg = GPTConfig(vocab_size=tok.shape[0], hidden_size=tok.shape[1],
                    num_layers=layers,
                    intermediate_size=ffn.shape[1] if ffn is not None else 0,
                    max_position_embeddings=pos.shape[0])
    missing = sorted(set(fluid_param_shapes(cfg)) - set(arrays))
    unknown = sorted(n for n in arrays if scope.get(n) is None)
    if missing or unknown:
        raise KeyError("fluid scope: missing %s, unknown %s"
                       % (missing[:5], unknown[:5]))
    with torch.no_grad():
        for name, arr in arrays.items():
            t = scope.get(name)
            arr = np.asarray(arr)
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError("fluid var %s: shape %s, the scope holds %s"
                                 % (name, arr.shape, tuple(t.shape)))
            t.copy_(torch.from_numpy(np.array(arr, order="C")).to(t.dtype))
    return scope


def share_fluid_scope(model, scope, names=None):
    """Make ``model``'s parameters the tensors a program scope holds, with
    no copy: an fc weight [in, out] becomes the transposed view
    ``nn.Linear`` reads, so a predictor and a decode engine over one scope
    hold one copy of the weights. ``names`` maps a canonical fluid name
    (``fluid_param_shapes``) to the scope variable holding it (default:
    the same name). Each tensor must have its reference shape and the
    model's dtype, and all of them one device, which becomes the model's
    (a model built on ``"meta"`` allocates nothing before); the
    parameters take no gradient."""
    names = names or {}
    shapes = fluid_param_shapes(model.cfg)
    devices = set()
    for canon, (mod, attr, transpose) in _param_owners(model).items():
        src = names.get(canon, canon)
        t = scope.get(src)
        if t is None:
            raise KeyError("fluid scope holds no %r (for %s)" % (src, canon))
        old = getattr(mod, attr)
        if tuple(t.shape) != tuple(shapes[canon]) or t.dtype != old.dtype:
            raise ValueError("fluid var %s: %s %s, the model needs %s %s"
                             % (src, tuple(t.shape), t.dtype,
                                tuple(shapes[canon]), old.dtype))
        devices.add(t.device)
        setattr(mod, attr, nn.Parameter(t.t() if transpose else t,
                                        requires_grad=False))
    if len(devices) != 1:
        raise ValueError("fluid scope's parameters lie on %s, not on one "
                         "device" % sorted(map(str, devices)))
    return model


def init_fluid_params(cfg, seed):
    """A reference-layout parameter dict made with numpy from ``seed``:
    weights N(0, 0.02), biases 0, layer-norm scales 1."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in fluid_param_shapes(cfg).items():
        if name.endswith(".b_0"):
            out[name] = np.zeros(shape, np.float32)
        elif "_ln" in name:
            out[name] = np.ones(shape, np.float32)
        else:
            out[name] = rng.standard_normal(shape, dtype=np.float32) * \
                np.float32(0.02)
    return out


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------


def _reference_generate(model, prompt_ids, max_len, use_flash=None):
    """The oracle: greedy decode recomputing the full [1, max_len]
    forward per emitted token, O(T^2) model work — the parity reference
    the decode runtime is held against."""
    ids = list(prompt_ids)
    dev = model.device
    pos_ids = torch.arange(max_len, device=dev).reshape(1, max_len)
    positions = torch.arange(max_len, device=dev)
    padded = torch.zeros(1, max_len, dtype=torch.int64, device=dev)
    with torch.inference_mode():
        for _ in range(max_len - len(prompt_ids)):
            cur = len(ids)
            padded[0, :cur] = torch.as_tensor(ids, device=dev)
            mask = (positions < cur).float().reshape(1, max_len)
            logits = model(padded, pos_ids, mask, use_flash=use_flash)
            ids.append(int(logits[0, cur - 1].argmax()))
    return ids


def greedy_generate(model, *args, **kwargs):
    """Greedy decode through the KV-cache runtime: one prefill, then
    single-token steps against the cache — O(T) model work, token-exact
    with the full-forward oracle. Two forms:

    - ``greedy_generate(model, prompt_ids, max_len)``: the eager
      ``GPTLM``; its 1-slot session is cached on the model per
      ``max_len``.
    - ``greedy_generate(exe, infer_prog, logits_var, cfg, prompt_ids,
      max_len, scope=None)`` (the reference's, ``gpt.py:715``): the
      serving programs run by a program ``DecodeSession`` on
      ``exe.place`` over ``scope`` (``global_scope()`` for None), cached
      on the scope; ``infer_prog`` names the scope's parameters (its
      ``_<n>`` suffixes read as ``_0``) and ``logits_var`` is unused, as
      in the reference.

    Concurrent callers of one session serialize on its lock."""
    if isinstance(model, GPTLM):
        return _greedy_eager(model, *args, **kwargs)
    return _greedy_program(model, *args, **kwargs)


def _greedy_eager(model, prompt_ids, max_len):
    from ..serving import decode as _decode

    return _greedy(prompt_ids, max_len,
                   lambda: _decode.session_for_generate(model, max_len))


def _greedy_program(exe, infer_prog, logits_var, cfg, prompt_ids, max_len,
                    scope=None):
    from ..serving import decode as _decode

    return _greedy(prompt_ids, max_len, lambda: _decode.session_for_generate(
        exe, cfg, scope, max_len, infer_prog))


def _greedy(prompt_ids, max_len, session):
    ids = list(prompt_ids)
    if len(ids) >= max_len:
        return ids
    sess = session()
    with sess.lock:
        logits = sess.prefill(0, ids)
        ids.append(int(np.asarray(logits).ravel().argmax()))
        while len(ids) < max_len:
            step = sess.decode_step([ids[-1]], [len(ids) - 1], [True])
            ids.append(int(np.asarray(step)[0].argmax()))
    return ids


# ---------------------------------------------------------------------------
# training: the program form
# ---------------------------------------------------------------------------


def _causal_bias(seq_len):
    """[1, 1, T, T] additive bias program variable (0 attendable / -1e4
    future) for the dense path; the flash path masks inside the kernel
    instead."""
    tri = np.tril(np.ones((1, seq_len, seq_len), np.float32))
    bias = fluid.layers.assign((tri - 1.0) * 1e4)
    bias = fluid.layers.unsqueeze(bias, axes=[1])  # [1, 1, T, T]
    bias.stop_gradient = True
    return bias


def gpt_decoder(ids, pos_ids, input_mask, cfg, kv_cache=None):
    """Decoder stack on [N, T, 1] int64 id variables; returns hidden
    [N, T, H] (the reference's builder, ``gpt.py:63``).

    Without ``kv_cache`` (training, full-forward inference): with flash
    the padding mask becomes a key-only bias and causality rides the
    kernel flag; otherwise a dense causal + padding bias is built.
    ``kv_cache`` threads the serving programs' cache plumbing through
    every layer's attention (``bert.multi_head_attention``): a dict with
    ``mode``, the per-layer ``caches`` [(k, v)], ``max_len`` and the
    mode's feeds (``slot_idx``; ``slot_off`` and ``resume_bias``;
    ``tables``, ``pos`` and ``resume_bias`` or ``step_bias``; ``pos``
    and ``key_bias``). In ``decode`` and ``paged_step`` the fed bias
    carries all masking and the flash policy keys on the cache length;
    the ``resume`` and ``paged_window`` windows attend dense."""
    emb = fluid.layers.embedding(
        input=ids, size=[cfg.vocab_size, cfg.hidden_size],
        param_attr=fluid.ParamAttr(name="tok_embedding"))
    pos = fluid.layers.embedding(
        input=pos_ids, size=[cfg.max_position_embeddings, cfg.hidden_size],
        param_attr=fluid.ParamAttr(name="pos_embedding"))
    h = fluid.layers.elementwise_add(emb, pos)
    h = _bert._dropout(h, cfg.hidden_dropout, cfg.is_test)
    key_bias = attn_bias = None
    mode = kv_cache["mode"] if kv_cache is not None else None
    if mode in ("resume", "paged_window"):
        use_flash = False
    elif mode in ("decode", "paged_step"):
        use_flash = _bert.flash_wanted(cfg,
                                       seq_len=int(kv_cache["max_len"]))
    else:
        _s = ids.shape[1] if len(ids.shape) >= 2 else -1
        use_flash = _bert.flash_wanted(
            cfg, seq_len=None if _s in (-1, None) else int(_s))
        if use_flash:
            key_bias = _bert.mask_to_key_bias(input_mask)
        else:
            pad = fluid.layers.scale(
                fluid.layers.reshape(input_mask, shape=[0, 1, 1, -1]),
                scale=1e4, bias=-1e4)
            pad.stop_gradient = True
            attn_bias = fluid.layers.elementwise_add(
                _causal_bias(ids.shape[1]), pad)
    feeds = {"prefill": ("slot_idx",), "resume": ("slot_off", "resume_bias"),
             "paged_window": ("tables", "pos", "resume_bias"),
             "paged_step": ("tables", "pos", "step_bias"),
             "decode": ("pos", "key_bias")}.get(mode, ())
    for i in range(cfg.num_layers):
        name = "gpt_%d" % i
        cache_i = None
        if kv_cache is not None:
            k_var, v_var = kv_cache["caches"][i]
            cache_i = {"k": k_var, "v": v_var, "mode": mode}
            cache_i.update((key, kv_cache[key]) for key in feeds)
        attn = _bert.multi_head_attention(
            h, h, attn_bias, cfg, name + "_att", key_bias=key_bias,
            causal=True, use_flash=use_flash, cache=cache_i)
        attn = _bert._dropout(attn, cfg.hidden_dropout, cfg.is_test)
        h = fluid.layers.layer_norm(fluid.layers.elementwise_add(h, attn),
                                    begin_norm_axis=2, name=name + "_ln1")
        ff = _bert._dropout(_bert._ffn(h, cfg, name + "_ffn"),
                            cfg.hidden_dropout, cfg.is_test)
        h = fluid.layers.layer_norm(fluid.layers.elementwise_add(h, ff),
                                    begin_norm_axis=2, name=name + "_ln2")
    return h


def gpt_lm_logits(ids, pos_ids, input_mask, cfg, kv_cache=None):
    """[N, T, vocab] next-token logits variable."""
    h = gpt_decoder(ids, pos_ids, input_mask, cfg, kv_cache=kv_cache)
    return fluid.layers.fc(input=h, size=cfg.vocab_size, num_flatten_dims=2,
                           name="lm_head")


def build_gpt_lm_train(cfg, seq_len, learning_rate=3e-4, use_amp=False):
    """Next-token LM training program (the reference's builder,
    ``gpt.py:183``): positions t predict tokens t+1, padded target
    positions masked out of the loss, Adam over every parameter.

    Returns (main, startup, feeds, avg_loss): run ``startup`` once, then
    ``main`` with feeds ``ids`` / ``pos_ids`` ([N, seq_len, 1] int64) and
    ``input_mask`` ([N, seq_len, 1] float32) through ``fluid.Executor``.
    Parameter names are the reference's (build under a fresh
    ``fluid.unique_name.guard()`` for its ``_0`` suffixes). ``use_amp``
    decorates Adam with ``contrib.mixed_precision.decorate`` (bf16, loss
    scale 1, no dynamic scaling), as the reference does: the AMP rewrite
    casts the products' operands to bf16, the flash op follows its bf16
    Q/K/V, layer norm and the loss stay fp32, and the scope keeps fp32
    parameters that the rewrite's ``cast`` ops copy to bf16 every step."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ids = fluid.layers.data(name="ids", shape=[seq_len, 1], dtype="int64")
        pos_ids = fluid.layers.data(name="pos_ids", shape=[seq_len, 1],
                                    dtype="int64")
        input_mask = fluid.layers.data(name="input_mask", shape=[seq_len, 1],
                                       dtype="float32")
        logits = gpt_lm_logits(ids, pos_ids, input_mask, cfg)
        # shift: logits[:, :-1] predict ids[:, 1:]
        pred = fluid.layers.slice(logits, axes=[1], starts=[0],
                                  ends=[seq_len - 1])
        tgt = fluid.layers.slice(ids, axes=[1], starts=[1], ends=[seq_len])
        loss = fluid.layers.softmax_with_cross_entropy(pred, tgt)
        # mask the loss at padded TARGET positions
        tgt_mask = fluid.layers.slice(input_mask, axes=[1], starts=[1],
                                      ends=[seq_len])
        loss = fluid.layers.elementwise_mul(loss, tgt_mask)
        denom = fluid.layers.reduce_sum(tgt_mask)
        avg_loss = fluid.layers.elementwise_div(fluid.layers.reduce_sum(loss),
                                                denom)
        opt = fluid.optimizer.Adam(learning_rate=learning_rate)
        if use_amp:
            opt = fluid.contrib.mixed_precision.decorate(opt)
        opt.minimize(avg_loss)
    return main, startup, [ids, pos_ids, input_mask], avg_loss


def build_gpt_infer(cfg, seq_len):
    """Inference program with ``is_test`` semantics (the reference's
    builder, ``gpt.py:221``): returns (main, startup, feed names,
    logits). Feeds are ``ids`` / ``pos_ids`` ([N, seq_len, 1] int64) and
    ``input_mask`` ([N, seq_len, 1] float32); any sequence length runs.
    The caller's config is not mutated."""
    cfg = copy.copy(cfg)
    cfg.is_test = True
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ids = fluid.layers.data(name="ids", shape=[seq_len, 1], dtype="int64")
        pos_ids = fluid.layers.data(name="pos_ids", shape=[seq_len, 1],
                                    dtype="int64")
        input_mask = fluid.layers.data(name="input_mask", shape=[seq_len, 1],
                                       dtype="float32")
        logits = gpt_lm_logits(ids, pos_ids, input_mask, cfg)
    return main, startup, ["ids", "pos_ids", "input_mask"], logits


# ---------------------------------------------------------------------------
# the KV-cache serving programs (the reference's builders, gpt.py:284-685)
# ---------------------------------------------------------------------------


def _declare_state(names, shape):
    """Declare per-layer persistable (K, V) vars of ``shape`` in the
    current main program. No initializer: the serving session puts their
    tensors in the scope (a startup run would also re-initialize the
    model's parameters)."""
    block = fluid.default_main_program().global_block()
    return [tuple(block.create_var(name=n, shape=shape, dtype="float32",
                                   persistable=True) for n in pair)
            for pair in names]


def _declare_cache_vars(cfg, slots, max_len):
    return _declare_state(decode_cache_names(cfg, slots, max_len),
                          decode_cache_shape(cfg, slots, max_len))


def _declare_prefix_store_vars(cfg, blocks, block):
    return _declare_state(prefix_store_names(cfg, blocks, block),
                          prefix_store_shape(cfg, blocks, block))


def _declare_paged_pool_vars(cfg, blocks, block):
    return _declare_state(paged_pool_names(cfg, blocks, block),
                          paged_pool_shape(cfg, blocks, block))


def _serving_program(cfg):
    """(is_test copy of ``cfg``, main, startup) for a serving builder.
    ``main._donate_mutable`` is the reference's opt-in to donating the
    cache buffers; here the cache ops write the scope's tensors in place
    whatever it says."""
    cfg = copy.copy(cfg)
    cfg.is_test = True
    main, startup = fluid.Program(), fluid.Program()
    main._donate_mutable = True
    return cfg, main, startup


def _data(name, shape, dtype="int64"):
    return fluid.layers.data(name=name, shape=shape, dtype=dtype)


def _last_logits(logits, last_onehot):
    """[1, vocab]: the logits of the position ``last_onehot`` marks."""
    return fluid.layers.reduce_sum(
        fluid.layers.elementwise_mul(logits, last_onehot), dim=1)


def build_gpt_prefill(cfg, slots, seq_len, max_len):
    """Prefill program (``gpt.py:284``): ONE prompt (batch 1, padded to
    the ``seq_len`` bucket) runs the causal forward and writes every
    layer's K/V into the row of the fed slot ``slot_idx`` [1, 1];
    ``last_onehot`` [1, seq_len, 1] selects the last real position's
    logits. Feeds ``ids``, ``pos_ids``, ``input_mask``, ``slot_idx``,
    ``last_onehot``. Returns (main, startup, feed names, next_logits
    [1, vocab]); the startup is not meant to run (the scope holds the
    parameters)."""
    cfg, main, startup = _serving_program(cfg)
    with fluid.program_guard(main, startup):
        ids = _data("ids", [seq_len, 1])
        pos_ids = _data("pos_ids", [seq_len, 1])
        input_mask = _data("input_mask", [seq_len, 1], "float32")
        slot_idx = _data("slot_idx", [1])
        last_onehot = _data("last_onehot", [seq_len, 1], "float32")
        logits = gpt_lm_logits(ids, pos_ids, input_mask, cfg, kv_cache={
            "mode": "prefill",
            "caches": _declare_cache_vars(cfg, slots, max_len),
            "slot_idx": slot_idx, "max_len": max_len})
        next_logits = _last_logits(logits, last_onehot)
    feeds = ["ids", "pos_ids", "input_mask", "slot_idx", "last_onehot"]
    return main, startup, feeds, next_logits


def build_gpt_resume_prefill(cfg, slots, seq_len, max_len):
    """Resume-prefill program (``gpt.py:332``): ONE prompt window (batch
    1, padded to ``seq_len``) written at the fed ``slot_off`` = (slot,
    offset) [1, 2] of its row; its queries attend dense over the whole
    updated row under ``resume_bias`` [1, seq_len, max_len] (0 where
    position j <= offset + i for query i, -1e4 beyond). Feeds ``ids``,
    ``pos_ids``, ``slot_off``, ``resume_bias``, ``last_onehot``. Returns
    (main, startup, feed names, next_logits [1, vocab])."""
    cfg, main, startup = _serving_program(cfg)
    with fluid.program_guard(main, startup):
        ids = _data("ids", [seq_len, 1])
        pos_ids = _data("pos_ids", [seq_len, 1])
        slot_off = _data("slot_off", [2])
        resume_bias = _data("resume_bias", [seq_len, max_len], "float32")
        last_onehot = _data("last_onehot", [seq_len, 1], "float32")
        logits = gpt_lm_logits(ids, pos_ids, None, cfg, kv_cache={
            "mode": "resume",
            "caches": _declare_cache_vars(cfg, slots, max_len),
            "slot_off": slot_off, "resume_bias": resume_bias,
            "max_len": max_len})
        next_logits = _last_logits(logits, last_onehot)
    feeds = ["ids", "pos_ids", "slot_off", "resume_bias", "last_onehot"]
    return main, startup, feeds, next_logits


def build_gpt_prefix_copy(cfg, slots, max_len, blocks, block,
                          publish=False):
    """One block move between the prefix store and the slot caches in
    every layer's K and V (``gpt.py:434``): ``publish`` False copies store
    block ``src_loc`` into the slot row at ``dst_loc``, True a slot-row
    block into the store; both (row, position) locations [1, 2] are fed.
    Returns (main, startup, ["dst_loc", "src_loc"], ok), ``ok`` a dummy
    fetch: the pools are the outputs."""
    main, startup = fluid.Program(), fluid.Program()
    main._donate_mutable = True
    with fluid.program_guard(main, startup):
        dst_loc = _data("dst_loc", [2])
        src_loc = _data("src_loc", [2])
        caches = _declare_cache_vars(cfg, slots, max_len)
        stores = _declare_prefix_store_vars(cfg, blocks, block)
        for (ck, cv), (sk, sv) in zip(caches, stores):
            if publish:
                fluid.layers.kv_cache_copy(sk, ck, dst_loc, src_loc, block)
                fluid.layers.kv_cache_copy(sv, cv, dst_loc, src_loc, block)
            else:
                fluid.layers.kv_cache_copy(ck, sk, dst_loc, src_loc, block)
                fluid.layers.kv_cache_copy(cv, sv, dst_loc, src_loc, block)
        ok = fluid.layers.fill_constant(shape=[1], dtype="int32", value=1)
    return main, startup, ["dst_loc", "src_loc"], ok


def build_gpt_decode_step(cfg, slots, max_len):
    """Single-step decode program (``gpt.py:471``): one new token a slot.
    Feeds ``step_ids`` / ``step_pos`` [slots, 1, 1] (each slot's token
    and its cache position, where its K/V lands) and ``key_bias``
    [slots, max_len] (0 on live positions, -1e4 beyond). With flash the
    attention is the ``flash_decode_attention`` op. Returns (main,
    startup, feed names, step_logits [slots, vocab])."""
    cfg, main, startup = _serving_program(cfg)
    with fluid.program_guard(main, startup):
        step_ids = _data("step_ids", [1, 1])
        step_pos = _data("step_pos", [1, 1])
        key_bias = _data("key_bias", [max_len], "float32")
        logits = gpt_lm_logits(step_ids, step_pos, None, cfg, kv_cache={
            "mode": "decode",
            "caches": _declare_cache_vars(cfg, slots, max_len),
            "pos": step_pos, "key_bias": key_bias, "max_len": max_len})
        step_logits = fluid.layers.reshape(logits, shape=[-1, cfg.vocab_size])
    return main, startup, ["step_ids", "step_pos", "key_bias"], step_logits


def build_gpt_paged_window(cfg, blocks, block, max_blocks, seq_len):
    """Paged prefill-window program (``gpt.py:574``): ONE prompt window
    (batch 1, padded to ``seq_len``) written through the fed block
    ``table`` [1, max_blocks] at logical positions ``window_pos`` [1, 1]
    onward, then attending dense over the gathered logical row under
    ``resume_bias`` [1, seq_len, max_blocks*block]. Feeds ``ids``,
    ``pos_ids``, ``table``, ``window_pos``, ``resume_bias``,
    ``last_onehot``. Returns (main, startup, feed names, next_logits
    [1, vocab])."""
    cfg, main, startup = _serving_program(cfg)
    with fluid.program_guard(main, startup):
        ids = _data("ids", [seq_len, 1])
        pos_ids = _data("pos_ids", [seq_len, 1])
        table = _data("table", [max_blocks])
        window_pos = _data("window_pos", [1])
        resume_bias = _data("resume_bias", [seq_len, max_blocks * block],
                            "float32")
        last_onehot = _data("last_onehot", [seq_len, 1], "float32")
        logits = gpt_lm_logits(ids, pos_ids, None, cfg, kv_cache={
            "mode": "paged_window",
            "caches": _declare_paged_pool_vars(cfg, blocks, block),
            "tables": table, "pos": window_pos, "resume_bias": resume_bias,
            "max_len": max_blocks * block})
        next_logits = _last_logits(logits, last_onehot)
    feeds = ["ids", "pos_ids", "table", "window_pos", "resume_bias",
             "last_onehot"]
    return main, startup, feeds, next_logits


def build_gpt_paged_step(cfg, slots, blocks, block, max_blocks, step_w=1):
    """Paged step/verify program (``gpt.py:627``): every slot advances a
    ``step_w``-token window through its block table; ``step_w`` 1 is the
    decode step (the ``flash_decode_paged_attention`` op with flash),
    ``step_w`` k the speculative verify (gather + dense). Feeds
    ``step_ids`` / ``step_pos`` [slots, step_w, 1] (each slot's tokens
    and their contiguous positions), ``tables`` [slots, max_blocks] and
    ``step_bias`` [slots, step_w, max_blocks*block] (0 where position
    j <= step_pos[s, i], -1e4 beyond). Returns (main, startup, feed
    names, step_logits [slots*step_w, vocab])."""
    cfg, main, startup = _serving_program(cfg)
    with fluid.program_guard(main, startup):
        step_ids = _data("step_ids", [step_w, 1])
        step_pos = _data("step_pos", [step_w, 1])
        tables = _data("tables", [max_blocks])
        step_bias = _data("step_bias", [step_w, max_blocks * block],
                          "float32")
        # each slot writes from its window's first position
        write_pos = fluid.layers.reshape(
            fluid.layers.slice(step_pos, axes=[1], starts=[0], ends=[1]),
            shape=[-1])
        logits = gpt_lm_logits(step_ids, step_pos, None, cfg, kv_cache={
            "mode": "paged_step",
            "caches": _declare_paged_pool_vars(cfg, blocks, block),
            "tables": tables, "pos": write_pos, "step_bias": step_bias,
            "max_len": max_blocks * block})
        step_logits = fluid.layers.reshape(logits, shape=[-1, cfg.vocab_size])
    return main, startup, ["step_ids", "step_pos", "tables", "step_bias"], \
        step_logits


def build_gpt_paged_block_copy(cfg, blocks, block, npairs):
    """Pool-internal block copy in every layer's K and V pool
    (``gpt.py:666``): ``pool[dst[i]] = pool[src[i]]`` for the fed
    ``src`` / ``dst`` [1, npairs]. Returns (main, startup, ["src",
    "dst"], ok)."""
    main, startup = fluid.Program(), fluid.Program()
    main._donate_mutable = True
    with fluid.program_guard(main, startup):
        src = _data("src", [npairs])
        dst = _data("dst", [npairs])
        for pk, pv in _declare_paged_pool_vars(cfg, blocks, block):
            fluid.layers.kv_cache_block_copy(pk, src, dst)
            fluid.layers.kv_cache_block_copy(pv, src, dst)
        ok = fluid.layers.fill_constant(shape=[1], dtype="int32", value=1)
    return main, startup, ["src", "dst"], ok


# ---------------------------------------------------------------------------
# training: the eager form
# ---------------------------------------------------------------------------


def gpt_lm_loss(logits, ids, input_mask):
    """The loss of the reference's ``build_gpt_lm_train`` (:197-210):
    logits[:, t] predict ids[:, t + 1], the per-token cross entropy is
    masked at padded TARGET positions, and the sum is divided by the
    number of real targets. ``ids``/``input_mask``: [N, T] or
    [N, T, 1]."""
    N, T = ids.shape[0], ids.shape[1]
    loss = math_ops.softmax_with_cross_entropy(
        logits[:, :T - 1], ids.reshape(N, T, 1)[:, 1:])
    tgt_mask = input_mask.reshape(N, T, 1)[:, 1:].to(loss.dtype)
    return (loss * tgt_mask).sum() / tgt_mask.sum()


def build_gpt_lm_train_eager(cfg, seq_len, learning_rate=3e-4,
                             use_amp=False, device=None, seed=0):
    """The next-token LM train step of ``build_gpt_lm_train``, eagerly on
    torch autograd.

    Returns ``(model, optimizer, feed_names, step)``: a ``GPTLM`` in
    training mode with weights from ``init_fluid_params(cfg, seed)`` (load
    others with ``load_fluid_params``), an ``Adam`` over its parameters,
    the reference's feed names, and ``step(feed) -> loss``. ``feed``
    maps ``ids`` and ``pos_ids`` ([N, seq_len, 1] int64) and
    ``input_mask`` ([N, seq_len, 1] float32) to arrays or tensors; a
    step runs the forward, ``gpt_lm_loss``, the backward and one Adam
    update, and returns the loss as a float, read after the update. It
    runs under a ``train_step`` span and bumps the ``train_steps``
    counter and the ``train_step_ms`` histogram. Dropout draws its masks
    and flash seeds from a ``bert.DropoutRNG`` seeded with ``seed``.
    ``use_amp`` runs the forward with ``amp_dtype=torch.bfloat16`` (bf16
    products and attention, fp32 layer norms, loss and parameters: the
    casts of the AMP program) and the loss in fp32."""
    model = GPTLM(cfg, device=device)
    load_fluid_params(model, init_fluid_params(cfg, seed))
    model.rng = _bert.DropoutRNG(model.device, seed)
    model.train()
    opt = _optimizer.Adam(learning_rate=learning_rate,
                          parameter_list=model.parameters())
    feed_names = ["ids", "pos_ids", "input_mask"]
    amp_dtype = torch.bfloat16 if use_amp else None
    steps = [0]

    def step(feed):
        t0 = time.perf_counter()
        with trace.span("train_step", cat="train", step=steps[0]):
            ids, pos_ids, mask = (
                torch.as_tensor(feed[n], device=model.device)
                for n in feed_names)
            if ids.shape[1] != seq_len:
                raise ValueError("feed has %d positions, the step was built "
                                 "for %d" % (ids.shape[1], seq_len))
            logits = model(ids, pos_ids, mask, amp_dtype=amp_dtype).float()
            loss = gpt_lm_loss(logits, ids, mask)
            opt.minimize(loss)
            value = float(loss.detach())
        profiler.bump_histogram("train_step_ms",
                                (time.perf_counter() - t0) * 1e3)
        profiler.bump_counter("train_steps")
        steps[0] += 1
        return value

    return model, opt, feed_names, step
