"""Shared transformer pieces (port of the parts of
``paddle_tpu/models/bert.py`` the GPT serving and training paths use):
the flash policy, the key-only padding bias, the dropout helper and
where a training forward draws its random numbers, the FFN, and
multi-head attention with attention dropout in training and its
KV-cache modes: ``prefill`` and ``decode`` over the contiguous slot
pool, ``paged_window`` and ``paged_step`` over the paged pool.

The projections and the FFN are plain products (``nn.Linear``), as the
reference left them to XLA outside any Pallas kernel; the score /
softmax / context chain goes through the flash ops, which run the
hand-written kernels on the card.
"""

import math

import torch
from torch import nn

from ..fluid.ops import math_ops, nn_ops

__all__ = [
    "FLASH_AUTO_SEQ_THRESHOLD",
    "flash_wanted",
    "mask_to_key_bias",
    "DropoutRNG",
    "FFN",
    "MultiHeadAttention",
]

# The reference's dense/flash crossover for use_flash_attention="auto"
# was measured on a TPU; on the H100 it is still to be measured.
FLASH_AUTO_SEQ_THRESHOLD = 1024


def flash_wanted(cfg, seq_len=None):
    """Resolve ``cfg.use_flash_attention`` (True/False/"auto") to a bool:
    "auto" fuses at or beyond ``cfg.flash_auto_threshold`` (default
    ``FLASH_AUTO_SEQ_THRESHOLD``) when the sequence length is known."""
    want = getattr(cfg, "use_flash_attention", False)
    if want == "auto":
        thr = getattr(cfg, "flash_auto_threshold", FLASH_AUTO_SEQ_THRESHOLD)
        want = seq_len is not None and seq_len >= thr
    return bool(want)


def mask_to_key_bias(mask):
    """[N, S, 1] (or [N, S]) 0/1 token mask -> key-only additive bias
    [N, S]: 0 where attendable, -1e4 on padded keys."""
    return mask.reshape(mask.shape[0], -1).float() * 1e4 - 1e4


class DropoutRNG(object):
    """Where a training forward draws its random numbers: ``masks``, a
    ``torch.Generator`` on the model's device for the dropout op's masks,
    and ``seeds``, a CPU generator for the flash kernel's per-layer
    dropout seeds, drawn as Python ints so that no draw waits on the card.
    Both seeded from ``seed``."""

    def __init__(self, device, seed=0):
        self.masks = torch.Generator(device=device).manual_seed(int(seed))
        self.seeds = torch.Generator().manual_seed(int(seed) + 1)


def _dropout(x, rate, is_test, rng=None):
    """``bert._dropout`` (:51): the dropout op with its default
    ``downgrade_in_infer`` (x·mask in training, no upscale), skipped
    entirely at ``is_test`` or rate 0 — the reference's train/infer
    mismatch, kept as it is."""
    if is_test or rate <= 0.0:
        return x
    return nn_ops.dropout(x, dropout_prob=rate,
                          generator=None if rng is None else rng.masks)


class FFN(nn.Module):
    """fc0 (exact-erf GELU) -> fc1."""

    def __init__(self, hidden_size, intermediate_size, device=None):
        super().__init__()
        self.fc0 = nn.Linear(hidden_size, intermediate_size, device=device)
        self.fc1 = nn.Linear(intermediate_size, hidden_size, device=device)

    def forward(self, x):
        return self.fc1(math_ops.gelu(self.fc0(x)))


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
                use_flash=False, cache=None, dropout_rate=0.0, rng=None):
        scale = 1.0 / math.sqrt(self.d_head)
        q = self._split_heads(self.q(x))
        k = self._split_heads(self.k(x))
        v = self._split_heads(self.v(x))
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
            scores = torch.matmul(q, k.transpose(-1, -2)) * scale
            if attn_bias is not None:
                scores = scores + attn_bias
            weights = _dropout(math_ops.softmax(scores), dropout_rate,
                               not training, rng)
            ctxt = torch.matmul(weights, v)
        return self.out(self._merge_heads(ctxt))
