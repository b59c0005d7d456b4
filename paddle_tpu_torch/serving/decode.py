"""Autoregressive decode runtime: KV cache + continuous batching (port of
``paddle_tpu/serving/decode.py``: the contiguous slot pool with its
prefix store, chunked and resume prefill, the paged engine with
speculative decoding, and the priority/tenant scheduler).

Contiguous pool (``block_size`` 0):

  prefill  one prompt, padded to its bucket of the prompt-length ladder,
           runs the causal forward and writes its per-layer K/V into a
           slot of the cache pool (the flash prefill kernel on the card);
  decode   every engine tick runs ONE fused single-token step over all
           slots, each slot masked by its own length through the key bias
           (the flash decode kernel on the card).

  The cache is a fixed pool of ``slots`` rows per layer, device tensors
  [slots, heads, max_len, d_head] written in place. Admission writes a
  slot row, retirement frees the index; neither changes a tensor shape.

  prefix store   ``prefix_cache_mb`` > 0 arms a device block store
                 (per-layer [blocks, heads, block, d_head]) indexed by
                 ``PrefixCache`` under the hash chain of prompt blocks:
                 admission copies the longest cached prefix into the
                 slot row and only the suffix runs, as a **resume
                 window** (a prompt window prefilled at an offset of the
                 row, attending densely over the whole row); a finished
                 prefill publishes its blocks back under LRU eviction.
  chunked prefill  ``prefill_chunk`` caps the prompt tokens one tick
                 prefills: a long prompt admits as resume windows, one a
                 tick, interleaved with the fused decode steps.

Paged pool (``block_size`` > 0, engine v2):

  one pool per layer [pool_blocks, heads, block, d_head] shared by every
  slot and the prefix index, addressed through per-slot block tables
  (host lists, ``BlockAllocator`` refcounts; block 0 is the sink that
  idle slots write into). Prompts prefill as bucket-shaped windows
  through the table (``prefill_chunk`` caps a window); a prefix hit is a
  table edit (``PagedPrefixIndex``, zero copy). Each tick runs ONE fused
  step: width 1 is the decode step (the paged flash decode kernel on the
  card), width ``spec_tokens`` = k the speculative verify of the pending
  token plus a k-1-token draft, accepted on the host up to the first
  mismatch and rolled back by table edit.

Both pools serve ``resume_tokens`` (a request resumed after an
interrupted run: prompt + emitted suffix re-prefill, and the stream
emits only the continuation) and the scheduler: dequeue is interactive
before batch, then weighted-fair across tenants (``sched_tenant_weights``),
and with ``sched_preempt`` a waiting interactive request evicts a batch
stream, which re-admits token-exactly later.

``DecodeSession`` is the synchronous core (caches or pools, prefill,
windows, block copies, fused step), over an eager ``GPTLM`` or, given a
``GPTConfig`` (``ProgramDecodeSession``), over the reference's serving
programs run by a ``fluid.Executor``; ``DecodeEngine`` owns the loop
thread (admission queue, prefix store, windows, streaming, retirement)
and publishes its gauges to ``observability.registry`` while it runs.
As the reference's engine it starts the exporter at ``start()``, arms
the strict build gate (``observability.compile_stats``) after its
warmup and runs every window, copy and step inside a
``serving_request_window``; a stream carries the trace context it was
submitted under, re-entered around its slot's windows, and each fused
tick of traced streams is a ``decode_tick`` span listing their trace
ids.

Fleet KV tier (``kv_tier_host_mb`` > 0, paged pool with a prefix
index): an index eviction pins the victim block and hands it to a spill
worker, which gathers the victims' rows on the card and copies only
those rows to a ``kv_tier.HostBlockStore``; an admission whose chain
runs past the device index readmits the spilled blocks H2D into fresh
pool blocks instead of prefilling them again. ``request_export`` reads a
prompt's published chain out of the pool (a prefill-role replica's
``/v1/kv/prefill``) and ``offer_blocks`` drops a pulled chain into the
host store; ``prefix_heads`` and ``estimate_cached_tokens`` are the
router's affinity advertisement and the gateway's pull signal. A
payload is the reference's: per layer a ``(k_rows, v_rows)`` pair of
numpy arrays [heads, block, d_head] in the pool's dtype. Left for a
later slice, as in ROADMAP.md: tensor parallelism.
"""

import contextlib
import copy
import queue
import re
import threading
import time
from collections import OrderedDict, deque

import numpy as np
import torch

from ..fluid import core as _core
from ..fluid import executor as _executor
from ..fluid import flags as _flags
from ..fluid import framework as _framework
from ..fluid import profiler as _profiler
from ..fluid import unique_name as _unique_name
from ..fluid.ops import nn_ops as _nn_ops
from ..models import gpt as _gpt
from ..observability import compile_stats as _compile_stats
from ..observability import exporter as _obs_exporter
from ..observability import registry as _registry
from ..observability import trace as _trace
from . import kv_tier as _kv_tier
from .batcher import ServerOverloadedError, ServingError

__all__ = [
    "BlockAllocator",
    "DecodeSession",
    "DecodeEngine",
    "GenerationStream",
    "PagedPrefixIndex",
    "PrefixCache",
    "ProgramDecodeSession",
    "fast_forward_rng",
    "prefill_ladder",
    "sample_token",
    "session_for_generate",
]


def _flag(name, override):
    return override if override is not None else _flags.get_flag(name)


def prefill_ladder(max_len, buckets=None):
    """Ascending prompt-length buckets. ``buckets``: explicit list/CSV,
    or None for the default powers-of-two ladder from 8, capped by (and
    always including) ``max_len``."""
    if isinstance(buckets, str):
        buckets = [int(b) for b in buckets.split(",") if b.strip()]
    if buckets:
        out = sorted(set(int(b) for b in buckets))
        if out[0] < 1:
            raise ValueError("prefill buckets must be positive: %r"
                             % (buckets,))
        kept = [b for b in out if b <= max_len]
        if len(kept) != len(out):
            import warnings

            warnings.warn(
                "prefill buckets %r exceed max_len %d and were dropped"
                "%s" % (
                    [b for b in out if b > max_len], max_len,
                    "; every prompt now pads to the full-length program"
                    if not kept else "",
                ), stacklevel=2)
        out = kept
        if not out or out[-1] != max_len:
            out.append(int(max_len))
        return out
    out = []
    b = 8
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(int(max_len))
    return out


# ---------------------------------------------------------------------------
# paged pool bookkeeping — host side, loop thread only
# ---------------------------------------------------------------------------


# the chain digest is shared with the host store, the wire codec and
# the router's affinity scorer, so the one definition lives in kv_tier
_block_hash = _kv_tier.block_hash


class _PrefixEntry(object):
    __slots__ = ("key", "prev", "tokens", "block_idx", "refs")

    def __init__(self, key, prev, tokens, block_idx):
        self.key = key
        self.prev = prev
        self.tokens = tokens
        self.block_idx = block_idx
        self.refs = 0  # PrefixCache pins (the paged index pins blocks
        # through the allocator)


class PrefixCache(object):
    """Host index of the contiguous pool's prefix store: maps hash-chained
    prompt blocks to store block indices, with LRU eviction and refcount
    pins. The device store itself (per-layer [blocks, heads, block,
    d_head] tensors) belongs to ``DecodeSession``; this class decides
    which block lives where, and the engine moves the bytes.

    One mutator, the engine's loop thread. Pins exist so that an
    eviction forced by one admission's publish never reclaims a block
    another admission is still copying from (``refs > 0`` entries are
    skipped by the LRU sweep)."""

    def __init__(self, blocks, block):
        if blocks < 1 or block < 1:
            raise ValueError("need blocks >= 1 and block >= 1, got %d / %d"
                             % (blocks, block))
        self.blocks = int(blocks)
        self.block = int(block)
        self._entries = OrderedDict()  # key -> _PrefixEntry, LRU order
        self._free = list(range(self.blocks))
        self.evictions = 0

    def __len__(self):
        return len(self._entries)

    def lookup(self, prompt):
        """Longest cached block-chain prefix of ``prompt``, capped at
        ``len(prompt) - 1`` tokens so admission always recomputes the
        last prompt token (its logits give the first emitted token).
        Every returned entry is pinned: the caller ``release``s them once
        its copy is done. A collision (equal key, another stored link)
        stops the chain. Returns (entries, tokens)."""
        usable = (len(prompt) - 1) // self.block
        out = []
        prev = 0
        for b in range(usable):
            toks = tuple(prompt[b * self.block:(b + 1) * self.block])
            key = _block_hash(prev, toks)
            e = self._entries.get(key)
            # verify the whole chain link, not only this block's tokens
            if e is None or e.tokens != toks or e.prev != prev:
                break
            out.append(e)
            prev = key
        for e in out:
            e.refs += 1
            self._entries.move_to_end(e.key)
        return out, len(out) * self.block

    def release(self, entries):
        for e in entries:
            e.refs -= 1

    def publish(self, prompt):
        """Register every full block of ``prompt`` not cached yet.
        Returns [(entry, prompt block index)] for the new entries: the
        caller copies those blocks from the slot row into
        ``entry.block_idx`` (or ``forget``s them on failure). A full
        store evicts its least recently used unpinned entry; an
        all-pinned store stops publishing."""
        new = []
        prev = 0
        for b in range(len(prompt) // self.block):
            toks = tuple(prompt[b * self.block:(b + 1) * self.block])
            key = _block_hash(prev, toks)
            e = self._entries.get(key)
            if e is not None:
                if e.tokens != toks or e.prev != prev:
                    break  # collision squatting on the key
                self._entries.move_to_end(key)
                prev = key
                continue
            idx = self._alloc()
            if idx is None:
                break  # every block pinned by in-flight copies
            e = _PrefixEntry(key, prev, toks, idx)
            self._entries[key] = e
            new.append((e, b))
            prev = key
        return new

    def forget(self, entry):
        """Drop a registration whose copy failed: the block returns to
        the free list and the key stops matching."""
        if self._entries.get(entry.key) is entry:
            del self._entries[entry.key]
            self._free.append(entry.block_idx)

    def _alloc(self):
        if self._free:
            return self._free.pop()
        victim = None
        for e in self._entries.values():  # oldest first
            if e.refs <= 0:
                victim = e
                break
        if victim is None:
            return None
        del self._entries[victim.key]
        self.evictions += 1
        _profiler.bump_counter("decode_prefix_evictions")
        return victim.block_idx

    def stats(self):
        return {"blocks": self.blocks, "block": self.block,
                "cached_blocks": len(self._entries),
                "evictions": self.evictions}


class BlockAllocator(object):
    """Free list + refcounts over the paged pool's physical blocks. Block
    0 is the SINK: idle and prefilling slots park their tables on it, so
    the fused step's unconditional writes never touch a live block; it
    is never handed out. Sharing is a refcount: a prefix-index entry and
    any number of slots may reference one block, and whoever drops the
    last reference returns it to the free list."""

    SINK = 0

    def __init__(self, blocks):
        if blocks < 2:
            raise ValueError(
                "paged pool needs >= 2 blocks (sink + 1), got %d" % blocks)
        self.blocks = int(blocks)
        self._free = list(range(self.blocks - 1, 0, -1))  # pop() -> low ids
        self._refs = [0] * self.blocks
        self._refs[self.SINK] = 1  # permanently pinned

    def alloc(self, n):
        """Take ``n`` fresh blocks (refcount 1 each), or None when the
        free list cannot cover all of them: all or nothing, so a half
        admitted slot never holds a partial table."""
        if n < 0:
            raise ValueError("alloc(%d)" % n)
        if n == 0:
            return []
        if len(self._free) < n:
            return None
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._refs[b] = 1
        return out

    def incref(self, block_ids):
        for b in block_ids:
            if not 0 < b < self.blocks or self._refs[b] <= 0:
                raise ValueError("incref on dead/sink block %d" % b)
            self._refs[b] += 1

    def decref(self, block_ids):
        """Drop one reference per id; blocks reaching zero return to the
        free list. Returns the number freed."""
        freed = 0
        for b in block_ids:
            if not 0 < b < self.blocks or self._refs[b] <= 0:
                raise ValueError("decref on dead/sink block %d" % b)
            self._refs[b] -= 1
            if self._refs[b] == 0:
                self._free.append(b)
                freed += 1
        return freed

    def refs(self, block_id):
        return self._refs[block_id]

    @property
    def free_blocks(self):
        return len(self._free)

    @property
    def shared_blocks(self):
        return sum(1 for r in self._refs[1:] if r > 1)

    def stats(self):
        return {"blocks": self.blocks, "free": self.free_blocks,
                "shared": self.shared_blocks}


class PagedPrefixIndex(object):
    """Hash-chain prefix index over the paged pool, zero copy: an entry
    points at the pool block a slot wrote when it prefilled that prompt
    block, held alive by one allocator reference. A hit puts the entry's
    block into the admitted slot's table and increfs it; no device copy
    moves. Eviction is a decref: a block live slots still share survives
    until the last of them retires. ``max_blocks`` caps how many blocks
    the index itself may pin (the paged reading of
    ``decode_prefix_cache_mb``).

    ``on_evict`` is the host-spill seam (kv_tier): called with the
    victim entry before the index drops its reference, while the block's
    bytes are still live; the engine's hook pins the block and hands it
    to the spill worker. It must not mutate the index."""

    def __init__(self, block, max_blocks, allocator, on_evict=None):
        if block < 1 or max_blocks < 1:
            raise ValueError(
                "need block >= 1 and max_blocks >= 1, got %d / %d"
                % (block, max_blocks))
        self.block = int(block)
        self.max_blocks = int(max_blocks)
        self.allocator = allocator
        self.on_evict = on_evict
        self._entries = OrderedDict()  # key -> _PrefixEntry, LRU order
        self.evictions = 0

    def __len__(self):
        return len(self._entries)

    def lookup(self, prompt):
        """Longest cached block-chain prefix of ``prompt``, capped at
        ``len(prompt) - 1`` tokens so admission always recomputes the
        last prompt token (its logits give the first emitted token).
        Every matched entry's block is increfed for the caller: those
        references become the slot's table entries, and a failed
        admission must decref them. Returns (entries, tokens)."""
        usable = (len(prompt) - 1) // self.block
        out = []
        prev = 0
        for b in range(usable):
            toks = tuple(prompt[b * self.block:(b + 1) * self.block])
            key = _block_hash(prev, toks)
            e = self._entries.get(key)
            # verify the whole chain link, not only this block's tokens:
            # a key collision with equal tokens but another parent would
            # otherwise splice another prompt's K/V into this request
            if e is None or e.tokens != toks or e.prev != prev:
                break
            out.append(e)
            prev = key
        for e in out:
            self.allocator.incref([e.block_idx])
            self._entries.move_to_end(e.key)
        return out, len(out) * self.block

    def publish(self, prompt, slot_blocks):
        """Index every full block of ``prompt`` not indexed yet, each new
        entry pointing at the slot's own block ``slot_blocks[b]`` (one
        incref, the index's reference). Stops at a collision, a missing
        slot block, or a pin budget full of shared blocks. Returns the
        new entries."""
        new = []
        prev = 0
        for b in range(len(prompt) // self.block):
            toks = tuple(prompt[b * self.block:(b + 1) * self.block])
            key = _block_hash(prev, toks)
            e = self._entries.get(key)
            if e is not None:
                if e.tokens != toks or e.prev != prev:
                    break  # collision squatting on the key
                self._entries.move_to_end(key)
                prev = key
                continue
            if b >= len(slot_blocks):
                break
            if len(self._entries) >= self.max_blocks:
                if not self.evict_one():
                    break
            e = _PrefixEntry(key, prev, toks, slot_blocks[b])
            self.allocator.incref([e.block_idx])
            self._entries[key] = e
            new.append(e)
            prev = key
        return new

    def forget(self, entry):
        if self._entries.get(entry.key) is entry:
            del self._entries[entry.key]
            self.allocator.decref([entry.block_idx])

    def evict_one(self, need_free=False):
        """Drop the least recently used entry, preferring one whose block
        the index alone references (the decref frees it). With
        ``need_free`` only such entries are taken (the allocator-pressure
        path: evicting a block a slot shares frees nothing). Returns True
        when an entry was dropped."""
        victim = None
        for e in self._entries.values():  # oldest first
            if self.allocator.refs(e.block_idx) == 1:
                victim = e
                break
        if victim is None:
            if need_free:
                return False
            victim = next(iter(self._entries.values()), None)
            if victim is None:
                return False
        if self.on_evict is not None:
            try:
                self.on_evict(victim)
            except Exception:  # noqa: BLE001 - spilling is best effort
                pass
        del self._entries[victim.key]
        self.allocator.decref([victim.block_idx])
        self.evictions += 1
        _profiler.bump_counter("decode_prefix_evictions")
        return True

    def admit(self, key, prev, tokens, block_idx):
        """Index a block rebuilt from outside the pool (a host-store
        readmission or a pulled peer payload) under its chain key. The
        caller owns ``block_idx`` with exactly one reference and hands it
        to the index (no slot holds it, so no incref). Returns the new
        entry, or None when the key is already indexed or no room can be
        made; the caller then keeps its reference."""
        toks = tuple(int(t) for t in tokens)
        if self._entries.get(key) is not None:
            return None
        if len(self._entries) >= self.max_blocks:
            if not self.evict_one():
                return None
        e = _PrefixEntry(key, prev, toks, block_idx)
        self._entries[key] = e
        return e

    def head_keys(self, k):
        """The newest ``k`` chain keys, newest first: the replica's cache
        affinity advertisement. Read without the loop's lock off the
        gateway thread: the dict view is copied first, and a racing
        change at worst gives a slightly stale list, which the router's
        staleness bound tolerates."""
        try:
            keys = list(self._entries.keys())
        except RuntimeError:  # resized mid-copy: advertise nothing
            return []
        return keys[-int(k):][::-1] if k > 0 else []

    def stats(self):
        return {"block": self.block, "max_blocks": self.max_blocks,
                "cached_blocks": len(self._entries),
                "evictions": self.evictions}


class DecodeSession(object):
    """Synchronous KV-cache decode core, in two forms.

    ``DecodeSession(model, ...)`` runs a ``GPTLM`` eagerly: it owns the
    per-layer cache tensors (on the model's device, zeroed at
    construction) and calls the model's serving entry points.
    ``DecodeSession(cfg, place=None, scope=None, ...)`` (a ``GPTConfig``
    first, the reference's form, ``decode.py:521``) runs the reference's
    serving programs (``gpt.build_gpt_*``) through its own
    ``fluid.Executor`` over ``scope`` (``ProgramDecodeSession``).

    Both expose the reference's ``prefill`` / ``decode_step`` and the
    rest with the reference's feeds; the host work (validation, masks,
    spans, counters) is shared, only the device call differs. One caller
    at a time: the engine's loop thread, or a ``greedy_generate`` caller
    holding ``lock``.

    ``block_size`` > 0 (default ``FLAGS_decode_block_size``) makes it a
    paged session instead: one pool per layer [pool_blocks, heads,
    block_size, d_head] (default ``slots * max_blocks + 1``, the sink
    included), prompt windows through ``paged_window``, the fused step
    through ``paged_step`` at width 1 and, with ``spec_tokens`` = k > 1,
    at width k, and ``block_copy`` for copy-on-write. The prompt ladder
    then shapes windows, capped at ``window_cap`` (0 = ``max_len``).

    A contiguous session built with ``build_resume`` (or a prefix store)
    also prefills windows at an offset of a slot row (``resume_prefill``:
    prefix hits, chunked prefill, resumed and preempted requests);
    ``prefix_blocks`` > 0 adds the per-layer prefix store [prefix_blocks,
    heads, prefix_block, d_head] (``prefix_block`` default
    ``FLAGS_decode_prefix_block``) and the block moves between it and the
    slot rows (``prefix_copy_in``, ``prefix_publish``)."""

    def __new__(cls, model=None, *args, **kwargs):
        if cls is DecodeSession and isinstance(kwargs.get("cfg", model),
                                               _gpt.GPTConfig):
            cls = ProgramDecodeSession
        return object.__new__(cls)

    def __init__(self, model, slots=None, max_len=None,
                 prefill_buckets=None, block_size=None, spec_tokens=None,
                 pool_blocks=0, window_cap=0, prefix_blocks=0,
                 prefix_block=None, build_resume=False):
        self.model = model
        self.device = model.device
        self._setup(model.cfg, slots, max_len, prefill_buckets, block_size,
                    spec_tokens, pool_blocks, window_cap, prefix_blocks,
                    prefix_block, build_resume)
        # per-layer (k, v): the contiguous caches, or the paged pools
        self.caches, self.stores = self._alloc()
        self._pos_cache = {
            T: torch.arange(T, device=self.device).reshape(1, T, 1)
            for T in self.buckets
        }

    def _setup(self, cfg, slots, max_len, prefill_buckets, block_size,
               spec_tokens, pool_blocks, window_cap, prefix_blocks,
               prefix_block, build_resume):
        """The geometry both forms share: slots, lengths, the pool or the
        caches and the prefix store, the ladder, the state's names."""
        self.cfg = cfg
        self.slots = int(_flag("decode_slots", slots))
        max_len = int(_flag("decode_max_len", max_len))
        if max_len <= 0:
            max_len = int(self.cfg.max_position_embeddings)
        if max_len > self.cfg.max_position_embeddings:
            raise ValueError(
                "decode max_len %d exceeds max_position_embeddings %d"
                % (max_len, self.cfg.max_position_embeddings))
        if self.slots < 1 or max_len < 2:
            raise ValueError("need slots >= 1 and max_len >= 2, got %d / %d"
                             % (self.slots, max_len))
        self.max_len = max_len
        self.block_size = int(_flag("decode_block_size", block_size))
        self.spec_tokens = max(int(_flag("decode_spec_tokens", spec_tokens)),
                               0)
        self.paged = self.block_size > 0
        ladder_top = max_len
        if self.paged:
            width = max(self.spec_tokens, 1)
            # the verify writes and embeds positions up to max_len + k - 2
            # (a slot one token from the wall still feeds a full window)
            if max_len + width - 1 > self.cfg.max_position_embeddings:
                raise ValueError(
                    "paged decode needs max_len + spec_tokens - 1 <= "
                    "max_position_embeddings (%d + %d - 1 > %d): lower "
                    "decode_max_len or decode_spec_tokens"
                    % (max_len, width, self.cfg.max_position_embeddings))
            self.max_blocks = -(-(max_len + width - 1) // self.block_size)
            self.pool_blocks = int(pool_blocks) or (
                self.slots * self.max_blocks + 1)
            if self.pool_blocks < 2:
                raise ValueError("paged pool needs >= 2 blocks (sink + 1), "
                                 "got %d" % self.pool_blocks)
            self.widths = [1] + ([self.spec_tokens]
                                 if self.spec_tokens > 1 else [])
            ladder_top = min(max_len, max(int(window_cap) or max_len, 1))
            self._names = _gpt.paged_pool_names(self.cfg, self.pool_blocks,
                                                self.block_size)
            self._cols = np.arange(self.max_blocks * self.block_size)
        else:
            self._names = _gpt.decode_cache_names(self.cfg, self.slots,
                                                  max_len)
            self._cols = np.arange(max_len)
        self.buckets = prefill_ladder(
            ladder_top,
            _flag("decode_prefill_buckets", prefill_buckets) or None)
        self.prefills = 0
        self.steps = 0
        self.lock = threading.RLock()
        self.prefix_block = int(_flag("decode_prefix_block", prefix_block))
        self.prefix_blocks = int(prefix_blocks)
        if self.prefix_blocks < 0 or self.prefix_block < 1:
            raise ValueError(
                "need prefix_blocks >= 0 and prefix_block >= 1, got %d / %d"
                % (self.prefix_blocks, self.prefix_block))
        # resume windows and the prefix store ride the contiguous pool
        # only: the paged pool prefills every window through its tables
        self.resumable = bool(build_resume or self.prefix_blocks) \
            and not self.paged
        self._store_names = []
        if self.prefix_blocks and not self.paged:
            self._store_names = _gpt.prefix_store_names(
                self.cfg, self.prefix_blocks, self.prefix_block)

    def _alloc(self):
        """Zeroed (caches or pools, prefix stores) on the session's
        device, each a list of per-layer (k, v) fp32 tensors."""
        if self.paged:
            shape = _gpt.paged_pool_shape(self.cfg, self.pool_blocks,
                                          self.block_size)
        else:
            shape = _gpt.decode_cache_shape(self.cfg, self.slots,
                                            self.max_len)
        pshape = _gpt.prefix_store_shape(self.cfg, self.prefix_blocks,
                                         self.prefix_block)

        def pairs(n, shp):
            return [(torch.zeros(shp, dtype=torch.float32, device=self.device),
                     torch.zeros(shp, dtype=torch.float32, device=self.device))
                    for _ in range(n)]

        return (pairs(len(self._names), shape),
                pairs(len(self._store_names), pshape))

    def cache_tensors(self):
        """{name: tensor}: the caches (or paged pools) and the prefix
        store, under the reference's names."""
        out = {}
        for (k_name, v_name), (k, v) in zip(
                self._names + self._store_names, self.caches + self.stores):
            out[k_name] = k
            out[v_name] = v
        return out

    def reset_caches(self):
        """Zero every cache and store tensor in place. Correctness never
        depends on it (prefill replaces a slot's row head and the key
        bias masks the rest), but fresh caches keep warmup and tests
        deterministic."""
        for k, v in self.caches + self.stores:
            k.zero_()
            v.zero_()

    def warmup(self):
        """Run each prefill bucket once (and each resume window bucket and
        both block copies where armed) and the decode step once (paged:
        each window bucket and each step width through all-sink tables,
        and the block copy), then zero the caches: every kernel and, in
        the program form, every Executor plan is built before a strict
        build gate is armed. Returns the session."""
        with _compile_stats.warmup_window(), _trace.span(
                "decode_warmup", cat="serving"):
            if self.paged:
                sink = [BlockAllocator.SINK] * self.max_blocks
                for T in self.buckets:
                    self.paged_window(sink, [0] * T, 0)
                for w in self.widths:
                    self.paged_step(np.zeros((self.slots, w), "int64"),
                                    [0] * self.slots, None,
                                    [False] * self.slots, width=w)
                self.block_copy([BlockAllocator.SINK], [BlockAllocator.SINK])
            else:
                for T in self.buckets:
                    self.prefill(0, [0] * min(T, self.max_len - 1))
                if self.resumable:
                    for T in self.buckets:
                        self.resume_prefill(0, [0] * T, 0)
                if self.stores:
                    self.prefix_copy_in(0, 0, 0)
                    self.prefix_publish(0, 0, 0)
                self.decode_step([0] * self.slots, [0] * self.slots,
                                 [False] * self.slots)
            self.reset_caches()
        return self

    def bucket_for(self, prompt_len):
        for b in self.buckets:
            if b >= prompt_len:
                return b
        raise ValueError(
            "prompt of %d tokens exceeds the prefill ladder (max %d)"
            % (prompt_len, self.buckets[-1]))

    def _to_device(self, arr):
        return torch.from_numpy(arr).to(self.device, non_blocking=True)

    def _window_feed(self, window_ids, T, offset, bias=True):
        """The padded ids [1, T, 1], positions ``offset ..`` [1, T, 1],
        ``last_onehot`` [1, T, 1] and (``bias``) the offset-shifted
        causal ``resume_bias`` [1, T, S] over the row of a window: query
        i at row position offset + i sees positions <= offset + i; pad
        queries keep a finite row, their output never selected."""
        P = len(window_ids)
        ids = np.zeros((1, T, 1), "int64")
        ids[0, :P, 0] = window_ids
        last_onehot = np.zeros((1, T, 1), "float32")
        last_onehot[0, P - 1, 0] = 1.0
        feed = {"ids": ids,
                "pos_ids": (offset + np.arange(T)).reshape(1, T, 1)
                .astype("int64"),
                "last_onehot": last_onehot}
        if bias:
            allow = self._cols[None, :] <= (offset + np.arange(T))[:, None]
            feed["resume_bias"] = np.where(allow, 0.0, -1e4).astype(
                "float32")[None]
        return feed

    def _tables_feed(self, tables):
        """[len(tables), max_blocks] int64 block tables (logical block
        order; unused entries the sink)."""
        tbl = np.zeros((len(tables), self.max_blocks), "int64")
        for s, row in enumerate(tables):
            if len(row):
                tbl[s, :len(row)] = row
        return tbl

    def prefill(self, slot, prompt_ids):
        """Run the prompt through its bucket's prefill, writing slot
        ``slot``'s cache row; returns the next-token logits [vocab] at the
        last real prompt position (a host numpy array)."""
        P = len(prompt_ids)
        if self.paged:
            raise RuntimeError("prefill on a paged session (paged_window)")
        if not 0 <= slot < self.slots:
            raise ValueError("slot %d out of range" % slot)
        if P < 1:
            raise ValueError("empty prompt")
        T = self.bucket_for(P)
        feed = self._window_feed(prompt_ids, T, 0, bias=False)
        feed["input_mask"] = (np.arange(T) < P).astype("float32") \
            .reshape(1, T, 1)
        feed["slot_idx"] = np.array([[slot]], "int64")
        t0 = time.perf_counter()
        with _trace.span("decode_prefill", cat="serving", bucket=T, rows=P):
            out = self._run_prefill(T, feed)[0]
        _profiler.bump_counter("decode_prefills")
        self.prefills += 1
        _profiler.bump_histogram("decode_prefill_ms",
                                 (time.perf_counter() - t0) * 1e3)
        return out

    def resume_prefill(self, slot, window_ids, offset):
        """Prefill a prompt window from cache position ``offset`` of slot
        ``slot``'s row: the suffix after a copied prefix, or one chunk of
        a chunked prefill. The window pads to its bucket; its queries
        attend over the whole row under the causal mask shifted by the
        offset. Returns the logits [vocab] at the window's last real
        token (host numpy; the next-token logits on a prompt's final
        window)."""
        P = len(window_ids)
        if not 0 <= slot < self.slots:
            raise ValueError("slot %d out of range" % slot)
        if P < 1:
            raise ValueError("empty resume window")
        if not self.resumable:
            raise RuntimeError("session built without resume windows")
        T = self.bucket_for(P)
        offset = int(offset)
        if offset < 0 or offset + T > self.max_len:
            raise ValueError(
                "resume window bucket [%d, %d) exceeds max_len %d: the "
                "engine's window planner must pick a fitting bucket"
                % (offset, offset + T, self.max_len))
        feed = self._window_feed(window_ids, T, offset)
        feed["slot_off"] = np.array([[slot, offset]], "int64")
        t0 = time.perf_counter()
        with _trace.span("decode_resume_prefill", cat="serving", bucket=T,
                         rows=P, offset=offset):
            out = self._run_resume(T, feed)[0]
        _profiler.bump_counter("decode_prefills")
        self.prefills += 1
        _profiler.bump_histogram("decode_prefill_ms",
                                 (time.perf_counter() - t0) * 1e3)
        return out

    def prefix_copy_in(self, slot, dst_pos, src_block):
        """Copy prefix-store block ``src_block`` into slot ``slot``'s row
        at position ``dst_pos``, every layer's K and V: a hit's
        replacement for recomputing a block's prefill."""
        if not self.stores:
            raise RuntimeError("session built without a prefix store")
        with _trace.span("decode_prefix_copy", cat="serving",
                         block=src_block, pos=dst_pos):
            self._run_prefix_copy((slot, dst_pos), (src_block, 0), False)

    def prefix_publish(self, slot, src_pos, dst_block):
        """Copy one block of slot ``slot``'s finished prefill (row
        position ``src_pos``) into prefix-store block ``dst_block``, so
        later admissions can reuse it."""
        if not self.stores:
            raise RuntimeError("session built without a prefix store")
        with _trace.span("decode_prefix_publish", cat="serving",
                         block=dst_block, pos=src_pos):
            self._run_prefix_copy((dst_block, 0), (slot, src_pos), True)

    def decode_step(self, tokens, positions, active):
        """ONE fused step over all slots: slot i's ``tokens[i]`` lands at
        cache position ``positions[i]`` and its next-token logits come
        back. Slots with ``active[i]`` False feed an inert zero token at
        their caller-chosen position and a fully masked key bias; their
        output is ignored. A free slot's dead row tolerates any landing
        spot, but a row mid-chunked-prefill is live, so the engine aims
        its write at the next window's start (overwritten before any
        query reads it). Returns logits [slots, vocab] (host numpy)."""
        if self.paged:
            raise RuntimeError("decode_step on a paged session (paged_step)")
        act = np.asarray(active, bool)
        pos = np.asarray(positions, "int64")
        tok = np.where(act, np.asarray(tokens, "int64"), 0)
        feed = {
            "step_ids": tok.reshape(self.slots, 1, 1),
            "step_pos": pos.reshape(self.slots, 1, 1),
            "key_bias": ((self._cols[None, :] > pos[:, None])
                         | ~act[:, None]).astype("float32") * -1e4,
        }
        t0 = time.perf_counter()
        with _trace.span("decode_step", cat="serving",
                         active=int(act.sum())):
            out = self._run_decode(feed)
        _profiler.bump_counter("decode_steps")
        self.steps += 1
        _profiler.bump_histogram("decode_step_ms",
                                 (time.perf_counter() - t0) * 1e3)
        return out

    # -- paged device steps --------------------------------------------------
    def paged_window(self, table, window_ids, offset):
        """Prefill one prompt window (batch 1) through the block ``table``
        (the slot's pool block ids, logical block order): window token i
        lands at logical position ``offset + i``. The paged runtime's
        only prefill form (offset 0 = the whole prompt). Returns the
        logits [vocab] at the window's last real token (host numpy)."""
        P = len(window_ids)
        if not self.paged:
            raise RuntimeError("paged_window on a non-paged session")
        if P < 1:
            raise ValueError("empty prefill window")
        T = self.bucket_for(P)
        offset = int(offset)
        span = self.max_blocks * self.block_size
        if offset < 0 or offset + T > span:
            raise ValueError(
                "paged window bucket [%d, %d) exceeds the table span %d"
                % (offset, offset + T, span))
        # the -1e4 side of the bias also buries sink garbage past the
        # live length
        feed = self._window_feed(window_ids, T, offset)
        feed["table"] = self._tables_feed([table])
        feed["window_pos"] = np.array([[offset]], "int64")
        t0 = time.perf_counter()
        with _trace.span("decode_paged_window", cat="serving", bucket=T,
                         rows=P, offset=offset):
            out = self._run_paged_window(T, feed)[0]
        _profiler.bump_counter("decode_prefills")
        self.prefills += 1
        _profiler.bump_histogram("decode_prefill_ms",
                                 (time.perf_counter() - t0) * 1e3)
        return out

    def paged_step(self, tokens, positions, tables, active, width=1):
        """ONE fused paged step over all slots: slot s advances the
        ``width``-token window ``tokens[s]`` at logical positions
        ``positions[s] .. positions[s] + width - 1`` through its block
        table ``tables[s]``. Width 1 is the decode step; width k the
        speculative verify (all k positions scored in one call).
        Inactive slots feed an all-sink table (their writes land in
        block 0) and a fully masked bias; their output is ignored.
        Returns logits [slots, width, vocab] (host numpy)."""
        if not self.paged:
            raise RuntimeError("paged_step on a non-paged session")
        if width not in self.widths:
            raise ValueError("no paged step of width %d (this session has "
                             "%s)" % (width, self.widths))
        act = np.asarray(active, bool)
        pos = np.asarray(positions, "int64")
        tok = np.where(act[:, None], np.asarray(tokens, "int64").reshape(
            self.slots, width), 0)
        qpos = pos[:, None] + np.arange(width)[None, :]
        rows = [tables[s] if tables is not None else ()
                for s in range(self.slots)]
        feed = {
            "step_ids": tok.reshape(self.slots, width, 1),
            "step_pos": qpos.reshape(self.slots, width, 1),
            "tables": self._tables_feed(rows),
            # query i of slot s sees logical positions <= qpos[s, i]
            "step_bias": ((self._cols[None, None, :] > qpos[:, :, None])
                          | ~act[:, None, None]).astype("float32") * -1e4,
        }
        t0 = time.perf_counter()
        with _trace.span("decode_paged_step", cat="serving",
                         active=int(act.sum()), width=width):
            out = self._run_paged_step(width, feed).reshape(
                self.slots, width, -1)
        _profiler.bump_counter("decode_steps")
        self.steps += 1
        _profiler.bump_histogram("decode_step_ms",
                                 (time.perf_counter() - t0) * 1e3)
        return out

    def block_copy(self, src_blocks, dst_blocks):
        """``pool[dst[i]] = pool[src[i]]`` in every layer's K and V pool —
        the copy-on-write device op. The eager form moves all pairs in
        one copy per pool, so no dst may be a later pair's src."""
        if not self.paged:
            raise RuntimeError("block_copy on a non-paged session")
        with _trace.span("decode_block_copy", cat="serving",
                         pairs=len(src_blocks)), torch.inference_mode():
            src = self._to_device(np.asarray(src_blocks, "int64"))
            dst = self._to_device(np.asarray(dst_blocks, "int64"))
            for k, v in self.caches:
                _nn_ops.kv_cache_block_copy(k, src, dst)
                _nn_ops.kv_cache_block_copy(v, src, dst)

    # -- the eager device calls ---------------------------------------------
    def _run_prefill(self, T, feed):
        d = self._to_device
        with torch.inference_mode():
            return self.model.prefill(
                d(feed["ids"]), self._pos_cache[T], d(feed["input_mask"]),
                feed["slot_idx"], d(feed["last_onehot"]),
                self.caches).cpu().numpy()

    def _run_resume(self, T, feed):
        d = self._to_device
        offset = int(feed["slot_off"][0, 1])
        with torch.inference_mode():
            return self.model.resume_prefill(
                d(feed["ids"]), self._pos_cache[T] + offset,
                feed["slot_off"], d(feed["resume_bias"]),
                d(feed["last_onehot"]), self.caches).cpu().numpy()

    def _run_prefix_copy(self, dst_loc, src_loc, publish):
        with torch.inference_mode():
            self.model.prefix_copy(self.caches, self.stores, dst_loc,
                                   src_loc, publish=publish)

    def _run_decode(self, feed):
        d = self._to_device
        with torch.inference_mode():
            return self.model.decode_step(
                d(feed["step_ids"]), d(feed["step_pos"]),
                d(feed["key_bias"]), self.caches).cpu().numpy()

    def _run_paged_window(self, T, feed):
        d = self._to_device
        offset = int(feed["window_pos"][0, 0])
        with torch.inference_mode():
            return self.model.paged_window(
                d(feed["ids"]), self._pos_cache[T] + offset,
                d(feed["table"].astype(np.int32)), offset,
                d(feed["resume_bias"]), d(feed["last_onehot"]),
                self.caches).cpu().numpy()

    def _run_paged_step(self, width, feed):
        # the paged kernel takes int32 tables, built once per step
        d = self._to_device
        with torch.inference_mode():
            return self.model.paged_step(
                d(feed["step_ids"]), d(feed["step_pos"]),
                d(feed["tables"].astype(np.int32)), d(feed["step_bias"]),
                self.caches).cpu().numpy()


class ProgramDecodeSession(DecodeSession):
    """``DecodeSession(cfg, place=None, scope=None, ...)``: the
    reference's session (``decode.py:521``), which runs the serving
    programs through its own ``fluid.Executor(place)`` over ``scope``.

    It builds one ``build_gpt_prefill`` per bucket and
    ``build_gpt_decode_step`` (contiguous; ``build_gpt_resume_prefill``
    per bucket with ``build_resume`` or a prefix store, and both
    ``build_gpt_prefix_copy`` programs with the store), or one
    ``build_gpt_paged_window`` per bucket, ``build_gpt_paged_step`` per
    width and ``build_gpt_paged_block_copy`` (paged), each under a fresh
    ``unique_name.guard()`` so its parameters are the canonical
    ``<layer>.w_0``. Their cache, store and pool vars are zeroed tensors
    it puts in the scope under the reference's names; the programs write
    them in place. ``place`` None means the card, as the Executor's;
    ``scope`` None means ``global_scope()``, where the reference makes a
    fresh scope. The scope must hold the model's parameters (a startup
    run under ``unique_name.guard()``, or ``bind_params``). ``tp`` other
    than 1 raises (tensor parallelism is not ported). Every program's
    Executor plan is built at its first run: ``warmup()`` runs them all
    once."""

    def __init__(self, cfg, place=None, scope=None, slots=None,
                 max_len=None, prefill_buckets=None, prefix_blocks=0,
                 prefix_block=None, build_resume=False, block_size=None,
                 pool_blocks=0, spec_tokens=None, window_cap=0, tp=None):
        if tp is not None and int(tp) != 1:
            raise NotImplementedError(
                "tensor-parallel decode (tp=%r) is not ported yet: ROADMAP "
                "queue A, item A12" % (tp,))
        self.model = None
        self.place = place
        self.device = _core.resolve_device(place)
        self.scope = scope if scope is not None else _core.global_scope()
        self.exe = _executor.Executor(place)
        cfg = copy.copy(cfg)
        cfg.is_test = True
        self._setup(cfg, slots, max_len, prefill_buckets, block_size,
                    spec_tokens, pool_blocks, window_cap, prefix_blocks,
                    prefix_block, build_resume)
        caches, stores = self._alloc()
        for (k_name, v_name), (k, v) in zip(self._names + self._store_names,
                                            caches + stores):
            self.scope.set(k_name, k)
            self.scope.set(v_name, v)
        g = self.cfg
        self._prefill, self._resume, self._window, self._step = {}, {}, {}, {}
        self._decode = self._copy_in = self._publish = self._block_copy = None
        if self.paged:
            for T in self.buckets:
                self._window[T] = self._build(
                    _gpt.build_gpt_paged_window, g, self.pool_blocks,
                    self.block_size, self.max_blocks, T)
            for w in self.widths:
                self._step[w] = self._build(
                    _gpt.build_gpt_paged_step, g, self.slots,
                    self.pool_blocks, self.block_size, self.max_blocks,
                    step_w=w)
            self._block_copy = self._build(
                _gpt.build_gpt_paged_block_copy, g, self.pool_blocks,
                self.block_size, npairs=1)
        else:
            for T in self.buckets:
                self._prefill[T] = self._build(
                    _gpt.build_gpt_prefill, g, self.slots, T, self.max_len)
            self._decode = self._build(_gpt.build_gpt_decode_step, g,
                                       self.slots, self.max_len)
            if self.resumable:
                for T in self.buckets:
                    self._resume[T] = self._build(
                        _gpt.build_gpt_resume_prefill, g, self.slots, T,
                        self.max_len)
            if self._store_names:
                self._copy_in, self._publish = (
                    self._build(_gpt.build_gpt_prefix_copy, g, self.slots,
                                self.max_len, self.prefix_blocks,
                                self.prefix_block, publish=publish)
                    for publish in (False, True))

    @staticmethod
    def _build(builder, *args, **kwargs):
        """(main program, fetch name) of ``builder`` under a fresh
        ``unique_name.guard()``."""
        with _unique_name.guard():
            main, _startup, _feeds, fetch = builder(*args, **kwargs)
        return main, fetch.name

    @property
    def caches(self):
        """Per-layer (k, v) caches or pools: the scope's tensors."""
        return [(self.scope.get(k), self.scope.get(v))
                for k, v in self._names]

    @property
    def stores(self):
        return [(self.scope.get(k), self.scope.get(v))
                for k, v in self._store_names]

    def bind_params(self, program):
        """Alias ``program``'s parameters onto the canonical names the
        session's programs read: a program built outside a fresh
        ``unique_name.guard()`` says ``gpt_0_att_q.w_3`` where the
        session's say ``.w_0``. The scope entry becomes the same tensor
        (no copy); re-invoked per generate call, so retrained parameters
        stay current. ``program`` is THE model of this scope, as in the
        reference (``decode.py:768``)."""
        for v in program.list_vars():
            if not isinstance(v, _framework.Parameter):
                continue
            canon = re.sub(r"_(\d+)$", "_0", v.name)
            if canon == v.name:
                continue
            val = self.scope.get(v.name)
            if val is not None:
                self.scope.set(canon, val)

    def _fetch(self, entry, feed):
        main, fetch_name = entry
        (out,) = self.exe.run(main, feed=feed, fetch_list=[fetch_name],
                              scope=self.scope)
        return out

    def _run_prefill(self, T, feed):
        return self._fetch(self._prefill[T], feed)

    def _run_resume(self, T, feed):
        return self._fetch(self._resume[T], feed)

    def _run_prefix_copy(self, dst_loc, src_loc, publish):
        self._fetch(self._publish if publish else self._copy_in,
                    {"dst_loc": np.array([dst_loc], "int64"),
                     "src_loc": np.array([src_loc], "int64")})

    def _run_decode(self, feed):
        return self._fetch(self._decode, feed)

    def _run_paged_window(self, T, feed):
        return self._fetch(self._window[T], feed)

    def _run_paged_step(self, width, feed):
        return self._fetch(self._step[width], feed)

    def block_copy(self, src_blocks, dst_blocks):
        """``pool[dst[i]] = pool[src[i]]`` in every layer's K and V pool,
        pair by pair through the one-pair program, as the reference."""
        if not self.paged:
            raise RuntimeError("block_copy on a non-paged session")
        for src, dst in zip(src_blocks, dst_blocks):
            with _trace.span("decode_block_copy", cat="serving",
                             src=int(src), dst=int(dst)):
                self._fetch(self._block_copy,
                            {"src": np.array([[src]], "int64"),
                             "dst": np.array([[dst]], "int64")})


def session_for_generate(model, *args, **kwargs):
    """The 1-slot contiguous session ``greedy_generate`` drives.

    ``session_for_generate(model, max_len)``: the eager session, cached
    on the ``GPTLM`` per ``max_len``. ``session_for_generate(exe, cfg,
    scope, max_len, param_program)`` (the reference's form,
    ``decode.py:1100``): a program session on ``exe.place``, cached on the
    scope (``global_scope()`` for None) per model geometry, flash policy
    and place, its parameters bound from ``param_program``."""
    if isinstance(model, _gpt.GPTLM):
        return _eager_generate_session(model, *args, **kwargs)
    return _program_generate_session(model, *args, **kwargs)


def _eager_generate_session(model, max_len):
    cache = model.__dict__.setdefault("_generate_sessions", {})
    lock = model.__dict__.setdefault("_generate_lock", threading.Lock())
    with lock:
        sess = cache.get(int(max_len))
        if sess is None:
            # always the contiguous pool, whatever the paged flags say
            sess = cache[int(max_len)] = DecodeSession(
                model, slots=1, max_len=max_len, block_size=0,
                spec_tokens=0)
        return sess


_GEN_LOCK = threading.Lock()


def _program_generate_session(exe, cfg, scope, max_len, param_program):
    scope = scope if scope is not None else _core.global_scope()
    key = (cfg.vocab_size, cfg.hidden_size, cfg.num_layers, cfg.num_heads,
           cfg.intermediate_size, cfg.max_position_embeddings,
           repr(getattr(cfg, "use_flash_attention", False)), int(max_len),
           str(_core.resolve_device(exe.place)))
    # kept on the scope, as the reference's: a session holds its scope,
    # so a module-level map would keep every scope alive
    with _GEN_LOCK:
        cache = scope.__dict__.setdefault(
            "_decode_gen_sessions", {"lock": threading.Lock(),
                                     "sessions": {}})
    with cache["lock"]:
        sess = cache["sessions"].get(key)
        if sess is None:
            sess = cache["sessions"][key] = DecodeSession(
                cfg, place=exe.place, scope=scope, slots=1, max_len=max_len,
                block_size=0, spec_tokens=0, tp=1)
    sess.bind_params(param_program)
    return sess


# ---------------------------------------------------------------------------
# sampling — host-side, over the fetched logits
# ---------------------------------------------------------------------------


def sample_token(logits, temperature=0.0, top_k=0, top_p=0.0, rng=None):
    """Pick one token id from a ``[vocab]`` logits row.

    ``temperature <= 0`` is greedy (argmax), the default. Otherwise:
    temperature scale -> top-k cut -> softmax -> nucleus (top-p) cut ->
    renormalize, then ONE uniform draw from ``rng`` (a
    ``np.random.RandomState``) selects by inverse CDF. A sampled pick
    consumes exactly one draw and a greedy pick none, which is what
    ``fast_forward_rng`` relies on."""
    z = np.asarray(logits, np.float64).ravel()
    if temperature is None or temperature <= 0.0:
        return int(z.argmax())
    z = z / float(temperature)
    if top_k and 0 < int(top_k) < z.size:
        kth = np.partition(z, -int(top_k))[-int(top_k)]
        z = np.where(z < kth, -np.inf, z)
    z = z - z.max()
    probs = np.exp(z)
    probs /= probs.sum()
    if top_p and 0.0 < float(top_p) < 1.0:
        order = np.argsort(-probs)
        csum = np.cumsum(probs[order])
        drop = order[(csum - probs[order]) >= float(top_p)]
        probs[drop] = 0.0
        probs /= probs.sum()
    if not np.isfinite(probs).all():
        raise ValueError(
            "sampling produced non-finite probabilities "
            "(temperature %r too extreme for the logits)" % (temperature,))
    r = rng if rng is not None else np.random
    u = float(r.random_sample())
    cdf = np.cumsum(probs)
    # strictly below cdf[-1], so a rounding-up draw cannot land on the
    # zero-probability tail
    x = min(u * cdf[-1], np.nextafter(cdf[-1], 0.0))
    return int(min(np.searchsorted(cdf, x, side="right"), probs.size - 1))


def fast_forward_rng(rng, n):
    """Advance ``rng`` past ``n`` sampled-token draws (one uniform each,
    by ``sample_token``'s consumption contract)."""
    n = int(n)
    if n < 0:
        raise ValueError("cannot fast-forward a negative draw count")
    if n:
        rng.random_sample(n)
    return rng


# ---------------------------------------------------------------------------
# streaming handle
# ---------------------------------------------------------------------------

_SENTINEL = object()


class GenerationStream(object):
    """Per-request streaming handle. The engine pushes tokens as they are
    generated; the caller iterates (``for tok in stream``), or blocks on
    ``tokens()`` / ``result()``. Single consumer. ``finish_reason`` is
    ``"eos"`` / ``"length"`` / ``"cancelled"`` once done.

    ``priority`` ("batch", else interactive) and ``tenant`` are the
    scheduling identity; ``preemptions`` counts the times the engine
    evicted this stream for an interactive one and re-admitted it.
    ``resume_tokens`` is the suffix an interrupted run of the same
    request already emitted: the engine prefills prompt + suffix and the
    stream emits only the continuation, its RNG fast-forwarded past the
    replayed picks."""

    def __init__(self, prompt_ids, max_new_tokens=None, eos_id=None,
                 temperature=0.0, top_k=0, top_p=0.0, seed=None,
                 resume_tokens=None, priority=None, tenant=None):
        self.prompt_ids = [int(t) for t in prompt_ids]
        self.priority = "batch" if priority == "batch" else "interactive"
        self.tenant = str(tenant or "")
        self.preemptions = 0
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.temperature = float(temperature or 0.0)
        self.top_k = int(top_k or 0)
        self.top_p = float(top_p or 0.0)
        self.seed = seed
        self.resume_tokens = [int(t) for t in (resume_tokens or [])]
        self._rng = (np.random.RandomState(seed)
                     if self.temperature > 0.0 else None)
        if self._rng is not None and self.resume_tokens:
            fast_forward_rng(self._rng, len(self.resume_tokens))
        self.finish_reason = None
        # engine tick bookkeeping: the tick a slot was admitted on and the
        # last tick it decoded on
        self.first_tick = None
        self.last_tick = None
        # submit -> first generated token, engine-stamped
        self.ttft_ms = None
        # paged engine facts, engine-stamped: prompt tokens the prefix
        # index served, prefill windows the admission ran (1 = the whole
        # prompt at once), and the draft tokens the verify scored for
        # this stream and accepted
        self.cached_prefix_tokens = 0
        self.admit_windows = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        # distributed-trace hand-off: the stream is built on the
        # submitting thread (the gateway handler inside its trace_scope);
        # the engine's loop re-enters this context around the slot's
        # windows and copies and lists its trace id on every decode tick
        # the slot rides
        self.trace_ctx = _trace.current_context()
        self._t_submit = time.monotonic()
        self._t_last_emit = None
        self._q = queue.Queue()
        self._tokens = []
        self._done = threading.Event()
        self._error = None
        self._cancelled = False

    def full_prompt(self):
        """What the engine prefills: the prompt plus the resume suffix."""
        return self.prompt_ids + self.resume_tokens

    @property
    def emitted_count(self):
        """Tokens of the whole generation emitted so far: the resumed
        suffix plus what this stream pushed (what a transport needs to
        build the next resume form)."""
        return len(self.resume_tokens) + len(self._tokens)

    def cancel(self):
        """Abandon the request: the engine retires its slot at the next
        tick boundary (finish_reason ``"cancelled"``). Safe from any
        thread, idempotent."""
        self._cancelled = True

    # engine side
    def pick(self, logits):
        """Next token from a ``[vocab]`` logits row: greedy argmax unless
        the request armed temperature sampling."""
        if self._rng is None:
            return int(np.asarray(logits).ravel().argmax())
        return sample_token(logits, temperature=self.temperature,
                            top_k=self.top_k, top_p=self.top_p,
                            rng=self._rng)

    def _push(self, tok):
        self._tokens.append(int(tok))
        self._q.put(int(tok))

    def _finish(self, reason):
        self.finish_reason = reason
        self._done.set()
        self._q.put(_SENTINEL)

    def _fail(self, exc):
        self._error = exc
        self._done.set()
        self._q.put(_SENTINEL)

    # consumer side
    @property
    def done(self):
        return self._done.is_set()

    def __iter__(self):
        return self.stream_tokens(timeout=None)

    def stream_tokens(self, timeout=None):
        """Like iteration, but the whole stream must finish within
        ``timeout`` seconds (None = unbounded); raises ``TimeoutError``
        when the budget runs out."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            remaining = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError("generation still in flight")
            try:
                item = self._q.get(timeout=remaining)
            except queue.Empty:
                raise TimeoutError("generation still in flight")
            if item is _SENTINEL:
                if self._error is not None:
                    raise self._error
                return
            yield item

    def tokens(self, timeout=None):
        """Block until the request finishes; returns the generated tokens
        (prompt excluded)."""
        if not self._done.wait(timeout):
            raise TimeoutError("generation still in flight")
        if self._error is not None:
            raise self._error
        return list(self._tokens)

    def result(self, timeout=None):
        """prompt + generated tokens — ``greedy_generate``'s contract. A
        resumed stream includes its resume suffix: the same sequence the
        uninterrupted run returns."""
        return self.prompt_ids + self.resume_tokens + self.tokens(timeout)


def _stream_scope(stream):
    """The trace context of one request's stream, re-entered on the
    engine's loop thread so the slot's window, copy and publish spans
    join the request's tree. A no-op scope for untraced streams."""
    ctx = getattr(stream, "trace_ctx", None) or (None, None)
    return _trace.trace_scope(*ctx)


class _Slot(object):
    __slots__ = ("stream", "pending_token", "next_pos", "generated")

    def __init__(self, stream, pending_token, next_pos, generated=1):
        self.stream = stream
        self.pending_token = pending_token  # emitted, not yet cached
        self.next_pos = next_pos            # cache position it writes next
        # tokens of the whole generation so far: a resumed or re-admitted
        # stream starts past its replayed ones, so the max_new / max_len
        # budgets stay those of the original request
        self.generated = generated


class _PrefillJob(object):
    """A slot mid-prefill: its prompt's bucket-shaped windows (after the
    cached prefix) and the next one to run. Multi-window jobs (chunked
    prefill) advance one window per engine tick."""

    __slots__ = ("stream", "windows", "wi")

    def __init__(self, stream, windows):
        self.stream = stream
        self.windows = windows
        self.wi = 0


# ---------------------------------------------------------------------------
# speculative drafters — host side, correctness-neutral proposals
# ---------------------------------------------------------------------------


def _ngram_draft(history, k):
    """Self-draft from the stream's own history: find the most recent
    earlier occurrence of the trailing n-gram (n = 3 shrinking to 1) and
    propose the continuation that followed it, padded with its last
    token to exactly ``k`` tokens. A wrong draft costs only verify work:
    the accept loop keeps the emitted tokens those of sequential
    decoding."""
    hist = [int(t) for t in history]
    draft = []
    for n in (3, 2, 1):
        if len(hist) <= n:
            continue
        key = tuple(hist[-n:])
        for i in range(len(hist) - n - 1, -1, -1):
            if tuple(hist[i:i + n]) == key:
                draft = hist[i + n:i + n + k]
                break
        if draft:
            break
    if not draft:
        draft = [hist[-1]] if hist else [0]
    while len(draft) < k:
        draft.append(draft[-1])
    return draft[:k]


def _repeat_draft(history, k):
    """Propose the last token ``k`` times: right exactly on runs."""
    last = int(history[-1]) if history else 0
    return [last] * k


# ``decode_spec_draft`` names one of these; a model-based drafter plugs
# in as DecodeEngine(drafter=callable(history, k) -> k tokens)
_SPEC_DRAFTERS = {"ngram": _ngram_draft, "repeat": _repeat_draft}


# ---------------------------------------------------------------------------
# continuous-batching engine
# ---------------------------------------------------------------------------


def _engine_model(cfg, place, scope, param_program):
    """The engine's GPTLM: ``cfg`` itself when it is one, else a model of
    ``cfg`` over the scope's parameter tensors on ``place``."""
    if isinstance(cfg, _gpt.GPTLM):
        if place is not None or scope is not None or \
                param_program is not None:
            raise ValueError(
                "DecodeEngine(model, ...) serves the model as it is; place, "
                "scope and param_program go with DecodeEngine(cfg, ...)")
        return cfg
    dev = _core.resolve_device(place)
    scope = scope if scope is not None else _core.global_scope()
    names = {}
    if param_program is not None:
        for v in param_program.list_vars():
            if isinstance(v, _framework.Parameter):
                names[re.sub(r"_(\d+)$", "_0", v.name)] = v.name
    # built on the meta device: every parameter is then the scope's
    model = _gpt.share_fluid_scope(_gpt.GPTLM(cfg, device="meta"), scope,
                                   names)
    got = model.device
    if got.type != dev.type or (dev.index is not None
                                and got.index != dev.index):
        raise ValueError("the scope's parameters are on %s, the engine's "
                         "place is %s" % (got, dev))
    return model


class DecodeEngine(object):
    """Continuous batching over a ``DecodeSession``.

    One loop thread ticks: reap cancelled streams, admit queued requests
    into free slots (the scheduler's order: interactive before batch,
    weighted-fair across tenants within a class) — mid-flight, active
    streams keep decoding across admissions — then run ONE fused decode
    step for every active slot, stream each new token out, and retire
    slots on EOS / max-new-tokens / max-length. Greedy decoding is
    token-exact with ``gpt._reference_generate``.

    On the contiguous pool ``prefix_cache_mb`` > 0 arms the prefix store
    (``prefix_block`` tokens a block, default ``decode_prefix_block``):
    admission copies the longest cached prefix into the slot row and
    prefills the rest as resume windows, and a finished prefill publishes
    its blocks. ``prefill_chunk`` > 0 caps a window: a longer prompt
    admits one window a tick while live streams decode.

    ``block_size`` > 0 (default ``FLAGS_decode_block_size``) serves from
    the paged pool instead: admission takes ``ceil(len(prompt) / block)``
    pool blocks (a prefix-index hit supplies the leading ones without a
    copy, ``prefix_cache_mb`` > 0 arms the index), prefills them in
    bucket-shaped windows of at most ``prefill_chunk`` tokens (0 = one
    window), one window per tick for a multi-window prompt; tables grow
    a block at a time as streams decode, and a pool that cannot cover a
    request sheds it with ``ServerOverloadedError``. ``spec_tokens`` = k
    > 1 makes every tick a speculative verify of the pending token plus
    ``drafter(history, k - 1)`` (default ``decode_spec_draft``'s
    built-in), accepted up to the first mismatch; ``set_spec_width``
    switches between width 1 and k at run time. Tokens are the same
    either way.

    With ``sched_preempt`` (the default) an interactive request waiting
    for a slot evicts a batch stream; the victim re-queues at the front
    and re-prefills its prompt and emitted tokens when it is admitted
    again, so its tokens are those of an uninterrupted run.

    ``start()`` runs every prefill bucket (resume windows and the block
    copies too, where armed; paged: each window bucket) and step width
    once (building the kernels and warming the card), registers the
    engine's gauges, then starts the loop. ``stream_class`` is the
    handle type ``submit`` creates.

    Two forms build an engine. ``DecodeEngine(model, ...)`` serves a
    ``GPTLM`` as it is. ``DecodeEngine(cfg, place, scope, ...,
    param_program=...)`` is the reference's (``GPTConfig`` first, its
    keyword order): the model is built on ``resolve_device(place)`` over
    the parameters ``scope`` holds (default ``global_scope()``), shared
    and not copied (``gpt.share_fluid_scope``), so a predictor and the
    engine over one scope hold one copy of the weights;
    ``param_program`` names them, its ``_<n>`` suffixes read as ``_0``
    as in the reference."""

    stream_class = GenerationStream

    def __init__(self, cfg, place=None, scope=None, slots=None,
                 max_len=None, prefill_buckets=None, queue_depth=None,
                 param_program=None, prefix_block=None,
                 prefix_cache_mb=None, prefill_chunk=None, block_size=None,
                 spec_tokens=None, spec_draft=None, pool_blocks=0,
                 drafter=None, tp=None):
        if tp is not None and int(tp) != 1:
            raise NotImplementedError(
                "tensor-parallel decode (tp=%r) is not ported yet: ROADMAP "
                "queue A, item A12" % (tp,))
        self.model = _engine_model(cfg, place, scope, param_program)
        self._slots_arg = slots
        self._max_len_arg = max_len
        self._buckets_arg = prefill_buckets
        self.queue_depth = int(_flag("decode_queue_depth", queue_depth))
        self.prefix_block = int(_flag("decode_prefix_block", prefix_block))
        self.prefix_cache_mb = float(_flag("decode_prefix_cache_mb",
                                           prefix_cache_mb))
        self.prefill_chunk = int(_flag("decode_prefill_chunk",
                                       prefill_chunk))
        if self.prefill_chunk < 0 or self.prefix_cache_mb < 0:
            raise ValueError("prefill_chunk and prefix_cache_mb must be >= 0")
        self.block_size = int(_flag("decode_block_size", block_size))
        self.spec_tokens = int(_flag("decode_spec_tokens", spec_tokens))
        self._paged = self.block_size > 0
        if self.spec_tokens > 1 and not self._paged:
            raise ValueError(
                "speculative decoding rides the paged runtime: set "
                "decode_block_size > 0 alongside decode_spec_tokens")
        if self._paged:
            # the paged reuse granularity is the pool block
            self.prefix_block = self.block_size
        self._spec_width = self.spec_tokens if self.spec_tokens > 1 else 1
        self._pool_blocks_arg = int(pool_blocks or 0)
        if drafter is not None:
            self._drafter = drafter
        else:
            name = str(_flag("decode_spec_draft", spec_draft) or "ngram")
            if name not in _SPEC_DRAFTERS:
                raise ValueError(
                    "unknown decode_spec_draft %r (built-ins: %s; pass "
                    "drafter= for a model-based one)"
                    % (name, sorted(_SPEC_DRAFTERS)))
            self._drafter = _SPEC_DRAFTERS[name]
        self.prefix = None     # PrefixCache once started (contiguous)
        self.pindex = None     # PagedPrefixIndex once started, if armed
        self.allocator = None  # BlockAllocator once started (paged)
        self._slot_blocks = {}  # slot index -> [pool block ids] (paged)
        self.session = None
        self.started = False
        self.tick = 0
        self._pending = deque()
        self._active = {}
        self._prefilling = {}  # slot index -> _PrefillJob
        self._free = []
        self._cond = threading.Condition()
        self._stop = False
        self._thread = None
        # engine-local tallies (the profiler counters are process-global)
        self._counts = {"requests": 0, "admissions": 0, "retirements": 0,
                        "tokens": 0, "prompt_tokens": 0, "prefix_hits": 0,
                        "prefix_misses": 0, "prefix_cached_tokens": 0,
                        "resume_admissions": 0, "resume_tokens": 0,
                        "spec_drafted": 0, "spec_accepted": 0,
                        "oom_sheds": 0, "preemptions": 0,
                        "preempt_replayed_tokens": 0,
                        "kv_readmits": 0, "kv_readmit_tokens": 0}
        # weighted-fair scheduler (stride scheduling): per-tenant virtual
        # time and the virtual clock a newly seen tenant starts at
        self._sched_vtime = {}
        self._sched_vclock = 0.0
        self._sched_weights = {}
        self._sched_weights_ver = None
        self._gauges = {}  # registry name -> the callable registered
        self._armed = False  # this engine's count in the strict gate
        # fleet KV tier (kv_tier.py): the host-spill store behind the
        # paged prefix index. Evicted blocks spill D2H off the loop
        # thread; an admission whose chain outruns the device index
        # readmits the spilled rows H2D instead of prefilling them again
        self.kv_host_mb = float(_flags.get_flag("kv_tier_host_mb"))
        self.kv_advert_k = int(_flags.get_flag("kv_tier_advert_k"))
        self.host_store = None  # kv_tier.HostBlockStore once started
        self._spill_worker = None
        # worker -> loop thread: block ids whose D2H copy finished
        # (deque append/popleft are atomic)
        self._spill_done = deque()
        # gateway -> loop thread: chain exports (/v1/kv/prefill); the
        # pool is read on the loop thread, its only writer
        self._export_jobs = deque()

    # -- lifecycle -----------------------------------------------------------
    def start(self, loop=True):
        """Build the session, warm every shape, register the gauges, and
        (default) spawn the loop thread. ``loop=False`` skips the thread:
        the caller drives ``_tick()`` itself (deterministic tests)."""
        if self.started:
            raise RuntimeError("decode engine already started")
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError(
                "previous decode-engine loop thread has not exited yet")
        self.prefix = self.pindex = self.allocator = None
        self.host_store = None
        if self._paged:
            self.session = DecodeSession(
                self.model, slots=self._slots_arg, max_len=self._max_len_arg,
                prefill_buckets=self._buckets_arg, block_size=self.block_size,
                spec_tokens=self.spec_tokens,
                pool_blocks=self._pool_blocks_arg,
                window_cap=self.prefill_chunk)
            self.allocator = BlockAllocator(self.session.pool_blocks)
            if self.prefix_cache_mb > 0:
                # zero copy: the budget caps the pool blocks the index
                # may pin, it allocates nothing of its own
                cap = max(1, int(self.prefix_cache_mb * 2 ** 20 // (
                    _gpt.paged_block_bytes(self.model.cfg, self.block_size))))
                self.pindex = PagedPrefixIndex(self.block_size, cap,
                                               self.allocator)
                if self.kv_host_mb > 0:
                    # the host tier behind the index: an eviction spills
                    # instead of vanishing, and admission walks the
                    # store when the device chain runs out
                    self.host_store = _kv_tier.HostBlockStore(
                        int(self.kv_host_mb * 2 ** 20))
                    self.pindex.on_evict = self._on_index_evict
                    self._spill_done.clear()
                    self._spill_worker = _kv_tier.SpillWorker(
                        self._spill_batch)
        else:
            blocks = 0
            if self.prefix_cache_mb > 0:
                blocks = max(1, int(self.prefix_cache_mb * 2 ** 20 // (
                    _gpt.prefix_block_bytes(self.model.cfg,
                                            self.prefix_block))))
            self.session = DecodeSession(
                self.model, slots=self._slots_arg, max_len=self._max_len_arg,
                prefill_buckets=self._buckets_arg, block_size=0,
                spec_tokens=0, prefix_blocks=blocks,
                prefix_block=self.prefix_block,
                build_resume=bool(blocks or self.prefill_chunk))
            if blocks:
                self.prefix = PrefixCache(blocks, self.prefix_block)
        self._slot_blocks.clear()
        self.session.warmup()
        self._free = list(range(self.session.slots))
        self._stop = False
        try:
            # telemetry as InferenceServer: the exporter lights up from
            # the flags, and the strict gate arms counted, per engine
            _obs_exporter.maybe_start_from_flags()
            # occupancy counts the slots admission cannot use: decoding
            # and mid-chunked-prefill ones
            gauges = {
                "serving_slot_occupancy":
                    lambda e=self: len(e._active) + len(e._prefilling),
                "decode_queue_depth": lambda e=self: len(e._pending),
            }
            if self.allocator is not None:
                gauges["decode_blocks_free"] = lambda e=self: (
                    e.allocator.free_blocks if e.allocator else 0)
                gauges["decode_blocks_shared"] = lambda e=self: (
                    e.allocator.shared_blocks if e.allocator else 0)
            if self._spec_width > 1:
                gauges["decode_spec_acceptance"] = lambda e=self: (
                    e._counts["spec_accepted"]
                    / max(e._counts["spec_drafted"], 1))
            if self.host_store is not None:
                # host-tier pressure: resident spilled blocks and bytes
                gauges["kv_tier_host_blocks"] = lambda e=self: (
                    len(e.host_store) if e.host_store else 0)
                gauges["kv_tier_host_bytes"] = lambda e=self: (
                    e.host_store.bytes_used if e.host_store else 0)
            for name, fn in gauges.items():
                _registry.register_gauge(name, fn)
                self._gauges[name] = fn
            _compile_stats.arm_serving_steady()
            self._armed = True
            if loop:
                self._thread = threading.Thread(
                    target=self._loop, name="decode-engine", daemon=True)
                self._thread.start()
            # last: a half-started engine must never look started
            self.started = True
        except Exception:
            self._disarm()
            self._drop_gauges()
            raise
        return self

    def _disarm(self):
        if self._armed:
            _compile_stats.disarm_serving_steady()
            self._armed = False

    def _drop_gauges(self):
        """Unregister every gauge this engine published (a successor's
        re-registration of the same name stays)."""
        for name, fn in self._gauges.items():
            _registry.unregister_gauge(name, fn)
        self._gauges.clear()

    def stop(self):
        if not self.started:
            return
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
            if not self._thread.is_alive():
                self._thread = None
        if self._spill_worker is not None:
            # finishes the queued spill batches first (the loop thread is
            # gone, so their pool reads race nothing), then exits; the
            # pins die with the allocator the next start() builds
            self._spill_worker.stop()
            self._spill_worker = None
        self._disarm()
        self._drop_gauges()
        # drain under the lock submit() enqueues under, flipping started
        # inside it: a racing submit either lands before the drain (and is
        # failed here) or sees the engine stopped and raises
        with self._cond:
            failed = [s.stream for s in self._active.values()]
            failed += [j.stream for j in self._prefilling.values()]
            self._active.clear()
            self._prefilling.clear()
            pending = list(self._pending)
            self._pending.clear()
            # block ownership dies with the allocator the next start()
            # builds
            self._slot_blocks.clear()
            self.started = False
        err = ServingError("decode engine stopped")
        for stream in failed + pending:
            stream._fail(err)

    # -- request path --------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens=None, eos_id=None,
               temperature=0.0, top_k=0, top_p=0.0, seed=None,
               resume_tokens=None, priority=None, tenant=None):
        """Non-blocking admission; returns a ``GenerationStream``. Beyond
        ``queue_depth`` waiting requests it sheds with
        ``ServerOverloadedError``. Sampling knobs are per-request and
        host-side; greedy (``temperature=0``) is the default.
        ``priority`` ("interactive" default, or "batch") and ``tenant``
        are the scheduling identity.

        ``resume_tokens`` is the resume form: the suffix an interrupted
        run of this same request (prompt, knobs, seed) already emitted.
        The engine prefills prompt + suffix through the prefix and window
        path, fast-forwards the request's RNG past the replayed picks,
        and the stream emits exactly what the uninterrupted run would
        have emitted from there. A sampled request must carry its seed to
        be resumable. A resume that already reaches ``max_len`` is a
        finished generation: the stream comes back done, with no tokens
        and finish reason "length"."""
        prompt = [int(t) for t in prompt_ids]
        if not prompt:
            raise ValueError("empty prompt")
        resume = [int(t) for t in (resume_tokens or [])]
        if resume:
            if float(temperature or 0.0) > 0.0 and seed is None:
                raise ValueError(
                    "resume of a temperature-sampled generation requires "
                    "its seed (the replayed picks are otherwise "
                    "unreproducible)")
            if eos_id is not None and int(eos_id) in resume:
                raise ValueError(
                    "resume_tokens already contain eos_id %d: the "
                    "generation is finished, not resumable" % int(eos_id))
            if max_new_tokens is not None and max_new_tokens <= len(resume):
                raise ValueError(
                    "resume_tokens (%d) meet or exceed max_new_tokens (%d): "
                    "nothing left to generate"
                    % (len(resume), max_new_tokens))
        if not self.started or self.session is None:
            raise ServingError("decode engine not started")
        knobs = dict(max_new_tokens=max_new_tokens, eos_id=eos_id,
                     temperature=temperature, top_k=top_k, top_p=top_p,
                     seed=seed, resume_tokens=resume, priority=priority,
                     tenant=tenant)
        if len(prompt) + len(resume) >= self.session.max_len:
            if resume:
                # the resumed generation already met the max_len wall,
                # which the resuming caller cannot know: it is complete
                stream = self.stream_class(prompt, **knobs)
                stream._finish("length")
                return stream
            raise ValueError("prompt of %d tokens leaves no room to generate "
                             "(max_len %d)" % (len(prompt),
                                               self.session.max_len))
        if not self._paged:
            # paged windows tile any prompt length below max_len; the
            # contiguous ladder must hold the whole re-prefilled length
            self.session.bucket_for(len(prompt) + len(resume))
        if max_new_tokens is not None and max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        stream = self.stream_class(prompt, **knobs)
        with self._cond:
            if not self.started or self._stop:
                raise ServingError("decode engine stopped")
            if len(self._pending) >= self.queue_depth:
                raise ServerOverloadedError(
                    "decode admission queue full (%d pending)"
                    % len(self._pending), retry_after_ms=50)
            self._pending.append(stream)
            self._counts["requests"] += 1
            self._cond.notify_all()
        _profiler.bump_counter("decode_requests")
        return stream

    def generate(self, prompt_ids, max_new_tokens=None, eos_id=None,
                 temperature=0.0, top_k=0, top_p=0.0, seed=None,
                 resume_tokens=None, priority=None, tenant=None):
        """Submit and return the streaming handle."""
        return self.submit(prompt_ids, max_new_tokens=max_new_tokens,
                           eos_id=eos_id, temperature=temperature,
                           top_k=top_k, top_p=top_p, seed=seed,
                           resume_tokens=resume_tokens, priority=priority,
                           tenant=tenant)

    def set_spec_width(self, width):
        """Switch a paged engine's fused step between its two warmed
        widths at run time: 1 (plain decode, the drafter is never called)
        and ``spec_tokens`` (the verify). Tokens are the same either way;
        this is the lever for a workload whose acceptance makes drafting
        a loss."""
        w = int(width)
        if not self._paged:
            raise ValueError("spec width is a paged-engine knob")
        if w != 1 and w != max(self.spec_tokens, 1):
            raise ValueError(
                "width %d not warmed (this engine has 1%s)"
                % (w, " and %d" % self.spec_tokens
                   if self.spec_tokens > 1 else ""))
        self._spec_width = w

    def stats(self):
        """THIS engine's counters and live occupancy."""
        sess = self.session
        c = self._counts
        out = {
            "slots": sess.slots if sess else 0,
            "active": len(self._active),
            "prefilling": len(self._prefilling),
            "queued": len(self._pending),
            "ticks": self.tick,
            "requests": c["requests"],
            "prefills": sess.prefills if sess else 0,
            "steps": sess.steps if sess else 0,
        }
        for key in ("tokens", "admissions", "retirements", "prompt_tokens",
                    "prefix_hits", "prefix_misses", "prefix_cached_tokens",
                    "resume_admissions", "resume_tokens", "spec_drafted",
                    "spec_accepted", "oom_sheds", "preemptions",
                    "preempt_replayed_tokens"):
            out[key] = c[key]
        if c["spec_drafted"]:
            out["spec_acceptance"] = c["spec_accepted"] / c["spec_drafted"]
        if self.allocator is not None:
            out["paged"] = dict(self.allocator.stats(),
                                block_size=self.block_size)
        store = self.prefix if self.prefix is not None else self.pindex
        if store is not None:
            out["prefix_store"] = store.stats()
        if self.host_store is not None:
            out["kv_tier"] = dict(self.host_store.stats(),
                                  readmit_tokens=c["kv_readmit_tokens"])
        return out

    # -- engine loop ---------------------------------------------------------
    def _loop(self):
        while True:
            with self._cond:
                while not self._stop and not self._pending \
                        and not self._active and not self._prefilling \
                        and not self._export_jobs:
                    self._cond.wait()
                if self._stop:
                    return
            try:
                self._tick()
            except Exception as e:  # noqa: BLE001 - fail the live streams
                # a failed device step fails the requests it was serving;
                # the engine stays up for the next submission. Freed slots
                # count as retirements (admissions == retirements +
                # occupancy holds across recovered failures); prefilling
                # slots were never admitted and free without a tally
                for idx, slot in list(self._active.items()):
                    slot.stream._fail(e)
                    self._release_slot_blocks(idx)
                    self._count_retirement()
                for idx, job in list(self._prefilling.items()):
                    job.stream._fail(e)
                    self._release_slot_blocks(idx)
                self._free.extend(self._active.keys())
                self._free.extend(self._prefilling.keys())
                self._active.clear()
                self._prefilling.clear()

    def _tick(self):
        """One engine tick: reap cancellations, admit queued requests
        into free slots (prefix copies, then a prompt that fits one
        window prefills inline and emits its first token), advance ONE
        window of a multi-window prefill, then ONE fused decode step over
        every active slot. The window cap bounds what a live stream
        waits per token: one window plus one step. Finished spills and
        chain exports are served first."""
        self._drain_spill_done()
        self._serve_export_jobs()
        self._reap_cancelled()
        self._admit()
        self._advance_prefills()
        if self._active:
            self._step()

    def _count_retirement(self):
        _profiler.bump_counter("serving_slot_retirements")
        self._counts["retirements"] += 1

    def _reap_cancelled(self):
        """Retire slots whose consumer abandoned the stream, before any
        device work is spent on them, and drop cancelled requests from
        the pending queue so they release their admission entry."""
        for idx, slot in list(self._active.items()):
            if slot.stream._cancelled:
                self._active.pop(idx, None)
                self._free.append(idx)
                self._release_slot_blocks(idx)
                self._count_retirement()
                slot.stream._finish("cancelled")
        for idx, job in list(self._prefilling.items()):
            if job.stream._cancelled:
                # never admitted (no token emitted): no retirement tally
                self._prefilling.pop(idx, None)
                self._free.append(idx)
                self._release_slot_blocks(idx)
                job.stream._finish("cancelled")
        with self._cond:
            if any(s._cancelled for s in self._pending):
                live = deque()
                for s in self._pending:
                    if s._cancelled:
                        s._finish("cancelled")
                    else:
                        live.append(s)
                self._pending = live

    def _plan_windows(self, prompt_len, prefix_tokens):
        """Bucket-shaped windows covering [prefix, prompt_len): returns
        (usable prefix, [(start, end), ...]). Every window's bucket must
        end within max_len; when the suffix's cannot after the cached
        prefix, the prefix shrinks a block at a time (recompute beats
        corrupt). A ladder too sparse to tile the prompt degrades to one
        window from 0."""
        sess = self.session
        chunk = self.prefill_chunk
        prefix = prefix_tokens
        while prefix >= 0:
            s, wins, ok = prefix, [], True
            while s < prompt_len:
                cand = [b for b in sess.buckets if s + b <= sess.max_len]
                if not cand:
                    ok = False
                    break
                length = prompt_len - s
                if chunk:
                    length = min(length, chunk)
                length = min(length, max(cand))
                wins.append((s, s + length))
                s += length
            if ok:
                return prefix, wins
            prefix -= self.prefix_block
        return 0, [(0, prompt_len)]

    # -- scheduler: weighted-fair dequeue and preemption ---------------------
    def _tenant_weight(self, tenant):
        """Weight from ``sched_tenant_weights`` ("a:4,b:1"); unlisted
        tenants weigh 1. Parsed again only when the flags change."""
        ver = _flags.version()
        if ver != self._sched_weights_ver:
            self._sched_weights_ver = ver
            table = {}
            spec = str(_flags.get_flag("sched_tenant_weights", "") or "")
            for part in spec.split(","):
                name, sep, w = part.strip().rpartition(":")
                if not sep:
                    continue
                try:
                    table[name.strip()] = max(float(w), 1e-3)
                except ValueError:
                    continue
            self._sched_weights = table
        return self._sched_weights.get(tenant, 1.0)

    def _dequeue_locked(self):
        """The scheduler's pick from the pending queue (the caller holds
        ``_cond``): interactive strictly before batch; within a class,
        preempted re-admissions first (their share was charged at first
        admission), then weighted-fair across tenants by stride
        scheduling (each fresh dequeue advances its tenant's virtual time
        by 1 / weight; lowest virtual time next, FIFO within a tenant).
        One tenant alone is plain FIFO."""
        if not self._pending:
            return None
        best_i = best_key = None
        for i, s in enumerate(self._pending):
            cls = 1 if getattr(s, "priority", "interactive") == "batch" \
                else 0
            replay = 0 if getattr(s, "preemptions", 0) else 1
            if replay:
                t = getattr(s, "tenant", "") or ""
                v = max(self._sched_vtime.get(t, 0.0), self._sched_vclock)
            else:
                v = -1.0
            key = (cls, replay, v, i)
            if best_key is None or key < best_key:
                best_key, best_i = key, i
        stream = self._pending[best_i]
        del self._pending[best_i]
        if best_key[1]:  # a fresh admission: charge its tenant's stride
            t = getattr(stream, "tenant", "") or ""
            v = best_key[2]
            self._sched_vclock = v
            self._sched_vtime[t] = v + 1.0 / self._tenant_weight(t)
            if len(self._sched_vtime) > 4096:
                # tenant names are caller data: reset rather than grow
                # without bound (only relative history is lost)
                self._sched_vtime.clear()
        return stream

    def _preempt_for_pending(self):
        """At a tick boundary with no free slot: when ``sched_preempt``
        is on and an interactive request is pending, evict one batch
        stream — a still-prefilling one first (nothing emitted), else the
        active one with the least cached work. The victim goes to the
        front of the pending queue; its re-admission prefills prompt +
        emitted tokens, so its continuation is token-exact (the stream,
        its RNG state and its emitted tokens survive). Returns True when
        a slot was freed."""
        if not bool(_flags.get_flag("sched_preempt", True)):
            return False
        with self._cond:
            wanting = any(
                not s._cancelled
                and getattr(s, "priority", "interactive") != "batch"
                for s in self._pending)
        if not wanting:
            return False
        victim_idx = victim = None
        from_active = False
        for idx, job in self._prefilling.items():
            if getattr(job.stream, "priority", "interactive") == "batch":
                victim_idx, victim = idx, job.stream
                break
        if victim_idx is None:
            best = None
            for idx, slot in self._active.items():
                if getattr(slot.stream, "priority", "interactive") != "batch":
                    continue
                cost = len(slot.stream.full_prompt()) \
                    + len(slot.stream._tokens)
                if best is None or cost < best[0]:
                    best = (cost, idx, slot.stream)
            if best is not None:
                _cost, victim_idx, victim = best
                from_active = True
        if victim_idx is None:
            return False
        if from_active:
            # an evicted active stream was admitted, so its exit is a
            # retirement; its re-admission counts again
            self._active.pop(victim_idx, None)
            self._count_retirement()
        else:
            self._prefilling.pop(victim_idx, None)
        self._free.append(victim_idx)
        self._release_slot_blocks(victim_idx)
        victim.preemptions += 1
        replayed = len(victim._tokens)
        _profiler.bump_counter("decode_preemptions")
        _profiler.bump_counter("decode_preempt_replayed_tokens", replayed)
        self._counts["preemptions"] += 1
        self._counts["preempt_replayed_tokens"] += replayed
        with self._cond:
            # the front of the queue, past the depth bound: an internal
            # re-queue of an admitted request, not new load
            self._pending.appendleft(victim)
        return True

    def _admission_prompt(self, stream):
        """Every token whose K/V must be cached before the next pick: the
        prompt, the resume suffix, and whatever this stream already
        emitted here (non-empty only for a preempted stream coming back:
        re-prefilling its own tokens makes the eviction token-exact)."""
        return stream.full_prompt() + [
            int(t) for t in getattr(stream, "_tokens", ()) or ()]

    def _admit(self):
        """Admit queued requests, in the scheduler's order, into free
        slots — mid-flight, between decode steps, never evicting an
        active stream except through ``_preempt_for_pending``. On the
        contiguous pool each admission copies the longest cached prefix
        into the slot row, then prefills the rest: one window inline, a
        longer prompt as a ``_PrefillJob`` advanced one window a tick. On
        the paged pool see ``_admit_paged``."""
        if not self._free:
            self._preempt_for_pending()
        while self._free:
            with self._cond:
                stream = self._dequeue_locked()
            if stream is None:
                return
            if stream._cancelled:
                stream._finish("cancelled")
                continue
            slot_idx = self._free.pop()
            if self._paged:
                self._admit_paged(slot_idx, stream)
                continue
            prompt = self._admission_prompt(stream)
            entries, hit_tokens = [], 0
            if self.prefix is not None:
                entries, hit_tokens = self.prefix.lookup(prompt)
            prefix_tokens, wins = self._plan_windows(len(prompt), hit_tokens)
            if prefix_tokens < hit_tokens:
                # the planner gave blocks back: unpin what is not copied
                keep = prefix_tokens // self.prefix_block
                self.prefix.release(entries[keep:])
                entries = entries[:keep]
            try:
                if entries:
                    with _stream_scope(stream), \
                            _compile_stats.serving_request_window():
                        for j, e in enumerate(entries):
                            self.session.prefix_copy_in(
                                slot_idx, j * self.prefix_block,
                                e.block_idx)
            except Exception as exc:  # noqa: BLE001 - per-request failure
                self._free.append(slot_idx)
                stream._fail(exc)
                continue
            finally:
                # copied (or failed): the store may evict these again
                if entries:
                    self.prefix.release(entries)
            self._stamp_admission(stream, prompt, prefix_tokens, wins,
                                  self.prefix is not None)
            job = _PrefillJob(stream, wins)
            if len(wins) == 1:
                with _stream_scope(stream):
                    self._run_prefill_window(slot_idx, job)
                continue
            with self._cond:
                # stop() drains under this lock: parking the job after
                # its drain would strand the stream in a dead engine
                if self._stop or not self.started:
                    self._free.append(slot_idx)
                    stream._fail(ServingError("decode engine stopped"))
                    continue
                self._prefilling[slot_idx] = job

    def _stamp_admission(self, stream, prompt, prefix_tokens, wins, armed):
        """Stamp and count one admission: its prompt, its windows and its
        prefix hit or miss (``armed``: a prefix store or index exists)."""
        stream.cached_prefix_tokens = prefix_tokens
        stream.admit_windows = len(wins)
        _profiler.bump_counter("decode_prompt_tokens", len(prompt))
        self._counts["prompt_tokens"] += len(prompt)
        if armed:
            if prefix_tokens:
                _profiler.bump_counter("decode_prefix_hits")
                _profiler.bump_counter("decode_prefix_cached_tokens",
                                       prefix_tokens)
                self._counts["prefix_hits"] += 1
                self._counts["prefix_cached_tokens"] += prefix_tokens
            else:
                _profiler.bump_counter("decode_prefix_misses")
                self._counts["prefix_misses"] += 1

    # -- paged admission -----------------------------------------------------
    def _admit_paged(self, slot_idx, stream):
        """Paged admission: a prefix hit puts the matched index blocks
        into the slot's table (increfed, no copy), fresh blocks cover the
        rest of ``ceil(len(prompt) / block)``, and the prompt prefills
        through bucket-shaped windows fed the table — inline when it is
        one window, else as a ``_PrefillJob`` advanced one window per
        tick. A pool that cannot cover the prompt (after evicting
        index-only blocks) sheds the request with the overload error."""
        prompt = self._admission_prompt(stream)
        entries, hit_tokens = [], 0
        if self.pindex is not None:
            entries, hit_tokens = self.pindex.lookup(prompt)
            if self.host_store is not None:
                # the chain ran past the device index: spilled (or
                # pulled) blocks readmit H2D, each joining ``entries``
                # with the same slot reference lookup hands out
                entries = self._readmit_from_host(prompt, entries)
                hit_tokens = len(entries) * self.block_size
        prefix_tokens, wins = self._plan_windows(len(prompt), hit_tokens)
        bs = self.block_size
        if prefix_tokens < hit_tokens:
            keep = prefix_tokens // bs
            self.allocator.decref([e.block_idx for e in entries[keep:]])
            entries = entries[:keep]
        blocks = [e.block_idx for e in entries]
        need = -(-len(prompt) // bs) - len(blocks)
        owned = self._alloc_blocks(need)
        if owned is None:
            if blocks:
                self.allocator.decref(blocks)
            self._free.append(slot_idx)
            _profiler.bump_counter("decode_paged_oom_sheds")
            self._counts["oom_sheds"] += 1
            stream._fail(ServerOverloadedError(
                "paged KV pool exhausted (%d blocks short after eviction)"
                % need, retry_after_ms=50))
            return
        self._slot_blocks[slot_idx] = blocks + owned
        self._stamp_admission(stream, prompt, prefix_tokens, wins,
                              self.pindex is not None)
        job = _PrefillJob(stream, wins)
        if len(wins) == 1:
            with _stream_scope(stream):
                self._run_prefill_window(slot_idx, job)
            return
        with self._cond:
            if self._stop or not self.started:
                self._free.append(slot_idx)
                self._release_slot_blocks(slot_idx)
                stream._fail(ServingError("decode engine stopped"))
                return
            self._prefilling[slot_idx] = job

    def _advance_prefills(self):
        """Run ONE window of ONE multi-window prefill, oldest first: live
        streams pay at most one window plus one fused step per token."""
        if self._prefilling:
            slot_idx = next(iter(self._prefilling))
            job = self._prefilling[slot_idx]
            with _stream_scope(job.stream):
                self._run_prefill_window(slot_idx, job)

    def _run_prefill_window(self, slot_idx, job):
        """Advance ``job`` by one window; after the prompt's last window,
        publish its full blocks to the prefix store or index, emit the
        first token, and join the decode batch. On the contiguous pool a
        window that is the whole prompt from position 0 runs the prefill
        (the flash kernel on the card), any other the resume window."""
        stream = job.stream
        prompt = self._admission_prompt(stream)
        s, e = job.windows[job.wi]
        try:
            with _compile_stats.serving_request_window():
                if self._paged:
                    logits = self.session.paged_window(
                        self._slot_blocks[slot_idx], prompt[s:e], s)
                elif s == 0 and e == len(prompt):
                    logits = self.session.prefill(slot_idx, prompt)
                else:
                    logits = self.session.resume_prefill(
                        slot_idx, prompt[s:e], s)
            job.wi += 1
            if job.wi < len(job.windows):
                # re-park under the drain lock, as _active insertion
                with self._cond:
                    if self._stop or not self.started:
                        self._prefilling.pop(slot_idx, None)
                        self._free.append(slot_idx)
                        self._release_slot_blocks(slot_idx)
                        stream._fail(ServingError("decode engine stopped"))
                        return
                    self._prefilling[slot_idx] = job
                return
            # pick() inside the per-request guard: a poisoned sampling
            # request fails alone, not every co-batched stream
            tok = stream.pick(logits)
        except Exception as exc:  # noqa: BLE001 - per-request failure
            self._prefilling.pop(slot_idx, None)
            self._free.append(slot_idx)
            self._release_slot_blocks(slot_idx)
            stream._fail(exc)
            return
        self._prefilling.pop(slot_idx, None)
        if self.pindex is not None:
            self.pindex.publish(prompt, self._slot_blocks[slot_idx])
        elif self.prefix is not None:
            self._publish_blocks(slot_idx, prompt)
        # a resumed or re-admitted stream continues the original
        # request's budgets: every replayed token counts as generated
        slot = _Slot(stream, tok, next_pos=len(prompt),
                     generated=1 + len(prompt) - len(stream.prompt_ids))
        with self._cond:
            if self._stop or not self.started:
                self._free.append(slot_idx)
                self._release_slot_blocks(slot_idx)
                stream._fail(ServingError("decode engine stopped"))
                return
            self._active[slot_idx] = slot
        _profiler.bump_counter("serving_slot_admissions")
        self._counts["admissions"] += 1
        if stream.resume_tokens:
            _profiler.bump_counter("decode_resume_admissions")
            _profiler.bump_counter("decode_resume_tokens",
                                   len(stream.resume_tokens))
            self._counts["resume_admissions"] += 1
            self._counts["resume_tokens"] += len(stream.resume_tokens)
        if stream.ttft_ms is None:
            # a preempted stream's first token was stamped already
            stream.first_tick = self.tick
            stream.ttft_ms = (time.monotonic() - stream._t_submit) * 1e3
            _profiler.bump_histogram("decode_ttft_ms", stream.ttft_ms)
        self._emit(slot_idx, slot, tok)

    def _publish_blocks(self, slot_idx, prompt):
        """Publish a finished prefill's full blocks to the contiguous
        prefix store. Best effort: a failed copy unregisters the new
        entries (a key never points at bytes that were not written) and
        the request streams on."""
        new = self.prefix.publish(prompt)
        try:
            with _compile_stats.serving_request_window():
                for entry, b in new:
                    self.session.prefix_publish(
                        slot_idx, b * self.prefix_block, entry.block_idx)
        except Exception:  # noqa: BLE001 - publishing is an optimisation
            for entry, _b in new:
                self.prefix.forget(entry)

    # -- paged block bookkeeping ---------------------------------------------
    def _alloc_blocks(self, n):
        """Allocator take with prefix-index relief: while the free list
        is short, evict index entries whose block the index alone holds
        (each decref frees one) and retry. With the host tier an eviction
        frees nothing at once (the spill pin holds the block until its
        D2H copy completes), so the loop also reaps finished spills and,
        still short with spills in flight, waits (bounded) for the
        worker's batch. None = out of memory; the caller sheds."""
        got = self.allocator.alloc(n)
        while got is None:
            progressed = self._drain_spill_done()
            if self.pindex is not None \
                    and self.pindex.evict_one(need_free=True):
                progressed = True
            if not progressed and self._spill_worker is not None \
                    and self._spill_worker.pending:
                self._spill_worker.drain(timeout=0.2)
                progressed = self._drain_spill_done()
            if not progressed:
                return None
            got = self.allocator.alloc(n)
        return got

    # -- fleet KV tier (kv_tier.py) ------------------------------------------
    def _read_rows(self, blocks):
        """Host copies of pool ``blocks``' rows: numpy [layers, 2, n,
        heads, block, d_head] in the pool's dtype (axis 1 is K, V). One
        gather per pool on the pool's device and one D2H copy of only
        these rows, never the whole pool. Any thread may call it for
        blocks no step writes (a pinned spill victim, an indexed block):
        every thread enqueues on the device's default stream, so the
        gather runs after the step that last wrote them."""
        sess = self.session
        idx = torch.as_tensor(np.asarray(blocks, np.int64)).to(sess.device)
        with torch.inference_mode():
            rows = torch.stack([torch.stack((k.index_select(0, idx),
                                             v.index_select(0, idx)))
                                for k, v in sess.caches])
            return rows.cpu().numpy()

    def _write_rows(self, blocks, rows):
        """Write ``rows`` (numpy [layers, 2, n, heads, block, d_head], as
        ``_read_rows`` gives them) into pool ``blocks``: one H2D copy of
        the rows and one ``index_copy_`` per pool, on the calling
        thread's stream (the loop thread's, ahead of the step that reads
        them)."""
        sess = self.session
        with torch.inference_mode():
            idx = torch.as_tensor(np.asarray(blocks, np.int64)).to(
                sess.device)
            dev_rows = torch.from_numpy(rows).to(
                sess.device, dtype=sess.caches[0][0].dtype)
            for li, (k, v) in enumerate(sess.caches):
                k.index_copy_(0, idx, dev_rows[li, 0])
                v.index_copy_(0, idx, dev_rows[li, 1])

    @staticmethod
    def _payload(rows, j):
        """Block ``j``'s payload out of ``_read_rows``: per layer a
        (k_rows, v_rows) pair [heads, block, d_head], owning its bytes."""
        return [(rows[li, 0, j].copy(), rows[li, 1, j].copy())
                for li in range(rows.shape[0])]

    def _on_index_evict(self, victim):
        """Index eviction hook (loop thread, before the index decrefs):
        pin the victim's block with one more reference and hand it to the
        spill worker. The pin keeps the allocator from issuing the block
        again, and no step writes a block it did not allocate
        (copy-on-write covers shared writes), so its rows stay as they
        are until the worker has copied them."""
        if self._spill_worker is None:
            return
        self.allocator.incref([victim.block_idx])
        self._spill_worker.submit(
            (victim.key, victim.prev, victim.tokens, victim.block_idx))

    def _spill_batch(self, jobs):
        """Spill worker body: one gather and one D2H copy cover every
        queued eviction, then each victim's rows go into the host store.
        Every block id returns through ``_spill_done``, also on failure,
        so a lost spill never leaks a pin."""
        try:
            rows = self._read_rows([job[3] for job in jobs])
            for j, (key, prev, tokens, _blk) in enumerate(jobs):
                self.host_store.put(key, prev, tokens,
                                    self._payload(rows, j))
        finally:
            for job in jobs:
                self._spill_done.append(job[3])

    def _drain_spill_done(self):
        """Reap finished spills (loop thread): drop each pin the evict
        hook took; for a block only the pin still held this is the decref
        that frees it. Returns True when any block was released."""
        freed = False
        while True:
            try:
                blk = self._spill_done.popleft()
            except IndexError:
                return freed
            self.allocator.decref([blk])
            freed = True

    def _readmit_from_host(self, prompt, entries):
        """Extend a device-index hit from the host tier: walk the
        prompt's chain past the device entries and, for every spilled
        block found, take a fresh pool block, write the payload H2D and
        index it again. Returns the extended entries (each new one
        carries the caller's slot reference, as ``lookup``'s do). All
        hits go up in one H2D copy and one ``index_copy_`` per pool, on
        the loop thread ahead of the window that reads them: the cost
        scales with the readmitted rows, not the pool."""
        bs = self.block_size
        usable = (len(prompt) - 1) // bs
        hits = []  # (host entry, fresh pool block)
        prev = entries[-1].key if entries else 0
        for b in range(len(entries), usable):
            toks = tuple(prompt[b * bs:(b + 1) * bs])
            key = _block_hash(prev, toks)
            if self.pindex._entries.get(key) is not None:
                break  # raced back into the device index; stop
            he = self.host_store.get(key, prev, toks)
            if he is None:
                break
            got = self._alloc_blocks(1)
            if got is None:
                break  # pool pressure: keep what we have, prefill the rest
            hits.append((he, got[0]))
            prev = key
        if not hits:
            return entries
        self._write_rows([blk for _he, blk in hits], np.stack([
            np.stack((np.stack([he.payload[li][0] for he, _b in hits]),
                      np.stack([he.payload[li][1] for he, _b in hits])))
            for li in range(len(self.session.caches))]))
        out = list(entries)
        for he, blk in hits:
            e = self.pindex.admit(he.key, he.prev, he.tokens, blk)
            if e is None:
                # the index refused (full of slot-shared blocks): the
                # block still serves this admission under a detached
                # entry, and the slot's decref at retirement frees it
                e = _PrefixEntry(he.key, he.prev, he.tokens, blk)
            else:
                # the index took the allocated reference; the slot needs
                # its own
                self.allocator.incref([blk])
            self.host_store.note_readmit(he)
            _profiler.bump_counter("kv_tier_readmit_tokens", bs)
            self._counts["kv_readmits"] += 1
            self._counts["kv_readmit_tokens"] += bs
            out.append(e)
        return out

    def prefix_heads(self, k=None):
        """The cache affinity advertisement: up to ``k`` hot chain keys,
        the device index's first (newest first), then the host tier's.
        Safe off the gateway thread: both reads copy without the loop's
        lock, and a stale head only costs the router a mis-score within
        its staleness bound."""
        if k is None:
            k = self.kv_advert_k
        k = int(k)
        if k <= 0 or self.pindex is None:
            return []
        heads = self.pindex.head_keys(k)
        if self.host_store is not None and len(heads) < k:
            seen = set(heads)
            try:
                host_keys = list(self.host_store._entries.keys())
            except RuntimeError:
                host_keys = []
            for key in reversed(host_keys):
                if key not in seen:
                    heads.append(key)
                    seen.add(key)
                if len(heads) >= k:
                    break
        return heads

    def estimate_cached_tokens(self, prompt_ids):
        """About how many of ``prompt_ids``' tokens the device index and
        the host tier hold: the gateway's pull-or-not signal. Read without
        the loop's lock off the gateway thread; a racing eviction at worst
        skews the estimate, and admission verifies every link again."""
        if self.pindex is None:
            return 0
        bs = self.block_size
        prompt = list(prompt_ids)
        cached = 0
        prev = 0
        for b in range((len(prompt) - 1) // bs):
            toks = tuple(prompt[b * bs:(b + 1) * bs])
            key = _block_hash(prev, toks)
            try:
                e = self.pindex._entries.get(key)
            except RuntimeError:
                break
            if e is None and self.host_store is not None:
                e = self.host_store.get(key, prev, toks)
            if e is None:
                break
            cached += bs
            prev = key
        return cached

    def offer_blocks(self, entries):
        """Take chain blocks pulled from a prefill-role peer (gateway
        thread) into the thread-safe host store: the next admission whose
        chain reaches them readmits them H2D through the spilled-block
        path, with the same verification. Returns the blocks accepted."""
        if self.host_store is None:
            return 0
        n = 0
        for key, prev, tokens, payload in entries:
            if self.host_store.put(key, prev, tokens, payload, tally=False):
                n += 1
        return n

    def request_export(self, prompt_ids, timeout=5.0):
        """The prompt's published chain blocks (a prefill-role replica's
        ``/v1/kv/prefill``, gateway thread). The pool is read on the loop
        thread, its only writer, so this parks a job the next tick serves
        and waits (bounded). Returns [(key, prev, tokens, payload)] in
        chain order, or None on timeout or a stopped engine."""
        if not self.started or self.pindex is None:
            return None
        ev = threading.Event()
        box = {}
        with self._cond:
            if self._stop or not self.started:
                return None
            self._export_jobs.append((list(prompt_ids), ev, box))
            self._cond.notify_all()
        if not ev.wait(timeout):
            return None
        return box.get("entries")

    def _serve_export_jobs(self):
        """Loop-thread half of ``request_export``: walk each job's chain,
        read the indexed blocks' rows out of the pool in one gather, and
        take spilled blocks straight from the host tier."""
        while True:
            try:
                prompt, ev, box = self._export_jobs.popleft()
            except IndexError:
                return
            try:
                bs = self.block_size
                chain = []  # [key, prev, tokens, pool block, payload]
                prev = 0
                for b in range(len(prompt) // bs):
                    toks = tuple(prompt[b * bs:(b + 1) * bs])
                    key = _block_hash(prev, toks)
                    e = self.pindex._entries.get(key)
                    if e is not None and (e.tokens != toks
                                          or e.prev != prev):
                        break  # collision squatting on the key
                    if e is not None:
                        chain.append([key, prev, toks, e.block_idx, None])
                    elif self.host_store is not None:
                        # already spilled: the payload is on the host
                        he = self.host_store.get(key, prev, toks)
                        if he is None:
                            break
                        chain.append([key, prev, toks, None, he.payload])
                    else:
                        break
                    prev = key
                on_card = [c for c in chain if c[3] is not None]
                if on_card:
                    rows = self._read_rows([c[3] for c in on_card])
                    for j, c in enumerate(on_card):
                        c[4] = self._payload(rows, j)
                box["entries"] = [(c[0], c[1], c[2], c[4]) for c in chain]
            except Exception:  # noqa: BLE001 - export is best effort
                box["entries"] = None
            finally:
                ev.set()

    def _release_slot_blocks(self, slot_idx):
        """Drop the slot's reference on every block of its table: owned
        blocks free, blocks the index or another slot shares survive."""
        blocks = self._slot_blocks.pop(slot_idx, None)
        if blocks and self.allocator is not None:
            self.allocator.decref(blocks)

    def _ensure_writable(self, slot_idx, block_i):
        """Copy-on-write: if logical block ``block_i`` of the slot's table
        is shared, copy it into a fresh block and swap the table entry
        before this tick writes it. Block-aligned admission never shares
        a block a writer touches, so this guards an invariant."""
        blocks = self._slot_blocks[slot_idx]
        blk = blocks[block_i]
        if self.allocator.refs(blk) <= 1:
            return
        got = self._alloc_blocks(1)
        if got is None:
            raise ServerOverloadedError(
                "paged KV pool exhausted during copy-on-write",
                retry_after_ms=50)
        with _compile_stats.serving_request_window():
            self.session.block_copy([blk], got)
        blocks[block_i] = got[0]
        self.allocator.decref([blk])

    def _trim_blocks(self, slot_idx, next_pos):
        """Speculative rollback by table edit: free the slot's blocks past
        the one its next write lands in; the rejected tail's K/V becomes
        unreferenced garbage no bias ever exposed."""
        blocks = self._slot_blocks.get(slot_idx)
        keep = next_pos // self.block_size + 1
        if blocks and len(blocks) > keep:
            tail = blocks[keep:]
            del blocks[keep:]
            self.allocator.decref(tail)

    # -- decode --------------------------------------------------------------
    def _emit(self, slot_idx, slot, tok):
        """Stream one generated token and retire the slot if finished."""
        stream = slot.stream
        stream._push(tok)
        stream.last_tick = self.tick
        now = time.monotonic()
        if stream._t_last_emit is not None:
            # what a live stream feels per token: what the window cap
            # bounds while long prompts admit
            _profiler.bump_histogram("decode_intertoken_ms",
                                     (now - stream._t_last_emit) * 1e3)
        stream._t_last_emit = now
        _profiler.bump_counter("decode_tokens")
        self._counts["tokens"] += 1
        reason = None
        if stream.eos_id is not None and tok == stream.eos_id:
            reason = "eos"
        elif (stream.max_new_tokens is not None
              and slot.generated >= stream.max_new_tokens):
            reason = "length"
        elif len(stream.prompt_ids) + slot.generated >= self.session.max_len:
            reason = "length"
        if reason is not None:
            # pop, not del: a stop() whose join timed out may have drained
            # _active concurrently
            self._active.pop(slot_idx, None)
            self._free.append(slot_idx)
            self._release_slot_blocks(slot_idx)
            self._count_retirement()
            stream._finish(reason)

    def _tick_span(self):
        """A fused tick decodes every traced stream at once: a
        ``decode_tick`` span lists their trace ids (as the batcher's
        dispatch span does), opened only when some stream is traced and
        tracing is on (an untraced tick pays nothing)."""
        tids = sorted({s.stream.trace_ctx[0] for s in self._active.values()
                       if s.stream.trace_ctx}) if _trace.enabled() else None
        if not tids:
            return contextlib.nullcontext()
        return _trace.span("decode_tick", cat="serving", tick=self.tick,
                           trace_ids=tids)

    def _step(self):
        """One fused decode step over every active slot."""
        if self._paged:
            self._step_paged()
            return
        sess = self.session
        tokens = [0] * sess.slots
        positions = [0] * sess.slots
        active = [False] * sess.slots
        for idx, slot in self._active.items():
            tokens[idx] = slot.pending_token
            positions[idx] = slot.next_pos
            active[idx] = True
        for idx, job in self._prefilling.items():
            # the step writes every slot: a row mid-chunked-prefill is
            # live (copied prefix, finished windows), so its masked write
            # lands on the next window's start, which that window
            # overwrites before any query reads it. A free slot's position
            # 0 would corrupt the row head and the blocks it publishes
            positions[idx] = job.windows[job.wi][0]
        with self._tick_span(), _compile_stats.serving_request_window():
            logits = sess.decode_step(tokens, positions, active)
        self.tick += 1
        for idx in list(self._active.keys()):
            slot = self._active[idx]
            try:
                tok = slot.stream.pick(logits[idx])
            except Exception as e:  # noqa: BLE001 - fail THIS stream only
                self._shed_active(idx, e)
                continue
            slot.next_pos += 1
            slot.generated += 1
            slot.pending_token = tok
            self._emit(idx, slot, tok)

    def _shed_active(self, idx, exc):
        """Retire active slot ``idx``, failing its stream with ``exc``."""
        slot = self._active.pop(idx)
        self._free.append(idx)
        self._release_slot_blocks(idx)
        self._count_retirement()
        slot.stream._fail(exc)

    def _step_paged(self):
        """One fused paged tick over every active slot: the plain decode
        step at width 1, or the batched verify at width k — each slot's
        window is its pending token plus a k-1-token draft, one call
        scores all k positions, and the host emits up to the first
        position where the draft differs from what was picked.

        Token exactness: query j's logits see positions <= next_pos + j
        holding exactly the window's tokens, and the accept loop uses
        logits[j + 1] only after confirming that draft token j + 1 is the
        token it just emitted — so every consumed row is the one
        sequential decoding would have produced. Each emitted token costs
        one ``pick`` (one uniform draw when sampling), so seeded sampling
        replays unchanged. ``_trim_blocks`` rolls whole rejected blocks
        back by table edit."""
        sess = self.session
        width = self._spec_width
        bs = self.block_size
        # grow each table through this window's last write; a slot the
        # pool cannot cover (even after index eviction) sheds
        for idx, slot in list(self._active.items()):
            need = (slot.next_pos + width - 1) // bs + 1
            blocks = self._slot_blocks[idx]
            try:
                if need > len(blocks):
                    got = self._alloc_blocks(need - len(blocks))
                    if got is None:
                        raise ServerOverloadedError(
                            "paged KV pool exhausted mid-generation",
                            retry_after_ms=50)
                    blocks.extend(got)
                for bi in range(slot.next_pos // bs, need):
                    self._ensure_writable(idx, bi)
            except Exception as exc:  # noqa: BLE001 - shed this slot
                _profiler.bump_counter("decode_paged_oom_sheds")
                self._counts["oom_sheds"] += 1
                self._shed_active(idx, exc)
        if not self._active:
            return
        tokens = np.zeros((sess.slots, width), "int64")
        positions = [0] * sess.slots
        active = [False] * sess.slots
        tables = [()] * sess.slots
        windows = {}
        for idx, slot in self._active.items():
            win = [slot.pending_token]
            if width > 1:
                hist = slot.stream.full_prompt() + slot.stream._tokens
                win += [int(t) for t in self._drafter(hist, width - 1)]
            windows[idx] = win
            tokens[idx, :] = win
            positions[idx] = slot.next_pos
            active[idx] = True
            tables[idx] = self._slot_blocks[idx]
        # idle and mid-prefill slots keep the all-sink table: their
        # writes land in block 0
        with self._tick_span(), _compile_stats.serving_request_window():
            logits = sess.paged_step(tokens, positions, tables, active,
                                     width=width)
        self.tick += 1
        for idx in list(self._active.keys()):
            slot = self._active[idx]
            win = windows[idx]
            emitted = 0
            failed = False
            for j in range(width):
                try:
                    tok = slot.stream.pick(logits[idx, j])
                except Exception as e:  # noqa: BLE001 - this stream only
                    self._shed_active(idx, e)
                    failed = True
                    break
                emitted += 1
                slot.next_pos += 1
                slot.generated += 1
                slot.pending_token = tok
                self._emit(idx, slot, tok)
                if idx not in self._active:
                    break  # retired: eos or length mid-window
                if j < width - 1 and tok != win[j + 1]:
                    break  # the draft diverged: the tail is dead weight
            if width > 1 and not failed:
                drafted, accepted = width - 1, emitted - 1
                _profiler.bump_counter("decode_spec_drafted", drafted)
                _profiler.bump_counter("decode_spec_accepted", accepted)
                self._counts["spec_drafted"] += drafted
                self._counts["spec_accepted"] += accepted
                slot.stream.spec_drafted += drafted
                slot.stream.spec_accepted += accepted
            if idx in self._active:
                self._trim_blocks(idx, slot.next_pos)
