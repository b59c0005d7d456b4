"""Fleet KV tier (port of ``paddle_tpu/serving/kv_tier.py``, numpy
only): content-addressed prefix blocks across device, host, and
replicas.

In the port the paged engine spills to the host store through the spill
worker and exports chains; the gateway uses the chain digest, the wire
codec and the peers file; the router scores affinity with
``chain_keys``.

The paged engine makes prefix K/V reuse cheap *inside* one replica:
the paged pool plus ``PagedPrefixIndex`` turn a shared system prompt
into zero-copy block references. But the index is per-replica and bounded by
device memory: at fleet scale the same prefix re-prefills once per
replica, and an LRU-evicted block is recomputed from scratch. This
module is the tier that fixes both, built on one observation: a paged
KV block is now a plain refcounted array addressed by a content hash
(the chain digest), so it can move across the device/host boundary and
between replicas without any replica-local naming — bytes-moved vs
tokens-recomputed becomes a measurable crossover instead of a guess
(PAPERS: portable array redistribution).

Three pieces, smallest first:

``block_hash`` / ``chain_keys``
    THE canonical chain digest — ``decode.py`` aliases it (so a test
    that monkeypatches ``decode._block_hash`` still works) and the
    router computes the same keys for affinity scoring. One definition
    means a replica's advertisement and the router's expectation can
    never drift.

``HostBlockStore``
    The host-spill tier behind ``PagedPrefixIndex``: when the device
    index LRU-evicts an entry, the engine spills the block's K/V rows
    D2H into this store (async, off the tick thread — see
    ``SpillWorker``) instead of letting the bytes vanish. A later
    admission whose chain walks past the device index re-admits the
    spilled payload H2D into freshly allocated blocks — O(bytes copied)
    against O(tokens^2) re-prefill, which wins past a measured
    crossover length (banked in PERF.md). Capacity-bounded by
    ``FLAGS_kv_tier_host_mb`` with its own LRU; thread-safe (the spill
    worker puts, the engine loop gets).

``encode_entries`` / ``decode_entries``
    The wire form for the role-split fleet: a prefill-role replica
    serializes its chain blocks (base64 float32 rows) over the internal
    ``/v1/kv/prefill`` endpoint; a decode-role replica pulls and admits
    them into its own pool. The decoder re-verifies every chain link —
    a payload is data, never trusted naming.

The tier is an optimization layered on an unchanged correctness story:
every spilled / re-admitted / pulled block holds the exact float32 rows
the local prefill would have computed (same seeded params fleet-wide),
so every stream stays token-exact vs ``_reference_generate``.
"""

from __future__ import annotations

import base64
import threading
import time
from collections import OrderedDict, deque

import numpy as np

from ..fluid import profiler as _profiler

__all__ = [
    "HostBlockStore",
    "SpillWorker",
    "block_hash",
    "chain_keys",
    "decode_entries",
    "encode_entries",
    "read_peers",
]


def block_hash(prev_key, tokens):
    """Chain digest for one prompt block: block i's key folds in block
    i-1's, so equal keys mean equal WHOLE prefixes. A real digest
    (sha256 over prev_digest || token bytes), NOT ``hash()`` — the
    gateway hands this map client-controlled token ids, and a
    birthday-searchable 61-bit key would let a tenant engineer
    cross-request K/V reuse. Shared by the engine's index, the host
    store, and the router's affinity scorer — one definition, zero
    drift. No consumer trusts the key alone: every match re-compares
    the stored (prev, tokens) link."""
    import hashlib

    h = hashlib.sha256()
    h.update(repr(prev_key).encode())
    h.update(np.asarray(tokens, np.int64).tobytes())
    return h.hexdigest()


def chain_keys(prompt, block):
    """The prompt's full-block chain keys, root first: key i covers
    tokens [0, (i+1)*block). The router scores a backend by the deepest
    of these keys the backend advertises — chain keys name whole
    prefixes, so depth alone gives expected cached tokens."""
    out = []
    prev = 0
    for b in range(len(prompt) // int(block)):
        toks = tuple(prompt[b * block:(b + 1) * block])
        prev = block_hash(prev, toks)
        out.append(prev)
    return out


class _HostEntry(object):
    __slots__ = ("key", "prev", "tokens", "payload", "nbytes")

    def __init__(self, key, prev, tokens, payload):
        self.key = key
        self.prev = prev
        self.tokens = tuple(int(t) for t in tokens)
        # payload: [(k_row, v_row)] per layer, each a float32
        # [heads, block, d_head] HOST array — the exact bytes the pool
        # row held on device
        self.payload = payload
        self.nbytes = sum(k.nbytes + v.nbytes for k, v in payload)


class HostBlockStore(object):
    """Host-RAM LRU of spilled prefix blocks, keyed by chain digest.

    The device index's eviction shadow: ``put`` is called by the spill
    worker with the evicted block's K/V rows; ``get`` is called by the
    engine loop at admission when the chain walk outruns the device
    index. Thread-safe under one lock — both sides are rare relative to
    decode ticks, and the payloads themselves are immutable once
    stored. Capacity is bytes (``FLAGS_kv_tier_host_mb``); inserting
    past it evicts the host-LRU tail (``kv_tier_host_evictions``) —
    a block falling off BOTH tiers is finally recomputed, which is what
    every evicted block costs without the host tier."""

    def __init__(self, capacity_bytes):
        self.capacity_bytes = int(capacity_bytes)
        if self.capacity_bytes < 1:
            raise ValueError(
                "host store needs capacity_bytes >= 1, got %d"
                % self.capacity_bytes
            )
        self._lock = threading.Lock()
        self._entries = OrderedDict()  # key -> _HostEntry, LRU order
        self._bytes = 0
        self.spills = 0          # accepted puts
        self.readmits = 0        # hits the engine re-admitted
        self.host_evictions = 0  # entries the byte cap pushed out

    def __len__(self):
        with self._lock:
            return len(self._entries)

    @property
    def bytes_used(self):
        with self._lock:
            return self._bytes

    def put(self, key, prev, tokens, payload, tally=True):
        """Store one spilled block (idempotent: a key already resident
        just refreshes its LRU position — re-spilling the same content
        moves no new bytes). Returns True when the payload was
        accepted; an over-capacity single block is refused rather than
        flushing the whole store for one entry. ``tally=False`` skips
        the spill counters — a block PULLED from a peer is not a D2H
        spill (the pull path keeps its own kv_tier_pull_* tallies)."""
        e = _HostEntry(key, prev, tokens, payload)
        if e.nbytes > self.capacity_bytes:
            return False
        with self._lock:
            old = self._entries.get(key)
            if old is not None:
                self._entries.move_to_end(key)
                return True
            while self._bytes + e.nbytes > self.capacity_bytes:
                _k, victim = self._entries.popitem(last=False)
                self._bytes -= victim.nbytes
                self.host_evictions += 1
                _profiler.bump_counter("kv_tier_host_evictions")
            self._entries[key] = e
            self._bytes += e.nbytes
            if tally:
                self.spills += 1
        if tally:
            _profiler.bump_counter("kv_tier_spills")
            _profiler.bump_counter("kv_tier_bytes_d2h", e.nbytes)
        return True

    def get(self, key, prev, tokens):
        """The entry under ``key`` — chain-verified against the
        caller's (prev, tokens) link, LRU-refreshed. None on miss or
        link mismatch (a colliding key must fall through to prefill,
        same rule as the device index)."""
        tokens = tuple(int(t) for t in tokens)
        with self._lock:
            e = self._entries.get(key)
            if e is None or e.tokens != tokens or e.prev != prev:
                return None
            self._entries.move_to_end(key)
            return e

    def note_readmit(self, entry):
        """Tally one H2D re-admission of ``entry`` (the engine owns the
        actual pool write; the store owns the counters so unit tests
        can audit traffic without an engine)."""
        self.readmits += 1
        _profiler.bump_counter("kv_tier_readmits")
        _profiler.bump_counter("kv_tier_bytes_h2d", entry.nbytes)

    def stats(self):
        with self._lock:
            return {
                "host_blocks": len(self._entries),
                "host_bytes": self._bytes,
                "capacity_bytes": self.capacity_bytes,
                "spills": self.spills,
                "readmits": self.readmits,
                "host_evictions": self.host_evictions,
            }


class SpillWorker(object):
    """One daemon thread draining spill jobs off the engine tick.

    The engine loop must never pay a D2H read mid-tick, but eviction
    happens mid-tick (inside the admission path's allocation pressure).
    Protocol: the loop thread pins the evicted block (one extra
    allocator ref) and ``submit``s a job; this thread batches every
    queued job into ONE ``batch_fn(jobs)`` call (the engine's reader
    snapshots each per-layer pool once per batch, not once per block)
    and the engine's batch_fn hands the freed block ids back through
    its done-queue for the loop thread to decref. ``drain`` bounds the
    allocator-pressure path: when the free list is empty and blocks
    are pinned awaiting spill, the engine may wait (bounded) for this
    thread to finish the in-flight batch."""

    def __init__(self, batch_fn, name="kv-spill"):
        self._batch_fn = batch_fn
        self._jobs = deque()
        self._cond = threading.Condition()
        self._stop = False
        self._busy = 0  # jobs taken but not yet completed
        self._thread = threading.Thread(
            target=self._run, name=name, daemon=True
        )
        self._thread.start()

    def submit(self, job):
        with self._cond:
            if self._stop:
                raise RuntimeError("spill worker stopped")
            self._jobs.append(job)
            self._cond.notify_all()

    @property
    def pending(self):
        with self._cond:
            return len(self._jobs) + self._busy

    def drain(self, timeout=1.0):
        """Block (bounded) until every submitted job has completed.
        Returns True when fully drained."""
        deadline = time.monotonic() + float(timeout)
        with self._cond:
            while self._jobs or self._busy:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cond.wait(left)
        return True

    def stop(self, timeout=5.0):
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._thread.join(timeout=timeout)

    def _run(self):
        while True:
            with self._cond:
                while not self._jobs and not self._stop:
                    self._cond.wait()
                if not self._jobs and self._stop:
                    return
                batch = list(self._jobs)
                self._jobs.clear()
                self._busy = len(batch)
            try:
                self._batch_fn(batch)
            except Exception:  # noqa: BLE001 - spill is best-effort
                # a failed spill loses an optimization, never bytes a
                # request depends on; the engine's done-queue still gets
                # the block ids back (batch_fn guarantees it in its own
                # finally), so no block leaks pinned
                pass
            finally:
                with self._cond:
                    self._busy = 0
                    self._cond.notify_all()


# ---------------------------------------------------------------------------
# wire form: serialized chain blocks for the prefill -> decode pull path
# ---------------------------------------------------------------------------
def encode_entries(entries):
    """JSON-safe form of exported chain blocks: ``entries`` is
    [(key, prev, tokens, payload)] in CHAIN ORDER (root first), payload
    as in ``_HostEntry``. Arrays ride base64 float32 — bit-exact, and
    the decoder rebuilds shapes from the advertised geometry."""
    out = []
    for key, prev, tokens, payload in entries:
        out.append({
            "key": key,
            "prev": prev,
            "tokens": [int(t) for t in tokens],
            "layers": [
                [base64.b64encode(np.ascontiguousarray(
                    k, dtype=np.float32).tobytes()).decode("ascii"),
                 base64.b64encode(np.ascontiguousarray(
                     v, dtype=np.float32).tobytes()).decode("ascii")]
                for k, v in payload
            ],
        })
    return out


def decode_entries(blob, row_shape):
    """Inverse of ``encode_entries``: returns [(key, prev, tokens,
    payload)] with every array reshaped to ``row_shape``
    ([heads, block, d_head]) and every chain link RE-VERIFIED — an
    entry whose key does not hash from its own (prev, tokens) is
    dropped along with everything chained after it (a decode replica
    must never admit a block under a name its content doesn't earn)."""
    n = 1
    for d in row_shape:
        n *= int(d)
    out = []
    expect_prev = 0
    for d in blob:
        key, prev, tokens = d["key"], d["prev"], [int(t) for t in
                                                  d["tokens"]]
        if prev != expect_prev or block_hash(prev, tokens) != key:
            break
        payload = []
        ok = True
        for kb, vb in d["layers"]:
            k = np.frombuffer(base64.b64decode(kb), np.float32)
            v = np.frombuffer(base64.b64decode(vb), np.float32)
            if k.size != n or v.size != n:
                ok = False
                break
            payload.append((k.reshape(row_shape).copy(),
                            v.reshape(row_shape).copy()))
        if not ok:
            break
        out.append((key, prev, tuple(tokens), payload))
        expect_prev = key
    return out


def read_peers(path):
    """The controller-maintained peers file (atomic JSON): the prefill
    replicas a decode replica may pull published blocks from. Returns
    [] on any read problem — a torn or missing file degrades to local
    prefill, never an error."""
    import json
    import os

    if not path or not os.path.isfile(path):
        return []
    try:
        with open(path) as f:
            doc = json.load(f)
        peers = doc.get("peers") or []
        return [p for p in peers
                if isinstance(p, dict) and p.get("port")]
    except (OSError, ValueError):
        return []
