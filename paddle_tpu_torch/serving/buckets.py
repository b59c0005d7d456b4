"""Padding-bucket shape planner (a copy of ``paddle_tpu/serving/buckets.py``).

The planner rounds a coalesced micro-batch's (batch, seq) up to a small
fixed ladder of buckets, so steady-state traffic runs at a fixed set of
shapes that the server warmed at start (in the port: the Executor's plan
and every kernel library are built and the card's caching allocator has
seen each size before the first request), and records exactly what was
padded so the rows and positions can be stripped before results return
to callers.

Batch padding replicates the last valid row (edge padding): replicated
rows travel through any model without numeric hazards (no zero rows
hitting a layer_norm denominator or an embedding lookup with id 0
semantics) and are sliced off before anyone sees them. Sequence-axis
padding is opt-in (`seq_buckets`) because it is only sound for models
that mask padded positions; integer feeds pad with `seq_pad_value`
(e.g. a pad token id) and float feeds (masks) pad with zeros, which is
precisely the masked-position convention of the repo's BERT/GPT models.
"""

from __future__ import annotations

import numpy as np

__all__ = ["BucketLadder", "BatchPlan"]


def _default_batch_buckets(max_batch):
    """1, 2, 4, ... up to and including max_batch (always included, so the
    coalescer's fullest batch maps onto a bucket)."""
    out = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return out


class BatchPlan(object):
    """What one padded dispatch looked like — consumed by unpad_outputs
    and by the fill-ratio metrics."""

    __slots__ = ("rows", "padded_rows", "seq", "padded_seq", "seq_axis")

    def __init__(self, rows, padded_rows, seq=None, padded_seq=None,
                 seq_axis=1):
        self.rows = rows
        self.padded_rows = padded_rows
        self.seq = seq
        self.padded_seq = padded_seq
        self.seq_axis = seq_axis


class BucketLadder(object):
    """Rounds (batch, seq) up to fixed buckets; pads and unpads feeds.

    ``batch_buckets``: ascending batch sizes (default powers of two up to
    ``max_batch``). ``seq_buckets``: optional ascending sequence lengths;
    when given, feeds of rank >= 2 are padded along ``seq_axis``.
    """

    def __init__(self, max_batch=8, batch_buckets=None, seq_buckets=None,
                 seq_axis=1, seq_pad_value=0, trim_seq_outputs=True):
        if batch_buckets is None:
            batch_buckets = _default_batch_buckets(int(max_batch))
        self.batch_buckets = sorted(set(int(b) for b in batch_buckets))
        if not self.batch_buckets or self.batch_buckets[0] < 1:
            raise ValueError("batch_buckets must be positive: %r"
                             % (batch_buckets,))
        self.seq_buckets = (
            sorted(set(int(s) for s in seq_buckets)) if seq_buckets else None
        )
        self.seq_axis = int(seq_axis)
        self.seq_pad_value = seq_pad_value
        self.trim_seq_outputs = bool(trim_seq_outputs)

    @property
    def max_batch(self):
        return self.batch_buckets[-1]

    def batch_bucket(self, rows):
        """Smallest bucket >= rows. rows beyond the ladder is an admission
        error (the coalescer caps batches at max_batch)."""
        for b in self.batch_buckets:
            if b >= rows:
                return b
        raise ValueError(
            "batch of %d rows exceeds the bucket ladder (max %d)"
            % (rows, self.max_batch)
        )

    def seq_bucket(self, seq):
        for s in self.seq_buckets:
            if s >= seq:
                return s
        raise ValueError(
            "sequence length %d exceeds the bucket ladder (max %d)"
            % (seq, self.seq_buckets[-1])
        )

    def shapes(self):
        """Every (padded_rows, padded_seq) combination on the ladder —
        the warmup set. padded_seq is None without seq bucketing."""
        if self.seq_buckets is None:
            return [(b, None) for b in self.batch_buckets]
        return [(b, s) for b in self.batch_buckets
                for s in self.seq_buckets]

    # -- pad / unpad ---------------------------------------------------------
    def plan(self, feeds):
        """BatchPlan for a list of stacked per-feed arrays (row-major on
        axis 0; all feeds carry the same row count)."""
        rows = int(np.shape(feeds[0])[0])
        seq = padded_seq = None
        if self.seq_buckets is not None:
            lens = [int(a.shape[self.seq_axis]) for a in feeds
                    if np.ndim(a) > self.seq_axis]
            if lens:
                seq = max(lens)
                padded_seq = self.seq_bucket(seq)
        return BatchPlan(rows, self.batch_bucket(rows), seq, padded_seq,
                         self.seq_axis)

    def pad_feeds(self, feeds, plan=None):
        """(padded_feeds, plan). Rows pad by edge replication; the seq
        axis (when bucketed) pads ints with seq_pad_value and floats with
        zeros."""
        feeds = [np.asarray(a) for a in feeds]
        if plan is None:
            plan = self.plan(feeds)
        out = []
        for a in feeds:
            if (plan.padded_seq is not None and np.ndim(a) > self.seq_axis
                    and a.shape[self.seq_axis] < plan.padded_seq):
                width = [(0, 0)] * a.ndim
                width[self.seq_axis] = (
                    0, plan.padded_seq - a.shape[self.seq_axis]
                )
                fill = (self.seq_pad_value
                        if np.issubdtype(a.dtype, np.integer) else 0)
                a = np.pad(a, width, mode="constant", constant_values=fill)
            if a.shape[0] < plan.padded_rows:
                width = [(0, 0)] * a.ndim
                width[0] = (0, plan.padded_rows - a.shape[0])
                a = np.pad(a, width, mode="edge")
            out.append(a)
        return out, plan

    def unpad_outputs(self, outputs, plan):
        """Strip the padding the plan added: outputs whose axis 0 equals
        the padded row count lose the replica rows; outputs carrying the
        padded seq length on seq_axis lose the padded positions. Outputs
        with neither (scalars, reductions) pass through — but a scalar
        from a row-padded batch AGGREGATED the replica rows, which cannot
        be undone here; serve per-row outputs.

        Seq trimming is by SHAPE MATCH on seq_axis: a non-sequence output
        dimension that happens to equal the padded seq length (e.g.
        num_classes == a seq bucket) would be trimmed too. Models with
        such colliding output shapes must build the ladder with
        ``trim_seq_outputs=False`` and strip seq padding themselves."""
        out = []
        for a in outputs:
            a = np.asarray(a)
            if (plan.padded_rows != plan.rows and a.ndim >= 1
                    and a.shape[0] == plan.padded_rows):
                a = a[: plan.rows]
            if (self.trim_seq_outputs
                    and plan.padded_seq is not None
                    and plan.padded_seq != plan.seq
                    and a.ndim > self.seq_axis
                    and a.shape[self.seq_axis] == plan.padded_seq):
                idx = [slice(None)] * a.ndim
                idx[self.seq_axis] = slice(0, plan.seq)
                a = a[tuple(idx)]
            out.append(a)
        return out
