"""Metric ops (port of ``paddle_tpu/fluid/ops/metric_ops.py``): the
plain functions on tensors and their registered lowerings. No gradient,
as in the reference. ``auc`` and ``precision_recall`` update their state
inputs in place when the outputs name them; ``edit_distance``,
``chunk_eval`` and ``positive_negative_pair`` compute on the host, as the
reference's do, each input read once (``op_host_reads``) and the outputs
put back on the op's device."""

import numpy as np
import torch

from .. import core
from .registry import SkipInferShape, in_var, op, register_op, set_out
from .sequence_ops import SEQ_LEN

__all__ = ["accuracy", "mean_iou", "auc", "precision_recall",
           "edit_distance", "chunk_eval", "positive_negative_pair"]


def accuracy(indices, label):
    """The ``accuracy`` op (``metric_ops.py:12``) from the top-k
    ``indices`` [N, k] and the ``label`` [N, 1] (or [N]): a row is
    correct when any of its k indices is its label. Returns (Accuracy
    float32 [1], Correct int32 [1], Total int32 [1])."""
    lab = label if label.dim() == indices.dim() else label.unsqueeze(-1)
    correct = (indices == lab).any(-1)
    num = correct.sum(dtype=torch.int32).reshape((1,))
    total = correct.numel()
    acc = num.to(torch.float32) / float(total)
    return acc, num, torch.full((1,), total, dtype=torch.int32,
                                device=indices.device)


def _accuracy_infer(op_, block):
    if in_var(op_, block, "Indices") is None:
        raise SkipInferShape()
    set_out(op_, block, "Accuracy", (1,), core.VarDesc.VarType.FP32)
    set_out(op_, block, "Correct", (1,), core.VarDesc.VarType.INT32)
    set_out(op_, block, "Total", (1,), core.VarDesc.VarType.INT32)


@op("accuracy", infer_shape=_accuracy_infer)
def _accuracy(ctx, op_):
    acc, num, total = accuracy(ctx.in1(op_, "Indices"),
                               ctx.in1(op_, "Label"))
    ctx.out(op_, "Accuracy", acc)
    ctx.out(op_, "Correct", num)
    ctx.out(op_, "Total", total)


def mean_iou(pred, label, num_classes):
    """``metric_ops.py:31``: per class, predictions and labels that agree
    (``OutCorrect``) and those in the class's union that do not
    (``OutWrong``), int32 [num_classes]; ``OutMeanIou`` [1] the mean
    intersection over union of the classes present. A value outside
    [0, num_classes) (an ignore label) counts for no class."""
    cls = torch.arange(num_classes, device=pred.device)
    p = pred.reshape(-1, 1) == cls
    lab = label.reshape(-1, 1) == cls
    inter = (p & lab).sum(0).to(torch.float32)
    union = (p | lab).sum(0).to(torch.float32)
    iou = torch.where(union > 0, inter / union.clamp_min(1.0),
                      torch.zeros_like(union))
    valid = (union > 0).sum().to(torch.float32)
    miou = (iou.sum() / valid.clamp_min(1.0)).reshape((1,))
    return miou, (union - inter).to(torch.int32), inter.to(torch.int32)


@op("mean_iou")
def _mean_iou(ctx, op_):
    miou, wrong, correct = mean_iou(ctx.in1(op_, "Predictions"),
                                    ctx.in1(op_, "Labels"),
                                    int(op_.attr("num_classes")))
    ctx.out(op_, "OutMeanIou", miou)
    ctx.out(op_, "OutWrong", wrong)
    ctx.out(op_, "OutCorrect", correct)


def auc(predict, label, stat_pos, stat_neg, num_thresholds=4095):
    """``metric_ops.py:49``: each sample's positive probability bucketed
    into ``num_thresholds`` + 1 int64 buckets added to the running
    (StatPos, StatNeg); AUC (float64 scalar) the trapezoid over the
    buckets walked from high to low. Returns (AUC, new StatPos, new
    StatNeg)."""
    pos_prob = predict[:, 1] if predict.dim() == 2 else predict.reshape(-1)
    bucket = (pos_prob * num_thresholds).to(torch.int32).clamp(
        0, num_thresholds).long()
    is_pos = (label.reshape(-1) > 0).long()
    stat_pos = stat_pos.reshape(-1).long().index_add(0, bucket, is_pos)
    stat_neg = stat_neg.reshape(-1).long().index_add(0, bucket, 1 - is_pos)
    tp = torch.cumsum(stat_pos.flip(0), 0).double()
    fp = torch.cumsum(stat_neg.flip(0), 0).double()
    zero = tp.new_zeros((1,))
    tp_prev = torch.cat([zero, tp[:-1]])
    fp_prev = torch.cat([zero, fp[:-1]])
    area = ((fp - fp_prev) * (tp + tp_prev) / 2.0).sum()
    value = area / (tp[-1].clamp_min(1) * fp[-1].clamp_min(1))
    return value.reshape(()), stat_pos, stat_neg


@op("auc")
def _auc(ctx, op_):
    value, sp, sn = auc(ctx.in1(op_, "Predict"), ctx.in1(op_, "Label"),
                        ctx.in1(op_, "StatPos"), ctx.in1(op_, "StatNeg"),
                        int(op_.attr("num_thresholds", 4095)))
    ctx.out(op_, "AUC", value)
    ctx.write_state(op_, "StatPos", "StatPosOut", sp)
    ctx.write_state(op_, "StatNeg", "StatNegOut", sn)


def _pr_metrics(st):
    """(macro P, R, F1, micro P, R, F1) of [C, 4] (TP, FP, TN, FN)."""
    tp, fp, fn = st[:, 0], st[:, 1], st[:, 3]

    def ratio(a, b):
        return torch.where(b > 0, a / b.clamp_min(1e-10), torch.zeros_like(a))

    prec, rec = ratio(tp, tp + fp), ratio(tp, tp + fn)
    f1 = ratio(2 * prec * rec, prec + rec)
    tps, fps, fns = tp.sum(), fp.sum(), fn.sum()
    mp, mr = ratio(tps, tps + fps), ratio(tps, tps + fns)
    mf = ratio(2 * mp * mr, mp + mr)
    return torch.stack([prec.mean(), rec.mean(), f1.mean(), mp, mr, mf])


def precision_recall(indices, labels, states, weights=None):
    """``metric_ops.py:84``: per class (weighted) TP, FP, TN, FN of the
    batch, added to ``states`` [C, 4]; returns (BatchMetrics [1, 6],
    AccumMetrics [1, 6], the accumulated states)."""
    C = states.shape[0]
    cls = torch.arange(C, device=states.device)
    pred_oh = (indices.reshape(-1, 1) == cls).to(torch.float32)
    lab_oh = (labels.reshape(-1, 1) == cls).to(torch.float32)
    w = torch.ones(lab_oh.shape[0], dtype=torch.float32,
                   device=states.device) if weights is None else \
        weights.reshape(-1).to(torch.float32)
    wc = w[:, None]
    tp = (wc * pred_oh * lab_oh).sum(0)
    fp = (wc * pred_oh).sum(0) - tp
    fn = (wc * lab_oh).sum(0) - tp
    tn = w.sum() - tp - fp - fn
    batch = torch.stack([tp, fp, tn, fn], 1)
    accum = states.to(torch.float32) + batch
    return (_pr_metrics(batch).reshape(1, 6),
            _pr_metrics(accum).reshape(1, 6), accum)


@op("precision_recall")
def _precision_recall(ctx, op_):
    batch, acc_m, accum = precision_recall(
        ctx.in1(op_, "Indices"), ctx.in1(op_, "Labels"),
        ctx.in1(op_, "StatesInfo"), ctx.in1(op_, "Weights", optional=True))
    ctx.out(op_, "BatchMetrics", batch)
    ctx.out(op_, "AccumMetrics", acc_m)
    ctx.write_state(op_, "StatesInfo", "AccumStatesInfo", accum)


# ---------------------------------------------------------------------------
# host metrics: plain numpy on the values read once
# ---------------------------------------------------------------------------
def _host_input(ctx, op_, slot):
    names = op_.inputs.get(slot) or []
    return ctx.host_array(names[0]) if names else None


def _host_lengths(ctx, op_, slot, len_slot):
    """The lengths of input ``slot``: its ``len_slot`` input, else its
    ``@SEQ_LEN`` companion, else None; read on the host."""
    explicit = _host_input(ctx, op_, len_slot)
    if explicit is not None:
        return explicit.reshape(-1)
    key = op_.input(slot)[0] + SEQ_LEN
    while ctx is not None and key not in ctx.env:
        ctx = ctx.parent
    return None if ctx is None else ctx.host_array(key).reshape(-1)


def _put(ctx, op_, slot, array):
    ctx.out(op_, slot, torch.from_numpy(np.ascontiguousarray(array)).to(
        ctx.device))


def _rows(a):
    a = np.asarray(a)
    return a[:, :, 0] if a.ndim == 3 else a


def edit_distance(hyp, ref, hyp_lens=None, ref_lens=None, normalized=True,
                  ignored_tokens=()):
    """``metric_ops.py:132`` on host arrays: each row pair's Levenshtein
    distance over its first ``lens`` tokens less the ignored ones,
    divided by the reference's length when ``normalized``; (Out float32
    [B, 1], SequenceNum int64 [1])."""
    hyp, ref = _rows(hyp), _rows(ref)
    B = hyp.shape[0]
    hl = np.full(B, hyp.shape[1]) if hyp_lens is None else hyp_lens
    rl = np.full(B, ref.shape[1]) if ref_lens is None else ref_lens
    ignored = set(int(t) for t in ignored_tokens)
    out = np.zeros((B, 1), np.float32)
    for b in range(B):
        h = [int(t) for t in hyp[b, :hl[b]] if int(t) not in ignored]
        r = [int(t) for t in ref[b, :rl[b]] if int(t) not in ignored]
        prev = list(range(len(r) + 1))
        for i in range(1, len(h) + 1):
            cur = [i] + [0] * len(r)
            for j in range(1, len(r) + 1):
                cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                             prev[j - 1] + (h[i - 1] != r[j - 1]))
            prev = cur
        d = float(prev[len(r)])
        out[b, 0] = d / max(len(r), 1) if normalized else d
    return out, np.asarray([B], np.int64)


def _edit_distance_op(ctx, op_):
    out, num = edit_distance(
        _host_input(ctx, op_, "Hyps"), _host_input(ctx, op_, "Refs"),
        _host_lengths(ctx, op_, "Hyps", "HypsLength"),
        _host_lengths(ctx, op_, "Refs", "RefsLength"),
        bool(op_.attr("normalized", True)),
        op_.attr("ignored_tokens") or [])
    _put(ctx, op_, "Out", out)
    _put(ctx, op_, "SequenceNum", num)


def _chunks(tags, length, num_chunk_types, scheme):
    """{(start, end, type)} of one row: IOB (tag = 2·type, +1 inside;
    B starts a chunk) or plain (tag = type, a chunk a maximal run)."""
    out = []
    start, ctype = None, None
    limit = num_chunk_types * 2 if scheme == "IOB" else num_chunk_types
    for t in range(int(length)):
        tag = int(tags[t])
        if tag >= limit:
            if start is not None:
                out.append((start, t, ctype))
                start = None
            continue
        if scheme == "IOB":
            ty, begins = tag // 2, tag % 2 == 0
        else:
            ty, begins = tag, ctype != tag
        if not begins and ctype == ty and start is not None:
            continue
        if start is not None:
            out.append((start, t, ctype))
        start, ctype = t, ty
    if start is not None:
        out.append((start, int(length), ctype))
    return set(out)


def chunk_eval(inference, label, lengths, num_chunk_types, scheme="IOB"):
    """``metric_ops.py:186`` on host arrays: chunk precision, recall and
    F1 (float32 [1] each) and the int64 [1] counts of inferred, labelled
    and correct chunks."""
    if scheme not in ("IOB", "plain"):
        raise NotImplementedError(
            "chunk_eval: scheme %r not supported (IOB and plain only)"
            % scheme)
    inf, lab = _rows(inference), _rows(label)
    B, T = inf.shape
    lens = np.full(B, T) if lengths is None else lengths
    n_inf = n_lab = n_cor = 0
    for b in range(B):
        ic = _chunks(inf[b], lens[b], num_chunk_types, scheme)
        lc = _chunks(lab[b], lens[b], num_chunk_types, scheme)
        n_inf, n_lab, n_cor = n_inf + len(ic), n_lab + len(lc), \
            n_cor + len(ic & lc)
    p = n_cor / n_inf if n_inf else 0.0
    r = n_cor / n_lab if n_lab else 0.0
    f1 = 2 * p * r / (p + r) if p + r else 0.0
    f = lambda v: np.asarray([v], np.float32)  # noqa: E731
    i = lambda v: np.asarray([v], np.int64)  # noqa: E731
    return f(p), f(r), f(f1), i(n_inf), i(n_lab), i(n_cor)


def _chunk_eval_op(ctx, op_):
    got = chunk_eval(_host_input(ctx, op_, "Inference"),
                     _host_input(ctx, op_, "Label"),
                     _host_lengths(ctx, op_, "Inference", "SeqLength"),
                     int(op_.attr("num_chunk_types")),
                     op_.attr("chunk_scheme", "IOB"))
    for slot, v in zip(("Precision", "Recall", "F1-Score", "NumInferChunks",
                        "NumLabelChunks", "NumCorrectChunks"), got):
        _put(ctx, op_, slot, v)


def positive_negative_pair(score, label, query):
    """``metric_ops.py:263`` on host arrays: over the pairs of one query
    with different labels, those the scores order as the labels
    (positive), the other way (negative) and tied (neutral); float32
    [1] each."""
    score, label = score.reshape(-1), label.reshape(-1)
    qid = query.reshape(-1)
    pos = neg = neu = 0.0
    for q in np.unique(qid):
        idx = np.where(qid == q)[0]
        for a in range(len(idx)):
            for b in range(a + 1, len(idx)):
                i, j = idx[a], idx[b]
                if label[i] == label[j]:
                    continue
                ds = score[i] - score[j]
                if ds * (label[i] - label[j]) > 0:
                    pos += 1
                elif ds == 0:
                    neu += 1
                else:
                    neg += 1
    return tuple(np.asarray([v], np.float32) for v in (pos, neg, neu))


def _positive_negative_pair_op(ctx, op_):
    got = positive_negative_pair(_host_input(ctx, op_, "Score"),
                                 _host_input(ctx, op_, "Label"),
                                 _host_input(ctx, op_, "QueryID"))
    for slot, v in zip(("PositivePair", "NegativePair", "NeutralPair"), got):
        _put(ctx, op_, slot, v)


register_op("edit_distance", lower=_edit_distance_op)
register_op("chunk_eval", lower=_chunk_eval_op)
register_op("positive_negative_pair", lower=_positive_negative_pair_op)
