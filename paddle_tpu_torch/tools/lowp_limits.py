"""The limits a bf16 or fp16 flash training kernel is held to against its
plain version on the same inputs, and a run that shows which planted
faults those limits catch.

Both sides take the same low-precision q/k/v/dO, form scores and sums in
fp32 and round at the reference kernel's points. They differ in the
order of their fp32 sums and, in the forward, in which p they round: the
kernel rounds the running, unnormalised p (exp(s - m) against the row
maximum so far), the plain version the normalised softmax. Each output
meets two limits, written as ratios that pass at 1 or less:

- ``elem``, per element, a bound of what the two sides' roundings can
  do to that element from its own terms. out: eps * sum_j keep_ij p_ij
  |v_jd| / (1 - rate) + eps * |out_id| (each side moves each term of P.V
  by at most a unit roundoff u = eps / 2 of it, and rounds its result
  once), plus the subnormal spacing times sum_j |v_jd| / (1 - rate)
  (fp16's p underflows into subnormals, whose error is absolute); sum_j
  p |v| is the plain forward in fp32 on |v|. dq, dk, dv: both sides round
  ds (or keep * p / (1 - rate)) from fp32 values that differ only by
  fp32 rounding, so each rounded term differs by at most one ulp of it
  (eps |ds_ij|) plus that fp32 difference: the scores' (rho |ds_ij|,
  rho = 2 D u32 scale max|q| max|k| + 8 u32 through p) and dO.V's (2 D
  u32 p_ij sum_d |dO_id| |v_jd| / (1 - rate), which does not shrink when
  dp - delta cancels, as in a row with one live key). The bound sums
  those over the product (with the subnormal spacing for each nonzero
  term), adds each side's fp32 sum error (2 S u32 of the sum of |terms|)
  and eps * |ref| for the final rounding. Both bounds are worst cases
  (every rounding against the same side): at the train shape they run
  to ~10% of a late row's bf16 gradient and ~0.6% of fp16's at S = 130,
  so they catch gross faults in single elements; the block norms are
  the tight check.
- ``block``, per 64 rows of each (batch, head): the Frobenius norm of
  the difference in units of eps, relative to the block's out (at most
  ``OUT_BLOCK_EPS``) or to the root sum of squares of the terms of its
  dq, dk or dv (at most ``GRAD_BLOCK_EPS[dtype]``; rounding moves each
  term, so a gradient whose terms cancel is held to its terms). It
  scales with each block's own values, so the late rows of a causal
  sequence, whose outputs are small, are held as tightly as the early
  ones.

lse, dkey_bias and dbias are fp32 sums: ``FP32_ATOL`` absolute and
relative.

Planted faults, each against the correct plain version (which stands in
for a correct kernel), at the train step's causal shape with a padded
key tail and dropout 0.1::

    python3 -m paddle_tpu_torch.tools.lowp_limits [--heads 4] [--seq 1024]

prints one JSON line: for each fault, the largest ratio on each output
(above 1: caught). It runs on the CPU. The readings of the CUDA kernels
that the limits are set from, on a machine with a card::

    python3 -m paddle_tpu_torch.tools.lowp_limits --card
"""

import argparse
import json
import math

import torch
import torch.nn.functional as F

from paddle_tpu_torch.kernels import flash_attention as fa

# Set from the card's readings (``--card``; PERF.md, Findings):
# out reads up to 0.63 eps of block norm in either type; dq/dk/dv up to
# 0.12 eps in bf16 and 0.33 eps in fp16, whose 3 more bits let the two
# sides' fp32 differences flip more of its roundings. The backward's ds
# and p left unrounded read 0.35-0.44 eps: caught in bf16 (the AMP
# step's type), not in fp16.
OUT_BLOCK_EPS = 1.0
GRAD_BLOCK_EPS = {torch.bfloat16: 0.25, torch.float16: 0.6}
FP32_ATOL = 1e-4
BLOCK_ROWS = 64


def _eps(dtype):
    return torch.finfo(dtype).eps


def out_bound(dtype, q, k, v, ref_out, key_bias=None, bias=None,
              causal=False, scale=None, dropout_rate=0.0, dropout_seed=None):
    """Per-element limit (fp32, out's shape) of |out_kernel - out_plain|
    for the forward on ``dtype`` inputs; arguments as
    ``flash_attention_lse_plain``, ``ref_out`` the plain version's out."""
    e = _eps(dtype)
    rate = float(dropout_rate or 0.0)
    absv, _lse = fa.flash_attention_lse_plain(
        q.float(), k.float(), v.float().abs(), key_bias=key_bias, bias=bias,
        causal=causal, scale=scale, dropout_rate=rate,
        dropout_seed=dropout_seed)
    subnormal = torch.finfo(dtype).tiny * e
    vsum = v.float().abs().sum(-2, keepdim=True) / (1.0 - rate)
    return e * absv + e * ref_out.float().abs() + subnormal * vsum


def grad_bounds(dtype, q, k, v, key_bias, g, lse, delta, refs, causal=False,
                scale=None, dropout_rate=0.0, dropout_seed=None, bias=None):
    """((bound, rss) for dq, dk and dv) of the backward on ``dtype``
    inputs, arguments as ``flash_bwd_dq_plain``, ``refs`` the plain
    version's (dq, dk, dv): per element, the limit of |kernel - plain|
    and the root sum of squares of the element's terms (ds_ij k_jd scale,
    ds_ij q_id scale, pv_ij dO_id), the scale of what rounding each term
    can do."""
    e, u32 = _eps(dtype), torch.finfo(torch.float32).eps / 2
    Sq, D = q.shape[-2], q.shape[-1]
    Sk = k.shape[-2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    rate = float(dropout_rate or 0.0)
    terms = dict(causal=causal, scale=scale, rate=rate,
                 dropout_seed=dropout_seed, bias=bias)
    ds, pv = fa._bwd_terms(q, k, v, key_bias, g, lse, delta, **terms)
    # p_ij keep_ij sum_d |dO_id| |v_jd| / (1 - rate): dO.V's fp32 scale
    dpn, _pv = fa._bwd_terms(q, k, v.abs(), key_bias, g.abs(), lse,
                             torch.zeros_like(delta), **terms)
    qn = q.float().norm(dim=-1).max()
    kn = k.float().norm(dim=-1).max()
    rho = float(2 * D * u32 * scale * qn * kn + 8 * u32)
    subnormal = torch.finfo(dtype).tiny * e      # fp16's absolute floor
    dds = ((e + rho + 2 * max(Sq, Sk) * u32) * ds.abs() + 2 * D * u32 * dpn
           + subnormal * (ds != 0))
    dpv = (e + rho + 2 * Sq * u32) * pv + subnormal * (pv != 0)
    kf, qf, gf = k.float(), q.float(), g.float()
    ds2, pv2 = ds.square(), pv.square()
    out = []
    for spec, w, x, x2, ref, sc in (
            ("bnqk,bnkd->bnqd", dds, kf, ds2, refs[0], scale),
            ("bnqk,bnqd->bnkd", dds, qf, ds2, refs[1], scale),
            ("bnqk,bnqd->bnkd", dpv, gf, pv2, refs[2], 1.0)):
        bound = sc * torch.einsum(spec, w, x.abs()) + e * ref.float().abs()
        rss = sc * torch.einsum(spec, x2, x.square()).sqrt()
        out.append((bound, rss))
    return tuple(out)


def _block_rel(got, want, scale, rows=BLOCK_ROWS):
    """Largest ||got - want|| / ||scale|| over blocks of ``rows`` rows of
    each [..., S, D] matrix; a block whose ``scale`` is all zero must
    match exactly."""
    d, w = got.float() - want.float(), scale.float()
    S, D = w.shape[-2], w.shape[-1]
    pad = (-S) % rows
    if pad:
        d, w = F.pad(d, (0, 0, 0, pad)), F.pad(w, (0, 0, 0, pad))
    shape = w.shape[:-2] + ((S + pad) // rows, rows * D)
    num = d.reshape(shape).norm(dim=-1)
    den = w.reshape(shape).norm(dim=-1)
    ratio = torch.where(den > 0, num / den.clamp_min(1e-30),
                        torch.where(num > 0, math.inf, 0.0))
    return float(ratio.max())


def _elem(got, want, bound):
    """Largest |got - want| / bound; where the bound is 0 (a padded key's
    dk and dv, a row that dropout emptied) the two must be equal."""
    d = (got.float() - want.float()).abs()
    ratio = torch.where(bound > 0, d / bound.clamp_min(1e-30),
                        torch.where(d > 0, math.inf, 0.0))
    return float(ratio.max())


def out_ratios(dtype, got, want, bound):
    """{"elem", "block"} of a forward's out against the plain version's
    ``want``, ``bound`` from ``out_bound``: 1 or less passes."""
    return {"elem": _elem(got, want, bound),
            "block": _block_rel(got, want, want)
            / (OUT_BLOCK_EPS * _eps(dtype))}


def grad_ratios(dtype, got, want, bound_rss):
    """{"elem", "block"} of dq, dk or dv against the plain version's
    ``want``, ``bound_rss`` its entry of ``grad_bounds``: 1 or less
    passes."""
    bound, rss = bound_rss
    return {"elem": _elem(got, want, bound),
            "block": _block_rel(got, want, rss)
            / (GRAD_BLOCK_EPS[dtype] * _eps(dtype))}


def check(name, ratios):
    """Raise if a ratio of ``out_ratios``/``grad_ratios`` is above 1."""
    worst = max(ratios.values())
    if not worst <= 1.0:
        raise AssertionError("%s disagrees with its plain version beyond its "
                             "limits: %r" % (name, ratios))
    return worst


# ---------------------------------------------------------------------------
# planted faults
# ---------------------------------------------------------------------------


def _masked_keys(S, rows_from, keys):
    """[S, S] general bias that hides ``keys`` (a [S, S] bool mask over
    (row, key)) from rows ``rows_from`` onwards."""
    hide = keys.clone()
    hide[:rows_from] = False
    return torch.where(hide, torch.tensor(-1e4), torch.tensor(0.0))


def planted_faults(B=1, N=4, S=1024, D=64, dtype=torch.bfloat16, rate=0.1,
                   seed=0):
    """{fault: {output: largest ratio}} of faults a kernel could have,
    against the plain version on the same inputs (causal, a padded key
    tail on the last batch row, dropout ``rate``), on the CPU:

    - ``late_rows_2pct``: rows from S/2 on 2% too large;
    - ``first_key_tile_skipped``: rows from S/2 skip keys [0, 64);
    - ``diagonal_tile_skipped``: rows from S/2 skip the 64-key tile that
      holds their own position;
    - ``one_key_dropped``: key S/2 hidden from every row;
    - ``p_unrounded``: the forward's P.V on fp32 p (no rounding of p);
    - ``ds_p_unrounded``: the backward's products on fp32 ds and p.

    The backward faults run from the correct forward's lse and delta, as
    a backward kernel with that fault would."""
    gen = torch.Generator().manual_seed(seed)
    q, k, v, g = (torch.randn(B, N, S, D, generator=gen).to(dtype)
                  for _ in range(4))
    kb = torch.zeros(B, S)
    kb[-1, S - S // 8:] = -1e4
    kw = dict(causal=True, dropout_rate=rate, dropout_seed=1234)
    out, lse = fa.flash_attention_lse_plain(q, k, v, key_bias=kb, **kw)
    bound = out_bound(dtype, q, k, v, out, key_bias=kb, **kw)
    delta = (g.float() * out.float()).sum(-1)
    args = (q, k, v, kb, g, lse, delta)
    dq = fa.flash_bwd_dq_plain(*args, **kw)
    dk, dv, _dkb = fa.flash_bwd_dkv_plain(*args, **kw)
    want = {"dq": dq, "dk": dk, "dv": dv}
    gbound = dict(zip(want, grad_bounds(dtype, *args, (dq, dk, dv), **kw)))

    def score(got_out=None, grads=None):
        r = {}
        if got_out is not None:
            r["out"] = max(out_ratios(dtype, got_out, out, bound).values())
        for name, got in (grads or {}).items():
            r[name] = max(grad_ratios(dtype, got, want[name],
                                      gbound[name]).values())
        return r

    def with_bias(bias):
        o, _ = fa.flash_attention_lse_plain(q, k, v, key_bias=kb, bias=bias,
                                            **kw)
        bargs = (q, k, v, kb, g, lse, delta)
        gq = fa.flash_bwd_dq_plain(*bargs, bias=bias, **kw)
        gk, gv = fa.flash_bwd_dkv_plain(*bargs, bias=bias, **kw)[:2]
        return score(o, {"dq": gq, "dk": gk, "dv": gv})

    rows = torch.arange(S).reshape(S, 1)
    keys = torch.arange(S).reshape(1, S)
    late = torch.ones(S, 1)
    late[S // 2:] = 1.02
    res = {"late_rows_2pct": score(
        (out.float() * late).to(dtype),
        {n: (t.float() * late).to(dtype) for n, t in want.items()})}
    res["first_key_tile_skipped"] = with_bias(
        _masked_keys(S, S // 2, (keys < 64).expand(S, S)))
    res["diagonal_tile_skipped"] = with_bias(
        _masked_keys(S, S // 2, keys // 64 == rows // 64))
    res["one_key_dropped"] = with_bias(
        _masked_keys(S, 0, (keys == S // 2).expand(S, S)))
    o32, _ = fa.flash_attention_lse_plain(q, k, v.float(), key_bias=kb, **kw)
    res["p_unrounded"] = score(o32.to(dtype))
    up = tuple(t.float() if t.dtype == dtype else t for t in args)
    res["ds_p_unrounded"] = score(grads={
        "dq": fa.flash_bwd_dq_plain(*up, **kw).to(dtype),
        **{n: t.to(dtype) for n, t in
           zip(("dk", "dv"), fa.flash_bwd_dkv_plain(*up, **kw)[:2])}})
    return res


# (name, dtype, B, N, S, D, causal, dropout rate, per-head bias, seed,
# first padded key of the last batch row)
_CARD_CASES = [("train_bf16", torch.bfloat16, 8, 12, 1024, 64, True, 0.1,
                False, 6, 1000)] + [
    ("%s_%s_D%d" % (shape, name, D), dtype, B, N, S, D, causal, rate, bias,
     seed + D, pad)
    for name, dtype in (("bf16", torch.bfloat16), ("fp16", torch.float16))
    for D in (16, 48, 64, 128, 256)
    for shape, B, N, S, causal, rate, bias, seed, pad in (
        ("S130_bias", 2, 3, 130, True, 0.1, True, 99, 100),
        ("S100", 2, 3, 100, True, 0.1, False, 7, 77),
        ("S150_noncausal_bias", 2, 3, 150, False, 0.0, True, 3, 127),
        ("S1024", 1, 4, 1024, True, 0.1, False, 11, 900))]


def card_readings():
    """{case: {output: ratios}} of the CUDA kernels against their plain
    versions on the card over ``_CARD_CASES``, and the largest ratio of
    each (type, output, limit): the readings the limits are set from."""
    cases, worst = {}, {}
    for (name, dtype, B, N, S, D, causal, rate, bias, seed,
         pad) in _CARD_CASES:
        gen = torch.Generator().manual_seed(seed)
        q, k, v, g = (torch.randn(B, N, S, D, generator=gen).cuda().to(dtype)
                      for _ in range(4))
        gb = ((torch.randn(1, N, S, S, generator=gen) * 0.5).cuda()
              if bias else None)
        kb = torch.zeros(B, S)
        kb[-1, pad:] = -1e4
        kb = kb.cuda()
        kw = dict(causal=causal, dropout_rate=rate,
                  dropout_seed=seed if rate else None, bias=gb)
        out, lse = fa.flash_attention_lse(q, k, v, kb, **kw)
        ref, _lse = fa.flash_attention_lse_plain(q, k, v, key_bias=kb, **kw)
        r = {"out": out_ratios(dtype, out, ref, out_bound(
            dtype, q, k, v, ref, key_bias=kb, **kw))}
        args = (q, k, v, kb, g, lse, (g.float() * out.float()).sum(-1))
        got = (fa.flash_bwd_dq(*args, **kw),) + fa.flash_bwd_dkv(
            *args, **kw)[:2]
        want = (fa.flash_bwd_dq_plain(*args, **kw),) + fa.flash_bwd_dkv_plain(
            *args, **kw)[:2]
        for oname, a, w, b in zip(("dq", "dk", "dv"), got, want,
                                  grad_bounds(dtype, *args, want, **kw)):
            r[oname] = grad_ratios(dtype, a, w, b)
        cases[name] = r
        tname = "bf16" if dtype == torch.bfloat16 else "fp16"
        for oname, ratios in r.items():
            for limit, x in ratios.items():
                key = "%s_%s_%s" % (tname, oname, limit)
                worst[key] = max(worst.get(key, 0.0), x)
    return {"cases": cases, "worst": worst}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--card", action="store_true",
                    help="the kernels' readings on the card instead")
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--dtype", choices=("bf16", "fp16"), default="bf16")
    a = ap.parse_args(argv)
    dtype = torch.bfloat16 if a.dtype == "bf16" else torch.float16
    limits = {"out_block_eps": OUT_BLOCK_EPS,
              "grad_block_eps": {"bf16": GRAD_BLOCK_EPS[torch.bfloat16],
                                 "fp16": GRAD_BLOCK_EPS[torch.float16]}}
    if a.card:
        res = dict(card_readings(), device=torch.cuda.get_device_name(0))
    else:
        res = {"planted_faults": planted_faults(N=a.heads, S=a.seq,
                                                dtype=dtype),
               "shape": [1, a.heads, a.seq, 64], "dtype": a.dtype}
    print(json.dumps(dict(res, limits=limits)))


if __name__ == "__main__":
    main()
