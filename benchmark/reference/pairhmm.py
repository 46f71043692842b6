"""The pair-HMM of oracle.py (ObservationModelFBMaxErr) vectorised over
pairs and states with plain torch operations.

score_pairs(pairs, params, device, dtype) returns one MLAlignment per
(haplotype, read, hap_start), as oracle.pair_hmm_single does: the same
recursions, candidates in the same order for every destination state,
the same EPS / near-tie rule, the same state numbering (s = i*numS + x,
numS = H + 2) wherever it decides a tie, and every sum associated as the
oracle writes it.  In float64 the result is the oracle's, bit for bit
(benchmark/tests checks it); `dtype` lower than float64 runs the same
recursions in that type (the precision control).

Layout: per pair, the non-insertion and insertion planes (P, X), X =
max H + 2; column x is the oracle's x (0 = LO, 1..H hap bases, H+1 =
RO), columns past a pair's RO are padding that no valid state reads."""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from .model import MLAlignment
from .oracle import (EPS, TIE, _report_variants, _Trans, compute_b_mid,
                     compute_b_mid_prior)

NEG = -math.inf


def _upd(dv, bt, val, idx, mask=None):
    """updateMax on every state at once: replace on val > dv + EPS, or on
    a near tie (dv <= val <= dv + TIE) with a lower state index."""
    up = (val > dv + EPS) | ((val >= dv) & (val <= dv + TIE) & (bt > idx))
    if mask is not None:
        up = up & mask
    return torch.where(up, val, dv), torch.where(up, idx, bt)


def _g(t, idx):
    """t[p, idx[p, ...]] for a (P, X) table and (P, K) indices."""
    return torch.gather(t, 1, idx)


class _Block:
    """The host-side tables of a block of pairs, on the device."""

    def __init__(self, pairs, params, device, dtype):
        P = len(pairs)
        Hs = np.array([len(h.seq) for h, _, _ in pairs])
        Ls = np.array([r.size() for _, r, _ in pairs])
        X = int(Hs.max()) + 2
        Lm = int(Ls.max())
        self.P, self.X, self.Lm = P, X, Lm
        lpe = np.zeros((P, X + 1))
        lpn = np.zeros((P, X + 1))
        pri_r = np.full((P, 2, X), NEG)
        pri_h = np.full((P, 2, X), NEG)
        eq = np.zeros((P, Lm))
        uq = np.zeros((P, Lm))
        hap = np.zeros((P, X), np.uint8)
        rd = np.full((P, Lm), 255, np.uint8)
        bmid = np.zeros(P, np.int64)
        trs = {}
        qlog = {}
        p_mut = params.p_mut
        for p, (h, r, start) in enumerate(pairs):
            H, L = Hs[p], Ls[p]
            if params.max_length_del > H:
                raise ValueError("hapSize error.")
            if params.force_read_on_haplotype:
                raise ValueError("force_read_on_haplotype is not modelled")
            tr = trs.get(h.seq)
            if tr is None:
                tr = trs[h.seq] = _Trans(params, h.seq)
            lpe[p, :H + 2] = tr.lpe
            lpn[p, :H + 2] = tr.lpn
            b = compute_b_mid(r, start, H, params.b_mid)
            bmid[p] = b
            for pri, mq in ((pri_r, r.map_qual), (pri_h, 1.0 - 1e-10)):
                v = compute_b_mid_prior(tr, r, start, H, params, mq, b)
                pri[p, 0, :H + 2] = v[:H + 2]
                pri[p, 1, :H + 2] = v[H + 2:]
            for j, q in enumerate(r.qual):
                e = qlog.get(q)
                if e is None:
                    pr = q * (1.0 - p_mut)
                    e = qlog[q] = (math.log(0.25 + 0.75 * pr),
                                   math.log(0.75 + 1e-10 - 0.75 * pr))
                eq[p, j], uq[p, j] = e
            hap[p, 1:H + 1] = np.frombuffer(h.seq.encode(), np.uint8)
            rd[p, :L] = np.frombuffer(r.seq.encode(), np.uint8)
        self.tr = next(iter(trs.values()))
        to = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        f = lambda a: to(a).to(dtype)  # noqa: E731
        self.H = to(Hs)
        self.L = to(Ls)
        self.RO = self.H + 1
        self.numS = self.H + 2
        self.bmid = to(bmid)
        self.lpe, self.lpn = f(lpe[:, :X]), f(lpn[:, :X])
        self.lpe_next = f(lpe[:, 1:X + 1])
        self.pri_r, self.pri_h = f(pri_r), f(pri_h)
        self.eq, self.uq = f(eq), f(uq)
        x = torch.arange(X, device=device)
        self.x = x.expand(P, X)
        H1 = self.H[:, None]
        hap_t = to(hap)
        rd_t = to(rd)
        # a hap base emits uq where it differs from the read base (and is
        # not N); LO, RO, padding and the insertion plane emit eq
        self.mism = ((hap_t[:, None, :] != rd_t[:, :, None])
                     & (hap_t[:, None, :] != ord("N"))
                     & (x >= 1) & (x <= H1)[:, None, :])
        self.ins_idx = self.numS[:, None] + self.x     # oracle's numS + x
        self.is_lo = self.x == 0
        self.is_ro = self.x == self.RO[:, None]
        self.is_hap = (self.x >= 1) & (self.x <= H1)
        self.RO_c = self.RO[:, None]
        self.H_c = H1
        self.dtype = dtype

    def obs(self, b):
        eq = self.eq[:, b, None]
        obs_n = torch.where(self.mism[:, b], self.uq[:, b, None], eq)
        return obs_n, eq.expand_as(obs_n)


def _forward(k: _Block, sn, si, b):
    """passMessageTwoDec: alpha[b] from alpha[b-1] (sn, si), obs[b-1]."""
    tr = k.tr
    on, oi = k.obs(b - 1)
    zero = torch.zeros_like(k.x)
    ro, hh = k.RO_c, k.H_c
    # RO (steps 1 and 4)
    dro = torch.full((k.P, 1), NEG, dtype=k.dtype, device=sn.device)
    bro = torch.zeros((k.P, 1), dtype=torch.long, device=sn.device)
    dro, bro = _upd(dro, bro, _g(on, ro) + _g(sn, ro) + tr.logpLOgLO
                    + tr.logpNoInsgNoIns, ro)
    dro, bro = _upd(dro, bro, _g(on, hh) + _g(sn, hh) + tr.logpFirstgLO
                    + tr.logpNoInsgNoIns, hh)
    dro, bro = _upd(dro, bro, _g(oi, ro) + _g(si, ro) + tr.logpLOgLO
                    + _g(k.lpe, ro), k.numS[:, None] + ro)
    dro, bro = _upd(dro, bro, _g(oi, hh) + _g(si, hh) + tr.logpFirstgLO
                    + _g(k.lpe, hh), k.numS[:, None] + hh)
    # hap bases (steps 2 and 5)
    dn = torch.full_like(sn, NEG)
    bn = zero
    for y in range(1, tr.numT):
        nx = torch.clamp(k.x - y, min=0)
        lp = k.lpn if y == 1 else k.lpe + (y - 1) * tr.logpInsgIns
        dn, bn = _upd(dn, bn, _g(on, nx) + lp + _g(sn, nx) + k.lpn, nx)
    px = torch.clamp(k.x - 1, min=0)
    dn, bn = _upd(dn, bn, _g(oi, px) + _g(si, px) + k.lpe,
                  k.numS[:, None] + px, k.x >= 1)
    # LO (step 3) and RO
    lo = on[:, :1] + sn[:, :1] + tr.logpNoInsgNoIns
    dn = torch.where(k.is_lo, lo, torch.where(k.is_ro, dro, dn))
    bn = torch.where(k.is_lo, zero, torch.where(k.is_ro, bro, bn))
    # insertion plane (steps 6 and 7)
    di = oi + si + tr.logpInsgIns
    bi = k.ins_idx
    di, bi = _upd(di, bi, on + sn + tr.logpNoInsgIns, k.x, k.x >= 1)
    return dn, di, bn, bi


def _backward(k: _Block, sn, si, b):
    """passMessageTwoInc: beta[b-1] from beta[b] (sn, si), obs[b]."""
    tr = k.tr
    on, oi = k.obs(b)
    zero = torch.zeros_like(k.x)
    ro = k.RO_c
    # LO (step 1)
    dlo = torch.full((k.P, 1), NEG, dtype=k.dtype, device=sn.device)
    blo = torch.zeros((k.P, 1), dtype=torch.long, device=sn.device)
    dlo, blo = _upd(dlo, blo, on[:, :1] + sn[:, :1] + tr.logpLOgLO
                    + tr.logpNoInsgNoIns, blo)
    dlo, blo = _upd(dlo, blo, on[:, 1:2] + sn[:, 1:2] + tr.logpFirstgLO
                    + tr.logpNoInsgNoIns, blo + 1)
    # hap bases (step 2)
    dn = torch.full_like(sn, NEG)
    bn = zero
    for y in range(1, tr.numT):
        nx = torch.minimum(k.x + y, ro)
        ln = _g(k.lpn, nx)
        lp = ln if y == 1 else _g(k.lpe, nx) + (y - 1) * tr.logpInsgIns
        dn, bn = _upd(dn, bn, lp + ln + _g(sn, nx) + _g(on, nx), nx)
    # RO (step 3)
    dro = torch.full((k.P, 1), NEG, dtype=k.dtype, device=sn.device)
    bro = torch.zeros((k.P, 1), dtype=torch.long, device=sn.device)
    dro, bro = _upd(dro, bro, _g(on, ro) + _g(sn, ro) + _g(k.lpn, ro), ro)
    dn = torch.where(k.is_lo, dlo, torch.where(k.is_ro, dro, dn))
    bn = torch.where(k.is_lo, blo, torch.where(k.is_ro, bro, bn))
    # insertion open (step 4): x <= H with lpe[x+1], RO without
    dn, bn = _upd(dn, bn, oi + si + k.lpe_next, k.ins_idx,
                  k.x <= k.H_c)
    dn, bn = _upd(dn, bn, oi + si, k.ins_idx, k.is_ro)
    # insertion plane (steps 5 and 6)
    di = oi + si + tr.logpInsgIns
    bi = k.ins_idx
    nx = torch.where(k.x == 0, zero, torch.minimum(k.x + 1, ro))
    di, bi = _upd(di, bi, _g(on, nx) + _g(sn, nx) + tr.logpNoInsgIns, nx)
    return dn, di, bn, bi


def _eps_argmax(v, valid):
    """The oracle's scan over states in order: the first state whose
    value exceeds the best so far by more than EPS.  v (P, S)."""
    P, S = v.shape
    best = torch.full((P,), NEG, dtype=v.dtype, device=v.device)
    arg = torch.zeros(P, dtype=torch.long, device=v.device)
    for s in range(S):
        up = (v[:, s] > best + EPS) & valid[:, s]
        best = torch.where(up, v[:, s], best)
        arg = torch.where(up, torch.full_like(arg, s), arg)
    return best, arg


def _score_block(pairs, params, device, dtype) -> List[MLAlignment]:
    k = _Block(pairs, params, device, dtype)
    P, X, Lm = k.P, k.X, k.Lm
    dev = torch.device(device)
    an = torch.zeros((P, X), dtype=dtype, device=dev)
    ai = torch.zeros_like(an)
    btf = torch.zeros((Lm, P, 2 * X), dtype=torch.int16, device=dev)
    for b in range(1, int(k.bmid.max()) + 1):
        act = (b <= k.bmid)[:, None]
        dn, di, bn, bi = _forward(k, an, ai, b)
        an = torch.where(act, dn, an)
        ai = torch.where(act, di, ai)
        btf[b] = torch.cat([bn, bi], 1).to(torch.int16)
    bn_ = torch.zeros_like(an)
    bi_ = torch.zeros_like(an)
    btb = torch.zeros((Lm, P, 2 * X), dtype=torch.int16, device=dev)
    for b in range(Lm - 1, 0, -1):
        act = ((b <= k.L - 1) & (b > k.bmid))[:, None]
        if not bool(act.any()):
            continue
        dn, di, bn, bi = _backward(k, bn_, bi_, b)
        bn_ = torch.where(act, dn, bn_)
        bi_ = torch.where(act, di, bi_)
        btb[b - 1] = torch.cat([bn, bi], 1).to(torch.int16)
    # the anchor slice, in the oracle's state order
    rows = torch.arange(P, device=dev)
    eq_mid = k.eq[rows, k.bmid][:, None]
    obs_mid_n = torch.where(k.mism[rows, k.bmid], k.uq[rows, k.bmid][:, None],
                            eq_mid)
    obs_mid_i = eq_mid.expand_as(obs_mid_n)
    S = 2 * X
    s = torch.arange(S, device=dev).expand(P, S)
    numS = k.numS[:, None]
    ins = s >= numS
    xs = torch.where(ins, s - numS, s)
    flat = torch.where(ins, X + xs, xs).clamp(max=S - 1)
    valid = s < 2 * numS
    base_n = an + obs_mid_n + bn_
    base_i = ai + obs_mid_i + bi_
    base = torch.cat([base_n, base_i], 1)
    pri_r = k.pri_r.reshape(P, S)
    pri_h = k.pri_h.reshape(P, S)
    v_r = _g(base + pri_r, flat)
    v_h = _g(base + pri_h, flat)
    ll, ms_r = _eps_argmax(v_r, valid)
    _, ms_h = _eps_argmax(v_h, valid)
    clean = torch.where(torch.isnan(v_r) | ~valid,
                        torch.full_like(v_r, NEG), v_r)
    is_off = (xs == 0)
    is_on = (xs != 0) & (xs != k.RO[:, None])
    ll_off = torch.where(is_off, clean, torch.full_like(clean, NEG)).amax(1)
    ll_on = torch.where(is_on, clean, torch.full_like(clean, NEG)).amax(1)
    # MAP backtrack from the anchor
    ms = torch.zeros((P, Lm), dtype=torch.long, device=dev)
    ms[rows, k.bmid] = ms_h

    def to_flat(st):
        i = st >= numS[:, 0]
        return torch.where(i, X + st - numS[:, 0], st)

    for b in range(int(k.bmid.max()), 0, -1):
        act = b <= k.bmid
        prev = btf[b, rows, to_flat(ms[:, b])].long()
        ms[:, b - 1] = torch.where(act, prev, ms[:, b - 1])
    for b in range(0, Lm - 1):
        act = (b >= k.bmid) & (b < k.L - 1)
        if not bool(act.any()):
            continue
        nxt = btb[b, rows, to_flat(ms[:, b])].long()
        ms[:, b + 1] = torch.where(act, nxt, ms[:, b + 1])
    ll = ll.double().cpu().numpy()
    ll_off = ll_off.double().cpu().numpy()
    ll_on = ll_on.double().cpu().numpy()
    ms_r = ms_r.cpu().numpy()
    ms = ms.cpu().numpy()
    Hs = k.H.cpu().numpy()
    bm = k.bmid.cpu().numpy()
    out = []
    for p, (h, r, _start) in enumerate(pairs):
        nS, RO = int(Hs[p]) + 2, int(Hs[p]) + 1
        ml = MLAlignment()
        ml.ll = float(ll[p])
        m = ms[p, :r.size()].astype(np.int32)
        ml.off_hap_hmq = (int(m[bm[p]]) % nS) in (0, RO)
        ml.off_hap = (int(ms_r[p]) % nS) in (0, RO)
        ml.ll_off = float(ll_off[p])
        ml.ll_on = float(ll_on[p])
        _report_variants(ml, m, h, r, params, nS, RO)
        out.append(ml)
    return out


def score_pairs(pairs, params, device="cpu", dtype=torch.float64,
                block_pairs: int = 4096) -> List[MLAlignment]:
    """One MLAlignment per (hap, read, hap_start), in order, computed in
    blocks of at most block_pairs pairs."""
    out: List[MLAlignment] = []
    for i in range(0, len(pairs), block_pairs):
        out.extend(_score_block(pairs[i:i + block_pairs], params, device,
                                dtype))
    return out
