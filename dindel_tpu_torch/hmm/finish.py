"""bMid-slice likelihood folds and MAP-state backtrack, plain PyTorch.

Counterpart of ``dindel_tpu.hmm.batch._finish`` with ``bt_codes=True``
(batch.py:249-380): it consumes the DP's nibble-packed class-code planes
and reconstructs each source index from (code, current state, hap_len)
along the MAP path only."""

from __future__ import annotations

import torch

from .reference import EPS


def finish(H_pad, L_pad, numT, b_mid, hap_len, alpha_mid, beta_mid, obs_mid,
           prior_rmq, prior_hmq, btf, btb, exact_ties=False):
    """Returns (ll, off_hap, off_hap_hmq, ll_off, ll_on, map_state).

    exact_ties=True is the reference's order-dependent EPS-guarded fold
    over all 2*(H_pad+2) states (ObservationModelFB.cpp:1096-1117), a
    sequential loop.  exact_ties=False is the parallel first-occurrence
    argmax (the fold's `v > ll + EPS` guard degenerates to a strict `>`
    whenever EPS is below one ulp of the running maximum, which holds in
    float32 for every realistic log-likelihood).

    Only btf rows b-1 with b <= b_mid and btb rows b >= b_mid are used on
    each pair's path inside its read; map_state beyond read_len is
    whatever the unwritten rows decode to, and consumers mask it."""
    dev, dt = alpha_mid.device, alpha_mid.dtype
    B = b_mid.shape[0]
    SP = H_pad + 2
    S = 2 * SP
    RO = H_pad + 1
    neginf = torch.tensor(-float("inf"), dtype=dt, device=dev)

    base = alpha_mid + obs_mid + beta_mid
    vr = base + prior_rmq
    vh = base + prior_hmq

    if not exact_ties:
        map_rmq = torch.argmax(vr, dim=1)
        ll = torch.amax(vr, dim=1)
        s_mid = torch.argmax(vh, dim=1)
        xm = torch.arange(S, device=dev) % SP
        is0 = (xm == 0)[None, :]
        isRO = (xm == RO)[None, :]
        ll_off = torch.amax(torch.where(is0, vr, neginf), dim=1)
        ll_on = torch.amax(torch.where(is0 | isRO, neginf, vr), dim=1)
    else:
        eps = torch.tensor(EPS, dtype=dt, device=dev)
        ll = neginf.expand(B)
        llH = neginf.expand(B)
        ll_off = neginf.expand(B)
        ll_on = neginf.expand(B)
        map_rmq = torch.zeros(B, dtype=torch.int64, device=dev)
        s_mid = torch.zeros(B, dtype=torch.int64, device=dev)
        for x in range(S):
            v = vr[:, x]
            w = vh[:, x]
            takeR = v > ll + eps
            ll = torch.where(takeR, v, ll)
            map_rmq = torch.where(takeR, x, map_rmq)
            takeH = w > llH + eps
            llH = torch.where(takeH, w, llH)
            s_mid = torch.where(takeH, x, s_mid)
            xm = x % SP
            if xm == 0:
                ll_off = torch.where(v > ll_off, v, ll_off)
            elif xm != RO:
                ll_on = torch.where(v > ll_on, v, ll_on)

    hl = hap_len.long()
    bm = b_mid.long()

    def code_at(bt_b, cur):
        x = cur % SP
        pack = torch.gather(bt_b, 1, x[:, None])[:, 0].long()
        c = torch.where(cur >= SP, pack >> 4, pack) & 15
        return x, c

    def decode_fwd(bt_b, cur):
        x, c = code_at(bt_b, cur)
        ins_nxt = torch.where(c == 0, cur, x)
        noins_int = torch.where(
            c == 0, SP + (x - 1).clamp(min=0),
            torch.where(c == 1, x, (x - (c - 1)).clamp(min=0)))
        noins_ro = torch.where(
            c == 0, SP + RO,
            torch.where(c == 1, SP + hl, torch.where(c == 2, RO, hl)))
        noins_nxt = torch.where(x == RO, noins_ro, noins_int)
        return torch.where(cur >= SP, ins_nxt, noins_nxt)

    def decode_bwd(bt_b, cur):
        x, c = code_at(bt_b, cur)
        x1 = torch.where(x + 1 <= hl, x + 1, RO)
        ins_nxt = torch.where(c == 0, cur, torch.where(c == 1, x, x1))
        xy = x + (numT - c)
        dely = torch.where(xy <= hl, xy, RO)
        noins_nxt = torch.where(c == 0, SP + x,
                                torch.where(c == numT, x, dely))
        return torch.where(cur >= SP, ins_nxt, noins_nxt)

    # down through btf: column j (< L_pad-1) is the state after
    # processing slice b = j+1; up through btb: column j (> 0) is the
    # state after processing slice b = j-1
    down = [None] * (L_pad - 1)
    cur = s_mid
    for b in range(L_pad - 1, 0, -1):
        cur = torch.where(b <= bm, decode_fwd(btf[b - 1], cur), cur)
        down[b - 1] = cur
    up = []
    cur = s_mid
    for b in range(0, L_pad - 1):
        cur = torch.where(b >= bm, decode_bwd(btb[b], cur), cur)
        up.append(cur)
    ms_down = torch.stack(down + [s_mid], dim=1)
    ms_up = torch.stack([s_mid] + up, dim=1)
    b_axis = torch.arange(L_pad, device=dev)[None, :]
    map_state = torch.where(b_axis < bm[:, None], ms_down,
                            torch.where(b_axis > bm[:, None], ms_up,
                                        s_mid[:, None]))

    off_hap_hmq = ((s_mid % SP) == 0) | ((s_mid % SP) == RO)
    off_hap = ((map_rmq % SP) == 0) | ((map_rmq % SP) == RO)
    return (ll, off_hap, off_hap_hmq, ll_off, ll_on,
            map_state.to(torch.int32))
