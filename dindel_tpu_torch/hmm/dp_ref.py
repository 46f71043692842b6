"""Plain PyTorch version of the pair-HMM DP recursions.

The same contract as ``dindel_tpu.hmm.pallas_kernel.dp_pallas``: returns
``(alpha_mid, beta_mid, btf, btb)`` with ``btf``/``btb`` as
``(L_pad-1, B, S_half)`` uint8 planes of nibble-packed transition-class
codes (lo nibble = noins dest, hi nibble = ins dest; decode tables in
``expand_bt_codes``).  It is the reference the CUDA kernel
(csrc/pair_hmm_dp.cu) is held to bit for bit, and the path
hmm/dp_kernel.py takes for tensors on the CPU.

Written as a Python loop over read bases with whole-tensor ops on
(B, S_half).  Numerics follow the Pallas kernel exactly:

- candidate fold order and rank codes in both fold modes: exact_ties is
  the EPS/TIE band rule in reference candidate order (``_fold_exact``);
  fast mode folds in ASCENDING rank with a value-only ``>=``
  (``_fold_ge``), the NEGBIG filler included;
- constant association: the Pallas kernel bakes the scalars as Python
  floats, so in float32 the sums ``logpLOgLO + logpNoInsgNoIns`` and
  ``logpFirstgLO + logpNoInsgNoIns`` are formed in float64 and rounded
  once (``W + (a + b)``), while ``WiRO + logpLOgLO + lpeRO`` is
  evaluated left to right.  float64 is the oracle-parity configuration
  (the JAX package runs it through its XLA DP, bit-equal to the
  reference C++): there those two sums associate left to right too,
  ``(W + a) + b``, as in ObservationModelFB.cpp;
- anchor bounds: the forward (Dec) pass runs b = 1..MB and the backward
  (Inc) pass from L_act-1 down to MN+1; btf rows >= MB and btb rows < MN
  are never written (they stay 0 here, uninitialised in the kernel) and
  the finish never consumes them."""

from __future__ import annotations

import numpy as np
import torch

from .reference import EPS, TIE

NEGBIG = -1.0e30
NCODE = ord("N")


def dp_bounds(read_len: np.ndarray, b_mid: np.ndarray, L_pad: int):
    """Anchor-bounded pass extents (L_act, MB, MN) from host arrays: the
    Dec recursion runs to max(b_mid), the Inc recursion down to
    min(b_mid), over L_act = max(read_len) read bases
    (ObservationModelFB.cpp:1047-1062; pallas_kernel.py:128-140)."""
    L_act = max(2, min(int(np.max(read_len)), L_pad))
    bm = np.asarray(b_mid)
    MB = max(0, min(int(bm.max()), L_act - 1))
    MN = max(0, min(int(bm.min()), L_act - 1))
    return L_act, MB, MN


def check_dp_args(H_pad, L_pad, numT, hap_len, read_len, b_mid, read_codes,
                  hap_codes, eq, uq, lpe, lpn):
    """Shape/type checks shared by the plain version and the kernel."""
    if numT > 15:
        raise ValueError("the DP stores 4-bit backpointer class codes; "
                         "numT = maxLengthDel + 2 must be <= 15 "
                         f"(got {numT})")
    B = hap_len.shape[0]
    SP = H_pad + 2
    want = {"read_len": (read_len, (B,)), "b_mid": (b_mid, (B,)),
            "read_codes": (read_codes, (B, L_pad)),
            "hap_codes": (hap_codes, (B, H_pad)),
            "eq": (eq, (B, L_pad)), "uq": (uq, (B, L_pad)),
            "lpe": (lpe, (B, SP)), "lpn": (lpn, (B, SP))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {shape}")
    dt = eq.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"DP dtype must be float32 or float64, got {dt}")
    for name, t in (("uq", uq), ("lpe", lpe), ("lpn", lpn)):
        if t.dtype != dt:
            raise TypeError(f"{name}: dtype {t.dtype}, want {dt}")
    devs = {t.device for t in (hap_len, read_len, b_mid, read_codes,
                               hap_codes, eq, uq, lpe, lpn)}
    if len(devs) != 1:
        raise ValueError(f"DP inputs on several devices: {devs}")


class _Consts:
    """The kernel's constants as 0-dim tensors of the working type (each
    rounded once from its float64 value, as a Python-float constant is
    in the Pallas kernel); `ltr` selects the float64 association."""

    def __init__(self, scalars, numT, dt, dev):
        lolo, first, lpig, nig, nn = (float(x) for x in np.asarray(scalars))
        t = lambda v: torch.tensor(v, dtype=dt, device=dev)  # noqa: E731
        self.lolo, self.first, self.lpig = t(lolo), t(first), t(lpig)
        self.nig, self.nn = t(nig), t(nn)
        self.lolo_nn = t(lolo + nn)
        self.first_nn = t(first + nn)
        self.ltr = dt == torch.float64
        self.ky = [None, None] + [t((y - 1) * lpig) for y in range(2, numT)]
        self.eps, self.tie, self.negbig = t(EPS), t(TIE), t(NEGBIG)


def _lolo_nn(k, W):
    """W + logpLOgLO + logpNoInsgNoIns: left to right in float64 (the
    oracle's order), one baked constant in float32 (the TPU kernel's)."""
    return (W + k.lolo) + k.nn if k.ltr else W + k.lolo_nn


def _first_nn(k, W):
    """W + logpFirstgLO + logpNoInsgNoIns, associated as _lolo_nn."""
    return (W + k.first) + k.nn if k.ltr else W + k.first_nn


def _fold_exact(k, dv, dc, cv, cc):
    """updateMax on (value, class rank); ranks descend with the source
    index, so the tie-to-lower-index rule is `cand_c > dest_c`."""
    cc = torch.as_tensor(cc, dtype=torch.int32, device=dv.device)
    take = (cv > dv + k.eps) | ((cv >= dv) & (cv <= dv + k.tie) & (cc > dc))
    return torch.where(take, cv, dv), torch.where(take, cc, dc)


def _fold_ge(k, dv, dc, cv, cc):
    """Fast fold: candidates come in ascending rank, so `>=` keeps the
    higher rank on exact ties."""
    cc = torch.as_tensor(cc, dtype=torch.int32, device=dv.device)
    take = cv >= dv
    return torch.where(take, cv, dv), torch.where(take, cc, dc)


def _roll_right(x, y, fill):
    """out[:, l] = x[:, l-y] for l >= y else fill (B, 1)."""
    return torch.cat([fill.expand(-1, y), x[:, :x.shape[1] - y]], dim=1)


def _roll_left(x, y):
    """out[:, l] = x[:, l+y], wrapped (callers mask the tail)."""
    return torch.roll(x, -y, dims=1)


def dp_ref(H_pad, L_pad, numT, hap_len, read_len, b_mid, read_codes,
           hap_codes, eq, uq, lpe, lpn, scalars, exact_ties=False,
           bounds=None):
    """Plain DP.  hap_len/read_len/b_mid (B,) int; read_codes (B, L_pad)
    and hap_codes (B, H_pad) byte codes; eq/uq (B, L_pad), lpe/lpn
    (B, S_half) float; scalars the pk's 5-vector.  `bounds` is
    (L_act, MB, MN) from dp_bounds (computed here when None)."""
    check_dp_args(H_pad, L_pad, numT, hap_len, read_len, b_mid, read_codes,
                  hap_codes, eq, uq, lpe, lpn)
    if bounds is None:
        bounds = dp_bounds(read_len.cpu().numpy(), b_mid.cpu().numpy(),
                           L_pad)
    L_act, MB, MN = bounds
    dev, dt = eq.device, eq.dtype
    B = hap_len.shape[0]
    SP = H_pad + 2
    RO = H_pad + 1
    k = _Consts(scalars, numT, dt, dev)
    fold = _fold_exact if exact_ties else _fold_ge
    i32 = lambda v: torch.full((B, 1), v, dtype=torch.int32,  # noqa: E731
                               device=dev)

    lane = torch.arange(SP, device=dev)[None, :]
    hl = hap_len.long()[:, None]
    bm = b_mid.long()[:, None]
    rlen = read_len.long()[:, None]
    live = (lane <= hl) | (lane == RO)
    is0 = lane == 0
    isRO = lane == RO
    on_hap = (lane >= 1) & (lane <= hl)
    open_ok = lane >= 1
    # hap base code at lane x is hap_codes[x-1]; N at lanes 0 and RO
    hapat = torch.full((B, SP), NCODE, dtype=torch.uint8, device=dev)
    hapat[:, 1:RO] = hap_codes
    read_codes = read_codes.to(torch.uint8)
    negbig = k.negbig.expand(B, SP)

    lpeH = torch.gather(lpe, 1, hl)
    lpeRO = lpe[:, RO:RO + 1]
    lpnRO = lpn[:, RO:RO + 1]
    dec_lp = [None, lpn] + [lpe + k.ky[y] for y in range(2, numT)]
    inc_cost = [None]
    for y in range(1, numT):
        clamped = (lane + y) <= hl
        s_lpe = torch.where(clamped, _roll_left(lpe, y), lpeRO)
        s_lpn = torch.where(clamped, _roll_left(lpn, y), lpnRO)
        lp = s_lpn if y == 1 else s_lpe + k.ky[y]
        inc_cost.append(lp + s_lpn)
    clamped1 = (lane + 1) <= hl
    lpe_x1 = torch.where(isRO, torch.zeros((), dtype=dt, device=dev),
                         _roll_left(lpe, 1))

    def obs(b):
        rb = read_codes[:, b:b + 1]
        e = eq[:, b:b + 1]
        mism = (hapat != rb) & (hapat != NCODE)
        return torch.where(on_hap & mism, uq[:, b:b + 1], e), e

    amid = torch.zeros((B, 2 * SP), dtype=dt, device=dev)
    bmid = torch.zeros((B, 2 * SP), dtype=dt, device=dev)
    btf = torch.zeros((L_pad - 1, B, SP), dtype=torch.uint8, device=dev)
    btb = torch.zeros((L_pad - 1, B, SP), dtype=torch.uint8, device=dev)

    # ---------------- forward (Dec) pass ----------------
    an = torch.zeros((B, SP), dtype=dt, device=dev)
    ai = torch.zeros((B, SP), dtype=dt, device=dev)
    for b in range(1, MB + 1):
        obs_n, e = obs(b - 1)
        Wn = an + obs_n
        Wi = ai + e
        Wn0 = Wn[:, 0:1]
        WnRO = Wn[:, RO:RO + 1]
        WiRO = Wi[:, RO:RO + 1]
        WnH = torch.gather(Wn, 1, hl)
        WiH = torch.gather(Wi, 1, hl)
        srcWi = _roll_right(Wi, 1, Wi[:, 0:1])
        if exact_ties:
            # RO ranks (descending src index): ins RO(0) > ins hl(1) >
            # noins RO(2) > noins hl(3); interior: ins exit x-1(0) >
            # self x(1) > del src x-y(1+y)
            dRO_v, dRO_c = _lolo_nn(k, WnRO), i32(2)
            dRO_v, dRO_c = fold(k, dRO_v, dRO_c, _first_nn(k, WnH), 3)
            dx_v, dx_c = negbig, i32(1).expand(B, SP)
            for y in range(1, numT):
                src = _roll_right(Wn, y, Wn0)
                dx_v, dx_c = fold(k, dx_v, dx_c, (src + dec_lp[y]) + lpn,
                                  1 + y)
            dRO_v, dRO_c = fold(k, dRO_v, dRO_c, (WiRO + k.lolo) + lpeRO, 0)
            dRO_v, dRO_c = fold(k, dRO_v, dRO_c, (WiH + k.first) + lpeH, 1)
            dx_v, dx_c = fold(k, dx_v, dx_c, srcWi + lpe, 0)
        else:
            dRO_v, dRO_c = (WiRO + k.lolo) + lpeRO, i32(0)
            dRO_v, dRO_c = fold(k, dRO_v, dRO_c, (WiH + k.first) + lpeH, 1)
            dRO_v, dRO_c = fold(k, dRO_v, dRO_c, _lolo_nn(k, WnRO), 2)
            dRO_v, dRO_c = fold(k, dRO_v, dRO_c, _first_nn(k, WnH), 3)
            # ins exit (0), the NEGBIG self filler (1), del/match 2..numT
            dx_v, dx_c = srcWi + lpe, i32(0).expand(B, SP)
            dx_v, dx_c = fold(k, dx_v, dx_c, negbig, 1)
            for y in range(1, numT):
                src = _roll_right(Wn, y, Wn0)
                dx_v, dx_c = fold(k, dx_v, dx_c, (src + dec_lp[y]) + lpn,
                                  1 + y)
        d0_v = Wn0 + k.nn
        # insertion lanes: extension (0) then open from noins x (1)
        di_v, di_c = Wi + k.lpig, i32(0).expand(B, SP)
        di_v, di_c = fold(k, di_v, di_c,
                          torch.where(open_ok, Wn + k.nig, negbig),
                          open_ok.to(torch.int32))

        noins_v = torch.where(is0, d0_v, torch.where(isRO, dRO_v, dx_v))
        noins_c = torch.where(is0, 1, torch.where(isRO, dRO_c, dx_c))
        an = torch.where(live, noins_v, negbig)
        ai = torch.where(live, di_v, negbig)
        noins_c = torch.where(live, noins_c, 1)
        ins_c = torch.where(live, di_c, 0)
        sel = bm == b
        amid[:, :SP] = torch.where(sel, an, amid[:, :SP])
        amid[:, SP:] = torch.where(sel, ai, amid[:, SP:])
        btf[b - 1] = (noins_c + ins_c * 16).to(torch.uint8)

    # ---------------- backward (Inc) pass ----------------
    an = torch.zeros((B, SP), dtype=dt, device=dev)
    ai = torch.zeros((B, SP), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    for b in range(L_act - 1, MN, -1):
        obs_n, e = obs(b)
        Wn = an + obs_n
        Wi = ai + e
        WnRO = Wn[:, RO:RO + 1]
        Wn0 = Wn[:, 0:1]
        Wn1 = Wn[:, 1:2]
        cand = Wi + lpe_x1
        if exact_ties:
            # noins ranks (descending src index): ins x(0) > del src
            # clamp(x+y)(numT-y) > self x(numT)
            d0_v, d0_c = _lolo_nn(k, Wn0), i32(numT)
            d0_v, d0_c = fold(k, d0_v, d0_c, _first_nn(k, Wn1), numT - 1)
            dx_v, dx_c = negbig, i32(numT).expand(B, SP)
            for y in range(1, numT):
                srcW = torch.where((lane + y) <= hl, _roll_left(Wn, y), WnRO)
                dx_v, dx_c = fold(k, dx_v, dx_c, inc_cost[y] + srcW,
                                  numT - y)
            dRO_v, dRO_c = WnRO + lpnRO, i32(numT)
            dx_v, dx_c = fold(k, dx_v, dx_c, cand, 0)
            d0_v, d0_c = fold(k, d0_v, d0_c, cand[:, 0:1], 0)
            dRO_v, dRO_c = fold(k, dRO_v, dRO_c, cand[:, RO:RO + 1], 0)
        else:
            # ascending rank: ins (0), del y descending (numT-y), then
            # the NEGBIG self filler (numT)
            dx_v, dx_c = cand, i32(0).expand(B, SP)
            for y in range(numT - 1, 0, -1):
                srcW = torch.where((lane + y) <= hl, _roll_left(Wn, y), WnRO)
                dx_v, dx_c = fold(k, dx_v, dx_c, inc_cost[y] + srcW,
                                  numT - y)
            dx_v, dx_c = fold(k, dx_v, dx_c, negbig, numT)
            d0_v, d0_c = cand[:, 0:1], i32(0)
            d0_v, d0_c = fold(k, d0_v, d0_c, _first_nn(k, Wn1), numT - 1)
            d0_v, d0_c = fold(k, d0_v, d0_c, _lolo_nn(k, Wn0), numT)
            dRO_v, dRO_c = cand[:, RO:RO + 1], i32(0)
            dRO_v, dRO_c = fold(k, dRO_v, dRO_c, WnRO + lpnRO, numT)
        # insertion lanes: extension (0), then exit to noins 0 at lane 0
        # (1) or to noins clamp(x+1) (2)
        di_v, di_c = Wi + k.lpig, i32(0).expand(B, SP)
        srcW1 = torch.where(clamped1, _roll_left(Wn, 1), WnRO)
        cand_v = torch.where(is0, Wn0, srcW1) + k.nig
        cand_c = torch.where(is0, 1, 2).to(torch.int32)
        di_v, di_c = fold(k, di_v, di_c, cand_v, cand_c)

        noins_v = torch.where(is0, d0_v, torch.where(isRO, dRO_v, dx_v))
        noins_c = torch.where(is0, d0_c, torch.where(isRO, dRO_c, dx_c))
        noins_v = torch.where(live, noins_v, negbig)
        noins_c = torch.where(live, noins_c, numT)
        ins_v = torch.where(live, di_v, negbig)
        ins_c = torch.where(live, di_c, 0)
        # padded-slice rule: beta[b-1] = 0 when b-1 >= read_len-1
        pad = (b - 1) >= (rlen - 1)
        an = torch.where(pad, zero, noins_v)
        ai = torch.where(pad, zero, ins_v)
        noins_c = torch.where(pad, numT, noins_c)
        ins_c = torch.where(pad, 0, ins_c)
        sel = bm == (b - 1)
        bmid[:, :SP] = torch.where(sel, an, bmid[:, :SP])
        bmid[:, SP:] = torch.where(sel, ai, bmid[:, SP:])
        btb[b - 1] = (noins_c + ins_c * 16).to(torch.uint8)
    return amid, bmid, btf, btb


def expand_bt_codes(btf, btb, hap_len, H_pad, numT):
    """Expansion of nibble-packed backpointer class codes into full
    source-state index planes, (L, B, 2*S_half) int32 — the format of the
    JAX package's XLA DP.  For differential tests; the finish decodes
    along the MAP path only.  Torch version of
    ``pallas_kernel.expand_bt_codes`` (pallas_kernel.py:625).

    Forward (Dec) codes, at dest lane x:
      noins interior: 0 -> ins x-1, 1 -> self, 1+y -> noins max(x-y, 0)
      noins RO:       0 -> ins RO, 1 -> ins hl, 2 -> noins RO, 3 -> noins hl
      ins:            0 -> ins x (extend), 1 -> noins x (open)
    Backward (Inc) codes:
      noins: 0 -> ins x, numT -> self, c -> noins clamp(x + (numT-c))
      ins:   0 -> ins x, 1 -> noins 0 (lane 0 only), 2 -> noins clamp(x+1)
    where clamp(v) = v if v <= hap_len else RO."""
    btf = btf.long()
    btb = btb.long()
    hl = hap_len.long().to(btf.device)[None, :, None]
    SP = H_pad + 2
    RO = H_pad + 1
    x = torch.arange(SP, device=btf.device)[None, None, :]
    w = torch.where

    def fwd(codes):
        cn = codes & 15
        ci = (codes >> 4) & 15
        noins_int = w(cn == 0, SP + (x - 1).clamp(min=0),
                      w(cn == 1, x, (x - (cn - 1)).clamp(min=0)))
        noins_ro = w(cn == 0, SP + RO,
                     w(cn == 1, SP + hl, w(cn == 2, RO, hl)))
        noins = w(x == RO, noins_ro, noins_int)
        ins = w(ci == 0, SP + x, x)
        return torch.cat([noins, ins], dim=2).to(torch.int32)

    def bwd(codes):
        cn = codes & 15
        ci = (codes >> 4) & 15
        xy = x + (numT - cn)
        dely = w(xy <= hl, xy, RO)
        noins = w(cn == 0, SP + x, w(cn == numT, x, dely))
        x1 = w(x + 1 <= hl, x + 1, RO)
        ins = w(ci == 0, SP + x, w(ci == 1, x, x1))
        return torch.cat([noins, ins], dim=2).to(torch.int32)

    return fwd(btf), bwd(btb)
