"""Host packing of (haplotype, read) pairs into slab tables.

JAX-free counterpart of the packing half of ``dindel_tpu/hmm/batch.py``
(``_round_up`` :50, ``compute_obs_mid`` :383, ``pack_pairs_compact``
:463, ``merge_compact`` :584, ``pad_compact`` :609,
``expand_compact_host`` :1018, ``pack_pairs`` :1155).  The numpy code is the
same; tests/test_torch_host.py and tests/test_torch_dense.py hold every
output byte-equal to the original.  ``tables_to_device`` is new: it
turns the numpy slab tables into tensors on an explicit device, which is
all the state the slab program consumes (the system has no weights).

Compact form: each per-read and per-hap table is shipped once, plus
per-pair index vectors (hap_idx, read_idx); the slab program expands
them on the device with gathers (hmm/expand.py).  The insert-size
positional prior needs per-pair tables; ``pack_pairs_compact`` returns
None there and the caller packs the dense per-pair form with
``pack_pairs`` (hmm/slab.py ``run_packed``)."""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from ..config import ObservationModelParameters
from ..model import Haplotype, Read
from .dp_ref import NEGBIG
from .reference import _Trans, hp_log_prob_error


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def compute_obs_mid(pk: dict) -> np.ndarray:
    """Observation potentials at each pair's bMid slice, host-side
    (setupReadObservationPotentials at one slice)."""
    B = pk["hap_len"].shape[0]
    H_pad = pk["H_pad"]
    S_half = H_pad + 2
    bm = pk["b_mid"]
    rows = np.arange(B)
    e = pk["eq"][rows, bm][:, None]
    u = pk["uq"][rows, bm][:, None]
    rb = pk["read_codes"][rows, bm][:, None]
    mismatch = (pk["hap_codes"] != rb) & (pk["hap_codes"] != ord("N"))
    on = np.where(mismatch, u, e)
    noins = np.concatenate([e, on, e * np.ones((B, 1))], axis=1)
    ins = np.broadcast_to(e, (B, S_half))
    return np.concatenate([noins, ins], axis=1).astype(pk["eq"].dtype)


def pack_pairs(haps: List[Haplotype], reads: List[Read], hap_start: int,
               p: ObservationModelParameters, dtype=np.float64,
               bucket: int = 16, H_pad: int = None, L_pad: int = None) -> dict:
    """Pack a window's (haps x reads) pairs into the dense per-pair
    arrays the DP consumes (insert-size ``pinsert`` prior rows included).
    Vectorized: per-read and per-hap arrays computed once, broadcast over
    the cross product."""
    nh, nr = len(haps), len(reads)
    H_max = max(h.size() for h in haps)
    L_max = max(r.size() for r in reads)
    if H_pad is None:
        H_pad = _round_up(H_max, bucket)
    if L_pad is None:
        L_pad = _round_up(max(L_max, 2), bucket)
    numT = p.max_length_del + 2
    S_half = H_pad + 2
    S = 2 * S_half
    B = nh * nr
    dt = dtype

    # ---- per-read arrays (computed once, tiled over haps) ----
    read_len_r = np.fromiter((r.size() for r in reads), np.int32, nr)
    read_codes_r = np.zeros((nr, L_pad), np.uint8)
    qual_r = np.zeros((nr, L_pad), np.float64)
    for ri, r in enumerate(reads):
        L = read_len_r[ri]
        read_codes_r[ri, :L] = np.frombuffer(r.seq.encode(), np.uint8)
        qual_r[ri, :L] = r.qual
    col = np.arange(L_pad)[None, :]
    in_read = col < read_len_r[:, None]
    pr = qual_r * (1.0 - p.p_mut)
    eq_r = np.where(in_read, np.log(0.25 + 0.75 * pr), 0.0).astype(dt)
    uq_r = np.where(in_read, np.log(0.75 + 1e-10 - 0.75 * pr), 0.0).astype(dt)
    map_qual_r = np.fromiter((r.map_qual for r in reads), np.float64, nr)
    unmapped_r = np.fromiter((r.is_unmapped for r in reads), bool, nr)
    psf_r = np.fromiter((read.pos_stat_first for read in reads),
                        np.float64, nr)

    # vectorized compute_b_mid (ObservationModelFB.cpp:50-99): truncation
    # toward zero matches C++ int casts for the non-negative coordinates
    def b_mid_vec(Hh: int) -> np.ndarray:
        m = psf_r.astype(np.int64)
        read_end = m + read_len_r - 1
        hap_end = hap_start + Hh
        half = read_len_r // 2
        ol_start = np.maximum(hap_start, m)
        ol_end = np.where(hap_end > read_end, read_end, hap_end)
        mid = (ol_end - ol_start) // 2 + ol_start
        bm = np.where(unmapped_r | (m > hap_end) | (read_end < hap_start),
                      half, mid - m)
        if p.b_mid != -1:
            bm = np.full_like(bm, p.b_mid)
        return np.clip(bm, 0, read_len_r - 1).astype(np.int32)

    # vectorized computeBMidPrior (ObservationModelFB.cpp:268-305) over
    # reads, for one haplotype length Hh.  pinsert handling (the
    # insert-size positional prior for unmapped-mate realignment) is a
    # per-read fallback — rare, library mode only.
    tr_dummy = _Trans(p, haps[0].seq)
    log_ins1 = tr_dummy.logpInsgNoIns
    log_ins0 = math.log(1.0 - math.exp(tr_dummy.logpInsgNoIns))

    def prior_vec(Hh: int, bm: np.ndarray, map_qual: np.ndarray
                  ) -> np.ndarray:
        mq = 1.0 - map_qual
        capped = -10.0 * np.log10(mq) > p.map_qual_threshold
        mq = np.where(capped, 10.0 ** (-p.map_qual_threshold / 10.0), mq)
        log_off = np.log(mq)[:, None]
        log_on = np.log(1.0 - mq)[:, None]
        numS = Hh + 2
        out = np.zeros((nr, 2 * numS))
        need_pinsert = (p.map_unmapped_reads and
                        any(r.is_paired and not r.mate_is_unmapped
                            and r.mate_len != -1 and r.same_tid_as_mate
                            for r in reads))
        pins = np.zeros((nr, numS))
        if need_pinsert:
            x = np.arange(1, Hh + 1)
            for ri, r in enumerate(reads):
                if (r.is_paired and not r.mate_is_unmapped
                        and r.mate_len != -1 and r.same_tid_as_mate):
                    lib = r.get_library()
                    if r.mate_is_reverse:
                        d = np.abs(hap_start + x - bm[ri]
                                   - (r.mate_pos + r.mate_len))
                    else:
                        d = np.abs(hap_start + x + r.size() - bm[ri]
                                   - r.mate_pos)
                    pins[ri, 1:Hh + 1] = np.log(lib.get_prob_vec(d))
                    pins[ri, 0] = math.log(lib.ninetyfifth_pct_prob)
        for i, log_ins in enumerate((log_ins0, log_ins1)):
            blk = out[:, i * numS:(i + 1) * numS]
            blk[:, 0] = log_off[:, 0] + log_ins + pins[:, 0]
            blk[:, 1:Hh + 1] = pins[:, 1:Hh + 1] + log_on + log_ins
            blk[:, Hh + 1] = -100.0
        return out

    # ---- per-hap arrays, broadcast into the (hap-major) pair blocks ----
    hap_len = np.zeros(B, np.int32)
    read_len = np.tile(read_len_r, nh)
    b_mid = np.zeros(B, np.int32)
    read_codes = np.tile(read_codes_r, (nh, 1))
    hap_codes = np.zeros((B, H_pad), np.uint8)
    eq = np.tile(eq_r, (nh, 1))
    uq = np.tile(uq_r, (nh, 1))
    lpe = np.full((B, S_half), math.log(1e-5), dt)
    lpn = np.full((B, S_half), math.log(1 - 1e-5), dt)
    lpeV = np.zeros((B, S_half + numT), dt)
    lpnV = np.zeros((B, S_half + numT), dt)
    prior_rmq = np.full((B, S), NEGBIG, dt)
    prior_hmq = np.full((B, S), NEGBIG, dt)
    hmq_r = np.full(nr, 1.0 - 1e-10)

    for hi, hap in enumerate(haps):
        Hh = hap.size()
        if p.max_length_del > Hh:
            raise ValueError("hapSize error.")
        sl = slice(hi * nr, (hi + 1) * nr)
        hap_len[sl] = Hh
        hseq = np.frombuffer(hap.seq.encode(), np.uint8)
        hap_codes[sl, :Hh] = hseq[None, :]
        e_, n_ = hp_log_prob_error(hap.seq)
        lpe[sl, :Hh + 2] = np.asarray(e_, dt)[None, :]
        lpn[sl, :Hh + 2] = np.asarray(n_, dt)[None, :]
        ROi = Hh + 1
        if ROi != H_pad + 1:
            lpe[sl, H_pad + 1] = lpe[hi * nr, ROi]
            lpn[sl, H_pad + 1] = lpn[hi * nr, ROi]
        # V-arrays: per-hap constant rows
        core_e = np.full(S_half + numT, e_[ROi])
        core_n = np.full(S_half + numT, n_[ROi])
        core_e[:Hh + 1] = e_[:Hh + 1]
        core_n[:Hh + 1] = n_[:Hh + 1]
        lpeV[sl] = core_e[None, :]
        lpnV[sl] = core_n[None, :]
        bm = b_mid_vec(Hh)
        b_mid[sl] = bm
        pr_r = prior_vec(Hh, bm, map_qual_r)
        pr_h = prior_vec(Hh, bm, hmq_r)
        # _expand_prior, vectorized: per-half [0..Hh] block + RO slot
        numS = Hh + 2
        for half in range(2):
            prior_rmq[sl, half * S_half:half * S_half + Hh + 1] = (
                pr_r[:, half * numS:half * numS + Hh + 1])
            prior_rmq[sl, half * S_half + H_pad + 1] = (
                pr_r[:, half * numS + Hh + 1])
            prior_hmq[sl, half * S_half:half * S_half + Hh + 1] = (
                pr_h[:, half * numS:half * numS + Hh + 1])
            prior_hmq[sl, half * S_half + H_pad + 1] = (
                pr_h[:, half * numS + Hh + 1])

    scalars = np.array([math.log(1.0 - p.p_first_g_lo),
                        math.log(p.p_first_g_lo),
                        -0.5,
                        math.log(1.0 - math.exp(-0.5)),
                        math.log(1.0 - p.p_error)], dt)
    return dict(H_pad=H_pad, L_pad=L_pad, numT=numT, nh=nh, nr=nr,
                hap_len=hap_len, read_len=read_len, b_mid=b_mid,
                read_codes=read_codes, hap_codes=hap_codes, eq=eq, uq=uq,
                lpe=lpe, lpn=lpn, lpeV=lpeV, lpnV=lpnV,
                prior_rmq=prior_rmq, prior_hmq=prior_hmq, scalars=scalars)


def pack_pairs_compact(haps: List[Haplotype], reads: List[Read],
                       hap_start: int, p: ObservationModelParameters,
                       dtype=np.float64, bucket: int = 16,
                       H_pad: int = None, L_pad: int = None):
    if p.map_unmapped_reads and any(
            r.is_paired and not r.mate_is_unmapped and r.mate_len != -1
            and r.same_tid_as_mate for r in reads):
        return None
    nh, nr = len(haps), len(reads)
    H_max = max(h.size() for h in haps)
    L_max = max(r.size() for r in reads)
    if H_pad is None:
        H_pad = _round_up(H_max, bucket)
    if L_pad is None:
        L_pad = _round_up(max(L_max, 2), bucket)
    numT = p.max_length_del + 2
    S_half = H_pad + 2

    # per-read tables
    read_len_r = np.fromiter((r.size() for r in reads), np.int32, nr)
    read_codes_r = np.zeros((nr, L_pad), np.uint8)
    qual_r = np.zeros((nr, L_pad), np.float64)
    for ri, r in enumerate(reads):
        L = read_len_r[ri]
        read_codes_r[ri, :L] = np.frombuffer(r.seq.encode(), np.uint8)
        qual_r[ri, :L] = r.qual
    col = np.arange(L_pad)[None, :]
    in_read = col < read_len_r[:, None]
    pr = qual_r * (1.0 - p.p_mut)
    eq_r = np.where(in_read, np.log(0.25 + 0.75 * pr), 0.0).astype(dtype)
    uq_r = np.where(in_read, np.log(0.75 + 1e-10 - 0.75 * pr),
                    0.0).astype(dtype)
    map_qual_r = np.fromiter((r.map_qual for r in reads), np.float64, nr)
    unmapped_r = np.fromiter((r.is_unmapped for r in reads), bool, nr)
    psf_r = np.fromiter((read.pos_stat_first for read in reads),
                        np.float64, nr)
    # capped off-hap prior mass per read (computeBMidPrior,
    # ObservationModelFB.cpp:268-305)
    mq = 1.0 - map_qual_r
    capped = -10.0 * np.log10(mq) > p.map_qual_threshold
    mq = np.where(capped, 10.0 ** (-p.map_qual_threshold / 10.0), mq)
    log_off_r = np.log(mq)
    log_on_r = np.log(1.0 - mq)
    # HMQ prior mass: same float ops as the dense path (1-(1-1e-10)
    # differs from literal 1e-10 by one ulp, and the cap threshold
    # comparison sits exactly at that boundary)
    mq_h = 1.0 - (1.0 - 1e-10)
    if -10.0 * math.log10(mq_h) > p.map_qual_threshold:
        mq_h = 10.0 ** (-p.map_qual_threshold / 10.0)
    tr_dummy = _Trans(p, haps[0].seq)

    # per-hap tables
    hap_len_h = np.fromiter((h.size() for h in haps), np.int32, nh)
    hap_codes_h = np.zeros((nh, H_pad), np.uint8)
    lpe_h = np.full((nh, S_half), math.log(1e-5), dtype)
    lpn_h = np.full((nh, S_half), math.log(1 - 1e-5), dtype)
    lpeV_h = np.zeros((nh, S_half + numT), dtype)
    lpnV_h = np.zeros((nh, S_half + numT), dtype)
    b_mid_hr = np.zeros((nh, nr), np.int32)
    for hi, hap in enumerate(haps):
        Hh = hap_len_h[hi]
        if p.max_length_del > Hh:
            raise ValueError("hapSize error.")
        hap_codes_h[hi, :Hh] = np.frombuffer(hap.seq.encode(), np.uint8)
        e_, n_ = hp_log_prob_error(hap.seq)
        lpe_h[hi, :Hh + 2] = np.asarray(e_, dtype)
        lpn_h[hi, :Hh + 2] = np.asarray(n_, dtype)
        ROi = Hh + 1
        if ROi != H_pad + 1:
            lpe_h[hi, H_pad + 1] = lpe_h[hi, ROi]
            lpn_h[hi, H_pad + 1] = lpn_h[hi, ROi]
        core_e = np.full(S_half + numT, e_[ROi])
        core_n = np.full(S_half + numT, n_[ROi])
        core_e[:Hh + 1] = e_[:Hh + 1]
        core_n[:Hh + 1] = n_[:Hh + 1]
        lpeV_h[hi] = core_e
        lpnV_h[hi] = core_n
        # vectorized compute_b_mid (ObservationModelFB.cpp:50-99)
        m = psf_r.astype(np.int64)
        read_end = m + read_len_r - 1
        hap_end = hap_start + int(Hh)
        ol_start = np.maximum(hap_start, m)
        ol_end = np.where(hap_end > read_end, read_end, hap_end)
        mid = (ol_end - ol_start) // 2 + ol_start
        bm = np.where(unmapped_r | (m > hap_end) | (read_end < hap_start),
                      read_len_r // 2, mid - m)
        if p.b_mid != -1:
            bm = np.full_like(bm, p.b_mid)
        b_mid_hr[hi] = np.clip(bm, 0, read_len_r - 1).astype(np.int32)

    hap_idx = np.repeat(np.arange(nh, dtype=np.int32), nr)
    read_idx = np.tile(np.arange(nr, dtype=np.int32), nh)
    scalars = np.array([math.log(1.0 - p.p_first_g_lo),
                        math.log(p.p_first_g_lo),
                        -0.5,
                        math.log(1.0 - math.exp(-0.5)),
                        math.log(1.0 - p.p_error)], dtype)
    # per-read-base tables for the device stats pass (_pair_stats):
    # base-quality masks + log10(1-q) terms (in_read masking matches the
    # host decode, which only reads b < read_len)
    bqt_r = in_read & (qual_r > p.check_base_qual_threshold)
    q95_r = in_read & (qual_r > 0.95)
    with np.errstate(divide="ignore"):
        log10q_r = np.where(in_read,
                            np.log10(np.maximum(1.0 - qual_r, 1e-300)), 0.0)
    return dict(
        compact=True, H_pad=H_pad, L_pad=L_pad, numT=numT, nh=nh, nr=nr,
        bqt_r=bqt_r, q95_r=q95_r, log10q_r=log10q_r,
        read_codes_r=read_codes_r, eq_r=eq_r, uq_r=uq_r,
        hap_codes_h=hap_codes_h, lpe_h=lpe_h, lpn_h=lpn_h,
        lpeV_h=lpeV_h, lpnV_h=lpnV_h,
        hap_idx=hap_idx, read_idx=read_idx,
        hap_len=hap_len_h[hap_idx], read_len=read_len_r[read_idx],
        b_mid=b_mid_hr.reshape(-1),
        log_off_r=log_off_r, log_on_r=log_on_r,
        log_off_hmq=math.log(mq_h), log_on_hmq=math.log(1.0 - mq_h),
        log_ins1=tr_dummy.logpInsgNoIns,
        log_ins0=math.log(1.0 - math.exp(tr_dummy.logpInsgNoIns)),
        scalars=scalars)


def merge_compact(pks: List[dict]) -> dict:
    """Concatenate compact pks from several windows into one slab (table
    rows stacked; per-pair indices offset)."""
    if len(pks) == 1:
        return pks[0]
    out = dict(pks[0])
    for key in ("H_pad", "L_pad", "numT"):
        assert all(pk[key] == out[key] for pk in pks)
    tables_r = ("read_codes_r", "eq_r", "uq_r", "log_off_r", "log_on_r",
                "bqt_r", "q95_r", "log10q_r")
    tables_h = ("hap_codes_h", "lpe_h", "lpn_h", "lpeV_h", "lpnV_h")
    for k in tables_r + tables_h:
        out[k] = np.concatenate([pk[k] for pk in pks])
    off_r = np.cumsum([0] + [pk["read_codes_r"].shape[0] for pk in pks])
    off_h = np.cumsum([0] + [pk["hap_codes_h"].shape[0] for pk in pks])
    out["read_idx"] = np.concatenate(
        [pk["read_idx"] + off_r[i] for i, pk in enumerate(pks)])
    out["hap_idx"] = np.concatenate(
        [pk["hap_idx"] + off_h[i] for i, pk in enumerate(pks)])
    for k in ("hap_len", "read_len", "b_mid"):
        out[k] = np.concatenate([pk[k] for pk in pks])
    out["nh"] = out["nr"] = 0
    return out


def pad_compact(pk: dict) -> dict:
    """Pad a compact slab's table and pair-array sizes to shape buckets
    (the pad rows are clones of the last real row and every consumer
    slices by real-pair offsets).  Read tables pad to multiples of 64
    rows, hap tables to 8, and the pair axis to 128-pair tiles (pow2
    tile counts below 16, multiples of 16 above) — the layout the JAX
    package uses, kept so both packages see the same slab."""
    def padrows(a, m):
        n = a.shape[0]
        t = _round_up(max(n, 1), m)
        if t == n:
            return a
        return np.concatenate(
            [a, np.repeat(a[-1:], t - n, axis=0)], axis=0)

    out = dict(pk)
    for k in ("read_codes_r", "eq_r", "uq_r", "log_off_r", "log_on_r",
              "bqt_r", "q95_r", "log10q_r"):
        out[k] = padrows(pk[k], 64)
    for k in ("hap_codes_h", "lpe_h", "lpn_h", "lpeV_h", "lpnV_h"):
        out[k] = padrows(pk[k], 8)
    B = pk["hap_idx"].shape[0]
    TB = 128
    tiles = _round_up(B, TB) // TB
    if tiles > 1:
        if tiles < 16:
            tiles = 1 << (tiles - 1).bit_length()
        else:
            tiles = _round_up(tiles, 16)
    Bp = tiles * TB
    for k in ("hap_idx", "read_idx", "hap_len", "read_len", "b_mid"):
        out[k] = padrows(pk[k], Bp)
    return out


def expand_compact_host(pk: dict) -> dict:
    """Host-side (numpy) expansion of a compact pk into the dense layout
    of ``pack_pairs``."""
    out = dict(H_pad=pk["H_pad"], L_pad=pk["L_pad"], numT=pk["numT"],
               nh=pk["nh"], nr=pk["nr"], scalars=pk["scalars"],
               hap_len=pk["hap_len"], read_len=pk["read_len"],
               b_mid=pk["b_mid"])
    hi, ri = pk["hap_idx"], pk["read_idx"]
    out["read_codes"] = pk["read_codes_r"][ri]
    out["eq"] = pk["eq_r"][ri]
    out["uq"] = pk["uq_r"][ri]
    out["hap_codes"] = pk["hap_codes_h"][hi]
    out["lpe"] = pk["lpe_h"][hi]
    out["lpn"] = pk["lpn_h"][hi]
    out["lpeV"] = pk["lpeV_h"][hi]
    out["lpnV"] = pk["lpnV_h"][hi]
    dt = pk["eq_r"].dtype
    S_half = pk["H_pad"] + 2
    B = ri.shape[0]
    lane = np.arange(S_half)[None, :]
    hl = pk["hap_len"][:, None]

    def prior_half(lo, on, log_ins):
        v0 = np.asarray(lo + log_ins, dt)
        von = np.asarray(on + log_ins, dt)
        row = np.where(lane == 0, np.broadcast_to(v0, (B, S_half)),
                       np.where((lane >= 1) & (lane <= hl),
                                np.broadcast_to(von, (B, S_half)),
                                np.where(lane == pk["H_pad"] + 1,
                                         dt.type(-100.0), dt.type(NEGBIG))))
        return row.astype(dt)

    lo_r = pk["log_off_r"][ri][:, None]
    on_r = pk["log_on_r"][ri][:, None]
    out["prior_rmq"] = np.concatenate(
        [prior_half(lo_r, on_r, pk["log_ins0"]),
         prior_half(lo_r, on_r, pk["log_ins1"])], axis=1)
    oh = np.full((B, 1), pk["log_off_hmq"])
    onh = np.full((B, 1), pk["log_on_hmq"])
    out["prior_hmq"] = np.concatenate(
        [prior_half(oh, onh, pk["log_ins0"]),
         prior_half(oh, onh, pk["log_ins1"])], axis=1)
    return out


# table -> on-device dtype (None: keep the pk's float dtype)
_DEVICE_TABLES = {
    "read_codes_r": torch.uint8, "hap_codes_h": torch.uint8,
    "eq_r": None, "uq_r": None, "lpe_h": None, "lpn_h": None,
    "hap_idx": torch.int64, "read_idx": torch.int64,
    "hap_len": torch.int32, "read_len": torch.int32, "b_mid": torch.int32,
    "log_off_r": torch.float64, "log_on_r": torch.float64,
    "bqt_r": torch.bool, "q95_r": torch.bool, "log10q_r": torch.float64,
}


def tables_to_device(pk: dict, device) -> dict:
    """The compact slab tables as tensors on `device`.  The JAX package's
    V-arrays (lpeV_h/lpnV_h) serve only its XLA DP and are not sent."""
    out = {}
    for k, dt in _DEVICE_TABLES.items():
        a = np.ascontiguousarray(pk[k])
        t = torch.from_numpy(a)
        out[k] = t.to(device=device, dtype=dt if dt is not None else t.dtype)
    return out
