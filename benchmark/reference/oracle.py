"""Float64 NumPy oracle of the production pair-HMM (max-product with
homopolymer-aware indel-error transitions).

This is the numerical contract for the batched JAX/Pallas kernels: an exact
behavioral port of ObservationModelFBMaxErr (ObservationModelFB.cpp:867-1829)
including the EPS tie-breaking of updateMax (:877-888), the bMid anchoring
(:35-102, :268-305), emission quirks (insertion states emit 'match',
:243-245), and MAP-path variant reporting (:1351-1475).

State space per read base: x in {0=LO, 1..H (hap base x-1), H+1=RO} times
insertion flag i in {0,1}; linear index s = i*numS + x, numS = H+2.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from .config import ObservationModelParameters
from .model import Haplotype, MLAlignment, Read, HPOS_INS, HPOS_LO, HPOS_RO
from .variants import AlignedVariant

EPS = 1e-10       # ObservationModelFB.hpp:25
TIE = 1e-5        # updateMax near-tie window (ObservationModelFB.cpp:883)
NEG = -math.inf


# --- homopolymer indel error model (ReadIndelErrorModel.hpp:25-54) ---

_HP_BASE = np.array([2.9e-5, 2.9e-5, 2.9e-5, 2.9e-5, 4.3e-5,
                     1.1e-4, 2.4e-4, 5.7e-4, 1.0e-3, 1.4e-3])


def viterbi_hp_error(hp_len: int) -> float:
    ln = max(hp_len, 1)
    if ln <= 10:
        pbe = _HP_BASE[ln - 1]
    else:
        pbe = _HP_BASE[9] + 4.3e-4 * (ln - 10)
    pbe *= hp_len
    return min(pbe, 0.99)


_LVE_TAB = np.empty(0)
_LVN_TAB = np.empty(0)


def _log_verr_tables(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """math.log(viterbi_hp_error(ln)) / log(1-...) for ln in 0..n, grown
    lazily with the exact scalar calls the loop implementation made (so
    every float is bit-identical); index 0 is never consumed."""
    global _LVE_TAB, _LVN_TAB
    if _LVE_TAB.shape[0] <= n:
        old = _LVE_TAB.shape[0]
        e = np.empty(n + 1)
        v = np.empty(n + 1)
        e[:old] = _LVE_TAB
        v[:old] = _LVN_TAB
        for ln in range(max(old, 1), n + 1):
            perr = viterbi_hp_error(ln)
            e[ln] = math.log(perr)
            v[ln] = math.log(1.0 - perr)
        if old == 0:
            e[0] = np.nan
            v[0] = np.nan
        _LVE_TAB, _LVN_TAB = e, v
    return _LVE_TAB, _LVN_TAB


def hp_log_prob_error(hap_seq: str) -> Tuple[np.ndarray, np.ndarray]:
    """logProbError/logProbNoError tables per state index 0..H+1, the exact
    (quirky, sparse) fill pattern of FBMaxErr::setupTransitionProbs
    (ObservationModelFB.cpp:1675-1703).  Vectorized run-length scan; all
    float values come from the same math.log(viterbi_hp_error(ln)) calls
    as the original per-base loop (via _log_verr_tables), so the result
    is bit-identical to it."""
    H = len(hap_seq)
    lpe = np.full(H + 2, math.log(1e-5))
    lpn = np.full(H + 2, math.log(1.0 - 1e-5))
    if H == 0:
        return lpe, lpn
    lve, lvn = _log_verr_tables(H)
    # lpe[1] is seeded with the ln=1 value before the scan (the scan may
    # overwrite index 1 with the same value when a boundary sits there)
    lpe[1] = lve[1]
    lpn[1] = lvn[1]
    s = np.frombuffer(hap_seq.encode(), np.uint8)
    change = np.nonzero(s[1:] != s[:-1])[0] + 1  # boundary positions b
    if change.shape[0]:
        prev = np.concatenate([[0], change[:-1]])
        ln = change - prev            # run length ending at b-1
        lpe[change] = lve[ln]
        lpn[change] = lvn[ln]
        ln_final = H - change[-1]
    else:
        ln_final = H
    lpe[H - 1] = lve[ln_final]
    lpn[H - 1] = lvn[ln_final]
    return lpe, lpn


def compute_b_mid(read: Read, hap_start: int, hap_size: int,
                  override: int = -1) -> int:
    """Anchor base selection (ObservationModelFB.cpp:50-99)."""
    L = read.size()
    if read.is_unmapped:
        b_mid = L // 2
    else:
        m_read_start = int(read.pos_stat_first)
        read_end = m_read_start + L - 1
        hap_end = hap_start + hap_size
        if m_read_start > hap_end or read_end < hap_start:
            b_mid = L // 2
        else:
            ol_start = max(hap_start, m_read_start)
            ol_end = read_end if hap_end > read_end else hap_end
            mid = (ol_end - ol_start) // 2 + ol_start
            b_mid = mid - m_read_start
    if override != -1:
        b_mid = override
    if b_mid < 0:
        b_mid = 0
    if b_mid >= L:
        b_mid = L - 1
    return b_mid


class _Trans:
    """Transition log-probs (FBMaxErr::setupTransitionProbs,
    ObservationModelFB.cpp:1641-1673)."""

    def __init__(self, params: ObservationModelParameters, hap_seq: str):
        p = params
        self.logpLOgLO = math.log(1.0 - p.p_first_g_lo)
        self.logpFirstgLO = math.log(p.p_first_g_lo)
        self.numT = p.max_length_del + 2
        lt = np.zeros(self.numT)
        lt[1] = math.log(1.0 - p.p_error)
        norm = 0.0
        for x in range(1, self.numT):
            if x != 1:
                lt[x] = -abs(1.0 - x)
                norm += math.exp(lt[x])
        norm = math.log(norm / p.p_error)
        for x in range(1, self.numT):
            if x != 1:
                lt[x] -= norm
        self.logPTrans = lt
        self.logpInsgIns = -0.5
        self.logpNoInsgIns = math.log(1.0 - math.exp(self.logpInsgIns))
        self.logpInsgNoIns = math.log(p.p_error)
        self.logpNoInsgNoIns = math.log(1.0 - p.p_error)
        self.lpe, self.lpn = hp_log_prob_error(hap_seq)


def _update_max(dest: np.ndarray, bt: np.ndarray, j: int, val: float, idx: int):
    """updateMax (ObservationModelFB.cpp:877-888): replace on strictly-greater
    (EPS margin), or on near-tie (within 1e-5) prefer the lower state index."""
    dv = dest[j]
    if val > dv + EPS:
        dest[j] = val
        bt[j] = idx
    elif val >= dv and val <= dv + TIE and bt[j] > idx:
        dest[j] = val
        bt[j] = idx


def _pass_two_dec(tr: _Trans, H: int, dest: np.ndarray, src: np.ndarray,
                  obs: np.ndarray, bt: np.ndarray) -> None:
    """Forward step (read base b-1 -> b, hap position increasing):
    FBMaxErr::passMessageTwoDec (ObservationModelFB.cpp:1775-1829).
    dest = alpha[b], src = alpha[b-1], obs = obs[b-1], bt = btf[b]."""
    numS = H + 2
    RO = H + 1
    # 1. off-hap right: stay RO, or enter from last hap base
    dest[RO] = NEG
    _update_max(dest, bt, RO, obs[RO] + src[RO] + tr.logpLOgLO + tr.logpNoInsgNoIns, RO)
    _update_max(dest, bt, RO, obs[H] + src[H] + tr.logpFirstgLO + tr.logpNoInsgNoIns, H)
    # 2. on-hap matches/deletions
    for x in range(1, H + 1):
        dest[x] = NEG
        lpt = tr.lpe[x]
        lpn = tr.lpn[x]
        for y in range(1, tr.numT):
            newx = x - y
            if newx < 0:
                newx = 0
            lp = lpn if y == 1 else (lpt + (y - 1) * tr.logpInsgIns)
            _update_max(dest, bt, x, obs[newx] + lp + src[newx] + lpn, newx)
    # 3. off-hap left self-loop (overwrite)
    dest[0] = obs[0] + src[0] + tr.logpNoInsgNoIns
    bt[0] = 0
    # 4. insertion-exit into RO
    _update_max(dest, bt, RO, obs[numS + RO] + src[numS + RO] + tr.logpLOgLO + tr.lpe[RO], numS + RO)
    _update_max(dest, bt, RO, obs[numS + H] + src[numS + H] + tr.logpFirstgLO + tr.lpe[H], numS + H)
    # 5. insertion-exit onto hap
    for x in range(1, H + 1):
        newx = x - 1
        _update_max(dest, bt, x, obs[numS + newx] + src[numS + newx] + tr.lpe[x], numS + newx)
    # 6. insertion extension (assign)
    for x in range(0, H + 2):
        dest[numS + x] = obs[numS + x] + src[numS + x] + tr.logpInsgIns
        bt[numS + x] = numS + x
    # 7. insertion open
    for x in range(1, H + 2):
        _update_max(dest, bt, numS + x, obs[x] + src[x] + tr.logpNoInsgIns, x)


def _pass_two_inc(tr: _Trans, H: int, dest: np.ndarray, src: np.ndarray,
                  obs: np.ndarray, bt: np.ndarray) -> None:
    """Backward step (read base b -> b-1): FBMaxErr::passMessageTwoInc
    (ObservationModelFB.cpp:1715-1773). dest = beta[b-1], src = beta[b],
    obs = obs[b], bt = btb[b-1] (stores the successor state)."""
    numS = H + 2
    RO = H + 1
    # 1. LO: stay, or enter hap at base 1
    dest[0] = NEG
    _update_max(dest, bt, 0, obs[0] + src[0] + tr.logpLOgLO + tr.logpNoInsgNoIns, 0)
    _update_max(dest, bt, 0, obs[1] + src[1] + tr.logpFirstgLO + tr.logpNoInsgNoIns, 1)
    # 2. on-hap matches/deletions
    for x in range(1, H + 1):
        dest[x] = NEG
        for y in range(1, tr.numT):
            newx = x + y
            if newx > H:
                newx = RO
            lpn = tr.lpn[newx]
            lpt = tr.lpe[newx]
            lp = lpn if y == 1 else (lpt + (y - 1) * tr.logpInsgIns)
            _update_max(dest, bt, x, lp + lpn + src[newx] + obs[newx], newx)
    # 3. RO self-loop
    dest[RO] = NEG
    _update_max(dest, bt, RO, obs[RO] + src[RO] + tr.lpn[RO], RO)
    # 4. insertion open (noins x -> ins x at next base)
    for x in range(0, H + 1):
        _update_max(dest, bt, x, obs[numS + x] + src[numS + x] + tr.lpe[x + 1], numS + x)
    x = H + 1
    _update_max(dest, bt, x, obs[numS + x] + src[numS + x], numS + x)
    # 5. insertion extension (assign)
    for x in range(0, H + 2):
        dest[numS + x] = obs[numS + x] + src[numS + x] + tr.logpInsgIns
        bt[numS + x] = numS + x
    # 6. insertion exit
    _update_max(dest, bt, numS + 0, obs[0] + src[0] + tr.logpNoInsgIns, 0)
    for x in range(1, H + 2):
        newx = x + 1
        if newx > RO:
            newx = RO
        _update_max(dest, bt, numS + x, obs[newx] + src[newx] + tr.logpNoInsgIns, newx)


def _emissions(hap_seq: str, read: Read, params: ObservationModelParameters) -> np.ndarray:
    """Observation potentials obs[b, s] (setupReadObservationPotentials,
    ObservationModelFB.cpp:220-266)."""
    H = len(hap_seq)
    numS = H + 2
    L = read.size()
    obs = np.zeros((L, 2 * numS))
    hap_arr = np.frombuffer(hap_seq.encode(), dtype=np.uint8)
    read_arr = np.frombuffer(read.seq.encode(), dtype=np.uint8)
    N = ord("N")
    for b in range(L):
        pr = read.qual[b] * (1.0 - params.p_mut)
        eq = math.log(0.25 + 0.75 * pr)
        uq = math.log(0.75 + 1e-10 - 0.75 * pr)
        obs[b, :] = eq  # ins states + off-hap all emit eq
        mismatch = (hap_arr != read_arr[b]) & (hap_arr != N)
        obs[b, 1:H + 1][mismatch] = uq
    if params.force_read_on_haplotype:
        RO = H + 1
        obs[:, 0] = -1000.0
        obs[:, RO] = -1000.0
        obs[:, numS] = -1000.0
        obs[:, numS + RO] = -1000.0
    return obs


def compute_b_mid_prior(tr: _Trans, read: Read, hap_start: int, H: int,
                        params: ObservationModelParameters, map_qual: float,
                        b_mid: int) -> np.ndarray:
    """Anchored prior at the bMid slice (computeBMidPrior,
    ObservationModelFB.cpp:268-305)."""
    numS = H + 2
    RO = H + 1
    mq = 1.0 - map_qual
    if -10.0 * math.log10(mq) > params.map_qual_threshold:
        mq = math.pow(10.0, -params.map_qual_threshold / 10.0)
    p_off_first = mq
    prior = np.zeros(2 * numS)
    pinsert = np.zeros(numS)
    if params.map_unmapped_reads and read.is_paired:
        if (not read.mate_is_unmapped) and read.mate_len != -1 and read.same_tid_as_mate:
            lib = read.get_library()
            if read.mate_is_reverse:
                for x in range(1, H + 1):
                    pinsert[x] = math.log(lib.get_prob(abs(hap_start + x - b_mid - (read.mate_pos + read.mate_len))))
            else:
                for x in range(1, H + 1):
                    pinsert[x] = math.log(lib.get_prob(abs(hap_start + x + read.size() - b_mid - read.mate_pos)))
            pinsert[0] = math.log(lib.ninetyfifth_pct_prob)
    for i in range(2):
        logp_ins = tr.logpInsgNoIns if i == 1 else math.log(1.0 - math.exp(tr.logpInsgNoIns))
        prior[i * numS + 0] = math.log(p_off_first) + logp_ins + pinsert[0]
        prior[i * numS + RO] = -100.0
        for x in range(1, H + 1):
            prior[i * numS + x] = pinsert[x] + math.log(1.0 - p_off_first) + logp_ins
    return prior


def pair_hmm_single(hap: Haplotype, read: Read, hap_start: int,
                    params: Optional[ObservationModelParameters] = None) -> MLAlignment:
    """Score one read against one haplotype; the full
    ObservationModelFBMaxErr::calcLikelihood path (runHMM + reportVariants)."""
    if params is None:
        params = ObservationModelParameters()
    hap_seq = hap.seq
    H = len(hap_seq)
    if params.max_length_del > H:
        raise ValueError("hapSize error.")
    numS = H + 2
    RO = H + 1
    L = read.size()
    S = 2 * numS

    b_mid = compute_b_mid(read, hap_start, H, params.b_mid)
    tr = _Trans(params, hap_seq)
    obs = _emissions(hap_seq, read, params)

    alpha = np.zeros((L, S))
    beta = np.zeros((L, S))
    btf = np.zeros((L, S), dtype=np.int32)
    btb = np.zeros((L, S), dtype=np.int32)

    # forward/backward split at bMid (FBMax::computeForwardMessages,
    # ObservationModelFB.cpp:1569-1581)
    for b in range(1, b_mid + 1):
        _pass_two_dec(tr, H, alpha[b], alpha[b - 1], obs[b - 1], btf[b])
    for b in range(L - 1, b_mid, -1):
        _pass_two_inc(tr, H, beta[b - 1], beta[b], obs[b], btb[b - 1])

    # likelihood at the bMid slice (FBMax::calcLikelihoodFromLastSlice,
    # ObservationModelFB.cpp:1075-1144)
    prior_rmq = compute_b_mid_prior(tr, read, hap_start, H, params, read.map_qual, b_mid)
    prior_hmq = compute_b_mid_prior(tr, read, hap_start, H, params, 1.0 - 1e-10, b_mid)

    ml = MLAlignment()
    log_lik = NEG
    ll_hmq = NEG
    lik_off = [NEG, NEG]
    map_state = np.zeros(L, dtype=np.int32)
    map_state_rmq = 0
    for x in range(S):
        v = alpha[b_mid, x] + obs[b_mid, x] + beta[b_mid, x] + prior_rmq[x]
        if v > log_lik + EPS:
            log_lik = v
            map_state_rmq = x
        if (x % numS) == 0:
            if v > lik_off[0]:
                lik_off[0] = v
        elif (x % numS) != RO:
            if v > lik_off[1]:
                lik_off[1] = v
        v = alpha[b_mid, x] + obs[b_mid, x] + beta[b_mid, x] + prior_hmq[x]
        if v > ll_hmq + EPS:
            ll_hmq = v
            map_state[b_mid] = x
    ml.ll = log_lik
    ml.off_hap_hmq = (map_state[b_mid] % numS) in (0, RO)
    ml.off_hap = (map_state_rmq % numS) in (0, RO)
    ml.ll_off = lik_off[0]
    ml.ll_on = lik_off[1]

    # backtrack (FBMax::computeMAPState, ObservationModelFB.cpp:1148-1165)
    for b in range(b_mid, 0, -1):
        map_state[b - 1] = btf[b, map_state[b]]
    for b in range(b_mid, L - 1):
        map_state[b + 1] = btb[b, map_state[b]]

    _report_variants(ml, map_state, hap, read, params, numS, RO)
    return ml


def _report_variants(ml: MLAlignment, map_state: np.ndarray, hap: Haplotype,
                     read: Read, params: ObservationModelParameters,
                     numS: int, RO: int) -> None:
    """MAP path -> per-read variant events + coverage/mismatch statistics
    (FBMax::reportVariants, ObservationModelFB.cpp:1351-1475)."""
    H = numS - 2
    L = read.size()
    ml.align = ["R"] * H
    ml.hpos = [0] * L
    ml.first_base = -1
    ml.last_base = -1
    b = 0
    while b < L:
        s = int(map_state[b])
        x = s % numS
        if 0 < x <= H:
            if s >= numS:
                # insertion run
                pos = x  # insertion before hap base x (pos = x-1+1)
                rpos = b
                ln = 0
                while b < L and map_state[b] >= numS:
                    ml.hpos[b] = HPOS_INS
                    b += 1
                    ln += 1
                seq = read.seq[rpos:rpos + ln]
                ml.indels[pos] = AlignedVariant("+" + seq, start_hap=pos, end_hap=pos,
                                                start_read=rpos, end_read=b - 1)
                ml.num_indels += 1
                b -= 1
            else:
                ml.hpos[b] = s - 1
                if ml.first_base == -1 or s - 1 < ml.first_base:
                    ml.first_base = s - 1
                if ml.last_base == -1 or s - 1 > ml.last_base:
                    ml.last_base = s - 1
                if read.qual[b] > params.check_base_qual_threshold:
                    ml.n_bqt += 1
                    ml.m_log_bq += math.log10(1.0 - read.qual[b])
                if read.seq[b] != hap.seq[s - 1]:
                    snp = hap.seq[s - 1] + "=>" + read.seq[b]
                    if read.qual[b] > params.check_base_qual_threshold:
                        ml.n_mm_bqt += 1
                    if b < 6:
                        ml.n_mm_left += 1
                    if b > L - 6:
                        ml.n_mm_right += 1
                    if read.qual[b] > 0.95:
                        ml.num_mismatch += 1
                    ml.snps[s - 1] = AlignedVariant(snp, start_hap=s - 1, end_hap=s - 1,
                                                    start_read=b, end_read=b)
                    ml.align[s - 1] = read.seq[b]
                if b < L - 1:
                    ns = int(map_state[b + 1])
                    if ns < numS and ns - s > 1:
                        pos = s  # pos = s+1-1
                        ln = ns - s - 1
                        for y in range(pos, pos + ln):
                            ml.align[y] = "D"
                        seq = hap.seq[pos:pos + ln]
                        ml.indels[pos] = AlignedVariant("-" + seq, start_hap=pos,
                                                        end_hap=pos + ln - 1,
                                                        start_read=b, end_read=b + 1)
                        ml.num_indels += 1
        else:
            ml.hpos[b] = HPOS_LO if x == 0 else HPOS_RO
        b += 1
    ml.align = "".join(ml.align)

    for p, av in hap.indels.items():
        ml.hap_indel_covered[p] = av.is_covered(params.pad_cover, ml.first_base, ml.last_base)
    for p, av in hap.snps.items():
        ml.hap_snp_covered[p] = av.is_covered(params.pad_cover, ml.first_base, ml.last_base)
