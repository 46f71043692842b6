"""The slab epilogue's kernels (csrc/slab_epilogue.cu: finish, pair_stats,
window_call) on the CPU.

CUDA cannot run here, so each kernel's algorithm is written below as a
NumPy model in the kernel's loop order, and held to the plain PyTorch
version and to the JAX package (``_finish(bt_codes=True)``,
``_pair_stats``, ``_window_call`` on the CPU) on seeded inputs:
- finish: a warp per pair, lane l folding columns l, l+32, ... in
  order, the lanes' partial folds combined by the xor-shuffle butterfly
  (fast fold; and ll_off/ll_on of the exact fold); the exact EPS fold
  run over each 32-column sub-row's prefix-maximum records only; then
  the down walk and the up walk as two walks from s_mid.  Cases: float32
  with the fast fold and float64 with the exact one (and the other two
  pairings), b_mid at 0 and at read_len-1, random garbage in the
  backpointer rows and map_state columns no pair consumes, and rows
  that break a wrong combine: ties and near-ties (inside EPS) in
  different lanes and sub-rows, NaN in several lanes, +0.0 and -0.0 at
  the maximum, all -inf rows;
- pair_stats: a warp per pair, lane l decoding columns l, l+32, ...
  of the staged row in one pass (order-free counts as lane partial
  sums; n_ind from each 32 columns' ballot masks with the run's `seen`
  flag and the last event's position carried between chunks), the row
  left decoded for the slot tests (lanes over columns, four slots a
  pass), then m_log_bq in column order skipping the masked terms.
  Cases: slabs' decoded paths and random states, and the edge rows of
  chip_smoke.STATS_EDGE_CASES (L_pad 33, 64, 112, 200; V 0, 1, 8; ins
  runs and repeated event positions across column 32; read_len 0 and
  above L_pad; hap_len 0; NaN, +-inf and -0.0 log10q terms);
- window_call: a block per (window, KT pairs), t computed once per
  (pair, read) for a chunk of R reads, then each of the S+1 sums adding
  the chunk in read order; several KT and R, NR not a multiple of R,
  windows with nr_w 0, above NR and below it.
The wrappers (hmm/epilogue_kernel.py) must return exactly the plain
versions' results for CPU tensors and must not count a launch there.
The kernels themselves are held to the plain versions on the card in
tests/test_torch_cuda.py and chip_smoke.py.

Tolerances: finish and pair_stats compare exactly (they add, compare
and decode integers; pair_stats's float64 sum bit for bit), NaN equal
to NaN (a NaN's sign and payload follow the operand order the compiler
picks for an add, on the CPU); the sign of a zero at the
maximum is held to the first occurrence's (the sequential fold's rule,
which the kernel keeps) and compared by value to plain and JAX, whose
vectorised max may return the other zero.  window_call's model is
bit-equal to the plain version with torch's exp/log; with NumPy's it
compares to 1e-6 relative in float32 and 1e-12 in float64, as does JAX:
NumPy's, torch's and XLA's libm differ by ulps."""

import hashlib

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from chip_smoke import (SPECIALS, STATS_EDGE_CASES, edge_inputs,
                        special_rows, stats_edge_arrays, window_special_case)
from dindel_tpu.hmm.batch import _finish, _pair_stats
from dindel_tpu.infer.device_call import _window_call
from dindel_tpu_torch import nvcc_build
from dindel_tpu_torch.config import ObservationModelParameters
from dindel_tpu_torch.hmm import dp_kernel
from dindel_tpu_torch.hmm import epilogue_kernel as ek
from dindel_tpu_torch.hmm.dp_ref import dp_ref
from dindel_tpu_torch.hmm.finish import finish as plain_finish
from dindel_tpu_torch.hmm.pack import (merge_compact, pack_pairs_compact,
                                       pad_compact, tables_to_device)
from dindel_tpu_torch.hmm.slab import run_slab_decode
from dindel_tpu_torch.hmm.stats import pair_stats as plain_pair_stats
from dindel_tpu_torch.infer.device_call import pair_enum
from dindel_tpu_torch.infer.device_call import window_call as plain_window
from dindel_tpu_torch.parallel.mesh import synth_windows

torch.set_num_threads(1)

EPS = 1e-10
NEGBIG = -1.0e30
MAX_MM = 2
FIN_NAMES = ("ll", "off_hap", "off_hap_hmq", "ll_off", "ll_on", "map_state")
STAT_NAMES = ("fb", "lb", "n_bqt", "n_mm_bqt", "m_log_bq", "n_mm_left",
              "n_mm_right", "num_mm", "has_event", "any_mism", "n_ind",
              "cov_ok")


# ---------------------------------------------------------------------------
# the kernels' algorithms, one pair at a time


def _code(row, cur, SP):
    x = cur % SP  # Python's % is a floor modulo, as the kernel's floor_mod
    pack = int(row[x])
    return x, (pack >> 4 if cur >= SP else pack) & 15


def _dec_fwd(row, cur, SP, RO, hl):
    x, c = _code(row, cur, SP)
    if cur >= SP:
        return cur if c == 0 else x
    if x == RO:
        return (SP + RO if c == 0 else SP + hl if c == 1
                else RO if c == 2 else hl)
    return (SP + max(x - 1, 0) if c == 0 else x if c == 1
            else max(x - (c - 1), 0))


def _dec_bwd(row, cur, SP, RO, hl, numT):
    x, c = _code(row, cur, SP)
    if cur >= SP:
        x1 = x + 1 if x + 1 <= hl else RO
        return cur if c == 0 else x if c == 1 else x1
    xy = x + (numT - c)
    return SP + x if c == 0 else x if c == numT else (xy if xy <= hl else RO)


LANES = 32
BIG = 2 ** 31 - 1


def _isnan(v):
    return v != v


def _before_fast(v, i, cv, ci):
    """Does (v, column i) come before (cv, ci) in the fast fold's order:
    a NaN first, then the larger value, then the lower column."""
    n, cn = _isnan(v), _isnan(cv)
    if n != cn:
        return n
    if not n and v != cv:
        return v > cv
    return i < ci


def _before_exact(v, i, cv, ci):
    """The exact fold's ll_off/ll_on order: a NaN never comes first."""
    return bool(v > cv or (v == cv and i < ci))


def _bits(v):
    return np.asarray(v).tobytes()


def _butterfly(pairs, before):
    """The xor-shuffle combine of 32 lanes' (value, column): five rounds,
    lane l taking lane l^o's pair where it comes first.  Every lane must
    end with the same pair."""
    for o in (16, 8, 4, 2, 1):
        pairs = [pairs[lane ^ o] if before(*pairs[lane ^ o], *pairs[lane])
                 else pairs[lane] for lane in range(LANES)]
    assert len({(_bits(v), i) for v, i in pairs}) == 1
    return pairs[0]


def _max_num(a, b):
    return a if _isnan(b) else b if (_isnan(a) or b > a) else a


def _eps_records(v, base, eps, carry, ll, idx):
    """One 32-column sub-row of the exact fold (v a list of 32, NaN past
    the row): the lanes' inclusive max scan (shfl_up), each column's
    maximum before it, the records, and the `v > ll + EPS` test over the
    records in column order."""
    neginf = type(eps)(-np.inf)
    s = list(v)
    for o in (1, 2, 4, 8, 16):
        s = [_max_num(s[lane], s[lane - o]) if lane >= o else s[lane]
             for lane in range(LANES)]
    before = [_max_num(s[lane - 1] if lane else neginf, carry)
              for lane in range(LANES)]
    rec = [bool(v[lane] > before[lane]) for lane in range(LANES)]
    carry = _max_num(carry, s[LANES - 1])
    for lane in range(LANES):
        if rec[lane] and v[lane] > ll + eps:
            ll, idx = v[lane], base + lane
    return carry, ll, idx


def _walk(bt, i, cur, rows, decode):
    """The states a walk visits from `cur` over backpointer `rows` of
    pair i, one per row, in order."""
    out = []
    for b in rows:
        cur = decode(bt[b, i], cur)
        out.append(cur)
    return out


def model_finish(H_pad, L_pad, numT, b_mid, hap_len, alpha, beta, obs, prm,
                 phm, btf, btb, exact, read_len=None):
    """finish_kernel's loop order (see the module docstring); returns
    the plain version's six outputs."""
    dt = alpha.dtype.type
    B = len(b_mid)
    SP, RO, S = H_pad + 2, H_pad + 1, 2 * (H_pad + 2)
    eps, neginf, nan = dt(EPS), dt(-np.inf), dt(np.nan)
    before_off = _before_exact if exact else _before_fast
    fl = np.empty((3, B), dt)
    fb = np.empty((2, B), bool)
    ms = np.empty((B, L_pad), np.int32)
    for i in range(B):
        lanes = [dict(ll=(neginf, BIG), llH=(neginf, BIG), off=(neginf, BIG),
                      on=(neginf, BIG)) for _ in range(LANES)]
        ll, ir, llH, ih = neginf, BIG, neginf, BIG  # the exact scans
        cv = cw = neginf
        for base_col in range(0, S, LANES):
            vs, ws = [nan] * LANES, [nan] * LANES
            for lane in range(LANES):
                x = base_col + lane
                if x >= S:
                    continue
                base = (alpha[i, x] + obs[i, x]) + beta[i, x]
                v, w = base + prm[i, x], base + phm[i, x]
                vs[lane], ws[lane] = v, w
                st = lanes[lane]
                if not exact:
                    for key, val in (("ll", v), ("llH", w)):
                        if _before_fast(val, x, *st[key]):
                            st[key] = (val, x)
                key = "off" if x % SP == 0 else None if x % SP == RO else "on"
                if key and before_off(v, x, *st[key]):
                    st[key] = (v, x)
            if exact:
                cv, ll, ir = _eps_records(vs, base_col, eps, cv, ll, ir)
                cw, llH, ih = _eps_records(ws, base_col, eps, cw, llH, ih)
        if not exact:
            ll, ir = _butterfly([st["ll"] for st in lanes], _before_fast)
            llH, ih = _butterfly([st["llH"] for st in lanes], _before_fast)
        off = _butterfly([st["off"] for st in lanes], before_off)[0]
        on = _butterfly([st["on"] for st in lanes], before_off)[0]
        mr = 0 if ir == BIG else ir
        sm = 0 if ih == BIG else ih
        fl[:, i] = ll, off, on
        fb[:, i] = mr % SP in (0, RO), sm % SP in (0, RO)
        # the two walks, each from s_mid on a thread of its own
        hl = int(hap_len[i])
        rl = L_pad if read_len is None else int(read_len[i])
        a = min(max(int(b_mid[i]), 0), L_pad - 1)
        down = _walk(btf, i, sm, range(a - 1, -1, -1),
                     lambda row, cur: _dec_fwd(row, cur, SP, RO, hl))
        up = _walk(btb, i, sm, range(a, min(L_pad - 2, rl - 2) + 1),
                   lambda row, cur: _dec_bwd(row, cur, SP, RO, hl, numT))
        ms[i, :a] = down[::-1]
        ms[i, a] = sm
        ms[i, a + 1:a + 1 + len(up)] = up
        ms[i, a + 1 + len(up):] = up[-1] if up else sm
    return fl[0], fb[0], fb[1], fl[1], fl[2], ms


SLOT_GROUP = 4  # slots a pass over the decoded row (kSlotGroup)


def _ballot(pred):
    """A warp's ballot: bit l is lane l's predicate."""
    return int((pred.astype(np.uint64) << np.arange(32, dtype=np.uint64))
               .sum())


def _clz(x):
    return 32 - int(x).bit_length()


def _stat_cols(row, b, L_pad, SP, RO, hl, rl):
    """stat_col for the lanes' columns b: (xs, ins, on); nothing past
    the row."""
    valid = b < L_pad
    m = np.where(valid, row[np.minimum(b, L_pad - 1)], 0)
    xa = m % SP  # a floor modulo, as the kernel's state_col
    xs = np.where(valid, np.where(xa == RO, hl + 1, xa), 0)
    return (xs, valid & (m >= SP),
            valid & (xs >= 1) & (xs <= hl) & (b < rl))


def _stats_pass(row, rc, bq, q95, hc, H_pad, L_pad, rl, hl):
    """The column pass of one pair (a warp, lane l on columns l, l+32,
    ...): returns the eight ints, has_event, any_mism, the row decoded
    in place ((hp + 4) << 2 | isN << 1 | mm) and the bqt ballot masks."""
    SP, RO = H_pad + 2, H_pad + 1
    lane = np.arange(32)
    below = (1 << lane) - 1
    dec = row.astype(np.int64).copy()
    fbv, lbv = np.full(32, BIG, np.int64), np.full(32, -1, np.int64)
    n_mm_bqt = n_mm_left = n_mm_right = num_mm = 0
    any_mm = False
    n_bqt = n_ind = last_pos = 0
    seen = has_prev = False
    masks = []
    cur = _stat_cols(row, lane, L_pad, SP, RO, hl, rl)
    for c in range((L_pad + 31) // 32):
        b = 32 * c + lane
        nxt = _stat_cols(row, b + 32, L_pad, SP, RO, hl, rl)
        xs, ins, on = cur
        # column b + 1: the next lane's, lane 31's the next chunk's lane 0
        xs1 = np.append(xs[1:], nxt[0][0])
        ins1 = np.append(ins[1:], nxt[1][0])
        noins_on, inhap = on & ~ins, on & ins
        del_ev = noins_on & ~ins1 & (b + 1 < rl) & (b + 1 < L_pad) & (
            xs1 - xs > 1)
        hp = np.where(noins_on, xs - 1, np.where(xs == 0, -3, -4))
        wrap = np.where(hp >= 0, hp, hl + hp)
        hch = hc[np.clip(wrap, 0, H_pad - 1)]
        valid = b < L_pad
        bc = np.minimum(b, L_pad - 1)
        mm = valid & (hch != rc[bc])
        isn = hch == ord("N")
        dec[b[valid]] = (((hp + 4) << 2) | (isn << 1) | mm)[valid]
        bqt = noins_on & bq[bc].astype(bool)
        mb = _ballot(bqt)
        masks.append(mb)
        n_bqt += bin(mb).count("1")
        fbv = np.where(noins_on, np.minimum(fbv, hp), fbv)
        lbv = np.where(noins_on, np.maximum(lbv, hp), lbv)
        # the mismatch counts from ballots, skipped without a mismatch
        M = _ballot(noins_on & mm)
        if M:
            t = rl - 5 - 32 * c  # columns b > rl - 6: lanes t and up
            R = 0xffffffff if t <= 0 else (0xffffffff << t) & 0xffffffff \
                if t < 32 else 0
            n_mm_bqt += bin(M & mb).count("1")
            num_mm += bin(M & _ballot(valid & q95[bc].astype(bool))
                          ).count("1")
            n_mm_left += 0 if c else bin(M & 0x3F).count("1")
            n_mm_right += bin(M & R).count("1")
            any_mm = True
        # n_ind from the ballots, the run's `seen` and the last event
        # carried from chunk to chunk; skipped with no ins column and no
        # deletion
        I, D = _ballot(ins), _ballot(del_ev)
        if not I | D:
            seen = False
            cur = nxt
            continue
        H = _ballot(inhap)
        ev = np.zeros(32, bool)
        for ln in range(32):
            z = ~I & below[ln] & 0xffffffff
            prior = ((H & below[ln]) >> (32 - _clz(z))) != 0 if z else (
                seen or (H & below[ln]) != 0)
            ev[ln] = (inhap[ln] and not prior) or del_ev[ln]
        E = _ballot(ev)
        fresh = np.zeros(32, bool)
        for ln in range(32):
            e = E & below[ln]
            pxs = xs[31 - _clz(e) if e else 0]
            fresh[ln] = ev[ln] and ((xs[ln] != pxs) if e else (
                not has_prev or xs[ln] != last_pos))
        n_ind += int(fresh.sum())
        nI = ~I & 0xffffffff
        seen = bool(I >> 31) and (((H >> (32 - _clz(nI))) != 0) if nI
                                  else (seen or H != 0))
        if E:
            last_pos = int(xs[31 - _clz(E)])
            has_prev = True
        cur = nxt
    fb = int(fbv.min())
    ints = (-1 if fb == BIG else fb, int(lbv.max()), n_bqt, n_mm_bqt,
            n_mm_left, n_mm_right, num_mm, n_ind)
    return ints, has_prev, any_mm, dec, masks


def _stats_slots(dec, ncol, sel, left, right, isdel, valid, max_mm):
    """The slot tests over the decoded row, SLOT_GROUP slots a pass:
    lanes over columns; per slot a lane's count of the in-range no-ins
    columns, of the mismatches and of the mismatches against an N, and
    the sentinels' bits, reduced over the warp; a deletion's mismatches
    leave out those against an N."""
    V = len(left)
    lane = np.arange(32)
    out = np.zeros(V, bool)
    for v0 in range(0, V, SLOT_GROUP):
        ks = range(v0, min(V, v0 + SLOT_GROUP))
        act = {k: sel and valid[k] and right[k] >= left[k] for k in ks}
        acc = {k: np.zeros((3, 32), np.int64) for k in ks}
        lr = {k: np.zeros(32, np.int64) for k in ks}
        if any(act.values()):
            for c0 in range(0, ncol, 32):
                b = c0 + lane
                live = b < ncol
                d = dec[np.minimum(b, len(dec) - 1)]
                hp = (d >> 2) - 4
                w = np.stack([hp >= 0, (d & 1) == 1, (d & 3) == 3])
                sent = np.where(hp < 0, hp + 5, 0)
                for k in ks:
                    if act[k]:
                        inr = live & (hp >= left[k]) & (hp <= right[k])
                        acc[k] += w & inr
                        lr[k] |= np.where(inr, sent, 0)
        for k in ks:
            if not (sel and valid[k]):
                continue
            c_noins, mm, mmn = acc[k].sum(axis=1)
            sk = int(np.bitwise_or.reduce(lr[k]))
            c_size = int(c_noins) + (sk & 1) + (sk >> 1)
            ln = int(right[k]) - int(left[k]) + 1
            ok_mm = (mm - mmn if isdel[k] else mm) <= max_mm
            out[k] = (c_size >= ln and ok_mm) if isdel[k] else (
                ok_mm and c_size == ln)
    return out


def _stats_sum(lq, masks):
    """m_log_bq: the terms of the set bqt bits in column order from
    +0.0, the masked ones skipped (adding +0.0 is the identity there)."""
    s = np.float64(0.0)
    with np.errstate(invalid="ignore"):  # inf + -inf: NaN, as on the card
        for c, m in enumerate(masks):
            for j in range(32):
                if m >> j & 1:
                    s = s + lq[32 * c + j]
    return s


def model_pair_stats(H_pad, L_pad, V, ms, read_len, hap_len, read_idx,
                     hap_idx, rc_r, hc_h, bqt_r, q95_r, lq_r, v_left,
                     v_right, v_isdel, v_valid, off_hap_hmq, max_mm):
    """pair_stats_kernel: per pair, the column pass (a warp), the slot
    tests over the row it decoded, then the column-ordered sum."""
    B = ms.shape[0]
    ints = np.zeros((8, B), np.int32)
    mlq = np.zeros(B, np.float64)
    flags = np.zeros((2, B), bool)
    cov = np.zeros((B, V), bool)
    for i in range(B):
        rl, hl = int(read_len[i]), int(hap_len[i])
        ri, hi = int(read_idx[i]), int(hap_idx[i])
        pi, has_event, any_mism, dec, masks = _stats_pass(
            ms[i], rc_r[ri], bqt_r[ri], q95_r[ri], hc_h[hi], H_pad, L_pad,
            rl, hl)
        ints[:, i] = pi
        flags[:, i] = has_event, any_mism
        cov[i] = _stats_slots(dec, min(max(rl, 0), L_pad),
                              not off_hap_hmq[i] and not has_event,
                              v_left[hi], v_right[hi], v_isdel[hi],
                              v_valid[hi], max_mm)
        mlq[i] = _stats_sum(lq_r[ri], masks)
    return (ints[0], ints[1], ints[2], ints[3], mlq, ints[4], ints[5],
            ints[6], flags[0], flags[1], ints[7], cov)


def torch_term(a, b):
    """t of gathered values a, b (NumPy arrays of one dtype) as the plain
    version computes it, with torch's exp and log."""
    a, b = torch.from_numpy(a), torch.from_numpy(b)
    log5 = torch.tensor(np.log(0.5), dtype=a.dtype)
    one = torch.tensor(1.0, dtype=a.dtype)
    m, mn = torch.maximum(a, b), torch.minimum(a, b)
    return (log5 + (m + torch.log(one + torch.exp(mn - m)))).numpy()


def numpy_term(a, b):
    """t of gathered values a, b with NumPy's exp and log."""
    dt = a.dtype.type
    m, mn = np.maximum(a, b), np.minimum(a, b)
    return dt(np.log(0.5)) + (m + np.log(dt(1.0) + np.exp(mn - m)))


def model_window_call(W, NH, S, NR, ll, index_map, nr_w, pair_pr, KT, R,
                      term):
    """window_call_kernel's loop order: a block per (window, KT pairs
    in pair_enum order); per chunk of R reads, t computed once per
    (pair, read) by `term` from the two gathered ll values, then each
    accumulator adding the chunk's values in read order; reads past nr_w
    add one +0.0."""
    dt = pair_pr.dtype.type
    NP = NH * (NH + 1) // 2
    h1v, h2v = pair_enum(NH)
    zero = dt(0.0)
    llc = ll.astype(dt)
    base = np.empty((W, NP), dt)
    site = np.empty((W, S, NP), dt)
    for w in range(W):
        nr = min(max(int(nr_w[w]), 0), NR)
        for k0 in range(0, NP, KT):
            nk = min(KT, NP - k0)
            acc = [zero if j == 0 else pair_pr[w, j - 1, k0 + kk]
                   for j in range(S + 1) for kk in range(nk)]
            for r0 in range(0, nr, R):
                rc = min(R, nr - r0)
                tv = [term(llc[index_map[w, h1v[k0 + kk], r0:r0 + rc]],
                           llc[index_map[w, h2v[k0 + kk], r0:r0 + rc]])
                      for kk in range(nk)]
                for a in range(len(acc)):
                    s = acc[a]
                    for val in tv[a % nk]:
                        s = s + val
                    acc[a] = s
            for a, s in enumerate(acc):
                if nr < NR:
                    s = s + zero
                j, kk = divmod(a, nk)
                if j == 0:
                    base[w, k0 + kk] = s
                else:
                    site[w, j - 1, k0 + kk] = s
    return base, site


# ---------------------------------------------------------------------------
# inputs


def _garbage_bt(btf, btb, b_mid, read_len, rng):
    """Copies of btf/btb with random bytes in every row a pair does not
    consume: btf rows >= b_mid, btb rows < b_mid or > read_len-2."""
    f, g = btf.copy(), btb.copy()
    rows = np.arange(f.shape[0])
    for i, (bm, rl) in enumerate(zip(b_mid, read_len)):
        fr = rows >= bm
        br = (rows < bm) | (rows > rl - 2)
        f[fr, i] = rng.randint(0, 256, size=(fr.sum(), f.shape[2]))
        g[br, i] = rng.randint(0, 256, size=(br.sum(), g.shape[2]))
    return f, g


def finish_case(dtype, exact, b_mid, seed):
    """DP outputs of random inputs on a 0.25 grid (ties in the folds),
    obs and prior rows on the same grid with NEGBIG states, and
    backpointer rows with garbage outside each pair's walk."""
    H_pad, L_pad, numT = 46, 24, 7
    args, bounds = edge_inputs(B=9, H_pad=H_pad, L_pad=L_pad, numT=numT,
                               dtype=dtype, seed=seed, device="cpu",
                               b_mid=b_mid)
    amid, bmid, btf, btb = [t.numpy() for t in dp_ref(
        *args, exact_ties=exact, bounds=bounds)]
    rng = np.random.RandomState(seed + 100)
    B, S = amid.shape
    dt = amid.dtype

    def grid(lo, hi):
        a = np.round(rng.uniform(lo, hi, size=(B, S)) * 4) / 4
        a[rng.rand(B, S) < 0.1] = NEGBIG
        return a.astype(dt)

    hl, rl, bm = (args[i].numpy() for i in (3, 4, 5))
    btf, btb = _garbage_bt(btf, btb, bm, rl, rng)
    obs, prm, phm = grid(-2, 0), grid(-3, 0), grid(-3, 0)
    if dt == np.float64:
        # near-ties within EPS after the maximum, where the exact fold
        # keeps the first state and the fast fold takes the later one
        base = (amid + obs) + bmid
        for pr in (prm, phm):
            for i in range(0, B, 2):
                x1 = int(np.argmax(base[i] + pr[i]))
                x2 = x1 + 1 + rng.randint(S - x1 - 1) if x1 < S - 1 else x1
                pr[i, x2] = (base[i, x1] + pr[i, x1] + 5e-11) - base[i, x2]
    return dict(H_pad=H_pad, L_pad=L_pad, numT=numT, b_mid=bm, hap_len=hl,
                read_len=rl, alpha=amid, beta=bmid, obs=obs, prm=prm,
                phm=phm, btf=btf, btb=btb)


def _fin_args(c, to):
    return (c["H_pad"], c["L_pad"], c["numT"], to(c["b_mid"]),
            to(c["hap_len"]), to(c["alpha"]), to(c["beta"]), to(c["obs"]),
            to(c["prm"]), to(c["phm"]), to(c["btf"]), to(c["btb"]))


def _plain_finish(c, exact):
    return [o.numpy() for o in plain_finish(*_fin_args(c, torch.from_numpy),
                                            exact_ties=exact)]


def _valid(c):
    return np.arange(c["L_pad"])[None, :] < c["read_len"][:, None]


def _assert_finish_equal(a, b, valid=None):
    """Equal outputs (NaN equal to NaN, a zero to a zero of either sign);
    map_state on the `valid` columns."""
    for nm, x, y in zip(FIN_NAMES, a, b):
        x, y = np.asarray(x), np.asarray(y)
        if nm == "map_state" and valid is not None:
            x, y = np.where(valid, x, -1), np.where(valid, y, -1)
        assert x.dtype == y.dtype, nm
        assert np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), nm


def _jax_finish(c, exact):
    return [np.asarray(o) for o in _finish(
        c["H_pad"], c["L_pad"], jnp.asarray(c["b_mid"]),
        *[jnp.asarray(c[k]) for k in ("alpha", "beta", "obs", "prm", "phm",
                                      "btf", "btb")],
        exact_ties=exact, bt_codes=True, numT=c["numT"],
        hap_len=jnp.asarray(c["hap_len"]))]


def _assert_first_bits(c, out):
    """ll, ll_off and ll_on carry the bits of the first column (of the
    row, of the xm == 0 columns, of the other on-hap columns) that holds
    their value: the sequential fold's rule, signed zeros included (and
    the first NaN's bits, where a NaN wins)."""
    vr = (c["alpha"] + c["obs"]) + c["beta"] + c["prm"]
    S = vr.shape[1]
    xm = np.arange(S) % (S // 2)
    sets = (np.ones(S, bool), xm == 0, (xm != 0) & (xm != S // 2 - 1))
    for name, got, cols in zip(("ll", "ll_off", "ll_on"),
                               (out[0], out[3], out[4]), sets):
        for i, val in enumerate(got):
            row = vr[i][cols]
            same = np.isnan(row) if np.isnan(val) else row == val
            if same.any():
                assert _bits(row[np.argmax(same)]) == _bits(val), (name, i)


FOLDS = [(np.float32, False), (np.float64, True), (np.float32, True),
         (np.float64, False)]
FOLD_IDS = ["f32-fast", "f64-exact", "f32-exact", "f64-fast"]


@pytest.mark.parametrize("b_mid", ["rand", "zero", "last"])
@pytest.mark.parametrize("dtype,exact", FOLDS, ids=FOLD_IDS)
def test_finish_walk_matches_plain_and_jax(dtype, exact, b_mid):
    c = finish_case("float32" if dtype == np.float32 else "float64", exact,
                    b_mid, seed=3)
    plain = _plain_finish(c, exact)
    valid = _valid(c)
    # the kernel with read_len walks only consumed rows
    model = model_finish(*_fin_args(c, lambda a: a), exact,
                         read_len=c["read_len"])
    _assert_finish_equal(model, plain, valid)
    # without read_len it walks every row as the plain version does: equal
    # everywhere, garbage columns included (the floor modulo)
    _assert_finish_equal(model_finish(*_fin_args(c, lambda a: a), exact),
                         plain)
    _assert_finish_equal(_jax_finish(c, exact), plain, valid)
    if dtype == np.float64:  # the near-ties tell the two folds apart
        other = _plain_finish(c, not exact)
        assert not np.array_equal(plain[0], other[0])
    assert b_mid != "zero" or (c["b_mid"] == 0).all()
    assert b_mid != "last" or (c["b_mid"] == c["read_len"] - 1).all()




@pytest.mark.parametrize("kind", SPECIALS)
@pytest.mark.parametrize("dtype,exact", FOLDS, ids=FOLD_IDS)
def test_finish_model_special_values(dtype, exact, kind):
    """Rows planted in vr and vh (alpha = beta = obs = -0.0, so v is the
    prior row bit for bit): the model equal to the plain version and to
    JAX, and each fold value carrying its first column's bits."""
    name = "float32" if dtype == np.float32 else "float64"
    c = finish_case(name, exact, "rand", seed=8)
    B, S = c["alpha"].shape
    dt = c["alpha"].dtype.type
    rng = np.random.RandomState(SPECIALS.index(kind))
    for k in ("alpha", "beta", "obs"):
        c[k] = np.full((B, S), -0.0, dt)
    c["prm"] = special_rows(kind, B, S, dt, rng)
    c["phm"] = np.roll(special_rows(kind, B, S, dt, rng), 3, axis=1)
    plain = _plain_finish(c, exact)
    valid = _valid(c)
    model = model_finish(*_fin_args(c, lambda a: a), exact,
                         read_len=c["read_len"])
    _assert_finish_equal(model, plain, valid)
    _assert_finish_equal(_jax_finish(c, exact), plain, valid)
    _assert_first_bits(c, model)
    if kind == "nan":
        assert np.isnan(model[0]).all() != exact
    if kind == "near" and dtype == np.float64:  # the folds differ here
        other = model_finish(*_fin_args(c, lambda a: a), not exact,
                             read_len=c["read_len"])
        assert not np.array_equal(model[0], other[0])
    if kind == "pm0":  # both signs of zero won somewhere
        assert {bool(x) for x in np.signbit(model[0])} == {True, False}
        assert {bool(x) for x in np.signbit(model[3])} == {True, False}
    if kind == "ninf":  # odd rows hold one NaN, which the fast fold takes
        for i, v in enumerate(model[0]):
            assert np.isnan(v) if i % 2 and not exact else v == -np.inf


@pytest.mark.parametrize("dtype,exact", FOLDS[:2], ids=FOLD_IDS[:2])
def test_finish_consumed_columns_ignore_garbage(dtype, exact):
    c = finish_case("float32" if dtype == np.float32 else "float64", exact,
                    "rand", seed=4)
    a = _plain_finish(c, exact)
    rng = np.random.RandomState(9)
    c["btf"], c["btb"] = _garbage_bt(c["btf"], c["btb"], c["b_mid"],
                                     c["read_len"], rng)
    b = _plain_finish(c, exact)
    _assert_finish_equal(a, b, _valid(c))
    # and the garbage does reach the columns past the reads
    assert not np.array_equal(a[5], b[5])


def _slab(dtype=np.float64, H_pad=78):
    windows = synth_windows(3, nh=3, nr=12, H=60, L=30, seed=2)
    params = ObservationModelParameters()
    return pad_compact(merge_compact([
        pack_pairs_compact(haps, reads, hs, params, dtype, H_pad=H_pad,
                           L_pad=32)
        for haps, reads, hs in windows]))


def _vtab(pk, V, seed=5):
    """Slots with mixed widths: flanks at the LO/RO sentinel codes (-3,
    -4), reaching below 0 (the negative-index wrap), invalid slots."""
    rng = np.random.RandomState(seed)
    n = pk["hap_codes_h"].shape[0]
    left = rng.randint(-4, 50, size=(n, V)).astype(np.int32)
    if V:
        left[::3, 0] = -4
        left[1::3, 0] = -3
    return dict(v_left_h=left,
                v_right_h=(left + rng.randint(0, 8, size=(n, V))
                           ).astype(np.int32),
                v_isdel_h=rng.rand(n, V) < 0.5,
                v_valid_h=rng.rand(n, V) < 0.8)


STAT_TABLES = ("read_len", "hap_len", "read_idx", "hap_idx", "read_codes_r",
               "hap_codes_h", "bqt_r", "q95_r", "log10q_r")
VKEYS = ("v_left_h", "v_right_h", "v_isdel_h", "v_valid_h")


def _stats_case(exact, V, seed=7, kind="decoded"):
    """A slab's MAP paths ("decoded": the plain finish's on the CPU), or
    random states with random base-quality flags ("random": many indel
    events, repeated event positions, masked m_log_bq terms)."""
    pk = _slab()
    out = run_slab_decode(pk, exact, "cpu")
    ms = out[5].to(torch.int32).numpy().copy()
    rng = np.random.RandomState(seed)
    if kind == "random":
        S = 2 * (pk["H_pad"] + 2)
        runs = rng.randint(0, S, size=ms.shape)
        # mostly steps along the hap, with jumps and insert runs
        walk = np.cumsum(rng.choice([1, 1, 1, 0, 2, 3], size=ms.shape),
                         axis=1) + rng.randint(0, 20, size=(ms.shape[0], 1))
        ms = np.where(rng.rand(*ms.shape) < 0.15, runs, walk).astype(np.int32)
        pk = dict(pk, bqt_r=pk["bqt_r"] & (rng.rand(*pk["bqt_r"].shape) < .7),
                  q95_r=pk["q95_r"] & (rng.rand(*pk["q95_r"].shape) < .7))
    # garbage past each read (the kernel holds a state there; the plain
    # finish decodes unwritten rows)
    past = np.arange(pk["L_pad"])[None, :] >= pk["read_len"][:, None]
    ms[past] = rng.randint(-40, 2 * (pk["H_pad"] + 2) + 40, size=past.sum())
    return pk, ms, out[2].numpy(), _vtab(pk, V)


def _plain_stats(pk, ms, off_hmq, vtab, V):
    t = (tables_to_device(pk, "cpu") if "eq_r" in pk  # a packed slab
         else {k: torch.from_numpy(pk[k]) for k in STAT_TABLES})
    return [o.numpy() for o in plain_pair_stats(
        pk["H_pad"], pk["L_pad"], V, torch.from_numpy(ms),
        *[t[k] for k in STAT_TABLES],
        *[torch.from_numpy(vtab[k]) for k in VKEYS],
        torch.from_numpy(off_hmq), MAX_MM)]


def _same_stats(a, b):
    """Equal outputs: integers and flags exactly, floats bit for bit with
    NaN equal to NaN."""
    if a.shape != b.shape:
        return False
    if a.dtype != np.float64:
        return np.array_equal(a, b)
    nan = np.isnan(a)
    return (np.array_equal(nan, np.isnan(b))
            and np.array_equal(a[~nan].view(np.int64), b[~nan].view(np.int64)))


def _edge_stats_case(kw):
    """chip_smoke.STATS_EDGE_CASES row `kw`: (H_pad, tables, map_state,
    off_hap_hmq, slot tables) in _stats_case's form."""
    H_pad, a = stats_edge_arrays(**kw)
    pk = dict({k: a[k] for k in STAT_TABLES}, H_pad=H_pad,
              L_pad=kw["L_pad"])
    return pk, a["map_state"], a["off_hap_hmq"], {k: a[k] for k in VKEYS}


# (exact, V, kind): slabs' decoded paths and random states in both folds,
# then chip_smoke.STATS_EDGE_CASES (no fold: their paths are made)
STATS_CASES = ([(e, v, k) for e in (False, True) for v in (0, 4)
                for k in ("decoded", "random")]
               + [(False, kw["V"], name) for name, kw in STATS_EDGE_CASES])


@pytest.mark.parametrize("exact,V,kind", STATS_CASES,
                         ids=[f"{e}-{v}-{k}" for e, v, k in STATS_CASES])
def test_pair_stats_walk_matches_plain_and_jax(exact, V, kind):
    edge = dict(STATS_EDGE_CASES).get(kind)
    pk, ms, off_hmq, vtab = (_edge_stats_case(edge) if edge
                             else _stats_case(exact, V, kind=kind))
    plain = _plain_stats(pk, ms, off_hmq, vtab, V)
    model = model_pair_stats(pk["H_pad"], pk["L_pad"], V, ms,
                             *[np.asarray(pk[k]) for k in STAT_TABLES],
                             *[vtab[k] for k in VKEYS], off_hmq, MAX_MM)
    want = _pair_stats(pk["H_pad"], pk["L_pad"], V, jnp.asarray(ms),
                       *[jnp.asarray(pk[k]) for k in STAT_TABLES],
                       *[jnp.asarray(vtab[k]) for k in VKEYS],
                       jnp.asarray(off_hmq), jnp.asarray(np.int32(MAX_MM)))
    for nm, p, w, j in zip(STAT_NAMES, plain, model, want):
        assert _same_stats(p, w), nm
        assert _same_stats(p, np.asarray(j)), nm
    assert plain[-1].shape == (ms.shape[0], V)
    if V and kind != "random":
        assert plain[-1].any()  # the coverage fold is exercised
    assert plain[10].any() and plain[8].any()  # n_ind, has_event
    if kind != "decoded":  # repeated event positions are collapsed
        assert (plain[10] > 0).any() and not np.array_equal(
            plain[10], _events(pk, ms))
    if edge:  # NaN, +-inf and -0.0 terms reach the sum
        assert np.isnan(plain[4]).any() and np.isinf(plain[4]).any()


def _events(pk, ms):
    """Indel-event entries per pair, repeats included (what n_ind would
    count without collapsing equal positions)."""
    SP, RO = pk["H_pad"] + 2, pk["H_pad"] + 1
    out = []
    for i in range(ms.shape[0]):
        hl, rl = int(pk["hap_len"][i]), int(pk["read_len"][i])
        xa = ms[i] % SP
        xs = np.where(xa == RO, hl + 1, xa)
        ins = ms[i] >= SP
        on = (xs >= 1) & (xs <= hl) & (np.arange(len(xs)) < rl)
        n, seen = 0, False
        for b in range(len(xs)):
            inhap = ins[b] and on[b]
            entry = inhap and not seen
            seen = ins[b] and (seen or inhap)
            dl = (b + 1 < min(rl, len(xs)) and on[b] and not ins[b]
                  and not ins[b + 1] and xs[b + 1] - xs[b] > 1)
            n += entry or dl
        out.append(n)
    return np.array(out, np.int32)


def test_pair_stats_ignore_columns_past_the_read():
    pk, ms, off_hmq, vtab = _stats_case(False, 4)
    a = _plain_stats(pk, ms, off_hmq, vtab, 4)
    past = np.arange(pk["L_pad"])[None, :] >= pk["read_len"][:, None]
    ms2 = ms.copy()
    ms2[past] = np.random.RandomState(1).randint(0, 2 * (pk["H_pad"] + 2),
                                                 size=past.sum())
    b = _plain_stats(pk, ms2, off_hmq, vtab, 4)
    for nm, x, y in zip(STAT_NAMES, a, b):
        assert np.array_equal(x, y), nm


def _window_case(dtype, seed=0):
    rng = np.random.RandomState(seed)
    W, NH, S, NR = 3, 4, 3, 16
    NP = len(pair_enum(NH)[0])
    ll = -rng.gamma(2.0, 40.0, size=W * NH * NR).astype(np.float32)
    index_map = np.zeros((W, NH, NR), np.int32)
    nr_w = np.array([NR, 11, 0], np.int32)
    for w in range(W):
        index_map[w, :, :nr_w[w]] = (w * NH * NR + np.arange(NH)[:, None]
                                     * NR + np.arange(nr_w[w])[None, :])
    pair_pr = (-rng.rand(W, S, NP) * 10).astype(dtype)
    pair_pr[0, 0, 0] = pair_pr[2, 0, 0] = -0.0
    return W, NH, S, NR, ll, index_map, nr_w, pair_pr


@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-6),
                                        (np.float64, 1e-12)])
def test_window_call_walk_matches_plain_and_jax(dtype, rtol):
    W, NH, S, NR, ll, im, nr_w, pp = _window_case(dtype)
    pb, ps = plain_window(W, NH, S, NR, torch.from_numpy(ll),
                          torch.from_numpy(im), torch.from_numpy(nr_w),
                          torch.from_numpy(pp))
    # the kernel's loop order with torch's exp/log: bit-equal
    mb, ms = model_window_call(W, NH, S, NR, ll, im, nr_w, pp, 2, 32,
                               torch_term)
    assert _bits(mb) == _bits(pb.numpy()) and _bits(ms) == _bits(ps.numpy())
    # with NumPy's exp/log, and JAX, to the libm tolerance
    wb, ws = model_window_call(W, NH, S, NR, ll, im, nr_w, pp, 2, 32,
                               numpy_term)
    jb, js = _window_call(W, NH, S, NR, jnp.asarray(ll), jnp.asarray(im),
                          jnp.asarray(nr_w), jnp.asarray(pp))
    for got in ((wb, ws), (np.asarray(jb), np.asarray(js))):
        np.testing.assert_allclose(got[0], pb.numpy(), rtol=rtol)
        np.testing.assert_allclose(got[1], ps.numpy(), rtol=rtol)
    assert wb.dtype == pb.numpy().dtype == dtype
    # a window without reads keeps its seeds: base 0, site = pair_pr, but
    # a -0.0 seed comes out +0.0 (the masked reads each add +0.0)
    assert (pb[2] == 0).all() and torch.equal(ps[2], torch.from_numpy(pp[2]))
    assert not np.signbit(ms[2, 0, 0]) and np.signbit(pp[2, 0, 0])


@pytest.mark.parametrize("R", [5, 7, 19, 32])
@pytest.mark.parametrize("KT", [1, 4])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_window_call_model_chunks(dtype, KT, R):
    """The kernel's loop order at several pairs a block (KT; 4 does not
    divide the 15 pairs, and its tiles span hap rows) and reads a chunk
    (R; NR = 19 is a multiple of none but itself): base and site
    bit-equal to the plain version, NaN terms and signed zeros included,
    and to JAX to the libm tolerance."""
    W, NH, S, NR, ll, im, nr_w, pp = window_special_case(dtype)
    pb, ps = plain_window(W, NH, S, NR, torch.from_numpy(ll),
                          torch.from_numpy(im), torch.from_numpy(nr_w),
                          torch.from_numpy(pp))
    assert torch.isnan(pb).any()  # NaN terms reach the sums
    mb, ms = model_window_call(W, NH, S, NR, ll, im, nr_w, pp, KT, R,
                               torch_term)
    assert _bits(mb) == _bits(pb.numpy()) and _bits(ms) == _bits(ps.numpy())
    jb, js = _window_call(W, NH, S, NR, jnp.asarray(ll), jnp.asarray(im),
                          jnp.asarray(nr_w), jnp.asarray(pp))
    rtol = 1e-6 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(np.asarray(jb), mb, rtol=rtol)
    np.testing.assert_allclose(np.asarray(js), ms, rtol=rtol)
    assert not np.signbit(ms[2, 1, 3])  # nr_w 0: -0.0 + 0.0


# ---------------------------------------------------------------------------
# the wrappers on the CPU


def _launches():
    return (ek.finish.launches, ek.pair_stats.launches,
            ek.window_call.launches)


@pytest.mark.parametrize("dtype,exact", FOLDS[:2], ids=FOLD_IDS[:2])
def test_wrappers_on_cpu_are_the_plain_versions(dtype, exact):
    before = _launches()
    c = finish_case("float32" if dtype == np.float32 else "float64", exact,
                    "rand", seed=5)
    args = _fin_args(c, torch.from_numpy)
    want = plain_finish(*args, exact_ties=exact)
    for kw in ({}, {"read_len": torch.from_numpy(c["read_len"])}):
        got = ek.finish(*args, exact_ties=exact, **kw)
        for nm, g, w in zip(FIN_NAMES, got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), nm

    pk, ms, off_hmq, vtab = _stats_case(exact, 4)
    t = tables_to_device(pk, "cpu")
    sargs = (pk["H_pad"], pk["L_pad"], 4, torch.from_numpy(ms),
             *[t[k] for k in STAT_TABLES],
             *[torch.from_numpy(vtab[k]) for k in VKEYS],
             torch.from_numpy(off_hmq), MAX_MM)
    for g, w in zip(ek.pair_stats(*sargs), plain_pair_stats(*sargs)):
        assert g.dtype == w.dtype and torch.equal(g, w)

    W, NH, S, NR, ll, im, nr_w, pp = _window_case(dtype)
    wargs = (W, NH, S, NR, torch.from_numpy(ll), torch.from_numpy(im),
             torch.from_numpy(nr_w), torch.from_numpy(pp))
    for g, w in zip(ek.window_call(*wargs), plain_window(*wargs)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert _launches() == before


def test_wrappers_refuse_other_devices():
    n0 = ek.noop.launches
    with pytest.raises(ValueError, match="no kernel to launch on cpu"):
        ek.noop("cpu")  # the launch floor's empty kernel is CUDA only
    assert ek.noop.launches == n0
    meta = torch.empty((2, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ek.window_call(1, 1, 1, 1, torch.empty(2, device="meta"),
                       torch.empty((1, 1, 1), dtype=torch.int32,
                                   device="meta"),
                       torch.empty(1, dtype=torch.int32, device="meta"),
                       torch.empty((1, 1, 1), device="meta"))
    with pytest.raises(ValueError, match="several devices"):
        ek.finish(2, 3, 7, torch.zeros(2, dtype=torch.int32),
                  torch.zeros(2, dtype=torch.int32), meta, meta, meta, meta,
                  meta, torch.zeros((2, 2, 4), dtype=torch.uint8),
                  torch.zeros((2, 2, 4), dtype=torch.uint8))


@pytest.mark.parametrize("module", [ek, dp_kernel], ids=["epilogue", "dp"])
def test_build_without_nvcc_raises(module, monkeypatch, tmp_path):
    monkeypatch.setattr(nvcc_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(nvcc_build, "CUDA_NVCC", str(tmp_path / "nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        nvcc_build.build_library("probe", module.SOURCE,
                                 nvcc_build.NVCC_FLAGS, module.VARIANTS,
                                 "the probe", build_dir=tmp_path / "build")
    assert not (tmp_path / "build").exists()


def test_library_names_follow_the_source(tmp_path):
    """The library is keyed by a hash of its source, flags and variants,
    and an existing library is returned without a build (no nvcc here)."""
    src = tmp_path / "k.cu"
    src.write_text("// a kernel\n")
    digest = hashlib.sha1(src.read_bytes() + repr(
        (list(nvcc_build.NVCC_FLAGS), {"a": ["-DA"]})).encode()).hexdigest()
    so = tmp_path / "build" / f"libk_{digest[:16]}.so"
    so.parent.mkdir()
    so.write_bytes(b"")
    assert nvcc_build.build_library("k", src, nvcc_build.NVCC_FLAGS,
                                    {"a": ["-DA"]}, "k",
                                    build_dir=tmp_path / "build") == so


def _ctype_of(a):
    import ctypes
    if a is None or isinstance(a, torch.Tensor):
        return ctypes.c_void_p
    return ctypes.c_double if isinstance(a, float) else ctypes.c_int


@pytest.mark.parametrize("dtype,exact", FOLDS, ids=FOLD_IDS)
def test_launch_arguments_match_the_entry_points(dtype, exact):
    """What each wrapper hands its entry point on a card, built here from
    CPU tensors: the argument checks pass, the arguments match the C
    signature one for one (the stream is appended at the launch), and
    the outputs have the plain versions' shapes and dtypes."""
    c = finish_case("float32" if dtype == np.float32 else "float64", exact,
                    "rand", seed=6)
    args = _fin_args(c, torch.from_numpy)
    calls = [(ek.finish_args(*args, exact, torch.from_numpy(c["read_len"])),
              plain_finish(*args, exact_ties=exact)),
             (ek.finish_args(*args, exact), None)]
    pk, ms, off_hmq, vtab = _stats_case(exact, 4)
    t = tables_to_device(pk, "cpu")
    sargs = (pk["H_pad"], pk["L_pad"], 4, torch.from_numpy(ms),
             *[t[k] for k in STAT_TABLES],
             *[torch.from_numpy(vtab[k]) for k in VKEYS],
             torch.from_numpy(off_hmq), MAX_MM)
    calls.append((ek.pair_stats_args(*sargs), plain_pair_stats(*sargs)))
    W, NH, S, NR, ll, im, nr_w, pp = _window_case(dtype)
    wargs = (W, NH, S, NR, torch.from_numpy(ll), torch.from_numpy(im),
             torch.from_numpy(nr_w), torch.from_numpy(pp))
    calls.append((ek.window_call_args(*wargs), plain_window(*wargs)))
    for (entry, cargs, outs), want in calls:
        sig = ek.SIGNATURES[entry]
        assert [_ctype_of(a) for a in cargs] == sig[:-1], entry
        if want is not None:
            assert [(o.shape, o.dtype) for o in outs] == [
                (w.shape, w.dtype) for w in want], entry
    assert calls[0][0][0] == ("dindel_finish_"
                              f"{'f32' if dtype == np.float32 else 'f64'}_"
                              f"{'exact' if exact else 'fast'}")
    assert calls[1][0][1][2] is None  # no read_len: the full walk


def test_launch_argument_checks():
    c = finish_case("float32", False, "rand", seed=6)
    args = list(_fin_args(c, torch.from_numpy))
    bad = list(args)
    bad[5] = bad[5].double()  # alpha_mid of another dtype than the rows
    with pytest.raises(TypeError, match="beta_mid"):
        ek.finish_args(*bad)
    bad = list(args)
    bad[6] = bad[6].t().contiguous().t()  # beta_mid not contiguous
    with pytest.raises(ValueError, match="beta_mid: not contiguous"):
        ek.finish_args(*bad)
    bad = list(args)
    bad[10] = bad[10][:-1]  # btf short of a row
    with pytest.raises(ValueError, match="btf: shape"):
        ek.finish_args(*bad)
    with pytest.raises(ValueError, match="numT"):
        ek.finish_args(*args[:2], 16, *args[3:])
    W, NH, S, NR, ll, im, nr_w, pp = _window_case(np.float32)
    with pytest.raises(TypeError, match="window_call: dtype"):
        ek.window_call_args(W, NH, S, NR, torch.from_numpy(ll),
                            torch.from_numpy(im), torch.from_numpy(nr_w),
                            torch.from_numpy(pp).half())
    pk, ms, off_hmq, vtab = _stats_case(False, 4)
    t = tables_to_device(pk, "cpu")
    tabs = [t[k] for k in STAT_TABLES]
    tabs[-1] = tabs[-1].float()  # log10q_r must be float64
    with pytest.raises(TypeError, match="log10q_r"):
        ek.pair_stats_args(pk["H_pad"], pk["L_pad"], 4, torch.from_numpy(ms),
                           *tabs, *[torch.from_numpy(vtab[k]) for k in VKEYS],
                           torch.from_numpy(off_hmq), MAX_MM)
