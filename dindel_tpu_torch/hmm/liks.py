"""The liks matrices the callers consume: JAX-free counterparts of
``dindel_tpu.hmm.batch.LiksView``, ``_LazyRow`` and ``decode_liks_view``
(batch.py:1363-1795, the full-decode route: host decode of the fetched
map_state, through ``native/decode.cpp`` when it builds, else numpy)
and of ``LiksStats`` (batch.py:1950, the device-call route).  The code
is the original's; tests/test_torch_decode.py and
tests/test_torch_host.py hold each to it."""

from __future__ import annotations

from typing import List

import numpy as np

from ..config import ObservationModelParameters
from ..model import Haplotype, MLAlignment, Read


class LiksStats:
    """Stats-only liks matrix: the device-computed per-pair scalars the
    callers (diploid, filter, guards) consume — no map_state planes, no
    per-base decode.  Exposes the same array attributes as LiksView;
    per-pair MLAlignments are unavailable (realigned-BAM and --opl
    windows take the full-decode route, LiksView)."""

    def __init__(self, haps, reads, p, read_len, hap_len, fetched: dict):
        self.haps = haps
        self.reads = reads
        self.p = p
        self.nh = len(haps)
        self.nr = len(reads)
        self.read_len = read_len
        self._hap_len = hap_len
        self.ll = np.asarray(fetched["ll"], np.float64)
        self.off_hap = np.asarray(fetched["off_hap"], bool)
        self.off_hap_hmq = np.asarray(fetched["off_hap_hmq"], bool)
        self.ll_off = np.asarray(fetched["ll_off"], np.float64)
        self.ll_on = np.asarray(fetched["ll_on"], np.float64)
        self.fb = np.asarray(fetched["fb"], np.int64)
        self.lb = np.asarray(fetched["lb"], np.int64)
        self.n_bqt = np.asarray(fetched["n_bqt"], np.int64)
        self.n_mm_bqt = np.asarray(fetched["n_mm_bqt"], np.int64)
        self.m_log_bq = np.asarray(fetched["m_log_bq"], np.float64)
        self.n_mm_left = np.asarray(fetched["n_mm_left"], np.int64)
        self.n_mm_right = np.asarray(fetched["n_mm_right"], np.int64)
        self.num_mm = np.asarray(fetched["num_mm"], np.int64)
        self.has_event = np.asarray(fetched["has_event"], bool)
        self.any_mism = np.asarray(fetched["any_mism"], bool)
        self._n_ind = np.asarray(fetched["n_ind"], np.int64)
        self.cov_ok = np.asarray(fetched["cov_ok"], bool)

    @property
    def ll2d(self):
        return self.ll.reshape(self.nh, self.nr)

    @property
    def off_hap2d(self):
        return self.off_hap.reshape(self.nh, self.nr)

    @property
    def off_hap_hmq2d(self):
        return self.off_hap_hmq.reshape(self.nh, self.nr)

    def n_indel_entries_row(self, h: int) -> np.ndarray:
        return self._n_ind[h * self.nr:(h + 1) * self.nr]

    def __len__(self):
        return self.nh

    def __getitem__(self, h):
        raise TypeError(
            "LiksStats has no per-pair MLAlignments (map_state was not "
            "fetched); use the full-decode path for per-pair consumers")


class LiksView:
    """Array-backed liks matrix (nh x nr) over the device outputs.

    Callers that understand it (infer/, engine/) consume whole-matrix
    arrays (``ll2d``, ``off_hap2d``, ...) directly; ``liks[h][r]`` still
    yields a full MLAlignment, materialized lazily and cached, so every
    per-pair consumer (realigned-BAM CIGARs, --opl dumps, oracle-parity
    tests) keeps working unchanged.  tests/test_torch_decode.py holds
    the arrays and the materialized MLAlignments equal to the
    original's, on both inits.

    ``pk`` needs H_pad, L_pad, hap_len, read_len and the dense per-pair
    code tables hap_codes (B, H_pad) and read_codes (B, L_pad)."""

    def __init__(self, haps: List[Haplotype], reads: List[Read],
                 pk: dict, ll, off_hap, off_hap_hmq, ll_off, ll_on,
                 map_state, p: ObservationModelParameters):
        self.haps = haps
        self.reads = reads
        self.p = p
        nh, nr = len(haps), len(reads)
        self.nh = nh
        self.nr = nr
        H_pad = pk["H_pad"]
        L_pad = pk["L_pad"]
        self.H_pad = H_pad
        self.L_pad = L_pad
        self.read_len = pk["read_len"]
        self._hap_len = pk["hap_len"]
        self._ms = np.asarray(map_state)
        self._pk_read_codes = pk["read_codes"]
        self._pk_hap_codes = pk["hap_codes"]

        self.ll = np.asarray(ll, np.float64)
        self.off_hap = np.asarray(off_hap, bool)
        self.off_hap_hmq = np.asarray(off_hap_hmq, bool)
        self.ll_off = np.asarray(ll_off, np.float64)
        self.ll_on = np.asarray(ll_on, np.float64)
        # lazily-derived (B, L_pad) matrices; the native decode fills
        # xs/hpos directly and only per-pair consumers (events, SNP
        # reports) ever force the rest
        self._ins_all = None
        self._del_ev = None
        self._mism = None
        self._noins_on = None

        qual_b = np.zeros((nr, L_pad))
        for ri, r in enumerate(reads):
            qual_b[ri, :r.size()] = r.qual
        with np.errstate(divide="ignore"):
            log10q = np.log10(np.maximum(1.0 - qual_b, 1e-300))
        self._qual_r = qual_b  # (nr, L_pad); pair i uses row i % nr

        from .decode_native import native_lib as _dec_lib
        if _dec_lib() is not None:
            self._init_native(_dec_lib(), qual_b, log10q)
        else:
            self._init_numpy(qual_b, log10q)
        # indel events are enumerated lazily per pair (has_event flags
        # which pairs carry any; a pair has num_indels == 0 iff not
        # has_event, which is what the filter/selection logic needs)
        self._events = {}
        self._nind_rows = {}
        self._cache = {}

    def _init_native(self, lib, qual_b: np.ndarray, log10q: np.ndarray):
        """One C pass (native/decode.cpp) producing the same arrays as
        _init_numpy."""
        B = self.nh * self.nr
        L_pad, H_pad = self.L_pad, self.H_pad
        ms = np.ascontiguousarray(self._ms, np.int16)
        read_len = np.ascontiguousarray(self.read_len, np.int32)
        hap_len = np.ascontiguousarray(self._hap_len, np.int32)
        rc = np.ascontiguousarray(self._pk_read_codes, np.uint8)
        hc = np.ascontiguousarray(self._pk_hap_codes, np.uint8)
        xs = np.empty((B, L_pad), np.int32)
        hpos = np.empty((B, L_pad), np.int32)
        del_ev = np.empty((B, L_pad - 1), np.uint8)
        i64 = lambda: np.empty(B, np.int64)
        n_bqt, n_mm_bqt, n_mm_left, n_mm_right, num_mm, fb, lb = (
            i64(), i64(), i64(), i64(), i64(), i64(), i64())
        m_log_bq = np.empty(B, np.float64)
        has_event = np.empty(B, np.uint8)
        any_mism = np.empty(B, np.uint8)
        lib.ddec_stats(B, L_pad, H_pad, self.nr, ms, read_len, hap_len,
                       rc, hc, np.ascontiguousarray(qual_b),
                       np.ascontiguousarray(log10q),
                       float(self.p.check_base_qual_threshold),
                       xs, hpos, del_ev, n_bqt, n_mm_bqt, n_mm_left,
                       n_mm_right, num_mm, m_log_bq, fb, lb, has_event,
                       any_mism)
        self._del_ev = del_ev.view(bool)
        self.xs = xs
        self.hpos_all = hpos
        self.fb = fb
        self.lb = lb
        self.n_bqt = n_bqt
        self.n_mm_bqt = n_mm_bqt
        self.n_mm_left = n_mm_left
        self.n_mm_right = n_mm_right
        self.num_mm = num_mm
        self.m_log_bq = m_log_bq
        self.has_event = has_event.astype(bool)
        self.any_mism = any_mism.astype(bool)

    def _init_numpy(self, qual_b: np.ndarray, log10q: np.ndarray):
        from ..model import HPOS_LO, HPOS_RO

        nh, nr = self.nh, self.nr
        H_pad, L_pad = self.H_pad, self.L_pad
        B = nh * nr
        S_half_f = H_pad + 2
        hap_len = self._hap_len
        read_len = self.read_len
        map_state = self._ms
        ins_all = map_state >= S_half_f
        x_all = map_state % S_half_f
        ROh_all = (hap_len + 1)[:, None]
        xs = np.where(x_all == H_pad + 1, ROh_all, x_all)
        col = np.arange(L_pad)[None, :]
        validc = col < read_len[:, None]
        on = (xs >= 1) & (xs <= hap_len[:, None]) & validc
        ins_ev = ins_all & on
        noins_on = on & ~ins_all
        del_ev = (noins_on[:, :-1] & ~ins_all[:, 1:]
                  & (col[:, 1:] < read_len[:, None])
                  & (xs[:, 1:] - xs[:, :-1] > 1))
        has_event = ins_ev.any(axis=1) | del_ev.any(axis=1)

        hpos_all = np.where(noins_on, xs - 1,
                            np.where(xs == 0, HPOS_LO, HPOS_RO))
        big = np.iinfo(np.int32).max
        fb_all = np.where(noins_on, xs - 1, big).min(axis=1)
        fb_all = np.where(fb_all == big, -1, fb_all)
        lb_all = np.where(noins_on, xs - 1, -1).max(axis=1)

        qual_t = np.tile(qual_b, (nh, 1))
        bqt = noins_on & (qual_t > self.p.check_base_qual_threshold)
        hc = np.take_along_axis(self._pk_hap_codes,
                                np.clip(xs - 1, 0, H_pad - 1), axis=1)
        mism = noins_on & (self._pk_read_codes != hc)
        n_bqt_all = bqt.sum(axis=1)
        n_mm_bqt_all = (mism & bqt).sum(axis=1)
        n_mm_left_all = (mism & (col < 6)).sum(axis=1)
        n_mm_right_all = (mism & (col > read_len[:, None] - 6)).sum(axis=1)
        num_mm_all = (mism & (qual_t > 0.95)).sum(axis=1)
        # sequential (loop-order) float accumulation for bit-parity with
        # the per-base loop: column-at-a-time adds, masked terms as +0.0
        log10q_t = np.where(bqt, np.tile(log10q, (nh, 1)), 0.0)
        mlogbq_all = np.zeros(B)
        for b in range(L_pad):
            mlogbq_all = mlogbq_all + log10q_t[:, b]

        self.xs = xs
        self._ins_all = ins_all
        self._del_ev = del_ev
        self._noins_on = noins_on
        self.has_event = has_event
        self.any_mism = mism.any(axis=1)
        self._mism = mism
        self.hpos_all = hpos_all
        self.fb = fb_all
        self.lb = lb_all
        self.n_bqt = n_bqt_all
        self.n_mm_bqt = n_mm_bqt_all
        self.n_mm_left = n_mm_left_all
        self.n_mm_right = n_mm_right_all
        self.num_mm = num_mm_all
        self.m_log_bq = mlogbq_all

    # --- lazily-derived (B, L_pad) matrices (native init skips them) ---

    @property
    def ins_all(self):
        if self._ins_all is None:
            self._ins_all = self._ms >= (self.H_pad + 2)
        return self._ins_all

    @property
    def noins_on(self):
        if self._noins_on is None:
            col = np.arange(self.L_pad)[None, :]
            validc = col < self.read_len[:, None]
            xs = self.xs
            on = (xs >= 1) & (xs <= self._hap_len[:, None]) & validc
            self._noins_on = on & ~self.ins_all
        return self._noins_on

    @property
    def del_ev(self):
        if self._del_ev is None:
            col = np.arange(self.L_pad)[None, :]
            xs = self.xs
            self._del_ev = (self.noins_on[:, :-1] & ~self.ins_all[:, 1:]
                            & (col[:, 1:] < self.read_len[:, None])
                            & (xs[:, 1:] - xs[:, :-1] > 1))
        return self._del_ev

    @property
    def mism(self):
        if self._mism is None:
            hc = np.take_along_axis(
                self._pk_hap_codes,
                np.clip(self.xs - 1, 0, self.H_pad - 1), axis=1)
            self._mism = self.noins_on & (self._pk_read_codes != hc)
        return self._mism

    # --- per-row derivations (O(L) per call; per-pair consumers use
    # these so a handful of event pairs never force the full (B, L_pad)
    # matrices the native init skipped) ---

    def _ins_row(self, i: int):
        if self._ins_all is not None:
            return self._ins_all[i]
        return self._ms[i] >= (self.H_pad + 2)

    def _noins_on_row(self, i: int):
        if self._noins_on is not None:
            return self._noins_on[i]
        xs = self.xs[i]
        col = np.arange(self.L_pad)
        on = ((xs >= 1) & (xs <= self._hap_len[i])
              & (col < self.read_len[i]))
        return on & ~self._ins_row(i)

    def _del_row(self, i: int):
        if self._del_ev is not None:
            return self._del_ev[i]
        xs = self.xs[i]
        noins_on = self._noins_on_row(i)
        col = np.arange(1, self.L_pad)
        return (noins_on[:-1] & ~self._ins_row(i)[1:]
                & (col < self.read_len[i]) & (xs[1:] - xs[:-1] > 1))

    def _mism_row(self, i: int):
        if self._mism is not None:
            return self._mism[i]
        hc = self._pk_hap_codes[i][
            np.clip(self.xs[i] - 1, 0, self.H_pad - 1)]
        return self._noins_on_row(i) & (self._pk_read_codes[i] != hc)

    # --- 2-D (nh, nr) views of the flat hap-major arrays ---
    @property
    def ll2d(self):
        return self.ll.reshape(self.nh, self.nr)

    @property
    def off_hap2d(self):
        return self.off_hap.reshape(self.nh, self.nr)

    @property
    def off_hap_hmq2d(self):
        return self.off_hap_hmq.reshape(self.nh, self.nr)

    def __len__(self):
        return self.nh

    def __getitem__(self, h):
        return _LazyRow(self, h)

    def __iter__(self):
        return (self[h] for h in range(self.nh))

    def materialize(self) -> List[List[MLAlignment]]:
        return [[self._ml(h, r) for r in range(self.nr)]
                for h in range(self.nh)]

    def events(self, h: int, r: int):
        """MAP-path indel events of pair (h, r), or None."""
        if not self.has_event[h * self.nr + r]:
            return None
        key = (h, r)
        ev = self._events.get(key)
        if ev is None:
            ev = self._pair_events(h, r)
            self._events[key] = ev
        return ev

    def n_indel_entries_row(self, h: int) -> np.ndarray:
        """len(liks[h][r].indels) over r (distinct indel positions on the
        MAP path), computed once per haplotype row."""
        row = self._nind_rows.get(h)
        if row is None:
            row = np.zeros(self.nr, np.int64)
            base = h * self.nr
            for r in np.nonzero(self.has_event[base:base + self.nr])[0]:
                ev = self.events(h, int(r))
                row[int(r)] = len({e[-1] for e in ev})
            self._nind_rows[h] = row
        return row

    # ------------------------------------------------------------------
    def _pair_events(self, hi: int, ri: int):
        """MAP-path indel events for pair (hi, ri): (b, 'D', pos) or
        (entry, 'I', end, pos), sorted by read position."""
        i = hi * self.nr + ri
        L = self.reads[ri].size()
        Hh = self.haps[hi].size()
        xs = self.xs
        events = []
        for b in np.nonzero(self._del_row(i)[:max(L - 1, 0)])[0]:
            events.append((int(b), "D", int(xs[i, b])))
        ins_row = self._ins_row(i)[:L]
        if ins_row.any():
            # maximal ins runs; the loop enters a run at its first base
            # with 0 < x <= H and consumes to the run end (earlier bases
            # keep their LO/RO codes)
            d = np.diff(ins_row.astype(np.int8))
            starts = list(np.nonzero(d == 1)[0] + 1)
            ends = list(np.nonzero(d == -1)[0])
            if ins_row[0]:
                starts.insert(0, 0)
            if ins_row[L - 1]:
                ends.append(L - 1)
            for a, e in zip(starts, ends):
                entry = -1
                for b in range(a, e + 1):
                    xv = int(xs[i, b])
                    if 0 < xv <= Hh:
                        entry = b
                        break
                if entry >= 0:
                    events.append((entry, "I", int(e), int(xs[i, entry])))
        events.sort(key=lambda t: t[0])
        return events

    def _ml(self, hi: int, ri: int) -> MLAlignment:
        from ..model import HPOS_INS
        from ..variants import AlignedVariant

        cached = self._cache.get((hi, ri))
        if cached is not None:
            return cached
        i = hi * self.nr + ri
        hap = self.haps[hi]
        r = self.reads[ri]
        L = r.size()
        align_ref = "R" * hap.size()
        xs = self.xs
        ml = MLAlignment()
        ml.ll = float(self.ll[i])
        ml.off_hap = bool(self.off_hap[i])
        ml.off_hap_hmq = bool(self.off_hap_hmq[i])
        ml.ll_off = float(self.ll_off[i])
        ml.ll_on = float(self.ll_on[i])
        ml.hpos = self.hpos_all[i, :L].tolist()
        ml.first_base = int(self.fb[i])
        ml.last_base = int(self.lb[i])
        ml.n_bqt = int(self.n_bqt[i])
        ml.m_log_bq = float(self.m_log_bq[i])
        ml.n_mm_bqt = int(self.n_mm_bqt[i])
        ml.n_mm_left = int(self.n_mm_left[i])
        ml.n_mm_right = int(self.n_mm_right[i])
        ml.num_mismatch = int(self.num_mm[i])
        align = None
        if self.any_mism[i]:
            align = list(align_ref)
            for b in np.nonzero(self._mism_row(i)[:L])[0]:
                spos = int(xs[i, b]) - 1
                ml.snps[spos] = AlignedVariant(
                    hap.seq[spos] + "=>" + r.seq[b],
                    start_hap=spos, end_hap=spos,
                    start_read=int(b), end_read=int(b))
                align[spos] = r.seq[b]
        events = self.events(hi, ri)
        if events:
            # patch the indel events onto the vectorized decode (same
            # event rules as hmm/reference.py _report_variants)
            if align is None:
                align = list(align_ref)
            for ev in events:
                if ev[1] == "D":
                    b, _, pos = ev
                    ns = int(xs[i, b + 1])
                    ln = ns - pos - 1
                    for y in range(pos, pos + ln):
                        align[y] = "D"
                    ml.indels[pos] = AlignedVariant(
                        "-" + hap.seq[pos:pos + ln],
                        start_hap=pos, end_hap=pos + ln - 1,
                        start_read=b, end_read=b + 1)
                    ml.num_indels += 1
                else:
                    entry, _, e, pos = ev
                    for b in range(entry, e + 1):
                        ml.hpos[b] = HPOS_INS
                    ml.indels[pos] = AlignedVariant(
                        "+" + r.seq[entry:e + 1],
                        start_hap=pos, end_hap=pos,
                        start_read=entry, end_read=e)
                    ml.num_indels += 1
        ml.align = "".join(align) if align is not None else align_ref
        for pos_, av in hap.indels.items():
            ml.hap_indel_covered[pos_] = av.is_covered(
                self.p.pad_cover, ml.first_base, ml.last_base)
        for pos_, av in hap.snps.items():
            ml.hap_snp_covered[pos_] = av.is_covered(
                self.p.pad_cover, ml.first_base, ml.last_base)
        self._cache[(hi, ri)] = ml
        return ml


class _LazyRow:
    """liks[h] under a LiksView: list-like row of lazy MLAlignments."""

    __slots__ = ("_v", "_h")

    def __init__(self, view: LiksView, h: int):
        self._v = view
        self._h = h

    def __getitem__(self, r):
        return self._v._ml(self._h, r)

    def __len__(self):
        return self._v.nr

    def __iter__(self):
        return (self._v._ml(self._h, r) for r in range(self._v.nr))


def decode_liks_view(haps: List[Haplotype], reads: List[Read],
                     pk: dict, ll, off_hap, off_hap_hmq, ll_off,
                     ll_on, map_state,
                     p: ObservationModelParameters) -> LiksView:
    """Array-level decode of the device outputs: O(1) per-pair Python.

    hpos, first/last base, SNPs, align strings and mismatch statistics
    are batch array ops (the per-base loop of hmm/reference.py
    _report_variants is not run); per-pair MLAlignment objects are
    built only on demand (LiksView)."""
    return LiksView(haps, reads, pk, ll, off_hap, off_hap_hmq, ll_off,
                    ll_on, map_state, p)
