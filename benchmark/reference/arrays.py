"""Uniform array access over a liks matrix for the vectorized callers.

The callers (diploid, pooled VB-EM, haplotype filter) are pure functions
of per-(hap, read) scalars.  LiksArrays exposes those as (nh, nr) numpy
arrays whether ``liks`` is a list-of-lists of MLAlignment (the oracle
path; attributes are gathered) or an hmm/liks.py LiksView or LiksStats
(the device paths; arrays are taken directly, no per-pair Python).

Float accumulations in the callers must reproduce the reference's
sequential left-folds bit-for-bit; ``seq_sum``/``add_logs_arr`` provide
order-exact vector equivalents (np.cumsum accumulates sequentially, and
the addLogs formula mirrors Utils.hpp:29 term-for-term).
"""

from __future__ import annotations

from typing import List

import numpy as np


def add_logs_arr(a, b):
    """Elementwise log(exp(a)+exp(b)), same operations as
    utils.add_logs / reference addLogs (Utils.hpp:29): larger argument
    stays outside the exp."""
    m = np.maximum(a, b)
    mn = np.minimum(a, b)
    return m + np.log(1.0 + np.exp(mn - m))


def seq_sum(terms) -> float:
    """Sequential left-fold sum (bit-equal to `acc = 0.0; for t: acc += t`)."""
    terms = np.asarray(terms, np.float64)
    if terms.size == 0:
        return 0.0
    return float(np.cumsum(terms)[-1])


class LiksArrays:
    """(nh, nr) array views of the liks matrix fields the callers use."""

    def __init__(self, liks, haps, reads, params):
        nh, nr = len(haps), len(reads)
        self.nh, self.nr = nh, nr
        self.haps = haps
        self.pad = params.obs_params.pad_cover
        self._dicts = None
        if True:
            def arr(f, dt):
                return np.array([[f(liks[h][r]) for r in range(nr)]
                                 for h in range(nh)], dt)
            self.ll = arr(lambda m: m.ll, np.float64)
            self.off = arr(lambda m: m.off_hap, bool)
            self.off_hmq = arr(lambda m: m.off_hap_hmq, bool)
            self.nbqt = arr(lambda m: m.n_bqt, np.int64)
            self.nmmbqt = arr(lambda m: m.n_mm_bqt, np.int64)
            self.mlogbq = arr(lambda m: m.m_log_bq, np.float64)
            self.nmml = arr(lambda m: m.n_mm_left, np.int64)
            self.nmmr = arr(lambda m: m.n_mm_right, np.int64)
            self.fb = None
            self.lb = None
            self._dicts = liks
            self._view = None

    def nind_entries_row(self, h: int) -> np.ndarray:
        """len(liks[h][r].indels) over r."""
        if self._dicts is not None:
            return np.array([len(self._dicts[h][r].indels)
                             for r in range(self.nr)], np.int64)
        return self._view.n_indel_entries_row(h)

    def indel_covered(self, h: int, pos: int) -> np.ndarray:
        """liks[h][r].hap_indel_covered.get(pos, False) over r."""
        if self._dicts is not None:
            return np.array([self._dicts[h][r].hap_indel_covered.get(pos, False)
                             for r in range(self.nr)], bool)
        av = self.haps[h].indels.get(pos)
        if av is None:
            return np.zeros(self.nr, bool)
        return ((self.fb[h] + self.pad <= av.start_read)
                & (self.lb[h] - self.pad >= av.end_read))

    def snp_covered(self, h: int, pos: int) -> np.ndarray:
        """liks[h][r].hap_snp_covered.get(pos, False) over r."""
        if self._dicts is not None:
            return np.array([self._dicts[h][r].hap_snp_covered.get(pos, False)
                             for r in range(self.nr)], bool)
        av = self.haps[h].snps.get(pos)
        if av is None:
            return np.zeros(self.nr, bool)
        return ((self.fb[h] + self.pad <= av.start_read)
                & (self.lb[h] - self.pad >= av.end_read))
