"""Uniform array access over a liks matrix for the vectorized callers:
JAX-free counterpart of ``dindel_tpu.infer.arrays.LiksArrays``
(arrays.py:39), whose constructor imports the JAX package's LiksView.

This package only ever holds its own LiksView (full-decode route) or
LiksStats (device-call route), so only the array branch of the original
is here.  ``add_logs_arr`` and ``seq_sum`` come from the original
module, which is JAX-free at top level."""

from __future__ import annotations

import numpy as np

from dindel_tpu.infer.arrays import add_logs_arr, seq_sum  # noqa: F401

from ..hmm.liks import LiksStats, LiksView


class LiksArrays:
    """(nh, nr) array views of the liks matrix fields the callers use."""

    def __init__(self, liks, haps, reads, params):
        if not isinstance(liks, (LiksView, LiksStats)):
            raise TypeError("expected LiksView or LiksStats, got "
                            f"{type(liks).__name__}")
        nh, nr = len(haps), len(reads)
        self.nh, self.nr = nh, nr
        self.haps = haps
        self.pad = params.obs_params.pad_cover
        self.ll = liks.ll2d
        self.off = liks.off_hap2d
        self.off_hmq = liks.off_hap_hmq2d
        self.nbqt = liks.n_bqt.reshape(nh, nr)
        self.nmmbqt = liks.n_mm_bqt.reshape(nh, nr)
        self.mlogbq = liks.m_log_bq.reshape(nh, nr)
        self.nmml = liks.n_mm_left.reshape(nh, nr)
        self.nmmr = liks.n_mm_right.reshape(nh, nr)
        self.fb = liks.fb.reshape(nh, nr)
        self.lb = liks.lb.reshape(nh, nr)
        self._view = liks

    def nind_entries_row(self, h: int) -> np.ndarray:
        """len(liks[h][r].indels) over r."""
        return self._view.n_indel_entries_row(h)

    def indel_covered(self, h: int, pos: int) -> np.ndarray:
        """liks[h][r].hap_indel_covered.get(pos, False) over r."""
        return self._covered(self.haps[h].indels.get(pos), h)

    def snp_covered(self, h: int, pos: int) -> np.ndarray:
        """liks[h][r].hap_snp_covered.get(pos, False) over r."""
        return self._covered(self.haps[h].snps.get(pos), h)

    def _covered(self, av, h: int) -> np.ndarray:
        if av is None:
            return np.zeros(self.nr, bool)
        return ((self.fb[h] + self.pad <= av.start_read)
                & (self.lb[h] - self.pad >= av.end_read))
