"""Haplotype filtering + per-variant strand coverage, a port of
DetInDel::filterHaplotypes (DInDel.cpp:1932-2100).

A haplotype survives only if each of its indels is covered by at least one
clean read (no indels, not off-hap at high mapping quality) matching the
flank interval with at most maxMismatch mismatches.

NB: the reference's coverage loops run ``b<=hpos.size()``
(DInDel.cpp:1995,2040), reading one element past the vector end — undefined
behavior whose effect depends on heap garbage (it can add a phantom base to
the coverage/mismatch counts).  This port implements the defined-behavior
subset (``b < len``); the differential test pins the reference's phantom
element so both sides agree (tests/test_callers_ref.py)."""

from __future__ import annotations

from typing import Dict, List, Tuple

from .config import Parameters
from .model import Haplotype, MLAlignment, Read
from .variants import AlignedVariant, DEL, INS


def filter_haplotypes(haps: List[Haplotype], reads: List[Read],
                      liks, params: Parameters, do_filter: bool):
    """Returns (filtered: List[int], var_coverage: {(pos, var) -> (nf, nr)}).

    Dispatches to an array-level implementation when liks is an
    hmm/liks.py LiksView (the full-decode route); the per-pair loop
    below is the oracle-path reference implementation, differential-tested
    against the compiled C++ in tests/test_callers_ref.py.  View-vs-loop
    equality is asserted in tests/test_liks_view.py."""
    num_haps = len(haps)
    filtered = [0] * num_haps
    pad = params.obs_params.pad_cover
    max_mm = params.obs_params.max_mismatch
    # coverage per (pos, var-string) per hap x strand
    h_var_cov: Dict[Tuple[int, str], List[set]] = {}
    num_filtered = 0

    for h in range(num_haps):
        sel_reads = [r for r in range(len(reads))
                     if not liks[h][r].off_hap_hmq and liks[h][r].num_indels == 0]
        all_covered = True
        for p, av in sorted(haps[h].indels.items()):
            pav = (p, av.str)
            if pav not in h_var_cov:
                h_var_cov[pav] = [set() for _ in range(num_haps * 2)]
            if av.type not in (INS, DEL):
                continue
            left = av.left_flank_read - pad
            right = av.right_flank_read + pad
            ln = right - left + 1
            covered = False
            if av.type == DEL:
                numdel = 0
                for r in sel_reads:
                    strand = _strand(reads[r])
                    c = set()
                    nmm = 0
                    hpos = liks[h][r].hpos
                    for b in range(len(hpos)):
                        hb = hpos[b]
                        if left <= hb <= right:
                            c.add(hb)
                            if haps[h].seq[hb] != "N" and haps[h].seq[hb] != reads[r].seq[b]:
                                nmm += 1
                    if len(c) >= ln and nmm <= max_mm:
                        numdel += 1
                        h_var_cov[pav][h + strand * num_haps].add(r)
                if numdel >= 1:
                    covered = True
            else:  # INS
                lenins = len(av.seq)
                for r in sel_reads:
                    strand = _strand(reads[r])
                    this_covered = [0] * ln
                    nmm = 0
                    c = set()
                    hpos = liks[h][r].hpos
                    for b in range(len(hpos)):
                        hb = hpos[b]
                        if left <= hb <= right:
                            this_covered[hb - left] += 1
                            c.add(hb)
                            if haps[h].seq[hb] != reads[r].seq[b]:
                                nmm += 1
                    this_read_covered = False
                    if (lenins > 10 and nmm <= max_mm) or \
                       (lenins <= 10 and len(c) >= ln and nmm <= max_mm):
                        this_read_covered = all(x > 0 for x in this_covered)
                        if this_read_covered:
                            h_var_cov[pav][h + strand * num_haps].add(r)
                    if this_read_covered:
                        covered = True
            if not covered:
                all_covered = False
                break
        if do_filter and not all_covered:
            num_filtered += 1
            filtered[h] = 1

    var_coverage: Dict[Tuple[int, str], Tuple[int, int]] = {}
    for pav, cov in h_var_cov.items():
        rf, rr = set(), set()
        for h in range(num_haps):
            if filtered[h] != 1:
                rf |= cov[h]
                rr |= cov[h + num_haps]
        var_coverage[pav] = (len(rf), len(rr))
    return filtered, var_coverage


def _strand(read: Read) -> int:
    """DInDel.cpp:1986-1992: unmapped reads use the mate's orientation."""
    if read.is_unmapped:
        return 1 if not read.mate_is_reverse else 0
    return 1 if read.on_reverse_strand else 0
