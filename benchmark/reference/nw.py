"""Affine-gap global alignment (Gotoh) + alignment-to-variants conversion.

Replaces the reference's use of SeqAn ``globalAlignment`` for aligning
candidate haplotypes to the window reference (DInDel.cpp:1427-1524) and for
left-aligning candidate indels (GetCandidates.cpp:103-195).  Behaviorally
identical to SeqAn 1.x Gotoh with AlignConfig<> (tie-breaks included; see
native/nw.cpp for the rules), differential-tested against the bundled SeqAn.

This copy keeps the pure-Python port only.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .config import NW_MATCH, NW_MISMATCH, NW_GAP_EXTEND, NW_GAP_OPEN
from .model import Haplotype, MLAlignment, Read, HPOS_INS, HPOS_LO, HPOS_RO
from .variants import AlignedVariant, DEL, INS

_DIAG, _HORIZ, _VERT = 0, 1, 2


def gotoh_align(seq1: str, seq2: str,
                match: int = NW_MATCH, mismatch: int = NW_MISMATCH,
                gap_extend: int = NW_GAP_EXTEND, gap_open: int = NW_GAP_OPEN
                ) -> Tuple[int, str]:
    """Global alignment of seq1 (reference row) vs seq2 (candidate row).

    Returns (score, ops) with ops a string over {D, H, V}: D consumes one
    char of both, H one of seq1 only (gap in seq2), V one of seq2 only
    (gap in seq1)."""
    return _gotoh_py(seq1, seq2, match, mismatch, gap_extend, gap_open)


def _gotoh_py(seq1: str, seq2: str, match: int, mismatch: int,
              gap_extend: int, gap_open: int) -> Tuple[int, str]:
    """Pure-Python port of native/nw.cpp (same tie-break semantics)."""
    n1, n2 = len(seq1), len(seq2)
    GO, GE = gap_open, gap_extend
    mat = [0] * (n2 + 1)
    hori = [0] * (n2 + 1)
    trace = [[0] * n2 for _ in range(max(n1, 1))]
    for row in range(1, n2 + 1):
        mat[row] = GO + (row - 1) * GE
        hori[row] = mat[row] + GO - GE
    vert = 0
    for col in range(1, n1 + 1):
        diag_val = mat[0]
        mat[0] = GO + (col - 1) * GE
        vert = mat[0] + GO - GE
        c1 = seq1[col - 1]
        tcol = trace[col - 1]
        for row in range(1, n2 + 1):
            tv = 0
            a = mat[row - 1] + GO
            b = vert + GE
            if a > b:
                vert = a
                tv |= 8
            else:
                vert = b
            a = mat[row] + GO
            b = hori[row] + GE
            if a > b:
                hori[row] = a
                tv |= 4
            else:
                hori[row] = b
            mv = diag_val + (match if c1 == seq2[row - 1] else mismatch)
            tm = _DIAG
            if vert > mv:
                mv = vert
                tm = _VERT
            if hori[row] > mv:
                mv = hori[row]
                tm = _HORIZ
            tv |= tm
            diag_val = mat[row]
            mat[row] = mv
            tcol[row - 1] = tv
    initial = _DIAG
    if n1 > 0 and n2 > 0:
        if hori[n2] == mat[n2]:
            initial = _HORIZ
        elif vert == mat[n2]:
            initial = _VERT
    score = mat[n2]

    rev: List[str] = []
    TC = "DHV"
    l1, l2 = n1, n2
    if l1 != 0 and l2 != 0:
        ntv = trace[l1 - 1][l2 - 1]
        tv = _DIAG
        if initial == _DIAG:
            tv = ntv & 3
        elif initial == _HORIZ:
            if (ntv >> 2) & 1:
                l1 -= 1
                rev.append("H")
            else:
                tv = _HORIZ
        else:
            if (ntv >> 3) & 1:
                l2 -= 1
                rev.append("V")
            else:
                tv = _VERT
        seg = 0
        tv_old = tv
        while l1 != 0 and l2 != 0:
            ntv = trace[l1 - 1][l2 - 1]
            if tv == _DIAG:
                tv = ntv & 3
            elif tv == _HORIZ:
                tv = _DIAG if (ntv >> 2) & 1 else _HORIZ
            else:
                tv = _DIAG if (ntv >> 3) & 1 else _VERT
            if tv == _DIAG:
                if tv != tv_old:
                    if tv_old == _VERT:
                        l2 -= 1
                    else:
                        l1 -= 1
                    seg += 1
                    rev.extend(TC[tv_old] * seg)
                    tv_old = tv
                    seg = 0
                else:
                    seg += 1
                    l1 -= 1
                    l2 -= 1
            elif tv == _HORIZ:
                if tv != tv_old:
                    rev.extend(TC[tv_old] * seg)
                    if (ntv >> 2) & 1:
                        l1 -= 1
                        rev.append("H")
                        tv = _DIAG
                        seg = 0
                    else:
                        tv_old = tv
                        seg = 1
                        l1 -= 1
                else:
                    seg += 1
                    l1 -= 1
            else:
                if tv != tv_old:
                    rev.extend(TC[tv_old] * seg)
                    if (ntv >> 3) & 1:
                        l2 -= 1
                        rev.append("V")
                        tv = _DIAG
                        seg = 0
                    else:
                        tv_old = tv
                        seg = 1
                        l2 -= 1
                else:
                    seg += 1
                    l2 -= 1
        if seg:
            rev.extend(TC[tv_old] * seg)
    if l1 != 0:
        rev.extend("H" * l1)
    elif l2 != 0:
        rev.extend("V" * l2)
    return score, "".join(reversed(rev))


# ---------------------------------------------------------------------------
# alignment -> MLAlignment conversion (convertAlignment,
# ObservationModelSeqAn.hpp:142-269) and ambiguity-flank computation
# (Realign::getFlankingCoordinatesBetter, ObservationModelSeqAn.hpp:39-138)
# ---------------------------------------------------------------------------

def get_flanking_coordinates(hap_seq: str, read_len: int, av: AlignedVariant) -> None:
    """Compute left/right-shift ambiguity flanks of an indel, exactly like
    Realign::getFlankingCoordinatesBetter (incl. its quirks of assigning
    leftFlankRead on right-overflow)."""
    if av.type == DEL:
        seq = av.seq
        l = len(seq)
        orig = hap_seq[:av.start_hap] + hap_seq[av.start_hap + l:]
        sh = av.start_hap
        lfh = sh - 1
        rfh = sh + l
        for x in range(sh - 1, 0, -1):
            if hap_seq[:x] + hap_seq[x + l:] == orig:
                lfh = x - 1
        if lfh <= 0:
            lfh = 0
        for x in range(sh + 1, len(hap_seq) - l):
            if hap_seq[:x] + hap_seq[x + l:] == orig:
                rfh = x + l
        lfr = av.start_read - (sh - lfh) + 1
        if lfr < 0:
            lfr = 0
        rfr = av.start_read + 1 + (rfh - sh - l)
        if rfr >= read_len:
            lfr = read_len - 1  # reference bug, kept for parity
    elif av.type == INS:
        seq = av.seq
        l = len(seq)
        orig = hap_seq[:av.start_hap] + seq + hap_seq[av.start_hap:]
        sh = av.start_hap
        lfh = sh - 1
        rfh = sh
        for x in range(sh - 1, 0, -1):
            iseq = orig[x:x + l]
            if hap_seq[:x] + iseq + hap_seq[x:] == orig:
                lfh = x - 1
        if lfh <= 0:
            lfh = 0
        for x in range(sh + 1, len(hap_seq) - l):
            iseq = orig[x:x + l]
            if hap_seq[:x] + iseq + hap_seq[x:] == orig:
                rfh = x
        lfr = av.start_read - (sh - lfh) + 1
        if lfr < 0:
            lfr = 0
        rfr = av.start_read + l + (rfh - sh)
        if rfr >= read_len:
            lfr = read_len - 1  # reference bug, kept for parity
    else:
        lfr = av.start_read - 1
        if lfr < 0:
            lfr = 0
        rfr = av.start_read + 1
        if rfr >= read_len:
            lfr = read_len - 1  # reference bug, kept for parity
        lfh = av.start_hap - 1
        if lfh < 0:
            lfh = 0
        rfh = av.start_hap + 1
        if rfh >= len(hap_seq):
            lfh = len(hap_seq) - 1  # reference bug, kept for parity
    av.set_flanking(lfh, rfh, lfr, rfr)


def convert_alignment(ops: str, ref_seq: str, cand_seq: str) -> MLAlignment:
    """Walk the gapped alignment and emit indels/snps/hpos exactly like
    convertAlignment (ObservationModelSeqAn.hpp:142-269).  Row 0 = ref_seq
    ('hap' in the reference code), row 1 = cand_seq ('read')."""
    hlen = len(ref_seq)
    rlen = len(cand_seq)
    ml = MLAlignment()
    ml.rel_pos = 0
    ml.align = ["R"] * hlen
    ml.hpos = [HPOS_LO] * rlen
    ml.first_base = -1
    ml.last_base = -1

    # expand ops to per-column (row0_gap, row1_gap) pairs
    ncols = len(ops)
    r0 = 0  # chars of ref consumed
    r1 = 0  # chars of cand consumed

    b = 0
    rb = 0
    # leading gaps in ref row
    while b < ncols and ops[b] == "V":
        ml.rel_pos -= 1
        ml.hpos[rb] = HPOS_LO
        rb += 1
        b += 1
    hb = 0
    fbfound = False
    while b < ncols and rb < rlen:
        if ops[b] == "V":  # gap in ref row
            if hb < hlen:
                seq = ["+"]
                it = rb
                while b < ncols and ops[b] == "V":
                    seq.append(cand_seq[rb])
                    ml.hpos[rb] = HPOS_INS
                    b += 1
                    rb += 1
                seq = "".join(seq)
                av = AlignedVariant(seq, start_hap=hb, end_hap=hb,
                                    start_read=rb - len(seq) + 1, end_read=rb - 1)
                get_flanking_coordinates(ref_seq, rlen, av)
                ml.indels[hb] = av
            else:
                ml.hpos[rb] = HPOS_RO
                rb += 1
                b += 1
        else:
            if ops[b] == "D":  # both aligned
                if not fbfound:
                    fbfound = True
                    ml.first_base = hb
                if ref_seq[hb] != cand_seq[rb]:
                    snp = ref_seq[hb] + "=>" + cand_seq[rb]
                    av = AlignedVariant(snp, start_hap=hb, end_hap=hb,
                                        start_read=rb, end_read=rb)
                    get_flanking_coordinates(ref_seq, rlen, av)
                    ml.snps[hb] = av
                    ml.align[hb] = cand_seq[rb]
                ml.hpos[rb] = hb
                rb += 1
                b += 1
                hb += 1
            else:  # 'H': gap in cand row -> deletion from ref
                seq = ["-"]
                ln = 0
                while b < ncols and ops[b] == "H":
                    seq.append(ref_seq[hb])
                    ml.align[hb] = "D"
                    b += 1
                    hb += 1
                    ln += 1
                if fbfound:
                    av = AlignedVariant("".join(seq), start_hap=hb - ln,
                                        end_hap=hb - 1, start_read=rb - 1, end_read=rb)
                    get_flanking_coordinates(ref_seq, rlen, av)
                    ml.indels[hb - ln] = av
    ml.last_base = hb
    ml.align = "".join(ml.align)
    return ml


# SeqAn 1.x ascii->Dna: ACGT/acgt map to themselves, U/u to T, and EVERY
# other byte (including 'N' — from --changeINStoN haplotypes or
# reference-genome Ns) to 'A'
# (seqan/basic/basic_alphabet_simple_tabs.h:137-170).
_SEQAN_DNA = str.maketrans({
    chr(b): ("C" if chr(b) in "Cc" else
             "G" if chr(b) in "Gg" else
             "T" if chr(b) in "TtUu" else
             "A")
    for b in range(256)})


def align_haplotype_to_ref(ref_seq: str, cand_seq: str) -> MLAlignment:
    """ObservationModelSeqAn::align equivalent: NW + conversion; ml.ll is
    the integer alignment score (ObservationModelSeqAn.hpp:321-346).

    Both inputs pass through seqan::DnaString construction in the
    reference (ObservationModelSeqAn.hpp:323-324), so the alignment —
    and the variant/align strings extracted from it — see the 4-letter
    converted sequences (non-ACGT -> 'A')."""
    ref_seq = ref_seq.translate(_SEQAN_DNA)
    cand_seq = cand_seq.translate(_SEQAN_DNA)
    score, ops = gotoh_align(ref_seq, cand_seq)
    ml = convert_alignment(ops, ref_seq, cand_seq)
    ml.ll = float(score)
    return ml
