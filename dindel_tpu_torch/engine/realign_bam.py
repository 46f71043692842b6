"""Realigned-BAM output: per-read CIGAR vs the reference composed from
read->haplotype and haplotype->reference MAP alignments, and the
per-window BAM writers.

Ports DetInDel::getCIGAR (DInDel.cpp:728-882), writeRealignedBAMFile
(:670-725) and writeUnalignedBAMFile (:644-668); the post-process hook
(params.processRealignedBAM, :521-526) is invoked by the window engine."""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..io.bam import BamHeader, BamRecord, BamWriter, CIGAR_OPS
from ..model import Haplotype, MLAlignment, Read, HPOS_INS, HPOS_LO, HPOS_RO


class CigarError(Exception):
    pass


def get_cigar(hap: Haplotype, read: Read, ml: MLAlignment,
              ref_seq_start: int) -> Tuple[int, List[Tuple[str, int]]]:
    """Compose read->hap (ml.hpos) with hap->ref (hap.ml.hpos) into a
    reference CIGAR.  Returns (ref_pos, cigar ops).  Exact port of
    DetInDel::getCIGAR."""
    if hap.ml is None or len(hap.ml.hpos) != hap.size():
        raise CigarError("Haplotype has not been aligned!")
    if len(ml.hpos) != read.size():
        raise CigarError("Read is not properly aligned!")
    hml = hap.ml
    L = read.size()
    npos = [0] * L
    for b in range(L):
        npos[b] = hml.hpos[ml.hpos[b]] if ml.hpos[b] >= 0 else ml.hpos[b]

    cig: List[Tuple[str, int]] = []

    b = L - 1
    while b >= 0 and npos[b] < 0:
        b -= 1
    lastbonh = b
    if lastbonh < 0:
        return -1, [("S", L)]

    b = 0
    while npos[b] < 0:
        b += 1
    if b > 0:
        cig.append(("S", b))
    prevponr = npos[b]
    ref_pos = ref_seq_start + prevponr

    curr_cop = "M"
    len_curr = 1
    while b < lastbonh:
        chp = npos[b]
        nhp = npos[b + 1]
        if nhp == HPOS_INS:
            if chp == HPOS_INS:
                if curr_cop != "I":
                    raise CigarError("Error(1)!")
                len_curr += 1
            elif chp >= 0:
                if curr_cop != "M":
                    raise CigarError("Error(2)!")
                cig.append(("M", len_curr))
                len_curr = 1
                curr_cop = "I"
                prevponr = chp
            else:
                raise CigarError("How is this possible? (1)")
        elif chp >= 0 and nhp >= 0 and nhp - chp == 1:
            if curr_cop != "M":
                raise CigarError("Error(3)!")
            len_curr += 1
            prevponr = nhp
        elif chp >= 0 and nhp >= 0 and nhp - chp > 1:
            if curr_cop != "M":
                raise CigarError("Error(4)!")
            cig.append(("M", len_curr))
            cig.append(("D", nhp - chp - 1))
            curr_cop = "M"
            len_curr = 1
            prevponr = nhp
        elif chp == HPOS_INS and nhp - prevponr == 1:
            cig.append(("I", len_curr))
            curr_cop = "M"
            len_curr = 1
            prevponr = nhp
        elif chp == HPOS_INS and nhp - prevponr > 1:
            cig.append(("I", len_curr))
            cig.append(("D", nhp - prevponr - 1))
            curr_cop = "M"
            len_curr = 1
            prevponr = nhp
        b += 1
    cig.append((curr_cop, len_curr))
    if L - 1 - lastbonh > 0:
        cig.append(("S", L - 1 - lastbonh))
    return ref_pos, cig


def write_realigned_bam(file_name: str, cigars: List[Optional[Tuple[int, List]]],
                        reads: List[Read], on_hap: List[int],
                        header: BamHeader) -> None:
    """writeRealignedBAMFile (DInDel.cpp:670-725): realigned reads get the
    new CIGAR/pos/isize; off-haplotype reads are written unchanged."""
    if len(cigars) != len(reads):
        raise CigarError("Problem with the cigars.")
    w = BamWriter(file_name, header, build_index=False)
    recs = []
    for r, read in enumerate(reads):
        rec: BamRecord = read.bam
        if on_hap[r] and cigars[r] is not None:
            import copy
            nb = copy.copy(rec)
            ref_pos, ops = cigars[r]
            nb.cigar = list(ops)
            if ref_pos >= 0:
                nb.pos = ref_pos
                nb.isize = ref_pos - nb.mpos
            recs.append(nb)
        else:
            recs.append(rec)
    # BAM files should stay coordinate sorted for downstream indexing
    for rec in recs:
        w.write(rec)
    w.close()


def write_unaligned_bam(file_name: str, reads: List[Read], on_hap: List[int],
                        header: BamHeader) -> None:
    """writeUnalignedBAMFile (DInDel.cpp:644-668)."""
    if len(on_hap) != len(reads):
        return
    if all(on_hap):
        return
    w = BamWriter(file_name, header, build_index=False)
    for r, read in enumerate(reads):
        if not on_hap[r]:
            w.write(read.bam)
    w.close()
