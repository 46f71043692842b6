"""Candidate-indel extraction from read CIGARs + library insert-size
histograms: port of GetCandidatesFromCIGAR (GetCandidates.cpp:37-497).

Each CIGAR I/D op becomes a candidate; candidates are left-aligned by
global alignment of the variant haplotype against the local reference
(alignCIGAR, :103-195) and written as ``tid pos var.. # count..`` lines."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

from ..align.nw import align_haplotype_to_ref
from ..io.bam import BamRecord, FPAIRED, FPROPER_PAIR, FDUP, FQCFAIL
from ..io.bam_native import open_bam
from ..io.fasta import FastaFile
from ..variants import AlignedVariant, INS, DEL, Variant


@dataclass(frozen=True)
class CIGARindel:
    refpos: int
    len: int          # >0 insertion, <0 deletion
    seq: str

    def sort_key(self):
        return (self.refpos, self.len, self.seq)


ALIGN_WINDOW = 100  # GetCandidates.hpp params.alignWindow default


def get_indels_from_cigar(rec: BamRecord) -> List[CIGARindel]:
    """getIndelFromCIGAR (GetCandidates.cpp:64-101)."""
    indels = []
    ref_pos = rec.pos
    l = 0
    for op, ln in rec.cigar:
        seq = ""
        # "=" and "X" are sequence-match/mismatch refinements of "M"
        # (consume read AND reference).  The reference binary predates
        # them and ABORTS the whole extraction on such CIGARs
        # (GetCandidates.cpp:98 "I don't know how to smoke this CIGAR");
        # we instead process them with M semantics so modern real-world
        # BAMs work (tests/test_realbam.py).
        if op in ("I", "M", "S", "=", "X"):
            if op == "I":
                seq = rec.seq[l:l + ln]
            l += ln
        elif op == "D":
            seq = "D" * ln
        if op == "I":
            indels.append(CIGARindel(ref_pos, ln, seq))
        elif op == "D":
            indels.append(CIGARindel(ref_pos, -ln, seq))
        if op in ("M", "D", "N", "=", "X"):
            ref_pos += ln
    return indels


def align_cigar(tid: str, cid: CIGARindel, fa: FastaFile) -> List[AlignedVariant]:
    """alignCIGAR (GetCandidates.cpp:103-195): left-align by NW of the
    variant haplotype against the local reference window."""
    width = ALIGN_WINDOW
    if abs(cid.len) > width // 3:
        width = abs(cid.len) * 3
    start = cid.refpos - width
    end = cid.refpos + width
    try:
        ref = fa.get_sequence(tid, start + 1, end + 1)
    except (KeyError, ValueError):
        return []
    hap = ref
    pos = cid.refpos - start
    testlen = 0 if cid.len > 0 else -cid.len
    if len(hap) < pos + testlen:
        return []
    if cid.len < 0:
        hap = hap[:pos] + hap[pos - cid.len:]
    elif cid.len > 0:
        hap = hap[:pos] + cid.seq + hap[pos:]
    ml = align_haplotype_to_ref(ref, hap)
    out = []
    for p, av in sorted(ml.indels.items()):
        if av.type in (INS, DEL):
            out.append(AlignedVariant(av.str, start_hap=start + p,
                                      end_hap=start + p, start_read=-1,
                                      end_read=-1))
    return out


def output_indels(tid: str, hmap: Dict[int, Dict[CIGARindel, int]],
                  out, fa: FastaFile) -> None:
    """outputIndels (GetCandidates.cpp:197-258): realign all, group by
    realigned position, emit 'tid pos var.. # count..'."""
    realigned: Dict[int, Dict[str, int]] = {}
    for refpos in hmap:
        for cid, count in hmap[refpos].items():
            for av in align_cigar(tid, cid, fa):
                realigned.setdefault(av.start_hap, {})[av.str] = count
    for pos in sorted(realigned):
        variants = realigned[pos]
        vars_str = []
        cnt_str = []
        for vs in sorted(variants):
            vars_str.append(vs)
            cnt_str.append(str(variants[vs]))
        out.write(f"{tid} {pos} " + " ".join(vars_str) + " #" +
                  ("" if not cnt_str else " " + " ".join(cnt_str)) + "\n")


def get_candidates(bam_path: str, output_prefix: str, fasta_path: str
                   ) -> Tuple[str, str]:
    """GetCandidatesFromCIGAR::get (GetCandidates.cpp:387-486): whole-BAM
    scan emitting candidates per target + library insert-size histograms.
    Returns (variants_file, libraries_file)."""
    fa = FastaFile(fasta_path)
    bam = open_bam(bam_path)
    var_path = output_prefix + ".variants.txt"
    lib_path = output_prefix + ".libraries.txt"
    lib_insert: Dict[str, Dict[int, int]] = {}
    rg2lib = bam.header.rg_to_library()

    with open(var_path, "w") as out:
        hmap: Dict[int, Dict[CIGARindel, int]] = {}
        old_tid = -1
        for rec in bam:
            if rec.tid < 0:
                continue
            if rec.tid != old_tid:
                if old_tid != -1:
                    output_indels(bam.header.name_of(old_tid), hmap, out, fa)
                old_tid = rec.tid
                hmap = {}
            for cid in get_indels_from_cigar(rec):
                hmap.setdefault(cid.refpos, {})
                hmap[cid.refpos][cid] = hmap[cid.refpos].get(cid, 0) + 1
            if (rec.flag & FPAIRED) and (rec.flag & FPROPER_PAIR) and \
               rec.tid == rec.mtid and not (rec.flag & (FDUP | FQCFAIL)):
                rg = rec.get_tag("RG")
                lib = rg2lib.get(rg, "dindel_default") if rg else "dindel_default"
                isize = abs(rec.isize)
                lib_insert.setdefault(lib, {})
                lib_insert[lib][isize] = lib_insert[lib].get(isize, 0) + 1
        if old_tid != -1:
            output_indels(bam.header.name_of(old_tid), hmap, out, fa)
    write_libraries(lib_insert, lib_path)
    bam.close()
    fa.close()
    return var_path, lib_path


def get_candidates_region(bam_paths: List[str], tid: str, start: int, end: int,
                          output_file: str, fasta_path: str) -> None:
    """getIndelFromCIGARRegion (GetCandidates.cpp:50-62)."""
    fa = FastaFile(fasta_path)
    hmap: Dict[int, Dict[CIGARindel, int]] = {}
    for path in bam_paths:
        bam = open_bam(path)
        btid = bam.header.tid_of(tid)
        for rec in bam.fetch(btid, start, end):
            for cid in get_indels_from_cigar(rec):
                hmap.setdefault(cid.refpos, {})
                hmap[cid.refpos][cid] = hmap[cid.refpos].get(cid, 0) + 1
        bam.close()
    with open(output_file, "w") as out:
        output_indels(tid, hmap, out, fa)
    fa.close()


def realign_candidate_file(var_file: str, is_one_based: bool,
                           output_file: str, fasta_path: str) -> None:
    """realignCandidateFile (GetCandidates.cpp:260-303)."""
    from ..variants import read_candidate_file
    fa = FastaFile(fasta_path)
    with open(output_file, "w") as out:
        hmap: Dict[int, Dict[CIGARindel, int]] = {}
        ctid = ""
        for cand in read_candidate_file(var_file, is_one_based):
            if cand.tid != ctid:
                if hmap:
                    output_indels(ctid, hmap, out, fa)
                hmap = {}
                ctid = cand.tid
            for var in cand.variants:
                if var.is_indel:
                    ln = var.size() if var.type == INS else -var.size()
                    cid = CIGARindel(cand.pos, ln, var.seq)
                    hmap.setdefault(cid.refpos, {})
                    hmap[cid.refpos][cid] = hmap[cid.refpos].get(cid, 0) + 1
        output_indels(ctid, hmap, out, fa)
    fa.close()


def write_libraries(lib_insert: Dict[str, Dict[int, int]], path: str) -> None:
    """outputLibraries (GetCandidates.cpp:305-386): median*10 outlier cut,
    5-smoothing, '#LIB' histogram format."""
    with open(path, "w") as out:
        for lib in lib_insert:
            insert_sizes = lib_insert[lib]
            tot = sum(insert_sizes.values())
            cum = 0
            median_isize = -1
            for isize in sorted(insert_sizes):
                cum += insert_sizes[isize]
                if median_isize == -1 and cum > tot // 2:
                    median_isize = isize
            max_isize = median_isize * 10
            dtot = float(tot)
            mean = sum(i * c / dtot for i, c in insert_sizes.items() if i < max_isize)
            std = sum(c / dtot * (i - mean) ** 2
                      for i, c in insert_sizes.items() if i < max_isize)
            ln = int(mean + 5 * math.sqrt(std))
            histo = [2] * ln
            for isize, c in insert_sizes.items():
                if isize < ln:
                    histo[isize] = c
            smoothed = [2] * ln
            L = 5
            for i in range(ln):
                lo = max(i - L, 0)
                hi = min(i + L, ln)
                s = sum(histo[lo:hi])
                n = hi - lo
                smoothed[i] = (s + 1) // (n + 1)
            out.write(f"#LIB {lib}\n")
            for i in range(ln):
                out.write(f"{i} {smoothed[i]}\n")
