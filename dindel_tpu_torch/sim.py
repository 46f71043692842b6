"""Synthetic data generation: reference FASTA + coordinate-sorted BAM with
reads sampled from chosen haplotypes (planted indels/SNPs).

Used by the integration tests and by bench.py; mirrors how the reference
would be exercised on a real BAM."""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .io.bam import (BamHeader, BamRecord, BamWriter, FPAIRED, FREVERSE,
                     FMREVERSE, FUNMAP, FMUNMAP)
from .io.fasta import write_fasta

BASES = "ACGT"


def random_ref(rng: random.Random, n: int, hp_rate: float = 0.05) -> str:
    out = []
    while len(out) < n:
        if rng.random() < hp_rate:
            out.extend(rng.choice(BASES) * rng.randint(3, 9))
        else:
            out.append(rng.choice(BASES))
    return "".join(out[:n])


@dataclass
class PlantedVariant:
    pos: int          # 0-based reference position (dindel convention)
    var: str          # +SEQ / -SEQ / X=>Y
    genotype: int     # 1 = het, 2 = hom


def apply_variants(ref: str, variants: List[PlantedVariant]) -> str:
    """Build the alternate haplotype sequence for the full reference."""
    seq = ref
    for v in sorted(variants, key=lambda v: -v.pos):
        if v.var.startswith("+"):
            seq = seq[:v.pos] + v.var[1:] + seq[v.pos:]
        elif v.var.startswith("-"):
            ln = len(v.var) - 1
            seq = seq[:v.pos] + seq[v.pos + ln:]
        else:
            seq = seq[:v.pos] + v.var[3] + seq[v.pos + 1:]
    return seq


def _cigar_for_read(read_start_alt: int, read_len: int,
                    variants: List[PlantedVariant], ref: str) -> Tuple[int, List[Tuple[str, int]]]:
    """Map a read interval on the ALT haplotype back to reference
    coordinates with the true CIGAR."""
    # walk ref/alt in parallel
    ops: List[Tuple[str, int]] = []
    ref_pos = 0
    alt_pos = 0
    events = sorted(variants, key=lambda v: v.pos)
    read_end_alt = read_start_alt + read_len
    start_ref: Optional[int] = None

    def emit(op: str, n: int):
        if n <= 0:
            return
        if ops and ops[-1][0] == op:
            ops[-1] = (op, ops[-1][1] + n)
        else:
            ops.append((op, n))

    ei = 0
    while alt_pos < read_end_alt and ref_pos <= len(ref):
        next_ev = events[ei] if ei < len(events) else None
        if next_ev is not None and ref_pos == next_ev.pos and alt_pos <= read_end_alt:
            v = next_ev
            ei += 1
            if v.var.startswith("+"):
                ln = len(v.var) - 1
                ov_beg = max(alt_pos, read_start_alt)
                ov_end = min(alt_pos + ln, read_end_alt)
                if ov_end > ov_beg:
                    if start_ref is None and ov_beg == read_start_alt:
                        start_ref = ref_pos  # read starts inside insertion
                    emit("I", ov_end - ov_beg)
                alt_pos += ln
                continue
            if v.var.startswith("-"):
                ln = len(v.var) - 1
                if read_start_alt <= alt_pos - 1 < read_end_alt or \
                   (alt_pos > read_start_alt and alt_pos < read_end_alt):
                    pass
                if alt_pos > read_start_alt and alt_pos < read_end_alt:
                    emit("D", ln)
                ref_pos += ln
                continue
            # SNP consumes one of both; fall through as a match column
        # plain match column
        if alt_pos >= read_start_alt and alt_pos < read_end_alt:
            if start_ref is None:
                start_ref = ref_pos
            emit("M", 1)
        alt_pos += 1
        ref_pos += 1
    if start_ref is None:
        start_ref = ref_pos
    return start_ref, ops


class _HapColumns:
    """Per-haplotype alt->ref column map, built once so each read's CIGAR
    is an O(read_len) slice instead of an O(ref_len) walk (the full-walk
    _cigar_for_read is kept above as the differential reference;
    tests/test_engine_misc.py::test_sim_fast_cigar_matches_walk)."""

    def __init__(self, variants: List[PlantedVariant], ref: str):
        col_ref: List[int] = []    # ref_pos per alt column (ins columns
        col_ins: List[bool] = []   # carry the event's ref_pos)
        del_at: Dict[int, int] = {}  # alt boundary -> deletion length
        ref_pos = 0
        events = sorted(variants, key=lambda v: v.pos)
        ei = 0
        n = len(ref)
        while ref_pos <= n:
            if ei < len(events) and events[ei].pos == ref_pos:
                v = events[ei]
                ei += 1
                if v.var.startswith("+"):
                    ln = len(v.var) - 1
                    col_ref.extend([ref_pos] * ln)
                    col_ins.extend([True] * ln)
                elif v.var.startswith("-"):
                    ln = len(v.var) - 1
                    del_at[len(col_ref)] = del_at.get(len(col_ref), 0) + ln
                    ref_pos += ln
                # SNP: plain match column, falls through
                continue
            if ref_pos == n:
                break
            col_ref.append(ref_pos)
            col_ins.append(False)
            ref_pos += 1
        self.col_ref = col_ref
        self.col_ins = col_ins
        self.del_at = del_at
        self.end_ref = ref_pos

    def cigar(self, start: int, read_len: int) -> Tuple[int, List[Tuple[str, int]]]:
        """Same contract as _cigar_for_read(start, read_len, ...)."""
        end = start + read_len
        ncol = len(self.col_ref)
        ops: List[Tuple[str, int]] = []

        def emit(op: str, k: int):
            if k <= 0:
                return
            if ops and ops[-1][0] == op:
                ops[-1] = (op, ops[-1][1] + k)
            else:
                ops.append((op, k))

        start_ref = None
        for a in range(start, min(end, ncol)):
            if a > start and a in self.del_at:
                emit("D", self.del_at[a])
            if self.col_ins[a]:
                if start_ref is None and a == start:
                    start_ref = self.col_ref[a]
                emit("I", 1)
            else:
                if start_ref is None:
                    start_ref = self.col_ref[a]
                emit("M", 1)
        if start_ref is None:
            start_ref = self.end_ref
        return start_ref, ops


@dataclass
class SimConfig:
    ref_len: int = 2000
    read_len: int = 75
    coverage: int = 30
    base_qual: int = 30
    map_qual: int = 50
    error_rate: float = 0.002
    paired: bool = True
    insert_mean: int = 250
    insert_sd: int = 30
    tid_name: str = "1"
    sample: str = "SAMPLE"
    qname_prefix: str = "r"
    # fraction of ALT-carrying second mates emitted as unmapped (placed at
    # the mate position, empty CIGAR) to exercise --libFile realignment
    unmapped_frac: float = 0.0
    # Fixed-sequence pad PREPENDED to the reference: the caller's fetch
    # window math runs in uint32 (DInDel.cpp:921-925; engine/reads._u32),
    # so windows within ~(maxInsertSize+200)bp of the contig start fall
    # in a dead zone and error with too_few_reads.  Planted variants and
    # reported positions shift by exactly start_pad; their local sequence
    # context (and thus left-alignment) is unchanged.
    start_pad: int = 2432


def simulate(path_prefix: str, variants: List[PlantedVariant],
             cfg: SimConfig = SimConfig(), seed: int = 0,
             ref: Optional[str] = None) -> Tuple[str, str]:
    """Write <prefix>.fa (+.fai) and <prefix>.bam (+.bai).

    Returns (fasta_path, bam_path)."""
    rng = random.Random(seed)
    if ref is None:
        ref = random_ref(rng, cfg.ref_len)
    if cfg.start_pad:
        pad = random_ref(random.Random(987654321), cfg.start_pad)
        ref = pad + ref
        variants = [PlantedVariant(pos=v.pos + cfg.start_pad, var=v.var,
                                   genotype=v.genotype) for v in variants]
    fa_path = path_prefix + ".fa"
    write_fasta(fa_path, {cfg.tid_name: ref})

    alt = apply_variants(ref, variants)
    het = [v for v in variants]
    cols_alt = _HapColumns(het, ref)
    cols_ref = _HapColumns([], ref)

    header = BamHeader(
        text=(f"@HD\tVN:1.3\tSO:coordinate\n"
              f"@SQ\tSN:{cfg.tid_name}\tLN:{len(ref)}\n"
              f"@RG\tID:rg1\tLB:lib1\tSM:{cfg.sample}\n"),
        refs=[(cfg.tid_name, len(ref))])

    n_reads = cfg.coverage * len(ref) // cfg.read_len
    recs: List[BamRecord] = []
    for i in range(n_reads):
        hom = all(v.genotype == 2 for v in variants) if variants else False
        use_alt = variants and (hom or rng.random() < 0.5)
        hap = alt if use_alt else ref
        cols = cols_alt if use_alt else cols_ref
        if cfg.paired:
            isize = max(2 * cfg.read_len + 2,
                        int(rng.gauss(cfg.insert_mean, cfg.insert_sd)))
            start1 = rng.randrange(0, max(1, len(hap) - isize))
            start2 = start1 + isize - cfg.read_len
            pairs = [(start1, False), (start2, True)]
        else:
            pairs = [(rng.randrange(0, max(1, len(hap) - cfg.read_len)), False)]
        made = []
        for start, is_rev in pairs:
            seq = hap[start:start + cfg.read_len]
            if len(seq) < cfg.read_len:
                continue
            # sequencing errors
            seq = list(seq)
            for b in range(len(seq)):
                if rng.random() < cfg.error_rate:
                    seq[b] = rng.choice(BASES)
            seq = "".join(seq)
            ref_start, cigar = cols.cigar(start, cfg.read_len)
            made.append((ref_start, cigar, seq, is_rev))
        if cfg.paired and len(made) == 2:
            (p1, c1, s1, _), (p2, c2, s2, _) = made
            flag1 = FPAIRED | 0x40 | FMREVERSE
            flag2 = FPAIRED | 0x80 | FREVERSE
            q = bytes([cfg.base_qual] * cfg.read_len)
            make_unmapped = (use_alt and cfg.unmapped_frac > 0
                             and rng.random() < cfg.unmapped_frac
                             and any(op in "ID" for op, _ in c2))
            if make_unmapped:
                r1 = BamRecord(qname=f"{cfg.qname_prefix}{i}",
                               flag=FPAIRED | 0x40 | FMUNMAP, tid=0, pos=p1,
                               mapq=cfg.map_qual, cigar=c1, mtid=0, mpos=p1,
                               isize=0, seq=s1, qual=q,
                               tags=[("RG", "Z", "rg1")])
                r2 = BamRecord(qname=f"{cfg.qname_prefix}{i}",
                               flag=FPAIRED | 0x80 | FUNMAP | FREVERSE,
                               tid=0, pos=p1, mapq=0, cigar=[], mtid=0,
                               mpos=p1, isize=0, seq=s2, qual=q,
                               tags=[("RG", "Z", "rg1")])
                recs.extend([r1, r2])
                continue
            r1 = BamRecord(qname=f"{cfg.qname_prefix}{i}", flag=flag1 | 0x2, tid=0, pos=p1,
                           mapq=cfg.map_qual, cigar=c1, mtid=0, mpos=p2,
                           isize=(p2 + cfg.read_len - p1), seq=s1, qual=q,
                           tags=[("RG", "Z", "rg1")])
            r2 = BamRecord(qname=f"{cfg.qname_prefix}{i}", flag=flag2 | 0x2, tid=0, pos=p2,
                           mapq=cfg.map_qual, cigar=c2, mtid=0, mpos=p1,
                           isize=-(p2 + cfg.read_len - p1), seq=s2, qual=q,
                           tags=[("RG", "Z", "rg1")])
            recs.extend([r1, r2])
        elif made:
            p1, c1, s1, _ = made[0]
            q = bytes([cfg.base_qual] * cfg.read_len)
            recs.append(BamRecord(qname=f"{cfg.qname_prefix}{i}", flag=0, tid=0, pos=p1,
                                  mapq=cfg.map_qual, cigar=c1, seq=s1, qual=q,
                                  tags=[("RG", "Z", "rg1")]))
    recs.sort(key=lambda r: r.pos)
    bam_path = path_prefix + ".bam"
    w = BamWriter(bam_path, header)
    for r in recs:
        w.write(r)
    w.close()
    return fa_path, bam_path
