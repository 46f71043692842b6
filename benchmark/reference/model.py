"""Core window-level data model: haplotypes, reads, alignment results.

Mirrors Haplotype.hpp:40-312, Read.hpp:31-449 (data parts), and
MLAlignment.hpp:28-78.  These are plain host-side objects; the device path
works on packed integer/float arrays built from them (see hmm/pack.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from .variants import AlignedVariant, INS, DEL, SNP, REF

# hpos codes (MLAlignment.hpp:31-34)
HPOS_INS = -1
HPOS_DEL = -2
HPOS_LO = -3
HPOS_RO = -4


@dataclass
class Haplotype:
    """A candidate haplotype with its alignment to the window reference.

    ``indels``/``snps`` map haplotype-relative position -> AlignedVariant
    (including *REF markers added by add_ref_variant)."""

    seq: str = ""
    freq: float = 0.0
    nfreq: float = 0.0
    conf: float = 0.0
    indels: Dict[int, AlignedVariant] = field(default_factory=dict)
    snps: Dict[int, AlignedVariant] = field(default_factory=dict)
    align: str = ""
    ml: Optional["MLAlignment"] = None

    def size(self) -> int:
        return len(self.seq)

    def count_indels(self) -> int:
        """Haplotype.hpp:254-261."""
        return sum(1 for v in self.indels.values() if v.type in (INS, DEL))

    def count_snps(self) -> int:
        """Haplotype.hpp:263-270."""
        return sum(1 for v in self.snps.values() if v.type == SNP and not v.is_ref)

    def add_ref_variant(self, rp: int) -> None:
        """Add *REF (or R=>x) markers at reference-relative position rp so
        coverage statistics can be computed (Haplotype.hpp:201-251)."""
        offset = 0
        for p in sorted(self.indels):
            v = self.indels[p]
            if p > rp:
                break
            if v.type == DEL:
                if p + v.size() <= rp:
                    offset -= v.size()
                else:
                    break  # reference keeps addVariant=true and falls through
            if v.type == INS:
                offset += v.size()
        read_start = rp + offset
        read_end = rp + offset
        if rp not in self.indels:
            a = self.align[rp] if rp < len(self.align) else "R"
            gt = "*REF" if a == "R" else "R=>" + a
            self.indels[rp] = AlignedVariant(gt, start_hap=rp, end_hap=rp,
                                             start_read=read_start, end_read=read_end)
        if rp not in self.snps:
            a = self.align[rp] if rp < len(self.align) else "R"
            gt = "*REF" if a == "R" else "R=>" + a
            self.snps[rp] = AlignedVariant(gt, start_hap=rp, end_hap=rp,
                                           start_read=read_start, end_read=read_end)


@dataclass
class MLAlignment:
    """Result of aligning one read against one haplotype
    (MLAlignment.hpp:28-78)."""

    ll: float = 0.0
    ll_on: float = 0.0
    ll_off: float = 0.0
    off_hap: bool = False
    off_hap_hmq: bool = False
    rel_pos: int = -1
    first_base: int = -1
    last_base: int = -1
    indels: Dict[int, AlignedVariant] = field(default_factory=dict)
    snps: Dict[int, AlignedVariant] = field(default_factory=dict)
    hap_indel_covered: Dict[int, bool] = field(default_factory=dict)
    hap_snp_covered: Dict[int, bool] = field(default_factory=dict)
    hpos: List[int] = field(default_factory=list)
    align: str = ""
    num_indels: int = 0
    num_mismatch: int = 0
    n_bqt: int = 0
    n_mm_bqt: int = 0
    m_log_bq: float = 0.0
    n_mm_left: int = 0
    n_mm_right: int = 0


class Library:
    """Insert-size library (Library.hpp:36-130)."""

    def __init__(self, counts: Optional[np.ndarray] = None):
        if counts is None:
            counts = np.ones(2000, dtype=np.float64)
        counts = np.asarray(counts, dtype=np.float64)
        # Library::calcProb (Library.hpp:80-126)
        max_isize = int(np.argmax(counts >= counts.max()))  # first max
        # reference scans for counts[s] >= max_count keeping the *last*;
        # emulate: argmax of counts with ties -> last index
        mx = counts.max()
        idxs = np.nonzero(counts >= mx)[0]
        max_isize = int(idxs[-1])
        maxins = 25 * max_isize
        if maxins > len(counts):
            maxins = len(counts)
        if maxins <= 0:
            maxins = len(counts)
        probs = counts[:maxins].astype(np.float64).copy()
        z = probs.sum()
        self.mode_insert_size = int(np.argmax(probs))
        probs /= z
        probs[probs < 1e-10] = 1e-10
        self.probs = probs
        self.maxins = maxins
        sp = np.sort(probs)
        s = 0.0
        self.ninetyfifth_pct_prob = sp[0]
        for x in range(len(sp) - 1, 0, -1):
            s += sp[x]
            if s > 0.95:
                self.ninetyfifth_pct_prob = sp[x]
                break

    def get_prob(self, x: int) -> float:
        x = abs(int(x))
        if x >= self.maxins:
            x = self.maxins - 1
        return float(self.probs[x])

    def get_prob_vec(self, x: np.ndarray) -> np.ndarray:
        """Vectorized get_prob (same clamping)."""
        xi = np.minimum(np.abs(x.astype(np.int64)), self.maxins - 1)
        return self.probs[xi]

    def get_max_insert_size(self) -> int:
        return self.maxins


class LibraryCollection(dict):
    """Library.hpp:132-256; always contains 'single_end' uniform-2000."""

    def __init__(self):
        super().__init__()
        self["single_end"] = Library()

    def get_max_insert_size(self) -> float:
        return max(lib.get_max_insert_size() for lib in self.values())

    def add_from_file(self, path: str) -> None:
        """Parse the '#LIB name' histogram format written by
        outputLibraries (GetCandidates.cpp:305-386; Library.hpp:140-242)."""
        lib_name = None
        counts: List[float] = []
        with open(path) as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    break
                toks = line.split()
                if toks[0] == "#LIB":
                    if counts and lib_name:
                        if lib_name in self and lib_name != "single_end":
                            raise ValueError("Duplicate library IDs.")
                        self[lib_name] = Library(np.array(counts))
                    counts = []
                    lib_name = toks[1] if len(toks) > 1 else None
                    if not lib_name:
                        raise ValueError("Cannot read library name")
                else:
                    counts.append(float(toks[1]))
        if lib_name:
            if lib_name in self and lib_name != "single_end":
                raise ValueError("Duplicate library IDs.")
            self[lib_name] = Library(np.array(counts))


@dataclass
class Read:
    """A read ready for the observation model (data mirror of Read.hpp).

    ``qual`` are per-base correctness probabilities clamped to
    [1e-16, 1-1e-16]; ``map_qual`` likewise (Read.hpp:127-149)."""

    seq: str = ""
    qual: np.ndarray = field(default_factory=lambda: np.zeros(0))
    map_qual: float = 1.0 - 1e-16
    pos: int = 0
    pos_stat_first: float = 0.0   # mean first-base position (Read.hpp:261-306)
    pos_stat_var: float = 1.0
    on_reverse_strand: bool = False
    is_unmapped: bool = False
    is_paired: bool = False
    mate_is_unmapped: bool = False
    mate_is_reverse: bool = False
    same_tid_as_mate: bool = True
    mate_pos: int = -1
    mate_len: int = -1
    pool_id: int = 0
    library: Optional[Library] = None
    qname: str = ""
    # raw BAM record (dindel_tpu.io.bam.BamRecord) when read from a BAM
    bam: object = None

    def size(self) -> int:
        return len(self.seq)

    def set_all_qual(self, v: float) -> None:
        self.qual = np.full(len(self.seq), v, dtype=np.float64)

    def get_library(self) -> Library:
        return self.library if self.library is not None else Library()


def mean_first_base_position(cigar: List[tuple], ref_pos: int):
    """Read::computePositionStatistics (Read.hpp:261-306): mean/var over
    M-ops of (readpos - totLen) + refPos.  cigar is [(op, len)] with SAM op
    characters."""
    pos = 0
    tot_len = 0
    mean = 0
    for op, ln in cigar:
        if op == "M":
            mean += ln * (pos - tot_len)
            tot_len += ln
        if op in ("M", "D", "S", "H"):
            pos += ln
    if tot_len == 0:
        return (-1.0, -1.0)
    dmean = mean / tot_len
    pos = 0
    tot_len = 0
    var = 0.0
    for op, ln in cigar:
        if op == "M":
            var += ln * ((pos - tot_len) - dmean) ** 2
            tot_len += ln
        if op in ("M", "D", "S", "H"):
            pos += ln
    return (dmean + ref_pos, var / tot_len)
