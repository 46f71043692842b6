"""Read construction and the per-window read fetch/filter cascade.

Ports the data side of Read.hpp (qual conversion, position statistics,
library lookup) and DetInDel::getReads (DInDel.cpp:885-1262): sliding read
buffer over sorted windows, mate pairing via qname, the filter cascade,
mapping-quality sort and the maxReads cap.  Which reads enter the
likelihood computation is part of the behavioral contract."""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from .config import Parameters
from .model import Library, LibraryCollection, Read, mean_first_base_position
from .bam import (BamReader, BamRecord, FDUP, FQCFAIL, FSUPPLEMENTARY)
from .utils import phred_prob

import numpy as _np_mod

# phred byte -> clamped probability; same numpy ops per element as the
# direct formula (Read.hpp:128-147), precomputed once
_PHRED_TABLE = _np_mod.clip(
    1.0 - 10.0 ** (-_np_mod.arange(256, dtype=_np_mod.float64) / 10.0),
    1e-16, 1.0 - 1e-16)


class WindowError(Exception):
    """Per-window failure; message becomes the error_* GLF row."""


class _ArenaUnavailable(Exception):
    """Arena fetch impossible (no .bai); fall back to record iteration."""


def read_from_bam(rec: BamRecord, libraries: LibraryCollection,
                  pool_id: int, rg2lib: Dict[str, str]) -> Read:
    """Read::Read(const bam1_t*, ...) (Read.hpp:123-180)."""
    map_qual = 1.0 - math.pow(10.0, -float(rec.mapq) / 10.0)
    if map_qual < 1e-16:
        map_qual = 1e-16
    if map_qual > 1 - 1e-16:
        map_qual = 1 - 1e-16
    import numpy as np
    # vectorized phred_prob (Read.hpp:128-147 clamps) via the 256-entry
    # byte table (same float ops per entry as the direct formula)
    qual = _PHRED_TABLE[np.frombuffer(rec.qual, np.uint8)]
    pos_stat = mean_first_base_position(rec.cigar, rec.pos)
    # library lookup (Read.hpp:166-179, getLibraryName :185-197)
    if rec.is_paired:
        rg = rec.get_tag("RG")
        lib_name = rg2lib.get(rg, "dindel_default") if rg else "dindel_default"
    else:
        lib_name = "single_end"
    library = libraries.get(lib_name)
    unknown_lib = False
    if library is None:
        unknown_lib = True
        library = libraries["single_end"]
    r = Read(seq=rec.seq, qual=qual, map_qual=map_qual, pos=rec.pos,
             pos_stat_first=pos_stat[0], pos_stat_var=pos_stat[1],
             on_reverse_strand=rec.is_reverse, is_unmapped=rec.is_unmapped,
             is_paired=rec.is_paired, mate_is_unmapped=rec.mate_is_unmapped,
             mate_is_reverse=rec.mate_is_reverse,
             same_tid_as_mate=(rec.mtid == rec.tid),
             mate_pos=rec.mpos, mate_len=-1, pool_id=pool_id,
             library=library, qname=rec.qname, bam=rec)
    r.unknown_lib = unknown_lib
    r.bam_end = rec.end_pos()  # cached; the cascade reads it every window
    return r


def complement_in_place(read: Read) -> None:
    comp = {"A": "T", "T": "A", "C": "G", "G": "C"}
    read.seq = "".join(comp.get(c, c) for c in read.seq)


def reverse_in_place(read: Read) -> None:
    read.seq = read.seq[::-1]


class ReadBuffer:
    """State carried across windows (readBuffer + oldLeftPos +
    oldRightFetchReadPos in detectIndels, DInDel.cpp:1299-1306).

    Two representations share this carrier: `reads` (Read objects, the
    loop/array impls) and the arena columns (`cols` + parallel `refs` /
    `templates` lists, the production impl='arena' path, where Read
    objects are materialized only for cascade survivors)."""

    def __init__(self):
        self.reads: List[Read] = []
        self.old_left_pos = 0
        self.old_right_fetch_read_pos = 0
        self.reset = True
        self.tid: Optional[str] = None
        # arena-mode state
        self.cols: Optional[dict] = None
        self.refs: List[tuple] = []        # (BamArena, row, pool_id)
        self.templates: List[Optional[Read]] = []
        self.qname_ids: dict = {}


LEFTPAD = 200  # DInDel.cpp:917


def _u32(x: int) -> int:
    """uint32_t wrap: the reference computes the fetch window coordinates
    in uint32 (DInDel.cpp:921-925), so leftPos - maxInsertSize - LEFTPAD
    WRAPS for windows within ~(maxInsertSize+200)bp of the contig start.
    The wrapped (huge) left bound then fails the `leftFetch <= rightFetch`
    guard — no reads are fetched and the window errors with
    too_few_reads.  The contig-start dead zone is load-bearing for
    output equality with the reference binary (tests/test_reads_ref.py)."""
    return x & 0xFFFFFFFF


def get_reads(bams: List[BamReader], tid: str, left_pos: int, right_pos: int,
              params: Parameters, libraries: LibraryCollection,
              buf: ReadBuffer) -> List[Read]:
    """DetInDel::getReads (DInDel.cpp:885-1262).

    impl='arena' (production) keeps the sliding buffer as raw BAM arena
    columns and materializes Read objects only for cascade survivors;
    impl='array' runs the same vectorized cascade over a buffer of Read
    objects; impl='loop' is the read-at-a-time port, kept as the
    reference implementation.  All three are asserted identical in
    tests/test_reads_array.py."""
    if left_pos < buf.old_left_pos:
        raise RuntimeError("Windows are not sorted!")
    if int(right_pos - left_pos) < 3 * params.min_read_overlap:
        raise WindowError("Choose a larger width or a smaller minReadOverlap.")

    max_dev = int(libraries.get_max_insert_size())
    right_fetch = right_pos + max_dev
    right_most = right_pos + max_dev
    left_fetch = _u32(left_pos - max_dev - LEFTPAD)
    left_most = _u32(left_pos - max_dev - LEFTPAD)

    rg2libs = [b.header.rg_to_library() for b in bams]

    left_overlaps_previous = False
    if buf.reset:
        buf.reads = []
        buf.old_right_fetch_read_pos = right_fetch
    else:
        buf.reads = [r for r in buf.reads if r.bam.pos >= left_most]
        if left_most < buf.old_right_fetch_read_pos:
            left_fetch = buf.old_right_fetch_read_pos
            left_overlaps_previous = True

    num_unknown_lib = 0
    new_reads: List[Read] = []
    if left_fetch <= right_fetch:
        for b_idx, bam in enumerate(bams):
            try:
                bam_tid = bam.header.tid_of(tid)
            except KeyError:
                raise WindowError("Cannot find ID!")
            count = len(buf.reads)
            for rec in bam.fetch(bam_tid, max(0, int(left_fetch)), int(right_fetch)):
                if rec.flag & (FDUP | FQCFAIL | FSUPPLEMENTARY):
                    continue  # fetchFuncVectorPooled filter (Read.hpp:384)
                r = read_from_bam(rec, libraries, b_idx, rg2libs[b_idx])
                if r.unknown_lib:
                    num_unknown_lib += 1
                new_reads.append(r)
                count += 1
                if count > params.max_reads * 100:
                    raise WindowError("Too many reads in region")
        buf.old_right_fetch_read_pos = right_fetch

    for r in new_reads:
        if r.bam.pos >= left_fetch:
            buf.reads.append(r)

    # duplicate check (DInDel.cpp:1018-1034)
    qname_count: Dict[str, int] = {}
    qids = []
    for r in buf.reads:
        c = qname_count.get(r.qname)
        if c is None:
            qname_count[r.qname] = (len(qname_count), 1)
        else:
            if c[1] + 1 > 2:
                raise WindowError("duplicate reads!")
            qname_count[r.qname] = (c[0], c[1] + 1)
        qids.append(qname_count[r.qname][0])

    reads = [_copy_read(r) for r in buf.reads]

    mapped_name_to_idx: Dict[str, List[int]] = {}
    unmapped_name_to_idx: Dict[str, List[int]] = {}
    for i, r in enumerate(reads):
        (unmapped_name_to_idx if r.is_unmapped else mapped_name_to_idx
         ).setdefault(r.qname, []).append(i)

    min_map_qual = max(params.map_qual_threshold, 0.0)
    for i, r in enumerate(reads):
        filt = False
        if r.size() > params.max_read_length:
            filt = True
        if r.bam.end_pos() < left_most or r.pos > right_most:
            filt = True
        if not r.is_unmapped:
            if (r.pos + r.size() < left_pos + params.min_read_overlap
                    or r.pos > right_pos - params.min_read_overlap):
                filt = True
            elif not r.mate_is_unmapped:
                if not r.same_tid_as_mate:
                    pass  # numTIDmismatch++; not filtered (DInDel.cpp:1099-1102)
                else:
                    idxs = mapped_name_to_idx.get(r.qname)
                    if not idxs:
                        filt = True
                    else:
                        filt = True
                        for j in idxs:
                            if j != i:
                                r.mate_len = reads[j].size()
                                r.mate_pos = reads[j].pos
                                filt = False
            elif r.mate_is_unmapped:
                r.mate_pos = r.pos
                idxs = unmapped_name_to_idx.get(r.qname)
                filt = True
                if idxs:
                    for j in idxs:
                        if j != i:
                            r.mate_len = reads[j].size()
                            filt = False
        else:
            if params.map_unmapped_reads:
                idxs = mapped_name_to_idx.get(r.qname)
                if not idxs:
                    filt = True
                else:
                    j = idxs[0]
                    mate = reads[j]
                    max_insert = mate.get_library().get_max_insert_size()
                    rpos = mate.pos
                    if mate.on_reverse_strand:
                        range_l, range_r = rpos - max_insert, rpos
                    else:
                        range_l, range_r = rpos, rpos + max_insert
                    if range_r > left_pos and range_l < right_pos:
                        filt = False
                        r.map_qual = mate.map_qual
                        r.mate_pos = mate.pos
                        r.mate_len = mate.size()
                        if r.on_reverse_strand == mate.on_reverse_strand:
                            reverse_in_place(r)
                            complement_in_place(r)
                    else:
                        filt = True
            else:
                filt = True
        if filt:
            r.map_qual = -1.0

    # sort by decreasing mapQual with the reference's exact (UNSTABLE
    # libstdc++ introsort) tie permutation, cap maxReads
    # (DInDel.cpp:1218-1226; see engine/std_sort.py)
    from .std_sort import mapqual_sort_order
    import numpy as _np
    order = mapqual_sort_order(
        _np.fromiter((r.map_qual for r in reads), _np.float64, len(reads)))
    reads = [reads[int(i)] for i in order]
    filtered: List[Read] = []
    for r in reads:
        if len(filtered) >= params.max_reads:
            break
        if r.map_qual < min_map_qual:
            break
        if r.mate_pos == -1 and r.is_paired and not r.mate_is_unmapped:
            r.mate_pos = r.pos
        filtered.append(r)
    reads = filtered

    if params.filter_read_aux and len(params.filter_read_aux) > 1:
        exclude = params.filter_read_aux[0] != "+"
        match = params.filter_read_aux[1:]
        kept = []
        for r in reads:
            found = match in r.bam.aux_string()
            if (exclude and not found) or (not exclude and found):
                kept.append(r)
        reads = kept

    if len(reads) < 2:
        raise WindowError("too_few_reads")
    if len(reads) >= params.max_reads:
        raise WindowError("above_read_count_threshold")
    return reads


def _copy_read(r: Read) -> Read:
    # fast shallow copy (copy.copy routes through __reduce_ex__ and was
    # the hottest call in get_reads); qual stays shared, read-only
    c = Read.__new__(Read)
    c.__dict__.update(r.__dict__)
    return c
