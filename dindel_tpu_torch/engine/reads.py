"""Read construction and the per-window read fetch/filter cascade.

Ports the data side of Read.hpp (qual conversion, position statistics,
library lookup) and DetInDel::getReads (DInDel.cpp:885-1262): sliding read
buffer over sorted windows, mate pairing via qname, the filter cascade,
mapping-quality sort and the maxReads cap.  Which reads enter the
likelihood computation is part of the behavioral contract."""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Tuple

from ..config import Parameters
from ..model import Library, LibraryCollection, Read, mean_first_base_position
from ..io.bam import (BamReader, BamRecord, FDUP, FQCFAIL, FSUPPLEMENTARY)
from ..io.bam_native import NativeBamReader
from ..io.reads_intake import IntakeHandle, IntakeJob, NameTable, intake_lib
from ..utils import phred_prob

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
    loop/array impls) and the arena columns (`cols`, the production
    impl='arena' path, where Read objects are materialized only for
    cascade survivors): each row's `blk`, `row` and `pool` name its
    record in `arenas` and its BAM.

    The arena path takes a window's new rows from the native read intake
    (io/reads_intake.py), a job of one intake per BAM on a native thread.
    Told the next window, it starts that window's job ahead, with the
    arguments this buffer's rules give it if the buffer is not reset;
    the next window takes the result when its own arguments are the
    same, and otherwise discards it and runs its job itself.  The intake
    handles and the qname table belong to one job at a time: a window
    waits for the job ahead before it starts one.  close() waits for the
    job and closes the handles."""

    def __init__(self):
        self.reads: List[Read] = []
        self.old_left_pos = 0
        self.old_right_fetch_read_pos = 0
        self.reset = True
        # arena-mode state
        self.cols: Optional[dict] = None
        self.arenas: dict = {}             # block id -> BamArena
        self.n_blocks = 0                  # block ids given so far
        self.left_most = 0                 # every row's pos is >= this
        self._names = None                 # NameTable of the qname keys
        self._handles: dict = {}           # BAM index -> IntakeHandle
        self._ahead = None                 # (intake key, started job)

    def intake(self, bams, key: tuple, stats=None) -> list:
        """The intake of `key` = (tid, left_fetch, right_fetch, fresh):
        the job ahead's when it was started for `key`, else one run
        now."""
        ahead, self._ahead = self._ahead, None
        if ahead is not None:
            if ahead[0] == key:
                if stats is not None:
                    stats.count("reads.ahead_used", 1)
                return self._finish(ahead[1], stats)
            self._settle(ahead, stats)
        return self._finish(self._start(bams, key))

    def read_ahead(self, bams, key: tuple, stats=None) -> None:
        """Start the job of `key` ahead."""
        if self._ahead is not None:
            ahead, self._ahead = self._ahead, None
            self._settle(ahead, stats)
        self._ahead = (key, self._start(bams, key))

    def _start(self, bams, key: tuple):
        """(job or None, the error that ends the BAM list or None): the
        job covers the BAMs before the first whose header lacks `tid`."""
        tid, left_fetch, right_fetch, fresh = key
        if self._names is None:
            self._names = NameTable()
        if fresh:
            self._names.clear()
        handles, tids, err = [], [], None
        for b_idx, bam in enumerate(bams):
            try:
                tids.append(bam.header.tid_of(tid))
            except KeyError:
                err = WindowError("Cannot find ID!")
                break
            h = self._handles.get(b_idx)
            if h is None:
                h = self._handles[b_idx] = IntakeHandle(bam.path)
            handles.append(h)
        job = None
        if handles:
            # the names of rows the buffer no longer holds leave the table
            job = IntakeJob(handles, self._names, tids,
                            max(0, int(left_fetch)), int(right_fetch),
                            int(left_fetch), 0 if fresh else self.left_most,
                            FDUP | FQCFAIL | FSUPPLEMENTARY)
        return job, err

    @staticmethod
    def _finish(started, stats=None) -> list:
        """Per BAM, an IntakeBlock with its pool's columns; a BAM that
        cannot be fetched ends the list with its error, which
        _buffer_arenas raises after the earlier BAMs' own checks, in the
        order of the reference's per-BAM loop.  With `stats`, the job's
        seconds (its native thread's clock) go to get_reads.ahead."""
        import numpy as np
        job, err = started
        out = []
        if job is not None:
            blocks = job.blocks()
            if stats is not None:
                stats.add_seconds("get_reads.ahead", job.seconds)
            for b_idx, blk in enumerate(blocks):
                if blk is None:
                    out.append(_ArenaUnavailable())
                    return out
                c = blk.cols
                c["mq"] = _MAPQ_TABLE[c.pop("mapq")]
                c["pool"] = np.full(c["row"].shape[0], b_idx, np.int64)
                out.append(blk)
        if err is not None:
            out.append(err)
        return out

    @staticmethod
    def _settle(ahead, stats) -> None:
        # wait for a discarded job, so the handles and the table are free
        job = ahead[1][0]
        if job is not None:
            job.wait()
        if stats is not None:
            if job is not None:
                stats.add_seconds("get_reads.ahead", job.seconds)
            stats.count("reads.ahead_refetched", 1)

    def close(self) -> None:
        """Wait for the job ahead, close the intake handles and the qname
        table."""
        ahead, self._ahead = self._ahead, None
        if ahead is not None:
            self._settle(ahead, None)
        for h in self._handles.values():
            h.close()
        self._handles = {}
        if self._names is not None:
            self._names.close()
            self._names = None


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
              buf: ReadBuffer, impl: str = "arena",
              stats=None, next_window=None) -> List[Read]:
    """DetInDel::getReads (DInDel.cpp:885-1262).

    impl='arena' (production) keeps the sliding buffer as raw BAM arena
    columns and materializes Read objects only for cascade survivors;
    impl='array' runs the same vectorized cascade over a buffer of Read
    objects; impl='loop' is the read-at-a-time port, kept as the
    reference implementation.  All three are asserted identical in
    tests/test_reads_array.py.

    next_window ((tid, left_pos, right_pos) of the window the caller
    stages next, or None): the arena path starts that window's intake
    ahead (ReadBuffer.read_ahead).

    stats (an engine.stats.RunStats, or None for none): the arena path
    times its stages get_reads.fetch (the intake, or the wait for the
    job ahead and the copy of its rows), get_reads.buffer and
    get_reads.cascade, and adds the seconds of each job ahead it takes
    to get_reads.ahead; it counts reads.records_fetched
    (records the intake decoded), reads.kept (reads returned),
    reads.ahead_used (intakes taken from the read-ahead) and
    reads.ahead_refetched (read-aheads discarded)."""
    if left_pos < buf.old_left_pos:
        raise RuntimeError("Windows are not sorted!")
    if int(right_pos - left_pos) < 3 * params.min_read_overlap:
        raise WindowError("Choose a larger width or a smaller minReadOverlap.")
    if impl == "arena":
        if (all(isinstance(b, NativeBamReader) for b in bams)
                and intake_lib() is not None):
            try:
                return _get_reads_arena(bams, tid, left_pos, right_pos,
                                        params, libraries, buf, stats,
                                        next_window)
            except _ArenaUnavailable:
                pass  # no .bai: record-iterator path below
        impl = "array"  # pure-Python reader fallback

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

    if impl == "array":
        return _cascade_array(buf, qids, left_pos, right_pos, left_most,
                              right_most, params)

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


def _get_reads_arena(bams, tid: str, left_pos: int, right_pos: int,
                     params: Parameters, libraries: LibraryCollection,
                     buf: ReadBuffer, stats=None,
                     next_window=None) -> List[Read]:
    """getReads with the sliding buffer held as raw BAM arena columns
    (io.bam_native.BamArena): the native intake (io/reads_intake.py)
    decodes each BAM's records and does the flag and position prefilter
    and the qname keys; the buffer's slide, the duplicate check and the
    whole filter cascade run as array ops, and Read objects are
    materialized (field-for-field as read_from_bam) only for cascade
    survivors.  With `next_window` the next window's intake starts
    ahead once this window's buffer is built."""
    max_dev = int(libraries.get_max_insert_size())
    right_fetch = right_pos + max_dev
    right_most = right_pos + max_dev
    left_fetch = _u32(left_pos - max_dev - LEFTPAD)
    left_most = _u32(left_pos - max_dev - LEFTPAD)

    rg2libs = [b.header.rg_to_library() for b in bams]

    fresh = buf.reset or buf.cols is None
    if not fresh and left_most < buf.old_right_fetch_read_pos:
        left_fetch = buf.old_right_fetch_read_pos

    def stage(name):
        return (stats.stage(name) if stats is not None
                else contextlib.nullcontext())

    fetched = []
    if left_fetch <= right_fetch:
        with stage("get_reads.fetch"):
            fetched = buf.intake(bams, (tid, left_fetch, right_fetch, fresh),
                                 stats)
        if stats is not None:
            stats.count("reads.records_fetched", sum(
                b.n_decoded for b in fetched if not isinstance(b, Exception)))
    with stage("get_reads.buffer"):
        _buffer_arenas(buf, fresh, fetched, left_fetch, right_fetch,
                       left_most, params)
    if next_window is not None:
        key = _ahead_key(buf, next_window, max_dev)
        if key is not None:
            buf.read_ahead(bams, key, stats)
    with stage("get_reads.cascade"):
        reads = _cascade_arena(buf, left_pos, right_pos, left_most,
                               right_most, params, libraries, rg2libs)
    if stats is not None:
        stats.count("reads.kept", len(reads))
    return reads


def _ahead_key(buf: ReadBuffer, next_window, max_dev: int):
    """The intake key of the next window by the rules of _get_reads_arena,
    for this buffer if it is not reset; None when it fetches nothing."""
    tid, left_pos, right_pos = next_window
    right_fetch = right_pos + max_dev
    left_fetch = _u32(left_pos - max_dev - LEFTPAD)
    if left_fetch < buf.old_right_fetch_read_pos:
        left_fetch = buf.old_right_fetch_read_pos
    if left_fetch > right_fetch:
        return None
    return (tid, left_fetch, right_fetch, False)


def _empty_cols() -> dict:
    import numpy as np
    i64 = lambda: np.empty(0, np.int64)
    b = lambda: np.empty(0, bool)
    return dict(pos=i64(), size=i64(), end=i64(), unmapped=b(),
                mate_unm=b(), same_tid=b(), mq=np.empty(0, np.float64),
                reverse=b(), mate_pos0=i64(), qid=i64(), row=i64(),
                pool=i64(), blk=i64())


def _buffer_arenas(buf: ReadBuffer, fresh: bool, fetched: list,
                   left_fetch: int, right_fetch: int, left_most: int,
                   params: Parameters) -> None:
    """The arena buffer slid to left_most (emptied when `fresh`), the
    intake's rows appended after the per-BAM cap checks, then the
    duplicate check: array ops only."""
    import numpy as np

    buf.left_most = left_most
    if fresh:
        buf.cols = _empty_cols()
        buf.arenas = {}
        buf.old_right_fetch_read_pos = right_fetch
    else:
        keep = buf.cols["pos"] >= left_most
        if not keep.all():
            buf.cols = {k: v[keep] for k, v in buf.cols.items()}
            # arenas older than every row left are no longer read
            lo = (int(buf.cols["blk"].min()) if buf.cols["blk"].shape[0]
                  else buf.n_blocks)
            buf.arenas = {k: a for k, a in buf.arenas.items() if k >= lo}

    if left_fetch <= right_fetch:
        cap = params.max_reads * 100
        n_buf = buf.cols["pos"].shape[0]
        for blk in fetched:
            if isinstance(blk, Exception):
                raise blk
            if n_buf + blk.n_flag_kept > cap:
                raise WindowError("Too many reads in region")
        buf.old_right_fetch_read_pos = right_fetch

        parts = [buf.cols]
        for blk in fetched:
            n = blk.cols["row"].shape[0]
            if n == 0:
                continue
            buf.arenas[buf.n_blocks] = blk.arena
            parts.append(dict(blk.cols,
                              blk=np.full(n, buf.n_blocks, np.int64)))
            buf.n_blocks += 1
        if len(parts) > 1:
            buf.cols = {k: np.concatenate([p[k] for p in parts])
                        for k in buf.cols}

    # duplicate check (DInDel.cpp:1018-1034)
    if buf.cols["qid"].shape[0]:
        _, counts = np.unique(buf.cols["qid"], return_counts=True)
        if (counts > 2).any():
            raise WindowError("duplicate reads!")


def _cascade_arena(buf: ReadBuffer, left_pos: int, right_pos: int,
                   left_most: int, right_most: int, params: Parameters,
                   libraries: LibraryCollection, rg2libs) -> List[Read]:
    """The filter cascade over the arena buffer, survivors materialized
    straight from the arena columns."""
    cols = buf.cols
    blk, row, pool = cols["blk"], cols["row"], cols["pool"]

    def ref(i: int) -> tuple:
        return buf.arenas[int(blk[i])], int(row[i]), int(pool[i])

    def lib_of(j: int):
        arena, r, p = ref(j)
        return read_from_bam(arena.record(r), libraries, p,
                             rg2libs[p]).get_library()

    # With only the built-in single_end library loaded (no --libFile),
    # EVERY paired read resolves to unknown_lib + the single_end
    # fallback no matter what its RG tag says — skip the per-read aux
    # scan entirely.  (Guarded against the pathological header that
    # names a library literally "single_end", where the lookup would
    # succeed and unknown_lib would differ.)
    skip_rg = (len(libraries) == 1
               and all("single_end" not in m.values() for m in rg2libs))

    def materialize_batch(idxs):
        """Survivor Reads built straight from the arena columns — no
        BamRecord, no per-field python; field-for-field identical to
        read_from_bam (asserted loop==array==arena in
        tests/test_reads_array.py and vs the compiled reference in
        tests/test_reads_ref.py)."""
        refs = [ref(i) for i in idxs]
        stats = _batch_pos_stats(refs)
        return [_read_from_arena(rf, cols, i, libraries, rg2libs, skip_rg,
                                 pos_stat=st)
                for rf, i, st in zip(refs, idxs, stats)]

    return _cascade_core(cols, left_pos, right_pos, left_most, right_most,
                         params, materialize=None, lib_of=lib_of,
                         materialize_batch=materialize_batch)


import numpy as _np
import math as _math
# mapq byte -> clamped probability, exactly read_from_bam's float ops
_MAPQ_TABLE = _np.array(
    [min(max(1.0 - _math.pow(10.0, -q / 10.0), 1e-16), 1 - 1e-16)
     for q in range(256)], _np.float64)


class _ArenaBamView:
    """Light stand-in for a survivor Read's .bam record: the four fields
    the hot path touches (haplotype-distribution ingestion) are plain
    attributes; anything else (realigned-BAM writing, aux matching,
    cigar tuples) lazily materializes the full BamRecord and delegates."""

    __slots__ = ("_arena", "_row", "_rec0", "flag", "pos", "cigar_raw",
                 "seq")

    def __init__(self, arena, row, flag, pos, cigar_raw, seq):
        self._arena = arena
        self._row = row
        self._rec0 = None
        self.flag = flag
        self.pos = pos
        self.cigar_raw = cigar_raw
        self.seq = seq

    def _rec(self):
        if self._rec0 is None:
            self._rec0 = self._arena.record(self._row)
        return self._rec0

    def __getattr__(self, name):
        # never delegate private/dunder lookups (copy/pickle protocols
        # probe them on half-initialized instances -> recursion)
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._rec(), name)

    def __copy__(self):
        # consumers that copy-and-mutate (realigned-BAM writer) get a
        # real mutable BamRecord
        import copy
        return copy.copy(self._rec())



def _batch_pos_stats(refs_batch):
    """computePositionStatistics for a whole survivor batch, vectorized
    over the concatenated arena cigar columns (replaces the two
    per-read python op loops in _read_from_arena; identical integer
    mean accumulation and float variance fold order — np.add.reduceat
    applies the ufunc sequentially within each segment)."""
    out = [None] * len(refs_batch)
    by_arena = {}
    for j, (arena, row, _pool) in enumerate(refs_batch):
        by_arena.setdefault(id(arena), (arena, []))[1].append((j, row))
    for arena, items in by_arena.values():
        js = _np.fromiter((j for j, _ in items), _np.int64, len(items))
        rows = _np.fromiter((r for _, r in items), _np.int64, len(items))
        starts = arena.cigar_off[rows]
        counts = arena.cigar_off[rows + 1] - starts
        # empty-CIGAR rows (unmapped placeholders) -> (-1, -1); they must
        # not enter the segment math (their seg_first would index past
        # the flat arrays)
        nz = counts > 0
        for j in js[~nz]:
            out[j] = (-1.0, -1.0)
        js = js[nz]
        starts = starts[nz]
        counts = counts[nz]
        total = int(counts.sum())
        n = len(js)
        if total == 0:
            continue
        seg = _np.repeat(_np.arange(n), counts)
        base = _np.repeat(starts, counts)
        off = _np.arange(total) - _np.repeat(
            _np.cumsum(counts) - counts, counts)
        cig = _np.asarray(arena.cigar)[base + off].astype(_np.int64)
        ops = cig & 0xF
        lens = cig >> 4
        isM = ops == 0
        # p_ advances on M/D/S/H; tot on M only (both exclusive prefixes)
        advP = _np.where((ops == 0) | (ops == 2) | (ops == 4) | (ops == 5),
                         lens, 0)
        advT = _np.where(isM, lens, 0)
        cP = _np.cumsum(advP)
        cT = _np.cumsum(advT)
        seg_first = _np.cumsum(counts) - counts
        pb = (cP - advP) - _np.repeat((cP - advP)[seg_first], counts)
        tb = (cT - advT) - _np.repeat((cT - advT)[seg_first], counts)
        mean_c = advT * (pb - tb)
        tot = _np.add.reduceat(advT, seg_first)
        mean = _np.add.reduceat(mean_c, seg_first)
        has = tot > 0
        dmean = _np.where(has, mean / _np.maximum(tot, 1), 0.0)
        var_c = advT * ((pb - tb) - dmean[seg]) ** 2
        var = _np.add.reduceat(var_c, seg_first)
        for k in range(n):
            if has[k]:
                out[js[k]] = (float(dmean[k]), float(var[k] / tot[k]))
            else:
                out[js[k]] = (-1.0, -1.0)
    return out


def _read_from_arena(ref, cols, i, libraries, rg2libs,
                     skip_rg=False, pos_stat=None) -> Read:
    """read_from_bam built straight from arena columns (no BamRecord):
    the clamped mapQual/base probabilities, position statistics and
    library lookup use the identical float ops and rules."""
    from ..io.bam import FPAIRED, FMREVERSE, _parse_tags

    arena, row, pool = ref
    flag = int(arena.fixed[row, 3])
    s0 = arena.seq_off[row]
    s1 = arena.seq_off[row + 1]
    seq = bytes(arena.seq_b[s0:s1]).decode()
    qual = _PHRED_TABLE[_np.frombuffer(arena.qual_b[s0:s1], _np.uint8)]
    raw = _np.ascontiguousarray(
        arena.cigar[arena.cigar_off[row]:arena.cigar_off[row + 1]])
    pos = int(cols["pos"][i])
    # computePositionStatistics (model.mean_first_base_position) on the
    # packed numeric ops: M=0 I=1 D=2 N=3 S=4 H=5; batched callers pass
    # the vectorized _batch_pos_stats result instead
    if pos_stat is None:
        p_ = 0
        tot = 0
        mean = 0
        ops = raw.tolist()
        for v in ops:
            op = v & 0xF
            ln = v >> 4
            if op == 0:
                mean += ln * (p_ - tot)
                tot += ln
            if op == 0 or op == 2 or op == 4 or op == 5:
                p_ += ln
        if tot == 0:
            pos_stat = (-1.0, -1.0)
        else:
            dmean = mean / tot
            p_ = 0
            tot = 0
            var = 0.0
            for v in ops:
                op = v & 0xF
                ln = v >> 4
                if op == 0:
                    var += ln * ((p_ - tot) - dmean) ** 2
                    tot += ln
                if op == 0 or op == 2 or op == 4 or op == 5:
                    p_ += ln
            pos_stat = (dmean + pos, var / tot)
    elif pos_stat[0] != -1.0:
        pos_stat = (pos_stat[0] + pos, pos_stat[1])

    is_paired = bool(flag & FPAIRED)
    if is_paired:
        if skip_rg:
            lib_name = "dindel_default"
        else:
            a0 = arena.aux_off[row]
            a1 = arena.aux_off[row + 1]
            rg = None
            if a1 > a0:
                for tag, _typ, val in _parse_tags(bytes(arena.aux_b[a0:a1]),
                                                  0):
                    if tag == "RG":
                        rg = val
                        break
            lib_name = rg2libs[pool].get(rg, "dindel_default") if rg \
                else "dindel_default"
    else:
        lib_name = "single_end"
    library = libraries.get(lib_name)
    unknown_lib = False
    if library is None:
        unknown_lib = True
        library = libraries["single_end"]

    view = _ArenaBamView(arena, int(row), flag, pos, raw, seq)
    r = Read(seq=seq, qual=qual, map_qual=float(cols["mq"][i]),
             pos=pos, pos_stat_first=pos_stat[0], pos_stat_var=pos_stat[1],
             on_reverse_strand=bool(cols["reverse"][i]),
             is_unmapped=bool(cols["unmapped"][i]),
             is_paired=is_paired,
             mate_is_unmapped=bool(cols["mate_unm"][i]),
             mate_is_reverse=bool(flag & FMREVERSE),
             same_tid_as_mate=bool(cols["same_tid"][i]),
             mate_pos=int(cols["mate_pos0"][i]), mate_len=-1,
             pool_id=pool, library=library,
             qname=arena.qname_bytes(row).decode(), bam=view)
    r.unknown_lib = unknown_lib
    r.bam_end = int(cols["end"][i])
    return r


def _copy_read(r: Read) -> Read:
    # fast shallow copy (copy.copy routes through __reduce_ex__ and was
    # the hottest call in get_reads); qual stays shared, read-only
    c = Read.__new__(Read)
    c.__dict__.update(r.__dict__)
    return c


def _cascade_array(buf: ReadBuffer, qids: List[int], left_pos: int,
                   right_pos: int, left_most: int, right_most: int,
                   params: Parameters) -> List[Read]:
    """The getReads filter cascade (DInDel.cpp:1068-1226) vectorized over
    a buffer of Read objects; Read objects are copied only for the
    survivors.  Behavior is asserted identical to the loop implementation
    in tests/test_reads_array.py."""
    import numpy as np

    reads_buf = buf.reads
    n = len(reads_buf)
    cols = dict(
        pos=np.fromiter((r.pos for r in reads_buf), np.int64, n),
        size=np.fromiter((len(r.seq) for r in reads_buf), np.int64, n),
        end=np.fromiter((r.bam_end for r in reads_buf), np.int64, n),
        unmapped=np.fromiter((r.is_unmapped for r in reads_buf), bool, n),
        mate_unm=np.fromiter((r.mate_is_unmapped for r in reads_buf),
                             bool, n),
        same_tid=np.fromiter((r.same_tid_as_mate for r in reads_buf),
                             bool, n),
        mq=np.fromiter((r.map_qual for r in reads_buf), np.float64, n),
        reverse=np.fromiter((r.on_reverse_strand for r in reads_buf),
                            bool, n),
        mate_pos0=np.fromiter((r.mate_pos for r in reads_buf), np.int64, n),
        qid=np.asarray(qids, np.int64))
    return _cascade_core(cols, left_pos, right_pos, left_most, right_most,
                         params,
                         materialize=lambda i: reads_buf[i],
                         lib_of=lambda j: reads_buf[j].get_library())


def _cascade_core(cols: dict, left_pos: int, right_pos: int,
                  left_most: int, right_most: int, params: Parameters,
                  materialize, lib_of, materialize_batch=None) -> List[Read]:
    """Cascade body shared by the Read-object and arena buffers: all
    filters/mutations run on the column arrays; `materialize(i)` yields
    the buffer Read template to copy for a survivor, `lib_of(j)` the
    library of buffer read j (unmapped-mate realignment only)."""
    import numpy as np

    pos = cols["pos"]
    size = cols["size"]
    end = cols["end"]
    unmapped = cols["unmapped"]
    mate_unm = cols["mate_unm"]
    same_tid = cols["same_tid"]
    mq = cols["mq"]
    reverse = cols["reverse"]
    qid = cols["qid"]
    n = pos.shape[0]

    # pair partner (same qname; <=2 per qname guaranteed by the dup check)
    partner = np.full(n, -1, np.int64)
    if n:
        order = np.argsort(qid, kind="stable")
        qs = qid[order]
        adj = qs[1:] == qs[:-1]
        a = order[:-1][adj]
        b = order[1:][adj]
        partner[a] = b
        partner[b] = a
    has_partner = partner != -1
    # partner views (safe defaults where absent)
    psize = np.where(has_partner, size[np.clip(partner, 0, None)], -1)
    ppos = np.where(has_partner, pos[np.clip(partner, 0, None)], -1)

    # NB: the reference's branch bodies ASSIGN filt (DInDel.cpp:1103-1213),
    # so a successful mate lookup clears the earlier size/extent filters —
    # quirk preserved by np.where overwrites below, matching the loop port
    filt = ((size > params.max_read_length)
            | (end < left_most) | (pos > right_most))
    mapped = ~unmapped
    overlap_bad = ((pos + size < left_pos + params.min_read_overlap)
                   | (pos > right_pos - params.min_read_overlap))
    filt = np.where(mapped & overlap_bad, True, filt)

    mate_pos_new = cols["mate_pos0"].copy()
    mate_len_new = np.full(n, -1, np.int64)
    mq_new = mq.copy()

    # mapped read, mapped mate on the same tid: must find its pair in the
    # buffer (DInDel.cpp:1103-1140); cross-tid mates pass unfiltered
    caseA = mapped & ~overlap_bad & ~mate_unm & same_tid
    partner_mapped = has_partner & ~unmapped[np.clip(partner, 0, None)]
    ok_a = caseA & partner_mapped
    filt = np.where(caseA, ~partner_mapped, filt)
    mate_len_new = np.where(ok_a, psize, mate_len_new)
    mate_pos_new = np.where(ok_a, ppos, mate_pos_new)

    # mapped read, unmapped mate: matePos := own pos; mate must be present
    caseB = mapped & ~overlap_bad & mate_unm
    partner_unmapped = has_partner & unmapped[np.clip(partner, 0, None)]
    mate_pos_new = np.where(caseB, pos, mate_pos_new)
    ok_b = caseB & partner_unmapped
    filt = np.where(caseB, ~partner_unmapped, filt)
    mate_len_new = np.where(ok_b, psize, mate_len_new)

    # unmapped reads: realign near the mapped mate when enabled
    # (DInDel.cpp:1159-1213); per-read Python, they are few
    revcomp = np.zeros(n, bool)
    if unmapped.any():
        if params.map_unmapped_reads:
            for i in np.nonzero(unmapped)[0]:
                j = partner[i]
                if j == -1 or unmapped[j]:
                    filt[i] = True
                    continue
                max_insert = lib_of(int(j)).get_max_insert_size()
                rpos = pos[j]
                if reverse[j]:
                    range_l, range_r = rpos - max_insert, rpos
                else:
                    range_l, range_r = rpos, rpos + max_insert
                if range_r > left_pos and range_l < right_pos:
                    filt[i] = False
                    # order-dependent reference quirk (DInDel.cpp:1180):
                    # mapQual is copied from the mate AFTER the mate's own
                    # filtering may have set it to -1 — but only when the
                    # mate precedes this read in the buffer.  An unmapped
                    # read whose earlier mapped mate was filtered is thus
                    # dropped at the mapQual cutoff.
                    mq_new[i] = -1.0 if (filt[j] and j < i) else mq[j]
                    mate_pos_new[i] = pos[j]
                    mate_len_new[i] = size[j]
                    if reverse[i] == reverse[j]:
                        revcomp[i] = True
                else:
                    filt[i] = True
        else:
            filt = np.where(unmapped, True, filt)

    mq_new[filt] = -1.0

    # sort by decreasing mapQual with the reference's exact (UNSTABLE
    # libstdc++ introsort) tie permutation, cap maxReads
    # (DInDel.cpp:1218-1226; see engine/std_sort.py)
    from .std_sort import mapqual_sort_order
    min_map_qual = max(params.map_qual_threshold, 0.0)
    order = mapqual_sort_order(mq_new)
    sorted_mq = mq_new[order]
    below = sorted_mq < min_map_qual
    cut = int(np.argmax(below)) if below.any() else n
    cut = min(cut, params.max_reads)

    reads: List[Read] = []
    idxs = [int(i) for i in order[:cut]]
    if materialize_batch is not None:
        # fresh Reads straight from the arena columns (no cached
        # template, so no defensive copy needed)
        base = materialize_batch(idxs)
    else:
        base = [_copy_read(materialize(i)) for i in idxs]
    for r, i in zip(base, idxs):
        r.map_qual = float(mq_new[i])
        r.mate_pos = int(mate_pos_new[i])
        if mate_len_new[i] != -1:
            r.mate_len = int(mate_len_new[i])
        else:
            r.mate_len = -1
        if revcomp[i]:
            reverse_in_place(r)
            complement_in_place(r)
        if r.mate_pos == -1 and r.is_paired and not r.mate_is_unmapped:
            r.mate_pos = r.pos
        reads.append(r)

    if params.filter_read_aux and len(params.filter_read_aux) > 1:
        exclude = params.filter_read_aux[0] != "+"
        match = params.filter_read_aux[1:]
        reads = [r for r in reads
                 if (match in r.bam.aux_string()) != exclude]

    if len(reads) < 2:
        raise WindowError("too_few_reads")
    if len(reads) >= params.max_reads:
        raise WindowError("above_read_count_threshold")
    return reads
