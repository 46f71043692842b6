"""ctypes binding for the C++ BGZF/BAM decoder (native/bamio.cpp).

Drop-in faster replacement for io.bam.BamReader (the reference's libbam
role, Makefile:8): same header object, same ``__iter__`` / ``fetch``
record semantics, differential-tested against the pure-Python reader in
tests/test_io_native.py.  Records cross the boundary as batch arenas
(int32 fixed fields + offset-indexed byte arenas) and are materialized
into BamRecord objects with O(1) slicing per field.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Iterator, List, Optional

import numpy as np

from ..native_build import native_so

from .bam import BamHeader, BamRecord, CIGAR_OPS, _parse_tags

_lib = None
_lib_tried = False
_build_lock = threading.Lock()


def native_lib():
    """Load (building if needed) libdindel_bamio.so; None if unavailable."""
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    with _build_lock:
        if _lib_tried:
            return _lib
        _lib_tried = True
        so = native_so("bamio.cpp", "libdindel_bamio.so", libs=["-lz"])
        if so is not None:
            try:
                lib = ctypes.CDLL(str(so))
            except OSError:
                return None
            c = ctypes
            lib.dbam_open.restype = c.c_void_p
            lib.dbam_open.argtypes = [c.c_char_p]
            lib.dbam_close.argtypes = [c.c_void_p]
            lib.dbam_header_text_len.restype = c.c_int64
            lib.dbam_header_text_len.argtypes = [c.c_void_p]
            lib.dbam_header_text.argtypes = [c.c_void_p, c.c_char_p]
            lib.dbam_n_ref.restype = c.c_int32
            lib.dbam_n_ref.argtypes = [c.c_void_p]
            lib.dbam_ref_name_len.restype = c.c_int32
            lib.dbam_ref_name_len.argtypes = [c.c_void_p, c.c_int32]
            lib.dbam_ref_name.argtypes = [c.c_void_p, c.c_int32, c.c_char_p]
            lib.dbam_ref_len.restype = c.c_int32
            lib.dbam_ref_len.argtypes = [c.c_void_p, c.c_int32]
            lib.dbam_rewind.argtypes = [c.c_void_p]
            lib.dbam_read_batch.restype = c.c_int64
            lib.dbam_read_batch.argtypes = [c.c_void_p, c.c_int64]
            lib.dbam_fetch.restype = c.c_int64
            lib.dbam_fetch.argtypes = [c.c_void_p, c.c_int32, c.c_int64,
                                       c.c_int64]
            lib.dbam_arena_sizes.argtypes = [c.c_void_p] + [
                c.POINTER(c.c_int64)] * 5
            lib.dbam_batch.argtypes = [
                c.c_void_p,
                np.ctypeslib.ndpointer(np.int32, flags="C"),
                c.c_char_p, np.ctypeslib.ndpointer(np.int64, flags="C"),
                np.ctypeslib.ndpointer(np.uint32, flags="C"),
                np.ctypeslib.ndpointer(np.int64, flags="C"),
                c.c_char_p, c.c_char_p,
                np.ctypeslib.ndpointer(np.int64, flags="C"),
                c.c_char_p, np.ctypeslib.ndpointer(np.int64, flags="C")]
            _lib = lib
    return _lib


class NativeBamReader:
    """Same interface as io.bam.BamReader, backed by native/bamio.cpp."""

    BATCH = 4096

    def __init__(self, path: str):
        lib = native_lib()
        if lib is None:
            raise OSError("native bamio library unavailable")
        self._lib = lib
        self.path = path
        h = lib.dbam_open(path.encode())
        if not h:
            raise IOError(f"{path}: not a BAM file")
        self._h = h
        n = lib.dbam_header_text_len(h)
        buf = ctypes.create_string_buffer(max(n, 1))
        lib.dbam_header_text(h, buf)
        # keep raw l_text bytes (incl. any padding) — must equal the pure
        # Python reader's header.text for the differential test
        text = buf.raw[:n].decode(errors="replace")
        refs = []
        for tid in range(lib.dbam_n_ref(h)):
            ln = lib.dbam_ref_name_len(h, tid)
            nb = ctypes.create_string_buffer(max(ln, 1))
            lib.dbam_ref_name(h, tid, nb)
            refs.append((nb.raw[:ln].decode(), lib.dbam_ref_len(h, tid)))
        self.header = BamHeader(text=text, refs=refs)

    def close(self):
        if self._h:
            self._lib.dbam_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _drain_batch(self) -> List[BamRecord]:
        lib = self._lib
        c = ctypes.c_int64
        n, qn, cg, sq, ax = c(), c(), c(), c(), c()
        lib.dbam_arena_sizes(self._h, ctypes.byref(n), ctypes.byref(qn),
                             ctypes.byref(cg), ctypes.byref(sq),
                             ctypes.byref(ax))
        n = n.value
        if n == 0:
            return []
        fixed = np.empty((n, 8), np.int32)
        qname = ctypes.create_string_buffer(max(qn.value, 1))
        qname_off = np.empty(n + 1, np.int64)
        cigar = np.empty(max(cg.value, 1), np.uint32)
        cigar_off = np.empty(n + 1, np.int64)
        seq = ctypes.create_string_buffer(max(sq.value, 1))
        qual = ctypes.create_string_buffer(max(sq.value, 1))
        seq_off = np.empty(n + 1, np.int64)
        aux = ctypes.create_string_buffer(max(ax.value, 1))
        aux_off = np.empty(n + 1, np.int64)
        lib.dbam_batch(self._h, fixed, qname, qname_off, cigar, cigar_off,
                       seq, qual, seq_off, aux, aux_off)
        qname_b = qname.raw[:qn.value]
        seq_b = seq.raw[:sq.value]
        qual_b = qual.raw[:sq.value]
        aux_b = aux.raw[:ax.value]
        out = []
        fixed_l = fixed.tolist()
        qname_off = qname_off.tolist()
        cigar_off = cigar_off.tolist()
        seq_off = seq_off.tolist()
        aux_off = aux_off.tolist()
        for i in range(n):
            tid, pos, mapq, flag, mtid, mpos, isize, _l_seq = fixed_l[i]
            cig = [(CIGAR_OPS[int(v) & 0xF], int(v) >> 4)
                   for v in cigar[cigar_off[i]:cigar_off[i + 1]]]
            s0, s1 = seq_off[i], seq_off[i + 1]
            a0, a1 = aux_off[i], aux_off[i + 1]
            tags = _parse_tags(aux_b[a0:a1], 0) if a1 > a0 else []
            out.append(BamRecord(
                qname=qname_b[qname_off[i]:qname_off[i + 1]].decode(),
                flag=flag, tid=tid, pos=pos, mapq=mapq, cigar=cig,
                mtid=mtid, mpos=mpos, isize=isize,
                seq=seq_b[s0:s1].decode(), qual=qual_b[s0:s1], tags=tags))
        return out

    def __iter__(self) -> Iterator[BamRecord]:
        self._lib.dbam_rewind(self._h)
        while True:
            got = self._lib.dbam_read_batch(self._h, self.BATCH)
            if got == 0:
                return
            yield from self._drain_batch()

    def fetch(self, tid: int, beg: int, end: int) -> Iterator[BamRecord]:
        """bam_fetch semantics (same chunk walk as the Python reader);
        falls back to a sequential scan when no .bai is usable."""
        got = self._lib.dbam_fetch(self._h, tid, beg, end)
        if got < 0:
            # no index: sequential-scan fallback, mirroring io.bam
            for r in self:
                if r.tid == tid and r.pos < end and r.end_pos() > beg:
                    yield r
                elif r.tid > tid or (r.tid == tid and r.pos >= end):
                    break
            return
        yield from self._drain_batch()


class BamArena:
    """A fetched batch as raw column arrays (fixed int32 (n, 8) in
    tid/pos/mapq/flag/mtid/mpos/isize/l_seq order + offset-indexed byte
    arenas, bytes-like), the decoded records behind a window's read
    intake (io/reads_intake.py); record(i) materializes one BamRecord
    (same fields as _drain_batch) for the get_reads survivors."""

    __slots__ = ("fixed", "qname_b", "qname_off", "cigar", "cigar_off",
                 "seq_b", "qual_b", "seq_off", "aux_b", "aux_off",
                 "_records")

    def __init__(self, fixed, qname_b, qname_off, cigar, cigar_off,
                 seq_b, qual_b, seq_off, aux_b, aux_off):
        self.fixed = fixed
        self.qname_b = qname_b
        self.qname_off = qname_off
        self.cigar = cigar
        self.cigar_off = cigar_off
        self.seq_b = seq_b
        self.qual_b = qual_b
        self.seq_off = seq_off
        self.aux_b = aux_b
        self.aux_off = aux_off
        self._records = {}

    @property
    def n(self) -> int:
        return self.fixed.shape[0]

    def qname_bytes(self, i: int) -> bytes:
        return bytes(self.qname_b[self.qname_off[i]:self.qname_off[i + 1]])

    def record(self, i: int) -> BamRecord:
        rec = self._records.get(i)
        if rec is None:
            # .tolist() yields Python ints in one C call (the per-element
            # int() genexpr was ~5us/record)
            tid, pos, mapq, flag, mtid, mpos, isize, _l = (
                self.fixed[i].tolist())
            cig = [(CIGAR_OPS[v & 0xF], v >> 4) for v in
                   self.cigar[self.cigar_off[i]:self.cigar_off[i + 1]]
                   .tolist()]
            s0, s1 = self.seq_off[i], self.seq_off[i + 1]
            a0, a1 = self.aux_off[i], self.aux_off[i + 1]
            rec = BamRecord(
                qname=self.qname_bytes(i).decode(),
                flag=flag, tid=tid, pos=pos, mapq=mapq, cigar=cig,
                mtid=mtid, mpos=mpos, isize=isize,
                seq=bytes(self.seq_b[s0:s1]).decode(),
                qual=bytes(self.qual_b[s0:s1]),
                aux_raw=bytes(self.aux_b[a0:a1]) if a1 > a0 else None)
            # raw packed (len<<4|op) view for native consumers (hapdist)
            rec.cigar_raw = np.ascontiguousarray(
                self.cigar[self.cigar_off[i]:self.cigar_off[i + 1]])
            self._records[i] = rec
        return rec


def open_bam(path: str):
    """Open `path` with the native reader when available, else the pure
    Python one."""
    if native_lib() is not None:
        try:
            return NativeBamReader(path)
        except (OSError, IOError):
            pass
    from .bam import BamReader
    return BamReader(path)
