"""ctypes binding for the native block algebra (native/hapdist.cpp).

Drop-in replacement for the read-ingestion side of
engine.hapgen.HaplotypeDistribution — the hottest host stage after the
arena read path (≈50 recursive block operations per read as pure
Python).  Block selection/pruning/enumeration stay in engine.hapgen
(HDIterator) and consume the exported block structure, so the two
implementations share everything downstream.  Exact equivalence with the
Python implementation (same blocks, haps, counts, types, freqs, same
error strings) is asserted in tests/test_hapgen_native.py.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict

import numpy as np

from ..native_build import native_so

from ..io.bam import FMUNMAP
from .hapgen import (B_INSERT, BlockHap, HapBlock, HapGenError,
                     HaplotypeDistribution)

_lib = None
_lib_tried = False
_build_lock = threading.Lock()

_ERR_MSG = {
    1: "Empty haplotype!",
    2: "seq outside of block boundaries",
    3: "updateBlock-seq mismatch.",
    4: "Cannot handle this case.",
    5: "Mag niet.",
    6: "I don't know how to smoke this CIGAR",
}

_OP_IDX = {op: i for i, op in enumerate("MIDNSHP=X")}

_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_U32P = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
_F64P = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def native_lib():
    """Load (building if needed) libdindel_hapdist.so; None if unavailable."""
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    with _build_lock:
        if _lib_tried:
            return _lib
        _lib_tried = True
        so = native_so("hapdist.cpp", "libdindel_hapdist.so")
        if so is not None:
            try:
                lib = ctypes.CDLL(str(so))
            except OSError:
                return None
            c = ctypes
            lib.hapdist_new.restype = c.c_void_p
            lib.hapdist_new.argtypes = [c.c_char_p, c.c_int64, c.c_int64]
            lib.hapdist_free.argtypes = [c.c_void_p]
            lib.hapdist_insert_read.restype = c.c_int32
            lib.hapdist_insert_read.argtypes = [
                c.c_void_p, c.c_int64, _U32P, c.c_int32, c.c_char_p,
                c.c_int64]
            lib.hapdist_insert_reads.restype = c.c_int32
            lib.hapdist_insert_reads.argtypes = [
                c.c_void_p, c.c_int64, _I64P, _U32P, _I64P, c.c_char_p,
                _I64P]
            lib.hapdist_set_freqs.argtypes = [c.c_void_p]
            lib.hapdist_counts.argtypes = [c.c_void_p] + [
                c.POINTER(c.c_int64)] * 4
            lib.hapdist_export.argtypes = [
                c.c_void_p, _I64P, _I64P, _I32P, _I64P, _I32P, _I64P,
                _F64P, _I64P, c.c_char_p]
            _lib = lib
    return _lib


class NativeHaplotypeDistribution:
    """Same interface as hapgen.HaplotypeDistribution for the engine's
    use (insert_read / set_frequencies / blocks / insertions / mid_pos);
    the per-read work runs in C++ and the final block structure is
    exported once, after which HDIterator proceeds unchanged."""

    def __init__(self, mid_pos: int, ref_seq: str, ref_seq_start: int):
        lib = native_lib()
        self._lib = lib
        self.mid_pos = mid_pos
        self._h = lib.hapdist_new(ref_seq.encode(), len(ref_seq),
                                  ref_seq_start)
        if not self._h:
            raise HapGenError("Empty haplotype!")
        self.blocks = None
        self.insertions: Dict[int, HapBlock] = {}

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.hapdist_free(h)
            self._h = None

    def insert_reads(self, recs) -> None:
        """One native call for the whole window's reads (identical
        sequential first-error semantics to the per-read loop)."""
        pos, cigs, seqs = [], [], []
        clens, slens = [], []
        for rec in recs:
            if rec.flag & FMUNMAP:
                continue
            raw = getattr(rec, "cigar_raw", None)
            if raw is None:
                raw = np.fromiter(((ln << 4) | _OP_IDX[op]
                                   for op, ln in rec.cigar), np.uint32,
                                  len(rec.cigar))
            pos.append(rec.pos)
            cigs.append(raw)
            clens.append(len(raw))
            seqs.append(rec.seq)
            slens.append(len(rec.seq))
        n = len(pos)
        if n == 0:
            return
        cig_off = np.zeros(n + 1, np.int64)
        np.cumsum(clens, out=cig_off[1:])
        seq_off = np.zeros(n + 1, np.int64)
        np.cumsum(slens, out=seq_off[1:])
        cig_cat = (np.concatenate(cigs).astype(np.uint32, copy=False)
                   if cig_off[-1] else np.zeros(1, np.uint32))
        seq_cat = "".join(seqs).encode()
        rc = self._lib.hapdist_insert_reads(
            self._h, n, np.asarray(pos, np.int64),
            np.ascontiguousarray(cig_cat), cig_off, seq_cat, seq_off)
        if rc:
            raise HapGenError(_ERR_MSG[rc])

    def insert_read(self, rec) -> None:
        if rec.flag & FMUNMAP:
            return
        raw = getattr(rec, "cigar_raw", None)
        if raw is None:
            raw = np.fromiter(((ln << 4) | _OP_IDX[op]
                               for op, ln in rec.cigar), np.uint32,
                              len(rec.cigar))
        seq = rec.seq.encode()
        rc = self._lib.hapdist_insert_read(self._h, rec.pos, raw,
                                           len(raw), seq, len(seq))
        if rc:
            raise HapGenError(_ERR_MSG[rc])

    def set_frequencies(self) -> None:
        lib = self._lib
        c = ctypes.c_int64
        n_norm, n_ins, n_haps, sbytes = c(), c(), c(), c()
        lib.hapdist_set_freqs(self._h)
        lib.hapdist_counts(self._h, ctypes.byref(n_norm),
                           ctypes.byref(n_ins), ctypes.byref(n_haps),
                           ctypes.byref(sbytes))
        nb = n_norm.value + n_ins.value
        nh = n_haps.value
        pos0 = np.empty(max(nb, 1), np.int64)
        pos1 = np.empty(max(nb, 1), np.int64)
        btype = np.empty(max(nb, 1), np.int32)
        hap_off = np.empty(nb + 1, np.int64)
        htype = np.empty(max(nh, 1), np.int32)
        hcount = np.empty(max(nh, 1), np.int64)
        hfreq = np.empty(max(nh, 1), np.float64)
        seq_off = np.empty(nh + 1, np.int64)
        arena = ctypes.create_string_buffer(max(sbytes.value, 1))
        lib.hapdist_export(self._h, pos0, pos1, btype, hap_off, htype,
                           hcount, hfreq, seq_off, arena)
        raw = arena.raw
        self.blocks = []
        self.insertions = {}
        for b in range(nb):
            hb = HapBlock.__new__(HapBlock)
            hb.pos0 = int(pos0[b])
            hb.pos1 = int(pos1[b])
            hb.type = int(btype[b])
            hb.haps = {}
            for hI in range(hap_off[b], hap_off[b + 1]):
                s = raw[seq_off[hI]:seq_off[hI + 1]].decode("latin-1")
                hb.haps[s] = BlockHap(s, int(htype[hI]), int(hcount[hI]),
                                      float(hfreq[hI]))
            if hb.type == B_INSERT:
                self.insertions[hb.pos0] = hb
            else:
                self.blocks.append(hb)


def make_hapdist(mid_pos: int, ref_seq: str, ref_seq_start: int):
    """Native HaplotypeDistribution when the library is available (the
    production path), else the pure-Python implementation.  Set
    DINDEL_HAPGEN=py to force the Python path."""
    if os.environ.get("DINDEL_HAPGEN") != "py" and native_lib() is not None:
        return NativeHaplotypeDistribution(mid_pos, ref_seq, ref_seq_start)
    return HaplotypeDistribution(mid_pos, ref_seq, ref_seq_start)
