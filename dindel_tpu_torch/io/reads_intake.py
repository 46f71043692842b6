"""ctypes binding for the native read intake (native/reads_intake.cpp).

An `IntakeJob` runs a window's intakes, one per BAM, on a native thread
that never takes the GIL: each decodes a region (the records of
`NativeBamReader.fetch`, in its order), does the read buffer's
per-record work, the flag prefilter, the position filter and a qname key
per row, and packs the result into one buffer.  `IntakeJob.blocks()`
waits for the thread and takes each BAM's buffer over, as columns beside
its decoded arena (views, no copy), from which survivors materialize as
before (engine/reads.py)."""

from __future__ import annotations

import ctypes
import threading
import weakref
from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np

from ..native_build import native_so
from .bam_native import BamArena

_lib = None
_lib_tried = False
_build_lock = threading.Lock()

# the int64 and the bool columns of a block, in their packed order (the
# fifth uint8 column is the raw mapq byte)
INT_COLS = ("row", "pos", "size", "end", "mate_pos0", "qid")
BOOL_COLS = ("unmapped", "mate_unm", "same_tid", "reverse")
# dri_block's meta entries (native/reads_intake.cpp, enum M_*)
(M_FLAG_KEPT, M_ROWS, M_RECORDS, M_INT_COLS, M_U8_COLS, M_FIXED, M_OFFS,
 M_CIGAR, M_QNAME, M_SEQ, M_QUAL, M_AUX, M_QNAME_LEN, M_CIGAR_LEN,
 M_SEQ_LEN, M_AUX_LEN, M_TOTAL, M_N) = range(18)


def intake_lib():
    """The intake library's entry points (building it if needed), or None
    if unavailable.  dri_open and the wait for a running job release the
    GIL (ctypes.CDLL); the short calls keep it (ctypes.PyDLL)."""
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    with _build_lock:
        if _lib_tried:
            return _lib
        _lib_tried = True
        so = native_so("reads_intake.cpp", "libdindel_intake.so",
                       flags=("-O2", "-fvisibility=hidden", "-pthread"),
                       libs=["-lz"], deps=["bamio.cpp"])
        if so is None:
            return None
        try:
            free, held = ctypes.CDLL(str(so)), ctypes.PyDLL(str(so))
        except OSError:
            return None
        c = ctypes
        vp = c.c_void_p
        i64 = np.ctypeslib.ndpointer(np.int64, flags="C")
        i32 = np.ctypeslib.ndpointer(np.int32, flags="C")
        sig = {
            "dri_open": (free, vp, [c.c_char_p]),
            "dri_close": (free, None, [vp]),
            "dri_names_new": (held, vp, []),
            "dri_names_clear": (held, None, [vp]),
            "dri_names_free": (held, None, [vp]),
            "dri_names_size": (held, c.c_int64, [vp]),
            "dri_job_start": (held, vp, [c.POINTER(vp), c.c_int32, vp, i32,
                                         c.c_int64, c.c_int64, c.c_int64,
                                         c.c_int64, c.c_int32, i64]),
            "dri_job_done": (held, c.c_int32, [vp]),
            "dri_job_wait": (free, c.c_double, [vp]),
            "dri_block": (held, vp, [vp, c.POINTER(c.c_int64)]),
            "dri_free": (held, None, [vp]),
        }
        fns = {}
        for name, (lib, restype, argtypes) in sig.items():
            f = getattr(lib, name)
            f.restype = restype
            f.argtypes = argtypes
            fns[name] = f
        # the join of a finished job, without handing the GIL away
        fns["dri_job_join"] = held.dri_job_wait
        fns["dri_job_join"].restype = c.c_double
        fns["dri_job_join"].argtypes = [vp]
        _lib = SimpleNamespace(**fns)
    return _lib


class NameTable:
    """The qname keys of one read buffer (native): byte-equal names get
    equal keys until `clear()`, or until a job prunes the name (see
    IntakeJob).  Used by one job or thread at a time."""

    def __init__(self):
        self._lib = intake_lib()
        self._t = self._lib.dri_names_new()

    def clear(self):
        self._lib.dri_names_clear(self._t)

    def __len__(self):
        return self._lib.dri_names_size(self._t)

    def close(self):
        if self._t:
            self._lib.dri_names_free(self._t)
            self._t = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


@dataclass
class IntakeBlock:
    """One BAM's intake for one window: the decoded arena, the count of
    records decoded and of flag-kept records (the cap's count), and the
    kept rows' columns (`row` indexes the arena; `mapq` the raw byte)."""
    arena: BamArena
    n_decoded: int
    n_flag_kept: int
    cols: dict


class IntakeHandle:
    """A BAM opened by the intake library (its own file handle, index
    and inflated-block cache).  Used by one job at a time."""

    def __init__(self, path: str):
        self._lib = intake_lib()
        h = self._lib.dri_open(path.encode())
        if not h:
            raise IOError(f"{path}: not a BAM file")
        self._h = h
        self._meta = (ctypes.c_int64 * M_N)()

    def block(self, n_decoded: int) -> IntakeBlock:
        """The last intake's rows and arena (it decoded `n_decoded`):
        numpy arrays and memoryviews over its packed native buffer, which
        is freed once none of them is left (no copy)."""
        lib = self._lib
        ptr = lib.dri_block(self._h, self._meta)
        m = self._meta[:]
        # M_TOTAL is a power of two: ctypes keeps one array type per size
        mem = (ctypes.c_char * m[M_TOTAL]).from_address(ptr)
        weakref.finalize(mem, lib.dri_free, ptr)
        raw = memoryview(mem).cast("B")
        nr, n = m[M_ROWS], m[M_RECORDS]

        def arr(dtype, at, count):
            return np.frombuffer(raw, dtype, count, at)

        def byt(at, count):
            return raw[at:at + count]

        ints = arr(np.int64, m[M_INT_COLS], 6 * nr).reshape(6, nr)
        u8 = arr(np.uint8, m[M_U8_COLS], 5 * nr).reshape(5, nr)
        cols = dict(zip(INT_COLS, ints))
        cols.update(zip(BOOL_COLS, u8[:4].view(bool)))
        cols["mapq"] = u8[4]
        offs = arr(np.int64, m[M_OFFS], 4 * (n + 1)).reshape(4, n + 1)
        sq = m[M_SEQ_LEN]
        arena = BamArena(
            arr(np.int32, m[M_FIXED], 8 * n).reshape(n, 8),
            byt(m[M_QNAME], m[M_QNAME_LEN]), offs[0],
            arr(np.uint32, m[M_CIGAR], m[M_CIGAR_LEN]), offs[1],
            byt(m[M_SEQ], sq), byt(m[M_QUAL], sq), offs[2],
            byt(m[M_AUX], m[M_AUX_LEN]), offs[3])
        return IntakeBlock(arena, n_decoded, m[M_FLAG_KEPT], cols)

    def close(self):
        if self._h:
            self._lib.dri_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class IntakeJob:
    """One window's intakes: the records of [beg, end) on `tids[i]` of
    `handles[i]`, those with a bit of `drop_flags` dropped and those at
    pos < left_fetch left out of the columns, qname keys from `names`
    after the names of no record at or right of `prune_below` are
    dropped from it; run in order on a native thread from construction
    on.  The handles and the table are the job's until it is waited
    for."""

    def __init__(self, handles, names: NameTable, tids, beg: int, end: int,
                 left_fetch: int, prune_below: int, drop_flags: int):
        lib = intake_lib()
        self._lib = lib
        self._handles = list(handles)
        self._names = names
        n = len(self._handles)
        # kept alive while the thread reads or writes them
        self._args = ((ctypes.c_void_p * n)(*[h._h for h in self._handles]),
                      np.asarray(tids, np.int32))
        self._n = np.zeros(n, np.int64)
        self._job = lib.dri_job_start(self._args[0], n, names._t,
                                      self._args[1], beg, end, left_fetch,
                                      prune_below, drop_flags, self._n)
        if not self._job:
            raise MemoryError("read intake: no thread could be started")
        self.seconds = None

    def wait(self) -> float:
        """Wait for the thread (GIL released while it runs); the seconds
        it ran."""
        if self._job:
            lib = self._lib
            join = (lib.dri_job_join if lib.dri_job_done(self._job)
                    else lib.dri_job_wait)
            self.seconds = join(self._job)
            self._job = None
        return self.seconds

    def blocks(self) -> list:
        """After the wait, per BAM its IntakeBlock; the list ends with a
        None at a BAM that has no usable .bai."""
        self.wait()
        out = []
        for h, n in zip(self._handles, self._n.tolist()):
            if n == -2:
                raise MemoryError("read intake")
            if n < 0:
                out.append(None)
                break
            out.append(h.block(n))
        return out

    def __del__(self):
        # never leave the thread running on handles that may be closed
        try:
            self.wait()
        except Exception:
            pass
