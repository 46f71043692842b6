"""ctypes binding for the native MAP-state decode (native/decode.cpp):
one C pass producing every per-pair scalar of LiksView's eager decode.
Set DINDEL_DECODE=py to force the numpy implementation (the differential
anchor, tests/test_liks_view.py)."""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from ..native_build import native_so

_lib = None
_lib_tried = False
_build_lock = threading.Lock()

_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_I16P = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
_U8P = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_F64P = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def native_lib():
    """Load (building if needed) libdindel_decode.so; None if unavailable
    or disabled via DINDEL_DECODE=py."""
    global _lib, _lib_tried
    if os.environ.get("DINDEL_DECODE") == "py":
        return None
    if _lib_tried:
        return _lib
    with _build_lock:
        if _lib_tried:
            return _lib
        _lib_tried = True
        so = native_so("decode.cpp", "libdindel_decode.so")
        if so is not None:
            try:
                lib = ctypes.CDLL(str(so))
            except OSError:
                return None
            c = ctypes
            lib.ddec_stats.argtypes = [
                c.c_int64, c.c_int64, c.c_int64, c.c_int64,
                _I16P, _I32P, _I32P, _U8P, _U8P, _F64P, _F64P, c.c_double,
                _I32P, _I32P, _U8P, _I64P, _I64P, _I64P, _I64P, _I64P,
                _F64P, _I64P, _I64P, _U8P, _U8P]
            _lib = lib
    return _lib
