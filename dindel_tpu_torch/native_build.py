"""Build of the native host helpers (native/*.cpp, the C++ sources the
JAX package builds too) into this package's own build directory,
``dindel_tpu_torch/build/``, so that the two packages never share or race
on a shared library.  Used by the ctypes loaders of io/bam_native.py,
engine/hapgen_native.py, engine/std_sort.py, hmm/decode_native.py and
align/nw.py, and of io/reads_intake.py from the port's own
native/reads_intake.cpp."""

from __future__ import annotations

import os
import subprocess
import sys
import threading
from pathlib import Path
from typing import Optional, Sequence

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
BUILD_DIR = Path(__file__).resolve().parent / "build"
_lock = threading.Lock()


def native_so(src_name: str, so_name: str, flags: Sequence[str] = ("-O2",),
              libs: Sequence[str] = (),
              deps: Sequence[str] = ()) -> Optional[Path]:
    """Path of build/<so_name>, compiled with g++ from native/<src_name>
    when it is missing or older than its source or a native/<dep> that
    the source includes (into a temporary name, then renamed, so
    concurrent processes never load a half-written file).  None, with a
    warning on stderr, when it cannot be built: the caller then takes
    its python path."""
    src = NATIVE_DIR / src_name
    so = BUILD_DIR / so_name
    with _lock:
        fresh = so.exists() and not any(
            f.exists() and f.stat().st_mtime > so.stat().st_mtime
            for f in [src, *(NATIVE_DIR / d for d in deps)])
        if fresh or not src.exists():
            return so if so.exists() else None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        try:
            r = subprocess.run(["g++", *flags, "-shared", "-fPIC", str(src),
                                "-o", str(tmp), *libs],
                               capture_output=True, text=True)
        except FileNotFoundError:
            print(f"WARNING: g++ not found; {so_name} unavailable",
                  file=sys.stderr)
            return so if so.exists() else None
        if r.returncode != 0:
            print(f"WARNING: {so_name} build failed; falling back to the "
                  f"python path:\n" + r.stderr[-500:], file=sys.stderr)
            tmp.unlink(missing_ok=True)
            return so if so.exists() else None
        os.replace(tmp, so)
        return so
