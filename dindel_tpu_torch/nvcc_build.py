"""nvcc build of the port's CUDA kernel libraries (csrc/*.cu) into this
package's build directory, ``dindel_tpu_torch/build/``: plain C-ABI
shared libraries, loaded with ctypes by hmm/dp_kernel.py and
hmm/epilogue_kernel.py.  The build needs only the sources in this
package and the CUDA toolkit; it runs on first use, never at import."""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

BUILD_DIR = Path(__file__).resolve().parent / "build"
# -fmad=false: a contracted multiply-add would round once where the
# plain version rounds twice (bit parity with the plain versions)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-fmad=false", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
CUDA_NVCC = "/usr/local/cuda/bin/nvcc"


def nvcc(what: str) -> str:
    """Path of nvcc; RuntimeError naming `what` when there is none."""
    path = shutil.which("nvcc")
    if path is None and os.path.exists(CUDA_NVCC):
        path = CUDA_NVCC
    if path is None:
        raise RuntimeError(f"nvcc not found: the CUDA toolkit is needed to "
                           f"build {what}")
    return path


def build_library(name: str, source: Path, flags: Sequence[str],
                  variants: Dict[str, Sequence[str]], what: str,
                  build_dir: Path = BUILD_DIR) -> Path:
    """Compile `source` once per variant (its -D flags), all translation
    units in parallel, and link them into build_dir/lib<name>_<hash>.so,
    keyed by a hash of the source, the flags and the variants; returns
    its path at once when it exists.  nvcc's output (ptxas's register
    and spill report included) is kept beside it as a .log file.  Every
    file is written under a temporary name and renamed, so a process
    that builds at the same time never loads a half-written library."""
    src = Path(source).read_bytes()
    digest = hashlib.sha1(src + repr((list(flags), variants)).encode()
                          ).hexdigest()[:16]
    so = Path(build_dir) / f"lib{name}_{digest}.so"
    if so.exists():
        return so
    exe = nvcc(what)
    so.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{digest}.{os.getpid()}"
    objs = {v: so.parent / f"{name}_{v}_{tag}.o" for v in variants}
    procs = {v: subprocess.Popen([exe, *flags, *variants[v], "-c", "-o",
                                  str(objs[v]), str(source)],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for v in variants}
    log, failed = [], []
    for v, proc in procs.items():
        out, _ = proc.communicate()
        log.append(f"== {v}\n{out}")
        if proc.returncode != 0:
            failed.append(v)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    if not failed:
        res = subprocess.run([exe, "-shared", "-o", str(tmp),
                              *[str(o) for o in objs.values()]],
                             capture_output=True, text=True)
        log.append(f"== link\n{res.stdout}{res.stderr}")
        if res.returncode != 0:
            failed.append("link")
    for o in objs.values():
        o.unlink(missing_ok=True)
    log_tmp = so.with_name(f"{so.stem}.log.{os.getpid()}.tmp")
    log_tmp.write_text("".join(log))
    os.replace(log_tmp, so.with_suffix(".log"))
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({failed}):\n" + "".join(log))
    os.replace(tmp, so)
    return so
