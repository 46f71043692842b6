"""Wrapper of the CUDA pair-HMM DP kernel (csrc/pair_hmm_dp.cu).

``pair_hmm_dp`` has the contract of the plain version (hmm/dp_ref.py),
which it takes only for tensors on the CPU.  For CUDA tensors it
launches the kernel or raises; there is no fallback.  The kernel is
built on first use with nvcc into ``dindel_tpu_torch/build/`` (a plain
C-ABI shared library, loaded with ctypes; nvcc_build.py), keyed by a
hash of the source and flags; the build needs only the sources in this
package.

``pair_hmm_dp.launches`` counts the kernel launches (and nothing
else), so a run can show that its DP went through the kernel."""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np
import torch

from ..nvcc_build import NVCC_FLAGS, build_library
from .dp_ref import check_dp_args, dp_bounds, dp_ref

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "pair_hmm_dp.cu"
# one translation unit per (type, fold), compiled in parallel:
# (entry-point suffix, -D flags)
VARIANTS = {"f32_fast": ["-DDINDEL_DP_DOUBLE=0", "-DDINDEL_DP_EXACT=0"],
            "f32_exact": ["-DDINDEL_DP_DOUBLE=0", "-DDINDEL_DP_EXACT=1"],
            "f64_fast": ["-DDINDEL_DP_DOUBLE=1", "-DDINDEL_DP_EXACT=0"],
            "f64_exact": ["-DDINDEL_DP_DOUBLE=1", "-DDINDEL_DP_EXACT=1"]}
# largest S_half = H_pad + 2: 32 lanes x 32 states
MAX_S_HALF = 1024

_LOCK = threading.Lock()
_LIB = None


def build() -> Path:
    """Compile the kernel library if it is not built yet; returns its
    path (nvcc_build.build_library: the four translation units in
    parallel, the .log beside the library)."""
    return build_library("pair_hmm_dp", SOURCE, NVCC_FLAGS, VARIANTS,
                         "the pair-HMM DP kernel")


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
            for v in VARIANTS:
                fn = getattr(lib, f"dindel_pair_hmm_dp_{v}")
                fn.argtypes = [p] * 13 + [i] * 7 + [d] * 5 + [p]
                fn.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def pair_hmm_dp(H_pad, L_pad, numT, hap_len, read_len, b_mid, read_codes,
                hap_codes, eq, uq, lpe, lpn, scalars, exact_ties=False,
                bounds=None):
    """The pair-HMM DP: (alpha_mid, beta_mid, btf, btb), see dp_ref.

    On the CPU this is dp_ref.  On CUDA the outputs are allocated here
    (torch.empty: btf rows >= MB and btb rows < MN stay uninitialised and
    are never consumed) and the kernel runs on the current stream."""
    dev = eq.device
    if dev.type == "cpu":
        return dp_ref(H_pad, L_pad, numT, hap_len, read_len, b_mid,
                      read_codes, hap_codes, eq, uq, lpe, lpn, scalars,
                      exact_ties=exact_ties, bounds=bounds)
    if dev.type != "cuda":
        raise ValueError(f"pair_hmm_dp: unsupported device {dev}")
    check_dp_args(H_pad, L_pad, numT, hap_len, read_len, b_mid, read_codes,
                  hap_codes, eq, uq, lpe, lpn)
    if bounds is None:
        bounds = dp_bounds(read_len.cpu().numpy(), b_mid.cpu().numpy(),
                           L_pad)
    L_act, MB, MN = bounds
    B = hap_len.shape[0]
    SP = H_pad + 2
    if SP > MAX_S_HALF:
        raise ValueError(f"pair_hmm_dp: S_half = {SP} exceeds the kernel's "
                         f"{MAX_S_HALF} states (32 lanes x 32)")
    dt = eq.dtype
    args = [hap_len.to(torch.int32).contiguous(),
            read_len.to(torch.int32).contiguous(),
            b_mid.to(torch.int32).contiguous(),
            read_codes.to(torch.uint8).contiguous(),
            hap_codes.to(torch.uint8).contiguous(),
            eq.contiguous(), uq.contiguous(), lpe.contiguous(),
            lpn.contiguous()]
    amid = torch.empty((B, 2 * SP), dtype=dt, device=dev)
    bmid = torch.empty((B, 2 * SP), dtype=dt, device=dev)
    btf = torch.empty((L_pad - 1, B, SP), dtype=torch.uint8, device=dev)
    btb = torch.empty((L_pad - 1, B, SP), dtype=torch.uint8, device=dev)
    variant = (("f32" if dt == torch.float32 else "f64") + "_"
               + ("exact" if exact_ties else "fast"))
    fn = getattr(_lib(), f"dindel_pair_hmm_dp_{variant}")
    scal = [float(v) for v in np.asarray(scalars)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*[t.data_ptr() for t in args + [amid, bmid, btf, btb]],
                B, H_pad, L_pad, numT, L_act, MB, MN, *scal, stream)
    if rc != 0:
        raise RuntimeError(f"pair_hmm_dp kernel launch failed: CUDA error "
                           f"{rc}")
    with _LOCK:  # the hostshard device server launches from many threads
        pair_hmm_dp.launches += 1
    return amid, bmid, btf, btb


pair_hmm_dp.launches = 0
