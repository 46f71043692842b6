"""Wrappers of the slab epilogue's CUDA kernels (csrc/slab_epilogue.cu):
``finish``, ``pair_stats`` and ``window_call``.

Each has the signature and contract of its plain version (hmm/finish.py
``finish``, hmm/stats.py ``pair_stats``, infer/device_call.py
``window_call``), which it takes only for tensors on the CPU.  For CUDA
tensors it launches its kernel on the tensors' device and that device's
current stream, or raises; there is no fallback.  The kernels are built
on first use with nvcc into ``dindel_tpu_torch/build/`` (nvcc_build.py;
one library for the three).

``finish`` takes one more keyword than its plain version, ``read_len``:
given, the kernel walks each pair's backtrack only over the backpointer
rows its read consumes and holds the last state in map_state's columns
at and past read_len (which no consumer reads); without it the kernel
walks every row, as the plain version does.

``<wrapper>.launches`` counts each wrapper's kernel launches (and
nothing else), so a run can show that its slab program went through
the kernels.  ``noop`` launches an empty kernel through the same path:
the floor no launch of these wrappers can beat."""

from __future__ import annotations

import ctypes
import math
import threading
from pathlib import Path

import torch

from ..infer.device_call import window_call as plain_window_call
from ..nvcc_build import NVCC_FLAGS, build_library
from .finish import finish as plain_finish
from .stats import pair_stats as plain_pair_stats

SOURCE = (Path(__file__).resolve().parent.parent / "csrc"
          / "slab_epilogue.cu")
# one translation unit per (type, fold), compiled in parallel
VARIANTS = {"f32_fast": ["-DDINDEL_EPI_DOUBLE=0", "-DDINDEL_EPI_EXACT=0"],
            "f32_exact": ["-DDINDEL_EPI_DOUBLE=0", "-DDINDEL_EPI_EXACT=1"],
            "f64_fast": ["-DDINDEL_EPI_DOUBLE=1", "-DDINDEL_EPI_EXACT=0"],
            "f64_exact": ["-DDINDEL_EPI_DOUBLE=1", "-DDINDEL_EPI_EXACT=1"]}
MAX_NUM_T = 15  # the DP's 4-bit class codes

_LOCK = threading.Lock()
_LIB = None
_FLOATS = (torch.float32, torch.float64)


def build() -> Path:
    """Compile the kernel library if it is not built yet; returns its
    path (the .log of nvcc and ptxas beside it)."""
    return build_library("slab_epilogue", SOURCE, NVCC_FLAGS, VARIANTS,
                         "the slab epilogue kernels")


# the C entry points' argument types, in order (the stream last)
_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
SIGNATURES = {**{f"dindel_finish_{v}": [_P] * 13 + [_I] * 4 + [_P]
                 for v in VARIANTS},
              **{f"dindel_window_call_{t}": [_P] * 6 + [_I] * 4 + [_D, _P]
                 for t in ("f32", "f64")},
              "dindel_pair_stats": [_P] * 19 + [_I] * 5 + [_P],
              "dindel_epilogue_noop": [_P],
              "dindel_finish_shape": [_I] * 3 + [_P],
              "dindel_pair_stats_shape": [_I] * 4 + [_P],
              "dindel_window_call_shape": [_I] * 5 + [_P]}
# the pair_stats kernel's limits: slot counts of up to 1023 chunks of 32
# columns a lane in 10-bit fields, 2 xs + ins in an int32
STATS_MAX_L_PAD = 32736
STATS_MAX_H_PAD = 1 << 28


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def _device(name, *tensors):
    """The one device of `tensors` (None entries skipped)."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"{name}: inputs on several devices: {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def _want(name, t, shape, dtype):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want "
                         f"{tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, want {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    return t


def _vec(name, t, shape, dtype):
    """An index, length or state table in the kernel's integer type."""
    t = t.to(dtype).contiguous()
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want "
                         f"{tuple(shape)}")
    return t


def _type(name, dt):
    if dt not in _FLOATS:
        raise TypeError(f"{name}: dtype must be float32 or float64, got "
                        f"{dt}")
    return "f32" if dt == torch.float32 else "f64"


def _launch(wrapper, call, dev=None):
    """Launches `call` = (entry point, its arguments but the stream,
    outputs) on `dev` (default: the device of its first tensor) and that
    device's current stream; counts the launch."""
    entry, args, _ = call
    if dev is None:
        dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    fn = getattr(_lib(), entry)
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in args]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*ptrs, stream)
    if rc != 0:
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed: CUDA "
                           f"error {rc}")
    with _LOCK:  # the hostshard device server launches from many threads
        wrapper.launches += 1


def finish_args(H_pad, L_pad, numT, b_mid, hap_len, alpha_mid, beta_mid,
                obs_mid, prior_rmq, prior_hmq, btf, btb, exact_ties=False,
                read_len=None):
    """The finish kernel's launch: (entry point, arguments, outputs),
    after the argument checks; the outputs are allocated on the inputs'
    device, uninitialised."""
    B = b_mid.shape[0]
    SP = H_pad + 2
    dt = alpha_mid.dtype
    t = _type("finish", dt)
    if not 2 <= numT <= MAX_NUM_T or H_pad < 0 or L_pad < 1:
        raise ValueError(f"finish: numT {numT} (2..{MAX_NUM_T}), H_pad "
                         f"{H_pad}, L_pad {L_pad}")
    rows = [_want(n, x, (B, 2 * SP), dt) for n, x in (
        ("alpha_mid", alpha_mid), ("beta_mid", beta_mid),
        ("obs_mid", obs_mid), ("prior_rmq", prior_rmq),
        ("prior_hmq", prior_hmq))]
    bts = [_want(n, x, (L_pad - 1, B, SP), torch.uint8)
           for n, x in (("btf", btf), ("btb", btb))]
    ints = [_vec(n, x, (B,), torch.int32)
            for n, x in (("b_mid", b_mid), ("hap_len", hap_len))]
    rl = (None if read_len is None
          else _vec("read_len", read_len, (B,), torch.int32))
    dev = alpha_mid.device
    fl = torch.empty((3, B), dtype=dt, device=dev)
    fb = torch.empty((2, B), dtype=torch.bool, device=dev)
    map_state = torch.empty((B, L_pad), dtype=torch.int32, device=dev)
    entry = f"dindel_finish_{t}_{'exact' if exact_ties else 'fast'}"
    return (entry, [*ints, rl, *rows, *bts, fl, fb, map_state, B, H_pad,
                    L_pad, numT],
            (fl[0], fb[0], fb[1], fl[1], fl[2], map_state))


def finish(H_pad, L_pad, numT, b_mid, hap_len, alpha_mid, beta_mid, obs_mid,
           prior_rmq, prior_hmq, btf, btb, exact_ties=False, read_len=None):
    """Returns (ll, off_hap, off_hap_hmq, ll_off, ll_on, map_state), as
    hmm/finish.py ``finish``; ``read_len`` as the module docstring."""
    dev = _device("finish", b_mid, hap_len, alpha_mid, beta_mid, obs_mid,
                  prior_rmq, prior_hmq, btf, btb, read_len)
    if dev.type == "cpu":
        return plain_finish(H_pad, L_pad, numT, b_mid, hap_len, alpha_mid,
                            beta_mid, obs_mid, prior_rmq, prior_hmq, btf,
                            btb, exact_ties=exact_ties)
    call = finish_args(H_pad, L_pad, numT, b_mid, hap_len, alpha_mid,
                       beta_mid, obs_mid, prior_rmq, prior_hmq, btf, btb,
                       exact_ties, read_len)
    if b_mid.shape[0]:
        _launch(finish, call)
    return call[2]


def pair_stats_args(H_pad, L_pad, V, map_state, read_len, hap_len, read_idx,
                    hap_idx, read_codes_r, hap_codes_h, bqt_r, q95_r,
                    log10q_r, v_left_h, v_right_h, v_isdel_h, v_valid_h,
                    off_hap_hmq, max_mismatch):
    """The pair_stats kernel's launch: (entry point, arguments, outputs),
    as finish_args."""
    B = map_state.shape[0]
    if (not 1 <= H_pad <= STATS_MAX_H_PAD
            or not 1 <= L_pad <= STATS_MAX_L_PAD or V < 0):
        raise ValueError(f"pair_stats: H_pad {H_pad} (1..{STATS_MAX_H_PAD}), "
                         f"L_pad {L_pad} (1..{STATS_MAX_L_PAD}), V {V}")
    nr, nh = read_codes_r.shape[0], hap_codes_h.shape[0]
    vecs = [_vec("map_state", map_state, (B, L_pad), torch.int32),
            _vec("read_len", read_len, (B,), torch.int32),
            _vec("hap_len", hap_len, (B,), torch.int32),
            _vec("read_idx", read_idx, (B,), torch.int64),
            _vec("hap_idx", hap_idx, (B,), torch.int64)]
    tables = [_want("read_codes_r", read_codes_r, (nr, L_pad), torch.uint8),
              _want("hap_codes_h", hap_codes_h, (nh, H_pad), torch.uint8),
              _want("bqt_r", bqt_r, (nr, L_pad), torch.bool),
              _want("q95_r", q95_r, (nr, L_pad), torch.bool),
              _want("log10q_r", log10q_r, (nr, L_pad), torch.float64),
              _vec("v_left_h", v_left_h, (nh, V), torch.int32),
              _vec("v_right_h", v_right_h, (nh, V), torch.int32),
              _want("v_isdel_h", v_isdel_h, (nh, V), torch.bool),
              _want("v_valid_h", v_valid_h, (nh, V), torch.bool),
              _want("off_hap_hmq", off_hap_hmq, (B,), torch.bool)]
    dev = map_state.device
    ints = torch.empty((8, B), dtype=torch.int32, device=dev)
    m_log_bq = torch.empty(B, dtype=torch.float64, device=dev)
    flags = torch.empty((2, B), dtype=torch.bool, device=dev)
    cov_ok = torch.empty((B, V), dtype=torch.bool, device=dev)
    return ("dindel_pair_stats",
            [*vecs, *tables, ints, m_log_bq, flags, cov_ok, B, H_pad, L_pad,
             V, int(max_mismatch)],
            (ints[0], ints[1], ints[2], ints[3], m_log_bq, ints[4], ints[5],
             ints[6], flags[0], flags[1], ints[7], cov_ok))


def pair_stats(H_pad, L_pad, V, map_state, read_len, hap_len, read_idx,
               hap_idx, read_codes_r, hap_codes_h, bqt_r, q95_r, log10q_r,
               v_left_h, v_right_h, v_isdel_h, v_valid_h, off_hap_hmq,
               max_mismatch):
    """Returns (fb, lb, n_bqt, n_mm_bqt, m_log_bq, n_mm_left, n_mm_right,
    num_mm, has_event, any_mism, n_ind, cov_ok), as hmm/stats.py
    ``pair_stats``.  read_idx/hap_idx must index rows of the tables (the
    kernel does not check them: that would need a device sync)."""
    args = (H_pad, L_pad, V, map_state, read_len, hap_len, read_idx,
            hap_idx, read_codes_r, hap_codes_h, bqt_r, q95_r, log10q_r,
            v_left_h, v_right_h, v_isdel_h, v_valid_h, off_hap_hmq,
            max_mismatch)
    dev = _device("pair_stats", *args[3:-1])
    if dev.type == "cpu":
        return plain_pair_stats(*args)
    call = pair_stats_args(*args)
    if map_state.shape[0]:
        _launch(pair_stats, call)
    return call[2]


def window_call_args(W, NH, S, NR, ll, index_map, nr_w, pair_pr):
    """The window_call kernel's launch: (entry point, arguments,
    outputs), as finish_args."""
    dt = pair_pr.dtype
    t = _type("window_call", dt)
    if W < 1 or NH < 1 or S < 0 or NR < 0 or ll.dim() != 1:
        raise ValueError(f"window_call: W {W}, NH {NH}, S {S}, NR {NR}, "
                         f"ll of {ll.dim()} dims")
    NP = NH * (NH + 1) // 2
    dev = pair_pr.device
    base = torch.empty((W, NP), dtype=dt, device=dev)
    site = torch.empty((W, S, NP), dtype=dt, device=dev)
    return (f"dindel_window_call_{t}",
            [ll.to(dt).contiguous(),
             _vec("index_map", index_map, (W, NH, NR), torch.int32),
             _vec("nr_w", nr_w, (W,), torch.int32),
             _want("pair_pr", pair_pr, (W, S, NP), dt), base, site, W, NH,
             S, NR, math.log(0.5)],
            (base, site))


def window_call(W, NH, S, NR, ll, index_map, nr_w, pair_pr):
    """Returns (base (W, NP), site (W, S, NP)), as infer/device_call.py
    ``window_call``; pair_pr's dtype is the folds'."""
    dev = _device("window_call", ll, index_map, nr_w, pair_pr)
    if dev.type == "cpu":
        return plain_window_call(W, NH, S, NR, ll, index_map, nr_w, pair_pr)
    call = window_call_args(W, NH, S, NR, ll, index_map, nr_w, pair_pr)
    _launch(window_call, call)
    return call[2]


def launch_shape(kernel, *sizes):
    """The launch the entry point picks, for the logs: "finish" with (B,
    L_pad, itemsize) and "pair_stats" with (B, H_pad, L_pad, V) give
    (pairs a block, blocks, shared memory bytes a block), "window_call"
    with (W, NH, S, NR, itemsize) gives (pairs a block, reads a chunk,
    blocks, shared memory bytes a block).  Builds the library; counts
    the current CUDA device's SMs."""
    out = (ctypes.c_int * 4)()
    getattr(_lib(), f"dindel_{kernel}_shape")(*sizes, out)
    return tuple(out)[:4 if kernel == "window_call" else 3]


def noop(device="cuda"):
    """One launch of an empty kernel (one warp) on `device`'s current
    stream, through the ctypes path the kernels above take: timed beside
    them, the launch floor.  Raises for a device that is not CUDA."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"noop: no kernel to launch on {dev}")
    _launch(noop, ("dindel_epilogue_noop", [], ()), dev)


finish.launches = 0
pair_stats.launches = 0
window_call.launches = 0
noop.launches = 0
