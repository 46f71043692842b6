#!/usr/bin/env python3
"""Times the phases of the slab epilogue's finish (K2), pair_stats (K3)
and window_call (K4) kernels apart, on one NVIDIA GPU.

    python3 tools/epilogue_phases_torch.py [--reps 20] [--against SOURCE]

Builds tools/epilogue_phases.cu (pair_stats's and window_call's phase
kernels, made of the shipped kernels' device functions; nvcc into
dindel_tpu_torch/build/)
beside the shipped library, then times, by CUDA events over `--reps`
chained launches and by the kernel's own device time (torch.profiler):
- finish at C1 (6144 pairs) and C2 (24576 pairs), float32, both folds,
  on K1's outputs, and at a streaming window's shape (B 1030, H_pad 128,
  L_pad 112, float64, exact fold): the whole kernel, and the folds alone
  (the same kernel on b_mid 0 and read_len 1: walks of no step);
- pair_stats at C1 and C2 (on the fast fold's map_state, four variant
  slots a hap) and at a main-path-like slab (B 24576, H_pad 128, L_pad
  112, each read shared by eight haps, four slots): the whole kernel,
  the kernel at V = 0 (the counts and scans without the slot tests) and
  the staging alone (the scalars, rows, hap codes and slot tables into
  shared memory and the output writes, no compute);
- window_call at C1 and C2 (W 8, NH 8, S 4, NR 768: one or four windows
  of reads) and at a main-path-like slab (W 32, NH 12, S 4, NR 128, each
  window 4..12 haps and 40..128 reads in the engine's layout), float32:
  the whole kernel, the gathers and t values alone, the in-order sums
  alone, and the sums' floor: nr_w dependent adds at four clocks each at
  the card's maximum SM clock.
The empty launch (epilogue_kernel.noop) is timed the same way.  With
--against, another version of csrc/slab_epilogue.cu (the same entry
points, e.g. `git show <commit>:dindel_tpu_torch/csrc/slab_epilogue.cu`)
is built too, held bit-equal to the shipped kernels on each shape and
timed beside them in alternation.  Prints one line per measurement and,
last, one JSON object.  Exits 2 without a CUDA device."""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

SOURCE = REPO / "tools" / "epilogue_phases.cu"
ADD_CLOCKS = 4  # latency of a dependent float32 add on sm_90


def build():
    """The phase library, keyed also by the shipped source it includes."""
    from dindel_tpu_torch.hmm import epilogue_kernel as ek
    from dindel_tpu_torch.nvcc_build import NVCC_FLAGS, build_library
    digest = hashlib.sha1(ek.SOURCE.read_bytes()).hexdigest()[:16]
    path = build_library("epilogue_phases", SOURCE, NVCC_FLAGS,
                         {"phases": [f"-DDINDEL_SHIPPED_SOURCE={digest}"]},
                         "the epilogue phase kernels")
    lib = ctypes.CDLL(str(path))
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.dindel_window_phase.argtypes = [I, I, P, I, I, I, I, D, P]
    lib.dindel_stats_stage_phase.argtypes = [P, I, I, I, I, P]
    return lib


def build_against(source):
    """Another version of the kernel library, loaded, or None."""
    if source is None:
        return None
    from dindel_tpu_torch.hmm import epilogue_kernel as ek
    from dindel_tpu_torch.nvcc_build import NVCC_FLAGS, build_library
    lib = ctypes.CDLL(str(build_library(
        "epilogue_against", Path(source), NVCC_FLAGS, ek.VARIANTS,
        "the kernels compared against")))
    for name in ek.SIGNATURES:
        if (name.startswith(("dindel_finish_f", "dindel_window_call_f"))
                or name == "dindel_pair_stats"):
            getattr(lib, name).argtypes = ek.SIGNATURES[name]
    return lib


def against(label, lib, entry, cargs, outs, want, same, kernel, fn, reps):
    """Times `lib`'s `entry` on the launch arguments `cargs` beside the
    shipped wrapper `fn`, two rounds each in alternation, after holding
    its outputs `outs` to the shipped ones `want` (`same` compares)."""
    import torch
    import chip_smoke as cs
    ptrs = [x.data_ptr() if isinstance(x, torch.Tensor) else x
            for x in cargs]

    def other():
        rc = getattr(lib, entry)(*ptrs,
                                 torch.cuda.current_stream().cuda_stream)
        if rc:
            raise SystemExit(f"{label}: the other build failed: {rc}")
    other()
    torch.cuda.synchronize()
    if not same(outs, want):
        raise SystemExit(f"{label}: the other build disagrees")
    t = {"shipped": [], "other": []}
    for _ in range(2):
        t["shipped"].append(cs.device_ms(fn, reps, kernel))
        t["other"].append(cs.device_ms(other, reps, kernel))
    print(f"[against] {label}: bit-equal; device (profiler) ms, two rounds "
          f"in alternation: shipped {t['shipped']}, other {t['other']}",
          flush=True)
    return t


def finish_shapes():
    """(name, finish arguments, read_len) at C1 and C2 (both folds) and at
    the streaming window, on K1's outputs."""
    import torch
    import chip_smoke as cs
    from dindel_tpu_torch.hmm.dp_kernel import pair_hmm_dp

    for name, n_windows in (("C1", 1), ("C2", 4)):
        pk, args, bounds, fin = cs.dp_inputs(n_windows, n_windows, "cuda")
        for exact in (False, True):
            dp = pair_hmm_dp(*args, exact_ties=exact, bounds=bounds)
            yield (f"{name} {'exact' if exact else 'fast'}", exact, (
                pk["H_pad"], pk["L_pad"], pk["numT"], fin["b_mid"],
                fin["hap_len"], dp[0], dp[1], fin["obs_mid"],
                fin["prior_rmq"], fin["prior_hmq"], dp[2], dp[3]),
                fin["read_len"])
    args, bounds = cs.edge_inputs(B=1030, H_pad=128, L_pad=112, numT=7,
                                  dtype="float64", seed=13, device="cuda")
    dp = pair_hmm_dp(*args, exact_ties=True, bounds=bounds)
    S = dp[0].shape[1]
    g = torch.Generator().manual_seed(13)

    def row():
        return (torch.randint(-12, 1, (1030, S), generator=g).double()
                / 4).cuda()
    yield ("streaming B1030 f64 exact", True, (
        128, 112, 7, args[5], args[3], dp[0], dp[1], row(), row(), row(),
        dp[2], dp[3]), args[4])


def stats_shapes():
    """(name, pair_stats arguments) at C1, C2 (on the fast fold's
    map_state, chip_smoke's slot tables) and a main-path-like slab."""
    import torch
    import chip_smoke as cs
    from dindel_tpu_torch.hmm import epilogue_kernel as ek
    from dindel_tpu_torch.hmm.dp_kernel import pair_hmm_dp
    from dindel_tpu_torch.hmm.pack import tables_to_device

    def slab(pk_H, pk_L, numT, b_mid, hap_len, read_len, dp, fin, tabs):
        k = ek.finish(pk_H, pk_L, numT, b_mid, hap_len, dp[0], dp[1],
                      fin["obs_mid"], fin["prior_rmq"], fin["prior_hmq"],
                      dp[2], dp[3], read_len=read_len)
        return (pk_H, pk_L, cs.EPI_V, k[5], *tabs, k[2], 2)

    for name, n_windows in (("C1", 1), ("C2", 4)):
        pk, args, bounds, fin = cs.dp_inputs(n_windows, n_windows, "cuda")
        dp = pair_hmm_dp(*args, bounds=bounds)
        tabs = cs.stats_tables(tables_to_device(pk, "cuda"), "cuda",
                               n_windows)
        yield name, slab(pk["H_pad"], pk["L_pad"], pk["numT"], fin["b_mid"],
                         fin["hap_len"], fin["read_len"], dp, fin, tabs)
    # the main path's first slab's shape: each read's rows shared by
    # eight haps (pairs hap-major within a window, as the engine packs)
    B, H_pad, L_pad, nrd = 24576, 128, 112, 24576 // 8
    args, bounds = cs.edge_inputs(B=B, H_pad=H_pad, L_pad=L_pad, numT=7,
                                  dtype="float32", seed=31, device="cuda")
    dp = pair_hmm_dp(*args, bounds=bounds)
    g = torch.Generator().manual_seed(31)

    def row():
        return (torch.randint(-12, 1, (B, 2 * (H_pad + 2)), generator=g)
                .float() / 4).cuda()
    fin = dict(obs_mid=row(), prior_rmq=row(), prior_hmq=row())
    i = torch.arange(B, device="cuda")
    t = dict(read_len=args[4], hap_len=args[3], read_idx=i % nrd,
             hap_idx=i // nrd, read_codes_r=args[6][:nrd].contiguous(),
             hap_codes_h=args[7][:B // nrd].contiguous(),
             bqt_r=torch.rand(nrd, L_pad, generator=g).cuda() < 0.8,
             q95_r=torch.rand(nrd, L_pad, generator=g).cuda() < 0.5,
             log10q_r=(-torch.rand(nrd, L_pad, generator=g,
                                   dtype=torch.float64) * 4).cuda())
    yield "main-path-like", slab(H_pad, L_pad, 7, args[5], args[3], args[4],
                                 dp, fin, cs.stats_tables(t, "cuda", 31))


def window_shapes():
    """(name, window_call arguments) at C1, C2 and a main-path-like slab."""
    import numpy as np
    import torch
    import chip_smoke as cs

    for name, n_windows in (("C1", 1), ("C2", 4)):
        rng = np.random.RandomState(n_windows)
        fold = cs.fold_inputs(n_windows, cs.NH, cs.NR, cs.EPI_SITES,
                              torch.float32, "cuda", n_windows)
        n = int(fold[4].max()) + 1
        ll = torch.as_tensor(-rng.gamma(2.0, 40.0, size=n), device="cuda",
                             dtype=torch.float32)
        yield name, (*fold[:4], ll, *fold[4:])
    # the engine's layout (engine/batched.py): window w's nh haps x nr
    # reads at a running offset, hap-major; 0 in the pad slots
    rng = np.random.RandomState(3)
    W, NH, S, NR = 32, 12, cs.EPI_SITES, 128
    index_map = np.zeros((W, NH, NR), np.int32)
    nr_w = rng.randint(40, NR + 1, size=W).astype(np.int32)
    off = 0
    for w in range(W):
        nh, nr = rng.randint(4, NH + 1), int(nr_w[w])
        index_map[w, :nh, :nr] = off + (np.arange(nh)[:, None] * nr
                                        + np.arange(nr)[None, :])
        off += nh * nr

    def up(a, dt=None):
        return torch.as_tensor(a, dtype=dt, device="cuda")
    yield "main-path-like", (
        W, NH, S, NR, up(-rng.gamma(2.0, 40.0, size=off), torch.float32),
        up(index_map), up(nr_w),
        up(-rng.rand(W, S, NH * (NH + 1) // 2) * 10, torch.float32))


def timed(label, fn, kernel, reps):
    import chip_smoke as cs
    t = cs.kernel_times(fn, reps, "cuda", kernel)
    print(f"[phases] {label}: {cs.fmt_times(t)}", flush=True)
    return t


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--against", default=None)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("epilogue_phases_torch: CUDA is not available",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from dindel_tpu_torch.hmm import epilogue_kernel as ek

    card = cs.card_line()
    print(f"[device] {card}", flush=True)
    lib = build()
    other = build_against(a.against)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    clock = cs.sm_clock_hz()
    out = {"card": card, "max_sm_clock_hz": clock,
           "floor": timed("empty launch", lambda: ek.noop("cuda"),
                          "noop_kernel", 200)}

    def checked(rc):
        if rc:
            raise SystemExit(f"phase launch failed: CUDA error {rc}")

    for name, exact, fa, read_len in finish_shapes():
        entry, cargs, outs = ek.finish_args(*fa, exact, read_len)
        B, L_pad = fa[5].shape[0], fa[1]
        full = lambda: ek.finish(*fa, exact_ties=exact,  # noqa: E731
                                 read_len=read_len)
        shipped = full()
        row = {"whole": timed(f"finish {name} B={B} whole", full,
                              "finish_kernel", a.reps)}
        zero = torch.zeros_like(fa[3])
        one = torch.ones_like(read_len)
        still = (*fa[:3], zero, *fa[4:])
        row["folds"] = timed(
            f"finish {name} B={B} folds alone (walks of no step)",
            lambda: ek.finish(*still, exact_ties=exact, read_len=one),
            "finish_kernel", a.reps)
        if other is not None:
            row["against"] = against(
                f"finish {name}", other, entry, cargs, outs, shipped,
                lambda k, r: not cs.finish_mismatches(k, r, read_len, L_pad),
                "finish_kernel", full, a.reps)
        out[f"finish {name}"] = row
    for name, sa in stats_shapes():
        B, H_pad, L_pad = sa[3].shape[0], sa[0], sa[1]
        sa0 = (*sa[:2], 0, *sa[3:13],
               *[x[:, :0].contiguous() for x in sa[13:17]], *sa[17:])
        row = {"launch": ek.launch_shape("pair_stats", B, H_pad, L_pad,
                                         sa[2])}
        for label, args in (("whole", sa), ("V=0", sa0)):
            bad = cs.stats_check(args[0], args[1], args[3], args[17],
                                 list(args[4:17]), args[18])
            if bad:
                raise SystemExit(f"pair_stats {name} {label}: the kernel "
                                 f"disagrees with its plain version: {bad}")
            row[label] = timed(f"pair_stats {name} B={B} {label}",
                               lambda: ek.pair_stats(*args),
                               "pair_stats_kernel", a.reps)
        entry, cargs, outs = ek.pair_stats_args(*sa)
        ptrs = torch.tensor([x.data_ptr() for x in cargs[:19]],
                            dtype=torch.int64, device="cuda")
        row["staging"] = timed(
            f"pair_stats {name} B={B} staging alone (rows, slot tables, "
            f"output writes)",
            lambda: checked(lib.dindel_stats_stage_phase(
                ptrs.data_ptr(), B, H_pad, L_pad, sa[2], stream())),
            "stats_stage_only", a.reps)
        print(f"[phases] pair_stats {name}: launch (pairs a block, blocks, "
              f"shared bytes) {row['launch']}", flush=True)
        if other is not None:
            row["against"] = against(
                f"pair_stats {name}", other, entry, cargs, outs,
                ek.pair_stats(*sa),
                lambda k, r: all(cs.same_bits(x, y) for x, y in zip(k, r)),
                "pair_stats_kernel", lambda: ek.pair_stats(*sa), a.reps)
        out[f"pair_stats {name}"] = row
    for name, wa in window_shapes():
        W, NH, S, NR, ll, im, nr_w, pp = wa
        entry, cargs, outs = ek.window_call_args(*wa)
        ptrs = torch.tensor([x.data_ptr() for x in cargs[:6]],
                            dtype=torch.int64, device="cuda")
        nr_max = int(nr_w.clamp(0, NR).max())
        row = {"whole": timed(f"window_call {name} whole",
                              lambda: ek.window_call(*wa),
                              "window_call_kernel", a.reps)}
        for which, label, kernel in ((0, "terms", "window_terms_only"),
                                     (1, "sums", "window_sums_only")):
            row[label] = timed(
                f"window_call {name} {label} alone",
                lambda: checked(lib.dindel_window_phase(
                    which, 0, ptrs.data_ptr(), W, NH, S, NR, math.log(0.5),
                    stream())), kernel, a.reps)
        row["chain_floor_ms"] = nr_max * ADD_CLOCKS / clock * 1e3
        row["launch"] = ek.launch_shape("window_call", W, NH, S, NR, 4)
        print(f"[phases] window_call {name}: the longest window's {nr_max} "
              f"dependent adds take {row['chain_floor_ms']!r} ms at "
              f"{ADD_CLOCKS} clocks each, {clock / 1e6:.0f} MHz; launch "
              f"(pairs a block, reads a chunk, blocks, shared bytes) "
              f"{row['launch']}", flush=True)
        if other is not None:
            row["against"] = against(
                f"window_call {name}", other, entry, cargs, outs,
                ek.window_call(*wa),
                lambda k, r: all(torch.equal(x.view(torch.int32),
                                             y.view(torch.int32))
                                 for x, y in zip(k, r)),
                "window_call_kernel", lambda: ek.window_call(*wa), a.reps)
        out[f"window_call {name}"] = row
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
