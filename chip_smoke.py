#!/usr/bin/env python3
"""Smoke test of dindel_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles both kernel libraries from dindel_tpu_torch/csrc/ at
   once (nvcc, sm_90a, four translation units each, all in parallel):
   the pair-HMM DP (K1, pair_hmm_dp.cu) and the slab epilogue (K2
   finish, K3 pair_stats, K4 window_call, slab_epilogue.cu); prints the
   build time, ptxas's registers and spills per kernel, and the SASS
   instruction counts of K1's main-path step loops (cuobjdump);
3. kernel vs plain, on the card: edge shapes (S_half not a multiple of
   32 and up to 1024, odd S_half, numT 2..15, B not a multiple of the
   pairs per block, b_mid at 0 and at read_len-1, a zero-length hap,
   float64) in both fold modes, alpha/beta and backpointer codes
   bit-equal; then the DP bench geometry (8 haps x 768 reads, H=160,
   L=100) and one engine-sized slab (24576 pairs), in both fold modes:
   alpha/beta bit-equal, backpointer codes equal on the consumed rows,
   the six finish outputs equal; then both timed with CUDA events over
   chained calls (DP cells/s, cells = B*L*2*(H+2)*numT) beside the
   kernel's bound (bytes and operations) and the share of it reached;
   then K2-K4 against their plain versions on K1's outputs: at K1's edge
   shapes in both folds (finish with read_len on the consumed columns
   and without it on every column; pair_stats with V = 4 and V = 0;
   pair_stats also at chip_smoke.STATS_EDGE_CASES: L_pad 33, 64, 112
   and 200, V 0, 1 and 8, ins runs and repeated event positions across
   column 32, read_len 0 and above L_pad, hap_len 0, NaN, +-inf and -0.0
   log10q terms; window_call at chip_smoke.FOLD_EDGE_CASES), on rows
   that break a wrong combine (SPECIALS: ties and near-ties across
   lanes, NaN, +-0.0 at the maximum, all -inf; window_call with NaN
   terms, signed-zero seeds and nr_w outside [0, NR]), and at C1 and C2
   in both folds (pair_stats with V = 4 and V = 0), all bit-equal (NaN
   equal to NaN), each timed with CUDA events, by the host clock and by
   its own device time (torch.profiler) beside its plain version, its
   bound and its launch shape, beside an empty kernel's launch through
   the same ctypes path (the launch floor);
4. the slice at realistic size: 360 planted indels, 30x, 100 bp reads
   (seed 3), through the CLI entry points getCIGARindels -> makeWindows
   -> indels --doDiploid --engine batched --hmmBackend pallas --device
   cuda -> mergeOutputDiploid, with the kernel's launch count read
   around the indels run; then a warm pass through the engine (windows/s,
   stage seconds, peak device memory); then K2-K4 at the run's own
   first slab (its B, H_pad, L_pad, V, W, NH, S, NR logged): against
   their plain versions, timed as in phase 3;
5. parity: the first windows of that run on the card and on the CPU
   (plain versions), host folds: GLF bytes identical; then the first
   120 windows with device folds on the card through K2-K4 and through
   their plain versions: GLF bytes identical;
6. golden call: the one-deletion sim's VCF holds 3128 AGGG A 0/1;
7. decode: the first 120 windows of phase 4 through the CLI with
   --outputRealignedBAM (the full-decode route: map_state fetched and
   decoded on the host), with windows/s, stage seconds, slab count per
   route, realigned BAM count and kernel launches; then the first 24
   windows on the card and on the CPU: GLF bytes and BAM records
   identical;
8. sentinel: 24 windows with --flankRefSeq 62, which puts most of their
   variant flanks at the LO/RO sentinel codes, one window per slab:
   slabs on both routes in one pass, GLF bytes identical between the
   card and the CPU, ok rows present;
9. pooled: the first 120 windows through indels --doPooled ->
   mergeOutputPooled (kernel launched, device VB-EM dispatched, VCF
   records); a warm engine pass (windows/s, stage seconds, peak device
   memory); 24 windows on the card and on the CPU with the host EM: GLF
   bytes identical; the device EM against the host EM on the card,
   within the tolerance of tests/test_device_em.py (relative 2e-3,
   absolute 1e-2);
10. streaming: the first 120 windows through the CLI's default engine
   (`indels --doDiploid --hmmBackend jax --device cuda`: one kernel
   launch per scored window, float64, exact ties), with windows/s, stage
   seconds (the per-window hmm split into pack, device and decode) and
   kernel launches (at least one per scored window); its GLF byte-equal
   to the batched engine's on the card in float64 with exact ties and
   host folds; K1 timed at the median window's shape beside its plain
   version and its bound, and K2 (float64, exact ties) checked and timed
   there too; 24 windows with `--hmmBackend pallas`
   on the card and on the CPU: GLF identical; 24 windows with
   `--faster` (host only) in six CLI processes at once: ok rows;
11. dense: the same 120 windows with `--engine batched --hmmBackend
   pallas --insertPrior --libFile <getCIGARindels' libraries file>`:
   every slab on the dense route (slab counts per route), kernel
   launches, windows/s, stage seconds; 24 windows on the card and on the
   CPU: GLF identical;
12. shards: the 120 windows split into two window files, through
   pipeline.run_parallel.run_and_merge_diploid with two spawned workers
   on the one card: the merged VCF equal to the single-process run's;
13. mesh: the 120 windows through the batched engine (the shipped
   configuration) on a 2x2 mesh (four distinct cards where the host has
   them, else the one card four times): GLF byte-equal to the
   single-device engine's, the kernel launched once per shard of every
   sharded slab; wall, windows/s and slab_dispatch per shard program;
   the CLI with --mesh 1x1 byte-equal to the CLI without it; and
   parallel.mesh.dryrun_multichip(8) over the one card eight times;
14. hostshard: the 120 windows in four window files through the CLI with
   --stageProcs 2 and through parallel.hostshard.run_hostshard with four
   staging processes and two repeats: merged GLFs byte-equal to one
   engine running the four files in sequence; the cold wall, the warm
   windows/s, the server's enqueue and fetch seconds, and each staging
   process's stage seconds, rescues and CUDA state (never initialized),
   in both runs.

Every engine this process closes, every shard worker's and every
staging process's must have rescued no slab (a rescue would hide a
broken device path).  Every path's run starts with the four kernels'
launch counts at 0 and reads them at its end; a kernel the path must
run (REQUIRED) that never launched fails it.  The line before the last
is the kernel table as JSON, K1-K4, each with its launches on the main
path (the device-call route of phase 4) and on each path (device call,
decode, pooled, streaming float64 and float32, dense, mesh,
hostshard); K2-K4 also with their host and device times, their times
at C1 and at the main path's first slab and ptxas's report, K3 at V =
0, K4 with the launch floor; the last line is {"ok": true, "device":
{...}}.  Needs nothing but the repository, the CUDA toolkit and
PyTorch; imports no JAX."""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
NH, NR, H, L = 8, 768, 160, 100        # bench.py:158 DP geometry
ENGINE_SLAB_WINDOWS = 4                # 4 x 6144 = 24576 pairs
N_VARIANTS, COVERAGE, READ_LEN = 360, 30, 100   # tools/bench_windows.py
PARITY_WINDOWS = 24
PATH_WINDOWS = 120                     # phases 7 and 9-14
FASTER_PROCS = 6       # phase 10's --faster windows over six CLI processes
SENTINEL_FLANK = 62    # phase 4's variant flanks start 58-60 bases in
EM_RTOL, EM_ATOL = 2e-3, 1e-2          # tests/test_device_em.py:75
# one H100 SXM at 700 W (NVIDIA's datasheet): HBM bytes/s and the
# float32 and float64 rates outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


# ---------------------------------------------------------------------------
# phase 2: the kernel's step loops in SASS

# instruction classes of the integer/logic ("ALU") pipe; the rest (FADD,
# IMAD, SHFL, loads/stores, branches) counted apart
ALU_OPS = ("ISETP", "FSETP", "SEL", "FSEL", "LOP3", "IADD3", "SHF", "PRMT",
           "P2R", "R2P", "PLOP3", "FMNMX", "IMNMX", "VIADD", "LEA")


def sass_step_loops(so, kernel):
    """Instruction counts of the two largest loops (the forward and the
    backward step loop) of the kernel whose mangled name contains
    `kernel`, from `cuobjdump -sass`: [(instructions, ALU-class
    instructions, {opcode: count})] in address order; None when
    cuobjdump is missing.  The blocks a step branches over are left out
    when they hold the b_mid row's float stores or the odd-S_half byte
    stores and none of the 2-byte backpointer stores (they run once per
    pass, or never at even S_half)."""
    import collections
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        if kernel not in func.split("\n", 1)[0]:
            continue
        ins = [(int(a, 16), t.strip()) for a, t in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", func)]
        loops = []
        for addr, text in ins:
            m = re.search(r"\bBRA\s+(?:`\()?0x([0-9a-f]+)", text)
            if m and int(m.group(1), 16) < addr:
                loops.append((int(m.group(1), 16), addr))
        loops = sorted(sorted(loops, key=lambda t: t[0] - t[1])[:2])
        def opcode(text):
            return text.split()[1 if text.startswith("@") else 0]

        skipped = set()
        for addr, text in ins:
            m = re.search(r"\bBRA\s+(?:`\()?0x([0-9a-f]+)", text)
            if not m or int(m.group(1), 16) <= addr:
                continue
            region = [(a, opcode(t)) for a, t in ins
                      if addr < a < int(m.group(1), 16)]
            kinds = {op for _, op in region if op.startswith("STG")}
            if kinds & {"STG.E", "STG.E.64", "STG.E.U8"} and \
                    "STG.E.U16" not in kinds:
                skipped |= {a for a, _ in region}
        out = []
        for lo, hi in loops:
            ops = collections.Counter(
                opcode(t).split(".")[0] for a, t in ins
                if lo <= a <= hi and a not in skipped)
            out.append((sum(ops.values()),
                        sum(n for op, n in ops.items() if op in ALU_OPS),
                        dict(ops.most_common())))
        return out
    return None


def sm_clock_hz():
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout
    return float(out.split()[0]) * 1e6


def issue_bounds(loops, B, bounds, clock_hz, sms=132):
    """Lower bounds of one call's time from the step loops' instruction
    counts: every instruction at 128 lanes/clk/SM (issue), and the
    ALU-class ones at 64 lanes/clk/SM (the SM's 64 INT32 lanes); ms."""
    L_act, MB, MN = bounds
    (nf, af, _), (nb, ab, _) = loops
    lanes = 32 * B
    issue = lanes * (nf * MB + nb * (L_act - 1 - MN)) / (sms * 128)
    alu = lanes * (af * MB + ab * (L_act - 1 - MN)) / (sms * 64)
    return issue / clock_hz * 1e3, alu / clock_hz * 1e3


# ---------------------------------------------------------------------------
# phase 3: kernel vs plain


def dp_inputs(n_windows, seed, device, nr=NR, dtype="float32"):
    """A compact slab of synthetic windows of the bench geometry (`nr`
    reads per window, `dtype` floats), expanded on `device`."""
    import numpy as np
    from dindel_tpu_torch.config import ObservationModelParameters
    from dindel_tpu_torch.hmm.dp_ref import dp_bounds
    from dindel_tpu_torch.hmm.expand import expand_compact
    from dindel_tpu_torch.hmm.pack import (merge_compact, pack_pairs_compact,
                                           pad_compact, tables_to_device)
    from dindel_tpu_torch.parallel.mesh import synth_windows

    params = ObservationModelParameters()
    wins = synth_windows(n_windows, nh=NH, nr=nr, H=H, L=L, seed=seed)
    H_pad = max(max(x.size() for x in haps) for haps, _, _ in wins)
    H_pad = ((H_pad + 15) // 16) * 16
    pk = pad_compact(merge_compact([
        pack_pairs_compact(haps, reads, hs, params, np.dtype(dtype),
                           H_pad=H_pad)
        for haps, reads, hs in wins]))
    t = tables_to_device(pk, device)
    ex = expand_compact(pk["H_pad"], pk["L_pad"], t["eq_r"].dtype, t,
                        (pk["log_off_hmq"], pk["log_on_hmq"]),
                        (pk["log_ins0"], pk["log_ins1"]))
    read_codes, eq, uq, hap_codes, lpe, lpn = ex[:6]
    args = [pk["H_pad"], pk["L_pad"], pk["numT"], t["hap_len"],
            t["read_len"], t["b_mid"], read_codes, hap_codes, eq, uq, lpe,
            lpn, pk["scalars"]]
    bounds = dp_bounds(pk["read_len"], pk["b_mid"], pk["L_pad"])
    fin = dict(b_mid=t["b_mid"], hap_len=t["hap_len"], read_len=t["read_len"],
               obs_mid=ex[8], prior_rmq=ex[6], prior_hmq=ex[7])
    return pk, args, bounds, fin


def dp_bound(B, H_pad, L_pad, numT, bounds, itemsize=4):
    """The least time the card could take for one DP call on these
    inputs: (bound_ms, bound_by, state_steps).  Bytes: every input read
    once, amid/bmid and the backpointer rows this call writes (MB forward
    and L_act-1-MN backward rows of B*S_half bytes) written once.
    Operations: per state-step the two emission adds, the noins fold
    (numT candidates, two adds and a compare each at most) and the ins
    fold (two candidates): 3*numT + 5 float adds and compares, at the
    card's float32 rate (float64 when itemsize is 8)."""
    L_act, MB, MN = bounds
    SP = H_pad + 2
    steps = MB + (L_act - 1 - MN)
    state_steps = B * SP * steps
    read = B * (3 * 4 + L_pad + H_pad + 2 * L_pad * itemsize
                + 2 * SP * itemsize)
    written = 2 * B * 2 * SP * itemsize + state_steps
    t_bytes = (read + written) / HBM_BYTES_PER_S * 1e3
    rate = F64_OPS_PER_S if itemsize == 8 else F32_OPS_PER_S
    t_ops = state_steps * (3 * numT + 5) / rate * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", state_steps
    return t_ops, "operations", state_steps


def edge_inputs(B, H_pad, L_pad, numT, dtype, seed, device, b_mid="rand",
                zero_hap=False):
    """Random DP inputs at one shape, with values on a 0.25 grid so that
    candidates tie often (the fold order and ranks are exercised)."""
    import numpy as np
    import torch
    from dindel_tpu_torch.hmm.dp_ref import dp_bounds

    rng = np.random.RandomState(seed)
    SP = H_pad + 2
    hl = rng.randint(1, H_pad + 1, size=B)
    hl[0], hl[-1] = H_pad, 1
    if zero_hap:
        hl[B // 2] = 0
    rl = rng.randint(2, L_pad + 1, size=B)
    rl[0] = L_pad
    bm = {"zero": np.zeros(B, int), "last": rl - 1}.get(
        b_mid, np.array([rng.randint(0, r) for r in rl]))
    codes = np.frombuffer(b"ACGTN", np.uint8)

    def grid(shape, lo, hi):
        return np.round(rng.uniform(lo, hi, size=shape) * 4) / 4

    dt = torch.float32 if dtype == "float32" else torch.float64
    t = lambda a, d: torch.as_tensor(np.ascontiguousarray(a), dtype=d,  # noqa
                                     device=device)
    args = [H_pad, L_pad, numT, t(hl, torch.int32), t(rl, torch.int32),
            t(bm, torch.int32),
            t(codes[rng.randint(0, 5, size=(B, L_pad))], torch.uint8),
            t(codes[rng.randint(0, 5, size=(B, H_pad))], torch.uint8),
            t(grid((B, L_pad), -0.5, 0.0), dt),
            t(grid((B, L_pad), -6, -2), dt), t(grid((B, SP), -3, -0.25), dt),
            t(grid((B, SP), -3, -0.25), dt),
            np.array([-0.25, -4.5, -1.0, -7.0, -0.5])]
    return args, dp_bounds(rl, bm, L_pad)


# (name, edge_inputs keywords): S_half = H_pad + 2
EDGE_CASES = [
    ("S_half 32, numT 2", dict(B=7, H_pad=30, L_pad=16, numT=2,
                               dtype="float32", seed=1)),
    ("S_half 47 (odd)", dict(B=5, H_pad=45, L_pad=24, numT=7,
                             dtype="float32", seed=2)),
    ("S_half 178, B 9", dict(B=9, H_pad=176, L_pad=32, numT=7,
                             dtype="float32", seed=3)),
    ("S_half 178, float64", dict(B=9, H_pad=176, L_pad=32, numT=7,
                                 dtype="float64", seed=3)),
    ("S_half 178, numT 15", dict(B=6, H_pad=176, L_pad=32, numT=15,
                                 dtype="float32", seed=4)),
    ("S_half 178, numT 15, float64", dict(B=6, H_pad=176, L_pad=32, numT=15,
                                          dtype="float64", seed=4)),
    ("S_half 1024, numT 15", dict(B=3, H_pad=1022, L_pad=24, numT=15,
                                  dtype="float32", seed=5)),
    ("S_half 1024, numT 15, float64", dict(B=3, H_pad=1022, L_pad=24,
                                           numT=15, dtype="float64", seed=5)),
    ("S_half 1002", dict(B=5, H_pad=1000, L_pad=20, numT=7,
                         dtype="float32", seed=6)),
    ("S_half 302, numT 9", dict(B=5, H_pad=300, L_pad=20, numT=9,
                                dtype="float32", seed=7)),
    ("S_half 232, numT 3", dict(B=6, H_pad=230, L_pad=20, numT=3,
                                dtype="float32", seed=8)),
    ("S_half 102, float64", dict(B=6, H_pad=100, L_pad=20, numT=7,
                                 dtype="float64", seed=9)),
    ("b_mid 0", dict(B=6, H_pad=176, L_pad=24, numT=7, dtype="float32",
                     seed=10, b_mid="zero")),
    ("b_mid read_len-1", dict(B=6, H_pad=176, L_pad=24, numT=7,
                              dtype="float32", seed=11, b_mid="last")),
    ("zero-length hap", dict(B=6, H_pad=176, L_pad=24, numT=7,
                             dtype="float32", seed=12, zero_hap=True)),
    ("zero-length hap, float64", dict(B=6, H_pad=176, L_pad=24, numT=7,
                                      dtype="float64", seed=12,
                                      zero_hap=True)),
]


def dp_mismatches(k, r, bounds):
    """Names of the DP outputs where kernel `k` and plain `r` differ
    (backpointers on the rows the passes write)."""
    import torch
    L_act, MB, MN = bounds
    pairs = {"alpha_mid": (k[0], r[0]), "beta_mid": (k[1], r[1]),
             "btf[:MB]": (k[2][:MB], r[2][:MB]),
             "btb[MN:L_act-1]": (k[3][MN:L_act - 1], r[3][MN:L_act - 1])}
    return [n for n, (a, b) in pairs.items()
            if a.dtype != b.dtype or not torch.equal(a, b)]


def edge_phase(device):
    """K1 against its plain version at the edge shapes, both folds."""
    from dindel_tpu_torch.hmm.dp_kernel import pair_hmm_dp
    from dindel_tpu_torch.hmm.dp_ref import dp_ref

    failed = []
    for name, kw in EDGE_CASES:
        args, bounds = edge_inputs(device=device, **kw)
        for exact in (False, True):
            k = pair_hmm_dp(*args, exact_ties=exact, bounds=bounds)
            r = dp_ref(*args, exact_ties=exact, bounds=bounds)
            sync(device)
            bad = dp_mismatches(k, r, bounds)
            if bad:
                failed.append((name, "exact" if exact else "fast", bad))
    log(f"[edge] K1 vs plain at {len(EDGE_CASES)} shapes x 2 folds: "
        f"failed {failed}")
    if failed:
        raise SystemExit(f"kernel disagrees with its plain version: {failed}")


def compare_and_time(name, n_windows, seed, device, reps, plain_reps):
    """Kernel vs plain on one slab in both fold modes; returns the rows
    for the kernel table (times of the fast fold, the shipped mode)."""
    import torch
    from dindel_tpu_torch.hmm.dp_kernel import pair_hmm_dp
    from dindel_tpu_torch.hmm.dp_ref import dp_ref
    from dindel_tpu_torch.hmm.finish import finish

    pk, args, bounds, fin = dp_inputs(n_windows, seed, device)
    B = pk["hap_len"].shape[0]
    H_pad, L_pad, numT = pk["H_pad"], pk["L_pad"], pk["numT"]
    valid = (torch.arange(L_pad, device=device)[None, :]
             < fin["read_len"].long()[:, None])
    cells = n_windows * NH * NR * L * 2 * (H + 2) * numT
    out = {}
    for exact in (False, True):
        mode = "exact" if exact else "fast"
        k = pair_hmm_dp(*args, exact_ties=exact, bounds=bounds)
        r = dp_ref(*args, exact_ties=exact, bounds=bounds)
        sync(device)
        err = max((k[0] - r[0]).abs().max().item(),
                  (k[1] - r[1]).abs().max().item())
        bad_dp = set(dp_mismatches(k, r, bounds))
        checks = {n: n not in bad_dp for n in (
            "alpha_mid", "beta_mid", "btf[:MB]", "btb[MN:L_act-1]")}
        fk = finish(H_pad, L_pad, numT, fin["b_mid"], fin["hap_len"], k[0],
                    k[1], fin["obs_mid"], fin["prior_rmq"], fin["prior_hmq"],
                    k[2], k[3], exact_ties=exact)
        fr = finish(H_pad, L_pad, numT, fin["b_mid"], fin["hap_len"], r[0],
                    r[1], fin["obs_mid"], fin["prior_rmq"], fin["prior_hmq"],
                    r[2], r[3], exact_ties=exact)
        for nm, a, b in zip(("ll", "off_hap", "off_hap_hmq", "ll_off",
                             "ll_on", "map_state"), fk, fr):
            if nm == "map_state":
                a, b = a.masked_fill(~valid, -1), b.masked_fill(~valid, -1)
            checks["finish." + nm] = torch.equal(a, b)
        del k, r, fk, fr
        bad = [c for c, ok in checks.items() if not ok]
        log(f"[kernel-vs-plain] {name} B={B} H_pad={H_pad} L_pad={L_pad} "
            f"{mode}: max_abs_err={err!r} checks={len(checks)} "
            f"failed={bad}")
        if bad or err != 0.0:
            raise SystemExit(f"kernel disagrees with its plain version: "
                             f"{name} {mode} {bad} err={err!r}")
        ms = time_ms(lambda: pair_hmm_dp(*args, exact_ties=exact,
                                         bounds=bounds), reps, device)
        plain_ms = time_ms(lambda: dp_ref(*args, exact_ties=exact,
                                          bounds=bounds), plain_reps, device)
        log(f"[time] {name} {mode}: kernel {ms!r} ms "
            f"({cells / ms * 1e3:.6g} cells/s), plain {plain_ms!r} ms "
            f"({cells / plain_ms * 1e3:.6g} cells/s), cells={cells}")
        out[mode] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err)
    bound_ms, bound_by, state_steps = dp_bound(B, H_pad, L_pad, numT, bounds)
    log(f"[bound] {name}: {state_steps} state-steps, bound {bound_ms!r} ms "
        f"({bound_by}); share of the bound reached: fast "
        f"{bound_ms / out['fast']['ms']:.4f}, exact "
        f"{bound_ms / out['exact']['ms']:.4f}")
    for v in out.values():
        v.update(bound_ms=bound_ms, bound_by=bound_by,
                 state_steps=state_steps, B=B, bounds=bounds)
    return out


# ---------------------------------------------------------------------------
# phase 3b: the slab epilogue kernels vs plain

KERNELS = ("pair_hmm_dp", "finish", "pair_stats", "window_call")
# the kernels each path must have launched (counted in its run)
REQUIRED = {"device_call": KERNELS,
            "decode": ("pair_hmm_dp", "finish"),
            "pooled": ("pair_hmm_dp", "finish"),
            "streaming_f64": ("pair_hmm_dp", "finish"),
            "streaming_f32": ("pair_hmm_dp", "finish"),
            "dense": ("pair_hmm_dp", "finish"),
            "mesh": ("pair_hmm_dp", "finish", "pair_stats"),
            "hostshard": ("pair_hmm_dp", "finish", "pair_stats")}
# the TPU-package code each kernel replaces (file:line)
REPLACES = {"pair_hmm_dp": "dindel_tpu/hmm/pallas_kernel.py:107",
            "finish": "dindel_tpu/hmm/batch.py:249",
            "pair_stats": "dindel_tpu/hmm/batch.py:1823",
            "window_call": "dindel_tpu/infer/device_call.py:232"}
EPI_V = 4        # variant slots per hap in the stats checks
EPI_SITES = 4    # call sites per window in the fold checks
FINISH_NAMES = ("ll", "off_hap", "off_hap_hmq", "ll_off", "ll_on",
                "map_state")
STATS_NAMES = ("fb", "lb", "n_bqt", "n_mm_bqt", "m_log_bq", "n_mm_left",
               "n_mm_right", "num_mm", "has_event", "any_mism", "n_ind",
               "cov_ok")


def kernel_wrappers():
    from dindel_tpu_torch.hmm import epilogue_kernel as ek
    from dindel_tpu_torch.hmm.dp_kernel import pair_hmm_dp
    return {"pair_hmm_dp": pair_hmm_dp, "finish": ek.finish,
            "pair_stats": ek.pair_stats, "window_call": ek.window_call}


def reset_launches():
    for w in kernel_wrappers().values():
        w.launches = 0


def read_launches():
    return {n: w.launches for n, w in kernel_wrappers().items()}


def check_launches(path, launches):
    missing = [k for k in REQUIRED.get(path, ()) if launches[k] <= 0]
    if missing:
        raise SystemExit(f"{path}: kernels never launched: {missing}")


def ulps(a, b):
    """Largest distance in units in the last place between two float
    tensors of one dtype (0 where they are equal, NaN included)."""
    import torch
    it = torch.int32 if a.dtype == torch.float32 else torch.int64
    ia, ib = a.contiguous().view(it).long(), b.contiguous().view(it).long()
    # order the bit patterns so that adjacent floats differ by one
    top = torch.iinfo(it).min
    ia = torch.where(ia < 0, top - ia, ia)
    ib = torch.where(ib < 0, top - ib, ib)
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    d = torch.where(same, 0, (ia - ib).abs())
    return int(d.max().item()) if d.numel() else 0


def walked_steps(b_mid, read_len, L_pad):
    """Backpointer rows the finish kernel reads with read_len: the down
    walk from the anchor column and the up walk to the read's end."""
    import numpy as np
    a = np.clip(np.asarray(b_mid, np.int64), 0, L_pad - 1)
    last = np.minimum(L_pad - 2, np.asarray(read_len, np.int64) - 2)
    return int((a + np.maximum(0, last - a + 1)).sum())


def bound(nbytes, ops, itemsize):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the float rate of the type."""
    rate = F64_OPS_PER_S if itemsize == 8 else F32_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def finish_bound(B, S, L_pad, steps, itemsize):
    """Bytes: the five (B, S) rows, b_mid, hap_len and read_len read once,
    one backpointer byte per walked step, the outputs written once.
    Operations: per state the four adds and four compares of the folds."""
    nbytes = (5 * B * S * itemsize + 3 * B * 4 + steps
              + 3 * B * itemsize + 2 * B + B * L_pad * 4)
    return bound(nbytes, 8 * B * S, itemsize)


def stats_bound(B, L_pad, V, nr, nh, H_pad, cols):
    """Bytes: map_state, the per-pair vectors, the read and hap tables
    and the slot tables read once, the outputs written once.
    Operations: the float64 m_log_bq adds over the `cols` read columns
    (the integer work is not counted)."""
    nbytes = (B * L_pad * 4 + B * (4 + 4 + 8 + 8 + 1)
              + nr * L_pad * (1 + 1 + 1 + 8) + nh * H_pad
              + nh * V * (4 + 4 + 1 + 1) + B * (8 * 4 + 8 + 2) + B * V)
    return bound(nbytes, cols, 8)


def window_bound(W, NH, S, NR, nreads, itemsize):
    """Bytes: the ll values the windows read, index_map, nr_w and pair_pr
    read once, base and site written once.  Operations: per (window,
    pair, read) the eight of t (max, min, sub, exp, add, log, add, add;
    exp and log counted as one each) and the S+1 fold adds."""
    NP = NH * (NH + 1) // 2
    nbytes = (nreads * NH * itemsize + W * NH * NR * 4 + W * 4
              + W * S * NP * itemsize + W * (S + 1) * NP * itemsize)
    return bound(nbytes, nreads * NP * (8 + S + 1), itemsize)


def stats_tables(t, device, seed):
    """pair_stats's inputs besides map_state and off_hap_hmq: the slab's
    tables `t`, and EPI_V random variant slots per hap (flanks at the
    LO/RO sentinel codes and below 0 included, some invalid)."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    n = t["hap_codes_h"].shape[0]
    left = rng.randint(-4, 50, size=(n, EPI_V)).astype(np.int32)
    left[::3, 0] = -4
    left[1::3, 0] = -3
    vt = dict(v_left_h=left,
              v_right_h=(left + rng.randint(0, 8, size=(n, EPI_V))
                         ).astype(np.int32),
              v_isdel_h=rng.rand(n, EPI_V) < 0.5,
              v_valid_h=rng.rand(n, EPI_V) < 0.8)
    vt = {k: torch.from_numpy(v).to(device) for k, v in vt.items()}
    return [t[k] for k in ("read_len", "hap_len", "read_idx", "hap_idx",
                           "read_codes_r", "hap_codes_h", "bqt_r", "q95_r",
                           "log10q_r")] + [vt[k] for k in (
        "v_left_h", "v_right_h", "v_isdel_h", "v_valid_h")]


# pair_stats's edge rows (stats_edge_arrays keywords): rows not a
# multiple of 32 long, V 0, 1 and 8
STATS_EDGE_CASES = [
    ("K3 L_pad 33, V 1", dict(L_pad=33, V=1, seed=21)),
    ("K3 L_pad 64, V 8", dict(L_pad=64, V=8, seed=22)),
    ("K3 L_pad 112, V 0", dict(L_pad=112, V=0, seed=23)),
    ("K3 L_pad 200, V 8", dict(L_pad=200, V=8, seed=24)),
]
STATS_ARG_NAMES = ("map_state", "read_len", "hap_len", "read_idx", "hap_idx",
                   "read_codes_r", "hap_codes_h", "bqt_r", "q95_r",
                   "log10q_r", "v_left_h", "v_right_h", "v_isdel_h",
                   "v_valid_h", "off_hap_hmq")


def stats_edge_arrays(L_pad, V, seed, B=48, nh=6):
    """pair_stats's inputs (numpy, STATS_ARG_NAMES) with the rows a wrong
    loop order breaks, pair i by i % 8: an aligned walk; an ins run
    across columns 32 (and 64); event positions repeated across column
    32 (an ins entry, a match at its position, a second entry there, a
    deletion); garbage states (negative, past 2 S_half, RO, 0); one ins
    run on the hap over the whole row; an ins run over all of columns
    32-63 entering the hap at 40; random jumps and ins runs; off-hap
    sentinels at both ends.  The first half of the pairs come in runs
    that share a hap, the rest in random order.  Pair 0 has read_len 0,
    pair 1 read_len >
    L_pad, pair 2 hap_len 0, pair 3 hap_len H_pad; log10q holds NaN,
    +-inf and -0.0; the V slots reach the -3/-4 sentinels and below 0,
    some are empty or invalid.  Returns (H_pad, arrays)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    H_pad = L_pad + 20
    SP, RO = H_pad + 2, H_pad + 1
    hl = rng.randint(L_pad // 2, H_pad + 1, size=B)
    hl[2], hl[3] = 0, H_pad
    rl = np.where(rng.rand(B) < 0.5, L_pad, rng.randint(1, L_pad + 1, B))
    rl[0], rl[1] = 0, L_pad + 7
    # the run and repeat rows on the hap and the read from end to end
    runs = (np.arange(B) >= 4) & np.isin(np.arange(B) % 8, (1, 2, 4, 5))
    rl[runs], hl[runs] = L_pad, H_pad
    col = np.arange(L_pad)
    ms = np.zeros((B, L_pad), np.int64)
    for i in range(B):
        s0 = rng.randint(0, 9)
        walk = np.minimum(s0 + 1 + col, RO)
        row = walk.copy()
        kind = i % 8
        if kind == 1:
            for lo, hi in ((29, 37), (60, 71)):
                if hi <= L_pad:
                    row[lo:hi] = SP + walk[lo - 1]
                    row[hi:] = np.minimum(walk[lo - 1] + 1 + col[hi:] - hi,
                                          RO)
        elif kind == 2 and L_pad >= 8:
            o = min(30, L_pad - 4)     # the second entry at column 32 or 33
            p = walk[o - 1]
            row[o:o + 2] = SP + p      # an entry at position p
            row[o + 2] = p             # a match there
            row[o + 3] = SP + p        # a second entry at p: not new
            row[o + 4:o + 5] = p + 3   # a deletion after it
            row[o + 5:] = np.minimum(p + 6 + col[o + 5:] - o - 5, RO)
        elif kind == 3:
            row = rng.randint(-3 * SP, 3 * SP, size=L_pad)
            row[rng.rand(L_pad) < 0.1] = RO
            row[rng.rand(L_pad) < 0.1] = 0
            row[rng.rand(L_pad) < 0.1] = SP + RO
        elif kind == 4:
            row = SP + np.minimum(walk, H_pad)
        elif kind == 5 and L_pad >= 64:
            row[32:64] = SP + RO       # ins off the hap (xs = hl + 1)
            row[40:64] = SP + walk[39]
        elif kind == 6:
            steps = rng.choice([1, 1, 1, 0, 2, 3], size=L_pad)
            row = np.minimum(np.cumsum(steps) + s0, RO)
            ins = rng.rand(L_pad) < 0.15
            row[ins] += SP
        elif kind == 7:
            row[:3] = 0
            row[-4:] = RO
        ms[i] = row
    codes = np.frombuffer(b"ACGTN", np.uint8)
    hc = codes[rng.choice(5, size=(nh, H_pad), p=[.225, .225, .225, .225,
                                                   .1])]
    hap_idx = rng.randint(0, nh, size=B)
    hap_idx[:B // 2].sort()  # runs of pairs with one hap, as in a slab
    read_idx = rng.permutation(B)
    rc = np.zeros((B, L_pad), np.uint8)
    for i in range(B):
        xs = ms[i] % SP
        match = hc[hap_idx[i], np.clip(xs - 1, 0, H_pad - 1)]
        rc[read_idx[i]] = np.where(rng.rand(L_pad) < 0.9, match,
                                   codes[rng.randint(0, 5, L_pad)])
    lq = -rng.rand(B, L_pad) * 4
    u = rng.rand(B, L_pad)
    lq[u < 0.03] = np.nan
    lq[(u >= 0.03) & (u < 0.06)] = np.inf
    lq[(u >= 0.06) & (u < 0.09)] = -np.inf
    lq[(u >= 0.09) & (u < 0.14)] = -0.0
    left = rng.randint(-5, H_pad, size=(nh, V)).astype(np.int32)
    if V:
        left[:2, 0] = -4, -3
    return H_pad, dict(
        map_state=ms.astype(np.int32), read_len=rl.astype(np.int32),
        hap_len=hl.astype(np.int32), read_idx=read_idx.astype(np.int64),
        hap_idx=hap_idx.astype(np.int64), read_codes_r=rc, hap_codes_h=hc,
        bqt_r=rng.rand(B, L_pad) < 0.8, q95_r=rng.rand(B, L_pad) < 0.5,
        log10q_r=lq,
        v_left_h=left,
        v_right_h=(left + rng.randint(-1, 9, size=(nh, V))).astype(np.int32),
        v_isdel_h=rng.rand(nh, V) < 0.5, v_valid_h=rng.rand(nh, V) < 0.8,
        off_hap_hmq=rng.rand(B) < 0.2)


def stats_edge_args(kw, device, max_mm=2):
    """pair_stats's arguments at one STATS_EDGE_CASES row, on `device`."""
    import torch
    H_pad, a = stats_edge_arrays(**kw)
    return (H_pad, kw["L_pad"], kw["V"],
            *[torch.as_tensor(a[k], device=device) for k in STATS_ARG_NAMES],
            max_mm)


def fold_inputs(n_windows, nh, nr, S, dtype, device, seed):
    """The per-window fold layout of a slab of n_windows windows of nh
    haps x nr reads (pairs window-major, hap, read), W padded to a power
    of two of at least 8 as the engine lays it out: (W, NH, S, NR,
    index_map, nr_w, pair_pr)."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    W = max(8, 1 << (n_windows - 1).bit_length())
    NP = nh * (nh + 1) // 2
    index_map = np.zeros((W, nh, nr), np.int32)
    nr_w = np.zeros(W, np.int32)
    for w in range(n_windows):
        index_map[w] = (w * nh * nr + np.arange(nh)[:, None] * nr
                        + np.arange(nr)[None, :])
        nr_w[w] = nr
    pair_pr = -rng.rand(W, S, NP) * 10
    t = lambda a, d=None: torch.as_tensor(a, dtype=d, device=device)  # noqa
    return (W, nh, S, nr, t(index_map), t(nr_w), t(pair_pr, dtype))


def finish_mismatches(k, r, read_len, L_pad):
    """Names of the finish outputs where kernel `k` and plain `r` differ
    (map_state on the consumed columns)."""
    import torch
    valid = (torch.arange(L_pad, device=read_len.device)[None, :]
             < read_len.long()[:, None])
    bad = []
    for nm, a, b in zip(FINISH_NAMES, k, r):
        if nm == "map_state":
            a, b = a.masked_fill(~valid, -1), b.masked_fill(~valid, -1)
        if a.dtype != b.dtype or not torch.equal(a, b):
            bad.append(nm)
    return bad


def finish_check(H_pad, L_pad, numT, dp, fin, exact):
    """The finish kernel against the plain finish on the DP outputs `dp`:
    with read_len (the slab programs' call) on the consumed columns, and
    without it on every column (both then decode the same rows).
    Returns (kernel outputs, mismatches)."""
    from dindel_tpu_torch.hmm import epilogue_kernel as ek
    from dindel_tpu_torch.hmm.finish import finish as plain

    args = (H_pad, L_pad, numT, fin["b_mid"], fin["hap_len"], dp[0], dp[1],
            fin["obs_mid"], fin["prior_rmq"], fin["prior_hmq"], dp[2], dp[3])
    r = plain(*args, exact_ties=exact)
    k = ek.finish(*args, exact_ties=exact, read_len=fin["read_len"])
    full = ek.finish(*args, exact_ties=exact)
    sync(dp[0].device)
    bad = finish_mismatches(k, r, fin["read_len"], L_pad)
    bad += [f"{n} (all columns)" for n, a, b in zip(FINISH_NAMES, full, r)
            if not a.equal(b)]
    return k, bad


def same_bits(a, b):
    """Equal tensors bit for bit, NaN equal to NaN (the sign and payload
    of a NaN an add makes may follow the order of its operands)."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.dtype.is_floating_point:
        return torch.equal(a, b)
    it = torch.int64 if a.element_size() == 8 else torch.int32
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a.masked_fill(na, 0).view(it),
                                               b.masked_fill(nb, 0).view(it))


def stats_check(H_pad, L_pad, map_state, off_hap_hmq, tables, max_mm=2):
    """The pair_stats kernel against the plain version (same_bits);
    returns the mismatching output names."""
    from dindel_tpu_torch.hmm import epilogue_kernel as ek
    from dindel_tpu_torch.hmm.stats import pair_stats as plain

    V = tables[-1].shape[1]
    args = (H_pad, L_pad, V, map_state, *tables, off_hap_hmq, max_mm)
    k, r = ek.pair_stats(*args), plain(*args)
    sync(map_state.device)
    return [n for n, a, b in zip(STATS_NAMES, k, r) if not same_bits(a, b)]


def stats_edge_case(kw, device):
    """pair_stats against its plain version at one STATS_EDGE_CASES row;
    returns the mismatches."""
    a = stats_edge_args(kw, device)
    return stats_check(a[0], a[1], a[3], a[17], list(a[4:17]), a[18])


def window_check(ll, fold):
    """The window_call kernel against the plain version on the folds
    `fold` = (W, NH, S, NR, index_map, nr_w, pair_pr); returns (largest
    ulp distance, largest absolute difference)."""
    from dindel_tpu_torch.hmm import epilogue_kernel as ek
    from dindel_tpu_torch.infer.device_call import window_call as plain

    k, r = ek.window_call(*fold[:4], ll, *fold[4:]), plain(*fold[:4], ll,
                                                           *fold[4:])
    sync(ll.device)
    err = max(float((a - b).abs().max()) if a.numel() else 0.0
              for a, b in zip(k, r))
    return max(ulps(a, b) for a, b in zip(k, r)), err


def epilogue_edge_case(kw, exact, device):
    """finish and pair_stats (V = EPI_V and V = 0) against their plain
    versions at one of K1's EDGE_CASES shapes, on K1's outputs (its
    unwritten backpointer rows included); returns the mismatches."""
    import numpy as np
    import torch
    from dindel_tpu_torch.hmm.dp_kernel import pair_hmm_dp

    args, bounds = edge_inputs(device=device, **kw)
    B, H_pad, L_pad, numT = kw["B"], kw["H_pad"], kw["L_pad"], kw["numT"]
    rng = np.random.RandomState(kw["seed"] + 50)
    S = 2 * (H_pad + 2)
    dt = args[8].dtype

    def grid(lo, hi):
        a = np.round(rng.uniform(lo, hi, size=(B, S)) * 4) / 4
        return torch.as_tensor(a, dtype=dt, device=device)

    def flags():
        return torch.as_tensor(rng.rand(B, L_pad) < 0.8, device=device)
    fin = dict(b_mid=args[5], hap_len=args[3], read_len=args[4],
               obs_mid=grid(-2, 0), prior_rmq=grid(-3, 0),
               prior_hmq=grid(-3, 0))
    # tables with one read and one hap row per pair
    t = dict(read_len=args[4], hap_len=args[3],
             read_idx=torch.arange(B, device=device),
             hap_idx=torch.arange(B, device=device), read_codes_r=args[6],
             hap_codes_h=args[7], bqt_r=flags(), q95_r=flags(),
             log10q_r=torch.as_tensor(-rng.rand(B, L_pad) * 4,
                                      device=device))
    dp = pair_hmm_dp(*args, exact_ties=exact, bounds=bounds)
    k, bad = finish_check(H_pad, L_pad, numT, dp, fin, exact)
    tabs = stats_tables(t, device, kw["seed"])
    bad += stats_check(H_pad, L_pad, k[5], k[2], tabs)
    tabs[-4:] = [x[:, :0].contiguous() for x in tabs[-4:]]
    bad += [f"{n} (V=0)" for n in stats_check(H_pad, L_pad, k[5], k[2],
                                              tabs)]
    return bad


# window_call's edge shapes: (windows, NH, S, NR, dtype); one window of
# each has half its reads
FOLD_EDGE_CASES = [(1, 1, 1, 1, "float32"), (3, 5, 0, 7, "float32"),
                   (2, 8, 3, 130, "float64"), (9, 4, 2, 33, "float32")]


# finish's rows that break a wrong combine (special_rows' kinds)
SPECIALS = ("ties", "near", "nan", "pm0", "ninf")


def special_rows(kind, B, S, dt, rng):
    """(B, S) rows of v that break a wrong combine; row i moves the
    pattern i columns right, so its columns fall in other lanes.
    ties: the maximum at three columns in three sub-rows (and a tie on
    the xm == 0 columns); near: values within EPS of each other in
    several lanes and sub-rows (the exact fold keeps an earlier one than
    the fast fold); nan: NaN in several lanes (and at xm == 0); pm0:
    -0.0 and +0.0 at the maximum, in both orders (row parity), on-hap and
    at xm == 0; ninf: every value -inf, and -inf with one NaN."""
    import numpy as np
    from dindel_tpu_torch.hmm.reference import EPS

    SP = S // 2
    M = dt(-1.0)
    eps = dt(EPS)
    rows = (np.round(rng.uniform(-6, -1.25, size=(B, S)) * 4) / 4).astype(dt)
    for i in range(B):
        row = rows[i]

        def put(col, val):
            row[(col + i) % S] = val
        if kind == "ties":
            for col in (5, 37, 70):
                put(col, M)
            row[0] = row[SP] = dt(-1.5)
        elif kind == "near":
            for col, k in ((7, 0.0), (38, 0.6), (70, 1.1), (71, 1.7),
                           (90 % S, 2.0)):
                put(col, M + dt(k) * eps)
        elif kind == "nan":
            for col in (9, 41, 80 % S):
                put(col, dt(np.nan))
            row[SP] = dt(np.nan)
        elif kind == "pm0":
            z = (dt(-0.0), dt(0.0)) if i % 2 else (dt(0.0), dt(-0.0))
            put(4, z[0])
            put(50 % S, z[1])
            row[0], row[SP] = z
        elif kind == "ninf":
            row[:] = -np.inf
            if i % 2:
                put(33, dt(np.nan))
    return rows


def window_special_case(dtype, seed=1):
    """window_call's inputs with the cases a wrong loop breaks (numpy):
    five windows of 5 haps x 19 reads (a multiple of no chunk), nr_w =
    NR, 11, 0, above NR and below 0, -inf ll values (NaN terms), and
    -0.0 seeds in the windows of NR and of 0 reads."""
    import numpy as np
    rng = np.random.RandomState(seed)
    W, NH, S, NR = 5, 5, 2, 19
    NP = NH * (NH + 1) // 2
    ll = -rng.gamma(2.0, 40.0, size=W * NH * NR).astype(np.float32)
    ll[rng.rand(ll.size) < 0.05] = -np.inf  # -inf pairs give NaN terms
    index_map = rng.randint(0, ll.size, size=(W, NH, NR)).astype(np.int32)
    nr_w = np.array([NR, 11, 0, NR + 3, -1], np.int32)
    pair_pr = (-rng.rand(W, S, NP) * 10).astype(dtype)
    pair_pr[0, 0, 0] = pair_pr[2, 1, 3] = -0.0
    return W, NH, S, NR, ll, index_map, nr_w, pair_pr


def same_values(a, b):
    """Equal tensors, NaN equal to NaN (a zero to a zero of either sign)."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.dtype.is_floating_point:
        return torch.equal(a, b)
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def first_bits(vr, vals, SP):
    """Names of the fold values (ll, ll_off, ll_on of each row) that do
    not carry the bits of the first column holding their value, of the
    row, of its xm == 0 columns and of its other on-hap columns (a NaN:
    the first NaN's bits): the sequential fold's rule, signed zeros
    included, which plain's vectorised max need not keep."""
    import numpy as np
    vr = vr.cpu().numpy()
    xm = np.arange(vr.shape[1]) % SP
    cols = (np.ones(vr.shape[1], bool), xm == 0, (xm != 0) & (xm != SP - 1))
    bad = []
    for name, got, c in zip(("ll", "ll_off", "ll_on"), vals, cols):
        for i, val in enumerate(got.cpu().numpy()):
            row = vr[i][c]
            same = np.isnan(row) if np.isnan(val) else row == val
            if same.any() and row[np.argmax(same)].tobytes() != val.tobytes():
                bad.append(f"{name} bits")
                break
    return bad


def epilogue_special_phase(device):
    """finish on rows that break a wrong combine (SPECIALS, planted in vr
    and vh with alpha = beta = obs = -0.0) on K1's outputs, both folds,
    float32 and float64, against its plain version (values NaN-equal,
    flags and map_state on the consumed columns equal) and bit for bit
    against the sequential fold (first_bits: a zero's sign and a NaN's
    bits from the first column holding them); window_call at
    window_special_case in both types (0 ulps, NaN terms included).
    Returns the failures."""
    import numpy as np
    import torch
    from dindel_tpu_torch.hmm import epilogue_kernel as ek
    from dindel_tpu_torch.hmm.dp_kernel import pair_hmm_dp
    from dindel_tpu_torch.hmm.finish import finish as plain

    def up(a):
        return torch.as_tensor(a, device=device)

    failed = []
    for dtype in ("float32", "float64"):
        dt = getattr(np, dtype)
        args, bounds = edge_inputs(B=9, H_pad=46, L_pad=24, numT=7,
                                   dtype=dtype, seed=8, device=device)
        B, S = 9, 2 * 48
        valid = (torch.arange(24, device=device)[None, :]
                 < args[4].long()[:, None])
        for exact in (False, True):
            dp = pair_hmm_dp(*args, exact_ties=exact, bounds=bounds)
            for kind in SPECIALS:
                rng = np.random.RandomState(SPECIALS.index(kind))
                zero = up(np.full((B, S), -0.0, dt))
                prm = up(special_rows(kind, B, S, dt, rng))
                phm = up(np.roll(special_rows(kind, B, S, dt, rng), 3, 1))
                fargs = (46, 24, 7, args[5], args[3], zero, zero, zero, prm,
                         phm, dp[2], dp[3])
                k = ek.finish(*fargs, exact_ties=exact, read_len=args[4])
                r = plain(*fargs, exact_ties=exact)
                sync(device)
                bad = [n for n, a, b in zip(FINISH_NAMES, k, r)
                       if not (same_values(a.masked_fill(~valid, -1),
                                           b.masked_fill(~valid, -1))
                               if n == "map_state" else same_values(a, b))]
                if torch.device(device).type == "cuda":  # the kernel's
                    bad += first_bits(((zero + zero) + zero) + prm,
                                      (k[0], k[3], k[4]), 48)
                if bad:
                    failed.append((dtype, "exact" if exact else "fast",
                                   kind, bad))
    for dtype in ("float32", "float64"):
        W, NH, S, NR, ll, im, nr_w, pp = window_special_case(
            getattr(np, dtype))
        u, err = window_check(up(ll), (W, NH, S, NR, up(im), up(nr_w),
                                       up(pp)))
        if u:
            failed.append((f"window_call {dtype}", f"{u} ulps", err))
    log(f"[epilogue-special] finish at {len(SPECIALS)} kinds of rows x 2 "
        f"folds x 2 types (values as plain, bits as the sequential fold), "
        f"window_call with NaN terms, signed zeros and "
        f"nr_w 0, above NR and below 0: failed {failed}")
    return failed


def window_edge_case(case, device):
    """window_call against its plain version at one FOLD_EDGE_CASES
    shape; returns (largest ulp distance, largest absolute difference)."""
    import numpy as np
    import torch

    n_w, nh, S, nr, dtype = case
    rng = np.random.RandomState(nh)
    dt = getattr(torch, dtype)
    ll = torch.as_tensor(-rng.gamma(2.0, 40.0, size=n_w * nh * nr),
                         dtype=dt, device=device)
    fold = fold_inputs(n_w, nh, nr, S, dt, device, nh)
    fold[5][n_w - 1] = nr // 2
    return window_check(ll, fold)


def epilogue_edge_phase(device):
    """K2-K4 against their plain versions at the edge shapes (K1's
    EDGE_CASES: S_half up to 1024, numT 2..15, b_mid at 0 and at
    read_len-1, a zero-length hap, float64) in both folds, pair_stats
    at STATS_EDGE_CASES and window_call at FOLD_EDGE_CASES."""
    failed = []
    for name, kw in EDGE_CASES:
        for exact in (False, True):
            bad = epilogue_edge_case(kw, exact, device)
            if bad:
                failed.append((name, "exact" if exact else "fast", bad))
    for name, kw in STATS_EDGE_CASES:
        bad = stats_edge_case(kw, device)
        if bad:
            failed.append((name, bad))
    for case in FOLD_EDGE_CASES:
        u, err = window_edge_case(case, device)
        if u:
            failed.append((f"window_call {case}", f"{u} ulps", err))
    log(f"[epilogue-edge] finish and pair_stats (V=0 and V={EPI_V}) at "
        f"{len(EDGE_CASES)} shapes x 2 folds, pair_stats at its "
        f"{len(STATS_EDGE_CASES)} edge rows (L_pad 33-200, V 0/1/8; runs "
        f"and repeated events across column 32; NaN, +-inf, -0.0 terms), "
        f"window_call at {len(FOLD_EDGE_CASES)} shapes: failed {failed}")
    if failed:
        raise SystemExit(f"epilogue kernels disagree with their plain "
                         f"versions: {failed}")


def epilogue_phase(name, n_windows, seed, device, reps, plain_reps,
                   nr=NR, dtype="float32"):
    """K2-K4 against their plain versions on one slab of the DP bench
    geometry (K1's outputs, `dtype`), in both folds (pair_stats and
    window_call on the fast fold's outputs, the shipped mode); each
    timed with CUDA events beside its plain version and its bound.
    Returns {kernel: row}."""
    import numpy as np
    import torch
    from dindel_tpu_torch.hmm import epilogue_kernel as ek
    from dindel_tpu_torch.hmm.dp_kernel import pair_hmm_dp
    from dindel_tpu_torch.hmm.finish import finish as plain_finish
    from dindel_tpu_torch.hmm.pack import tables_to_device
    from dindel_tpu_torch.hmm.stats import pair_stats as plain_stats
    from dindel_tpu_torch.infer.device_call import window_call as plain_fold

    pk, args, bounds, fin = dp_inputs(n_windows, seed, device, nr=nr,
                                      dtype=dtype)
    B = pk["hap_len"].shape[0]
    H_pad, L_pad, numT = pk["H_pad"], pk["L_pad"], pk["numT"]
    S = 2 * (H_pad + 2)
    dt, size = getattr(torch, dtype), np.dtype(dtype).itemsize
    rows = {}
    for exact in (False, True):
        mode = "exact" if exact else "fast"
        dp = pair_hmm_dp(*args, exact_ties=exact, bounds=bounds)
        k, bad = finish_check(H_pad, L_pad, numT, dp, fin, exact)
        if bad:
            raise SystemExit(f"finish kernel disagrees with its plain "
                             f"version: {name} {mode} {bad}")
        fargs = (H_pad, L_pad, numT, fin["b_mid"], fin["hap_len"], dp[0],
                 dp[1], fin["obs_mid"], fin["prior_rmq"], fin["prior_hmq"],
                 dp[2], dp[3])
        t = kernel_times(lambda: ek.finish(*fargs, exact_ties=exact,
                                           read_len=fin["read_len"]), reps,
                         device, "finish_kernel")
        plain_ms = time_ms(lambda: plain_finish(*fargs, exact_ties=exact),
                           plain_reps, device)
        steps = walked_steps(pk["b_mid"], pk["read_len"], L_pad)
        b_ms, b_by = finish_bound(B, S, L_pad, steps, size)
        rows.setdefault("finish", {})[mode] = dict(
            **t, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            max_abs_err=0.0, B=B, S=S, L_pad=L_pad)
        log(f"[epilogue] {name} B={B} S={S} L_pad={L_pad} {mode}: finish "
            f"bit-equal to plain; kernel {fmt_times(t)}, plain "
            f"{plain_ms!r} ms, bound {b_ms!r} ms ({b_by}, {steps} walked "
            f"steps), share of the bound {share(b_ms, t)}; launch "
            f"{launch_desc(device, 'finish', B, L_pad, size)}")
        if exact:
            continue
        t = tables_to_device(pk, device)
        tabs = stats_tables(t, device, seed)
        bad = stats_check(H_pad, L_pad, k[5], k[2], tabs)
        if bad:
            raise SystemExit(f"pair_stats kernel disagrees with its plain "
                             f"version: {name} {bad}")
        # V = 0: the counts and scans without the slot tests
        tabs0 = tabs[:-4] + [x[:, :0].contiguous() for x in tabs[-4:]]
        bad = stats_check(H_pad, L_pad, k[5], k[2], tabs0)
        if bad:
            raise SystemExit(f"pair_stats kernel disagrees with its plain "
                             f"version: {name} V=0 {bad}")
        cols = int(np.minimum(pk["read_len"], L_pad).sum())
        nr_t, nh_t = pk["read_codes_r"].shape[0], pk["hap_codes_h"].shape[0]
        for V, tb in ((EPI_V, tabs), (0, tabs0)):
            sargs = (H_pad, L_pad, V, k[5], *tb, k[2], 2)
            t = kernel_times(lambda: ek.pair_stats(*sargs), reps, device,
                             "pair_stats_kernel")
            plain_ms = time_ms(lambda: plain_stats(*sargs), plain_reps,
                               device)
            b_ms, b_by = stats_bound(B, L_pad, V, nr_t, nh_t, H_pad, cols)
            row = dict(**t, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       max_abs_err=0.0, B=B, V=V)
            if V:
                rows["pair_stats"] = row
            else:
                rows["pair_stats"]["at_V0"] = row
            log(f"[epilogue] {name} pair_stats V={V}: bit-equal to plain; "
                f"kernel {fmt_times(t)}, plain {plain_ms!r} ms, bound "
                f"{b_ms!r} ms ({b_by}), share of the bound {share(b_ms, t)};"
                f" launch "
                f"{launch_desc(device, 'pair_stats', B, H_pad, L_pad, V)}")
        fold = fold_inputs(n_windows, NH, nr, EPI_SITES, dt, device, seed)
        u, err = window_check(k[0], fold)
        if u:
            raise SystemExit(f"window_call kernel disagrees with its plain "
                             f"version: {name} {u} ulps, max abs {err!r}")
        t = kernel_times(lambda: ek.window_call(*fold[:4], k[0],
                                                *fold[4:]),
                         reps, device, "window_call_kernel")
        plain_ms = time_ms(lambda: plain_fold(*fold[:4], k[0], *fold[4:]),
                           plain_reps, device)
        b_ms, b_by = window_bound(fold[0], NH, EPI_SITES, nr,
                                  n_windows * nr, size)
        rows["window_call"] = dict(**t, plain_ms=plain_ms, bound_ms=b_ms,
                                   bound_by=b_by, max_abs_err=err,
                                   max_ulps=u, W=fold[0], NH=NH,
                                   S=EPI_SITES, NR=nr)
        log(f"[epilogue] {name} window_call W={fold[0]} NH={NH} "
            f"S={EPI_SITES} NR={nr}: bit-equal to plain; kernel "
            f"{fmt_times(t)}, plain {plain_ms!r} ms, bound {b_ms!r} ms "
            f"({b_by}), share of the bound {share(b_ms, t)}; launch "
            + launch_desc(device, "window_call", fold[0], NH, EPI_SITES, nr,
                          size))
    return rows


def sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def time_ms(fn, reps, device, host=False):
    """Mean time per call over `reps` chained calls (CUDA events; the
    calls serialize on the current stream), after one warm-up call.
    With `host`, returns (that time, the host clock's mean per call from
    the first enqueue to the end of the chain's synchronize)."""
    import torch
    fn()
    sync(device)
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        ms = (time.perf_counter() - t0) * 1e3 / reps
        return (ms, ms) if host else ms
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    ms = start.elapsed_time(end) / reps
    return (ms, host_ms) if host else ms


def device_ms(fn, reps, kernel):
    """The mean device time (ms) of one launch of the CUDA kernel whose
    name holds `kernel`, over `reps` calls of `fn` under torch.profiler
    (its key_averages); None where the profiler shows no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for ev in prof.key_averages():
        if kernel in ev.key and ev.key != "cudaLaunchKernel":
            us = getattr(ev, "device_time_total", None)
            if us is None:
                us = getattr(ev, "cuda_time_total", 0.0)
            if us:
                total += us
                count += ev.count
    return total / count / 1e3 if count else None


def kernel_times(fn, reps, device, kernel):
    """{ms, host_ms, device_ms} of the wrapper `fn` that launches
    `kernel`: CUDA events and the host clock over `reps` chained calls
    (time_ms; the two agree when the host's enqueue, not the kernel, sets
    the pace), and the kernel's own device time (device_ms; None off a
    card or where the profiler shows none)."""
    import torch
    ms, host_ms = time_ms(fn, reps, device, host=True)
    dev = (device_ms(fn, reps, kernel)
           if torch.device(device).type == "cuda" else None)
    return dict(ms=ms, host_ms=host_ms, device_ms=dev)


def fmt_times(t):
    dev = ("not measured" if t["device_ms"] is None
           else f"{t['device_ms']!r} ms")
    return (f"events {t['ms']!r} ms, host {t['host_ms']!r} ms, device "
            f"(profiler) {dev}")


def launch_floor(device, reps=200):
    """The empty kernel's times through the wrappers' ctypes path
    (epilogue_kernel.noop): the floor no launch beats."""
    from dindel_tpu_torch.hmm import epilogue_kernel as ek
    t = kernel_times(lambda: ek.noop(device), reps, device, "noop_kernel")
    log(f"[floor] empty launch through the ctypes path: {fmt_times(t)}")
    return t


def launch_desc(device, kernel, *sizes):
    """The launch the kernel's entry point picks for these sizes
    (epilogue_kernel.launch_shape), as text."""
    import torch
    from dindel_tpu_torch.hmm import epilogue_kernel as ek
    if torch.device(device).type != "cuda":
        return "none (no card)"
    shape = ek.launch_shape(kernel, *sizes)
    if kernel != "window_call":
        return (f"{shape[0]} pairs a block, {shape[1]} blocks, "
                f"{shape[2]} bytes of shared memory a block")
    return (f"{shape[0]} pairs a block, {shape[1]} reads a chunk, "
            f"{shape[2]} blocks, {shape[3]} bytes of shared memory a block")


def share(bound_ms, t):
    """The share of the bound the kernel reaches, by the CUDA events and
    by its own device time."""
    dev = ("not measured" if t["device_ms"] is None
           else f"{bound_ms / t['device_ms']:.4f}")
    return f"{bound_ms / t['ms']:.4f} (events), {dev} (device)"


# ---------------------------------------------------------------------------
# phases 4-6: the slice


def simulate_bench(d: Path, n_var, coverage, read_len):
    """tools/bench_windows.py's dataset: indels every 900 bp, seed 3."""
    import numpy as np
    from dindel_tpu_torch.sim import PlantedVariant, SimConfig, simulate

    rng = np.random.RandomState(7)
    variants = []
    for i in range(n_var):
        kind = rng.randint(3)
        if kind == 0:
            var = "-" + "ACGT"[rng.randint(4)] * rng.randint(1, 4)
        elif kind == 1:
            var = "+" + "".join("ACGT"[rng.randint(4)]
                                for _ in range(rng.randint(1, 4)))
        else:
            var = "-AC"
        variants.append(PlantedVariant(pos=(i + 1) * 900, var=var,
                                       genotype=1 + rng.randint(2)))
    cfg = SimConfig(ref_len=(n_var + 2) * 900, coverage=coverage,
                    read_len=read_len)
    fa, bam = simulate(str(d / "sim"), variants, cfg, seed=3)
    return fa, bam, variants


def run_cli(*argv):
    """One `python -m dindel_tpu_torch` command, in process."""
    from dindel_tpu_torch import cli

    rc = cli.main([str(a) for a in argv])
    if rc != 0:
        raise SystemExit(f"CLI {argv[:2]} returned {rc}")


def cli_pipeline(d: Path, fa, bam, device):
    """getCIGARindels -> makeWindows -> indels -> mergeOutputDiploid
    through the port's CLI; returns (window file, GLF, VCF, indels s)."""
    run = run_cli
    run("--analysis", "getCIGARindels", "--bamFile", bam, "--ref", fa,
        "--outputFile", str(d / "cand"))
    run("--analysis", "makeWindows", "--inputVarFile",
        str(d / "cand.variants.txt"), "--windowFilePrefix", str(d / "win"))
    wins = sorted(d.glob("win.*.txt"),
                  key=lambda p: int(p.name.split(".")[1]))
    glfs = []
    t0 = time.perf_counter()
    for wf in wins:
        out = str(d / f"out_{wf.name.split('.')[1]}")
        indels_cli(fa, bam, wf, out, device, "--doDiploid")
        glfs.append(out + ".glf.txt")
    indels_s = time.perf_counter() - t0
    (d / "glfs.txt").write_text("".join(g + "\n" for g in glfs))
    run("--analysis", "mergeOutputDiploid", "--inputFiles",
        str(d / "glfs.txt"), "--ref", fa, "--outputFile",
        str(d / "calls.vcf"))
    return wins, glfs, d / "calls.vcf", indels_s


def vcf_records(vcf: Path):
    return [line.rstrip("\n").split("\t") for line in open(vcf)
            if not line.startswith("#")]


def glf_rows_ok(glfs):
    """(ok rows, no NaN) over the GLF files: no ok row may carry a NaN
    logZ or qual (an infinite qual is a legitimate reference output)."""
    n, no_nan = 0, True
    for g in glfs:
        lines = open(g).read().splitlines()
        head = lines[0].split()
        for line in lines[1:]:
            rec = dict(zip(head, line.split()))
            if rec.get("msg") != "ok":
                continue
            n += 1
            for key in ("logZ", "qual"):
                if key in rec and rec[key] != "NA":
                    no_nan &= not math.isnan(float(rec[key]))
    return n, no_nan


def engine_pass(fa, bam, win_files, glf, device, folds=None, em=None,
                max_pairs=24576, flank=None, f64=False, mesh=None,
                lib_file=None, hmm_backend=None, batch_windows=128,
                **attrs):
    """One pass of the port's batched engine (the shipped configuration:
    float32, fast ties; with `f64`, float64 and exact ties; on `mesh`
    when given) over the window files in order, their GLFs merged into
    `glf` as hostshard merges its shards (one header); `attrs` are set on
    the Parameters (diploid by default), `flank` is --flankRefSeq,
    `lib_file` is --insertPrior --libFile <lib_file>, `batch_windows`
    --batchWindows.  With `hmm_backend`, the streaming engine
    (WindowEngine, the CLI's default) with that backend runs instead of
    the batched one."""
    import numpy as np
    from dindel_tpu_torch.config import Parameters
    from dindel_tpu_torch.engine.batched import BatchedWindowEngine
    from dindel_tpu_torch.engine.window import WindowEngine
    from dindel_tpu_torch.model import LibraryCollection
    from dindel_tpu_torch.parallel.hostshard import merge_glf

    params = Parameters()
    params.do_diploid = True
    params.file_name = str(glf)[:-len(".glf.txt")]
    for k, v in attrs.items():
        setattr(params, k, v)
    if flank is not None:
        params.obs_params.pad_cover = flank
    libraries = None
    if lib_file is not None:
        # as the CLI sets --insertPrior and --libFile (cli.py)
        params.obs_params.map_unmapped_reads = True
        params.map_unmapped_reads = True
        libraries = LibraryCollection()
        libraries.add_from_file(str(lib_file))
    if hmm_backend is not None:
        eng = WindowEngine([bam], fa, params, libraries,
                           hmm_backend=hmm_backend, device=device)
    else:
        eng = BatchedWindowEngine([bam], fa, params, libraries,
                                  device=device, exact_ties=f64,
                                  dtype=np.float64 if f64 else np.float32,
                                  device_folds=folds, device_em=em,
                                  batch_windows=batch_windows,
                                  max_pairs_per_slab=max_pairs, mesh=mesh)
    parts = ([Path(f"{glf}.{i}") for i in range(len(win_files))]
             if len(win_files) > 1 else [Path(glf)])
    t0 = time.perf_counter()
    try:
        for wf, part in zip(win_files, parts):
            eng.detect_indels(str(wf), str(part))
        sync(device)
    finally:
        eng.close()
    wall = time.perf_counter() - t0
    if len(parts) > 1:
        merge_glf([str(part) for part in parts], str(glf))
    return wall, eng.stats.summary()


def slice_phase(d: Path, device, n_var, coverage, read_len):
    import torch

    t0 = time.perf_counter()
    fa, bam, variants = simulate_bench(d, n_var, coverage, read_len)
    log(f"[slice] simulated {n_var} indels, {coverage}x, {read_len} bp in "
        f"{time.perf_counter() - t0:.3f} s")
    reset_launches()
    with FirstCalls("finish", "pair_stats", "window_call") as first:
        wins, glfs, vcf, indels_s = cli_pipeline(d, fa, bam, device)
    launches = read_launches()
    n_ok, no_nan = glf_rows_ok(glfs)
    recs = vcf_records(vcf)
    planted = {v.pos for v in variants}
    hit = sum(1 for v in planted
              if any(abs(int(r[1]) - 2432 - v) <= 10 for r in recs))
    log(f"[slice] CLI indels (cold) {indels_s:.3f} s over {len(wins)} window "
        f"files; kernel launches {launches}; ok GLF rows {n_ok}; no NaN "
        f"{no_nan}; VCF records {len(recs)}; planted indels recovered "
        f"{hit}/{len(planted)}")
    if launches["pair_hmm_dp"] <= 0 or n_ok <= 0 or not recs or not no_nan:
        raise SystemExit("slice phase failed: launches/rows/calls")
    check_launches("device_call", launches)
    main_slab = mainpath_epilogue(first.calls, device)
    del first  # the slab's planes, before the warm pass's peak memory
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    wall, st = engine_pass(fa, bam, wins, d / "warm.glf.txt", device)
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else None)
    stages = {k: round(v, 3) for k, v in st["stage_seconds"].items()}
    log(f"[slice] warm pass: windows_ok {st['windows_ok']} windows_error "
        f"{st['windows_error']} in {wall:.3f} s = "
        f"{st['windows_ok'] / wall:.6g} windows/s; stage seconds {stages}; "
        f"max_memory_allocated {peak} bytes")
    if st["windows_ok"] <= 0:
        raise SystemExit("slice phase failed: no window called")
    return fa, bam, wins, launches, main_slab


class FirstCalls:
    """While active: keeps the arguments of the first call of each named
    kernel wrapper that hmm/slab.py makes (the call itself goes through,
    and counts as it would)."""

    def __init__(self, *names):
        self.names = names

    def __enter__(self):
        from dindel_tpu_torch.hmm import slab

        self.calls = {}
        self.saved = {n: getattr(slab, n) for n in self.names}
        for n, real in self.saved.items():
            def first(*a, _n=n, _real=real, **k):
                self.calls.setdefault(_n, (a, k))
                return _real(*a, **k)
            setattr(slab, n, first)
        return self

    def __exit__(self, *exc):
        from dindel_tpu_torch.hmm import slab
        for n, real in self.saved.items():
            setattr(slab, n, real)
        return False


def mainpath_epilogue(calls, device, reps=20):
    """K2-K4 at the main path's own first slab (the arguments of phase
    4's first finish, pair_stats and window_call calls): each against
    its plain version, then timed beside it and its bound (after the
    path's launch count was read, so these launches are not the
    path's)."""
    import numpy as np
    from dindel_tpu_torch.hmm import epilogue_kernel as ek
    from dindel_tpu_torch.hmm.finish import finish as plain_finish
    from dindel_tpu_torch.hmm.stats import pair_stats as plain_stats
    from dindel_tpu_torch.infer.device_call import window_call as plain_fold

    fa, fk = calls["finish"]
    H_pad, L_pad, numT, b_mid = fa[:4]
    exact, read_len = fk.get("exact_ties", False), fk["read_len"]
    k = ek.finish(*fa, **fk)
    r = plain_finish(*fa, exact_ties=exact)
    sync(device)
    bad = finish_mismatches(k, r, read_len, L_pad)
    if bad:
        raise SystemExit(f"finish kernel disagrees with its plain version "
                         f"at the main path's slab: {bad}")
    B, S = fa[5].shape
    size = fa[5].element_size()
    t = kernel_times(lambda: ek.finish(*fa, **fk), reps, device,
                     "finish_kernel")
    plain_ms = time_ms(lambda: plain_finish(*fa, exact_ties=exact), 2,
                       device)
    steps = walked_steps(b_mid.cpu().numpy(), read_len.cpu().numpy(), L_pad)
    b_ms, b_by = finish_bound(B, S, L_pad, steps, size)
    out = {"finish": dict(B=B, H_pad=H_pad, L_pad=L_pad, **t,
                          plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)}
    log(f"[main-slab] finish at phase 4's first slab B={B} H_pad={H_pad} "
        f"L_pad={L_pad} {'exact' if exact else 'fast'}: bit-equal to "
        f"plain; kernel {fmt_times(t)}, plain {plain_ms!r} ms, bound "
        f"{b_ms!r} ms ({b_by}, {steps} walked steps), share of the bound "
        f"{share(b_ms, t)}; launch "
        f"{launch_desc(device, 'finish', B, L_pad, size)}")
    sa, _ = calls["pair_stats"]
    V, ms, rl = sa[2], sa[3], sa[4]
    bad = stats_check(H_pad, L_pad, ms, sa[17], list(sa[4:17]), sa[18])
    if bad:
        raise SystemExit(f"pair_stats kernel disagrees with its plain "
                         f"version at the main path's slab: {bad}")
    t = kernel_times(lambda: ek.pair_stats(*sa), reps, device,
                     "pair_stats_kernel")
    plain_ms = time_ms(lambda: plain_stats(*sa), 2, device)
    cols = int(rl.clamp(0, L_pad).sum())
    b_ms, b_by = stats_bound(B, L_pad, V, sa[8].shape[0], sa[9].shape[0],
                             H_pad, cols)
    out["pair_stats"] = dict(B=B, H_pad=H_pad, L_pad=L_pad, V=V, **t,
                             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             max_abs_err=0.0)
    log(f"[main-slab] pair_stats at phase 4's first slab B={B} "
        f"H_pad={H_pad} L_pad={L_pad} V={V}: bit-equal to plain; kernel "
        f"{fmt_times(t)}, plain {plain_ms!r} ms, bound {b_ms!r} ms "
        f"({b_by}), share of the bound {share(b_ms, t)}; launch "
        f"{launch_desc(device, 'pair_stats', B, H_pad, L_pad, V)}")
    wa, _ = calls["window_call"]
    W, NH, S, NR, ll, index_map, nr_w, pair_pr = wa
    u, err = window_check(ll, (W, NH, S, NR, index_map, nr_w, pair_pr))
    if u:
        raise SystemExit(f"window_call kernel disagrees with its plain "
                         f"version at the main path's slab: {u} ulps")
    t = kernel_times(lambda: ek.window_call(*wa), reps, device,
                     "window_call_kernel")
    plain_ms = time_ms(lambda: plain_fold(*wa), 2, device)
    size = pair_pr.element_size()
    nreads = int(np.clip(nr_w.cpu().numpy(), 0, NR).sum())
    b_ms, b_by = window_bound(W, NH, S, NR, nreads, size)
    out["window_call"] = dict(W=W, NH=NH, S=S, NR=NR, **t,
                              plain_ms=plain_ms, bound_ms=b_ms,
                              bound_by=b_by, max_abs_err=err)
    log(f"[main-slab] window_call at phase 4's first slab W={W} NH={NH} "
        f"S={S} NR={NR} ({nreads} reads): bit-equal to plain (0 ulps); "
        f"kernel {fmt_times(t)}, plain {plain_ms!r} ms, bound {b_ms!r} ms "
        f"({b_by}), share of the bound {share(b_ms, t)}; launch "
        f"{launch_desc(device, 'window_call', W, NH, S, NR, size)}")
    return out


def window_subset(wins, n_windows, path: Path):
    """The first n_windows lines of the window files, as one file;
    returns (path, number of windows)."""
    lines = []
    for wf in wins:
        lines += [x for x in open(wf).read().splitlines() if x.strip()]
    path.write_text("\n".join(lines[:n_windows]) + "\n")
    return path, min(n_windows, len(lines))


class Spy:
    """While active: counts the batched engine's slab programs per route
    (run_slab_stats: device call, run_slab_decode: full decode,
    run_slab_decode_sharded: full decode on a mesh, run_packed: dense)
    and its device VB-EM dispatches, and the streaming
    engine's scored windows (BatchedPairHMM.compute, with each window's
    pair count B, H_pad and L_pad in `shapes`, and the seconds of its
    pack, device and decode steps in `split`); keeps each engine's
    RunStats summary at close.  Wraps the names the engine modules call;
    restores them on exit."""

    NAMES = ("run_slab_stats", "run_slab_decode", "run_slab_decode_sharded",
             "run_packed", "run_batched_em")
    SPLIT = {"pack_pairs": "pack", "run_packed": "device",
             "decode_liks_view": "decode"}

    def __enter__(self):
        from dindel_tpu_torch.engine import batched, window
        from dindel_tpu_torch.hmm import batch

        self.counts = dict.fromkeys(self.NAMES, 0)
        self.counts["windows_scored"] = 0
        self.shapes, self.windows = [], []
        self.split = dict.fromkeys(self.SPLIT.values(), 0.0)
        self.saved = [(batched, n, getattr(batched, n)) for n in self.NAMES]
        self.saved += [(batch, n, getattr(batch, n)) for n in self.SPLIT]
        self.saved += [(batch.BatchedPairHMM, "compute",
                        batch.BatchedPairHMM.compute),
                       (window.WindowEngine, "close",
                        window.WindowEngine.close)]
        for n in self.NAMES:
            def wrapped(*a, _n=n, _real=getattr(batched, n), **k):
                self.counts[_n] += 1
                return _real(*a, **k)
            setattr(batched, n, wrapped)
        for n, step in self.SPLIT.items():
            def timed(*a, _step=step, _real=getattr(batch, n), **k):
                t0 = time.perf_counter()
                out = _real(*a, **k)
                if _step == "device":  # the caller's fetch waits here
                    out = [t.cpu() for t in out]
                if _step == "pack":
                    self.shapes.append((out["hap_len"].shape[0],
                                        out["H_pad"], out["L_pad"]))
                self.split[_step] += time.perf_counter() - t0
                return out
            setattr(batch, n, timed)
        compute = batch.BatchedPairHMM.compute

        def scored(hmm, *a, **k):
            self.counts["windows_scored"] += 1
            self.windows.append((hmm.params, *a))
            return compute(hmm, *a, **k)
        batch.BatchedPairHMM.compute = scored
        self.summaries = []
        close = window.WindowEngine.close

        def closed(eng):
            self.summaries.append(eng.stats.summary())
            return close(eng)
        window.WindowEngine.close = closed
        return self

    def __exit__(self, *exc):
        for owner, n, real in self.saved:
            setattr(owner, n, real)
        return False

    def stage_seconds(self):
        out = {}
        for s in self.summaries:
            for k, v in s["stage_seconds"].items():
                out[k] = round(out.get(k, 0.0) + v, 3)
        return out

    def windows_ok(self):
        return sum(s["windows_ok"] for s in self.summaries)


def ra_records(prefix: Path):
    """(file suffix, [(qname, pos, cigar, flag)]) of every realigned BAM
    written under `prefix`."""
    from dindel_tpu_torch.io.bam import BamReader

    paths = sorted(prefix.parent.glob(prefix.name + ".ra.*.bam"))
    return [(p.name[len(prefix.name):],
             [(r.qname, r.pos, r.cigar, r.flag) for r in BamReader(str(p))])
            for p in paths]


def card_vs_cpu(d: Path, tag, fa, bam, sub, device, **kw):
    """The same engine pass (host folds) on `device` and on the CPU:
    returns, for each, the GLF bytes, the realigned BAM records and the
    Spy's counts, and logs both passes."""
    out = []
    for dev in (device, "cpu"):
        glf = d / f"{tag}_{dev.replace(':', '_')}.glf.txt"
        with Spy() as spy:
            wall, st = engine_pass(fa, bam, [sub], glf, dev, folds=False,
                                   **kw)
        log(f"[{tag}] {dev}: {st['windows_ok']} windows ok in {wall:.3f} s; "
            f"slabs: decode {spy.counts['run_slab_decode']}, device call "
            f"{spy.counts['run_slab_stats']}")
        out.append((glf.read_bytes(),
                    ra_records(glf.parent / glf.name[:-len(".glf.txt")]),
                    spy.counts))
    return out


def parity_phase(d: Path, fa, bam, wins, device, n_windows):
    """The first n_windows windows on `device` and on the CPU (plain
    versions), host folds: GLF bytes must be identical."""
    sub, n = window_subset(wins, n_windows, d / "parity_win.txt")
    (g_card, _, _), (g_cpu, _, _) = card_vs_cpu(d, "parity", fa, bam, sub,
                                                device)
    log(f"[parity] {n} windows, GLF {len(g_card)} bytes, byte-identical "
        f"{g_card == g_cpu}")
    if g_card != g_cpu:
        raise SystemExit("parity phase failed: card and CPU GLF differ")


BATCHED_PALLAS = ("--engine", "batched", "--hmmBackend", "pallas")


def indels_cli(fa, bam, win_file, out, device, *extra,
               engine=BATCHED_PALLAS):
    """One `indels` CLI run (by default `--engine batched --hmmBackend
    pallas`); returns its seconds."""
    t0 = time.perf_counter()
    run_cli("--analysis", "indels", *engine, "--device", device,
            "--bamFile", bam, "--ref", fa, "--varFile", win_file,
            "--outputFile", out, *extra)
    sync(device)
    return time.perf_counter() - t0


def guard_rescues(fail=True):
    """From here on, an engine of this process that closes with a
    rescued slab fails the run: a rescue would hide a broken device
    path.  Returns the list of closed engines' rescue counts; with
    `fail` False the counts are only collected."""
    from dindel_tpu_torch.engine import window

    closed = []
    close = window.WindowEngine.close

    def checked(eng):
        close(eng)
        n = eng.stats.counts.get("slab.rescues", 0)
        closed.append(n)
        if n and fail:
            raise SystemExit(f"an engine rescued {n} slabs: its device "
                             "path failed")
    window.WindowEngine.close = checked
    return closed


def decode_phase(d: Path, fa, bam, wins, device):
    """Phase 7: the full-decode route (--outputRealignedBAM)."""

    d.mkdir()
    sub, n = window_subset(wins, PATH_WINDOWS, d / "win.txt")
    reset_launches()
    with Spy() as spy:
        wall = indels_cli(fa, bam, sub, d / "out", device, "--doDiploid",
                          "--outputRealignedBAM")
    launches = read_launches()
    n_bams = len(list(d.glob("out.ra.*.bam")))
    n_ok, no_nan = glf_rows_ok([d / "out.glf.txt"])
    routes = spy.counts
    log(f"[decode] CLI --outputRealignedBAM, {n} windows: "
        f"windows_ok {spy.windows_ok()} in {wall:.3f} s = "
        f"{spy.windows_ok() / wall:.6g} windows/s; stage seconds "
        f"{spy.stage_seconds()}; decode slabs {routes['run_slab_decode']}, "
        f"device-call slabs {routes['run_slab_stats']}; realigned BAMs "
        f"{n_bams}; kernel launches {launches}; ok GLF rows {n_ok}; no NaN "
        f"{no_nan}")
    check_launches("decode", launches)
    if (routes["run_slab_decode"] <= 0
            or routes["run_slab_stats"] != 0 or n_bams <= 0 or n_ok <= 0
            or not no_nan):
        raise SystemExit("decode phase failed: launches/routes/BAMs/rows")
    sub, n = window_subset(wins, PARITY_WINDOWS, d / "parity_win.txt")
    (g_card, ra_card, _), (g_cpu, ra_cpu, _) = card_vs_cpu(
        d, "decode-parity", fa, bam, sub, device, output_realigned_bam=True)
    n_rec = sum(len(recs) for _, recs in ra_card)
    log(f"[decode-parity] {n} windows: GLF {len(g_card)} "
        f"bytes identical {g_card == g_cpu}; {len(ra_card)} BAMs, {n_rec} "
        f"records identical {ra_card == ra_cpu}")
    if g_card != g_cpu or ra_card != ra_cpu or not n_rec:
        raise SystemExit("decode phase failed: card and CPU differ")
    return launches


def sentinel_phase(d: Path, fa, bam, wins, device):
    """Phase 8: slabs whose variant flanks reach the sentinel codes take
    the full-decode route, the others the device-call route, in one
    pass (one window per slab)."""
    d.mkdir()
    sub, n = window_subset(wins, PARITY_WINDOWS, d / "win.txt")
    res = card_vs_cpu(d, "sentinel", fa, bam, sub, device, max_pairs=1,
                      flank=SENTINEL_FLANK)
    (g_card, _, routes), (g_cpu, _, _) = res
    n_ok = sum(line.startswith(b"ok ") for line in g_card.splitlines())
    log(f"[sentinel] --flankRefSeq {SENTINEL_FLANK}, {n} windows, one per "
        f"slab: decode slabs {routes['run_slab_decode']}, device-call slabs "
        f"{routes['run_slab_stats']}; ok GLF rows {n_ok}; GLF {len(g_card)} "
        f"bytes identical {g_card == g_cpu}")
    if (routes["run_slab_decode"] <= 0 or routes["run_slab_stats"] <= 0
            or n_ok <= 0 or g_card != g_cpu):
        raise SystemExit("sentinel phase failed: routes/rows/parity")


_FLOAT = re.compile(r"^-?\d+\.?\d*(e[+-]?\d+)?$|^-?inf$|^-?nan$", re.I)


def glf_mismatches(a: bytes, b: bytes, rtol, atol):
    """Tokens of two GLFs that differ beyond the tolerance (as
    tests/test_device_em.py::_compare reads them: floats packed with
    ':,;/' may differ within rtol/atol, everything else must be equal)."""
    al, bl = a.decode().splitlines(), b.decode().splitlines()
    if len(al) != len(bl):
        return [("line count", len(al), len(bl))]
    bad = []
    for la, lb in zip(al, bl):
        ta, tb = la.split(" "), lb.split(" ")
        if len(ta) != len(tb):
            bad.append((la, lb))
            continue
        for xa, xb in zip(ta, tb):
            if xa == xb:
                continue
            pa, pb = re.split(r"[:,;/]", xa), re.split(r"[:,;/]", xb)
            if len(pa) != len(pb):
                bad.append((xa, xb))
                continue
            for fa_, fb_ in zip(pa, pb):
                if fa_ != fb_ and not (
                        _FLOAT.match(fa_) and _FLOAT.match(fb_)
                        and math.isclose(float(fa_), float(fb_),
                                         rel_tol=rtol, abs_tol=atol)):
                    bad.append((xa, xb))
    return bad


def pooled_phase(d: Path, fa, bam, wins, device):
    """Phase 9: the pooled caller with the device VB-EM."""
    import torch

    d.mkdir()
    sub, n = window_subset(wins, PATH_WINDOWS, d / "win.txt")
    reset_launches()
    with Spy() as spy:
        wall = indels_cli(fa, bam, sub, d / "out", device, "--doPooled")
    launches = read_launches()
    (d / "glfs.txt").write_text(str(d / "out.glf.txt") + "\n")
    run_cli("--analysis", "mergeOutputPooled", "--inputFiles",
            d / "glfs.txt", "--ref", fa, "--outputFile", d / "pooled.vcf",
            "--numSamples", 1, "--numBAMFiles", 1)
    recs = vcf_records(d / "pooled.vcf")
    n_pass = sum(r[6] == "PASS" for r in recs)
    n_em = spy.counts["run_batched_em"]
    log(f"[pooled] CLI --doPooled, {n} windows (cold): "
        f"windows_ok {spy.windows_ok()} in {wall:.3f} s; kernel launches "
        f"{launches}; device EM dispatches {n_em}; VCF records {len(recs)} "
        f"({n_pass} PASS)")
    check_launches("pooled", launches)
    if n_em <= 0 or not recs:
        raise SystemExit("pooled phase failed: launches/EM/VCF")

    pooled = dict(do_diploid=False, estimate_hap_freqs=True)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    wall, st = engine_pass(fa, bam, [sub], d / "warm.glf.txt", device,
                           **pooled)
    peak = torch.cuda.max_memory_allocated() if on_card else None
    stages = {k: round(v, 3) for k, v in st["stage_seconds"].items()}
    log(f"[pooled] warm pass: windows_ok {st['windows_ok']} windows_error "
        f"{st['windows_error']} in {wall:.3f} s = "
        f"{st['windows_ok'] / wall:.6g} windows/s; stage seconds {stages}; "
        f"max_memory_allocated {peak} bytes")
    if st["windows_ok"] <= 0 or stages.get("device_em", 0) <= 0:
        raise SystemExit("pooled phase failed: warm pass")

    psub, pn = window_subset(wins, PARITY_WINDOWS, d / "parity_win.txt")
    (g_card, _, _), (g_cpu, _, _) = card_vs_cpu(
        d, "pooled-parity", fa, bam, psub, device, em=False, **pooled)
    log(f"[pooled-parity] {pn} windows, host EM: GLF "
        f"{len(g_card)} bytes identical {g_card == g_cpu}")
    if g_card != g_cpu or b"singlevariant" not in g_card:
        raise SystemExit("pooled phase failed: card and CPU differ")

    wall, st = engine_pass(fa, bam, [sub], d / "host_em.glf.txt", device,
                           em=False, **pooled)
    bad = glf_mismatches((d / "host_em.glf.txt").read_bytes(),
                         (d / "warm.glf.txt").read_bytes(), EM_RTOL, EM_ATOL)
    log(f"[pooled-em] {n} windows on {device}: device EM vs host "
        f"EM (host pass {wall:.3f} s), rtol {EM_RTOL} atol {EM_ATOL}: "
        f"{len(bad)} tokens beyond tolerance {bad[:3]}")
    if bad:
        raise SystemExit("pooled phase failed: device EM vs host EM")
    return launches


def streaming_kernel(windows, device):
    """K1 at the shape of the median scored window (by pairs) of a
    streaming run, float64 exact and float32 fast: checked against its
    plain version, timed (CUDA events, 50 chained launches) beside the
    plain version and its bound.  Returns {fold: row}."""
    import numpy as np
    import torch
    from dindel_tpu_torch.hmm.dp_kernel import pair_hmm_dp
    from dindel_tpu_torch.hmm.dp_ref import dp_bounds, dp_ref
    from dindel_tpu_torch.hmm.pack import pack_pairs

    def pairs(w):
        return len(w[1]) * len(w[2])
    params, haps, reads, hs = sorted(windows, key=pairs)[len(windows) // 2]
    out = {}
    for fold, dtype, exact in (("f64 exact", np.float64, True),
                               ("f32 fast", np.float32, False)):
        pk = pack_pairs(haps, reads, hs, params, dtype)

        def up(k, dt=None):
            t = torch.from_numpy(np.ascontiguousarray(pk[k]))
            return t.to(device=device, dtype=dt or t.dtype)
        args = [pk["H_pad"], pk["L_pad"], pk["numT"],
                up("hap_len", torch.int32), up("read_len", torch.int32),
                up("b_mid", torch.int32), up("read_codes", torch.uint8),
                up("hap_codes", torch.uint8), up("eq"), up("uq"), up("lpe"),
                up("lpn"), pk["scalars"]]
        bounds = dp_bounds(pk["read_len"], pk["b_mid"], pk["L_pad"])
        k = pair_hmm_dp(*args, exact_ties=exact, bounds=bounds)
        r = dp_ref(*args, exact_ties=exact, bounds=bounds)
        sync(device)
        bad = dp_mismatches(k, r, bounds)
        err = max((k[0] - r[0]).abs().max().item(),
                  (k[1] - r[1]).abs().max().item())
        if bad or err != 0.0:
            raise SystemExit(f"kernel disagrees with its plain version at "
                             f"the streaming window ({fold}): {bad}")
        ms = time_ms(lambda: pair_hmm_dp(*args, exact_ties=exact,
                                         bounds=bounds), 50, device)
        plain_ms = time_ms(lambda: dp_ref(*args, exact_ties=exact,
                                          bounds=bounds), 3, device)
        B = pk["hap_len"].shape[0]
        bound_ms, bound_by, steps = dp_bound(B, pk["H_pad"], pk["L_pad"],
                                             pk["numT"], bounds,
                                             np.dtype(dtype).itemsize)
        out[fold] = dict(B=B, H_pad=pk["H_pad"], L_pad=pk["L_pad"],
                         bounds=bounds, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         max_abs_err=err)
        log(f"[streaming-kernel] median window B={B} H_pad={pk['H_pad']} "
            f"L_pad={pk['L_pad']} (L_act, MB, MN)={bounds} {fold}: kernel "
            f"{ms!r} ms per launch, plain {plain_ms!r} ms, bound "
            f"{bound_ms!r} ms ({bound_by}, {steps} state-steps), share of "
            f"the bound {bound_ms / ms:.4f}; bit-equal to plain")
        out[fold]["finish"] = streaming_finish(pk, args, k, exact, dtype,
                                               device)
    return out


def streaming_finish(pk, args, dp, exact, dtype, device):
    """The finish kernel at the streaming window's shape (the dense
    program's call: the host's obs_mid, the pk's prior rows) against its
    plain version, timed beside it and its bound."""
    import numpy as np
    import torch
    from dindel_tpu_torch.hmm import epilogue_kernel as ek
    from dindel_tpu_torch.hmm.finish import finish as plain_finish
    from dindel_tpu_torch.hmm.pack import compute_obs_mid

    H_pad, L_pad, numT = pk["H_pad"], pk["L_pad"], pk["numT"]
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa
    fin = dict(b_mid=args[5], hap_len=args[3], read_len=args[4],
               obs_mid=up(compute_obs_mid(pk)), prior_rmq=up(pk["prior_rmq"]),
               prior_hmq=up(pk["prior_hmq"]))
    _, bad = finish_check(H_pad, L_pad, numT, dp, fin, exact)
    if bad:
        raise SystemExit(f"finish kernel disagrees with its plain version "
                         f"at the streaming window: {bad}")
    fargs = (H_pad, L_pad, numT, fin["b_mid"], fin["hap_len"], dp[0], dp[1],
             fin["obs_mid"], fin["prior_rmq"], fin["prior_hmq"], dp[2],
             dp[3])
    t = kernel_times(lambda: ek.finish(*fargs, exact_ties=exact,
                                       read_len=fin["read_len"]), 50, device,
                     "finish_kernel")
    plain_ms = time_ms(lambda: plain_finish(*fargs, exact_ties=exact), 3,
                       device)
    B, S = dp[0].shape
    size = np.dtype(dtype).itemsize
    steps = walked_steps(pk["b_mid"], pk["read_len"], L_pad)
    b_ms, b_by = finish_bound(B, S, L_pad, steps, size)
    log(f"[streaming-kernel] finish at the median window B={B} S={S} "
        f"{'exact' if exact else 'fast'}: bit-equal to plain; kernel "
        f"{fmt_times(t)}, plain {plain_ms!r} ms, bound {b_ms!r} ms "
        f"({b_by}), share of the bound {share(b_ms, t)}; launch "
        f"{launch_desc(device, 'finish', B, L_pad, size)}")
    return dict(B=B, S=S, L_pad=L_pad, **t, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by)


def streaming_phase(d: Path, fa, bam, wins, device):
    """Phase 10: the CLI's default engine (streaming)."""

    d.mkdir()
    sub, n = window_subset(wins, PATH_WINDOWS, d / "win.txt")
    reset_launches()
    with Spy() as spy:
        wall = indels_cli(fa, bam, sub, d / "stream", device, "--doDiploid",
                          "--hmmBackend", "jax", engine=())
    launches = read_launches()
    scored = spy.counts["windows_scored"]
    n_ok, no_nan = glf_rows_ok([d / "stream.glf.txt"])
    split = {k: round(v, 3) for k, v in spy.split.items()}
    log(f"[streaming] CLI default engine, --hmmBackend jax (float64, exact "
        f"ties), {n} windows: windows_ok {spy.windows_ok()} in {wall:.3f} "
        f"s = {spy.windows_ok() / wall:.6g} windows/s; stage seconds "
        f"{spy.stage_seconds()}; window_hmm split {split}; windows scored "
        f"{scored}; kernel launches {launches}; ok GLF rows {n_ok}; no NaN "
        f"{no_nan}")
    check_launches("streaming_f64", launches)
    if (scored <= 0 or launches["pair_hmm_dp"] < scored
            or launches["finish"] < scored or n_ok <= 0 or not no_nan):
        raise SystemExit("streaming phase failed: launches/rows")
    wall_b, st = engine_pass(fa, bam, [sub], d / "batched64.glf.txt", device,
                             folds=False, f64=True)
    same = ((d / "batched64.glf.txt").read_bytes()
            == (d / "stream.glf.txt").read_bytes())
    log(f"[streaming] the batched engine on {device}, float64 exact ties, "
        f"host folds: {st['windows_ok']} windows ok in {wall_b:.3f} s; GLF "
        f"byte-identical to the streaming engine's {same}")
    if not same:
        raise SystemExit("streaming phase failed: streaming and batched "
                         "float64 GLF differ")
    kernel = streaming_kernel(spy.windows, device)

    psub, pn = window_subset(wins, PARITY_WINDOWS, d / "parity_win.txt")
    glfs = []
    for dev in (device, "cpu"):
        reset_launches()
        with Spy() as spy:
            wall = indels_cli(fa, bam, psub, d / f"pallas_{dev}", dev,
                              "--doDiploid", "--hmmBackend", "pallas",
                              engine=())
        if dev == device:
            f32_launches = read_launches()
            f32_scored = spy.counts["windows_scored"]
        glfs.append((d / f"pallas_{dev}.glf.txt").read_bytes())
        log(f"[streaming-pallas] {dev}: {spy.windows_ok()} windows ok in "
            f"{wall:.3f} s; windows scored {spy.counts['windows_scored']}")
    log(f"[streaming-pallas] {pn} windows, --hmmBackend pallas (float32, "
        f"fast ties): kernel launches {f32_launches}; GLF {len(glfs[0])} "
        f"bytes identical card vs CPU {glfs[0] == glfs[1]}")
    check_launches("streaming_f32", f32_launches)
    if (glfs[0] != glfs[1] or f32_launches["pair_hmm_dp"] < f32_scored
            or f32_scored <= 0):
        raise SystemExit("streaming phase failed: pallas card vs CPU")
    faster_windows(d, fa, bam, psub, device)
    return launches, f32_launches, kernel


def faster_windows(d: Path, fa, bam, win_file, device):
    """--faster (the sparse HMM, host only) over the lines of `win_file`,
    split over FASTER_PROCS CLI processes run at once."""
    lines = [x for x in open(win_file).read().splitlines() if x.strip()]
    per = -(-len(lines) // FASTER_PROCS)
    procs, outs = [], []
    t0 = time.perf_counter()
    try:
        for i in range(0, len(lines), per):
            wf = d / f"faster_win{i // per}.txt"
            wf.write_text("\n".join(lines[i:i + per]) + "\n")
            out = d / f"faster{i // per}"
            outs.append(Path(str(out) + ".glf.txt"))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "dindel_tpu_torch", "--analysis",
                 "indels", "--doDiploid", "--faster", "--device", device,
                 "--bamFile", str(bam),
                 "--ref", str(fa), "--varFile", str(wf), "--outputFile",
                 str(out)], cwd=REPO, stdout=subprocess.DEVNULL,
                stderr=subprocess.PIPE, text=True))
        errs = [p.communicate(timeout=900)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    rcs = [p.returncode for p in procs]
    n_ok, no_nan = glf_rows_ok(outs)
    log(f"[faster] CLI --faster, {len(lines)} windows in {len(procs)} "
        f"processes at once: {wall:.3f} s wall; exit codes {rcs}; ok GLF "
        f"rows {n_ok}; no NaN {no_nan}")
    if any(rcs) or n_ok <= 0 or not no_nan:
        raise SystemExit("faster run failed: " + " | ".join(
            e[-2000:] for e in errs if e))


def dense_phase(d: Path, fa, bam, wins, lib_file, device):
    """Phase 11: the batched engine's dense insert-prior route."""

    d.mkdir()
    sub, n = window_subset(wins, PATH_WINDOWS, d / "win.txt")
    extra = ("--doDiploid", "--insertPrior", "--libFile", str(lib_file))
    reset_launches()
    with Spy() as spy:
        wall = indels_cli(fa, bam, sub, d / "out", device, *extra)
    launches = read_launches()
    routes = spy.counts
    n_ok, no_nan = glf_rows_ok([d / "out.glf.txt"])
    log(f"[dense] CLI --insertPrior --libFile, {n} windows: windows_ok "
        f"{spy.windows_ok()} in {wall:.3f} s = {spy.windows_ok() / wall:.6g}"
        f" windows/s; stage seconds {spy.stage_seconds()}; slabs: dense "
        f"{routes['run_packed']}, decode {routes['run_slab_decode']}, "
        f"device call {routes['run_slab_stats']}; kernel launches "
        f"{launches}; ok GLF rows {n_ok}; no NaN {no_nan}")
    check_launches("dense", launches)
    if (routes["run_packed"] <= 0 or routes["run_slab_decode"]
            or routes["run_slab_stats"] or n_ok <= 0
            or not no_nan):
        raise SystemExit("dense phase failed: routes/launches/rows")
    psub, pn = window_subset(wins, PARITY_WINDOWS, d / "parity_win.txt")
    glfs = []
    for dev in (device, "cpu"):
        wall = indels_cli(fa, bam, psub, d / f"parity_{dev}", dev, *extra)
        glfs.append((d / f"parity_{dev}.glf.txt").read_bytes())
        log(f"[dense-parity] {dev}: {pn} windows in {wall:.3f} s")
    log(f"[dense-parity] GLF {len(glfs[0])} bytes identical card vs CPU "
        f"{glfs[0] == glfs[1]}")
    if glfs[0] != glfs[1]:
        raise SystemExit("dense phase failed: card and CPU GLF differ")
    return launches


def shards_phase(d: Path, fa, bam, wins, device):
    """Phase 12: the window-file shard driver, two workers on one card,
    against one process over the unsplit windows."""
    from dindel_tpu_torch.config import Parameters
    from dindel_tpu_torch.pipeline.run_parallel import run_and_merge_diploid

    d.mkdir()
    sub, n = window_subset(wins, PATH_WINDOWS, d / "all.txt")
    lines = open(sub).read().splitlines()
    half = (len(lines) + 1) // 2
    shards = [d / "shard0.txt", d / "shard1.txt"]
    for f, part in zip(shards, (lines[:half], lines[half:])):
        f.write_text("\n".join(part) + "\n")
    runs = {}
    for tag, files, workers in (("two", shards, 2), ("one", [sub], 1)):
        t0 = time.perf_counter()
        _, stats = run_and_merge_diploid(
            [str(f) for f in files], [bam], fa, Parameters(),
            str(d / tag), str(d / f"{tag}.vcf"), num_workers=workers,
            backend="pallas", device=device)
        wall = time.perf_counter() - t0
        rescues = sum(st["counts"].get("slab.rescues", 0)
                      for st in stats)
        runs[tag] = (d / f"{tag}.vcf").read_text()
        log(f"[shards] {tag}: {len(files)} window files, {workers} "
            f"worker(s): windows_ok {sum(st['windows_ok'] for st in stats)}"
            f" in {wall:.3f} s; slab rescues {rescues}")
        if rescues:
            raise SystemExit("shards phase failed: a worker rescued slabs")
    recs = [x for x in runs["two"].splitlines() if not x.startswith("#")]
    log(f"[shards] merged VCF: {len(recs)} records, identical to the "
        f"single-process run's {runs['two'] == runs['one']}")
    if runs["two"] != runs["one"] or not recs:
        raise SystemExit("shards phase failed: merged VCFs differ")


def mesh_phase(d: Path, fa, bam, wins, device):
    """Phase 13 (C10): the batched engine on a 2x2 mesh."""
    import torch
    from dindel_tpu_torch.parallel.mesh import dryrun_multichip, make_mesh

    d.mkdir()
    sub, n = window_subset(wins, PATH_WINDOWS, d / "win.txt")
    first = torch.device(device)
    if first.type == "cuda" and torch.cuda.device_count() >= 4:
        devices = [torch.device("cuda", i) for i in range(4)]
    else:
        devices = [first] * 4
    mesh = make_mesh(2, 2, devices)
    wall1, st1 = engine_pass(fa, bam, [sub], d / "single.glf.txt", device)
    log(f"[mesh] single device: {st1['windows_ok']} windows ok in "
        f"{wall1:.3f} s = {st1['windows_ok'] / wall1:.6g} windows/s; "
        f"slab_dispatch {st1['stage_seconds'].get('slab_dispatch', 0):.3f} s")
    reset_launches()
    with Spy() as spy:
        wall, st = engine_pass(fa, bam, [sub], d / "mesh.glf.txt", device,
                               mesh=mesh)
    launches = read_launches()
    sharded = (spy.counts["run_slab_stats"]
               + spy.counts["run_slab_decode_sharded"])
    same = ((d / "mesh.glf.txt").read_bytes()
            == (d / "single.glf.txt").read_bytes())
    dispatch = st["stage_seconds"].get("slab_dispatch", 0.0)
    stages = {k: round(v, 3) for k, v in st["stage_seconds"].items()}
    log(f"[mesh] 2x2 mesh over {[str(x) for x in mesh.flat]}, {n} windows: "
        f"windows_ok {st['windows_ok']} in {wall:.3f} s = "
        f"{st['windows_ok'] / wall:.6g} windows/s; stage seconds {stages}; "
        f"sharded slabs {sharded}, kernel launches {launches} (K1 4 per "
        f"sharded slab: {launches['pair_hmm_dp'] == 4 * sharded}); "
        f"slab_dispatch "
        f"{dispatch:.3f} s = {dispatch / max(1, 4 * sharded) * 1e3:.6g} ms "
        f"per shard program; GLF byte-identical to the single device {same}")
    check_launches("mesh", launches)
    if (not same or sharded <= 0
            or launches["pair_hmm_dp"] != 4 * sharded):
        raise SystemExit("mesh phase failed: GLF/launches")
    glfs = []
    for tag, extra in (("cli_plain", ()), ("cli_mesh", ("--mesh", "1x1"))):
        cli_wall = indels_cli(fa, bam, sub, d / tag, device, "--doDiploid",
                              *extra)
        glfs.append((d / f"{tag}.glf.txt").read_bytes())
        log(f"[mesh] CLI {' '.join(extra) or 'without --mesh'}: {n} windows "
            f"in {cli_wall:.3f} s")
    log(f"[mesh] CLI --mesh 1x1 GLF byte-identical to the CLI without "
        f"--mesh {glfs[0] == glfs[1]}")
    if glfs[0] != glfs[1]:
        raise SystemExit("mesh phase failed: CLI --mesh 1x1 differs")
    t0 = time.perf_counter()
    dryrun_multichip(8, [first] * 8)
    log(f"[mesh] dryrun_multichip(8) over {first} x 8 (sharded slab vs "
        f"single in float32 exact and fast, dp x rp window step): passed "
        f"in {time.perf_counter() - t0:.3f} s")
    return launches


def hostshard_phase(d: Path, fa, bam, wins, device):
    """Phase 14 (C11): staging processes feeding this process's card."""
    import numpy as np
    from dindel_tpu_torch.config import Parameters
    from dindel_tpu_torch.parallel.hostshard import run_hostshard

    d.mkdir()
    sub, n = window_subset(wins, PATH_WINDOWS, d / "all.txt")
    lines = open(sub).read().splitlines()
    per = -(-len(lines) // 4)
    files = [d / f"part{i}.txt" for i in range(4)]
    for i, f in enumerate(files):
        f.write_text("\n".join(lines[i * per:(i + 1) * per]) + "\n")
    wall_seq, st = engine_pass(fa, bam, files, d / "seq.glf.txt", device)
    seq = (d / "seq.glf.txt").read_bytes()
    log(f"[hostshard] one process, the four files in sequence: "
        f"{st['windows_ok']} windows ok in {wall_seq:.3f} s = "
        f"{st['windows_ok'] / wall_seq:.6g} windows/s")
    cli_wall = indels_cli(fa, bam, ",".join(str(f) for f in files),
                          d / "cli", device, "--doDiploid", "--stageProcs", 2)
    cli_same = (d / "cli.glf.txt").read_bytes() == seq
    # the CLI's staging processes, read from the stats files they leave
    # beside the GLF
    cli_procs = [json.loads((d / f"cli.glf.txt.err{s}.stats").read_text())
                 for s in range(2)]
    cli_flags = [(p["cuda_initialized"],
                  p["counts"].get("slab.rescues", 0))
                 for p in cli_procs]
    log(f"[hostshard] CLI --stageProcs 2 (cold: spawn, imports, staging): "
        f"{n} windows in {cli_wall:.3f} s = {n / cli_wall:.6g} windows/s; "
        f"GLF byte-identical to one process {cli_same}; staging processes' "
        f"(cuda_initialized, slab_rescues) {cli_flags}")
    params = Parameters()
    params.do_diploid = True
    params.file_name = str(d / "hs")
    stats = {}
    reset_launches()
    t0 = time.perf_counter()
    run_hostshard([bam], fa, params, [str(f) for f in files],
                  str(d / "hs.glf.txt"), n_procs=4, repeats=2,
                  stats_out=stats,
                  engine_kw=dict(dtype=np.float32, exact_ties=False),
                  device=device)
    wall = time.perf_counter() - t0
    launches = read_launches()
    same = (d / "hs.glf.txt").read_bytes() == seq
    procs = stats["per_proc"]
    first = [m["repeats"][0] for m in procs]
    cold_span = max(m["t1"] for m in first) - min(m["t0"] for m in first)
    span = stats.get("warm_span_s")
    warm_rate = stats["warm_windows"] / span if span else float("nan")
    srv = stats["server"]
    log(f"[hostshard] run_hostshard, 4 staging processes x 2 repeats: wall "
        f"{wall:.3f} s (spawn and imports included); first repeat "
        f"{sum(m['windows'] for m in first)} windows in {cold_span:.3f} s; "
        f"warm {stats.get('warm_windows')} windows in {span!r} s = "
        f"{warm_rate:.6g} windows/s; kernel launches {launches}; server: "
        f"{srv['dispatches']} slab programs, enqueue {srv['dispatch_s']:.3f} "
        f"s, fetch {srv['fetch_s']:.3f} s; GLF byte-identical to one "
        f"process {same}")
    for i, pst in enumerate(procs):
        stages = {k: round(v, 3) for k, v in pst["stage_seconds"].items()}
        log(f"[hostshard] staging process {i}: windows_ok "
            f"{pst['windows_ok']}, cuda_initialized "
            f"{pst['cuda_initialized']}, stage seconds {stages}")
    check_launches("hostshard", launches)
    if (not same or not cli_same or stats["slab_rescues"]
            or any(pst["cuda_initialized"] or pst["counts"].get(
                "slab.rescues", 0) for pst in procs + cli_procs)):
        raise SystemExit("hostshard phase failed: GLF/launches/CUDA in a "
                         "staging process/rescues")
    return launches


def golden_phase(d: Path, device):
    from dindel_tpu_torch.sim import PlantedVariant, SimConfig, simulate

    fa, bam = simulate(str(d / "sim"),
                       [PlantedVariant(pos=700, var="-ACG", genotype=1)],
                       SimConfig(ref_len=2100, coverage=25, read_len=75),
                       seed=11)
    _, _, vcf, _ = cli_pipeline(d, fa, bam, device)
    dels = [r for r in vcf_records(vcf) if len(r[3]) > len(r[4])]
    got = ((int(dels[0][1]), dels[0][3], dels[0][4],
            dels[0][9].split(":")[0]) if dels else None)
    log(f"[golden] first deletion call {got}")
    if got != (3128, "AGGG", "A", "0/1"):
        raise SystemExit(f"golden call failed: {got}")


# ---------------------------------------------------------------------------


def build_phase():
    """Both kernel libraries built at once (each compiles its translation
    units in parallel); prints the build time and ptxas's registers,
    shared memory and spills per kernel.  Returns (K1's library,
    {epilogue kernel: ptxas's lines})."""
    from concurrent.futures import ThreadPoolExecutor
    from dindel_tpu_torch.hmm import dp_kernel, epilogue_kernel

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        so, epi = [f.result() for f in [pool.submit(dp_kernel.build),
                                        pool.submit(epilogue_kernel.build)]]
    log(f"[build] {so.name} and {epi.name} in "
        f"{time.perf_counter() - t0:.3f} s")
    kern = None
    for line in so.with_suffix(".log").read_text().splitlines():
        m = re.search(r"warpI([fd])Lb([01])ELi(\d+)ELi(\d+)E", line)
        if m:
            kern = (f"{'f32' if m.group(1) == 'f' else 'f64'} "
                    f"{'exact' if m.group(2) == '1' else 'fast'} "
                    f"R={m.group(3)} numT<={m.group(4)}")
        elif "registers" in line or "spill" in line:
            log(f"[build] {kern}: {line.split(':', 1)[-1].strip()}")
    ptxas = {}
    for line in epi.with_suffix(".log").read_text().splitlines():
        m = re.search(r"(finish|pair_stats|window_call|noop)_kernel(I([fd])"
                      r"(Lb([01]))?)?", line)
        if m and "Compiling entry function" in line:
            kern = " ".join(x for x in (
                m.group(1), {"f": "f32", "d": "f64"}.get(m.group(3)),
                {"0": "fast", "1": "exact"}.get(m.group(5))) if x)
        elif kern and ("registers" in line or "spill" in line
                       or "smem" in line):
            text = line.split(":", 1)[-1].strip()
            ptxas.setdefault(kern, []).append(text)
            log(f"[build] {kern}: {text}")
    log("[build] finish and window_call take their shared memory "
        "dynamically (sized per launch; the launch logs give it)")
    return so, ptxas


def epilogue_glf_phase(d: Path, fa, bam, wins, device):
    """The shipped configuration (device folds) over PATH_WINDOWS windows
    on the card twice: through the epilogue kernels, and with the slab
    programs' finish, pair_stats and window_call swapped for their plain
    versions on the card: GLF bytes identical."""
    from dindel_tpu_torch.hmm import slab
    from dindel_tpu_torch.hmm.finish import finish
    from dindel_tpu_torch.hmm.stats import pair_stats
    from dindel_tpu_torch.infer.device_call import window_call

    d.mkdir()
    sub, n = window_subset(wins, PATH_WINDOWS, d / "win.txt")
    glfs = []
    for tag in ("kernels", "plain"):
        saved = {k: getattr(slab, k)
                 for k in ("finish", "pair_stats", "window_call")}
        if tag == "plain":
            # the plain finish takes no read_len: it decodes every row
            slab.finish, slab.pair_stats, slab.window_call = (
                lambda *a, read_len=None, **k: finish(*a, **k),
                pair_stats, window_call)
        try:
            reset_launches()
            with Spy() as spy:
                wall, st = engine_pass(fa, bam, [sub], d / f"{tag}.glf.txt",
                                       device)
            launches = read_launches()
        finally:
            for k, v in saved.items():
                setattr(slab, k, v)
        glfs.append((d / f"{tag}.glf.txt").read_bytes())
        n_dev = spy.counts["run_slab_stats"]
        log(f"[epilogue-glf] {tag} on {device}: {st['windows_ok']} windows "
            f"ok in {wall:.3f} s; device-call slabs {n_dev}, decode slabs "
            f"{spy.counts['run_slab_decode']}; launches {launches}")
        if tag == "kernels":
            if (n_dev <= 0 or launches["finish"] <= 0
                    or launches["pair_stats"] != n_dev
                    or launches["window_call"] != n_dev):
                raise SystemExit("epilogue-glf: the kernels did not run on "
                                 "every device-call slab")
        elif any(launches[k] for k in KERNELS[1:]):
            raise SystemExit("epilogue-glf: the plain pass launched kernels")
    log(f"[epilogue-glf] {n} windows, device folds: GLF {len(glfs[0])} "
        f"bytes identical kernels vs plain on the card {glfs[0] == glfs[1]}")
    if glfs[0] != glfs[1]:
        raise SystemExit("epilogue-glf: kernels and plain versions differ")


def main() -> int:
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev = "cuda"
    log(f"[device] {card_line()}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    so, ptxas = build_phase()
    # the main path's kernels: float32, S_half 178 -> R = 6, numT 7
    loops = {}
    for fold, tag in (("fast", "IfLb0ELi6ELi7E"), ("exact", "IfLb1ELi6ELi7E")):
        loops[fold] = sass_step_loops(so, "pair_hmm_dp_warp" + tag)
        log(f"[sass] {fold} fold, R=6, numT<=7: step loops (forward, "
            f"backward): " + ("not measured (no cuobjdump)"
                              if loops[fold] is None else "; ".join(
                                  f"{n} instructions, {a} ALU-class, "
                                  f"{dict(list(ops.items())[:12])}"
                                  for n, a, ops in loops[fold])))
    clock = sm_clock_hz()
    log(f"[sass] max SM clock {clock / 1e6:.0f} MHz")

    edge_phase(dev)
    epilogue_edge_phase(dev)
    special = epilogue_special_phase(dev)
    if special:
        raise SystemExit(f"epilogue kernels disagree with their plain "
                         f"versions on special values: {special}")
    bench = compare_and_time("bench 8x768", 1, 1, dev, reps=20,
                             plain_reps=3)
    slab = compare_and_time("engine slab 24576", ENGINE_SLAB_WINDOWS, 2,
                            dev, reps=10, plain_reps=2)
    for name, res in (("bench 8x768", bench), ("engine slab 24576", slab)):
        for fold, r in res.items():
            if loops[fold] is None:
                continue
            t_issue, t_alu = issue_bounds(loops[fold], r["B"], r["bounds"],
                                          clock)
            log(f"[bound] {name} {fold}: issue bound {t_issue!r} ms, "
                f"ALU-pipe bound {t_alu!r} ms (static step-loop counts); "
                f"kernel {r['ms']!r} ms = {t_issue / r['ms']:.4f} of the "
                f"issue bound, {t_alu / r['ms']:.4f} of the ALU bound")
    epi = {"C1": epilogue_phase("bench 8x768", 1, 1, dev, reps=20,
                                plain_reps=2),
           "C2": epilogue_phase("engine slab 24576", ENGINE_SLAB_WINDOWS, 2,
                                dev, reps=20, plain_reps=2)}
    floor = launch_floor(dev)
    torch.cuda.empty_cache()

    closed = guard_rescues()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        (tmp / "slice").mkdir()
        (tmp / "golden").mkdir()
        fa, bam, wins, launches, main_slab = slice_phase(
            tmp / "slice", dev, N_VARIANTS, COVERAGE, READ_LEN)
        parity_phase(tmp / "slice", fa, bam, wins, dev, PARITY_WINDOWS)
        epilogue_glf_phase(tmp / "epilogue_glf", fa, bam, wins, dev)
        golden_phase(tmp / "golden", dev)
        by_path = dict(device_call=launches)
        by_path["decode"] = decode_phase(tmp / "decode", fa, bam, wins, dev)
        sentinel_phase(tmp / "sentinel", fa, bam, wins, dev)
        by_path["pooled"] = pooled_phase(tmp / "pooled", fa, bam, wins, dev)
        (by_path["streaming_f64"], by_path["streaming_f32"],
         at_window) = streaming_phase(tmp / "streaming", fa, bam, wins, dev)
        by_path["dense"] = dense_phase(tmp / "dense", fa, bam, wins,
                                       tmp / "slice" / "cand.libraries.txt",
                                       dev)
        shards_phase(tmp / "shards", fa, bam, wins, dev)
        by_path["mesh"] = mesh_phase(tmp / "mesh", fa, bam, wins, dev)
        by_path["hostshard"] = hostshard_phase(tmp / "hostshard", fa, bam,
                                               wins, dev)
    log(f"[rescues] {len(closed)} engines closed in this process, slab "
        f"rescues {sum(closed)}")

    fast = slab["fast"]
    log(f"[kernel] bench-geometry fast fold: {bench['fast']['ms']!r} ms, "
        f"plain {bench['fast']['plain_ms']!r} ms")
    keys = ("ms", "plain_ms", "bound_ms", "bound_by")
    rows = [{
        "name": "pair_hmm_dp",
        "source": "dindel_tpu_torch/csrc/pair_hmm_dp.cu",
        "max_abs_err": max(v["max_abs_err"]
                           for r in (bench, slab, at_window)
                           for v in r.values()),
        **{k: fast[k] for k in keys},
        "at_streaming_window": {
            fold: {k: r[k] for k in ("B", "H_pad", "L_pad", *keys)}
            for fold, r in at_window.items()},
    }]
    epi_src = "dindel_tpu_torch/csrc/slab_epilogue.cu"
    fin = epi["C2"]["finish"]
    tkeys = keys + ("host_ms", "device_ms")
    rows.append({
        "name": "finish", "source": epi_src, "max_abs_err": 0.0,
        **{k: fin["fast"][k] for k in tkeys},
        "exact": {k: fin["exact"][k] for k in tkeys},
        "at_C1": {m: {k: epi["C1"]["finish"][m][k] for k in tkeys}
                  for m in ("fast", "exact")},
        "at_streaming_window": at_window["f64 exact"]["finish"],
        "at_main_path_slab": main_slab["finish"],
        "ptxas": {k: v for k, v in ptxas.items()
                  if k.startswith("finish")}})
    for name in ("pair_stats", "window_call"):
        r = epi["C2"][name]
        rows.append({
            "name": name, "source": epi_src,
            "max_abs_err": max([epi[c][name]["max_abs_err"] for c in epi]
                               + [main_slab[name]["max_abs_err"]]),
            **{k: r[k] for k in tkeys},
            "at_C1": {k: epi["C1"][name][k] for k in tkeys},
            "at_main_path_slab": main_slab[name],
            "ptxas": {k: v for k, v in ptxas.items() if k.startswith(name)}})
    rows[-2].update(at_V0={c: {k: epi[c]["pair_stats"]["at_V0"][k]
                               for k in tkeys} for c in epi})
    rows[-1].update(launch_floor={k: floor[k] for k in
                                  ("ms", "host_ms", "device_ms")})
    for row in rows:
        row.update(route="cuda", replaces=REPLACES[row["name"]],
                   launches=launches[row["name"]],
                   launches_by_path={p: n[row["name"]]
                                     for p, n in by_path.items()},
                   # no single PyTorch call computes any of these
                   library_ms=None)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
