#!/usr/bin/env python3
"""Benchmark of dindel_tpu_torch on one NVIDIA GPU: windows/s of every
engine path, K1 cells/s, and the single-core C++ baseline.

    python3 bench_torch.py [--modes dip,pooled,...] [--device cuda]

The counterpart of bench.py for the PyTorch port.  In order:

1. every mode of tools/bench_windows_torch.py (dip, pooled, decode,
   dense, streaming, hostshard), each in a subprocess, before this
   process touches the card (as bench.py:71-90); one dataset directory
   serves them all;
2. the kernel section at C1 (synth_windows(1, 8, 768, H=160, L=100,
   seed=1), bench.py:158) and C2 (4 such windows, seed 2: 24576 pairs),
   in the fast and the exact fold: `dp_kernel_cells_per_sec`, K1 alone,
   and `pairhmm_cells_per_sec`, K1 followed by hmm/finish.py `finish`
   (the step bench.py:176-181 times), each over 5 rounds of 20
   chained launches timed with CUDA events (the chain's host wall time
   beside it: that is where finish's host enqueue shows), with median
   and spread; cells = B*L*2*(H+2)*numT (bench.py:227); K1's bound
   (chip_smoke.dp_bound) and the share of it reached;
3. the C++ baseline: native/refshim/ref_hmm (ObservationModelFBMaxErr,
   one core) on bench.py:49-57's 40 pairs (H 160, L 100), the median of
   5 subprocess runs, cells as bench.py:65-66 counts them;
   `vs_baseline` is `pairhmm_cells_per_sec` at C1, fast fold (bench.py's
   headline value), over it.  When the binary cannot run, the baseline
   is null with the reason; no constant stands in;
4. the record: the last line of standard output is one JSON object with
   every metric by name and unit, the card's name, power limit and
   count, and the commit.

`--device cuda` (the default) needs a card and exits non-zero without
one; `--device cpu` only rehearses the control flow (a CPU record leaves
every device time and rate null; the host-side C++ baseline is still
measured).  Exits non-zero when a mode fails.  Imports nothing of JAX or
dindel_tpu."""

from __future__ import annotations

import argparse
import json
import random
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

import bench_windows_torch as bw  # noqa: E402
import chip_smoke  # noqa: E402

REF_HMM = REPO / "native" / "refshim" / "ref_hmm"
BASELINE_PAIRS, BASELINE_RUNS = 40, 5
NUM_T = 7                      # maxLengthDel 5 + 2 (bench.py:65)
CELLS = {"C1": (1, 1), "C2": (chip_smoke.ENGINE_SLAB_WINDOWS, 2)}
CHAIN, ROUNDS = 20, 5          # launches per timed round, rounds
MODE_TIMEOUT = 1800            # seconds per mode subprocess


def baseline_lines(n_pairs=BASELINE_PAIRS, H=chip_smoke.H, L=chip_smoke.L):
    """bench.py:49-57: random haps, each read an exact substring, quality
    0.999, mapQual 0.99999, pError 5e-4, pMut 1e-5, maxLengthDel 5."""
    rng = random.Random(0)
    lines = []
    for _ in range(n_pairs):
        hap = "".join(rng.choice("ACGT") for _ in range(H))
        start = rng.randrange(0, H - L) if H > L else 0
        read = hap[start:start + L]
        quals = ",".join("0.999" for _ in read)
        lines.append(f"{hap} {read} 0.99999 {start} 0 5e-4 1e-5 5 0.01 -1 "
                     f"0 0 {quals}")
    return lines


def measure_baseline():
    """(cells/s, seconds per run, None) of ref_hmm on the baseline lines,
    or (None, None, reason) when it cannot run."""
    inp = "\n".join(baseline_lines()) + "\n"
    runs = []
    try:
        for _ in range(BASELINE_RUNS):
            t0 = time.perf_counter()
            out = subprocess.run([str(REF_HMM)], input=inp,
                                 capture_output=True, text=True, timeout=600)
            runs.append(time.perf_counter() - t0)
            if (out.returncode != 0
                    or len(out.stdout.splitlines()) != BASELINE_PAIRS):
                return None, None, (f"ref_hmm exit {out.returncode}: "
                                    f"{out.stderr[-300:]}")
    except OSError as e:
        return None, None, f"ref_hmm cannot run: {e}"
    cells = BASELINE_PAIRS * chip_smoke.L * 2 * (chip_smoke.H + 2) * NUM_T
    return cells / statistics.median(runs), runs, None


def run_modes(modes, args, data: Path):
    """Each mode in its own subprocess; {mode: its record or an error}."""
    out = {}
    for mode in modes:
        cmd = [sys.executable, str(REPO / "tools" / "bench_windows_torch.py"),
               "--mode", mode, "--device", args.device, "--data", str(data),
               "--n-variants", str(args.n_variants), "--coverage",
               str(args.coverage)]
        if args.repeats:
            cmd += ["--repeats", str(args.repeats)]
        if mode == "hostshard" and bw.default_stage_procs() < 2:
            out[mode] = {"skipped": "one staging process: the host cannot "
                                    "run two beside the device server"}
            continue
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=MODE_TIMEOUT)
        lines = res.stdout.strip().splitlines()
        try:
            rec = json.loads(lines[-1]) if res.returncode == 0 else None
        except (IndexError, json.JSONDecodeError):
            rec = None
        if rec is None:
            rec = {"error": f"exit {res.returncode}: "
                            f"{(res.stderr or res.stdout)[-1500:]}"}
        print(f"[mode] {mode}: exit {res.returncode} in "
              f"{time.perf_counter() - t0:.3f} s: "
              f"{json.dumps(rec.get('windows_per_sec', rec.get('error')))}",
              flush=True)
        out[mode] = rec
    return out


def kernel_section(device, on_card, nr):
    """K1 alone and K1 + finish at C1 and C2 in both folds."""
    from dindel_tpu_torch.hmm.dp_kernel import pair_hmm_dp
    from dindel_tpu_torch.hmm.finish import finish

    dp_rate, chain_rate, bound = {}, {}, {}
    for cell, (n_windows, seed) in CELLS.items():
        pk, args, bounds, fin = chip_smoke.dp_inputs(n_windows, seed, device,
                                                     nr=nr)
        B, H_pad, L_pad = pk["hap_len"].shape[0], pk["H_pad"], pk["L_pad"]
        numT = pk["numT"]
        cells = (n_windows * chip_smoke.NH * nr * chip_smoke.L * 2
                 * (chip_smoke.H + 2) * numT)
        bound_ms, bound_by, _ = chip_smoke.dp_bound(B, H_pad, L_pad, numT,
                                                    bounds)
        for fold, exact in (("fast", False), ("exact", True)):
            def dp(exact=exact):
                return pair_hmm_dp(*args, exact_ties=exact, bounds=bounds)

            def step(exact=exact):
                a, b, btf, btb = dp()
                return finish(H_pad, L_pad, numT, fin["b_mid"],
                              fin["hap_len"], a, b, fin["obs_mid"],
                              fin["prior_rmq"], fin["prior_hmq"], btf, btb,
                              exact_ties=exact)

            if on_card:
                dp_ms = [chip_smoke.time_ms(dp, CHAIN, device)
                         for _ in range(ROUNDS)]
                chain = [chip_smoke.time_ms(step, CHAIN, device, host=True)
                         for _ in range(ROUNDS)]
            else:       # rehearse the calls, time nothing
                dp(), step()
                dp_ms, chain = [None], [(None, None)]
            ev_ms = [c[0] for c in chain]
            host_ms = [c[1] for c in chain]
            key = f"{cell}_{fold}"
            dp_rate[key] = dict(
                cells=cells, B=B, H_pad=H_pad, L_pad=L_pad, numT=numT,
                ms=bw.spread(dp_ms), ms_rounds=dp_ms,
                cells_per_sec=bw.spread([cells / m * 1e3 for m in dp_ms]
                                        if on_card else None))
            chain_rate[key] = dict(
                cells=cells, ms=bw.spread(ev_ms), ms_rounds=ev_ms,
                host_ms=bw.spread(host_ms), host_ms_rounds=host_ms,
                cells_per_sec=bw.spread([cells / m * 1e3 for m in ev_ms]
                                        if on_card else None),
                host_cells_per_sec=bw.spread(
                    [cells / m * 1e3 for m in host_ms] if on_card else None))
            med = dp_rate[key]["ms"]
            # the card's bound; a CPU rehearsal states none
            bound[key] = dict(bound_ms=bound_ms if on_card else None,
                              bound_by=bound_by,
                              share=bound_ms / med["median"] if med else None)
            chip_smoke.log(
                f"[kernel] {key}: B={B} cells={cells}; K1 "
                f"{dp_rate[key]['ms']} ms; K1+finish events "
                f"{chain_rate[key]['ms']} ms, host "
                f"{chain_rate[key]['host_ms']} ms; bound {bound_ms!r} ms "
                f"({bound_by}), share {bound[key]['share']}")
    return dp_rate, chain_rate, bound


def commit():
    try:
        return subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO,
                              capture_output=True, text=True, check=True,
                              timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--modes", default=",".join(bw.MODES),
                    help="comma-separated modes of bench_windows_torch")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-variants", type=int, default=chip_smoke.N_VARIANTS)
    ap.add_argument("--coverage", type=int, default=chip_smoke.COVERAGE)
    ap.add_argument("--repeats", type=int, default=None,
                    help="warm passes per mode (the tool's default: 5 for "
                         "dip, 3 otherwise)")
    ap.add_argument("--dp-reads", type=int, default=chip_smoke.NR,
                    help="reads per window of the kernel cells (768)")
    args = ap.parse_args(argv)
    modes = [m for m in args.modes.split(",") if m]
    bad = [m for m in modes if m not in bw.MODES]
    if bad:
        ap.error(f"unknown modes {bad}")
    on_card = bw.require_device(args.device, "bench_torch")

    with tempfile.TemporaryDirectory(prefix="bench_torch_") as tmp:
        mode_recs = run_modes(modes, args, Path(tmp) / "data")

    from dindel_tpu_torch.hmm import dp_kernel

    t0 = time.perf_counter()
    if on_card:
        dp_kernel.build()
    build_s = time.perf_counter() - t0
    dp_rate, chain_rate, bound = kernel_section(args.device, on_card,
                                                args.dp_reads)
    base, base_runs, base_err = measure_baseline()
    chip_smoke.log(f"[baseline] ref_hmm: {base} cells/s, runs {base_runs} s,"
                   f" {base_err or 'ok'}")
    head = chain_rate["C1_fast"]["cells_per_sec"]
    failed = [m for m, r in mode_recs.items() if "error" in r]
    record = {
        "metric": "bench_torch",
        "commit": commit(),
        "device": bw.device_record(on_card),
        "windows_per_sec": {m: r.get("windows_per_sec")
                            for m, r in mode_recs.items()},
        "dp_kernel_cells_per_sec": {k: v["cells_per_sec"]
                                    for k, v in dp_rate.items()},
        "pairhmm_cells_per_sec": {k: v["cells_per_sec"]
                                  for k, v in chain_rate.items()},
        "pairhmm_host_cells_per_sec": {k: v["host_cells_per_sec"]
                                       for k, v in chain_rate.items()},
        "k1_bound": bound,
        "baseline_cells_per_sec": base,
        "baseline_runs_s": base_runs,
        "baseline_error": base_err,
        "vs_baseline": (head["median"] / base if head and base else None),
        "peak_device_memory_bytes": {
            m: r.get("peak_device_memory_bytes")
            for m, r in mode_recs.items()},
        "kernel_build_s": build_s if on_card else None,
        "modes": mode_recs,
        "dp_kernel": dp_rate,
        "pairhmm": chain_rate,
        "failed_modes": failed,
        "units": {
            "windows_per_sec": "windows/s (median, min, max, iqr over the "
                               "warm passes)",
            "dp_kernel_cells_per_sec": "cells/s, cells = B*L*2*(H+2)*numT "
                                       "(median, min, max, iqr over rounds)",
            "pairhmm_cells_per_sec": "cells/s of K1 + finish, CUDA events",
            "pairhmm_host_cells_per_sec": "cells/s of K1 + finish, host "
                                          "clock to the chain's synchronize",
            "k1_bound": "ms; share = bound / median K1 ms",
            "baseline_cells_per_sec": "cells/s, one CPU core, median of "
                                      f"{BASELINE_RUNS} runs",
            "vs_baseline": "pairhmm_cells_per_sec C1_fast median / "
                           "baseline_cells_per_sec",
            "peak_device_memory_bytes": "bytes, warm passes",
            "kernel_build_s": "s",
        },
    }
    print(json.dumps(record), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
