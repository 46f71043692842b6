#!/usr/bin/env python3
"""End-to-end windows/s of dindel_tpu_torch, one engine path per run.

    python3 tools/bench_windows_torch.py --mode dip [--repeats N]

The counterpart of tools/bench_windows.py for the PyTorch port: the same
dataset (n_variants planted indels every 900 bp, 360 by default, at
`coverage` 30, 100 bp reads, simulator seed 3, variant seed 7) through
the port's getCIGARindels and makeWindows, then one cold pass and N warm
passes of the mode's engine in this process.  Every pass is kept: the
record gives the median warm windows/s with its min, max and
interquartile range, every pass's wall time, the median pass's stage
seconds, the cold wall, windows_ok / windows_error, the K1 launches
(`pair_hmm_dp.launches`) and the peak device memory of the warm passes.

Modes (the cells of PERF.md §4):

  dip        C3  the batched diploid engine, shipped configuration
                 (float32, fast ties, device folds), all windows
  pooled     C6  the pooled caller (estimate_hap_freqs), first 120
  decode     C4  --outputRealignedBAM (every slab full-decode), first 120
  dense      C8  --insertPrior --libFile <cand.libraries.txt>, first 120
  streaming  C7  the CLI's default engine (WindowEngine, float64, exact
                 ties), first 120
  hostshard  C11 run_hostshard: --stage-procs staging processes (default
                 as bench.py caps them: min(4, CPUs - 1)) over about 3
                 window files each, 1 + N repeats in the staging
                 processes; the first is the cold pass

A slab rescue in any engine voids the rate (windows_per_sec null) and
is printed.  The last line of standard output is one JSON record.
`--device cuda` (the default) needs a card and exits non-zero without
one; `--device cpu` only rehearses the control flow: its record names
the CPU and leaves every time and rate null (counts stay filled).
Imports nothing of JAX or dindel_tpu."""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (the smoke test's measurement helpers)

MODES = ("dip", "pooled", "decode", "dense", "streaming", "hostshard")
SUBSET_WINDOWS = 120     # chip_smoke.PATH_WINDOWS: the cells C4, C6-C8, C11


def default_stage_procs():
    """bench.py:127: leave one core for the device server, at most 4."""
    return max(1, min(4, (os.cpu_count() or 2) - 1))


def require_device(device: str, tool: str):
    """Exit non-zero with a one-line reason when `device` is CUDA and
    there is no card; returns whether the run is on a card."""
    import torch

    on_card = device != "cpu"
    if on_card and not torch.cuda.is_available():
        print(f"{tool}: --device {device} needs a CUDA card and none is "
              "available (use --device cpu to rehearse on the CPU)",
              file=sys.stderr)
        sys.exit(2)
    return on_card


def device_record(on_card: bool) -> dict:
    """The device a record was measured on."""
    import torch

    if not on_card:
        return {"platform": "cpu"}
    name, limit = (x.strip() for x in chip_smoke.card_line().split(",", 1))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "name": name, "power_limit": limit,
            "count": torch.cuda.device_count()}


def spread(xs):
    """median, min, max and interquartile range of `xs` (numpy's linear
    percentiles); None when there is no sample."""
    import numpy as np

    if not xs or any(x is None for x in xs):
        return None
    q25, q50, q75 = np.percentile(xs, [25, 50, 75])
    return {"median": float(q50), "min": float(min(xs)),
            "max": float(max(xs)), "iqr": float(q75 - q25), "n": len(xs)}


def prepare_dataset(d: Path, n_var: int, coverage: int):
    """tools/bench_windows.py's dataset in `d`, with getCIGARindels and
    makeWindows run through the port's CLI; reuses what an earlier run
    left there.  Returns (fasta, bam, window files, libraries file)."""
    d.mkdir(parents=True, exist_ok=True)
    fa, bam = d / "sim.fa", d / "sim.bam"
    if not (d / "windows.done").exists():
        chip_smoke.simulate_bench(d, n_var, coverage, chip_smoke.READ_LEN)
        chip_smoke.run_cli("--analysis", "getCIGARindels", "--bamFile", bam,
                           "--ref", fa, "--outputFile", d / "cand")
        chip_smoke.run_cli("--analysis", "makeWindows", "--inputVarFile",
                           d / "cand.variants.txt", "--windowFilePrefix",
                           d / "win")
        (d / "windows.done").write_text("")
    wins = sorted(d.glob("win.*.txt"), key=lambda p: int(p.name.split(".")[1]))
    return str(fa), str(bam), wins, d / "cand.libraries.txt"


def split_windows(sub: Path, n_files: int, prefix: Path):
    """The lines of `sub` cut into at most n_files window files of equal
    size."""
    lines = [x for x in open(sub).read().splitlines() if x.strip()]
    per = -(-len(lines) // n_files)
    files = []
    for i in range(0, len(lines), per):
        f = Path(f"{prefix}{i // per}.txt")
        f.write_text("\n".join(lines[i:i + per]) + "\n")
        files.append(f)
    return files


# mode -> engine_pass keywords (the subset modes run on the first
# SUBSET_WINDOWS windows)
ENGINE_MODES = {
    "dip": {},
    "pooled": dict(do_diploid=False, estimate_hap_freqs=True),
    "decode": dict(output_realigned_bam=True),
    "dense": {},                       # lib_file added at run time
    "streaming": dict(hmm_backend="jax"),
}


def run_engine_mode(mode, d, fa, bam, wins, lib_file, device, repeats):
    """One cold and `repeats` warm engine passes; returns the passes as
    (wall s, RunStats summary, K1 launches) and the peak memory."""
    import torch
    from dindel_tpu_torch.hmm.dp_kernel import pair_hmm_dp

    kw = dict(ENGINE_MODES[mode])
    if mode == "dense":
        kw["lib_file"] = lib_file
    files = wins
    if mode != "dip":
        sub, _ = chip_smoke.window_subset(wins, SUBSET_WINDOWS,
                                          d / f"{mode}_win.txt")
        files = [sub]
    on_card = torch.device(device).type == "cuda"
    passes, peak = [], None
    for i in range(1 + repeats):
        if i == 1 and on_card:
            torch.cuda.reset_peak_memory_stats()
        pair_hmm_dp.launches = 0
        wall, st = chip_smoke.engine_pass(fa, bam, files,
                                          d / f"{mode}_{i}.glf.txt", device,
                                          **kw)
        passes.append((wall, st, pair_hmm_dp.launches))
        chip_smoke.log(f"[{mode}] pass {i} ({'cold' if i == 0 else 'warm'}):"
                       f" windows_ok {st['windows_ok']} in {wall:.3f} s; "
                       f"K1 launches {pair_hmm_dp.launches}")
    if on_card:
        peak = torch.cuda.max_memory_allocated()
    return passes, peak


def run_hostshard_mode(d, fa, bam, wins, device, repeats, procs):
    """run_hostshard over the subset cut into about procs*3 files, with
    1 + repeats repeats in the staging processes; returns the passes as
    (span s, windows) per repeat, the stats and the K1 launches."""
    import numpy as np
    import torch
    from dindel_tpu_torch.config import Parameters
    from dindel_tpu_torch.hmm.dp_kernel import pair_hmm_dp
    from dindel_tpu_torch.parallel.hostshard import run_hostshard

    sub, _ = chip_smoke.window_subset(wins, SUBSET_WINDOWS,
                                      d / "hostshard_win.txt")
    files = split_windows(sub, procs * 3, d / "hostshard_part")
    params = Parameters()
    params.do_diploid = True
    params.file_name = str(d / "hostshard")
    stats: dict = {}
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    pair_hmm_dp.launches = 0
    run_hostshard([bam], fa, params, [str(f) for f in files],
                  str(d / "hostshard.glf.txt"), n_procs=procs,
                  repeats=1 + repeats, stats_out=stats,
                  engine_kw=dict(dtype=np.float32, exact_ties=False),
                  device=device)
    passes = []
    for k in range(1 + repeats):
        marks = [st["repeats"][k] for st in stats["per_proc"]]
        span = max(m["t1"] for m in marks) - min(m["t0"] for m in marks)
        passes.append((span, sum(m["windows"] for m in marks)))
    return passes, stats, pair_hmm_dp.launches, len(files)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=MODES, default="dip")
    ap.add_argument("--n-variants", type=int, default=chip_smoke.N_VARIANTS)
    ap.add_argument("--coverage", type=int, default=chip_smoke.COVERAGE)
    ap.add_argument("--repeats", type=int, default=None,
                    help="warm passes (default 5 for dip, 3 otherwise)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--stage-procs", type=int, default=None,
                    help="hostshard staging processes (default "
                         "min(4, CPUs - 1))")
    ap.add_argument("--data", default=None,
                    help="dataset directory, reused when already made "
                         "(default: a temporary directory)")
    args = ap.parse_args(argv)
    on_card = require_device(args.device, "bench_windows_torch")
    repeats = args.repeats or (5 if args.mode == "dip" else 3)
    import torch
    from dindel_tpu_torch.hmm import dp_kernel

    rec = {"metric": "windows_per_sec", "mode": args.mode,
           "unit": "windows/s", "n_variants": args.n_variants,
           "coverage": args.coverage, "repeats": repeats,
           "device": device_record(on_card)}
    t0 = time.perf_counter()
    if on_card:
        dp_kernel.build()
    rec["kernel_build_s"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="bench_windows_torch_") as tmp:
        data = Path(args.data) if args.data else Path(tmp) / "data"
        t0 = time.perf_counter()
        fa, bam, wins, lib_file = prepare_dataset(data, args.n_variants,
                                                  args.coverage)
        rec["dataset_s"] = time.perf_counter() - t0
        d = Path(tmp)
        closed = chip_smoke.guard_rescues(fail=False)
        if args.mode == "hostshard":
            procs = args.stage_procs or default_stage_procs()
            passes, stats, launches, n_files = run_hostshard_mode(
                d, fa, bam, wins, args.device, repeats, procs)
            rescues = stats["slab_rescues"]
            walls = [span for span, _ in passes]
            oks = [n for _, n in passes]
            srv = stats["server"]
            # the staging processes count windows, not error rows: the
            # windows of a repeat that were not called ok
            not_ok = sum(st["windows_total"] - st["windows_ok"]
                         for st in stats["per_proc"]) // len(passes)
            rec.update(stage_procs=min(procs, n_files), window_files=n_files,
                       windows_ok=oks[-1], windows_error=not_ok,
                       k1_launches=launches,
                       server_enqueue_s=srv["dispatch_s"],
                       server_fetch_s=srv["fetch_s"],
                       server_slab_programs=srv["dispatches"],
                       peak_device_memory_bytes=(
                           torch.cuda.max_memory_allocated()
                           if on_card else None))
        else:
            passes, peak = run_engine_mode(args.mode, d, fa, bam, wins,
                                           lib_file, args.device, repeats)
            rescues = sum(closed)
            walls = [w for w, _, _ in passes]
            oks = [st["windows_ok"] for _, st, _ in passes]
            warm = sorted(range(1, len(passes)), key=lambda i: walls[i])
            mid = passes[warm[(len(warm) - 1) // 2]]
            rec.update(windows_ok=mid[1]["windows_ok"],
                       windows_error=mid[1]["windows_error"],
                       k1_launches=mid[2],
                       k1_launches_per_pass=[n for _, _, n in passes],
                       stage_seconds=mid[1]["stage_seconds"],
                       peak_device_memory_bytes=peak)
    rates = [n / w for n, w in zip(oks[1:], walls[1:])]
    rec.update(slab_rescues=rescues,
               windows_per_sec=spread(rates) if rescues == 0 else None,
               cold_windows_per_sec=oks[0] / walls[0] if rescues == 0
               else None,
               warm_last_windows_per_sec=rates[-1] if rescues == 0 else None,
               warm_wall_s=walls[1:], cold_wall_s=walls[0],
               windows_ok_per_pass=oks)
    if rescues:
        print(f"bench_windows_torch: {rescues} slab rescues in mode "
              f"{args.mode}: windows/s voided", file=sys.stderr)
    if not on_card:
        # a CPU run times nothing of the device path: every time and
        # rate is left null
        for k in ("windows_per_sec", "cold_windows_per_sec",
                  "warm_last_windows_per_sec", "warm_wall_s", "cold_wall_s",
                  "stage_seconds", "kernel_build_s", "dataset_s",
                  "server_enqueue_s", "server_fetch_s"):
            if k in rec:
                rec[k] = None
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
