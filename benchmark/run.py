"""Run one benchmark cell once and print its result as the last line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

The cell (BENCHMARK.json) names a configuration (configs/<name>.json:
the engine and its CLI arguments, the sequencing design and its
samples, the plain reference and the value columns of its check) and a
traffic mix (traffic/<name>.json: the planted sites).  A run makes the
FASTA, the BAMs and the window file from the seed (gen/), takes the
engine `python -m dindel_tpu_torch --analysis indels` builds, warms it
up over the first windows, then drives it over the window file in whole
passes for --seconds (drive.py).  Untraced, it reports the cell's
end-to-end metrics: device_ms_per_window (the card's busy time, by a
profiler of CUDA activity alone, from the window's start until every
window staged in it has finished, over the windows completed in that
span) and setup_s; with --trace 1 the window runs under torch.profiler
and the run reports the per-layer metrics (metrics/<name>.py, reading
the window's rate, stage seconds, counters and trace), busy_s, window_s
and the breakdown.  After the window the
engine is freed and the configuration's plain reference
(reference/<reference>.py, default caller) works out the GLF rows of
sampled windows again; check.py decides `correct`.

Needs a CUDA card; without one it exits non-zero before any work.
`--cpu-rehearsal` (never used for a measurement) runs the same control
flow on the CPU at a tiny size with the kernels' plain versions and
reports no metric value."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "dindel_tpu")


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--cpu-rehearsal", type=int, default=0, metavar="SITES",
                    help="rehearse on the CPU with this many sites "
                         "(no metric values)")
    return ap.parse_args(argv)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def host_clocks() -> dict:
    """This process's CPU seconds and context switches, and the wall."""
    import resource
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"wall_s": time.perf_counter(), "user_s": ru.ru_utime,
            "sys_s": ru.ru_stime, "voluntary_switches": ru.ru_nvcsw,
            "involuntary_switches": ru.ru_nivcsw}


def set_cache_dirs():
    """Every build and kernel cache of the program at a fixed path inside
    the checkout (the port builds its own into dindel_tpu_torch/build)."""
    cache = ROOT / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark import spec
    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    cfg = spec.config(bench, cell["config"])
    traffic = spec.traffic(cell["traffic"])
    rehearse = args.cpu_rehearsal > 0

    import torch
    if not rehearse:
        if not torch.cuda.is_available():
            log("benchmark: no CUDA device; a measurement needs one")
            return 2
        if torch.cuda.device_count() < cell["chips"]:
            log(f"benchmark: {cell['chips']} CUDA devices needed, "
                f"{torch.cuda.device_count()} present")
            return 2
    set_cache_dirs()
    device = "cpu" if rehearse else "cuda:0"
    if rehearse:
        traffic = dict(traffic, sites=args.cpu_rehearsal)
    work = Path(tempfile.mkdtemp(prefix="dindel_bench_"))
    try:
        return run(args, bench, cell, cfg, traffic, device, rehearse, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run(args, bench, cell, cfg, traffic, device, rehearse, work) -> int:
    import torch
    from benchmark import check, drive, spec, tracing
    from benchmark.gen import make_dataset

    t_gen = time.perf_counter()
    data = make_dataset(str(work / "data"), cfg["sequencing"], traffic,
                        args.seed)
    gen_s = time.perf_counter() - t_gen
    lines = [x for x in open(data["windows"]).read().splitlines()
             if x.strip()]
    log(f"[data] {data['n_windows']} windows, {data['n_reads']} reads, "
        f"contig {data['ref_len']} bp, made in {gen_s:.3f} s")
    eng = drive.build_engine(cfg, data["fasta"], data["bams"],
                             data["bam_list"], device)
    warm = work / "warmup.txt"
    warm.write_text("\n".join(lines[:int(cfg["warmup_windows"])]) + "\n")
    eng.detect_indels(str(warm), str(work / "warmup.glf.txt"))
    if not rehearse:
        torch.cuda.synchronize()
    out_dir = work / "passes"
    out_dir.mkdir()
    trace = launches = None
    if args.trace:
        launches = tracing.Launches(eng.stats)
        launches.install()
        trace = tracing.Trace(work)
        trace.start()
    setup_s = time.perf_counter() - T_START
    device_time = None
    if not args.trace and not rehearse:
        device_time = tracing.DeviceTime(work)
        device_time.start()
    done0 = drive.completed(eng.stats)
    host0 = host_clocks()
    res = drive.run_passes(eng, data["windows"], out_dir, args.seconds)
    host1 = host_clocks()
    device_ms = None
    if device_time is not None:
        # every window staged in the window has finished: its device work
        # and its completion are both in the span
        busy = device_time.stop()
        done = drive.completed(eng.stats) - done0
        device_ms = 1e3 * busy / done if done > 0 else None
        log(f"[device] busy {busy!r} s from the window's start to its last "
            f"finished window; {done} windows completed in that span")
    log("[host] over the passes: " + ", ".join(
        f"{k} {host1[k] - host0[k]:.3f}" for k in host0)
        + f"; load {os.getloadavg()}; cpus {os.cpu_count()}")
    record = None
    if args.trace:
        events = trace.stop()
        launches.uninstall()
        record = tracing.reduce(events, args.seconds, launches)
    if not rehearse:
        torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated(0) if not rehearse else None)
    interval = drive.rate_interval(res["samples"], res["t0"],
                                   res["deadline"], cfg["burst_gap_s"],
                                   res["pass_ends"])
    n_window = res["n_close"] - res["samples"][0][1]
    stage_s = {k: res["stage_close"].get(k, 0.0) - res["stage_open"].get(k, 0.0)
               for k in res["stage_close"]}
    counts = {k: res["counts_close"].get(k, 0) - res["counts_open"].get(k, 0)
              for k in res["counts_close"]}
    log("[stages] ms per window in the window: " + ", ".join(
        f"{k} {1e3 * v / max(n_window, 1):.3f}" for k, v in stage_s.items()))
    log(f"[window] {res['passes']} whole passes of {data['n_windows']} "
        f"windows; {n_window} windows completed before the deadline; rate "
        f"interval {interval}; rescued windows {res['rescued']}; "
        f"windows ok {eng.stats.windows_ok}, error rows "
        f"{eng.stats.windows_error} {eng.stats.error_messages}; counts in "
        f"the window {counts}")
    eng.close()
    del eng
    gc.collect()
    if not rehearse:
        torch.cuda.empty_cache()

    # correctness: the reference on sampled windows, after the window
    passes = [check.read_glf(p) for p in res["glfs"] if p.exists()]
    chosen = check.sample(passes, len(lines), int(cfg["check_windows"]),
                          args.seed)
    t_ref = time.perf_counter()
    reference = spec.reference(cfg.get("reference", "caller"))
    chosen_lines = {i: lines[i - 1] for i in chosen}
    ref = reference.glf_rows(data["fasta"], data["bams"], chosen_lines,
                             cfg.get("dindel_flags", {}), device=device)
    row = check.row_comparison(cfg.get("value_columns", check.VALUES),
                               reference)
    nums = check.numbers(passes, ref, row)
    correct, rows = check.verdict(nums, cfg["limits"])
    log(f"[check] windows {chosen}; {nums['compared']} (pass, window) "
        f"pairs compared; reference {reference.__name__} "
        f"{time.perf_counter() - t_ref:.3f} s; not compared: " + ", ".join(
            f"{k} {nums[k]!r}" for k in check.NUMBERS
            if k not in cfg["limits"]))
    for line in check.over_limit(nums, cfg["limits"], passes, ref,
                                 chosen_lines, row):
        log("[check] over its limit: " + line)

    found = forbidden_modules()
    if found:
        log(f"benchmark: modules of JAX or the JAX package loaded: {found}")
        return 3

    if interval is None or interval[0] <= 0:
        log("benchmark: no batch completed inside the window")
        correct = False
    metrics = {}
    wanted = spec.metrics_of(bench, cell["name"], bool(args.trace))
    if not args.trace:
        values = {"device_ms_per_window": device_ms, "setup_s": setup_s}
        for m in wanted:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    elif record is not None:
        record.update(windows=n_window, stage_s=stage_s, counts=counts,
                      windows_per_s=(interval[0] / interval[1]
                                     if interval else None))
        for m in wanted:
            v = spec.reader(m["name"])(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if rehearse:
        log(f"[rehearsal] rate interval {interval}, setup {setup_s:.3f} s; "
            f"no metric is reported from the CPU")
        metrics = {k: {"value": None, "unit": v["unit"]}
                   for k, v in metrics.items()}
        dev = {"platform": "cpu", "kind": "cpu", "count": 0,
               "memory_peak_bytes": None}
    else:
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": 1, "memory_peak_bytes": int(peak)}
        if record is not None:
            dev.update(busy_s=record["busy_s"], window_s=record["window_s"])
    if rehearse and record is not None:
        log(f"[rehearsal] traced record: busy {record['busy_s']} s, "
            f"kernels {record['kernels']}, breakdown {record['breakdown']}")
    result = {"correct": bool(correct),
              "attempted": int(interval[0]) if interval else 0,
              "failed": int(res["rescued"]),
              "metrics": metrics, "device": dev}
    if record is not None and not rehearse:
        result["breakdown"] = record["breakdown"]
    # an infinite gap (a value on one side only) prints as 1e300: JSON
    # has no infinity
    result["checks"] = {n: {"value": v if math.isfinite(v) else 1e300,
                            "limit": lim} for n, v, lim in rows}
    for n, v, lim in rows:
        log(f"check {n} = {v!r} (limit {lim!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
