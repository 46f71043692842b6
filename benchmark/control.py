"""The precision control of a cell's correctness check: the comparison
of check.py run on a lower-precision answer, which has to fail it.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

Per seed it makes the cell's data, samples as many windows as a run
compares (spread over the whole window file), works out the float64
reference's GLF rows and the control's, and prints the three numbers:

  float32 configurations: the reference itself with its pair-HMM in
      bfloat16 (the program has no lower-precision path of its own);
  float64 configurations: the program's own float32 path, the streaming
      engine with `--hmmBackend pallas` (float32, fast ties), over the
      sampled windows.

Not part of a benchmark run; kept to show that each limit fails the
control (PERF.md gives its readings)."""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def control_rows(cfg, data, lines, chosen, device):
    """{index: rows} of the control for the chosen windows."""
    import torch
    from benchmark import spec
    if "float64" not in cfg["precision"]:
        reference = spec.reference(cfg.get("reference", "caller"))
        return reference.glf_rows(data["fasta"], data["bams"],
                                  {i: lines[i - 1] for i in chosen},
                                  cfg.get("dindel_flags", {}),
                                  device=device, dtype=torch.bfloat16)
    from benchmark import check, drive
    work = Path(data["windows"]).parent
    sub = work / "control_windows.txt"
    order = sorted(chosen)
    sub.write_text("\n".join(lines[i - 1] for i in order) + "\n")
    low = dict(cfg, cli=list(cfg["cli"]) + ["--hmmBackend", "pallas"])
    eng = drive.build_engine(low, data["fasta"], data["bams"],
                             data["bam_list"], device)
    try:
        eng.detect_indels(str(sub), str(work / "control.glf.txt"))
    finally:
        eng.close()
    out = {}
    for k, rows in check.read_glf(work / "control.glf.txt").items():
        i = order[k - 1]
        out[i] = [" ".join(r.split()[:1] + [str(i)] + r.split()[2:])
                  for r in rows]
    return out


def one_seed(cfg, traffic, seed, device):
    import torch
    from benchmark import check, spec
    from benchmark.gen import make_dataset
    reference = spec.reference(cfg.get("reference", "caller"))
    with tempfile.TemporaryDirectory(prefix="dindel_control_") as work:
        data = make_dataset(str(Path(work) / "data"), cfg["sequencing"],
                            traffic, seed)
        lines = [x for x in open(data["windows"]).read().splitlines()
                 if x.strip()]
        chosen = check.sample([{i + 1: [] for i in range(len(lines))}],
                              len(lines), int(cfg["check_windows"]), seed)
        ref = reference.glf_rows(data["fasta"], data["bams"],
                                 {i: lines[i - 1] for i in chosen},
                                 cfg.get("dindel_flags", {}),
                                 device=device, dtype=torch.float64)
        low = control_rows(cfg, data, lines, chosen, device)
        nums = check.numbers([low], ref, check.row_comparison(
            cfg.get("value_columns", check.VALUES), reference))
    return nums


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--cpu-rehearsal", type=int, default=0, metavar="SITES")
    args = ap.parse_args(argv)
    from benchmark import spec
    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    cfg = spec.config(bench, cell["config"])
    traffic = spec.traffic(cell["traffic"])
    device = "cuda:0"
    if args.cpu_rehearsal:
        traffic = dict(traffic, sites=args.cpu_rehearsal)
        device = "cpu"
    for seed in args.seeds:
        nums = one_seed(cfg, traffic, seed, device)
        nums.pop("per_window")
        print(json.dumps(dict(workload=args.workload, seed=seed, **nums)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
