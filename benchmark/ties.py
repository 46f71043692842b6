"""The readings that the reference's tie width (reference/diploid.py
`TIE`) was set from.

    python3 benchmark/ties.py --workload <cell> --seeds <n> [<n> ...]
                              [--windows <k>]

Per seed it makes the cell's data, runs the program's engine for the
cell over the whole window file, samples k windows from its rows as a
run does (by default as many as a run compares; the first k of a
larger sample are a run's), and runs the float64 reference over them.  At every
"dip" row it takes the called pair's two haplotypes and, for each read,
the reference's gap between its two log-likelihoods as a share of
max(1, |ll|) (the measure TIE bounds), and whether its choice between
the two moves a count of the row ("relevant").  It prints one line a
seed and a summary:

  flips       relevant reads that the program's likelihoods put on the
              other haplotype than the reference's: their gaps (the
              lower reading: sound runs decide these by rounding);
  drift       the largest change of a read's gap between the program's
              likelihoods and the reference's, as a share of
              max(1, |ll|), over every read and over the relevant ones:
              how far the program's rounding can move a gap, whichever
              way the read falls (a read whose gap is within it may fall
              either way on a sound run);
  near        each relevant read whose gap is under 1e-3 but not a tie in
              float64 (1e-15 or more): its gap and how far the program's
              rounding moved it; and how far it moved the ties' gaps;
  gaps        how many relevant reads have a gap in each decade, and the
              smallest;
  fault_gap   the smallest gap of a relevant read beyond the drift: a
              fault that inverts one read's choice moves a count, and
              the check sees it only where the read's gap is over TIE
              (the upper reading);
  ranged      "dip" rows that carry a range at each width.

Not part of a benchmark run (PERF.md gives its readings)."""

from __future__ import annotations

import argparse
import json
import math
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

WIDTHS = (1e-15, 1e-12, 1e-9, 1e-8, 1e-7, 1e-6, 1e-5, 1e-4)


def reference_sites(cfg, data, window_lines, device):
    """{window index: (ll2d, [(h1, h2, relevant reads)])} of the float64
    reference, one entry a "dip" row in row order."""
    import torch
    from benchmark.reference import caller, diploid
    sites, at = {}, {}
    glf, choice, count = caller.diploid_glf, diploid.read_choice, \
        diploid.count_range

    def diploid_glf(haps, reads, liks, *args, **kw):
        at["index"] = args[4]
        at["ll2d"] = np.array([[ml.ll for ml in row] for row in liks])
        sites[args[4]] = (at["ll2d"], [])
        return glf(haps, reads, liks, *args, **kw)

    def read_choice(ll2d, h1, h2):
        sites[at["index"]][1].append(
            (h1, h2, np.zeros(ll2d.shape[1], bool)))
        return choice(ll2d, h1, h2)

    def count_range(v1, v2, use1, tied):
        sites[at["index"]][1][-1][2][...] |= np.asarray(v1) != np.asarray(v2)
        return count(v1, v2, use1, tied)

    caller.diploid_glf = diploid_glf
    diploid.read_choice, diploid.count_range = read_choice, count_range
    try:
        caller.glf_rows(data["fasta"], data["bams"], window_lines,
                        cfg.get("dindel_flags", {}), device=device,
                        dtype=torch.float64)
    finally:
        caller.diploid_glf = glf
        diploid.read_choice, diploid.count_range = choice, count
    return sites


def program_lls(cfg, data, device, work):
    """({window index: the program's (haps, reads) log-likelihoods} as its
    diploid caller reads them, {window index: its GLF rows}) of one pass
    over the window file."""
    from benchmark import check, drive
    from dindel_tpu_torch.engine import batched
    lls = {}
    wrapped = []
    # the batched engine's diploid caller after a device call, and the
    # host one it falls back to: (haps, reads, liks view, ..., index at)
    for name, index_at in (("diploid_glf_dev", 9), ("diploid_glf", 7)):
        fn = getattr(batched, name)

        def wrap(*args, _fn=fn, _i=index_at, **kw):
            lls[args[_i]] = np.array(args[2].ll2d, np.float64)
            return _fn(*args, **kw)
        setattr(batched, name, wrap)
        wrapped.append((name, fn))
    eng = drive.build_engine(cfg, data["fasta"], data["bams"],
                             data["bam_list"], device)
    try:
        eng.detect_indels(data["windows"], str(work / "ties.glf.txt"))
    finally:
        eng.close()
        for name, fn in wrapped:
            setattr(batched, name, fn)
    return lls, check.read_glf(work / "ties.glf.txt")


def readings(ref, prog):
    """This seed's flips, drift, relevant gaps and ranged rows."""
    flips, gaps, near, shape_differs = [], [], [], 0
    tie_moved = 0.0
    drift = drift_rel = 0.0
    ranged = [0] * len(WIDTHS)
    rows = 0
    for i, (rll, rsites) in ref.items():
        pll = prog.get(i)
        if pll is None or pll.shape != rll.shape:
            shape_differs += 1
            continue
        for h1, h2, rel in rsites:
            rows += 1
            r1, r2, p1, p2 = rll[h1], rll[h2], pll[h1], pll[h2]
            scale = np.maximum(1.0, np.abs(r2))
            with np.errstate(invalid="ignore"):
                gap = np.abs(r1 - r2) / scale
                moved = np.abs((p1 - p2) - (r1 - r2)) / scale
            fin = np.isfinite(moved)
            if fin.any():
                drift = max(drift, float(moved[fin].max()))
            if (fin & rel).any():
                drift_rel = max(drift_rel, float(moved[fin & rel].max()))
            flip = rel & ((r1 >= r2) != (p1 >= p2))
            flips += [dict(window=i, h1=int(h1), h2=int(h2), read=int(r),
                           gap=float(gap[r]), ll=[float(r1[r]), float(r2[r])],
                           program=[float(p1[r]), float(p2[r])])
                      for r in np.nonzero(flip)[0]]
            g = gap[rel]
            gaps += g.tolist()
            at_tie = rel & (gap < 1e-15) & fin
            if at_tie.any():
                tie_moved = max(tie_moved, float(moved[at_tie].max()))
            close = rel & (gap >= 1e-15) & (gap < 1e-3)
            near += [[float(gap[r]), float(moved[r])]
                     for r in np.nonzero(close)[0]]
            for k, w in enumerate(WIDTHS):
                ranged[k] += bool((g <= w).any())
    return dict(flips=flips, drift=drift, drift_relevant=drift_rel,
                near=near, tie_moved=tie_moved, gaps=gaps, fault_gap=min((g for g in gaps if g > drift),
                                         default=None),
                ranged=ranged, rows=rows, windows_unmatched=shape_differs)


def decades(gaps):
    """{'<1e-16': n, '1e-16': n, ...}: relevant reads by the decade of
    their gap (a gap of 0 falls in the first)."""
    out = {}
    for g in gaps:
        key = ("<1e-16" if g < 1e-16 else
               f"1e{math.floor(math.log10(g)):+d}".replace("+", ""))
        out[key] = out.get(key, 0) + 1
    return dict(sorted(out.items(), key=lambda kv: (
        -math.inf if kv[0] == "<1e-16" else float(kv[0]))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/ties.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--windows", type=int, default=0)
    ap.add_argument("--cpu-rehearsal", type=int, default=0, metavar="SITES")
    args = ap.parse_args(argv)
    from benchmark import check, spec
    from benchmark.gen import make_dataset
    from benchmark.run import set_cache_dirs
    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    cfg = spec.config(bench, cell["config"])
    traffic = spec.traffic(cell["traffic"])
    device = "cuda:0"
    if args.cpu_rehearsal:
        traffic = dict(traffic, sites=args.cpu_rehearsal)
        device = "cpu"
    set_cache_dirs()
    flips, gaps, faults, near = [], [], [], []
    tie_moved = 0.0
    drift = drift_rel = 0.0
    ranged, rows = [0] * len(WIDTHS), 0
    for seed in args.seeds:
        with tempfile.TemporaryDirectory(prefix="dindel_ties_") as work:
            work = Path(work)
            data = make_dataset(str(work / "data"), cfg["sequencing"],
                                traffic, seed)
            lines = [x for x in open(data["windows"]).read().splitlines()
                     if x.strip()]
            lls, glf = program_lls(cfg, data, device, work)
            chosen = check.sample([glf], len(lines), args.windows
                                  or int(cfg["check_windows"]), seed)
            prog = {i: lls[i] for i in chosen if i in lls}
            ref = reference_sites(cfg, data,
                                  {i: lines[i - 1] for i in chosen}, device)
        got = readings(ref, prog)
        print(json.dumps(dict(
            seed=seed, rows=got["rows"], flips=got["flips"],
            drift=got["drift"], drift_relevant=got["drift_relevant"],
            fault_gap=got["fault_gap"], near=sorted(got["near"]),
            tie_moved=got["tie_moved"],
            relevant=len(got["gaps"]),
            smallest=sorted(got["gaps"])[:5], decades=decades(got["gaps"]),
            ranged=dict(zip(map(str, WIDTHS), got["ranged"])),
            windows_unmatched=got["windows_unmatched"])), flush=True)
        flips += [dict(f, seed=seed) for f in got["flips"]]
        near += got["near"]
        tie_moved = max(tie_moved, got["tie_moved"])
        gaps += got["gaps"]
        drift = max(drift, got["drift"])
        drift_rel = max(drift_rel, got["drift_relevant"])
        faults.append(got["fault_gap"])
        ranged = [a + b for a, b in zip(ranged, got["ranged"])]
        rows += got["rows"]
    print(json.dumps(dict(
        summary=True, seeds=len(args.seeds), rows=rows,
        flip_gaps=sorted(f["gap"] for f in flips), drift=drift,
        drift_relevant=drift_rel,
        near_most_moved=max((m for _, m in near), default=None),
        near_least_gap=min((g for g, _ in near), default=None),
        tie_moved=tie_moved,
        fault_gaps=sorted(g for g in faults if g is not None),
        relevant=len(gaps), smallest=sorted(gaps)[:20],
        decades=decades(gaps),
        ranged=dict(zip(map(str, WIDTHS), ranged)))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
