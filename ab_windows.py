#!/usr/bin/env python3
"""A/B of the port's warm 360-window diploid pass between two checkouts
on one NVIDIA GPU.

    python3 ab_windows.py OTHER_CHECKOUT

Simulates chip_smoke.py's slice dataset once (360 planted indels, 30x,
100 bp reads, seed 3; candidates and windows through this checkout's
CLI), then runs the engine pass of each checkout's chip_smoke.py
(float32, fast ties, device folds) in its own process, in the order
other, this, this, other: one warm-up pass and two timed passes per
process.  Prints windows/s and stage seconds of every timed pass, with
the card's name and power limit."""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

CHILD = r'''
import json, sys
sys.path.insert(0, {tree!r})
import chip_smoke as cs
from pathlib import Path
out = []
for _ in range(3):
    wall, st = cs.engine_pass({fa!r}, {bam!r}, [Path(w) for w in {wins!r}],
                              Path({glf!r}), "cuda")
    out.append((wall, st["windows_ok"],
                {{k: round(v, 3) for k, v in st["stage_seconds"].items()}}))
print("RESULT", json.dumps(out[1:]))
'''


def main(argv) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("ab_windows: CUDA is not available", file=sys.stderr)
        return 1
    trees = {"other": Path(argv[0]).resolve(), "this": HERE}
    print(f"[device] {cs.card_line()}", flush=True)
    with tempfile.TemporaryDirectory(prefix="ab_windows_") as tmp:
        tmp = Path(tmp)
        fa, bam, _ = cs.simulate_bench(tmp, cs.N_VARIANTS, cs.COVERAGE,
                                       cs.READ_LEN)
        cs.run_cli("--analysis", "getCIGARindels", "--bamFile", bam, "--ref",
                   fa, "--outputFile", tmp / "cand")
        cs.run_cli("--analysis", "makeWindows", "--inputVarFile",
                   tmp / "cand.variants.txt", "--windowFilePrefix",
                   tmp / "win")
        wins = [str(p) for p in sorted(tmp.glob("win.*.txt"))]
        for tag in ("other", "this", "this", "other"):
            code = CHILD.format(tree=str(trees[tag]), wins=wins, fa=fa,
                                bam=bam, glf=str(tmp / f"{tag}.glf.txt"))
            t0 = time.perf_counter()
            res = subprocess.run([sys.executable, "-c", code],
                                 capture_output=True, text=True)
            for line in res.stderr.splitlines():
                if "WARNING" in line:
                    print(f"[ab] {tag}: {line}", flush=True)
            if res.returncode:
                print(res.stdout[-2000:], res.stderr[-4000:], file=sys.stderr)
                return 1
            line = next(x for x in res.stdout.splitlines()
                        if x.startswith("RESULT"))
            for wall, ok, st in json.loads(line[len("RESULT"):]):
                print(f"[ab] {tag} ({trees[tag]}): {ok} windows in "
                      f"{wall:.3f} s = {ok / wall:.6g} windows/s; {st}",
                      flush=True)
            print(f"[ab] {tag}: process {time.perf_counter() - t0:.1f} s",
                  flush=True)
    print(f"[device] {cs.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
