"""Inspection dumps behind --opl (outputPooledLikelihoods): the
reference's manual test harness (DInDel.cpp:2823-2929 for the pooled
caller, :3404-3444 for the diploid caller).

Formats mirror the reference so existing tooling can parse them:
  <prefix>.hapvars     per-variant 0/1 membership across haplotypes
  <prefix>.hapfreqs    haplotype variant lists + estimated frequencies
  <prefix>.liks        per-read log-likelihoods and offHap flags
  <fileName>.check.txt diploid haplotype/read likelihood table
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

from ..model import Haplotype, MLAlignment, Read


def write_pooled_dumps(file_name: str, tid: str, cand_pos: int,
                       haps: List[Haplotype], reads: List[Read],
                       liks: List[List[MLAlignment]],
                       hap_freqs: List[float],
                       all_variants: List[Tuple[int, object]],
                       hap_has_var: List[List[int]],
                       left_pos: int) -> None:
    """DInDel.cpp:2823-2893 (.hapvars, .hapfreqs, .liks)."""
    oprefix = f"{file_name}.{tid}.{cand_pos}"
    nh = len(haps)
    nr = len(reads)
    with open(oprefix + ".hapvars", "w") as of:
        for idx, (p, av) in enumerate(all_variants):
            o = f"{tid} {left_pos + p} {av.str}"
            of.write(o + " " * max(1, 50 - len(o)))
            for h in range(nh):
                of.write(f" {hap_has_var[h][idx]}")
            of.write("\n")
    with open(oprefix + ".hapfreqs", "w") as of:
        prefix = f"EM {tid} {cand_pos} {nr}"
        for h, hap in enumerate(haps):
            of.write(f"{prefix} {h + 1} {hap_freqs[h]:g} ")
            for p, av in sorted(hap.indels.items()):
                if av.str != "*REF":
                    of.write(f"{left_pos + p},{av.str}|")
            of.write("\n")
    with open(oprefix + ".liks", "w") as of:
        for r in range(nr):
            of.write(f"{r} {reads[r].qname} "
                     f"{math.log(1.0 - reads[r].map_qual):g} {reads[r].pool_id}")
            for h in range(nh):
                of.write(f" {liks[h][r].ll:g}")
            for h in range(nh):
                of.write(f" {int(liks[h][r].off_hap)}")
            of.write("\n")


def write_diploid_check(file_name: str, haps: List[Haplotype],
                        reads: List[Read],
                        liks: List[List[MLAlignment]],
                        hx1: int, hx2: int, left_pos: int) -> None:
    """DInDel.cpp:3404-3444 (<fileName>.check.txt)."""
    path = file_name + ".check.txt"
    with open(path, "w") as of:
        of.write("HAPLOTYPES\n")
        for h, hap in enumerate(haps):
            varss = "".join(f"{left_pos + p},{av.str};"
                            for p, av in sorted(hap.indels.items()))
            of.write(f"{h}\t{varss}\n")
        of.write("READS\n")
        for r, read in enumerate(reads):
            of.write(f"{r}\t{read.qname}\t{read.pos}\t{read.map_qual:g}")
            for h in range(len(haps)):
                of.write(f"\t{liks[h][r].ll:g}")
            for h in range(len(haps)):
                of.write(f"\t{int(liks[h][r].off_hap)}")
            of.write("\n")
