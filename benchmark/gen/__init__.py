"""Inputs of a benchmark run, made from the seed: a FASTA, one indexed BAM
per sample, the list of the BAMs and one window file, as the documented
pipeline (getCIGARindels, then makeWindows) would hand them to
`--analysis indels`.

make_dataset(out_dir, seq, traffic, seed) -> dict of paths and counts.
The design's `samples` (default 1) each get their own genotypes, reads
at the design's `coverage` and read group (sim.py).  The candidates are
what getCIGARindels reports from the CIGARs of every sample's reads
(the planted indels, and insertions whose bases carry a sequencing
error); makeWindows's clustering and window geometry are applied to
them here.  A CPU test runs the program's own getCIGARindels and
makeWindows on the generated BAMs and gets the same window file."""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from .bamfile import write_bam, write_fasta
from .sim import genome_of, make_genome, make_reads, sample_sites

REF_NAME = "1"


def candidates(ref, reads) -> Dict[int, List[str]]:
    """{position: [alleles]} as getCIGARindels reports them: every indel
    of every read's CIGAR (an insertion with the read's own bases,
    sequencing errors included), left-aligned (shifted left while the
    base before it equals its last base)."""
    seen = set()
    for r in np.nonzero((reads.ev_op == 1) | (reads.ev_op == 2))[0]:
        at, n = int(reads.ev_at[r]), int(reads.ev_len[r])
        ref_pos = int(reads.pos[r]) + at
        if reads.ev_op[r] == 1:
            seen.add((ref_pos, "+" + reads.seq[r, at:at + n].tobytes()
                      .decode()))
        else:
            seen.add((ref_pos, "-" + ref[ref_pos:ref_pos + n].tobytes()
                      .decode()))
    out: Dict[int, List[str]] = {}
    for pos, var in sorted(seen):
        body = var[1:].encode()
        while pos > 0 and ref[pos - 1] == body[-1]:
            if var[0] == "+":
                body = body[-1:] + body[:-1]
            else:
                body = ref[pos - 1:pos - 1 + len(body)].tobytes()
            pos -= 1
        a = var[0] + body.decode()
        if a not in out.setdefault(pos, []):
            out[pos].append(a)
    return out


def _ref_end(pos: int, var: str) -> int:
    """makeWindows.py:14-27."""
    if var.startswith("-"):
        return pos + len(var) - 2
    if var.startswith("+"):
        return pos - 1
    return pos


def window_lines(cands: Dict[int, List[str]], chrom: str = REF_NAME,
                 min_dist: int = 20, hap_width: int = 60,
                 max_var_per_window: int = 16) -> List[str]:
    """makeWindows.py's windows: positions within min_dist of their
    neighbour form one cluster; a window spans the cluster's variants
    plus hap_width on each side, with at most max_var_per_window
    variants a line."""
    positions = sorted(cands)
    label = positions[:]
    done = False
    while not done:
        done = True
        for p in range(1, len(positions)):
            if (label[p] != label[p - 1]
                    and label[p] - positions[p - 1] <= min_dist):
                label[p] = label[p - 1]
                done = False
    clusters: Dict[int, List[Tuple[int, str]]] = {}
    for p, lab in zip(positions, label):
        for v in cands[p]:
            clusters.setdefault(lab, []).append((p, v))
    lines = []
    for lab in sorted(clusters):
        tups = sorted(set(clusters[lab]))
        left = max(min(p for p, _ in tups) - hap_width, 0)
        right = max(_ref_end(p, v) for p, v in tups) + hap_width
        for i in range(0, len(tups), max_var_per_window):
            lines.append(f"{chrom} {left} {right} " + " ".join(
                f"{p},{v}" for p, v in tups[i:i + max_var_per_window]))
    return lines


def make_dataset(out_dir: str, seq: dict, traffic: dict, seed: int) -> dict:
    """Write sim.fa(.fai), the BAMs with their .bai (sim.bam for one
    sample; sample<k>.bam, read group rg<k+1>, SM <sample><k> for more),
    bams.txt (one BAM path a line, as --bamFiles reads it) and
    windows.txt into out_dir."""
    os.makedirs(out_dir, exist_ok=True)
    n_samples = int(seq.get("samples", 1))
    genome = make_genome(seq, traffic, seed)
    ref = genome[0]
    fa = os.path.join(out_dir, "sim.fa")
    win = os.path.join(out_dir, "windows.txt")
    write_fasta(fa, REF_NAME, ref)
    cands: Dict[int, List[str]] = {}
    bams, n_reads, first_pair = [], 0, 0
    for k, sites in enumerate(sample_sites(genome[3], traffic, n_samples,
                                           seed)):
        g = genome if sites is genome[3] else genome_of(ref, sites)
        reads = make_reads(g, seq, seed, sample=k, first_pair=first_pair)
        one = n_samples == 1
        bam = os.path.join(out_dir, "sim.bam" if one else f"sample{k}.bam")
        write_bam(bam, REF_NAME, ref.shape[0],
                  seq["sample"] if one else f"{seq['sample']}{k}", reads,
                  int(seq["base_qual"]), int(seq["mapq"]), rg=f"rg{k + 1}",
                  library=f"lib{k + 1}")
        for pos, alleles in candidates(ref, reads).items():
            have = cands.setdefault(pos, [])
            have += [a for a in alleles if a not in have]
        bams.append(bam)
        n_reads += int(reads.pos.shape[0])
        first_pair += reads.pos.shape[0] // 2
    bam_list = os.path.join(out_dir, "bams.txt")
    with open(bam_list, "w") as f:
        f.write("".join(b + "\n" for b in bams))
    lines = window_lines(cands)
    with open(win, "w") as f:
        f.write("\n".join(lines) + "\n")
    return dict(fasta=fa, bam=bams[0], bams=bams, bam_list=bam_list,
                windows=win, n_windows=len(lines), n_reads=n_reads,
                ref_len=int(ref.shape[0]), sites=genome[3])
