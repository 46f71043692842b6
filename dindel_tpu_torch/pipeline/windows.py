"""Window building from candidate files: behavior of python/makeWindows.py
(clustering by union-style position propagation, window geometry, sharding)
and python/selectCandidates.py (count filter)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Tuple


@dataclass
class WinVariant:
    ref_pos: int
    var: str

    @property
    def ref_start(self) -> int:
        return self.ref_pos

    @property
    def ref_end(self) -> int:
        # makeWindows.py:14-27
        if self.var.startswith("-"):
            return self.ref_pos + len(self.var) - 2
        if self.var.startswith("+"):
            return self.ref_pos - 1
        return self.ref_pos


def read_candidates(path: str) -> Dict[str, Dict[int, List[str]]]:
    """makeWindows.py:133-162: {chr: {pos: [varString...]}}."""
    variants: Dict[str, Dict[int, List[str]]] = {}
    with open(path) as f:
        for line in f:
            dat = line.rstrip("\n").split()
            if len(dat) < 3:
                continue
            chrom = dat[0]
            pos = int(dat[1])
            i = 2
            while i < len(dat) and dat[i] != "#":
                variants.setdefault(chrom, {}).setdefault(pos, []).append(dat[i])
                i += 1
    return variants


def cluster_positions(positions: List[int], min_dist: int = 20) -> List[int]:
    """The iterate-until-fixed-point clustering of makeWindows.py:180-186:
    returns newPosition (cluster label per position)."""
    positions = sorted(positions)
    new_position = positions[:]
    done = False
    while not done:
        done = True
        for p in range(1, len(positions)):
            if (new_position[p] != new_position[p - 1]
                    and new_position[p] - positions[p - 1] <= min_dist):
                new_position[p] = new_position[p - 1]
                done = False
    return new_position


def make_windows(input_var_file: str, window_file_prefix: str,
                 min_dist: int = 20, variants_per_file: int = 1000,
                 hap_width: int = 60, max_var_per_window: int = 16) -> List[str]:
    """makeWindows.py split_and_merge + write_output_candidates.
    Returns the list of window files written."""
    variants = read_candidates(input_var_file)
    files: List[str] = []
    idx = 0
    for chrom in sorted(variants):  # variants.keys() order; sort for determinism
        positions = sorted(variants[chrom])
        new_position = cluster_positions(positions, min_dist)
        clustered: Dict[int, List[Tuple[int, str]]] = {}
        for p, np_ in zip(positions, new_position):
            for var in variants[chrom][p]:
                clustered.setdefault(np_, []).append((p, var))
        idx = _write_windows({chrom: clustered}, window_file_prefix, files,
                             variants_per_file, hap_width,
                             max_var_per_window, idx)
    return files


def _write_windows(new_variants, prefix: str, files: List[str],
                   variants_per_file: int, hap_width: int,
                   max_var_per_window: int, start_idx: int) -> int:
    """write_output_candidates (makeWindows.py:34-125)."""
    idx = start_idx
    num_written = 10_000_000
    fo = None
    for chrom in sorted(new_variants):
        for pos in sorted(new_variants[chrom]):
            if num_written > variants_per_file:
                idx += 1
                if fo:
                    fo.close()
                path = f"{prefix}.{idx}.txt"
                fo = open(path, "w")
                files.append(path)
                num_written = 0
            else:
                num_written += 1
            tups = sorted(set(new_variants[chrom][pos]))
            vars_ = [WinVariant(t[0], t[1]) for t in tups]
            min_ref = min(v.ref_start for v in vars_)
            max_ref = max(v.ref_end for v in vars_)
            left = max(min_ref - hap_width, 0)
            right = max_ref + hap_width
            vc = 0
            num_var = len(vars_)
            finished = False
            while not finished:
                fo.write(f"{chrom} {left} {right}")
                for _ in range(max_var_per_window):
                    fo.write(f" {vars_[vc].ref_pos},{vars_[vc].var}")
                    vc += 1
                    if vc == num_var:
                        finished = True
                        break
                fo.write("\n")
    if fo:
        fo.close()
    return idx


def select_candidates(input_path: str, output_path: str, min_count: int = 2) -> int:
    """selectCandidates.py: keep variants whose count (after '#') >=
    min_count. Returns number of lines written."""
    n = 0
    with open(input_path) as fin, open(output_path, "w") as fout:
        for line in fin:
            dat = line.rstrip("\n").split()
            if "#" not in dat:
                continue
            h = dat.index("#")
            variants = dat[2:h]
            counts = [int(c) for c in dat[h + 1:]]
            keep = [(v, c) for v, c in zip(variants, counts) if c >= min_count]
            if keep:
                fout.write(f"{dat[0]} {dat[1]} " + " ".join(v for v, _ in keep)
                           + " # " + " ".join(str(c) for _, c in keep) + "\n")
                n += 1
    return n
