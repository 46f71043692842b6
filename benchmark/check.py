"""The comparison that decides `correct`: the GLF rows the timed path
wrote, against the plain reference's rows for the same windows.

Windows are sampled from the seed among those the passes covered (a
pass covers the window file's lines up to the last window it wrote rows
for), with the window that has the most rows always in the sample; each
sampled window is compared in every pass that covered it.  The numbers:

  value_gap     the largest gap of a likelihood-derived value
                (post_prob_variant, qual, logZ, mLogBQ, each genotype's
                glf value) as a share of max(1, |reference value|); a
                row missing or extra, a field that does not come from
                the pair-HMM (the window, the variant, its reads and
                candidates) or a genotype that differs, and a value on
                one side only, count as an infinite gap;
  rows_differ   rows whose text differs from the reference's in any
                field (a missing or extra row counts once);
  counts_differ rows whose counts taken from the reads' best paths
                differ (off-haplotype reads, coverage, mismatches).

A configuration's `limits` name the numbers compared (PERF.md gives the
readings each limit was set from); the others are printed only."""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

COLUMNS = [
    "msg", "index", "analysis_type", "tid", "lpos", "rpos",
    "center_position", "realigned_position", "was_candidate_in_window",
    "ref_all", "nref_all", "num_reads", "post_prob_variant", "qual",
    "est_freq", "logZ", "hapfreqs", "indidx", "msq", "numOffAll",
    "num_indel", "num_cover_forward", "num_cover_reverse",
    "num_unmapped_realigned", "var_coverage_forward",
    "var_coverage_reverse", "nBQT", "nmmBQT", "mLogBQ", "nMMLeft",
    "nMMRight", "glf"]
COUNTS = ("numOffAll", "num_indel", "num_cover_forward", "num_cover_reverse",
          "num_unmapped_realigned", "var_coverage_forward",
          "var_coverage_reverse", "nBQT", "nmmBQT", "nMMLeft", "nMMRight")
VALUES = ("post_prob_variant", "qual", "logZ", "mLogBQ")
KEYS = tuple(c for c in COLUMNS if c not in COUNTS + VALUES + ("glf",))


def read_glf(path) -> Dict[int, List[str]]:
    """{window index: its rows} of one GLF file (header skipped)."""
    out: Dict[int, List[str]] = {}
    with open(path) as f:
        next(f, None)
        for line in f:
            parts = line.split()
            if len(parts) > 1:
                out.setdefault(int(parts[1]), []).append(line.rstrip("\n"))
    return out


def sample(passes: List[Dict[int, List[str]]], n_lines: int, k: int,
           seed: int) -> List[int]:
    """k window indices (1-based) among those the passes covered, the one
    with the most rows first."""
    covered = max((max(p) for p in passes if p), default=0)
    covered = min(covered, n_lines)
    if covered == 0:
        return []
    rows = {}
    for p in passes:
        for i, r in p.items():
            rows[i] = max(rows.get(i, 0), len(r))
    first = max(rows, key=lambda i: (rows[i], -i))
    rng = np.random.Generator(np.random.PCG64([int(seed) & (2**64 - 1), 3]))
    rest = [i for i in rng.permutation(np.arange(1, covered + 1)).tolist()
            if i != first]
    return [first] + rest[:max(0, k - 1)]


def _num(s: str) -> float:
    try:
        return float(s)
    except ValueError:
        return math.nan


def _glf(s: str):
    """[(genotype, value)] of a glf column ('0/0:-79.8,0/1:-155.8')."""
    if s == "NA":
        return []
    out = []
    for part in s.split(","):
        g, _, v = part.partition(":")
        out.append((g, v))
    return out


def _gap(a: str, b: str) -> float:
    """|a - b| / max(1, |b|) of two printed values; 0 when the text is the
    same, infinite when only one is a number."""
    if a == b:
        return 0.0
    x, y = _num(a), _num(b)
    if math.isnan(x) or math.isnan(y):
        return math.inf
    return abs(x - y) / max(1.0, abs(y))


def compare(prog: List[str], ref: List[str]):
    """(largest value gap, rows whose text differs, rows whose counts
    differ) of one window's rows."""
    rows = sum(a != b for a, b in zip(prog, ref)) + abs(len(prog) - len(ref))
    if len(prog) != len(ref):
        return math.inf, rows, 0
    counts, gap = 0, 0.0
    for lp, lr in zip(prog, ref):
        p = dict(zip(COLUMNS, lp.split()))
        r = dict(zip(COLUMNS, lr.split()))
        gp, gr = _glf(p.get("glf", "")), _glf(r.get("glf", ""))
        if (len(p) != len(COLUMNS) or len(r) != len(COLUMNS)
                or any(p[c] != r[c] for c in KEYS)
                or [g for g, _ in gp] != [g for g, _ in gr]):
            gap = math.inf
            continue
        counts += any(p[c] != r[c] for c in COUNTS)
        for c in VALUES:
            gap = max(gap, _gap(p[c], r[c]))
        for (_, vp), (_, vr) in zip(gp, gr):
            gap = max(gap, _gap(vp, vr))
    return gap, rows, counts


def numbers(passes: List[Dict[int, List[str]]],
            ref: Dict[int, List[str]]) -> dict:
    """The numbers over every sampled window in every pass that covered
    it, and how many (pass, window) pairs were compared."""
    out = dict(value_gap=0.0, rows_differ=0, counts_differ=0, compared=0)
    for p in passes:
        if not p:
            continue
        last = max(p)
        for i, rows in ref.items():
            if i > last:
                continue
            g, d, c = compare(p.get(i, []), rows)
            out["value_gap"] = max(out["value_gap"], g)
            out["rows_differ"] += d
            out["counts_differ"] += c
            out["compared"] += 1
    return out


def verdict(nums: dict, limits: dict):
    """(correct, [(name, value, limit)]): every number the limits name
    within its limit, and at least one window compared."""
    rows = [(n, nums[n], lim) for n, lim in limits.items()]
    ok = nums["compared"] > 0 and all(v <= lim for _, v, lim in rows)
    return ok, rows
