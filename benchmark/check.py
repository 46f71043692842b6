"""The comparison that decides `correct`: the GLF rows the timed path
wrote, against the plain reference's rows for the same windows.

Windows are sampled from the seed among those the passes covered (a
pass covers the window file's lines up to the last window it wrote rows
for), with the window that has the most rows always in the sample; each
sampled window is compared in every pass that covered it.  The numbers:

  value_gap     the largest gap of a likelihood-derived value (the
                configuration's `value_columns`, by default
                post_prob_variant, qual, logZ and mLogBQ, and each
                genotype's glf value) as a share of max(1, |reference
                value|); a row missing or extra, a field that does not
                come from the pair-HMM (the window, the variant, its
                reads and candidates) or a genotype that differs, and a
                value on one side only, count as an infinite gap;
  rows_differ   rows whose text differs from the reference's in any
                field (a missing or extra row counts once);
  counts_differ rows whose counts taken from the reads' best paths
                differ (off-haplotype reads, coverage, mismatches); where
                the reference's row carries a range for a count (its
                note `#tied:<count>=<lo>-<hi>;...`: reads tied between
                the called pair's two haplotypes, whose choice rounding
                decides), any count in the range agrees;
  counts_tied   rows whose counts differ from the reference's own but
                lie in its ranges (printed only).

A value column holds one number; the glf column's genotypes are compared
as text and their values by their gap.  A reference whose rows this
module cannot parse so (a pooled row's hapfreqs lists a haplotype only
above a frequency threshold) brings its own `compare_row(lp, lr,
values)` with the readings behind it; `row_comparison` takes it.

A configuration's `limits` name the numbers compared (PERF.md gives the
readings each limit was set from); the others are printed only.
`behind` finds the first row pair behind a number of a window."""

from __future__ import annotations

import functools
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
    return [part.partition(":")[::2] for part in s.split(",")]


def _gap(a: str, b: str) -> float:
    """|a - b| / max(1, |b|) of two printed values; 0 when the text is the
    same, infinite when only one is a number."""
    if a == b:
        return 0.0
    x, y = _num(a), _num(b)
    if math.isnan(x) or math.isnan(y):
        return math.inf
    return abs(x - y) / max(1.0, abs(y))


def keys_of(values=VALUES):
    """The columns compared as text: all but the counts, the value
    columns and the glf."""
    return tuple(c for c in COLUMNS
                 if c not in COUNTS + tuple(values) + ("glf",))


def split_note(row: str):
    """(the row's text, {count column: (lo, hi)}) of a reference row."""
    text, _, note = row.partition(" #")
    ranges = {}
    if note.startswith("tied:"):
        for part in note[len("tied:"):].split(";"):
            col, _, span = part.partition("=")
            lo, _, hi = span.partition("-")
            ranges[col] = (int(lo), int(hi))
    return text, ranges


def _within(value: str, span) -> bool:
    try:
        return span is not None and span[0] <= int(value) <= span[1]
    except ValueError:
        return False


def compare_row(lp: str, lr: str, values=VALUES):
    """(value gap, counts differ, counts only in the reference's ranges)
    of one program row against its reference row: a key column or a
    genotype that differs is an infinite gap and leaves the counts
    uncompared."""
    lr, ranges = split_note(lr)
    p = dict(zip(COLUMNS, lp.split()))
    r = dict(zip(COLUMNS, lr.split()))
    if len(p) != len(COLUMNS) or len(r) != len(COLUMNS):
        return math.inf, False, False
    gp, gr = _glf(p["glf"]), _glf(r["glf"])
    if (any(p[c] != r[c] for c in keys_of(values))
            or [g for g, _ in gp] != [g for g, _ in gr]):
        return math.inf, False, False
    gap = max([_gap(p[c], r[c]) for c in values]
              + [_gap(a, b) for (_, a), (_, b) in zip(gp, gr)], default=0.0)
    off = [c for c in COUNTS if p[c] != r[c]]
    outside = any(not _within(p[c], ranges.get(c)) for c in off)
    return gap, outside, bool(off) and not outside


def row_comparison(values=VALUES, reference=None):
    """The comparison of a program row with its reference row, as
    compare_row gives it: the reference module's own `compare_row` where
    it has one, else this module's, for the configuration's value
    columns."""
    return functools.partial(getattr(reference, "compare_row", compare_row),
                             values=tuple(values))


def compare_window(prog: List[str], ref: List[str], row=compare_row):
    """(largest value gap, rows whose text differs, rows whose counts
    differ, rows whose counts lie only in the reference's ranges) of one
    window's rows."""
    text = [split_note(r)[0] for r in ref]
    rows = sum(a != b for a, b in zip(prog, text)) + abs(len(prog) - len(ref))
    if len(prog) != len(ref):
        return math.inf, rows, 0, 0
    counts, tied, gap = 0, 0, 0.0
    for lp, lr in zip(prog, ref):
        g, c, t = row(lp, lr)
        gap = max(gap, g)
        counts += c
        tied += t
    return gap, rows, counts, tied


def compare(prog: List[str], ref: List[str], values=VALUES):
    """(largest value gap, rows whose text differs, rows whose counts
    differ) of one window's rows."""
    return compare_window(prog, ref, row_comparison(values))[:3]


def behind(prog: List[str], ref: List[str], name: str, limit,
           row=compare_row):
    """The first (program row, reference row) of a window behind its
    number `name` going over `limit`: a row whose value gap is over the
    limit, or whose counts or text differ; a missing row is None."""
    n = max(len(prog), len(ref))
    pad = lambda rows: rows + [None] * (n - len(rows))  # noqa: E731
    for lp, lr in zip(pad(list(prog)), pad(list(ref))):
        if lp is None or lr is None:
            if name != "counts_differ":
                return lp, lr
            continue
        if name == "rows_differ":
            over = lp != split_note(lr)[0]
        else:
            g, c, _ = row(lp, lr)
            over = g > limit if name == "value_gap" else c
        if over:
            return lp, lr
    return None


def numbers(passes: List[Dict[int, List[str]]],
            ref: Dict[int, List[str]], row=compare_row) -> dict:
    """The numbers over every sampled window in every pass that covered
    it, how many (pass, window) pairs were compared, and each pair's own
    numbers (`per_window`: pass, window, value_gap, rows_differ,
    counts_differ)."""
    out = dict(value_gap=0.0, rows_differ=0, counts_differ=0, counts_tied=0,
               compared=0, per_window=[])
    for k, p in enumerate(passes):
        if not p:
            continue
        last = max(p)
        for i, rows in ref.items():
            if i > last:
                continue
            g, d, c, t = compare_window(p.get(i, []), rows, row)
            out["value_gap"] = max(out["value_gap"], g)
            out["rows_differ"] += d
            out["counts_differ"] += c
            out["counts_tied"] += t
            out["compared"] += 1
            out["per_window"].append((k, i, g, d, c))
    return out


NUMBERS = ("value_gap", "rows_differ", "counts_differ", "counts_tied")


def over_limit(nums: dict, limits: dict, passes, ref, window_lines=None,
               row=compare_row, most: int = 4) -> List[str]:
    """Lines naming, for each number over its limit, the windows behind
    it (their own number over the limit; above 0 for a count of rows),
    each in the first pass that shows it, with its first row pair."""
    lines = []
    for name, lim in limits.items():
        if name not in NUMBERS[:3] or not nums[name] > lim:
            continue
        at = 2 + NUMBERS.index(name)
        first = {}
        for pw in nums["per_window"]:
            if pw[at] > (lim if name == "value_gap" else 0):
                first.setdefault(pw[1], pw)
        for i in sorted(first)[:most]:
            k, v = first[i][0], first[i][at]
            prog, refr = behind(passes[k].get(i, []), ref[i], name, lim,
                                row) or (None, None)
            where = (window_lines or {}).get(i, "")
            lines.append(f"{name} {v!r} in window {i} [{where}], pass {k}: "
                         f"program row {prog!r}; reference row {refr!r}")
        if len(first) > most:
            lines.append(f"{name}: {len(first) - most} more windows")
    return lines


def verdict(nums: dict, limits: dict):
    """(correct, [(name, value, limit)]): every number the limits name
    within its limit, and at least one window compared."""
    rows = [(n, nums[n], lim) for n, lim in limits.items()]
    ok = nums["compared"] > 0 and all(v <= lim for _, v, lim in rows)
    return ok, rows
